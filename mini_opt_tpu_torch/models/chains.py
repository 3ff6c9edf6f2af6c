"""Kinematic transform chains, the IK domain model: the port of
``mini_opt_tpu/models/chains.py`` (chains.py:26-345).

``Pose`` is a (quaternion, translation) pair; the chain's forward pass and
the chain rule to the active parameters (transform_chains.cc:23-243) are
written for ONE instance, as in the JAX package, and a batch runs them
under ``torch.func.vmap``. Link masks are static, so parameter gathers are
fixed indexing and every result is built functionally (no in-place
writes), which is what ``vmap`` needs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils import so3


@dataclasses.dataclass
class Pose:
    """Rotation (wxyz quaternion) + translation (transform_chains.hpp:23-59).
    Leaves may carry leading batch dims."""

    rotation: torch.Tensor  # (..., 4)
    translation: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float64, device=None) -> "Pose":
        return Pose(so3.quat_identity(dtype, device), torch.zeros(3, dtype=dtype, device=device))

    def compose(self, other: "Pose") -> "Pose":
        return Pose(
            so3.quat_multiply(self.rotation, other.rotation),
            self.translation + so3.quat_rotate(self.rotation, other.translation),
        )

    def __mul__(self, other):
        if isinstance(other, Pose):
            return self.compose(other)
        return self.transform(other)

    def inverse(self) -> "Pose":
        q_inv = so3.quat_conjugate(self.rotation)
        return Pose(q_inv, so3.quat_rotate(q_inv, -self.translation))

    def transform(self, v):
        return so3.quat_rotate(self.rotation, v) + self.translation


class ChainBuffers(NamedTuple):
    """Forward-pass products (ChainComputationBuffer,
    transform_chains.hpp:78-101) with (L, 3, 3) derivative panels."""

    i_R_end: torch.Tensor  # (L+1, 4): frame i -> end rotation
    i_t_end: torch.Tensor  # (L+1, 3): end position in frame i
    rotation_D_rotation: torch.Tensor  # (L, 3, 3)
    translation_D_rotation: torch.Tensor  # (L, 3, 3)
    translation_D_translation: torch.Tensor  # (L, 3, 3)

    def start_T_end(self) -> Pose:
        return Pose(self.i_R_end[0], self.i_t_end[0])


def compute_chain(links: Pose, use_associative_scan: bool = False) -> ChainBuffers:
    """Forward pass over a stacked chain of L links
    (transform_chains.cc:23-82): the end pose in every intermediate frame
    and the three derivative panels (right tangent of SO(3)):

      translation_D_translation[i] = R(start_R_i)
      translation_D_rotation[i]    = R(start_R_{i+1}) @ skew(-i_t_end[i+1])
      rotation_D_rotation[i]       = R(i_R_end[i+1])^T

    The sweeps are sequential, in the order of the JAX package's unrolled
    and scan forms (which compute the same products).
    ``use_associative_scan`` (JAX's O(log L)-depth option for long chains)
    is accepted and computes the same products sequentially.
    """
    del use_associative_scan
    L = links.rotation.shape[0]
    dtype, device = links.rotation.dtype, links.rotation.device
    q_id = so3.quat_identity(dtype, device)
    t_zero = torch.zeros(3, dtype=dtype, device=device)
    q_suf, t_suf = [q_id], [t_zero]
    for i in range(L - 1, -1, -1):
        q_suf.append(so3.quat_multiply(links.rotation[i], q_suf[-1]))
        t_suf.append(so3.quat_rotate(links.rotation[i], t_suf[-1]) + links.translation[i])
    i_R_end = torch.stack(q_suf[::-1])
    i_t_end = torch.stack(t_suf[::-1])
    starts = [q_id]
    for i in range(L):
        starts.append(so3.quat_multiply(starts[-1], links.rotation[i]))
    start_R = torch.stack(starts)

    R_start = so3.quat_to_matrix(start_R)  # (L+1, 3, 3)
    translation_D_rotation = torch.matmul(R_start[1:], so3.skew3(-i_t_end[1:]))
    rotation_D_rotation = so3.quat_to_matrix(i_R_end[1:]).transpose(-1, -2)
    return ChainBuffers(
        i_R_end=i_R_end,
        i_t_end=i_t_end,
        rotation_D_rotation=rotation_D_rotation,
        translation_D_rotation=translation_D_rotation,
        translation_D_translation=R_start[:L],
    )


def compute_all_poses(buffers: ChainBuffers) -> Pose:
    """All intermediate poses start_T_i (transform_chains.cc:84-92), stacked
    with leading dim L+1."""
    start_T_end = buffers.start_T_end()

    def one(q, t):
        pose = start_T_end.compose(Pose(q, t).inverse())
        return pose.rotation, pose.translation

    return Pose(*torch.func.vmap(one)(buffers.i_R_end, buffers.i_t_end))


@dataclasses.dataclass
class ActuatorLink:
    """One link: XYZ-euler rotation + translation with a static 6-bit mask
    of optimized parameters (transform_chains.hpp:124-153)."""

    rotation: torch.Tensor  # (4,)
    translation: torch.Tensor  # (3,)
    rotation_xyz: torch.Tensor  # (3,)
    active: Tuple[bool, ...]

    @staticmethod
    def create(pose: Pose, mask: Sequence[int], rotation_xyz=None) -> "ActuatorLink":
        """Decompose the pose's rotation into XYZ euler angles
        (transform_chains.cc:104-118), unless ``rotation_xyz`` gives them."""
        active = tuple(bool(m) for m in mask)
        if rotation_xyz is None:
            rotation_xyz = so3.euler_angles_xyz_from_quat(pose.rotation)
        return ActuatorLink(pose.rotation, pose.translation, rotation_xyz, active)

    @property
    def active_count(self) -> int:
        return sum(self.active)

    @property
    def active_rotation_count(self) -> int:
        return sum(self.active[:3])

    def compute(self, params, position: int, with_jacobian: bool = True):
        """Substitute the active params; return (Pose, J) with J the
        d(SO3 right tangent)/d(active angles) block, (3, active rotations)
        (transform_chains.cc:125-158); J is None without ``with_jacobian``."""
        p = position
        if self.active_rotation_count == 0:
            t = [self.translation[i] for i in range(3)]
            for i in range(3):
                if self.active[i + 3]:
                    t[i] = params[p]
                    p += 1
            J = torch.zeros((3, 0), dtype=params.dtype, device=params.device)
            return Pose(self.rotation, torch.stack(t)), J
        angles = [self.rotation_xyz[i] for i in range(3)]
        t = [self.translation[i] for i in range(3)]
        for i in range(3):
            if self.active[i]:
                angles[i] = params[p]
                p += 1
        for i in range(3):
            if self.active[i + 3]:
                t[i] = params[p]
                p += 1
        angles = torch.stack(angles)
        if not with_jacobian:
            return Pose(so3.quat_from_euler_angles_xyz(angles), torch.stack(t)), None
        rot = so3.so3_from_euler_angles_xyz(angles)
        J = torch.stack([rot.rotation_D_angles[:, i] for i in range(3) if self.active[i]], dim=1)
        return Pose(rot.q, torch.stack(t)), J


class ChainState(NamedTuple):
    """Effector pose + derivative panels with respect to the active
    parameter vector (transform_chains.hpp:157-209)."""

    effector: Pose
    rotation_D_params: torch.Tensor  # (3, P)
    translation_D_params: torch.Tensor  # (3, P)
    buffers: ChainBuffers

    @property
    def translation(self):
        return self.effector.translation

    @property
    def rotation(self):
        return self.effector.rotation


@dataclasses.dataclass
class ActuatorChain:
    """A chain of actuator links (transform_chains.hpp:157-209): static link
    structure (masks), base poses as tensors on one device."""

    links: Tuple[ActuatorLink, ...]

    @property
    def total_active(self) -> int:
        return sum(link.active_count for link in self.links)

    def to(self, device=None, dtype=None) -> "ActuatorChain":
        """The same chain with its tensors on ``device`` / in ``dtype``."""
        def mv(t):
            return t.to(device=device, dtype=dtype)

        return ActuatorChain(
            tuple(
                ActuatorLink(mv(l.rotation), mv(l.translation), mv(l.rotation_xyz), l.active)
                for l in self.links
            )
        )

    def effector(self, params) -> Pose:
        """The effector pose of one instance alone: the same operations as
        ``update(params).effector``, without the derivative panels, for
        residuals that need only the value (the JAX package leaves the
        unused panels to XLA's dead-code elimination)."""
        q = so3.quat_identity(params.dtype, params.device)
        t = torch.zeros(3, dtype=params.dtype, device=params.device)
        poses, position = [], 0
        for link in self.links:
            poses.append(link.compute(params, position, with_jacobian=False)[0])
            position += link.active_count
        for pose in reversed(poses):
            q, t = so3.quat_multiply(pose.rotation, q), so3.quat_rotate(pose.rotation, t) + pose.translation
        return Pose(q, t)

    def update(self, params, use_associative_scan: bool = False) -> ChainState:
        """Forward pass + chain rule to the active parameters of one
        instance, ``params (P,)`` (transform_chains.cc:165-243)."""
        poses, rot_jacs = [], []
        position = 0
        for link in self.links:
            pose, J = link.compute(params, position)
            poses.append(pose)
            rot_jacs.append(J)
            position += link.active_count

        stacked = Pose(
            torch.stack([p.rotation for p in poses]),
            torch.stack([p.translation for p in poses]),
        )
        buf = compute_chain(stacked, use_associative_scan)

        rot_cols, trans_cols = [], []
        for i, link in enumerate(self.links):
            nr = link.active_rotation_count
            if link.active_count == 0:
                continue
            if nr > 0:
                trans_cols.append(torch.matmul(buf.translation_D_rotation[i], rot_jacs[i]))
                rot_cols.append(torch.matmul(buf.rotation_D_rotation[i], rot_jacs[i]))
            zeros = torch.zeros((3, 1), dtype=params.dtype, device=params.device)
            for axis in range(3):
                if link.active[axis + 3]:
                    trans_cols.append(buf.translation_D_translation[i][:, axis : axis + 1])
                    rot_cols.append(zeros)
        P = self.total_active
        if P:
            rot_D = torch.cat(rot_cols, dim=1)
            trans_D = torch.cat(trans_cols, dim=1)
        else:
            rot_D = trans_D = torch.zeros((3, 0), dtype=params.dtype, device=params.device)
        return ChainState(
            effector=Pose(buf.i_R_end[0], buf.i_t_end[0]),
            rotation_D_params=rot_D,
            translation_D_params=trans_D,
            buffers=buf,
        )
