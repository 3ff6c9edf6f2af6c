"""Batched transform-chain inverse kinematics, the port of
``mini_opt_tpu/models/ik.py`` (ik.py:28-649).

The reference's actuator-limit IK problem (its nonlinear_test.cc:828-960):
a planar chain of Z-rotation actuators whose effector must reach a target,
with a nonlinear equality constraint on x, a soft cost on y and optional
joint-limit box constraints, solved for a whole batch of targets by
``nls_solve``; its spatial and waypoint variants; and the scalar-style
builders (``scalar_planar_ik_builder``, ``scalar_chain_ik_builder``) whose
one ``Problem`` drives ``nls_solve`` and compiles to the fused whole-solve
kernel through ``ops/fused_auto.py::family_from_problem``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..nonlinear import NLSParams, Problem
from ..parallel.batch import solve_batch
from ..qp import Var
from ..residual import BlockResidual, make_residual
from ..structs import BarrierStrategy, LineSearchStrategy, NLSResult, tree_map
from ..utils import so3
from .chains import ActuatorChain, ActuatorLink, Pose


def make_planar_chain(n_active: int = 2, link_length: float = 0.4, dtype=torch.float32, device=None) -> ActuatorChain:
    """A chain of ``n_active`` Z-rotation actuators plus a fixed end link
    (the reference's two-angle chain for n_active=2)."""
    mask = (0, 0, 1, 0, 0, 0)
    off = (0, 0, 0, 0, 0, 0)
    kw = dict(dtype=dtype, device=device)
    qi = so3.quat_identity(dtype, device)
    step = torch.tensor([link_length, 0.0, 0.0], **kw)
    links = [ActuatorLink.create(Pose(qi, torch.zeros(3, **kw)), mask)]
    for _ in range(n_active - 1):
        links.append(ActuatorLink.create(Pose(qi, step), mask))
    links.append(ActuatorLink.create(Pose(qi, step), off))
    return ActuatorChain(links=tuple(links))


def mod_pi_retraction(x, dx, alpha):
    """Angle-wrapping retraction of one instance (nonlinear_test.cc:869-874)."""
    return so3.mod_pi(x + dx * alpha)


def make_spatial_chain(
    n_active: int = 3, link_length: float = 0.4, dtype=torch.float32, device=None
) -> ActuatorChain:
    """A 3-D chain of ``n_active`` single-axis actuators with alternating
    rotation axes (z, y, z, y, ...) plus a fixed end link: the non-planar
    sibling of make_planar_chain (the reference's masked-Euler links,
    transform_chains.cc:94-158)."""
    mask_z = (0, 0, 1, 0, 0, 0)
    mask_y = (0, 1, 0, 0, 0, 0)
    off = (0, 0, 0, 0, 0, 0)
    kw = dict(dtype=dtype, device=device)
    qi = so3.quat_identity(dtype, device)
    step = torch.tensor([link_length, 0.0, 0.0], **kw)
    links = [ActuatorLink.create(Pose(qi, torch.zeros(3, **kw)), mask_z)]
    for a in range(1, n_active):
        links.append(ActuatorLink.create(Pose(qi, step), mask_y if a % 2 else mask_z))
    links.append(ActuatorLink.create(Pose(qi, step), off))
    return ActuatorChain(links=tuple(links))


def make_spatial_ik_problem(
    chain: ActuatorChain, target_xyz, with_joint_limits: bool = True, joint_limit: float = 3.14159265
) -> Problem:
    """Spatial analog of make_ik_problem: a soft cost pins effector (y, z),
    an equality constraint pins effector x, box limits on the non-leading
    joints."""
    P = chain.total_active

    def yz_res(params):
        st = chain.update(params)
        return st.translation[1:3] - target_xyz[1:3], st.translation_D_params[1:3, :]

    def x_eq(params):
        st = chain.update(params)
        return torch.stack([st.translation[0] - target_xyz[0]]), st.translation_D_params[0:1, :]

    def yz_value(params):
        return chain.effector(params).translation[1:3] - target_xyz[1:3]

    def x_value(params):
        return torch.stack([chain.effector(params).translation[0] - target_xyz[0]])

    ineq = ()
    if with_joint_limits:
        ineq = tuple(c for i in range(1, P) for c in (Var(i) >= 0.0, Var(i) <= joint_limit))
    idx = list(range(P))
    return Problem(
        dimension=P,
        costs=(make_residual(idx, yz_value, 2, jac=yz_res),),
        equality_constraints=(make_residual(idx, x_value, 1, jac=x_eq),),
        inequality_constraints=ineq,
    )


def make_ik_problem(
    chain: ActuatorChain, target_xy, with_joint_limits: bool = True, joint_limit: float = 3.14159265
) -> Problem:
    """The reference IK problem of ONE instance: a soft cost pins effector y,
    an equality constraint pins effector x, and optional joint-limit box
    constraints hold every non-leading joint in [0, joint_limit]."""
    P = chain.total_active

    def y_res(params):
        st = chain.update(params)
        return torch.stack([st.translation[1] - target_xy[1]]), st.translation_D_params[1:2, :]

    def x_eq(params):
        st = chain.update(params)
        return torch.stack([st.translation[0] - target_xy[0]]), st.translation_D_params[0:1, :]

    ineq = ()
    if with_joint_limits:
        ineq = tuple(c for i in range(1, P) for c in (Var(i) >= 0.0, Var(i) <= joint_limit))
    def y_value(params):
        return torch.stack([chain.effector(params).translation[1] - target_xy[1]])

    def x_value(params):
        return torch.stack([chain.effector(params).translation[0] - target_xy[0]])

    idx = list(range(P))
    return Problem(
        dimension=P,
        costs=(make_residual(idx, y_value, 1, jac=y_res),),
        equality_constraints=(make_residual(idx, x_value, 1, jac=x_eq),),
        inequality_constraints=ineq,
    )


def make_waypoint_ik_problem(
    chain: ActuatorChain,
    offsets,  # (W, 3) effector-frame waypoint offsets
    targets,  # (W, 3) world-frame targets
    weights,  # (W,)
) -> Problem:
    """Large-instance variant: W waypoint-matching residual blocks, each
    pulling an effector-frame offset point to a world target, built as ONE
    BlockResidual."""
    P = chain.total_active
    W = targets.shape[0]
    data = torch.cat([offsets, targets, weights[:, None]], dim=1)  # (W, 7)

    def one_waypoint(params, row):
        eff = chain.effector(params)
        offset, target, w = row[:3], row[3:6], row[6]
        pt = so3.quat_rotate(eff.rotation, offset) + eff.translation
        return w * (pt - target)

    indices = tuple(tuple(range(P)) for _ in range(W))
    return Problem(
        dimension=P,
        costs=(BlockResidual(fn=one_waypoint, indices=indices, dim=3, data=data),),
    )


def default_ik_params(dtype=torch.float32, max_iterations: int = 12, max_qp_iterations: int = 6) -> NLSParams:
    """Practical tolerances for the float32 throughput path; float64 uses
    the tighter reference tolerances (ik.py:190-216)."""
    f32 = dtype == torch.float32
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=max_qp_iterations,
        relative_exit_tol=1e-6 if f32 else 1e-12,
        absolute_first_derivative_tol=1e-6 if f32 else 1e-10,
        absolute_exit_tol=1e-7 if f32 else 1e-9,
        termination_kkt_tolerance=1e-5 if f32 else 1e-6,
        max_line_search_iterations=10,
        equality_penalty_initial=0.01,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        lambda_failure_init=0.001,
        armijo_search_tau=0.5,
        lambda_initial=0.001,
        min_lambda=1e-9,
        kkt_solver="auto",
    )


def solve_ik_batch(
    targets,  # (B, 2)
    x0,  # (B, P)
    chain: Optional[ActuatorChain] = None,
    params: Optional[NLSParams] = None,
    with_joint_limits: bool = True,
    device=None,
) -> NLSResult:
    """Solve B independent IK instances in one batched call. Numpy inputs go
    to ``device`` ("cuda" unless the caller names one); tensors run where
    they lie. The targets are cast to x0's dtype, the chain to x0's device
    and dtype."""
    from ..nonlinear import _as_batch

    x0, targets = _as_batch(x0, targets, device)
    dtype = x0.dtype
    targets = targets.to(dtype)
    if chain is None:
        chain = make_planar_chain(n_active=x0.shape[-1], dtype=dtype, device=x0.device)
    else:
        chain = chain.to(x0.device, dtype)
    if params is None:
        params = default_ik_params(dtype)

    def problem_fn(target):
        return make_ik_problem(chain, target, with_joint_limits)

    return solve_batch(problem_fn, params, x0, targets, retraction=mod_pi_retraction)



def solve_ik_multi_start(
    targets,  # (B, 2)
    x0,  # (B, S, P): S starts per instance
    chain: Optional[ActuatorChain] = None,
    params: Optional[NLSParams] = None,
    with_joint_limits: bool = True,
    device=None,
) -> NLSResult:
    """Multi-start robustification: solve every instance from S starts (all
    B*S solves batched together) and keep, per instance, the start with the
    lowest merit f + |eq|_1. Numpy inputs go to ``device`` ("cuda" unless
    named)."""
    from ..convert import _resolve_device

    if not torch.is_tensor(x0):
        x0 = torch.as_tensor(x0, device=_resolve_device(device))
    B, S, P = x0.shape
    targets = torch.as_tensor(targets, device=x0.device)
    targets_rep = torch.repeat_interleave(targets, S, dim=0)  # (B*S, 2)
    res = solve_ik_batch(targets_rep, x0.reshape(B * S, P), chain, params, with_joint_limits)
    res = tree_map(lambda a: a.reshape((B, S) + tuple(a.shape[1:])), res)
    merit = res.errors.f + res.errors.equality  # (B, S)
    best = torch.argmin(merit, dim=1)
    lanes = torch.arange(B, device=best.device)
    return tree_map(lambda a: a[lanes, best], res)


def scalar_planar_ik_builder(n_active: int, link_len: float = 0.4):
    """The planar IK problem as a SCALAR-STYLE ``problem_builder`` for
    ``family_from_problem`` (ops/fused_auto.py): the problem of
    ``make_ik_problem`` (soft cost on effector y, equality on effector x,
    [0, pi] limits on joints 1..n-1) with the forward kinematics written as
    static Python indexing and elementwise torch operations, so the SAME
    ``Problem`` drives ``nls_solve`` and compiles to the fused kernel. The
    joint limit is the JAX package's literal 3.14159265 and the effector is
    summed link by link (ik.py:269-317).

    Returns ``builder(data) -> Problem`` with ``data = (tx, ty)``.
    """
    L = link_len
    n = n_active
    idx = list(range(n))

    def builder(data):
        tx, ty = data[0], data[1]

        def effector(p):
            acc = None
            px = None
            py = None
            for i in range(n):
                acc = p[i] if acc is None else acc + p[i]
                cx = L * torch.cos(acc)
                sy = L * torch.sin(acc)
                px = cx if px is None else px + cx
                py = sy if py is None else py + sy
            return px, py

        def y_res(p):
            return torch.stack([effector(p)[1] - ty])

        def x_eq(p):
            return torch.stack([effector(p)[0] - tx])

        ineq = tuple(c for i in range(1, n) for c in (Var(i) >= 0.0, Var(i) <= 3.14159265))
        return Problem(
            dimension=n,
            costs=(make_residual(idx, y_res, 1),),
            equality_constraints=(make_residual(idx, x_eq, 1),),
            inequality_constraints=ineq,
        )

    return builder


def _c_neg(a):
    return -a


def _c_mul(a, b):
    """Constant-folding multiply: Python-float identities stay floats, exact
    0/1 factors vanish, so inactive mask bits generate no operations."""
    if isinstance(a, float):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if isinstance(b, float):
            return a * b
    if isinstance(b, float):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _c_add(a, b):
    if isinstance(a, float) and a == 0.0:
        return b
    if isinstance(b, float) and b == 0.0:
        return a
    return a + b


def _m3_mul(A, B):
    """3x3 product of nested-list matrices whose entries are Python floats
    or tensors. ``None`` stands for the identity."""
    if A is None:
        return B
    if B is None:
        return A
    return [
        [
            _c_add(
                _c_add(_c_mul(A[i][0], B[0][j]), _c_mul(A[i][1], B[1][j])),
                _c_mul(A[i][2], B[2][j]),
            )
            for j in range(3)
        ]
        for i in range(3)
    ]


def _axis_rot(angle, axis):
    """Rx/Ry/Rz as an entry list; float angles fold to float entries, exact
    zero folds to the identity (None)."""
    if isinstance(angle, float):
        if angle == 0.0:
            return None
        c, s = math.cos(angle), math.sin(angle)
    else:
        c, s = torch.cos(angle), torch.sin(angle)
    if axis == 0:
        return [[1.0, 0.0, 0.0], [0.0, c, _c_neg(s)], [0.0, s, c]]
    if axis == 1:
        return [[c, 0.0, s], [0.0, 1.0, 0.0], [_c_neg(s), 0.0, c]]
    return [[c, _c_neg(s), 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]


def _link_constants(chain: ActuatorChain):
    """Each link's mask and constants as float64 numpy arrays: (active,
    active rotation count, quaternion, euler angles, translation). Read once,
    outside any trace, as the JAX package reads concrete closure data."""

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return [
        (link.active, link.active_rotation_count, host(link.rotation), host(link.rotation_xyz),
         host(link.translation))
        for link in chain.links
    ]


def scalar_chain_fk(chain, p):
    """Forward kinematics of ANY ActuatorChain in SCALAR STYLE: static Python
    indexing of ``p`` plus elementwise operations only, so the same function
    serves the general path (``p`` a (P,) vector) and the fused family
    (``p`` a (P, B) stack; ops/fused_auto.py).

    The per-link mask and base-pose structure (transform_chains.hpp:124-153)
    is burned in at trace time: inactive euler angles and translations fold
    to Python-float constants (read through numpy in float64, as the JAX
    package does), so a planar chain generates exactly the cos/sin
    accumulation of the planar builder, while any SO(3) mask generates the
    minimal set of 3x3 products. ``chain`` is an ActuatorChain or its
    ``_link_constants`` (what a builder reads once, before any trace).
    Returns ``(R, t)``: a 3x3 nested list (or ``None`` for the identity) and
    a 3-list, entries floats or tensors.
    """
    links = _link_constants(chain) if isinstance(chain, ActuatorChain) else chain
    R = None  # accumulated rotation (None == identity)
    t = [0.0, 0.0, 0.0]
    pos = 0
    for active, active_rotation_count, quat, rot_xyz, trans in links:
        # --- link rotation ------------------------------------------------
        if active_rotation_count == 0:
            # As ActuatorLink.compute: the stored quaternion itself (the
            # euler decomposition may sit at a singularity).
            qw, qx, qy, qz = quat
            Rq = np.array(
                [
                    [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)],
                    [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)],
                    [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)],
                ]
            )
            if np.array_equal(Rq, np.eye(3)):
                R_link = None
            else:
                R_link = [[float(Rq[i, j]) for j in range(3)] for i in range(3)]
        else:
            R_link = None
            for axis in range(3):
                if active[axis]:
                    ang = p[pos]
                    pos += 1
                else:
                    ang = float(rot_xyz[axis])
                R_link = _m3_mul(R_link, _axis_rot(ang, axis))
        # --- link translation ----------------------------------------------
        tl = []
        for axis in range(3):
            if active[axis + 3]:
                tl.append(p[pos])
                pos += 1
            else:
                tl.append(float(trans[axis]))
        # --- compose: t += R @ tl; R = R @ R_link ---------------------------
        if R is None:
            t = [_c_add(t[i], tl[i]) for i in range(3)]
        else:
            t = [
                _c_add(
                    t[i],
                    _c_add(
                        _c_add(_c_mul(R[i][0], tl[0]), _c_mul(R[i][1], tl[1])),
                        _c_mul(R[i][2], tl[2]),
                    ),
                )
                for i in range(3)
            ]
        R = _m3_mul(R, R_link)
    return R, t


def scalar_chain_ik_builder(
    chain: ActuatorChain,
    target_dim: int = 2,
    with_joint_limits: bool = True,
    joint_limit: float = 3.14159265,
    prox_weight: float = 0.0,
):
    """The IK problem of ANY ActuatorChain as a scalar-style
    ``problem_builder`` for ``family_from_problem``, via ``scalar_chain_fk``;
    the same returned ``Problem`` drives ``nls_solve``.

    ``target_dim=2`` mirrors ``make_ik_problem`` (soft y cost, x equality);
    ``target_dim=3`` mirrors ``make_spatial_ik_problem`` (soft (y, z) cost,
    x equality). ``data = target`` of that length.

    ``prox_weight > 0`` appends the damped-least-squares proximal cost
    ``sqrt(prox_weight) * (x - x_ref)`` with ``x_ref`` carried as P extra
    data rows (``data = concat(target, x_ref)``): on redundant chains the
    unregularized landscape has constrained dead-ends, and
    ``fused_solve_proximal`` re-centres ``x_ref`` stage by stage.
    """
    if target_dim not in (2, 3):
        raise ValueError(f"target_dim must be 2 or 3, not {target_dim}")
    P = chain.total_active
    links = _link_constants(chain)
    idx = list(range(P))
    sqrt_w = float(prox_weight) ** 0.5
    expected_rows = target_dim + (P if prox_weight > 0.0 else 0)

    def builder(data):
        # A missing x_ref block would otherwise read past the target rows
        # silently on some paths: check the data length loudly.
        if len(data) < expected_rows:
            raise ValueError(
                f"builder expects {expected_rows} data rows "
                f"({target_dim} target"
                + (f" + {P} x_ref (prox_weight > 0)" if prox_weight > 0 else "")
                + f"), got {len(data)}"
            )

        def soft_res(p):
            _, t = scalar_chain_fk(links, p)
            if target_dim == 2:
                return torch.stack([t[1] - data[1]])
            return torch.stack([t[1] - data[1], t[2] - data[2]])

        def x_eq(p):
            _, t = scalar_chain_fk(links, p)
            return torch.stack([t[0] - data[0]])

        costs = [make_residual(idx, soft_res, target_dim - 1)]
        if prox_weight > 0.0:

            def prox_res(p):
                return torch.stack([sqrt_w * (p[i] - data[target_dim + i]) for i in range(P)])

            costs.append(make_residual(idx, prox_res, P))

        ineq = ()
        if with_joint_limits:
            ineq = tuple(c for i in range(1, P) for c in (Var(i) >= 0.0, Var(i) <= joint_limit))
        return Problem(
            dimension=P,
            costs=tuple(costs),
            equality_constraints=(make_residual(idx, x_eq, 1),),
            inequality_constraints=ineq,
        )

    return builder


_CHAIN_BUILDER_CACHE: dict = {}


def fused_chain_ik_solve(
    chain: ActuatorChain,
    targets,  # (B, 2) or (B, 3)
    x0,  # (B, P)
    params: Optional[NLSParams] = None,
    with_joint_limits: bool = True,
    joint_limit: float = 3.14159265,
    prox_weight: float = 0.0,
    prox_stages: int = 4,
    device=None,
):
    """One-call fused-kernel IK for ANY ActuatorChain.

    Builds (and caches, per chain object) the scalar-style IK problem via
    ``scalar_chain_ik_builder``, compiles it to a generated family and
    solves all B instances (``fused_nls_solve_batch``). ``targets.shape[1]``
    selects the planar (2) or spatial (3) cost structure. ``prox_weight >
    0`` runs ``prox_stages`` re-centred proximal stages. Defaults to the
    Mehrotra serving budget (10/3/1); ``params`` overrides the budgets
    (fixed trips, tolerance knobs ignored). Reuse the SAME chain object
    across calls: the cache is keyed on it. Tensors run where they lie;
    numpy inputs go to ``device`` ("cuda" unless named).
    """
    from ..convert import to_batch_major
    from ..ops.fused_auto import fused_nls_solve_batch

    targets, x0 = to_batch_major(targets, x0, device)
    target_dim = int(targets.shape[1])
    key = (id(chain), target_dim, with_joint_limits, float(joint_limit), float(prox_weight))
    if key not in _CHAIN_BUILDER_CACHE:
        _CHAIN_BUILDER_CACHE[key] = (
            chain,  # strong reference: keeps id() valid for the cache's lifetime
            scalar_chain_ik_builder(
                chain, target_dim=target_dim, with_joint_limits=with_joint_limits,
                joint_limit=joint_limit, prox_weight=prox_weight,
            ),
        )
    builder = _CHAIN_BUILDER_CACHE[key][1]
    if params is None:
        params = dataclasses.replace(
            default_ik_params(x0.dtype, max_iterations=10, max_qp_iterations=3),
            max_line_search_iterations=1,
            qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR,
            early_exit=False,
        )
    if prox_weight <= 0.0:
        return fused_nls_solve_batch(builder, targets, x0, params)
    x = x0
    for _ in range(prox_stages):
        d = torch.cat([targets, x], dim=1)
        x = fused_nls_solve_batch(builder, d, x, params)
    return x


def make_spatial_refine_fn(
    n_active: int = 3,
    link_length: float = 0.4,
    max_iterations: int = 12,
    qp_iterations: int = 6,
):
    """A float64 general-path re-solver for ``fused_solve_refined`` on the
    spatial family: the same problems through ``nls_solve`` with SO(3)
    actuator masks and the Mehrotra inner QP, per lane under
    ``torch.func.vmap``. Signature of refine_fn: (targets (K, 3) float64,
    x0 (K, n) float64) -> (K, n) float64, on the tensors' device."""
    from ..nonlinear import nls_solve

    params = dataclasses.replace(
        default_ik_params(torch.float64, max_iterations, qp_iterations),
        qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR,
    )

    def refine(targets, x0):
        chain = make_spatial_chain(n_active, link_length, dtype=torch.float64, device=x0.device)
        return nls_solve(
            lambda t: make_spatial_ik_problem(chain, t), params, x0,
            retraction=mod_pi_retraction, data=targets,
        ).x

    return refine
