"""What crosses between the JAX package and the port: instance data, warm
starts, and the general path's problem description (a chain's link poses and
masks, the solver's ``NLSParams``). This system has no weights.

The JAX entry points take batch-major ``(B, rows)`` / ``(B, n)`` arrays and
pack them feature-major inside ``_fused_solve`` (pallas_ik.py:898-901, with
1024-lane padding for the TPU tile). The port keeps the batch-major public
layout and uses the feature-major ``(vars, B)`` layout, without padding, for
its kernel: thread ``i`` reads column ``i``.

The fused paths' settings need no conversion: their keyword budgets
(``max_iterations``, ``qp_iterations``, ``ls_iterations``, ``line_search``,
``barrier``) keep the JAX names and defaults, so one kwargs dict drives both
packages. The general path's ``NLSParams`` crosses as a dict
(``params_from_dict(dataclasses.asdict(jax_params))``), an
``ActuatorChain`` as numpy arrays (``chain_from_numpy``), and a pose-ring
family with its batch of graphs as the family's fields and numpy arrays
(``pose_ring_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

_FLOAT_DTYPES = (torch.float32, torch.float64)


def _resolve_device(device):
    """The device numpy inputs go to: "cuda" unless the caller names one.
    Without a CUDA device this raises instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return device


def batch_from_numpy(data, x0, device=None, dtype=None):
    """(B, rows) data and (B, n) warm starts -> feature-major tensors
    ``(rows, B)`` and ``(n, B)`` on ``device`` ("cuda" unless named), in
    ``dtype`` (the arrays' own when None)."""
    data = np.asarray(data)
    x0 = np.asarray(x0)
    if data.ndim != 2 or x0.ndim != 2 or data.shape[0] != x0.shape[0]:
        raise ValueError(f"expected (B, rows) and (B, n); got {data.shape} and {x0.shape}")
    device = _resolve_device(device)
    out = []
    for a in (data, x0):
        t = torch.from_numpy(np.ascontiguousarray(a.T))
        out.append(t.to(device=device, dtype=dtype or t.dtype).contiguous())
    return tuple(out)


def batch_to_numpy(*tensors):
    """Feature-major tensors ``(..., B)`` -> batch-major numpy arrays
    ``(B, ...)``: the way back from ``batch_from_numpy``."""
    out = tuple(np.moveaxis(t.detach().cpu().numpy(), -1, 0) for t in tensors)
    return out if len(out) > 1 else out[0]


def to_feature_major(data, x0, device=None):
    """The entry points' input conversion: numpy arrays go through
    ``batch_from_numpy``; tensors stay where they lie unless ``device``
    names another. Returns contiguous ``(rows, B)`` and ``(n, B)`` tensors of
    one floating dtype on one device."""
    if not torch.is_tensor(data) or not torch.is_tensor(x0):
        if torch.is_tensor(data) or torch.is_tensor(x0):
            raise TypeError("pass data and x0 both as tensors or both as arrays")
        data_t, x0_t = batch_from_numpy(data, x0, device)
    else:
        if data.dim() != 2 or x0.dim() != 2 or data.shape[0] != x0.shape[0]:
            raise ValueError(
                f"expected (B, rows) and (B, n); got {tuple(data.shape)} and {tuple(x0.shape)}"
            )
        if device is not None:
            data, x0 = data.to(device), x0.to(device)
        data_t, x0_t = data.T.contiguous(), x0.T.contiguous()
    if data_t.device != x0_t.device:
        raise ValueError(f"data on {data_t.device} but x0 on {x0_t.device}")
    if data_t.dtype != x0_t.dtype or data_t.dtype not in _FLOAT_DTYPES:
        raise TypeError(
            f"data and x0 must share float32 or float64; got {data_t.dtype} and {x0_t.dtype}"
        )
    return data_t, x0_t


def chain_from_numpy(rotations, translations, masks, rotation_xyz=None, dtype=torch.float64, device=None):
    """The port's ``ActuatorChain`` from a chain's link poses and masks as
    numpy arrays: ``rotations (L, 4)`` wxyz quaternions, ``translations
    (L, 3)``, ``masks (L, 6)`` (0/1 per optimized parameter) and, when given,
    the links' XYZ euler decompositions ``rotation_xyz (L, 3)`` (else they
    are recomputed from the quaternions). Numpy inputs go to ``device``
    ("cuda" unless the caller names one)."""
    from .models.chains import ActuatorChain, ActuatorLink, Pose

    device = _resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    links = []
    for i in range(len(masks)):
        pose = Pose(t(rotations[i]), t(translations[i]))
        xyz = None if rotation_xyz is None else t(rotation_xyz[i])
        links.append(ActuatorLink.create(pose, tuple(int(m) for m in masks[i]), xyz))
    return ActuatorChain(links=tuple(links))


def params_from_dict(fields):
    """The port's ``NLSParams`` from ``dataclasses.asdict`` of the JAX
    package's: enum members cross by their integer values, which both
    packages share."""
    from .nonlinear import NLSParams
    from .structs import BarrierStrategy, InitialGuessMethod, LineSearchStrategy

    kw = dict(fields)
    kw["line_search_strategy"] = LineSearchStrategy(int(kw["line_search_strategy"]))
    kw["qp_barrier_strategy"] = BarrierStrategy(int(kw["qp_barrier_strategy"]))
    if kw.get("qp_initial_guess_method") is not None:
        kw["qp_initial_guess_method"] = InitialGuessMethod(int(kw["qp_initial_guess_method"]))
    return NLSParams(**kw)


def pose_ring_from_numpy(fields, measurements, x0, device=None, dtype=None):
    """The port's ``PoseRingFamily`` and batch-major tensors from a pose-ring
    family's fields (``dataclasses.asdict`` of the JAX package's
    ``PoseRingFamily``: n_poses, anchor_weight, closure, closures) and a
    batch of graphs as numpy arrays: ``measurements (B, E, 3)`` and
    ``x0 (B, N, 3)``. Returns ``(family, data (B, 3E), x0 (B, 3N))`` on
    ``device`` ("cuda" unless named), in ``dtype`` (the arrays' own when
    None)."""
    from .ops.pose_ring import pose_ring_family

    closure = fields.get("closure")
    closures = fields.get("closures") or None
    family = pose_ring_family(
        int(fields["n_poses"]),
        anchor_weight=float(fields.get("anchor_weight", 100.0)),
        closure=None if closure is None else tuple(int(v) for v in closure),
        closures=None if closures is None else tuple(tuple(int(v) for v in c) for c in closures),
    )
    meas, x0 = np.asarray(measurements), np.asarray(x0)
    B = meas.shape[0]
    if meas.shape != (B, family.n_edges, 3) or x0.shape != (B, family.n_poses, 3):
        raise ValueError(
            f"expected measurements (B, {family.n_edges}, 3) and x0 (B, {family.n_poses}, 3); "
            f"got {meas.shape} and {x0.shape}"
        )
    device = _resolve_device(device)
    out = [
        torch.as_tensor(np.ascontiguousarray(a.reshape(B, -1)), device=device)
        for a in (meas, x0)
    ]
    return (family,) + tuple(t.to(dtype or t.dtype) for t in out)
