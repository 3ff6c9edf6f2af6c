"""What crosses between the JAX package and the port: instance data and warm
starts. This system has no weights.

The JAX entry points take batch-major ``(B, rows)`` / ``(B, n)`` arrays and
pack them feature-major inside ``_fused_solve`` (pallas_ik.py:898-901, with
1024-lane padding for the TPU tile). The port keeps the batch-major public
layout and uses the feature-major ``(vars, B)`` layout, without padding, for
its kernel: thread ``i`` reads column ``i``.

Solver settings need no conversion: the port's keyword budgets
(``max_iterations``, ``qp_iterations``, ``ls_iterations``, ``line_search``,
``barrier``) keep the JAX names and defaults, so one kwargs dict drives both
packages.
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
