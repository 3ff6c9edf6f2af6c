"""Helpers shared by the fused solvers (``fused_ik.py``, ``blocked.py``):
the option and kernel-argument checks, and the JAX package's NaN and
rounding semantics written in PyTorch, so that the plain versions and the
CUDA kernels round alike."""

from __future__ import annotations

import torch

# Not math.pi: the JAX package's literal, which the wrap arithmetic mirrors.
_PI = 3.14159265358979


def _div(a, k):
    """a / k for a Python number k, rounded as one true division. (On CUDA,
    ``tensor / scalar`` computes ``tensor * (1 / scalar)``, which rounds
    differently from JAX's division and the kernel's.)"""
    return a / torch.full_like(a, k)


def _mod_pi(a):
    return a - 2.0 * _PI * torch.floor(_div(a + _PI, 2.0 * _PI))


def _maximum(a, b):
    """NaN-propagating max of a tensor and a tensor or float (jnp.maximum)."""
    return torch.maximum(a, b if torch.is_tensor(b) else torch.full_like(a, b))


def _minimum(a, b):
    """NaN-propagating min of a tensor and a tensor or float (jnp.minimum)."""
    return torch.minimum(a, b if torch.is_tensor(b) else torch.full_like(a, b))


def _sign(a):
    """jnp.sign: +-1, and the input itself at +-0 and NaN."""
    one = torch.ones_like(a)
    return torch.where(a > 0, one, torch.where(a < 0, -one, a))


def _check_options(max_iterations, qp_iterations, ls_iterations, line_search, barrier):
    if line_search not in ("armijo", "polynomial"):
        raise ValueError(f"line_search must be 'armijo' or 'polynomial', not {line_search!r}")
    if barrier not in ("complementarity", "mpc"):
        raise ValueError(f"barrier must be 'complementarity' or 'mpc', not {barrier!r}")
    # The final write-out reads iteration-loop state, so a zero-trip solve
    # has nothing to return.
    if max_iterations < 1:
        raise ValueError("fused kernels need max_iterations >= 1")
    if qp_iterations < 0 or ls_iterations < 0:
        raise ValueError("qp_iterations and ls_iterations must be >= 0")


# The kernels' dtype argument (csrc/*.cu launchers).
_CUDA_DTYPE_IDS = {torch.float32: 0, torch.float64: 1}


def _check_cuda_tensors(named, dtype, device, B, contiguous=True):
    """Each (name, tensor, shape) must be a CUDA tensor of ``shape`` in
    ``dtype`` on ``device``, contiguous unless the kernel reads strides
    (``contiguous=False``); the batch ``B`` must fit the kernels' int32
    grid."""
    if dtype not in _CUDA_DTYPE_IDS:
        raise TypeError(f"the kernel takes float32 or float64, not {dtype}")
    for name, t, shape in named:
        if not t.is_cuda or t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor on {device}")
        if tuple(t.shape) != shape or (contiguous and not t.is_contiguous()):
            kind = "contiguous " if contiguous else ""
            raise ValueError(f"{name} must be a {kind}{shape} tensor, not {tuple(t.shape)}")
    if B >= 2**31:
        raise ValueError("batch too large for the kernel's int32 grid")
