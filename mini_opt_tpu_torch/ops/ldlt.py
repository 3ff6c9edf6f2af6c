"""Lane-batched LDL^T factor and solve for the condensed KKT system, the
PyTorch port of ``mini_opt_tpu/ops/pallas_ldlt.py``.

Two CUDA kernels in ``csrc/ldlt.cu`` replace the TPU kernels
``pallas_ldlt.py::_ldlt_kernel`` (launched at :115 by
``_batched_factorize``) and ``pallas_ldlt.py::_solve_kernel`` (launched at
:155 by ``_batched_solve``): one instance per thread, feature-major
``(D, D, B)`` / ``(D, B)`` tensors, so that a warp's loads of one matrix
entry are coalesced. The unpivoted factorization ``H = L diag(d) L^T`` and
the forward, ``1/d`` and back substitutions keep the Pallas kernels'
association: ``c = H[:, j] - sum_k L[:, k] * (d[k] * L[j, k])`` with the sum
taken in index order.

Beside them sit ``_ldlt_factor_plain`` and ``_ldlt_solve_plain``, the same
arithmetic as plain PyTorch. CPU tensors run them; CUDA tensors launch the
kernels or raise. The kernels build without FMA contraction, so on the card
kernel and plain version agree bit for bit.

``factorize(H)`` / ``solve(fact, rhs)`` are the ``ops/kkt.py`` backend
``"pallas_ldlt"``: batch-first ``H (B, D, D)`` and ``rhs (B, D)``, with the
factor kept feature-major inside ``fact`` so that a solve reads it without
a copy. ``_batched_factorize`` / ``_batched_solve`` keep the JAX package's
batch-major signatures.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import _CUDA_DTYPE_IDS, _check_cuda_tensors

# Launches of each kernel in this process: the wrappers add one right where
# they launch, and nowhere else.
LDLT_FACTOR_LAUNCHES = 0
LDLT_SOLVE_LAUNCHES = 0


def _ldlt_factor_plain(Ht):
    """``Ht (D, D, B)`` (lower triangle read) -> ``Lt (D, D, B)`` unit-lower
    and ``dt (D, B)``: the kernel's column recurrence as plain PyTorch."""
    D = Ht.shape[0]
    L = torch.zeros_like(Ht)
    d = torch.zeros_like(Ht[0])
    rows = torch.arange(D, device=Ht.device)[:, None]
    one = torch.ones_like(Ht[:, 0])
    zero = torch.zeros_like(Ht[:, 0])
    for j in range(D):
        if j == 0:
            c = Ht[:, 0]
        else:
            w = d[:j] * L[j, :j]  # (j, B)
            acc = L[:, 0] * w[0]
            for k in range(1, j):
                acc = acc + L[:, k] * w[k]
            c = Ht[:, j] - acc
        dj = c[j]
        L[:, j] = torch.where(rows > j, c / dj, torch.where(rows == j, one, zero))
        d[j] = dj
    return L, d


def _ldlt_solve_plain(Lt, dt, rt):
    """Solve ``L diag(d) L^T x = rhs`` for feature-major ``rt (D, B)``:
    forward substitution, ``x / d``, back substitution, sums in index
    order."""
    D = Lt.shape[0]
    x = []
    for j in range(D):
        acc = rt[j]
        if j > 0:
            s = Lt[j, 0] * x[0]
            for k in range(1, j):
                s = s + Lt[j, k] * x[k]
            acc = acc - s
        x.append(acc)
    x = [x[j] / dt[j] for j in range(D)]
    for j in range(D - 2, -1, -1):
        s = Lt[j + 1, j] * x[j + 1]
        for k in range(j + 2, D):
            s = s + Lt[k, j] * x[k]
        x[j] = x[j] - s
    return torch.stack(x)


def _ldlt_factor_cuda(Ht):
    """Launch the factor kernel of ``csrc/ldlt.cu`` on a contiguous
    ``(D, D, B)`` CUDA tensor; same contract as ``_ldlt_factor_plain``."""
    global LDLT_FACTOR_LAUNCHES
    D, B = Ht.shape[0], Ht.shape[-1]
    _check_cuda_tensors((("H", Ht, (D, D, B)),), Ht.dtype, Ht.device, B)
    L = torch.empty_like(Ht)
    d = torch.empty((D, B), dtype=Ht.dtype, device=Ht.device)
    if B == 0 or D == 0:
        return L, d
    lib = _build.load_library()
    with torch.cuda.device(Ht.device):
        rc = lib.mo_ldlt_factor_launch(
            _CUDA_DTYPE_IDS[Ht.dtype], D, Ht.data_ptr(), L.data_ptr(), d.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"LDL^T factor kernel launch failed: {_build.error_string(rc)}")
    LDLT_FACTOR_LAUNCHES += 1
    return L, d


def _ldlt_solve_cuda(Lt, dt, rt):
    """Launch the solve kernel of ``csrc/ldlt.cu``; same contract as
    ``_ldlt_solve_plain``."""
    global LDLT_SOLVE_LAUNCHES
    D, B = rt.shape
    _check_cuda_tensors(
        (("L", Lt, (D, D, B)), ("d", dt, (D, B)), ("rhs", rt, (D, B))), rt.dtype, rt.device, B
    )
    x = torch.empty_like(rt)
    if B == 0 or D == 0:
        return x
    lib = _build.load_library()
    with torch.cuda.device(rt.device):
        rc = lib.mo_ldlt_solve_launch(
            _CUDA_DTYPE_IDS[rt.dtype], D, Lt.data_ptr(), dt.data_ptr(), rt.data_ptr(),
            x.data_ptr(), B, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"LDL^T solve kernel launch failed: {_build.error_string(rc)}")
    LDLT_SOLVE_LAUNCHES += 1
    return x


def _factor_fm(Ht):
    if Ht.is_cuda:
        return _ldlt_factor_cuda(Ht)
    if Ht.device.type == "cpu":
        return _ldlt_factor_plain(Ht)
    raise NotImplementedError(f"no LDL^T factor for device {Ht.device}")


def _solve_fm(Lt, dt, rt):
    if rt.is_cuda:
        return _ldlt_solve_cuda(Lt, dt, rt)
    if rt.device.type == "cpu":
        return _ldlt_solve_plain(Lt, dt, rt)
    raise NotImplementedError(f"no LDL^T solve for device {rt.device}")


def _ok(Lt, dt):
    """Per-lane health of a factorization (pallas_ldlt.py:139-141): every
    entry of L finite and every pivot above the dtype's smallest normal."""
    tiny = torch.finfo(dt.dtype).tiny
    return torch.isfinite(Lt).all(0).all(0) & (dt.abs() > tiny).all(0)


def _batched_factorize(H):
    """``H (B, D, D)`` -> ``(L (B, D, D), d (B, D), ok (B,))``."""
    Lt, dt = _factor_fm(H.permute(1, 2, 0).contiguous())
    return Lt.permute(2, 0, 1), dt.T, _ok(Lt, dt)


def _batched_solve(L, d, rhs):
    """``(B, D, D), (B, D), (B, D)`` -> ``x (B, D)``."""
    return _solve_fm(
        L.permute(1, 2, 0).contiguous(), d.T.contiguous(), rhs.T.contiguous()
    ).T


def factorize(H):
    """ops/kkt.py interface: ``H (B, D, D)`` -> ``(fact, ok (B,))``, the
    factor held feature-major in ``fact``."""
    Lt, dt = _factor_fm(H.permute(1, 2, 0).contiguous())
    return (Lt, dt), _ok(Lt, dt)


def solve(fact, rhs):
    """ops/kkt.py interface: ``rhs (B, D)`` -> ``x (B, D)``."""
    Lt, dt = fact
    return _solve_fm(Lt, dt, rhs.T.contiguous()).T
