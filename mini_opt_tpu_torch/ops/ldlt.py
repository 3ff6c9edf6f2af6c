"""Lane-batched LDL^T factor and solve for the condensed KKT system, the
PyTorch port of ``mini_opt_tpu/ops/pallas_ldlt.py``.

Two CUDA kernels in ``csrc/ldlt.cu`` replace the TPU kernels
``pallas_ldlt.py::_ldlt_kernel`` (launched at :115 by
``_batched_factorize``) and ``pallas_ldlt.py::_solve_kernel`` (launched at
:155 by ``_batched_solve``). Up to ``REGISTER_MAX_D`` (the register route,
``ldlt_launch_plan``) each thread holds one system in registers: the
factor reads ``H (B, D, D)`` batch-major, as the QP builds it, and writes
the factor feature-major, ``(D, D, B)`` / ``(D, B)``, with the per-lane
health flag ``ok``; the solve reads that factor and a batch-major ``rhs
(B, D)`` and writes ``x (B, D)``. So one ``factorize`` + ``solve`` pair is
two launches and nothing else on the card. Past the cap (the generic
route) the wrappers copy ``H`` and ``rhs`` feature-major for the first
design's kernels, which read L's earlier columns back from device memory.
Both keep the Pallas kernels' association: ``c = H[:, j] - sum_k L[:, k] *
(d[k] * L[j, k])`` with the sum taken in index order.

Beside them sit ``_ldlt_factor_plain`` and ``_ldlt_solve_plain``, the same
arithmetic as plain PyTorch on feature-major tensors, and ``_ok``, the
flag's plain version; ``_factor_plain`` and ``_solve_plain`` put them
behind the kernel wrappers' batch-major signatures. CPU tensors run them;
CUDA tensors launch the kernels or raise. The kernels build without FMA
contraction, so on the card kernel and plain version agree bit for bit,
``ok`` included.

``factorize(H)`` / ``solve(fact, rhs)`` are the ``ops/kkt.py`` backend
``"pallas_ldlt"``: batch-first ``H (B, D, D)`` and ``rhs (B, D)``, with the
factor kept feature-major inside ``fact`` so that a solve reads it without
a copy. ``_batched_factorize`` / ``_batched_solve`` keep the JAX package's
batch-major signatures.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from ._common import _CUDA_DTYPE_IDS, _check_cuda_tensors

# Launches of each kernel in this process: the wrappers add one right where
# they launch, and nowhere else.
LDLT_FACTOR_LAUNCHES = 0
LDLT_SOLVE_LAUNCHES = 0

# The largest D of the register route, which ops/_build.py passes to
# csrc/ldlt.cu: ptxas keeps every instance up to it free of spills in both
# types. The general path's IK QPs give D = N + K (D = 3 at n = 2).
REGISTER_MAX_D = 13
# Threads (systems) per CTA on each route, as csrc/ldlt.cu launches them
# (kRegisterThreads, kGenericThreads): B = 8192 makes 256 CTAs on the
# register route for the H100's 132 SMs.
_THREADS = {"register": 32, "generic": 128}


@dataclasses.dataclass(frozen=True)
class LDLTLaunchPlan:
    """How kernels 4 and 5 launch for B systems of D rows: ``route``
    "register" (batch-major H and rhs, a system per thread in registers) or
    "generic" (feature-major copies of H and rhs); ``threads`` per CTA,
    ``grid`` CTAs, no shared memory on either route."""

    route: str
    threads: int
    grid: int


def ldlt_launch_plan(D: int, B: int) -> LDLTLaunchPlan:
    """The launch plan of kernels 4 and 5 for B systems of D rows, in either
    type."""
    route = "register" if D <= REGISTER_MAX_D else "generic"
    return LDLTLaunchPlan(route, _THREADS[route], -(-B // _THREADS[route]))


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


def _launch(name, *args):
    lib = _build.load_library()
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"LDL^T kernel launch failed ({name}): {_build.error_string(rc)}")


def _ldlt_factor_cuda(H):
    """Launch the factor kernel of ``csrc/ldlt.cu`` on a contiguous
    batch-major ``H (B, D, D)`` CUDA tensor (lower triangle read) ->
    ``(Lt (D, D, B), dt (D, B), ok (B,))``, as ``_factor_plain``. Past
    ``REGISTER_MAX_D`` the generic kernel gets a feature-major copy."""
    global LDLT_FACTOR_LAUNCHES
    B, D = H.shape[0], H.shape[-1]
    _check_cuda_tensors((("H", H, (B, D, D)),), H.dtype, H.device, B)
    Lt = torch.empty((D, D, B), dtype=H.dtype, device=H.device)
    dt = torch.empty((D, B), dtype=H.dtype, device=H.device)
    ok = torch.empty((B,), dtype=torch.bool, device=H.device)
    if B == 0 or D == 0:
        return Lt, dt, ok
    src = H if D <= REGISTER_MAX_D else H.permute(1, 2, 0).contiguous()
    with torch.cuda.device(H.device):
        _launch(
            "mo_ldlt_factor_launch", _CUDA_DTYPE_IDS[H.dtype], D, src.data_ptr(), Lt.data_ptr(), dt.data_ptr(),
            ok.data_ptr(), B,
        )
    LDLT_FACTOR_LAUNCHES += 1
    return Lt, dt, ok


def _ldlt_solve_cuda(Lt, dt, rhs):
    """Launch the solve kernel of ``csrc/ldlt.cu``: feature-major ``Lt (D,
    D, B)`` and ``dt (D, B)``, batch-major ``rhs (B, D)`` -> ``x (B, D)``,
    as ``_solve_plain``. Past ``REGISTER_MAX_D`` the generic kernel gets a
    feature-major copy of rhs and x is a view of its feature-major output."""
    global LDLT_SOLVE_LAUNCHES
    B, D = rhs.shape
    _check_cuda_tensors(
        (("L", Lt, (D, D, B)), ("d", dt, (D, B)), ("rhs", rhs, (B, D))), rhs.dtype, rhs.device, B
    )
    register = D <= REGISTER_MAX_D
    src = rhs if register else rhs.T.contiguous()
    x = torch.empty_like(src)
    if B == 0 or D == 0:
        return x if register else x.T
    with torch.cuda.device(rhs.device):
        _launch(
            "mo_ldlt_solve_launch", _CUDA_DTYPE_IDS[rhs.dtype], D, Lt.data_ptr(), dt.data_ptr(), src.data_ptr(),
            x.data_ptr(), B,
        )
    LDLT_SOLVE_LAUNCHES += 1
    return x if register else x.T


def _ok(Lt, dt):
    """Per-lane health of a factorization (pallas_ldlt.py:133-135): every
    entry of L finite and every pivot above the dtype's smallest normal."""
    tiny = torch.finfo(dt.dtype).tiny
    return torch.isfinite(Lt).all(0).all(0) & (dt.abs() > tiny).all(0)


def _factor_plain(H):
    """The plain counterpart of ``_ldlt_factor_cuda``: ``H (B, D, D)`` ->
    ``(Lt (D, D, B), dt (D, B), ok (B,))``."""
    Lt, dt = _ldlt_factor_plain(H.permute(1, 2, 0).contiguous())
    return Lt, dt, _ok(Lt, dt)


def _solve_plain(Lt, dt, rhs):
    """The plain counterpart of ``_ldlt_solve_cuda``: ``rhs (B, D)`` -> ``x
    (B, D)``."""
    return _ldlt_solve_plain(Lt, dt, rhs.T).T


def factorize(H):
    """ops/kkt.py interface: ``H (B, D, D)`` -> ``(fact, ok (B,))``, the
    factor held feature-major in ``fact``."""
    if H.is_cuda:
        Lt, dt, ok = _ldlt_factor_cuda(H.contiguous())
    elif H.device.type == "cpu":
        Lt, dt, ok = _factor_plain(H)
    else:
        raise NotImplementedError(f"no LDL^T factor for device {H.device}")
    return (Lt, dt), ok


def solve(fact, rhs):
    """ops/kkt.py interface: ``rhs (B, D)`` -> ``x (B, D)``."""
    Lt, dt = fact
    if rhs.is_cuda:
        return _ldlt_solve_cuda(Lt, dt, rhs.contiguous())
    if rhs.device.type == "cpu":
        return _solve_plain(Lt, dt, rhs)
    raise NotImplementedError(f"no LDL^T solve for device {rhs.device}")


def _batched_factorize(H):
    """``H (B, D, D)`` -> ``(L (B, D, D), d (B, D), ok (B,))``."""
    (Lt, dt), ok = factorize(H)
    return Lt.permute(2, 0, 1), dt.T, ok


def _batched_solve(L, d, rhs):
    """``(B, D, D), (B, D), (B, D)`` -> ``x (B, D)``."""
    return solve((L.permute(1, 2, 0).contiguous(), d.T.contiguous()), rhs)
