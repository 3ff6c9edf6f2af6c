"""The whole fixed-trip QP interior point as one kernel, the PyTorch port of
``mini_opt_tpu/ops/pallas_qp.py``.

Kernel 6 replaces the TPU kernel ``pallas_qp.py::_make_qp_kernel`` (launched
at :262 by ``_fused_qp_batch``): for B independent QPs of N variables, K
equality rows and M diagonal box rows it runs the equality-constrained
initial guess, the condensed-KKT assembly and LDL^T, fraction-to-boundary
and the complementarity or Mehrotra schedule for a fixed number of
iterations. It has two routes (``launch_plan``):

* the register route (``csrc/fused_qp.cuh``, instantiated by ``fused_qp.cu``,
  ``fused_qp_pairs.cu`` and ``fused_qp_k2.cu``), one instance per thread,
  every loop unrolled over compile-time N and K within the caps
  ``REGISTER_MAX_N`` (what ptxas keeps free of spills in float, per K =
  0, 1, 2) and M <= 2N. ``qp_route`` names its two
  box-row types: "pairs" for the rows every caller in the port passes (a lo
  and a hi row on each of variables 1..N-1, the IK joint limits), which the
  kernel has at compile time, or "any" for any other rows, run-time values;
* the warp route (``csrc/fused_qp_warp.cu``), "warp", for everything past the
  caps up to D = N + K <= ``WARP_MAX_D``: one warp per instance, its
  condensed matrix and vectors a slab of the CTA's shared memory, any number
  of box rows on any variables. Past D = ``WARP_MAX_D`` or one CTA's shared
  memory the card raises (``_check_cuda_shape``).

Either route reads the caller's batch-major tensors at their own strides
and writes x (B, N) and y (B, K): a call is one device kernel and no copy.

Beside it sits ``_fused_qp_plain``, the same computation as plain PyTorch on
lists of ``(B,)`` tensors, a line-by-line counterpart of ``_make_qp_kernel``,
which takes feature-major views (``_fused_qp_plain_batch`` hands it the
batch-major tensors' transposed views, copying nothing). CPU tensors run it;
CUDA tensors launch the kernel or raise. The kernel builds without FMA
contraction, so on the card both agree bit for bit.

Semantics are ``qp.py::qp_ip_solve`` with ``early_exit=False``: every
iteration runs, and no tolerance ends the loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from ._common import _CUDA_DTYPE_IDS, _check_cuda_tensors, _div, _maximum, _minimum
from .fused_ik import _ldlt_apply, _ldlt_factor_unrolled

# Launches of the CUDA kernel in this process: the wrapper adds one right
# where it launches, and nowhere else.
FUSED_QP_LAUNCHES = 0

# The register route's caps: REGISTER_MAX_N[K] is the largest N it
# instantiates with K = 0, 1, 2 equality rows (from N = 1). K = 2 stops at
# N = 6: ptxas spills the float PairRows instance at N = 7 (144 B) and 8
# (356 B) and keeps N <= 6 in registers (NVIDIA H100 machine, CUDA 12.9;
# chip_smoke.py phase 9 prints every instance). K <= 1 keeps the N <= 8 it
# had. Their one home: ops/_build.py passes them to nvcc
# (-DMO_QP_REGISTER_MAX_N_K0, _K1, _K2), which instantiates just these.
REGISTER_MAX_N = (8, 8, 6)

# The warp route (csrc/fused_qp_warp.cu): D = N + K <= WARP_MAX_D, at most
# WARPS_PER_CTA instances a CTA, fewer where their slabs do not fit
# MAX_CTA_SMEM.
WARP_MAX_D = 192
WARPS_PER_CTA = 4
MAX_CTA_SMEM = 232_448  # bytes of dynamic shared memory one H100 CTA may hold
_REGISTER_BLOCK = 32  # threads a CTA on the register route (fused_qp.cuh kBlock)


def _fused_qp_plain(Gt, ct, At, bt, iat, ibt, ineq_var, iterations, sigma, barrier, has_eq_guess):
    """The kernel's computation on feature-major tensors: ``Gt (N, N, B)``
    (lower triangle read), ``ct (N, B)``, ``At (K, N, B)``, ``bt (K, B)``,
    ``iat`` / ``ibt (M, B)`` -> ``x (N, B)``, ``y (K, B)``. Operations in
    ``pallas_qp.py::_make_qp_kernel``'s order."""
    N, K, M = ct.shape[0], bt.shape[0], len(ineq_var)
    D = N + K
    G = [[Gt[i, j] for j in range(N)] for i in range(N)]
    c = [ct[i] for i in range(N)]
    A = [[At[k, j] for j in range(N)] for k in range(K)]
    b = [bt[k] for k in range(K)]
    ia = [iat[m] for m in range(M)]
    ib = [ibt[m] for m in range(M)]
    one = torch.ones_like(c[0])
    zero = torch.zeros_like(c[0])

    def gsym(i, j):
        return G[i][j] if i >= j else G[j][i]

    def assemble(sig):
        """Condensed (N+K)x(N+K) lower triangle; sig[m] = a_m^2 z/s."""
        H = [[zero] * D for _ in range(D)]
        for i in range(N):
            for j in range(i + 1):
                H[i][j] = G[i][j]
        for m in range(M):
            v = ineq_var[m]
            H[v][v] = H[v][v] + sig[m]
        for k in range(K):
            for j in range(N):
                H[N + k][j] = A[k][j]
        return H

    # Initial guess (qp.cc:439-482).
    if has_eq_guess:
        sol = _ldlt_apply(
            *_ldlt_factor_unrolled(assemble([zero] * M)),
            [-c[i] for i in range(N)] + [-b[k] for k in range(K)],
        )
        x = sol[:N]
        y = [-sol[N + k] for k in range(K)]
    else:
        x = [zero] * N
        y = [zero] * K
    # Clamp into the feasible half-lines, then s = max(1e-9, ax+b), z = 1/s.
    for m in range(M):
        v = ineq_var[m]
        t = ia[m] * x[v] + ib[m]
        x[v] = x[v] + torch.where(t < 0.0, -t / ia[m], zero)
    s = [_maximum(ia[m] * x[ineq_var[m]] + ib[m], 1e-9) for m in range(M)]
    z = [1.0 / v for v in s]

    mu = one
    tau = 0.995
    for _ in range(iterations):
        # KKT residuals (qp.cc:391-420).
        r_d = []
        for i in range(N):
            acc = c[i]
            for j in range(N):
                acc = acc + gsym(i, j) * x[j]
            for k in range(K):
                acc = acc - A[k][i] * y[k]
            r_d.append(acc)
        for m in range(M):
            r_d[ineq_var[m]] = r_d[ineq_var[m]] - ia[m] * z[m]
        r_pe = []
        for k in range(K):
            acc = b[k]
            for j in range(N):
                acc = acc + A[k][j] * x[j]
            r_pe.append(acc)
        r_pi = [ia[m] * x[ineq_var[m]] + ib[m] - s[m] for m in range(M)]
        r_c = [s[m] * z[m] for m in range(M)]
        zs = [z[m] / s[m] for m in range(M)]

        Lf, df = _ldlt_factor_unrolled(assemble([ia[m] * ia[m] * zs[m] for m in range(M)]))

        def solve_step(mu_v, corr):
            """Elimination, condensed solve, back-substitution
            (qp.cc:318-364)."""
            r_aug = list(r_d)
            for m in range(M):
                v = ineq_var[m]
                r_aug[v] = r_aug[v] + ia[m] * (zs[m] * r_pi[m] + (r_c[m] + corr[m] - mu_v) / s[m])
            sol = _ldlt_apply(Lf, df, [-v_ for v_ in r_aug] + [-r for r in r_pe])
            dx_v = sol[:N]
            dy_v = [-sol[N + k] for k in range(K)]
            ds_v = [ia[m] * dx_v[ineq_var[m]] + r_pi[m] for m in range(M)]
            dz_v = [-zs[m] * ds_v[m] - (r_c[m] + corr[m] - mu_v) / s[m] for m in range(M)]
            return dx_v, dy_v, ds_v, dz_v

        def ftb(vs, dvs, tau_v):
            alpha = one
            for v_, dv in zip(vs, dvs):
                blocking = (v_ + dv <= 0.0) & (torch.abs(dv) > 0.0)
                cand = -tau_v * v_ / torch.where(blocking, dv, one)
                alpha = _minimum(alpha, torch.where(blocking, cand, one))
            return alpha

        zeros_c = [zero] * M
        if M == 0:
            dx, dy, ds, dz = solve_step(zero, zeros_c)
        elif barrier == "mpc":
            dxa, dya, dsa, dza = solve_step(zero, zeros_c)
            ap_a = ftb(s, dsa, 1.0)
            ad_a = ftb(z, dza, 1.0)
            mu_aff = zero
            for m in range(M):
                mu_aff = mu_aff + (s[m] + ap_a * dsa[m]) * (z[m] + ad_a * dza[m])
            mu_aff = _maximum(_div(mu_aff, M), 0.0)
            ratio = mu_aff / mu
            mu_used = ratio * (ratio * ratio) * mu  # (mu_aff / mu) ** 3 * mu
            dx, dy, ds, dz = solve_step(mu_used, [dsa[m] * dza[m] for m in range(M)])
        else:
            dx, dy, ds, dz = solve_step(mu, zeros_c)

        if M > 0:
            ap = ftb(s, ds, tau)
            ad = ftb(z, dz, tau)
        else:
            ap = ad = one
        x = [x[i] + ap * dx[i] for i in range(N)]
        s = [s[m] + ap * ds[m] for m in range(M)]
        y = [y[k] + ad * dy[k] for k in range(K)]
        z = [z[m] + ad * dz[m] for m in range(M)]
        if M > 0:
            comp = zero
            for m in range(M):
                comp = comp + s[m] * z[m]
            mu = sigma * _div(comp, M)

    kw = dict(dtype=ct.dtype, device=ct.device)
    x_out = torch.stack(x) if N else torch.zeros((0, ct.shape[1]), **kw)
    y_out = torch.stack(y) if K else torch.zeros((0, ct.shape[1]), **kw)
    return x_out, y_out


def register_route(N, K, M):
    """Whether the register route has an instance for N variables, K
    equality rows and M box rows (fused_qp.cuh ``register_instance``)."""
    return 0 <= K < len(REGISTER_MAX_N) and 1 <= N <= REGISTER_MAX_N[K] and M <= 2 * N


def warp_slab_slots(N, K, M):
    """Slots of one instance's slab on the warp route
    (fused_qp_warp.cu ``warp_slab_slots``): the condensed lower triangle
    (tri(D)), the solution (D), x and r_d (N), y and r_pe (K), and twelve
    arrays of M."""
    D = N + K
    return D * (D + 1) // 2 + D + 2 * N + 2 * K + 12 * M


def warp_slab_bytes(N, K, M, dtype):
    """Bytes of one slab, in whole 16-byte units (``warp_slab_bytes``)."""
    size = torch.empty((), dtype=dtype).element_size()
    return -(-warp_slab_slots(N, K, M) * size // 16) * 16


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Kernel 6's launch for B QPs: the route ("register" or "warp"),
    instances a CTA, threads a CTA, bytes of shared memory an instance and a
    CTA (0 on the register route), and the grid."""

    route: str
    instances_per_cta: int
    threads: int
    instance_bytes: int
    cta_bytes: int
    grid: int


def launch_plan(N, K, M, B, dtype):
    """Kernel 6's launch for B QPs of N variables, K equality rows and M
    box rows in ``dtype``: the register route where its caps hold an
    instance, else the warp route, WARPS_PER_CTA instances a CTA (fewer
    where their slabs do not fit MAX_CTA_SMEM). Raises NotImplementedError
    past D = WARP_MAX_D or one CTA's shared memory (the CPU path takes any
    size)."""
    if N < 1 or K < 0 or M < 0:
        raise ValueError(f"a QP needs N >= 1, K >= 0 and M >= 0; got N = {N}, K = {K}, M = {M}")
    if register_route(N, K, M):
        return LaunchPlan("register", _REGISTER_BLOCK, _REGISTER_BLOCK, 0, 0, -(-B // _REGISTER_BLOCK))
    if N + K > WARP_MAX_D:
        raise NotImplementedError(
            f"kernel 6 takes N + K <= {WARP_MAX_D} on the card (csrc/fused_qp_warp.cu); got N = {N}, K = {K}"
        )
    slab = warp_slab_bytes(N, K, M, dtype)
    if slab > MAX_CTA_SMEM:
        raise NotImplementedError(
            f"kernel 6's slab for N = {N}, K = {K}, M = {M} in {dtype} ({slab} B) does not fit one CTA's "
            f"shared memory ({MAX_CTA_SMEM} B)"
        )
    warps = min(WARPS_PER_CTA, MAX_CTA_SMEM // slab)
    return LaunchPlan("warp", warps, 32 * warps, slab, warps * slab, -(-B // warps))


def _check_cuda_shape(N, K, M, dtype=torch.float64):
    """Raise where the card has no route for the QP's size."""
    launch_plan(N, K, M, 1, dtype)


def pair_rows(N):
    """The box rows' variables of the "pairs" route: a lo and a hi row on
    each of variables 1..N-1 (the IK problem's joint limits, in
    ``nonlinear.py::_ineq_var``'s order)."""
    return tuple(1 + m // 2 for m in range(2 * (N - 1)))


def qp_route(N, K, ineq_var, dtype=torch.float64):
    """Kernel 6's route for N variables, K equality rows and the box rows'
    variables ``ineq_var``: on the register route "pairs" where the rows are
    ``pair_rows(N)`` (the kernel has them at compile time), else "any"
    (run-time rows); past the register caps "warp". Raises where the card
    has no route. The launchers make the same choice from the rows they are
    given (``fused_qp.cuh::is_pair_rows``); this mirror names the route for
    labels and tests."""
    ineq_var = tuple(ineq_var)
    plan = launch_plan(N, K, len(ineq_var), 1, dtype)
    if any(not 0 <= v < N for v in ineq_var):
        raise ValueError(f"ineq_var {ineq_var} out of range for N = {N}")
    if plan.route == "warp":
        return "warp"
    return "pairs" if ineq_var == pair_rows(N) else "any"


def rows_table(ineq_var, N):
    """The warp route's table of the box rows, int32: var[M], then ptr[N + 1]
    and idx[M], the rows of each variable in row order (variable v's rows
    are idx[ptr[v]:ptr[v + 1]])."""
    ineq_var = tuple(int(v) for v in ineq_var)
    M = len(ineq_var)
    by_var = [[m for m in range(M) if ineq_var[m] == v] for v in range(N)]
    ptr = [0]
    for r in by_var:
        ptr.append(ptr[-1] + len(r))
    return list(ineq_var) + ptr + [m for r in by_var for m in r]


@functools.lru_cache(maxsize=64)
def _device_rows(ineq_var, N, device):
    """``rows_table`` on ``device``, copied there once per ineq_var."""
    return torch.tensor(rows_table(ineq_var, N), dtype=torch.int32, device=device)


def _fused_qp_cuda(G, c, A_eq, b_eq, ia, ib, ineq_var, iterations, sigma, barrier, has_eq_guess):
    """Launch kernel 6 on batch-major CUDA tensors at their own strides: G
    (B, N, N) (lower triangle read), c (B, N), A_eq (B, K, N), b_eq (B, K),
    ia / ib (B, M) -> x (B, N), y (B, K), as ``_fused_qp_plain_batch``, on
    the route ``launch_plan`` picks. Copies nothing (but the warp route's
    rows table, once per ineq_var and device); raises on anything the kernel
    does not take and on a refused launch."""
    global FUSED_QP_LAUNCHES
    B, N = c.shape
    K, M = b_eq.shape[1], len(ineq_var)
    qp_route(N, K, ineq_var, c.dtype)
    _check_cuda_tensors(
        (
            ("G", G, (B, N, N)), ("c", c, (B, N)), ("A_eq", A_eq, (B, K, N)),
            ("b_eq", b_eq, (B, K)), ("ia", ia, (B, M)), ("ib", ib, (B, M)),
        ),
        c.dtype, c.device, B, contiguous=False,
    )
    x = torch.empty((B, N), dtype=c.dtype, device=c.device)
    y = torch.empty((B, K), dtype=c.dtype, device=c.device)
    if B == 0:
        return x, y
    plan = launch_plan(N, K, M, B, c.dtype)
    strides = (ctypes.c_longlong * 14)(*(v for t in (G, c, A_eq, b_eq, ia, ib) for v in t.stride()))
    tensors = (G.data_ptr(), c.data_ptr(), A_eq.data_ptr(), b_eq.data_ptr(), ia.data_ptr(), ib.data_ptr(),
               strides, x.data_ptr(), y.data_ptr(), B)
    schedule = (iterations, ctypes.c_double(sigma), int(barrier == "mpc"), int(bool(has_eq_guess)))
    lib = _build.load_library()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "register":
            var = (ctypes.c_int * max(M, 1))(*ineq_var)
            rc = lib.mo_fused_qp_launch(_CUDA_DTYPE_IDS[c.dtype], N, K, M, var, *tensors, *schedule, stream)
        else:
            rows = _device_rows(tuple(ineq_var), N, c.device)
            rc = lib.mo_fused_qp_warp_launch(_CUDA_DTYPE_IDS[c.dtype], N, K, M, rows.data_ptr(), *tensors,
                                             plan.instances_per_cta, *schedule, stream)
    if rc != 0:
        raise RuntimeError(f"fused QP kernel launch failed ({plan.route} route): {_build.error_string(rc)}")
    FUSED_QP_LAUNCHES += 1
    return x, y


def _fused_qp_plain_batch(G, c, A_eq, b_eq, ia, ib, ineq_var, iterations, sigma, barrier, has_eq_guess):
    """The plain counterpart of ``_fused_qp_cuda``: ``_fused_qp_plain`` on the
    batch-major tensors' feature-major views (no copy) -> x (B, N), y (B, K)."""
    x, y = _fused_qp_plain(
        G.permute(1, 2, 0), c.T, A_eq.permute(1, 2, 0), b_eq.T, ia.T, ib.T,
        ineq_var, iterations, sigma, barrier, has_eq_guess,
    )
    return x.T, y.T


def _fused_qp_batch(G, c, A_eq, b_eq, ia, ib, *, ineq_var, iterations, sigma, barrier, has_eq_guess):
    """Batch-first: G (B, N, N), c (B, N), A_eq (B, K, N), b_eq (B, K),
    ia / ib (B, M) -> x (B, N), y (B, K). CUDA tensors launch kernel 6 on
    the tensors as they are; CPU tensors run the plain version."""
    if barrier not in ("complementarity", "mpc"):
        raise ValueError(f"barrier must be 'complementarity' or 'mpc', not {barrier!r}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    ineq_var = tuple(int(v) for v in ineq_var)
    if ia.shape[-1] != len(ineq_var) or ib.shape[-1] != len(ineq_var):
        raise ValueError(f"ia and ib need {len(ineq_var)} columns, one per ineq_var entry")
    args = (G, c, A_eq, b_eq, ia, ib, ineq_var, iterations, sigma, barrier, has_eq_guess)
    if c.is_cuda:
        return _fused_qp_cuda(*args)
    if c.device.type == "cpu":
        return _fused_qp_plain_batch(*args)
    raise NotImplementedError(f"no fused QP for device {c.device}")


def make_fused_qp_solver(
    ineq_var: tuple,
    iterations: int,
    sigma: float = 0.1,
    barrier: str = "complementarity",
    has_eq_guess: bool = True,
):
    """``solve(G, c, A_eq, b_eq, ia, ib) -> (x, y)`` for batch-first QPs with
    the static box-row variables ``ineq_var``: one kernel launch solves the
    whole batch (the JAX package's vmapped call)."""

    def solve(G, c, A_eq, b_eq, ia, ib):
        return _fused_qp_batch(
            G, c, A_eq, b_eq, ia, ib, ineq_var=ineq_var, iterations=iterations,
            sigma=sigma, barrier=barrier, has_eq_guess=has_eq_guess,
        )

    return solve
