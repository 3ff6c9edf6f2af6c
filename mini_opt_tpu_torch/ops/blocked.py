"""The medium-N blocked tier, the PyTorch port of
``mini_opt_tpu/ops/pallas_blocked.py``.

Past ``REGISTER_KKT_MAX`` (D = n + m_eq > 32) the register tier's fully
unrolled solver stops, and ``fused_solve_batch`` hands the family to
``blocked_solve_batch`` here. Two CUDA kernels replace the two TPU kernels
of ``pallas_blocked.py``:

* ``csrc/blocked.cu`` and ``blocked_f64.cu`` (device code
  ``csrc/blocked_sqp.cuh``): the whole fused SQP, one warp per instance and
  ``launch_plan(slab_shape(family), B, dtype).warps`` instances per CTA,
  the instance's KKT matrix (its lower triangle in 4-row tiles) factored in
  its slab of shared memory; past one CTA's shared memory or D = 192, in a
  slab of a global scratch array that each warp of the grid reuses for the
  instances it solves in turn (the global route, up to D = 256). It replaces
  ``_make_blocked_kernel``. The hand-written planar and spatial chains'
  instances are in ``blocked.cu``, ``blocked_f64.cu``,
  ``blocked_spatial.cu`` and ``blocked_spatial_f64.cu`` (the global route's
  in ``blocked_global.cu``, ``blocked_spatial_global.cu`` and their
  ``_f64`` twins); a family generated
  from a Problem gets its own
  instance, emitted by ``ops/fused_emit.py``'s blocked target and built at
  first use (``csrc/blocked_launch.cuh``). Both read the caller's
  batch-major tensors at their strides, so a ``blocked_solve_batch`` call on
  card tensors is one device kernel; its results are the transposed views of
  feature-major outputs.
* ``csrc/blocked_kkt.cu``: one dense LDL^T factor and solve per system,
  one warp per system up to D = 192 (kernel 2's routines, ``kkt_launch_plan``)
  and one CTA per system past it. It replaces the kernel of
  ``blocked_kkt_solve``.

Beside each sits its plain PyTorch version on stacked feature-major tensors,
``_blocked_solve_plain`` (G as ``(n, n, B)``, J_eq ``(m, n, B)``, the KKT
matrix ``(D, D, B)``) and ``_blocked_kkt_solve_plain``. Where the JAX kernel
sums a stacked axis with ``jnp.sum``, the plain version adds the terms one
by one in index order, and the kernels keep that order, so that on the card
kernel and plain version round alike. CPU tensors run the plain versions;
CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import convert
from . import _build
from ._common import (
    _CUDA_DTYPE_IDS,
    _check_cuda_tensors,
    _check_options,
    _div,
    _maximum,
    _minimum,
    _sign,
)

# Largest D = n + m_eq the register tier takes (pallas_blocked.py:60);
# fused_solve_batch sends larger families here.
REGISTER_KKT_MAX = 32

_TAU_FTB = 0.995

# Launches of the two CUDA kernels in this process: each wrapper adds one
# right where it launches, and nowhere else. BLOCKED_LAUNCHES counts kernel
# 2's hand-written instances (csrc/blocked.cu), GENERATED_LAUNCHES the
# instances emitted for families generated from a Problem.
BLOCKED_LAUNCHES = 0
GENERATED_LAUNCHES = 0
KKT_LAUNCHES = 0

# Families with a blocked-tier device functor (csrc/families.cuh
# PlanarChain, SpatialChain).
_CUDA_FAMILY_IDS = {"planar": 0, "spatial": 1}

# Kernel 2's launch (csrc/blocked_sqp.cuh): one warp per instance, up to
# WARPS_PER_CTA instances per CTA, each instance's slab in the CTA's dynamic
# shared memory; lane l owns KKT rows l, l + 32, ..., up to
# MAX_ROWS_PER_LANE of them.
WARPS_PER_CTA = 4
MAX_CTA_SMEM = 232_448  # bytes of dynamic shared memory one H100 CTA may hold
MAX_ROWS_PER_LANE = 6
# The global route, past one CTA's shared memory or 32 * MAX_ROWS_PER_LANE
# rows: one warp a CTA, GLOBAL_SLABS warps in the grid at most, each with a
# slab of a (slabs, bytes) global scratch on which it solves instances w, w +
# slabs, ... in turn; up to MAX_GLOBAL_D rows (8 a lane; the tile table
# holds a row and a column in 8 bits each). At D = 256, B = 8192 the grid of
# 264 warps (2 an SM) ran in 2.86 s a call, 132 in 4.12, 528 in 3.77, 1056
# in 3.02 (H100, float32, 6/3/2).
GLOBAL_SLABS = 264
MAX_GLOBAL_D = 256


def _tri(k):
    return k * (k + 1) // 2


def kkt_slots(D: int) -> int:
    """Slots of the D x D KKT matrix in kernel 2's tiled layout
    (csrc/blocked_sqp.cuh ``colA``): its lower triangle by columns, column
    j holding rows (j & ~3) .. Dp - 1 with Dp = D rounded up to 4."""
    Dp = -(-D // 4) * 4
    return sum(Dp - (j & ~3) for j in range(D))


@dataclasses.dataclass(frozen=True)
class SlabShape:
    """What kernel 2's slab of one instance holds for a family
    (csrc/blocked_sqp.cuh ``carve``): ``n`` variables, ``m`` equality rows,
    ``rows`` data rows, ``nlo`` / ``nhi`` bounded variables and the family's
    own ``scratch`` slots."""

    n: int
    m: int
    rows: int
    nlo: int
    nhi: int
    scratch: int


def planar_slab_shape(n: int) -> SlabShape:
    """The hand-written planar chain's (csrc/families.cuh ``PlanarChain``):
    one equality row, two data rows, joints 1..n-1 bounded on both sides, and
    3n scratch slots (the cumulative angles' cosines and sines, J_y)."""
    return SlabShape(n, 1, 2, n - 1, n - 1, 3 * n)


def spatial_slab_shape(n: int) -> SlabShape:
    """The hand-written spatial chain's (csrc/families.cuh ``SpatialChain``):
    one equality row, three data rows, joints 1..n-1 bounded on both sides,
    and 8n scratch slots (each joint's axis and origin, J_y, J_z)."""
    return SlabShape(n, 1, 3, n - 1, n - 1, 8 * n)


def slab_shape(family) -> SlabShape:
    """The slab shape of ``family`` on kernel 2: its hand-written functor's,
    or a generated family's with the scratch of its emitted blocked functor
    (``ops/fused_emit.py``)."""
    if family.cuda_functor is not None:
        if family.cuda_functor[0] == "spatial":
            return spatial_slab_shape(family.n)
        return planar_slab_shape(family.n)
    return SlabShape(
        family.n, family.m_eq, family.data_rows,
        sum(v is not None for v in family.lower), sum(v is not None for v in family.upper),
        family.cuda_program.blocked_scratch(),
    )


def _round4(k):
    return -(-k // 4) * 4


def slab_slots(s: SlabShape, dtype: torch.dtype) -> int:
    """Slots (of ``dtype``) of one instance's slab, counted as
    csrc/blocked_sqp.cuh's ``carve`` takes them, for the family of slab
    shape ``s`` (``slab_shape(family)``, ``planar_slab_shape(n)``): the
    tiled KKT matrix (``kkt_slots(D)``, D = n + m), the scratch area (the largest of the
    family's own scratch, the four arrays of step candidates, each padded to
    whole tiles of 4, and n terms of a sum; in whole tiles), the factor's w
    / the published vector (D), the packed Gauss-Newton Hessian (tri(n)),
    J_eq (m n), c (n), r_eq (m), the iterate (n), the data rows, and the
    2-byte table of the KKT matrix's tiles."""
    D = s.n + s.m
    scratch = _round4(max(s.scratch, 2 * (_round4(s.nlo) + _round4(s.nhi)), s.n))
    table = -(-2 * (kkt_slots(D) // 4) // torch.empty((), dtype=dtype).element_size())
    return kkt_slots(D) + scratch + D + _tri(s.n) + s.m * s.n + s.n + s.m + s.n + s.rows + table


def rows_per_lane(D: int) -> int:
    """KKT rows a lane owns in the kernel instance that takes D rows:
    csrc/blocked_sqp.cuh's ``rows_per_lane`` (0: no instance)."""
    return 2 if D <= 64 else 4 if D <= 128 else 6 if D <= 32 * MAX_ROWS_PER_LANE else 0


def global_rows_per_lane(D: int) -> int:
    """The same on the global route: csrc/blocked_sqp.cuh's
    ``global_rows_per_lane`` (6 or 8; 0: no instance)."""
    return 6 if D <= 192 else 8 if D <= MAX_GLOBAL_D else 0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How kernel 2 launches for B instances of a family: ``storage``
    "shared" (each instance's slab in its CTA's dynamic shared memory) or
    "global" (each warp of the grid's slab a row of a (``slabs``,
    ``warp_bytes``) global scratch array, 0 slabs on the shared route);
    ``warps`` (instances) per CTA, ``rows_per_lane`` of the KKT system,
    ``slots`` of one instance's slab and its ``warp_bytes`` (rounded up to
    16), ``cta_bytes`` of dynamic shared memory per CTA, ``grid`` CTAs."""

    warps: int
    rows_per_lane: int
    slots: int
    warp_bytes: int
    cta_bytes: int
    grid: int
    storage: str = "shared"
    slabs: int = 0


def launch_plan(s: SlabShape, B: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of kernel 2 for B instances in ``dtype`` of the family
    of slab shape ``s`` (``slab_shape(family)``, ``planar_slab_shape(n)``):
    on the shared route WARPS_PER_CTA instances per CTA, fewer where that
    many slabs do not fit MAX_CTA_SMEM; where one slab does not fit a CTA
    or D = n + m exceeds 32 * MAX_ROWS_PER_LANE, the global route (one warp a
    CTA, min(B, GLOBAL_SLABS) slabs). Raises ValueError past MAX_GLOBAL_D:
    the kernel has no route for those sizes (the CPU path takes them)."""
    D = s.n + s.m
    size = torch.empty((), dtype=dtype).element_size()
    slots = slab_slots(s, dtype)
    # Whole 16-byte units, so that every slab is aligned alike.
    warp_bytes = -(-slots * size // 16) * 16
    rows = rows_per_lane(D)
    if rows and warp_bytes <= MAX_CTA_SMEM:
        warps = min(WARPS_PER_CTA, MAX_CTA_SMEM // warp_bytes)
        return LaunchPlan(warps, rows, slots, warp_bytes, warps * warp_bytes, -(-B // warps))
    rows = global_rows_per_lane(D)
    if rows == 0:
        raise ValueError(
            f"the blocked kernel takes no n = {s.n}: D = {D} passes its global route's {MAX_GLOBAL_D} rows "
            f"(8 a lane); one instance's slab would be {warp_bytes} B, past one CTA's {MAX_CTA_SMEM} B"
        )
    slabs = min(B, GLOBAL_SLABS)
    return LaunchPlan(1, rows, slots, warp_bytes, 0, slabs, "global", slabs)


def kkt_slab_slots(D: int, dtype: torch.dtype) -> int:
    """Slots (of ``dtype``) of one system's slab on kernel 3's warp route
    (csrc/blocked_kkt.cu ``warp_slab_bytes``): the tiled lower triangle
    (``kkt_slots(D)``), the factor's w (D, in whole tiles of 4) and the
    2-byte table of the triangle's tiles."""
    size = torch.empty((), dtype=dtype).element_size()
    a = kkt_slots(D)
    return a + -(-D // 4) * 4 + -(-2 * (a // 4) // size)


# Kernel 3's CTA route (past the warp route's D): one thread per row, at
# most this many.
KKT_CTA_THREADS = 256


@dataclasses.dataclass(frozen=True)
class KKTLaunchPlan:
    """How kernel 3 launches for B systems of D rows: ``route`` "warp" (one
    warp per system, ``warps`` systems per CTA, ``rows_per_lane`` rows a
    lane) or "cta" (one CTA of ``threads`` threads per system, ``warps`` 1,
    ``rows_per_lane`` 0); ``system_bytes`` of shared memory per system,
    ``cta_bytes`` per CTA, ``grid`` CTAs."""

    route: str
    warps: int
    rows_per_lane: int
    threads: int
    system_bytes: int
    cta_bytes: int
    grid: int


def kkt_launch_plan(D: int, B: int, dtype: torch.dtype) -> KKTLaunchPlan:
    """The launch plan of kernel 3 for B systems of D rows in ``dtype``:
    the warp route up to D = 32 * MAX_ROWS_PER_LANE (WARPS_PER_CTA systems
    per CTA, fewer where that many slabs do not fit MAX_CTA_SMEM), the CTA
    route past it (PR 5's design: a (D, D | 1) matrix, d and w in one CTA's
    shared memory). Raises ValueError where neither route takes D (the CPU
    path takes any D)."""
    size = torch.empty((), dtype=dtype).element_size()
    rows = rows_per_lane(D)
    if rows:
        slab = -(-kkt_slab_slots(D, dtype) * size // 16) * 16
        warps = min(WARPS_PER_CTA, MAX_CTA_SMEM // slab)
        return KKTLaunchPlan("warp", warps, rows, 32 * warps, slab, warps * slab, -(-B // warps))
    threads = -(-D // 32) * 32
    cta = (D * (D | 1) + 2 * D) * size
    if threads > KKT_CTA_THREADS or cta > MAX_CTA_SMEM:
        raise ValueError(
            f"the blocked KKT kernel takes no D = {D} in {dtype}: one system's matrix ({cta} B) "
            f"does not fit a CTA ({MAX_CTA_SMEM} B, {KKT_CTA_THREADS} threads)"
        )
    return KKTLaunchPlan("cta", 1, 0, threads, cta, cta, B)


# ---------------------------------------------------------------------------
# Stacked algebra in a fixed summation order.
# ---------------------------------------------------------------------------


def _rowsum(t):
    """Sum over the leading axis in index order: t[0] + t[1] + ..."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def _matvec(A, v):
    """(k, n, B) @ (n, B) -> (k, B), summed over n in index order."""
    acc = A[:, 0] * v[0]
    for j in range(1, A.shape[1]):
        acc = acc + A[:, j] * v[j]
    return acc


def _matvec_t(A, y):
    """(m, n, B)^T @ (m, B) -> (n, B), summed over m in index order."""
    acc = A[0] * y[0]
    for k in range(1, A.shape[0]):
        acc = acc + A[k] * y[k]
    return acc


@functools.lru_cache(maxsize=16)
def _trailing_tril(D, device):
    """Per pivot k, the lower triangle of the trailing block as indices
    relative to row/column k + 1 and as absolute indices (precomputed, so
    that the factorization's own work has no index arithmetic)."""
    out = []
    for k in range(D):
        ii, jj = torch.tril_indices(D - k - 1, D - k - 1, device=device).unbind(0)
        out.append((ii, jj, ii + (k + 1), jj + (k + 1)))
    return out


def _ldlt_factor(A):
    """Unpivoted LDL^T of the stacked ``(D, D, B)`` systems; only the lower
    triangle is read. Returns ``(A, d)``: the strict lower triangle of the
    returned A holds L (its unit diagonal implied), ``d (D, B)`` the pivots.

    Right-looking: step k divides column k by its pivot and updates the
    trailing lower triangle, ``A_ij -= L_ik * (d_k * L_jk)``. Every entry thus
    takes its updates in the order k = 0, 1, ..., as in the column recurrence
    of pallas_blocked.py:163-179 and in the kernels."""
    A = A.clone()
    D = A.shape[0]
    tril = _trailing_tril(D, A.device)
    d = []
    for k in range(D):
        dk = A[k, k].clone()
        d.append(dk)
        if k + 1 == D:
            break
        lk = A[k + 1 :, k] / dk
        A[k + 1 :, k] = lk
        w = dk * lk
        ii, jj, rows, cols = tril[k]
        A[rows, cols] = A[rows, cols] - lk[ii] * w[jj]
    return A, torch.stack(d)


def _ldlt_solve(L, d, rhs):
    """Solve ``L diag(d) L^T x = rhs`` for a ``(D, B)`` rhs, L from
    ``_ldlt_factor``. Forward substitution subtracts L_ik x_k for k = 0, 1,
    ...; back substitution subtracts L_kj x_k for k = D-1, D-2, ..."""
    x = rhs.clone()
    D = x.shape[0]
    for k in range(D - 1):
        x[k + 1 :] = x[k + 1 :] - L[k + 1 :, k] * x[k]
    x = x / d
    for k in range(D - 1, 0, -1):
        x[:k] = x[:k] - L[k, :k] * x[k]
    return x


def _factor_bad(d):
    """1.0 on lanes where any pivot is (near-)zero or non-finite, else 0.0
    (pallas_blocked.py:175-179)."""
    good = (torch.abs(d) > torch.finfo(d.dtype).tiny) & torch.isfinite(d)
    return torch.where(good.all(0), torch.zeros_like(d[0]), torch.ones_like(d[0]))


def _kkt(G, Jeq, sig_d):
    """The condensed KKT matrix [[G + diag(sig_d), .], [J_eq, 0]] as a
    stacked ``(D, D, B)`` tensor; only its lower triangle is meaningful
    (pallas_blocked.py:203-225). ``sig_d`` None leaves G's diagonal as is."""
    n, B = G.shape[0], G.shape[2]
    m = 0 if Jeq is None else Jeq.shape[0]
    A = G.new_zeros((n + m, n + m, B))
    A[:n, :n] = G
    if sig_d is not None:
        idx = torch.arange(n, device=G.device)
        A[idx, idx] = G[idx, idx] + sig_d
    if m:
        A[n:, :n] = Jeq
    return A


# ---------------------------------------------------------------------------
# The fused solve: plain version and kernel wrapper.
# ---------------------------------------------------------------------------


def _blocked_solve_plain(
    family,
    data_t,
    x0_t,
    max_iterations,
    qp_iterations,
    ls_iterations,
    line_search="armijo",
    barrier="mpc",
):
    """The blocked kernel's computation as plain PyTorch on feature-major
    tensors: ``data_t (rows, B)``, ``x0_t (n, B)`` -> ``x (n, B)``,
    ``state (3, B)`` = (f, |eq|_1, flags).

    A counterpart of ``pallas_blocked.py::_make_blocked_kernel``
    statement by statement (``qp_solve`` :227-424, ``core`` :426-625): the
    family's outputs stacked once per outer iteration, the QP interior point
    on the stacked KKT system, the L1-merit line search, the lambda machine,
    the best-merit return with ``f_best`` starting at +inf."""
    n = family.n
    m = family.m_eq
    lo_list = [(i, lo) for i, lo in enumerate(family.lower) if lo is not None]
    hi_list = [(i, hi) for i, hi in enumerate(family.upper) if hi is not None]
    n_lo, n_hi = len(lo_list), len(hi_list)
    ncon = n_lo + n_hi
    dev = data_t.device
    lo_t = torch.tensor([i for i, _ in lo_list], dtype=torch.long, device=dev)
    hi_t = torch.tensor([i for i, _ in hi_list], dtype=torch.long, device=dev)
    eye = torch.eye(n, dtype=data_t.dtype, device=dev)[:, :, None]

    def scatter(vals, idx):
        """(k, B) rows at unique indices -> (n, B), zeros elsewhere."""
        out = vals.new_zeros((n, vals.shape[1]))
        out[idx] = vals
        return out

    def ftb(pairs, tau_v, one):
        alpha = one
        for v, dv in pairs:
            if v is None:
                continue
            blocking = (v + dv <= 0.0) & (torch.abs(dv) > 0.0)
            cand = -tau_v * v / torch.where(blocking, dv, torch.ones_like(dv))
            cand = torch.where(blocking, cand, torch.ones_like(cand))
            alpha = torch.minimum(alpha, torch.amin(cand, 0))
        return alpha

    def qp_solve(G, c, Jeq, beq, ib_lo, ib_hi, one, zero):
        """Interior point on the stacked condensed system. Returns (dx (n, B),
        y (m, B) or None, bad (B,))."""
        A, d = _ldlt_factor(_kkt(G, Jeq, None))
        bad = _factor_bad(d)
        sol = _ldlt_solve(A, d, torch.cat([-c, -beq]) if m else -c)
        x = sol[:n]
        y = -sol[n:] if m else None
        if ncon == 0:
            return x, y, bad

        # Clamp into the shifted bounds, then slack/dual init (qp.cc:470-481).
        x = x.clone()
        if n_lo:
            x[lo_t] = _maximum(x[lo_t], -ib_lo)
        if n_hi:
            x[hi_t] = _minimum(x[hi_t], ib_hi)
        s_lo = _maximum(x[lo_t] + ib_lo, 1e-9) if n_lo else None
        s_hi = _maximum(-x[hi_t] + ib_hi, 1e-9) if n_hi else None
        z_lo = 1.0 / s_lo if n_lo else None
        z_hi = 1.0 / s_hi if n_hi else None
        zl = torch.zeros_like(s_lo) if n_lo else None
        zh = torch.zeros_like(s_hi) if n_hi else None

        mu = one
        for _ in range(qp_iterations):
            # KKT residuals (eqs 19.2a-d, qp.cc:391-420).
            r_d = c + _matvec(G, x)
            if m:
                r_d = r_d - _matvec_t(Jeq, y)
            if n_lo:
                r_d = r_d - scatter(z_lo, lo_t)
            if n_hi:
                r_d = r_d + scatter(z_hi, hi_t)
            r_pe = beq + _matvec(Jeq, x) if m else None
            r_pi_lo = x[lo_t] + ib_lo - s_lo if n_lo else None
            r_pi_hi = -x[hi_t] + ib_hi - s_hi if n_hi else None
            r_c_lo = s_lo * z_lo if n_lo else None
            r_c_hi = s_hi * z_hi if n_hi else None
            sig_lo = z_lo / s_lo if n_lo else None
            sig_hi = z_hi / s_hi if n_hi else None
            sig_d = torch.zeros_like(c)
            if n_lo:
                sig_d = sig_d + scatter(sig_lo, lo_t)
            if n_hi:
                sig_d = sig_d + scatter(sig_hi, hi_t)
            A, d = _ldlt_factor(_kkt(G, Jeq, sig_d))
            bad = torch.maximum(bad, _factor_bad(d))

            def solve_step(mu_v, corr_lo, corr_hi):
                r_aug = r_d
                if n_lo:
                    r_aug = r_aug + scatter(
                        sig_lo * r_pi_lo + (r_c_lo + corr_lo - mu_v) / s_lo, lo_t
                    )
                if n_hi:
                    r_aug = r_aug - scatter(
                        sig_hi * r_pi_hi + (r_c_hi + corr_hi - mu_v) / s_hi, hi_t
                    )
                sol = _ldlt_solve(A, d, torch.cat([-r_aug, -r_pe]) if m else -r_aug)
                dx_v = sol[:n]
                dy_v = -sol[n:] if m else None
                ds_lo_v = dx_v[lo_t] + r_pi_lo if n_lo else None
                ds_hi_v = -dx_v[hi_t] + r_pi_hi if n_hi else None
                dz_lo_v = (
                    -sig_lo * ds_lo_v - (r_c_lo + corr_lo - mu_v) / s_lo if n_lo else None
                )
                dz_hi_v = (
                    -sig_hi * ds_hi_v - (r_c_hi + corr_hi - mu_v) / s_hi if n_hi else None
                )
                return dx_v, dy_v, ds_lo_v, ds_hi_v, dz_lo_v, dz_hi_v

            if barrier == "mpc":
                # Mehrotra predictor-corrector (alg 16.4 / qp.cc:170-188).
                _, _, dsl_a, dsh_a, dzl_a, dzh_a = solve_step(zero, zl, zh)
                ap_a = ftb([(s_lo, dsl_a), (s_hi, dsh_a)], 1.0, one)
                ad_a = ftb([(z_lo, dzl_a), (z_hi, dzh_a)], 1.0, one)
                mu_aff = zero
                if n_lo:
                    mu_aff = mu_aff + _rowsum((s_lo + ap_a * dsl_a) * (z_lo + ad_a * dzl_a))
                if n_hi:
                    mu_aff = mu_aff + _rowsum((s_hi + ap_a * dsh_a) * (z_hi + ad_a * dzh_a))
                mu_aff = _maximum(_div(mu_aff, ncon), 0.0)
                ratio = mu_aff / mu
                sigma = ratio * (ratio * ratio)  # jax.lax.integer_pow(ratio, 3)
                dx, dy, ds_lo, ds_hi, dz_lo, dz_hi = solve_step(
                    sigma * mu,
                    dsl_a * dzl_a if n_lo else None,
                    dsh_a * dzh_a if n_hi else None,
                )
            else:
                dx, dy, ds_lo, ds_hi, dz_lo, dz_hi = solve_step(mu, zl, zh)

            ap = ftb([(s_lo, ds_lo), (s_hi, ds_hi)], _TAU_FTB, one)
            ad = ftb([(z_lo, dz_lo), (z_hi, dz_hi)], _TAU_FTB, one)
            x = x + ap * dx
            comp = zero
            if n_lo:
                s_lo = s_lo + ap * ds_lo
                z_lo = z_lo + ad * dz_lo
                comp = comp + _rowsum(s_lo * z_lo)
            if n_hi:
                s_hi = s_hi + ap * ds_hi
                z_hi = z_hi + ad * dz_hi
                comp = comp + _rowsum(s_hi * z_hi)
            if m:
                y = y + ad * dy
            mu = 0.1 * _div(comp, ncon)
        bad = torch.maximum(bad, torch.where(torch.isfinite(x).all(0), zero, one))
        return x, y, bad

    tgt = [data_t[i] for i in range(family.data_rows)]
    th = x0_t
    one = torch.ones_like(th[0])
    zero = torch.zeros_like(one)

    def const(v):
        return torch.full_like(one, v)

    lam = 0.001 * one
    penalty = 0.01 * one
    restore = zero
    th_best = th
    f_best = const(float("inf"))
    eq_best = zero
    fac_bad = lam_maxed = accepted = f_acc = eq_acc = f_pre = eq_pre = zero

    for _ in range(max_iterations):
        f_pre, r_eq, Jeq_n, G0, c_l = family.linearize(list(th), tgt)
        c = torch.stack(c_l)
        beq = torch.stack(r_eq) if m else None
        Jeq = torch.stack([torch.stack(row) for row in Jeq_n]) if m else None
        # Full symmetric G from the lower-triangle lists.
        G_sym = torch.stack(
            [torch.stack([G0[max(i, j)][min(i, j)] for j in range(n)]) for i in range(n)]
        )
        eq_pre = _rowsum(torch.abs(beq)) if m else zero

        better = f_pre + penalty * eq_pre < f_best + penalty * eq_best
        th_best = torch.where(better, th, th_best)
        f_best = torch.where(better, f_pre, f_best)
        eq_best = torch.where(better, eq_pre, eq_best)

        G = G_sym + lam * eye
        ib_lo = torch.stack([th[i] - lo for i, lo in lo_list]) if n_lo else None
        ib_hi = torch.stack([hi - th[i] for i, hi in hi_list]) if n_hi else None

        dx, y, bad_it = qp_solve(G, c, Jeq, beq, ib_lo, ib_hi, one, zero)
        fac_bad = torch.maximum(fac_bad, bad_it)

        d_f = _rowsum(c * dx)
        if m:
            y_abs = torch.amax(torch.abs(y), 0)
            penalty = torch.where(y_abs > penalty, y_abs * 1.01, penalty)
            d_eq = _rowsum(_sign(beq) * _matvec(Jeq, dx))
        else:
            d_eq = zero
        dd = d_f + penalty * d_eq
        merit_pre = f_pre + penalty * eq_pre

        alpha = one
        accepted = zero
        dead = zero  # lanes whose polynomial fit went invalid
        best = th
        f_acc = f_pre
        eq_acc = eq_pre
        alpha_prev = one
        phi_prev = merit_pre
        alpha_prev2 = 2.0 * one
        phi_prev2 = merit_pre
        for probe in range(ls_iterations + 1):
            if probe > 0:
                if line_search == "armijo":
                    alpha = alpha * 0.5
                else:
                    # Quadratic fit (probe 1), cubic after, with validity
                    # gating; an invalid fit kills the lane's remaining probes.
                    if probe == 1:
                        num = phi_prev - dd * alpha_prev - merit_pre
                        num_s = torch.where(num == 0.0, one, num)
                        a_new = -dd * alpha_prev * alpha_prev / (2.0 * num_s)
                        valid = (dd <= 0.0) & (num > 0.0)
                    else:
                        a0, a1 = alpha_prev2, alpha_prev
                        r0 = phi_prev2 - merit_pre - dd * a0
                        r1 = phi_prev - merit_pre - dd * a1
                        det = a0 * a0 * a1 * a1 * (a0 - a1)
                        det_s = torch.where(det == 0.0, one, det)
                        ca = (a1 * a1 * r0 - a0 * a0 * r1) / det_s
                        cb = (-a1 * a1 * a1 * r0 + a0 * a0 * a0 * r1) / det_s
                        arg = cb * cb - 3.0 * ca * dd
                        ca_s = torch.where(ca == 0.0, one, ca)
                        a_new = (-cb + torch.sqrt(_maximum(arg, 1e-30))) / (3.0 * ca_s)
                        valid = (ca != 0.0) & (arg >= -1e-12) & (det != 0.0)
                    valid = valid & (a_new > 0.0) & (a_new < alpha)
                    dead = torch.maximum(dead, (1.0 - valid.to(one.dtype)) * (1.0 - accepted))
                    alpha = torch.where(valid, a_new, alpha * 0.5)
            cand = th + alpha * dx
            if family.retract is not None:
                cand = torch.stack(family.retract(list(cand)))
            f_c, eq_c = family.errors(list(cand), tgt)
            merit_c = f_c + penalty * eq_c
            # Armijo with the slack term clamped to <= 0.
            ok = (merit_c <= merit_pre + 1e-4 * alpha * _minimum(dd, zero)).to(one.dtype)
            take = ok * (1.0 - accepted) * (1.0 - dead)
            best = take * cand + (1.0 - take) * best
            f_acc = take * f_c + (1.0 - take) * f_acc
            eq_acc = take * eq_c + (1.0 - take) * eq_acc
            accepted = _minimum(accepted + take, 1.0)
            alpha_prev2, phi_prev2 = alpha_prev, phi_prev
            alpha_prev, phi_prev = alpha, merit_c

        th = torch.where(accepted > 0, best, th)
        lam_succ = _maximum(lam * torch.where(restore > 0, const(0.8), const(0.1)), 1e-9)
        lam_fail = torch.where(restore > 0, lam * 10.0, _maximum(0.001 * one, lam * 10.0))
        lam = torch.where(accepted > 0, lam_succ, lam_fail)
        restore = torch.where(accepted > 0, zero, one)
        lam_maxed = torch.where((accepted == 0) & (lam > 1.0), one, zero)

    f_fin = torch.where(accepted > 0, f_acc, f_pre)
    eq_fin = torch.where(accepted > 0, eq_acc, eq_pre)
    better = f_fin + penalty * eq_fin < f_best + penalty * eq_best
    x_out = torch.where(better, th, th_best)
    state = torch.stack(
        [
            torch.where(better, f_fin, f_best),
            torch.where(better, eq_fin, eq_best),
            fac_bad + 2.0 * lam_maxed,
        ]
    )
    return x_out, state


def _blocked_solve_cuda(
    family,
    data_t,
    x0_t,
    max_iterations,
    qp_iterations,
    ls_iterations,
    line_search="armijo",
    barrier="mpc",
):
    """Launch kernel 2 on feature-major CUDA tensors at their own strides
    (the transposed views of batch-major tensors are read where they lie);
    same contract as ``_blocked_solve_plain``. A hand-written family runs its
    instance in ``csrc/blocked.cu``; a family generated from a Problem runs
    the instance that ``ops/fused_emit.py`` emitted and built for it. Copies
    nothing; raises on anything the kernel does not take and on a refused
    launch."""
    global BLOCKED_LAUNCHES, GENERATED_LAUNCHES
    if family.cuda_functor is not None and family.cuda_functor[0] not in _CUDA_FAMILY_IDS:
        raise NotImplementedError(
            f"no blocked-tier functor for the {family.cuda_functor[0]!r} family in "
            "csrc/families.cuh; build the family with family_from_problem, whose program "
            "the family-to-CUDA emitter's blocked target turns into its instance of the kernel"
        )
    if family.cuda_functor is None and family.cuda_program is None:
        raise NotImplementedError(
            "this FusedFamily has neither a hand-written device functor (cuda_functor) "
            "nor a generated device program (cuda_program): build it with "
            "family_from_problem, whose program the family-to-CUDA emitter's blocked "
            "target turns into the family's instance of the kernel"
        )
    n = family.n
    B = data_t.shape[1] if data_t.dim() == 2 else -1
    _check_cuda_tensors(
        (("data", data_t, (family.data_rows, B)), ("x0", x0_t, (n, B))),
        data_t.dtype, data_t.device, B, contiguous=False,
    )
    # A size without a route raises ValueError, and an emitted source is
    # built, before anything is allocated: an operation the emitter cannot
    # mirror raises UnsupportedOp here.
    plan = launch_plan(slab_shape(family), max(B, 1), data_t.dtype)
    if family.cuda_functor is not None:
        kind, link_len = family.cuda_functor
        lib = _build.load_library()

        def launch(*io):
            return lib.mo_blocked_launch(_CUDA_FAMILY_IDS[kind], n, *io[:-1], ctypes.c_double(link_len), io[-1])

        error_text = _build.error_string
    else:
        lib = family.cuda_program.blocked_library()
        launch = lib.mo_generated_blocked_launch

        def error_text(rc):
            return f"error {rc}: {lib.mo_generated_error_string(rc).decode()}"

    kw = dict(dtype=data_t.dtype, device=data_t.device)
    x_out = torch.empty((n, B), **kw)
    state = torch.empty((3, B), **kw)
    if B == 0:
        return x_out, state
    # The global route's scratch: a slab per warp of the grid. Past the
    # card's memory torch.empty raises, naming the bytes it wanted.
    scratch = (
        torch.empty((plan.slabs, plan.warp_bytes), dtype=torch.uint8, device=data_t.device)
        if plan.storage == "global" else None
    )
    strides = (ctypes.c_longlong * 4)(data_t.stride(1), data_t.stride(0), x0_t.stride(1), x0_t.stride(0))
    with torch.cuda.device(data_t.device):
        rc = launch(
            _CUDA_DTYPE_IDS[data_t.dtype],
            data_t.data_ptr(),
            x0_t.data_ptr(),
            strides,
            x_out.data_ptr(),
            state.data_ptr(),
            B,
            plan.warps,
            max_iterations,
            qp_iterations,
            ls_iterations,
            int(line_search == "polynomial"),
            int(barrier == "mpc"),
            None if scratch is None else scratch.data_ptr(),
            plan.slabs,
            plan.warp_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"blocked kernel launch failed ({plan.storage} route): {error_text(rc)}")
    if family.cuda_functor is not None:
        BLOCKED_LAUNCHES += 1
    else:
        GENERATED_LAUNCHES += 1
    return x_out, state


def blocked_solve_batch(
    family,
    data,  # (B, family.data_rows), numpy array or tensor
    x0,  # (B, family.n)
    max_iterations: int = 10,
    qp_iterations: int = 6,
    ls_iterations: int = 2,
    line_search: str = "armijo",
    barrier: str = "mpc",
    return_state: bool = False,
    lanes=None,
    device=None,
):
    """Solve B instances of a medium-N family with the blocked fused solve.

    Same contract as ``fused_solve_batch``, which sends families with
    n + m_eq > REGISTER_KKT_MAX here: returns (B, n); with ``return_state``
    also the (B, 3) ``(f, |eq|_1, flags)`` channel that
    ``fused_termination_status`` reads. ``lanes`` is the TPU tile width of
    the JAX package (a multiple of 128); it is checked and changes no
    result: the kernel runs one instance per warp. Tensors run where they lie
    (CPU: the plain version; CUDA: the kernel); numpy inputs go to
    ``device``, which is "cuda" unless the caller passes "cpu"."""
    _check_options(max_iterations, qp_iterations, ls_iterations, line_search, barrier)
    lanes = 128 if lanes is None else lanes
    if lanes <= 0 or lanes % 128:
        raise ValueError(f"lanes must be a positive multiple of 128, not {lanes}")
    data, x0 = convert.to_batch_major(data, x0, device)
    if data.shape[1] != family.data_rows or x0.shape[1] != family.n:
        raise ValueError(
            f"expected data (B, {family.data_rows}) and x0 (B, {family.n}); got "
            f"{tuple(data.shape)} and {tuple(x0.shape)}"
        )
    # The kernel and the plain version read the feature-major views where
    # they lie: a call on card tensors copies nothing.
    data_t, x0_t = data.T, x0.T
    args = (
        family, data_t, x0_t, max_iterations, qp_iterations, ls_iterations,
        line_search, barrier,
    )
    if data_t.is_cuda:
        x_t, state_t = _blocked_solve_cuda(*args)
    elif data_t.device.type == "cpu":
        x_t, state_t = _blocked_solve_plain(*args)
    else:
        raise NotImplementedError(f"no blocked solve for device {data_t.device}")
    return (x_t.T, state_t.T) if return_state else x_t.T


# ---------------------------------------------------------------------------
# The standalone blocked KKT solve (pallas_blocked.py:751-819).
# ---------------------------------------------------------------------------


def _blocked_kkt_solve_plain(H, rhs):
    """``H (B, D, D)`` (lower triangle read), ``rhs (B, D)`` -> ``x (B, D)``
    with ``H x = rhs``, by the same LDL^T factor and substitutions as the
    fused solve, in the kernel's order."""
    L, d = _ldlt_factor(H.permute(1, 2, 0))
    return _ldlt_solve(L, d, rhs.T).T


def _blocked_kkt_solve_cuda(H, rhs):
    """Launch ``csrc/blocked_kkt.cu`` by ``kkt_launch_plan``: one warp per
    system up to D = 192, one CTA per system past it. Raises on anything the
    kernel does not take and on a refused launch."""
    global KKT_LAUNCHES
    B, D = rhs.shape
    _check_cuda_tensors((("H", H, (B, D, D)), ("rhs", rhs, (B, D))), H.dtype, H.device, B)
    x = torch.empty_like(rhs)
    if B == 0 or D == 0:
        return x
    plan = kkt_launch_plan(D, B, H.dtype)
    lib = _build.load_library()
    with torch.cuda.device(H.device):
        rc = lib.mo_blocked_kkt_launch(
            _CUDA_DTYPE_IDS[H.dtype],
            D,
            H.data_ptr(),
            rhs.data_ptr(),
            x.data_ptr(),
            B,
            plan.warps,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"blocked KKT kernel launch failed: {_build.error_string(rc)}")
    KKT_LAUNCHES += 1
    return x


def blocked_kkt_solve(H, rhs, lanes: int = 128, device=None):
    """Solve B dense quasi-definite systems ``H x = rhs`` by an unpivoted
    batched LDL^T: ``H (B, D, D)`` (lower triangle read), ``rhs (B, D)`` ->
    ``(B, D)``. ``lanes`` is the JAX package's TPU tile width; like JAX's
    ``blocked_kkt_solve`` (pallas_blocked.py:750-767), which pads the batch
    to it and checks nothing, the port takes any value, and it changes no
    result. Tensors run where they lie; numpy inputs go to ``device``
    ("cuda" unless the caller passes "cpu")."""
    del lanes
    if not torch.is_tensor(H) or not torch.is_tensor(rhs):
        if torch.is_tensor(H) or torch.is_tensor(rhs):
            raise TypeError("pass H and rhs both as tensors or both as arrays")
        dev = convert._resolve_device(device)
        H, rhs = torch.as_tensor(H, device=dev), torch.as_tensor(rhs, device=dev)
    elif device is not None:
        H, rhs = H.to(device), rhs.to(device)
    if H.dim() != 3 or rhs.dim() != 2 or H.shape != (rhs.shape[0], rhs.shape[1], rhs.shape[1]):
        raise ValueError(
            f"expected H (B, D, D) and rhs (B, D); got {tuple(H.shape)} and {tuple(rhs.shape)}"
        )
    if H.dtype != rhs.dtype or H.dtype not in _CUDA_DTYPE_IDS or H.device != rhs.device:
        raise TypeError("H and rhs must share float32 or float64 and one device")
    if H.is_cuda:
        return _blocked_kkt_solve_cuda(H.contiguous(), rhs.contiguous())
    if H.device.type == "cpu":
        return _blocked_kkt_solve_plain(H, rhs)
    raise NotImplementedError(f"no blocked KKT solve for device {H.device}")
