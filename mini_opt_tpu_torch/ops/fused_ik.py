"""Fused whole-solve batched IK, the PyTorch port of
``mini_opt_tpu/ops/pallas_ik.py``.

The whole constrained SQP solve of one instance -- the family's
linearization, Gauss-Newton assembly with LM damping, the condensed-KKT
interior point with a fully unrolled LDL^T, fraction-to-boundary, the L1-merit
Armijo or polynomial line search with retraction, the LM lambda restore
machine and the best-merit return -- runs as one CUDA kernel,
``csrc/fused_ik.cu``, one instance per thread. It replaces the TPU kernel
``pallas_ik.py::_make_kernel``.

Beside it sits ``_fused_solve_plain``, the same computation as plain PyTorch
on lists of ``(B,)`` tensors, a line-by-line counterpart of ``_make_kernel``.
The entry points dispatch on the tensors' device: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise. Nothing falls back from
one to the other.

Layouts follow the JAX package: the public functions take ``(B, rows)`` data
and ``(B, n)`` warm starts and return ``(B, n)`` solutions, ``(B, 3)`` states
``(f, |eq|_1, flags)`` and ``(B, iters, 7 + n)`` histories. Internally every
tensor is feature-major, ``(vars, B)``, so that thread ``i`` of the kernel
reads column ``i`` and a warp's loads are coalesced.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from .. import convert
from ..structs import NLSTerminationState
from . import _build

# Past this KKT size the JAX package hands off to its blocked tier
# (pallas_blocked.REGISTER_KKT_MAX); the port has no blocked tier yet.
REGISTER_KKT_MAX = 32

# Launches of the CUDA kernel in this process: the wrapper adds one right
# where it launches, and nowhere else.
KERNEL_LAUNCHES = 0

# The kernel's instances (csrc/fused_ik.cu): chain lengths and families.
CUDA_MIN_N, CUDA_MAX_N = 2, 8
_CUDA_FAMILY_IDS = {"planar": 0, "spatial": 1}
_CUDA_DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# History channels before dx_0..dx_{n-1}: f, eq, penalty, lam, dd, accepted,
# alpha (pallas_ik.py:590-697).
_N_DEBUG_FIXED = 7

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


def _ldlt_factor_unrolled(H):
    """Factor the symmetric DxD system (nested list of lane rows, lower
    triangle read) as unit-lower L and diagonal d; fully unrolled."""
    n = len(H)
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        acc = H[j][j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k] * d[k]
        d[j] = acc
        for i in range(j + 1, n):
            aij = H[i][j] if i >= j else H[j][i]
            for k in range(j):
                aij = aij - L[i][k] * L[j][k] * d[k]
            L[i][j] = aij / d[j]
    return L, d


def _ldlt_apply(L, d, r):
    """Solve with an existing LDL^T factorization (unrolled substitutions)."""
    n = len(r)
    y = list(r)
    for i in range(n):
        for k in range(i):
            y[i] = y[i] - L[i][k] * y[k]
    for i in range(n):
        y[i] = y[i] / d[i]
    for i in range(n - 1, -1, -1):
        for k in range(i + 1, n):
            y[i] = y[i] - L[k][i] * y[k]
    return y


def _ldlt_bad(d, zero):
    """1.0 where any pivot is (near-)zero or non-finite, else 0.0."""
    tiny = torch.finfo(zero.dtype).tiny
    bad = zero
    one = torch.ones_like(zero)
    for dj in d:
        good = (torch.abs(dj) > tiny) & torch.isfinite(dj)
        bad = torch.maximum(bad, torch.where(good, zero, one))
    return bad


@dataclasses.dataclass(frozen=True, eq=False)
class FusedFamily:
    """A problem family for the fused whole-solve kernel.

    The callables act on *lists of (B,) tensors*: ``x`` is a list of ``n``
    tensors (variable i across the batch), ``data`` a list of ``data_rows``
    tensors of per-instance payload.

    Attributes:
      n: number of optimization variables.
      data_rows: per-instance data rows handed to the callables.
      m_eq: number of (nonlinear, L1-penalized) equality constraint rows.
      linearize: ``(x, data) -> (f, r_eq, J_eq, G, c)``, the Gauss-Newton
        linearization at x: cost f = 0.5*||r_cost||^2, equality residuals
        ``r_eq`` (m_eq) with row Jacobians ``J_eq`` (m_eq lists of n), the
        cost Hessian's lower triangle ``G`` (``G[i][j]`` for j <= i) and the
        gradient ``c``.
      errors: ``(x, data) -> (f, eq_l1)``, cost and summed |equality| at x.
      lower / upper: per-variable bound constants (None = unbounded).
      retract: optional update applied to every line-search candidate.
      cuda_functor: the device-code family in ``csrc/families.cuh`` and its
        runtime constant, e.g. ``("planar", link_len)``; None for a family
        that exists only as Python callables (it runs on the CPU only).
    """

    n: int
    data_rows: int
    m_eq: int
    linearize: Callable
    errors: Callable
    lower: Tuple[Optional[float], ...]
    upper: Tuple[Optional[float], ...]
    retract: Optional[Callable] = None
    cuda_functor: Optional[Tuple[str, float]] = None

    def __post_init__(self):
        if len(self.lower) != self.n or len(self.upper) != self.n:
            raise ValueError("lower/upper need one entry per variable")


@functools.lru_cache(maxsize=None)
def planar_family(n, link_len):
    """The planar Z-rotation chain: cost on effector y, equality on effector
    x, [0, pi] limits on joints 1..n-1."""
    L = link_len

    def fk(th):
        phis = []
        acc = None
        for i in range(n):
            acc = th[i] if acc is None else acc + th[i]
            phis.append(acc)
        c = [torch.cos(p) for p in phis]
        s = [torch.sin(p) for p in phis]
        px = L * sum(c)
        py = L * sum(s)
        # dpx/dth_a = -L sum_{i>=a} s_i ; dpy/dth_a = L sum_{i>=a} c_i
        jx, jy = [], []
        sx = sy = None
        for a in range(n - 1, -1, -1):
            sx = s[a] if sx is None else sx + s[a]
            sy = c[a] if sy is None else sy + c[a]
            jx.append(-L * sx)
            jy.append(L * sy)
        jx.reverse()
        jy.reverse()
        return px, py, jx, jy

    def linearize(th, tgt):
        tx, ty = tgt
        px, py, jx, jy = fk(th)
        ry = py - ty
        rx = px - tx
        f_pre = 0.5 * ry * ry
        G = [[jy[i] * jy[j] for j in range(i + 1)] for i in range(n)]
        c = [jy[i] * ry for i in range(n)]
        return f_pre, [rx], [jx], G, c

    def errors(th, tgt):
        tx, ty = tgt
        px, py, _, _ = fk(th)
        return 0.5 * (py - ty) ** 2, torch.abs(px - tx)

    return FusedFamily(
        n=n,
        data_rows=2,
        m_eq=1,
        linearize=linearize,
        errors=errors,
        lower=(None,) + (0.0,) * (n - 1),
        upper=(None,) + (_PI,) * (n - 1),
        retract=lambda th: [_mod_pi(t) for t in th],
        cuda_functor=("planar", float(link_len)),
    )


@functools.lru_cache(maxsize=None)
def spatial_family(n, link_len):
    """3-D chain with alternating rotation axes (z, y, z, y, ...), links
    along local x: cost on effector (y, z), equality on effector x."""
    L = link_len

    def fk(th):
        """Effector p (3 tensors) and per-joint world Jacobians
        J[a] = w_a x (p - q_a)."""
        one = torch.ones_like(th[0])
        zero = torch.zeros_like(th[0])
        R = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
        p = [zero, zero, zero]
        ws, qs = [], []
        for a in range(n):
            axis_col = 2 if a % 2 == 0 else 1  # z-axis or y-axis column
            ws.append([R[0][axis_col], R[1][axis_col], R[2][axis_col]])
            qs.append(list(p))
            c_, s_ = torch.cos(th[a]), torch.sin(th[a])
            if a % 2 == 0:  # R = R @ Rz
                c0 = [c_ * R[r][0] + s_ * R[r][1] for r in range(3)]
                c1 = [-s_ * R[r][0] + c_ * R[r][1] for r in range(3)]
                R = [[c0[r], c1[r], R[r][2]] for r in range(3)]
            else:  # R = R @ Ry
                c0 = [c_ * R[r][0] - s_ * R[r][2] for r in range(3)]
                c2 = [s_ * R[r][0] + c_ * R[r][2] for r in range(3)]
                R = [[c0[r], R[r][1], c2[r]] for r in range(3)]
            p = [p[r] + L * R[r][0] for r in range(3)]
        J = []
        for a in range(n):
            d = [p[r] - qs[a][r] for r in range(3)]
            w = ws[a]
            J.append(
                [
                    w[1] * d[2] - w[2] * d[1],
                    w[2] * d[0] - w[0] * d[2],
                    w[0] * d[1] - w[1] * d[0],
                ]
            )
        return p, J

    def linearize(th, tgt):
        tx, ty, tz = tgt
        p, J = fk(th)
        ry = p[1] - ty
        rz = p[2] - tz
        rx = p[0] - tx
        f_pre = 0.5 * (ry * ry + rz * rz)
        jy = [J[a][1] for a in range(n)]
        jz = [J[a][2] for a in range(n)]
        jx = [J[a][0] for a in range(n)]
        G = [
            [jy[i] * jy[j] + jz[i] * jz[j] for j in range(i + 1)]
            for i in range(n)
        ]
        c = [jy[i] * ry + jz[i] * rz for i in range(n)]
        return f_pre, [rx], [jx], G, c

    def errors(th, tgt):
        tx, ty, tz = tgt
        p, _ = fk(th)
        return (
            0.5 * ((p[1] - ty) ** 2 + (p[2] - tz) ** 2),
            torch.abs(p[0] - tx),
        )

    return FusedFamily(
        n=n,
        data_rows=3,
        m_eq=1,
        linearize=linearize,
        errors=errors,
        lower=(None,) + (0.0,) * (n - 1),
        upper=(None,) + (_PI,) * (n - 1),
        retract=lambda th: [_mod_pi(t) for t in th],
        cuda_functor=("spatial", float(link_len)),
    )


def _fused_solve_plain(
    family,
    data_t,
    x0_t,
    max_iterations,
    qp_iterations,
    ls_iterations,
    line_search="armijo",
    barrier="complementarity",
    debug_history=False,
):
    """The kernel's computation as plain PyTorch on feature-major tensors:
    ``data_t (rows, B)``, ``x0_t (n, B)`` -> ``x (n, B)``, ``state (3, B)``
    and, with ``debug_history``, ``history (iters, 7 + n, B)`` (else None).

    A line-by-line counterpart of ``pallas_ik.py::_make_kernel``: the same
    operations in the same order, so that the CUDA kernel, built without FMA
    contraction, reproduces it bit for bit on the card."""
    n = family.n
    m = family.m_eq
    lo_list = [(i, lo) for i, lo in enumerate(family.lower) if lo is not None]
    hi_list = [(i, hi) for i, hi in enumerate(family.upper) if hi is not None]
    n_lo, n_hi = len(lo_list), len(hi_list)
    ncon = n_lo + n_hi

    def _interleave(lo_terms, hi_terms):
        """Alternate lo/hi contributions per slack index (the summation
        order of the JAX kernel)."""
        out = []
        for j in range(max(len(lo_terms), len(hi_terms))):
            if j < len(lo_terms):
                out.append(lo_terms[j])
            if j < len(hi_terms):
                out.append(hi_terms[j])
        return out

    def qp_solve(G, c, Jeq, beq, ib_lo, ib_hi, one, zero):
        """Interior point on the condensed (n+m)x(n+m) system. Returns
        (dx, y, bad): bad is 1.0 where a factorization had a zero or
        non-finite pivot."""
        D = n + m

        def assemble(sig_lo, sig_hi):
            H = [[zero] * D for _ in range(D)]
            for i in range(n):
                for j in range(i + 1):
                    H[i][j] = G[i][j]
            for j, (i, _) in enumerate(lo_list):
                H[i][i] = H[i][i] + sig_lo[j]
            for j, (i, _) in enumerate(hi_list):
                H[i][i] = H[i][i] + sig_hi[j]
            for k in range(m):
                for j in range(n):
                    H[n + k][j] = Jeq[k][j]
            return H

        # Equality-constrained initial guess, then clamp + slack init.
        H0 = assemble([zero] * n_lo, [zero] * n_hi)
        rhs0 = [-c[i] for i in range(n)] + [-beq[k] for k in range(m)]
        L0, d0 = _ldlt_factor_unrolled(H0)
        bad = _ldlt_bad(d0, zero)
        sol = _ldlt_apply(L0, d0, rhs0)
        x = sol[:n]
        y = [-sol[n + k] for k in range(m)]
        if ncon == 0:
            return x, y, bad
        for j, (i, _) in enumerate(lo_list):
            x[i] = _maximum(x[i], -ib_lo[j])
        for j, (i, _) in enumerate(hi_list):
            x[i] = _minimum(x[i], ib_hi[j])
        s_lo = [_maximum(x[i] + ib_lo[j], 1e-9) for j, (i, _) in enumerate(lo_list)]
        s_hi = [_maximum(-x[i] + ib_hi[j], 1e-9) for j, (i, _) in enumerate(hi_list)]
        z_lo = [1.0 / v for v in s_lo]
        z_hi = [1.0 / v for v in s_hi]

        mu = one
        tau = 0.995
        for _ in range(qp_iterations):
            r_d = []
            for i in range(n):
                acc = c[i]
                for k in range(m):
                    acc = acc - Jeq[k][i] * y[k]
                for j in range(n):
                    acc = acc + (G[i][j] if i >= j else G[j][i]) * x[j]
                r_d.append(acc)
            for j, (i, _) in enumerate(lo_list):
                r_d[i] = r_d[i] - z_lo[j]
            for j, (i, _) in enumerate(hi_list):
                r_d[i] = r_d[i] + z_hi[j]
            r_pe = []
            for k in range(m):
                acc = beq[k]
                for j in range(n):
                    acc = acc + Jeq[k][j] * x[j]
                r_pe.append(acc)
            r_pi_lo = [x[i] + ib_lo[j] - s_lo[j] for j, (i, _) in enumerate(lo_list)]
            r_pi_hi = [-x[i] + ib_hi[j] - s_hi[j] for j, (i, _) in enumerate(hi_list)]
            r_c_lo = [s_lo[j] * z_lo[j] for j in range(n_lo)]
            r_c_hi = [s_hi[j] * z_hi[j] for j in range(n_hi)]

            sig_lo = [z_lo[j] / s_lo[j] for j in range(n_lo)]
            sig_hi = [z_hi[j] / s_hi[j] for j in range(n_hi)]
            H = assemble(sig_lo, sig_hi)
            Lf, df = _ldlt_factor_unrolled(H)
            bad = torch.maximum(bad, _ldlt_bad(df, zero))

            def solve_step(mu_v, corr_lo, corr_hi):
                r_aug = list(r_d)
                for j, (i, _) in enumerate(lo_list):
                    r_aug[i] = (
                        r_aug[i]
                        + sig_lo[j] * r_pi_lo[j]
                        + (r_c_lo[j] + corr_lo[j] - mu_v) / s_lo[j]
                    )
                for j, (i, _) in enumerate(hi_list):
                    r_aug[i] = (
                        r_aug[i]
                        - sig_hi[j] * r_pi_hi[j]
                        - (r_c_hi[j] + corr_hi[j] - mu_v) / s_hi[j]
                    )
                rhs = [-v for v in r_aug] + [-v for v in r_pe]
                sol = _ldlt_apply(Lf, df, rhs)
                dx_v = sol[:n]
                dy_v = [-sol[n + k] for k in range(m)]
                ds_lo_v = [dx_v[i] + r_pi_lo[j] for j, (i, _) in enumerate(lo_list)]
                ds_hi_v = [-dx_v[i] + r_pi_hi[j] for j, (i, _) in enumerate(hi_list)]
                dz_lo_v = [
                    -sig_lo[j] * ds_lo_v[j] - (r_c_lo[j] + corr_lo[j] - mu_v) / s_lo[j]
                    for j in range(n_lo)
                ]
                dz_hi_v = [
                    -sig_hi[j] * ds_hi_v[j] - (r_c_hi[j] + corr_hi[j] - mu_v) / s_hi[j]
                    for j in range(n_hi)
                ]
                return dx_v, dy_v, ds_lo_v, ds_hi_v, dz_lo_v, dz_hi_v

            def ftb(vs, dvs, tau_v):
                alpha = one
                for v, dv in zip(vs, dvs):
                    blocking = (v + dv <= 0.0) & (torch.abs(dv) > 0.0)
                    cand = -tau_v * v / torch.where(blocking, dv, one)
                    alpha = torch.minimum(alpha, torch.where(blocking, cand, one))
                return alpha

            zeros_lo = [zero] * n_lo
            zeros_hi = [zero] * n_hi
            if barrier == "mpc":
                # Mehrotra predictor-corrector: affine probe with mu = 0,
                # sigma = (mu_aff / mu)^3, corrector diag(ds_aff) dz_aff.
                dxa, dya, dsl_a, dsh_a, dzl_a, dzh_a = solve_step(
                    zero, zeros_lo, zeros_hi
                )
                ap_a = ftb(s_lo + s_hi, dsl_a + dsh_a, 1.0)
                ad_a = ftb(z_lo + z_hi, dzl_a + dzh_a, 1.0)
                mu_aff = zero
                for t in _interleave(
                    [
                        (s_lo[j] + ap_a * dsl_a[j]) * (z_lo[j] + ad_a * dzl_a[j])
                        for j in range(n_lo)
                    ],
                    [
                        (s_hi[j] + ap_a * dsh_a[j]) * (z_hi[j] + ad_a * dzh_a[j])
                        for j in range(n_hi)
                    ],
                ):
                    mu_aff = mu_aff + t
                mu_aff = _maximum(_div(mu_aff, ncon), 0.0)
                ratio = mu_aff / mu
                sigma = ratio * (ratio * ratio)  # jax.lax.integer_pow(ratio, 3)
                mu_used = sigma * mu
                corr_lo = [dsl_a[j] * dzl_a[j] for j in range(n_lo)]
                corr_hi = [dsh_a[j] * dzh_a[j] for j in range(n_hi)]
                dx, dy, ds_lo, ds_hi, dz_lo, dz_hi = solve_step(
                    mu_used, corr_lo, corr_hi
                )
            else:
                dx, dy, ds_lo, ds_hi, dz_lo, dz_hi = solve_step(mu, zeros_lo, zeros_hi)

            ap = ftb(s_lo + s_hi, ds_lo + ds_hi, tau)
            ad = ftb(z_lo + z_hi, dz_lo + dz_hi, tau)
            x = [x[i] + ap * dx[i] for i in range(n)]
            s_lo = [s_lo[j] + ap * ds_lo[j] for j in range(n_lo)]
            s_hi = [s_hi[j] + ap * ds_hi[j] for j in range(n_hi)]
            y = [y[k] + ad * dy[k] for k in range(m)]
            z_lo = [z_lo[j] + ad * dz_lo[j] for j in range(n_lo)]
            z_hi = [z_hi[j] + ad * dz_hi[j] for j in range(n_hi)]
            comp = zero
            for t in _interleave(
                [s_lo[j] * z_lo[j] for j in range(n_lo)],
                [s_hi[j] * z_hi[j] for j in range(n_hi)],
            ):
                comp = comp + t
            mu = 0.1 * _div(comp, ncon)
        return x, y, bad

    tgt = [data_t[i] for i in range(family.data_rows)]
    th = [x0_t[i] for i in range(n)]
    one = torch.ones_like(th[0])
    zero = torch.zeros_like(th[0])

    def const(v):
        return torch.full_like(one, v)

    hist = []
    lam = 0.001 * one
    penalty = 0.01 * one
    restore = zero
    # Best-merit iterate ever visited, under the current penalty; NaN lanes
    # stay on their last good iterate (NaN comparisons are False).
    th_best = list(th)
    f_best = None
    eq_best = None
    # fac_bad is sticky; lam_maxed holds the last iteration's state.
    fac_bad = zero
    lam_maxed = zero

    for it in range(max_iterations):
        f_pre, r_eq, Jeq, G0, c = family.linearize(th, tgt)
        eq_pre = zero
        for k in range(m):
            eq_pre = eq_pre + torch.abs(r_eq[k])
        if f_best is None:
            f_best, eq_best = f_pre, eq_pre
        else:
            better = f_pre + penalty * eq_pre < f_best + penalty * eq_best
            th_best = [torch.where(better, th[i], th_best[i]) for i in range(n)]
            f_best = torch.where(better, f_pre, f_best)
            eq_best = torch.where(better, eq_pre, eq_best)
        G = [
            [G0[i][j] + (lam if i == j else zero) for j in range(i + 1)]
            for i in range(n)
        ]
        ib_lo = [th[i] - lo for (i, lo) in lo_list]
        ib_hi = [hi - th[i] for (i, hi) in hi_list]

        dx, y, bad_it = qp_solve(G, c, Jeq, r_eq, ib_lo, ib_hi, one, zero)
        fac_bad = torch.maximum(fac_bad, bad_it)

        d_f = sum(c[i] * dx[i] for i in range(n))
        if m > 0:
            y_abs = torch.abs(y[0])
            for k in range(1, m):
                y_abs = torch.maximum(y_abs, torch.abs(y[k]))
            penalty = torch.where(y_abs > penalty, y_abs * 1.01, penalty)
            d_eq = zero
            for k in range(m):
                d_eq = d_eq + _sign(r_eq[k]) * sum(Jeq[k][i] * dx[i] for i in range(n))
        else:
            d_eq = zero
        dd = d_f + penalty * d_eq
        merit_pre = f_pre + penalty * eq_pre

        alpha = one
        accepted = zero
        dead = zero  # lanes whose polynomial fit went invalid
        best = list(th)
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
                    dead = torch.maximum(
                        dead, (1.0 - valid.to(one.dtype)) * (1.0 - accepted)
                    )
                    alpha = torch.where(valid, a_new, alpha * 0.5)
            cand = [th[i] + alpha * dx[i] for i in range(n)]
            if family.retract is not None:
                cand = family.retract(cand)
            f_c, eq_c = family.errors(cand, tgt)
            merit_c = f_c + penalty * eq_c
            # Armijo with the slack term clamped to <= 0.
            ok = (merit_c <= merit_pre + 1e-4 * alpha * _minimum(dd, zero)).to(one.dtype)
            take = ok * (1.0 - accepted) * (1.0 - dead)
            best = [take * cand[i] + (1.0 - take) * best[i] for i in range(n)]
            f_acc = take * f_c + (1.0 - take) * f_acc
            eq_acc = take * eq_c + (1.0 - take) * eq_acc
            accepted = _minimum(accepted + take, 1.0)
            alpha_prev2, phi_prev2 = alpha_prev, phi_prev
            alpha_prev, phi_prev = alpha, merit_c

        th = [torch.where(accepted > 0, best[i], th[i]) for i in range(n)]
        if debug_history:
            hist.append([f_pre, eq_pre, penalty, lam, dd, accepted, alpha] + dx)
        lam_succ = _maximum(lam * torch.where(restore > 0, const(0.8), const(0.1)), 1e-9)
        lam_fail = torch.where(restore > 0, lam * 10.0, _maximum(0.001 * one, lam * 10.0))
        lam = torch.where(accepted > 0, lam_succ, lam_fail)
        restore = torch.where(accepted > 0, zero, one)
        lam_maxed = torch.where((accepted == 0) & (lam > 1.0), one, zero)

    # Final best update covers the last iteration's accepted step.
    f_fin = torch.where(accepted > 0, f_acc, f_pre)
    eq_fin = torch.where(accepted > 0, eq_acc, eq_pre)
    better = f_fin + penalty * eq_fin < f_best + penalty * eq_best
    x_out = torch.stack([torch.where(better, th[i], th_best[i]) for i in range(n)])
    state = torch.stack(
        [
            torch.where(better, f_fin, f_best),
            torch.where(better, eq_fin, eq_best),
            fac_bad + 2.0 * lam_maxed,
        ]
    )
    history = torch.stack([torch.stack(row) for row in hist]) if debug_history else None
    return x_out, state, history


def _fused_solve_cuda(
    family,
    data_t,
    x0_t,
    max_iterations,
    qp_iterations,
    ls_iterations,
    line_search="armijo",
    barrier="complementarity",
    debug_history=False,
):
    """Launch ``csrc/fused_ik.cu`` on feature-major CUDA tensors; same
    contract as ``_fused_solve_plain``. Raises on anything the kernel does
    not take and on a refused launch."""
    global KERNEL_LAUNCHES
    if family.cuda_functor is None:
        raise NotImplementedError(
            "this FusedFamily has no device-code functor (cuda_functor is "
            "None); families generated from a Problem need the family-to-CUDA "
            "emitter of slice 2 (ops/fused_auto.py)"
        )
    kind, link_len = family.cuda_functor
    if kind not in _CUDA_FAMILY_IDS:
        raise NotImplementedError(f"no CUDA functor named {kind!r}")
    n = family.n
    if not CUDA_MIN_N <= n <= CUDA_MAX_N:
        raise NotImplementedError(
            f"csrc/fused_ik.cu instantiates n = {CUDA_MIN_N}..{CUDA_MAX_N}; got n = {n}"
        )
    dtype = data_t.dtype
    if dtype not in _CUDA_DTYPE_IDS:
        raise TypeError(f"the kernel takes float32 or float64, not {dtype}")
    for name, t, rows in (("data", data_t, family.data_rows), ("x0", x0_t, n)):
        if not t.is_cuda or t.device != data_t.device or t.dtype != dtype:
            raise ValueError(f"{name} must be a {dtype} tensor on {data_t.device}")
        if t.dim() != 2 or t.shape[0] != rows or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({rows}, B) tensor")
    B = data_t.shape[1]
    if x0_t.shape[1] != B:
        raise ValueError("data and x0 batch sizes differ")
    if B >= 2**31:
        raise ValueError("batch too large for the kernel's int32 indexing")

    kw = dict(dtype=dtype, device=data_t.device)
    x_out = torch.empty((n, B), **kw)
    state = torch.empty((3, B), **kw)
    history = (
        torch.empty((max_iterations, _N_DEBUG_FIXED + n, B), **kw) if debug_history else None
    )
    if B == 0:
        return x_out, state, history
    lib = _build.load_library()
    with torch.cuda.device(data_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mo_fused_ik_launch(
            _CUDA_FAMILY_IDS[kind],
            n,
            _CUDA_DTYPE_IDS[dtype],
            data_t.data_ptr(),
            x0_t.data_ptr(),
            x_out.data_ptr(),
            state.data_ptr(),
            history.data_ptr() if debug_history else None,
            B,
            max_iterations,
            qp_iterations,
            ls_iterations,
            int(line_search == "polynomial"),
            int(barrier == "mpc"),
            ctypes.c_double(link_len),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_ik kernel launch failed: {_build.error_string(rc)}")
    KERNEL_LAUNCHES += 1
    return x_out, state, history


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


def _fused_solve(
    family, data, x0, max_iterations, qp_iterations, ls_iterations,
    line_search, barrier, debug_history, return_state, device,
):
    _check_options(max_iterations, qp_iterations, ls_iterations, line_search, barrier)
    if family.n + family.m_eq > REGISTER_KKT_MAX:
        raise NotImplementedError(
            f"n + m_eq = {family.n + family.m_eq} > {REGISTER_KKT_MAX} needs the "
            "blocked tier (ops/pallas_blocked.py), which is slice 2 of the port"
        )
    data_t, x0_t = convert.to_feature_major(data, x0, device)
    if data_t.shape[0] != family.data_rows or x0_t.shape[0] != family.n:
        raise ValueError(
            f"expected data (B, {family.data_rows}) and x0 (B, {family.n}); got "
            f"{tuple(data_t.T.shape)} and {tuple(x0_t.T.shape)}"
        )
    args = (
        family, data_t, x0_t, max_iterations, qp_iterations, ls_iterations,
        line_search, barrier, debug_history,
    )
    if data_t.is_cuda:
        x_t, state_t, hist_t = _fused_solve_cuda(*args)
    elif data_t.device.type == "cpu":
        x_t, state_t, hist_t = _fused_solve_plain(*args)
    else:
        raise NotImplementedError(f"no fused solve for device {data_t.device}")
    outs = [x_t.T]
    if return_state:
        outs.append(state_t.T)
    if debug_history:
        outs.append(hist_t.permute(2, 0, 1))
    return tuple(outs) if len(outs) > 1 else outs[0]


def fused_solve_batch(
    family: FusedFamily,
    data,  # (B, family.data_rows), numpy array or tensor
    x0,  # (B, family.n)
    max_iterations: int = 10,
    qp_iterations: int = 6,
    ls_iterations: int = 2,
    line_search: str = "armijo",  # or "polynomial"
    barrier: str = "mpc",  # or "complementarity"
    debug_history: bool = False,
    return_state: bool = False,
    device=None,
):
    """Solve B instances of ``family`` with one fused solve.

    Returns (B, n); with ``return_state`` also (B, 3) ``(f, |eq|_1, flags)``
    at the returned iterate; with ``debug_history`` also
    (B, max_iterations, 7 + n), channels [f, eq, penalty, lam, dd, accepted,
    alpha, dx_0..dx_{n-1}]. Tensors run where they lie (CPU: the plain
    version; CUDA: the kernel). numpy inputs go to ``device``, which is
    "cuda" unless the caller passes "cpu"."""
    return _fused_solve(
        family, data, x0, max_iterations, qp_iterations, ls_iterations,
        line_search, barrier, debug_history, return_state, device,
    )


def fused_ik_solve_batch(
    targets,  # (B, 2)
    x0,  # (B, n)
    link_len: float = 0.4,
    max_iterations: int = 10,
    qp_iterations: int = 6,
    ls_iterations: int = 2,
    line_search: str = "armijo",
    barrier: str = "mpc",
    debug_history: bool = False,
    return_state: bool = False,
    device=None,
):
    """Solve B planar n-link IK instances with the fused solve. Returns
    (B, n); optional extras and devices as in fused_solve_batch."""
    family = planar_family(x0.shape[1], link_len)
    return _fused_solve(
        family, targets, x0, max_iterations, qp_iterations, ls_iterations,
        line_search, barrier, debug_history, return_state, device,
    )


def fused_spatial_ik_solve_batch(
    targets,  # (B, 3)
    x0,  # (B, n)
    link_len: float = 0.4,
    max_iterations: int = 10,
    qp_iterations: int = 6,
    ls_iterations: int = 2,
    line_search: str = "armijo",
    barrier: str = "mpc",
    debug_history: bool = False,
    return_state: bool = False,
    device=None,
):
    """Solve B spatial (alternating z/y axis) n-link IK instances with the
    fused solve. Returns (B, n) (+extras)."""
    family = spatial_family(x0.shape[1], link_len)
    return _fused_solve(
        family, targets, x0, max_iterations, qp_iterations, ls_iterations,
        line_search, barrier, debug_history, return_state, device,
    )


def fused_termination_status(
    state: torch.Tensor,  # (B, 3): (f, |eq|_1, flags) from return_state=True
    f_tol: float = 1.0e-6,
    eq_tol: float = 1.0e-5,
) -> torch.Tensor:
    """int32 per-lane NLSTerminationState from the terminal (f, |eq|_1,
    flags), first match wins: SATISFIED_ABSOLUTE_TOL (both under the gate),
    QP_INDEFINITE (flag bit 1: a singular factorization), MAX_LAMBDA
    (non-finite state, or flag bit 2: the last iteration failed its line
    search with lambda past 1), else MAX_ITERATIONS. A (B, 2) state without
    flags degrades to the 3-state taxonomy."""
    f, eq = state[..., 0], state[..., 1]
    if state.shape[-1] >= 3:
        flags = state[..., 2]
        fac_bad = torch.remainder(torch.floor(flags), 2.0) >= 1.0
        lam_maxed = flags >= 2.0
    else:
        fac_bad = torch.zeros(f.shape, dtype=torch.bool, device=f.device)
        lam_maxed = torch.zeros(f.shape, dtype=torch.bool, device=f.device)
    finite = torch.isfinite(f) & torch.isfinite(eq)
    converged = finite & (f <= f_tol) & (eq <= eq_tol)

    def code(s):
        return torch.full(f.shape, int(s), dtype=torch.int32, device=f.device)

    return torch.where(
        converged,
        code(NLSTerminationState.SATISFIED_ABSOLUTE_TOL),
        torch.where(
            fac_bad,
            code(NLSTerminationState.QP_INDEFINITE),
            torch.where(
                ~finite | lam_maxed,
                code(NLSTerminationState.MAX_LAMBDA),
                code(NLSTerminationState.MAX_ITERATIONS),
            ),
        ),
    )
