"""Fused whole-solve batched IK, the PyTorch port of
``mini_opt_tpu/ops/pallas_ik.py``.

The whole constrained SQP solve of one instance -- the family's
linearization, Gauss-Newton assembly with LM damping, the condensed-KKT
interior point with a fully unrolled LDL^T, fraction-to-boundary, the L1-merit
Armijo or polynomial line search with retraction, the LM lambda restore
machine and the best-merit return -- runs as one CUDA kernel,
``csrc/fused_ik.cu``, one instance per thread, built at first use for each
family, chain length and type it runs. It replaces the TPU kernel
``pallas_ik.py::_make_kernel``.

Beside it sits ``_fused_solve_plain``, the same computation as plain PyTorch
on lists of ``(B,)`` tensors, a line-by-line counterpart of ``_make_kernel``.
The entry points dispatch on the tensors' device: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise. Nothing falls back from
one to the other.

Layouts follow the JAX package: the public functions take ``(B, rows)`` data
and ``(B, n)`` warm starts and return ``(B, n)`` solutions, ``(B, 3)`` states
``(f, |eq|_1, flags)`` and ``(B, iters, 7 + n)`` histories. The kernel reads
the caller's batch-major tensors at their own strides and writes its
outputs batch-major, so a call on card tensors is one device kernel and no
copy. The plain version works on feature-major ``(vars, B)`` views of the
same tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from .. import convert
from ..structs import NLSTerminationState
from . import _build, blocked
from ._common import (
    _CUDA_DTYPE_IDS,
    _PI,
    _check_cuda_tensors,
    _check_options,
    _div,
    _maximum,
    _minimum,
    _mod_pi,
    _sign,
)
from .blocked import REGISTER_KKT_MAX

# Launches of the CUDA kernel in this process: the wrapper adds one right
# where it launches, and nowhere else. KERNEL_LAUNCHES counts the
# hand-written families' instances (csrc/fused_ik.cu), GENERATED_LAUNCHES
# the instances emitted for families generated from a Problem.
KERNEL_LAUNCHES = 0
GENERATED_LAUNCHES = 0

# The kernel's hand-written instances (csrc/fused_ik.cu, one library per
# family, chain length and type, built at first use by
# _build.load_fused_ik): every n whose D = n + 1 the register tier takes
# (REGISTER_KKT_MAX), in both families. _build passes the two to nvcc.
CUDA_MIN_N, CUDA_MAX_N = 1, REGISTER_KKT_MAX - 1
_CUDA_FAMILY_IDS = {"planar": 0, "spatial": 1}

# History channels before dx_0..dx_{n-1}: f, eq, penalty, lam, dd, accepted,
# alpha (pallas_ik.py:590-697).
_N_DEBUG_FIXED = 7


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
        runtime constant, e.g. ``("planar", link_len)``.
      g_pattern / eq_patterns: optional static sparsity hints, as the JAX
        package's (pallas_ik.py:174-186): the lower-triangle (i, j) cells
        of the cost Hessian and, per equality row, the variables its
        Jacobian row touches, that MAY be nonzero (None = dense).
        ``family_from_problem`` fills both from the Problem's index lists;
        the emitter's blocked functor writes just those cells, and the plain
        blocked tier solves dense (the other cells are exact zeros).
      cuda_program: a generated family's device program
        (``ops/fused_emit.py::FamilyProgram``), which emits, builds and
        binds the family's own instance of the kernel at first use; set by
        ``family_from_problem``. A family with neither ``cuda_functor`` nor
        ``cuda_program`` exists only as Python callables and runs on the
        CPU only.
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
    g_pattern: Optional[frozenset] = None
    eq_patterns: Optional[Tuple[frozenset, ...]] = None
    cuda_program: Optional[object] = None

    def __post_init__(self):
        if len(self.lower) != self.n or len(self.upper) != self.n:
            raise ValueError("lower/upper need one entry per variable")
        if self.eq_patterns is not None and len(self.eq_patterns) != self.m_eq:
            raise ValueError("eq_patterns needs one entry per equality row")


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
    data,
    x0,
    max_iterations,
    qp_iterations,
    ls_iterations,
    line_search="armijo",
    barrier="complementarity",
    debug_history=False,
):
    """Launch kernel 1 on batch-major CUDA tensors at their own strides,
    ``data (B, rows)`` and ``x0 (B, n)`` -> ``x (B, n)``, ``state (B, 3)``
    and, with ``debug_history``, ``history (B, iters, 7 + n)`` (else None):
    ``_fused_solve_plain``'s results, batch-major. A hand-written family
    runs its instance in ``csrc/fused_ik.cu``; a family generated from a
    Problem runs the instance that ``ops/fused_emit.py`` emitted and built
    for it. Each is built at first use. Copies nothing; raises on anything
    the kernel does not take and on a refused launch."""
    global KERNEL_LAUNCHES, GENERATED_LAUNCHES
    if family.cuda_functor is None and family.cuda_program is None:
        raise NotImplementedError(
            "this FusedFamily has neither a hand-written device functor "
            "(cuda_functor) nor a generated device program (cuda_program): "
            "build it with family_from_problem (ops/fused_auto.py), whose "
            "program the family-to-CUDA emitter (ops/fused_emit.py) turns into "
            "the family's instance of the kernel"
        )
    n = family.n
    if family.cuda_functor is not None:
        kind, link_len = family.cuda_functor
        if kind not in _CUDA_FAMILY_IDS:
            raise NotImplementedError(f"no CUDA functor named {kind!r}")
        if not CUDA_MIN_N <= n <= CUDA_MAX_N:
            raise NotImplementedError(
                f"csrc/fused_ik.cu has instances at n = {CUDA_MIN_N}..{CUDA_MAX_N}; got n = {n}"
            )
    dtype = data.dtype
    B = data.shape[0] if data.dim() == 2 else -1
    _check_cuda_tensors(
        (("data", data, (B, family.data_rows)), ("x0", x0, (B, n))), dtype, data.device, B,
        contiguous=False,
    )

    kw = dict(dtype=dtype, device=data.device)
    x_out = torch.empty((B, n), **kw)
    state = torch.empty((B, 3), **kw)
    history = (
        torch.empty((B, max_iterations, _N_DEBUG_FIXED + n), **kw) if debug_history else None
    )
    if B == 0:
        return x_out, state, history
    strides = (ctypes.c_longlong * 4)(*data.stride(), *x0.stride())
    io = (
        _CUDA_DTYPE_IDS[dtype],
        data.data_ptr(),
        x0.data_ptr(),
        strides,
        x_out.data_ptr(),
        state.data_ptr(),
        history.data_ptr() if debug_history else None,
        B,
        max_iterations,
        qp_iterations,
        ls_iterations,
        int(line_search == "polynomial"),
        int(barrier == "mpc"),
    )
    if family.cuda_functor is not None:
        lib = _build.load_fused_ik(_CUDA_FAMILY_IDS[kind], n, dtype == torch.float64)
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mo_fused_ik_launch(*io[1:], ctypes.c_double(link_len), stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_ik kernel launch failed: error {rc}: {lib.mo_fused_ik_error_string(rc).decode()}"
            )
        KERNEL_LAUNCHES += 1
        return x_out, state, history
    lib = family.cuda_program.library()
    with torch.cuda.device(data.device):
        rc = lib.mo_generated_launch(*io, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"generated fused_ik kernel launch failed: error {rc}: {lib.mo_generated_error_string(rc).decode()}"
        )
    GENERATED_LAUNCHES += 1
    return x_out, state, history


def _fused_solve_plain_batch(family, data, x0, *budget):
    """The plain counterpart of ``_fused_solve_cuda``: ``_fused_solve_plain``
    on the batch-major tensors' feature-major views (no copy), its results
    returned batch-major."""
    x_t, state_t, hist_t = _fused_solve_plain(family, data.T, x0.T, *budget)
    return x_t.T, state_t.T, None if hist_t is None else hist_t.permute(2, 0, 1)


def _fused_solve(
    family, data, x0, max_iterations, qp_iterations, ls_iterations,
    line_search, barrier, debug_history, return_state, device,
):
    _check_options(max_iterations, qp_iterations, ls_iterations, line_search, barrier)
    # Medium-N dispatch, as pallas_ik.py:862-880: past the register tier's
    # KKT cap the blocked tier solves the same family.
    if family.n + family.m_eq > REGISTER_KKT_MAX:
        if debug_history:
            raise ValueError(
                "debug_history is a register-tier feature; the blocked "
                f"tier (n + m_eq = {family.n + family.m_eq} > "
                f"{REGISTER_KKT_MAX}) does not record per-iteration rows"
            )
        return blocked.blocked_solve_batch(
            family, data, x0,
            max_iterations=max_iterations,
            qp_iterations=qp_iterations,
            ls_iterations=ls_iterations,
            line_search=line_search,
            barrier=barrier,
            return_state=return_state,
            device=device,
        )
    data, x0 = convert.to_batch_major(data, x0, device)
    if data.shape[1] != family.data_rows or x0.shape[1] != family.n:
        raise ValueError(
            f"expected data (B, {family.data_rows}) and x0 (B, {family.n}); got "
            f"{tuple(data.shape)} and {tuple(x0.shape)}"
        )
    budget = (max_iterations, qp_iterations, ls_iterations, line_search, barrier, debug_history)
    if data.is_cuda:
        x, state, hist = _fused_solve_cuda(family, data, x0, *budget)
    elif data.device.type == "cpu":
        x, state, hist = _fused_solve_plain_batch(family, data, x0, *budget)
    else:
        raise NotImplementedError(f"no fused solve for device {data.device}")
    outs = [x]
    if return_state:
        outs.append(state)
    if debug_history:
        outs.append(hist)
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


def fused_solve_refined(
    family: FusedFamily,
    data,  # (B, data_rows)
    x0,  # (B, n)
    refine_fn,  # (data_k (K, rows) float64, x0_k (K, n) float64) -> (K, n) float64
    refine_k: int = 64,
    eq_penalty: float = 1.0,
    **kernel_kwargs,
):
    """The fused solve plus a float64 refinement of the worst-merit lanes
    (pallas_ik.py:1017-1070): the ``refine_k`` lanes of highest merit
    f + eq_penalty * |eq|_1 (the solve's own state) are re-solved by
    ``refine_fn``, typically the general path in float64
    (``models.ik.make_spatial_refine_fn``); a refined lane replaces the
    solve's answer only when its float64 merit, by the family's own
    ``errors``, is strictly better. Returns (B, n) in x0's dtype. A
    ``device`` keyword places numpy inputs, as in ``fused_solve_batch``."""
    n = family.n
    for reserved in ("return_state", "debug_history"):
        if reserved in kernel_kwargs:
            raise ValueError(
                f"fused_solve_refined owns {reserved!r} (it reads the "
                "solve's per-lane state to pick refinement lanes and "
                "returns only the (B, n) solutions); call fused_solve_batch "
                "directly for raw state/history access"
            )
    data, x0 = convert.to_batch_major(data, x0, kernel_kwargs.pop("device", None))
    x, state = fused_solve_batch(family, data, x0, return_state=True, **kernel_kwargs)

    def merit_of(xs, ds):
        f, eq = family.errors(
            [xs[:, i] for i in range(n)], [ds[:, i] for i in range(family.data_rows)]
        )
        return f + eq_penalty * eq

    merit = state[:, 0] + eq_penalty * state[:, 1]
    worst = torch.topk(merit, refine_k).indices
    d64 = data[worst].to(torch.float64)
    xr = refine_fn(d64, x0[worst].to(torch.float64))
    x_worst = x[worst].to(torch.float64)
    take = (merit_of(xr, d64) < merit_of(x_worst, d64))[:, None]
    out = x.clone()
    out[worst] = torch.where(take, xr, x_worst).to(x.dtype)
    return out


def fused_solve_proximal(
    family: FusedFamily,
    data,  # (B, data_rows - n): the family's payload WITHOUT x_ref
    x0,  # (B, n)
    stages: int = 4,
    **kernel_kwargs,
):
    """Proximal-point continuation for redundant families
    (pallas_ik.py:1073-1109): ``family`` carries ``x_ref`` as its LAST
    ``n`` data rows (the ``prox_weight`` builders of ``models.ik``); each
    stage solves with ``x_ref`` at the previous stage's result. All stages
    run the same kernel instance. Returns (B, n)."""
    if kernel_kwargs.get("debug_history"):
        raise ValueError(
            "fused_solve_proximal chains stage outputs into stage inputs; "
            "debug_history's (x, history) tuple cannot be chained -- call "
            "fused_solve_batch per stage yourself to collect histories"
        )
    if kernel_kwargs.get("return_state"):
        raise ValueError("fused_solve_proximal returns the (B, n) solutions only")
    data, x = convert.to_batch_major(data, x0, kernel_kwargs.pop("device", None))
    for _ in range(stages):
        d = torch.cat([data, x], dim=1)
        x = fused_solve_batch(family, d, x, **kernel_kwargs)
    return x


def fused_solve_multi_start(
    family: FusedFamily,
    data,  # (B, data_rows)
    x0s,  # (B, S, n): S starts per instance
    eq_penalty: float = 1.0,
    **kernel_kwargs,
):
    """Multi-start robustification of the fused path
    (pallas_ik.py:1112-1140): all B*S starts in one solve, and per instance
    the start of lowest merit f + eq_penalty * |eq|_1, by the family's own
    ``errors`` on the solutions. Returns (B, n)."""
    if kernel_kwargs.get("debug_history") or kernel_kwargs.get("return_state"):
        raise ValueError("fused_solve_multi_start returns the (B, n) solutions only")
    device = kernel_kwargs.pop("device", None)
    if not torch.is_tensor(x0s):
        x0s = torch.as_tensor(x0s, device=convert._resolve_device(device))
    if x0s.dim() != 3 or x0s.shape[2] != family.n:
        raise ValueError(f"x0s must be (B, S, {family.n}), not {tuple(x0s.shape)}")
    B, S, n = x0s.shape
    data = torch.as_tensor(data, device=x0s.device)
    data_rep = torch.repeat_interleave(data, S, dim=0)
    x = fused_solve_batch(family, data_rep, x0s.reshape(B * S, n), **kernel_kwargs)
    f, eq = family.errors(
        [x[:, i] for i in range(n)], [data_rep[:, i] for i in range(family.data_rows)]
    )
    best = torch.argmin((f + eq_penalty * eq).reshape(B, S), dim=1)
    return x.reshape(B, S, n)[torch.arange(B, device=best.device), best]


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
