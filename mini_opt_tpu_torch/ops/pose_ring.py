"""Whole-solve batched SE(2) pose-graph rings, the PyTorch port of
``mini_opt_tpu/ops/pallas_pose_ring.py``.

An N-pose odometry chain (edges ``(t, t+1)``) plus one or more loop
closures, with a soft anchor on pose 0. The Gauss-Newton Hessian is block
tridiagonal (3x3 blocks along the chain) plus the closures' couplings, so
one damped step solves by the bordered block-Thomas algorithm: the closure
endpoints are the border poses, the chain segments between them are
eliminated by block-Thomas sweeps that carry the border columns, and the
borders solve a small Schur system (a 3x3 adjugate inverse for one closure,
an unrolled 3k x 3k LDL^T for k border poses). Around it sits the solver
skeleton at ``NLSParams`` defaults: lambda machine (lambda_0 = 0, failure
init 1e-2, x0.1 on success, x0.8 on restore, cap 1), Armijo backtracking
with tau = 0.5, best-merit return.

The whole solve of one instance runs as one CUDA kernel, one instance per
thread: the device code is ``csrc/pose_ring.cuh``, its float and double
instances are built from ``pose_ring.cu`` (with the C launcher) and
``pose_ring_f64.cu``. It replaces the TPU kernel
``pallas_pose_ring.py::_make_ring_kernel``. Beside it sits
``_pose_ring_plain``, the same computation as plain PyTorch on lists of
``(B,)`` tensors, a line-by-line counterpart of ``_make_ring_kernel``. The
entry point dispatches on the tensors' device: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise. ``backend="xla"`` (the
JAX package's oracle route) asks for the plain version on whatever device
the tensors lie.

Layouts follow the JAX package: ``(B, 3E)`` edge measurements (chain edges
first, then the closures in declaration order) and ``(B, 3N)`` starts in,
``(B, 3N)`` poses and ``(B, 3)`` states ``(f, 0, flags)`` out. Internally
every tensor is feature-major, ``(rows, B)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .. import convert
from . import _build
from ._common import _CUDA_DTYPE_IDS, _check_cuda_tensors, _div, _maximum, _minimum
from .fused_ik import _ldlt_apply, _ldlt_bad, _ldlt_factor_unrolled

# Launches of the CUDA kernel in this process: the wrapper adds one right
# where it launches, and nowhere else.
KERNEL_LAUNCHES = 0

# csrc/pose_ring.cuh instances the multi-closure Schur system for up to
# this many border poses (k = 1 is the single-closure path).
CUDA_MAX_BORDERS = 6
CUDA_MAX_CLOSURES = 16

# math.pi, as pallas_pose_ring.py:48 (not the truncated literal of the IK
# kernels).
_PI = math.pi


def _wrap(a):
    return a - 2.0 * _PI * torch.floor(_div(a + _PI, 2.0 * _PI))


@dataclasses.dataclass(frozen=True)
class PoseRingFamily:
    """N-pose SE(2) odometry chain plus loop closure(s), soft anchor on pose
    0. ``closure=(cf, ct)`` is a single closure edge's (from, to) pose pair;
    ``closures=((cf1, ct1), ...)`` the multi-closure form; neither selects
    the canonical ring (N-1, 0). Per-lane data: the E = N-1+len(closures)
    edge measurements raveled (``data[3e:3e+3] = (dx, dy, dtheta)``, chain
    edges first, then the closures in declaration order)."""

    n_poses: int
    anchor_weight: float = 100.0
    closure: "tuple | None" = None
    closures: tuple = ()

    @property
    def closure_list(self) -> tuple:
        if self.closures:
            return self.closures
        if self.closure is not None:
            return (self.closure,)
        return ((self.n_poses - 1, 0),)

    @property
    def n_edges(self) -> int:
        return self.n_poses - 1 + len(self.closure_list)

    @property
    def dim(self) -> int:
        return 3 * self.n_poses


def _validate_closure(c, n_poses):
    cf, ct = int(c[0]), int(c[1])
    if not (cf != ct and 0 <= cf < n_poses and 0 <= ct < n_poses):
        raise ValueError(f"closure {tuple(c)} needs two distinct poses of 0..{n_poses - 1}")
    if not (abs(cf - ct) >= 2 or {cf, ct} == {0, n_poses - 1}):
        raise ValueError("closure parallel to a chain edge is a doubled edge, not a loop")
    return (cf, ct)


@functools.lru_cache(maxsize=None)
def pose_ring_family(n_poses: int, anchor_weight: float = 100.0, closure=None, closures=None) -> PoseRingFamily:
    if n_poses < 2:
        raise ValueError(f"a pose ring needs at least 2 poses, not {n_poses}")
    if closure is not None:
        closure = _validate_closure(closure, n_poses)
    if closures:
        closures = tuple(_validate_closure(c, n_poses) for c in closures)
        if closure is not None:
            raise ValueError("pass either closure= or closures=, not both")
    return PoseRingFamily(
        n_poses=n_poses,
        anchor_weight=anchor_weight,
        closure=closure,
        closures=tuple(closures) if closures else (),
    )


# ---------------------------------------------------------------------------
# 3x3 block helpers (blocks are 3x3 nested lists of (B,) tensors). Each sum
# starts from 0, as Python's ``sum`` in the JAX kernel does.
# ---------------------------------------------------------------------------


def _mat33_inv(M, zero, one):
    """Adjugate inverse; returns (inv, bad) where bad flags a tiny or
    non-finite determinant."""
    a, b, c = M[0]
    d, e, f = M[1]
    g, h, i = M[2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    tiny = torch.finfo(zero.dtype).tiny
    good = (torch.abs(det) > tiny) & torch.isfinite(det)
    bad = torch.where(good, zero, one)
    inv_det = one / torch.where(good, det, one)
    adj = [
        [A, c * h - b * i, b * f - c * e],
        [B, a * i - c * g, c * d - a * f],
        [C, b * g - a * h, a * e - b * d],
    ]
    return [[adj[r][s] * inv_det for s in range(3)] for r in range(3)], bad


def _mm(A, B):
    return [[sum(A[r][k] * B[k][s] for k in range(3)) for s in range(3)] for r in range(3)]


def _mTm(A, B):  # A^T @ B
    return [[sum(A[k][r] * B[k][s] for k in range(3)) for s in range(3)] for r in range(3)]


def _mv(A, v):
    return [sum(A[r][k] * v[k] for k in range(3)) for r in range(3)]


def _mTv(A, v):
    return [sum(A[k][r] * v[k] for k in range(3)) for r in range(3)]


def _msub(A, B):
    return [[A[r][s] - B[r][s] for s in range(3)] for r in range(3)]


def _madd(A, B):
    return [[A[r][s] + B[r][s] for s in range(3)] for r in range(3)]


def _mT(A):
    return [[A[s][r] for s in range(3)] for r in range(3)]


def _vsub(a, b):
    return [a[k] - b[k] for k in range(3)]


# ---------------------------------------------------------------------------
# The plain version of the kernel.
# ---------------------------------------------------------------------------


def _pose_ring_plain(family, data_t, x0_t, max_iterations, ls_iterations):
    """The kernel's computation as plain PyTorch on feature-major tensors:
    ``data_t (3E, B)``, ``x0_t (3N, B)`` -> ``x (3N, B)``, ``state (3, B)``
    = (f, 0, flags).

    A line-by-line counterpart of ``pallas_pose_ring.py::_make_ring_kernel``:
    the same operations in the same order, so that the CUDA kernel, built
    without FMA contraction, reproduces it bit for bit on the card."""
    N = family.n_poses
    wa = float(family.anchor_weight)
    closure_list = family.closure_list
    n_cl = len(closure_list)
    E = N - 1 + n_cl
    # Single closure: border pose a = min endpoint (one 3x3 Schur block).
    # Multi closure: border set = all endpoints, dense 3k x 3k Schur.
    cf, ct = closure_list[0]
    a_b, b_b = (min(cf, ct), max(cf, ct))

    def edge_ij(e):
        return (e, e + 1) if e < N - 1 else closure_list[e - (N - 1)]

    def errors(x, data):
        """f = 0.5 ||r||^2 over all edges and the anchor."""
        f = None
        for e in range(E):
            i, j = edge_ij(e)
            xi, yi, thi = x[3 * i], x[3 * i + 1], x[3 * i + 2]
            xj, yj, thj = x[3 * j], x[3 * j + 1], x[3 * j + 2]
            c, s = torch.cos(thi), torch.sin(thi)
            dxw, dyw = xj - xi, yj - yi
            rx = c * dxw + s * dyw - data[3 * e]
            ry = -s * dxw + c * dyw - data[3 * e + 1]
            rt = _wrap(thj - thi - data[3 * e + 2])
            term = 0.5 * (rx * rx + ry * ry + rt * rt)
            f = term if f is None else f + term
        ax, ay, at = x[0], x[1], _wrap(x[2])
        return f + 0.5 * wa * wa * (ax * ax + ay * ay + at * at)

    def linearize(x, data, zero):
        """Gauss-Newton blocks: diagonal D[0..N-1], chain blocks U[t] =
        block(t, t+1), closure blocks Cbs[j] = block(min_j, max_j), gradient
        g (3N), cost f."""
        D = [[[zero] * 3 for _ in range(3)] for _ in range(N)]
        U = [[[zero] * 3 for _ in range(3)] for _ in range(N - 1)]
        Cbs = [[[zero] * 3 for _ in range(3)] for _ in range(n_cl)]
        g = [zero] * (3 * N)
        f = None
        one_l = torch.ones_like(zero)
        for e in range(E):
            i, j = edge_ij(e)
            xi, yi, thi = x[3 * i], x[3 * i + 1], x[3 * i + 2]
            xj, yj, thj = x[3 * j], x[3 * j + 1], x[3 * j + 2]
            c, s = torch.cos(thi), torch.sin(thi)
            dxw, dyw = xj - xi, yj - yi
            rx_raw = c * dxw + s * dyw
            ry_raw = -s * dxw + c * dyw
            r = [rx_raw - data[3 * e], ry_raw - data[3 * e + 1], _wrap(thj - thi - data[3 * e + 2])]
            term = 0.5 * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
            f = term if f is None else f + term
            Ji = [[-c, -s, ry_raw], [s, -c, -rx_raw], [zero, zero, -one_l]]
            Jj = [[c, s, zero], [-s, c, zero], [zero, zero, one_l]]
            JiTJi = _mTm(Ji, Ji)
            JjTJj = _mTm(Jj, Jj)
            JiTJj = _mTm(Ji, Jj)
            for r_ in range(3):
                for s_ in range(3):
                    D[i][r_][s_] = D[i][r_][s_] + JiTJi[r_][s_]
                    D[j][r_][s_] = D[j][r_][s_] + JjTJj[r_][s_]
            if e < N - 1:
                for r_ in range(3):
                    for s_ in range(3):
                        U[e][r_][s_] = U[e][r_][s_] + JiTJj[r_][s_]
            else:
                # block(i, j); stored as block(min, max).
                Cb = Cbs[e - (N - 1)]
                for r_ in range(3):
                    for s_ in range(3):
                        Cb[r_][s_] = Cb[r_][s_] + (JiTJj[s_][r_] if i > j else JiTJj[r_][s_])
            gi = _mTv(Ji, r)
            gj = _mTv(Jj, r)
            for k in range(3):
                g[3 * i + k] = g[3 * i + k] + gi[k]
                g[3 * j + k] = g[3 * j + k] + gj[k]
        ax, ay, at = x[0], x[1], _wrap(x[2])
        f = f + 0.5 * wa * wa * (ax * ax + ay * ay + at * at)
        for k in range(3):
            D[0][k][k] = D[0][k][k] + wa * wa
        g[0] = g[0] + wa * wa * ax
        g[1] = g[1] + wa * wa * ay
        g[2] = g[2] + wa * wa * at
        return D, U, Cbs, g, f

    def damped(D, g, lam, zero):
        Dd = [[[D[p][r][s] + (lam if r == s else zero) for s in range(3)] for r in range(3)] for p in range(N)]
        b = [[-g[3 * p + r] for r in range(3)] for p in range(N)]
        return Dd, b

    def sweep(seg, Dd, U, b, Brow, cols, zero33, zero, one):
        """Block-Thomas forward and backward sweep over the consecutive
        poses ``seg``, carrying the rhs and one 3x3 column block per border
        in ``cols`` (``Brow[p][q]``: the coupling block(p, q), where
        present). Returns (y, W, bad)."""
        bad = zero
        dinv, z, ZW = {}, {}, {}
        for idx, p in enumerate(seg):
            if idx == 0:
                dk = Dd[p]
                zk = b[p]
                Zk = {q: Brow[p].get(q, zero33) for q in cols}
            else:
                pp = seg[idx - 1]
                Upp = U[pp]  # block(pp, p)
                dk = _msub(Dd[p], _mTm(Upp, _mm(dinv[pp], Upp)))
                zk = _vsub(b[p], _mTv(Upp, _mv(dinv[pp], z[pp])))
                Zk = {q: _msub(Brow[p].get(q, zero33), _mTm(Upp, _mm(dinv[pp], ZW[pp][q]))) for q in cols}
            invp, badp = _mat33_inv(dk, zero, one)
            bad = torch.maximum(bad, badp)
            dinv[p], z[p], ZW[p] = invp, zk, Zk
        y, W = {}, {}
        last = seg[-1]
        y[last] = _mv(dinv[last], z[last])
        W[last] = {q: _mm(dinv[last], ZW[last][q]) for q in cols}
        for idx in range(len(seg) - 2, -1, -1):
            p, pn = seg[idx], seg[idx + 1]
            Up = U[p]  # block(p, p+1)
            y[p] = _mv(dinv[p], _vsub(z[p], _mv(Up, y[pn])))
            W[p] = {q: _mm(dinv[p], _msub(ZW[p][q], _mm(Up, W[pn][q]))) for q in cols}
        return y, W, bad

    def finite_flag(dx, bad, zero, one):
        fin = dx[0] == dx[0]
        for v in dx:
            fin = fin & torch.isfinite(v)
        return torch.maximum(bad, torch.where(fin, zero, one))

    def bordered_solve(D, U, Cbs, g, lam, zero, one):
        """(H + lam I) dx = -g with the border = pose a (the lower closure
        endpoint): the chain segments [0..a-1] and [a+1..N-1] are swept with
        one border column, then the 3x3 border block is Schur-solved."""
        Cb = Cbs[0]
        Dd, b = damped(D, g, lam, zero)
        zero33 = [[zero] * 3 for _ in range(3)]
        # Border coupling rows block(r, a) and columns block(a, r) for the
        # poses next to the border; a closure endpoint b next to a adds.
        Brow, Crow = {}, {}
        if a_b >= 1:
            Brow[a_b - 1] = U[a_b - 1]
            Crow[a_b - 1] = _mT(U[a_b - 1])
        Brow[a_b + 1] = _mT(U[a_b])
        Crow[a_b + 1] = U[a_b]
        Brow[b_b] = _madd(Brow.get(b_b, zero33), _mT(Cb))
        Crow[b_b] = _madd(Crow.get(b_b, zero33), Cb)
        Brow_cols = {p: {a_b: Brow[p]} for p in Brow}

        bad = zero
        y, W = {}, {}
        segs = ([list(range(0, a_b))] if a_b >= 1 else []) + [list(range(a_b + 1, N))]
        for seg in segs:
            rows = {p: Brow_cols.get(p, {}) for p in seg}
            ys, Ws, bad_s = sweep(seg, Dd, U, b, rows, (a_b,), zero33, zero, one)
            bad = torch.maximum(bad, bad_s)
            y.update(ys)
            W.update({p: Ws[p][a_b] for p in Ws})

        # Schur complement on the border pose: S = A - sum_r C_r W_r.
        S = Dd[a_b]
        rhs0 = b[a_b]
        for r_pose in sorted(Crow):
            S = _msub(S, _mm(Crow[r_pose], W[r_pose]))
            rhs0 = _vsub(rhs0, _mv(Crow[r_pose], y[r_pose]))
        Sinv, badS = _mat33_inv(S, zero, one)
        bad = torch.maximum(bad, badS)
        dx0 = _mv(Sinv, rhs0)

        dx = [zero] * (3 * N)
        for r_ in range(3):
            dx[3 * a_b + r_] = dx0[r_]
        for k in range(N):
            if k == a_b:
                continue
            xk = _vsub(y[k], _mv(W[k], dx0))
            for r_ in range(3):
                dx[3 * k + r_] = xk[r_]
        return dx, finite_flag(dx, bad, zero, one)

    def bordered_solve_multi(D, U, Cbs, g, lam, zero, one):
        """(H + lam I) dx = -g for several closures: the borders are all
        closure endpoints, each chain segment between them is swept with a
        column per adjacent border, and the borders' dense 3k x 3k Schur
        system is factored by the unrolled LDL^T."""
        borders = sorted({p for c in closure_list for p in c})
        k = len(borders)
        bset = set(borders)
        bidx = {p: i for i, p in enumerate(borders)}
        Dd, b = damped(D, g, lam, zero)
        zero33 = [[zero] * 3 for _ in range(3)]

        segs, cur = [], []
        for p in range(N):
            if p in bset:
                if cur:
                    segs.append(cur)
                cur = []
            else:
                cur.append(p)
        if cur:
            segs.append(cur)

        bad = zero
        seg_results = []
        for seg in segs:
            nbs = []
            if seg[0] - 1 >= 0:
                nbs.append(seg[0] - 1)  # left border
            if seg[-1] + 1 <= N - 1:
                nbs.append(seg[-1] + 1)  # right border
            Brow = {p: {} for p in seg}
            if seg[0] - 1 >= 0:
                Brow[seg[0]][seg[0] - 1] = _mT(U[seg[0] - 1])  # block(seg0, left)
            if seg[-1] + 1 <= N - 1:
                Brow[seg[-1]][seg[-1] + 1] = U[seg[-1]]  # block(seg_last, right)
            y, W, bad_s = sweep(seg, Dd, U, b, Brow, nbs, zero33, zero, one)
            bad = torch.maximum(bad, bad_s)
            seg_results.append((seg, nbs, y, W))

        # Schur system on the borders: direct couplings (chain edges between
        # adjacent borders, closure blocks) minus the segment eliminations.
        S = [[None] * k for _ in range(k)]
        rhs_b = [list(b[p]) for p in borders]
        for i, p in enumerate(borders):
            S[i][i] = Dd[p]
            for j in range(k):
                if j != i and S[i][j] is None:
                    S[i][j] = zero33
        for p in borders:
            if p + 1 in bset:
                S[bidx[p]][bidx[p + 1]] = _madd(S[bidx[p]][bidx[p + 1]], U[p])
                S[bidx[p + 1]][bidx[p]] = _madd(S[bidx[p + 1]][bidx[p]], _mT(U[p]))
        for jc, (f_, t_) in enumerate(closure_list):
            lo, hi = min(f_, t_), max(f_, t_)
            S[bidx[lo]][bidx[hi]] = _madd(S[bidx[lo]][bidx[hi]], Cbs[jc])
            S[bidx[hi]][bidx[lo]] = _madd(S[bidx[hi]][bidx[lo]], _mT(Cbs[jc]))
        for seg, nbs, y, W in seg_results:
            for P in nbs:
                if P == seg[0] - 1:
                    r_p, C = seg[0], U[P]  # block(P, P+1)
                else:
                    r_p, C = seg[-1], _mT(U[seg[-1]])  # block(P, P-1)
                rhs_b[bidx[P]] = _vsub(rhs_b[bidx[P]], _mv(C, y[r_p]))
                for Q in nbs:
                    S[bidx[P]][bidx[Q]] = _msub(S[bidx[P]][bidx[Q]], _mm(C, W[r_p][Q]))

        Hf = [[S[ri // 3][ci // 3][ri % 3][ci % 3] for ci in range(3 * k)] for ri in range(3 * k)]
        rf = [rhs_b[ri // 3][ri % 3] for ri in range(3 * k)]
        Lf, df = _ldlt_factor_unrolled(Hf)
        bad = torch.maximum(bad, _ldlt_bad(df, zero))
        sol = _ldlt_apply(Lf, df, rf)
        dxb = {p: [sol[3 * i], sol[3 * i + 1], sol[3 * i + 2]] for i, p in enumerate(borders)}

        dx = [zero] * (3 * N)
        for p in borders:
            for r_ in range(3):
                dx[3 * p + r_] = dxb[p][r_]
        for seg, nbs, y, W in seg_results:
            for p in seg:
                xp = y[p]
                for Q in nbs:
                    xp = _vsub(xp, _mv(W[p][Q], dxb[Q]))
                for r_ in range(3):
                    dx[3 * p + r_] = xp[r_]
        return dx, finite_flag(dx, bad, zero, one)

    solve_fn = bordered_solve if n_cl == 1 else bordered_solve_multi

    data = [data_t[k] for k in range(3 * E)]
    x = [x0_t[k] for k in range(3 * N)]
    one = torch.ones_like(x[0])
    zero = torch.zeros_like(x[0])

    def const(v):
        return torch.full_like(one, v)

    lam = 0.0 * one
    restore = zero
    best_x = list(x)
    f_best = torch.full_like(one, math.inf)
    fac_bad = lam_maxed = accepted = f_acc = f_pre = zero
    for _ in range(max_iterations):
        D, U, Cbs, g, f_pre = linearize(x, data, zero)

        better = f_pre < f_best
        best_x = [torch.where(better, x[k], best_x[k]) for k in range(3 * N)]
        f_best = torch.where(better, f_pre, f_best)

        dx, bad = solve_fn(D, U, Cbs, g, lam, zero, one)
        fac_bad = _maximum(fac_bad, bad)
        dd = sum(g[k] * dx[k] for k in range(3 * N))

        alpha = one
        accepted = zero
        bx = list(x)
        f_acc = f_pre
        for probe in range(ls_iterations + 1):
            if probe > 0:
                alpha = alpha * 0.5
            cand = [x[k] + alpha * dx[k] for k in range(3 * N)]
            f_c = errors(cand, data)
            ok = (f_c <= f_pre + 1e-4 * alpha * _minimum(dd, zero)).to(one.dtype)
            take = ok * (1.0 - accepted)
            bx = [take * cand[k] + (1.0 - take) * bx[k] for k in range(3 * N)]
            f_acc = take * f_c + (1.0 - take) * f_acc
            accepted = _minimum(accepted + take, 1.0)

        x = [torch.where(accepted > 0, bx[k], x[k]) for k in range(3 * N)]
        # Lambda machine at NLSParams defaults (nonlinear.cc:296-343).
        lam_succ = _maximum(lam * torch.where(restore > 0, const(0.8), const(0.1)), 0.0)
        lam_fail = torch.where(restore > 0, lam * 10.0, _maximum(1e-2 * one, lam * 10.0))
        lam_maxed = torch.where((accepted == 0) & (lam >= 1.0), one, lam_maxed)
        lam = _minimum(torch.where(accepted > 0, lam_succ, lam_fail), 1.0)
        restore = torch.where(accepted > 0, zero, one)

    f_fin = torch.where(accepted > 0, f_acc, f_pre)
    better = f_fin < f_best
    x_out = torch.stack([torch.where(better, x[k], best_x[k]) for k in range(3 * N)])
    f_out = torch.where(better, f_fin, f_best)
    state = torch.stack([f_out, torch.zeros_like(f_out), fac_bad + 2.0 * lam_maxed])
    return x_out, state


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


def _pose_ring_cuda(family, data_t, x0_t, max_iterations, ls_iterations):
    """Launch ``csrc/pose_ring.cu`` on feature-major CUDA tensors; same
    contract as ``_pose_ring_plain``. Raises on anything the kernel does not
    take and on a refused launch."""
    global KERNEL_LAUNCHES
    N, E = family.n_poses, family.n_edges
    cl = family.closure_list
    # One closure has one border pose; several have all their endpoints.
    borders = 1 if len(cl) == 1 else len({p for c in cl for p in c})
    if len(cl) > CUDA_MAX_CLOSURES or borders > CUDA_MAX_BORDERS:
        raise NotImplementedError(
            f"csrc/pose_ring.cuh takes up to {CUDA_MAX_CLOSURES} closures and "
            f"{CUDA_MAX_BORDERS} border poses; got {len(cl)} closures and {borders} borders"
        )
    dtype = data_t.dtype
    B = data_t.shape[1] if data_t.dim() == 2 else -1
    _check_cuda_tensors((("data", data_t, (3 * E, B)), ("x0", x0_t, (3 * N, B))), dtype, data_t.device, B)
    kw = dict(dtype=dtype, device=data_t.device)
    x_out = torch.empty((3 * N, B), **kw)
    state = torch.empty((3, B), **kw)
    if B == 0:
        return x_out, state
    lib = _build.load_library()
    scratch = torch.empty((lib.mo_pose_ring_scratch_slots(N, len(cl)), B), **kw)
    flat = (ctypes.c_int * (2 * len(cl)))(*(v for c in cl for v in c))
    with torch.cuda.device(data_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mo_pose_ring_launch(
            _CUDA_DTYPE_IDS[dtype], N, len(cl), flat, ctypes.c_double(float(family.anchor_weight)),
            data_t.data_ptr(), x0_t.data_ptr(), x_out.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            B, max_iterations, ls_iterations, stream,
        )
    if rc != 0:
        raise RuntimeError(f"pose_ring kernel launch failed: {_build.error_string(rc)}")
    KERNEL_LAUNCHES += 1
    return x_out, state


def pose_ring_solve_batch(
    family: PoseRingFamily,
    data,  # (B, 3E) edge measurements
    x0,  # (B, 3N) initial poses
    max_iterations: int = 6,
    ls_iterations: int = 2,
    return_state: bool = False,
    backend: str = "pallas",
    device=None,
):
    """Solve B pose graphs of ``family`` with the bordered block-Thomas
    solve.

    Returns x (B, 3N); ``return_state`` appends (B, 3) per-lane
    (f, 0, flags) accepted by ``fused_termination_status``. With the
    default ``backend="pallas"`` tensors run where they lie (CPU: the plain
    version; CUDA: the kernel); ``backend="xla"`` runs the plain version on
    the tensors' device. numpy inputs go to ``device``, which is "cuda"
    unless the caller passes "cpu"."""
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend must be 'pallas' or 'xla', not {backend!r}")
    if max_iterations < 0 or ls_iterations < 0:
        raise ValueError("max_iterations and ls_iterations must be >= 0")
    data_t, x0_t = convert.to_feature_major(data, x0, device)
    if data_t.shape[0] != 3 * family.n_edges or x0_t.shape[0] != family.dim:
        raise ValueError(
            f"expected data (B, {3 * family.n_edges}) and x0 (B, {family.dim}); got "
            f"{tuple(data_t.T.shape)} and {tuple(x0_t.T.shape)}"
        )
    args = (family, data_t, x0_t, max_iterations, ls_iterations)
    if backend == "xla" or data_t.device.type == "cpu":
        x_t, state_t = _pose_ring_plain(*args)
    elif data_t.is_cuda:
        x_t, state_t = _pose_ring_cuda(*args)
    else:
        raise NotImplementedError(f"no pose-ring solve for device {data_t.device}")
    if return_state:
        return x_t.T, state_t.T
    return x_t.T
