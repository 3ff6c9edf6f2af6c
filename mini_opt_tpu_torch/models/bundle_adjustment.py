"""Bundle adjustment (cameras + landmarks), the port of
``mini_opt_tpu/models/bundle_adjustment.py``: C cameras with 6-DoF poses
and L landmarks tied by K reprojection observations, one ``BlockResidual``
of every observation. Small scenes take the dense path; large ones the
matrix-free CG path (``qp_solver="cg"``) under the Jacobi, block-Jacobi or
exact Schur-complement preconditioners.

Variable layout: camera c owns ``[6c, 6c+6)`` as (t_c(3), w_c(3)), the
camera-to-world translation and rotation vector; landmark l owns
``[6C + 3l, 6C + 3l + 3)``. Observation (camera c sees landmark l at the
normalized pixel (u, v)):

    p_cam = R(w_c)^T (X_l - t_c)
    r     = weight * (p_cam[:2] / p_cam[2] - (u, v))

The 7-dim monocular gauge is fixed by camera 0's pose plus a scale row
pinning ``||t_1 - t_0||``, softly (a prior) or exactly (``hard_anchor``).
``jax.ops.segment_sum`` is ``index_add``; the per-landmark and per-camera
LDL^T factors are ``ops/kkt.py``'s batched ones, the reduced camera system
``_ldlt_masked`` (the JAX package's order at its size).
numpy inputs go to ``device`` ("cuda" unless named). Not ported yet:
``solve_bundle_adjustment_large_sharded`` (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..nonlinear import NLSParams, Problem, nls_solve
from ..ops.kkt import ldlt_factorize, ldlt_solve
from ..residual import BlockResidual, make_residual, robustify
from ..structs import LineSearchStrategy, NLSResult
from ..utils.so3 import quat_conjugate, quat_exp, quat_log, quat_rotate
from .pose_graph import _as_tensor


def _reprojection_residual(xl, row):
    """2-row reprojection residual of one observation; xl = (t_c(3), w_c(3),
    X(3)), row = (u, v, weight)."""
    t_c, w_c, X = xl[0:3], xl[3:6], xl[6:9]
    uv, w = row[0:2], row[2]
    p = quat_rotate(quat_conjugate(quat_exp(w_c)), X - t_c)
    # Depth guard: a step that pushes a point near the camera plane keeps
    # the residual finite (the line search rejects it on merit).
    d = p[2]
    d_safe = torch.where(torch.abs(d) < 1e-6, torch.where(d < 0, torch.full_like(d, -1e-6),
                                                           torch.full_like(d, 1e-6)), d)
    return w * (p[0:2] / d_safe - uv)


def _obs_data(uv, weights):
    if weights is None:
        weights = torch.ones((uv.shape[0],), dtype=uv.dtype, device=uv.device)
    weights = _as_tensor(weights, like=uv).to(uv.dtype)
    return torch.cat([uv, weights[:, None]], dim=1)


def _obs_indices(n_cameras: int, obs_cl) -> np.ndarray:
    """(K, 9) global indices: the camera's block, then the landmark's."""
    obs = np.asarray(obs_cl, dtype=np.int64)
    cam = 6 * obs[:, 0:1] + np.arange(6)[None, :]
    lmk = 6 * n_cameras + 3 * obs[:, 1:2] + np.arange(3)[None, :]
    return np.concatenate([cam, lmk], axis=1)


def make_ba_problem(
    n_cameras: int,
    n_landmarks: int,
    obs_cl,  # (K, 2) int: (camera, landmark) per observation
    uv,  # (K, 2) normalized pixel coordinates
    weights=None,  # (K,)
    scale_ref: float = 1.0,  # gauge: target for ||t_1 - t_0||
    anchor_ref=None,  # (6,): camera-0 (t, w) to pin
    anchor_weight: float = 100.0,
    hard_anchor: bool = False,
    robust: Optional[str] = None,  # "huber" | "cauchy" on the observations
    robust_delta: float = 1.0,
    device=None,
) -> Problem:
    """The bundle-adjustment Problem over 6C + 3L variables: camera 0
    pinned to ``anchor_ref`` (origin if None) plus the scale row, soft
    priors of weight ``anchor_weight`` or, with ``hard_anchor``, 7 exact
    equality rows."""
    uv = _as_tensor(uv, device=device)
    data = _obs_data(uv, weights)
    indices = torch.as_tensor(_obs_indices(n_cameras, obs_cl), device=uv.device)
    block = BlockResidual(fn=_reprojection_residual, indices=indices, dim=2, data=data)
    if robust is not None:
        block = robustify(block, kind=robust, delta=robust_delta)
    ref = (torch.zeros((6,), dtype=uv.dtype, device=uv.device) if anchor_ref is None
           else _as_tensor(anchor_ref, like=uv))

    # Tensor constants: under torch.func.jacfwd a 0-dim value plus a Python
    # float comes out float64, which would break a float32 Jacobian.
    eps, sref = (torch.as_tensor(v, dtype=uv.dtype, device=uv.device) for v in (1e-18, scale_ref))

    def gauge(xl):
        # Camera 0's pose relative to the reference, and ||t_1 - t_0|| - scale_ref.
        d = xl[6:9] - xl[0:3]
        scale = torch.sqrt(torch.sum(d * d, dim=0) + eps) - sref
        return torch.cat([xl[0:3] - ref[0:3], xl[3:6] - ref[3:6], scale[None]])

    gauge_idx = list(range(9))  # t0, w0, t1
    dimension = 6 * n_cameras + 3 * n_landmarks
    if hard_anchor:
        return Problem(dimension=dimension, costs=(block,),
                       equality_constraints=(make_residual(gauge_idx, gauge, 7),))

    def anchor(xl):
        return anchor_weight * gauge(xl)

    return Problem(dimension=dimension, costs=(block, make_residual(gauge_idx, anchor, 7)))


class _Scene:
    """A scene's observation tensors, moved to an iterate's device and type
    once."""

    def __init__(self, n_cameras, obs_cl, uv, weights):
        obs = np.asarray(obs_cl, dtype=np.int64)
        uv = uv if torch.is_tensor(uv) else torch.as_tensor(np.asarray(uv))
        self.host = dict(idx=torch.as_tensor(_obs_indices(n_cameras, obs)), data=_obs_data(uv, weights),
                         cam=torch.as_tensor(obs[:, 0]), lmk=torch.as_tensor(obs[:, 1]))
        self.cache = {}

    def at(self, x):
        key = (x.device, x.dtype)
        if key not in self.cache:
            self.cache[key] = {k: v.to(device=x.device, dtype=x.dtype if v.is_floating_point() else torch.long)
                               for k, v in self.host.items()}
        return self.cache[key]

    def jacobians(self, x):
        """(K, 2, 9): every observation's Jacobian at x."""
        s = self.at(x)
        return vmap(lambda ri, rd: jacfwd(lambda v: _reprojection_residual(v, rd))(x[ri]))(s["idx"], s["data"])


def make_ba_jacobi_preconditioner(n_cameras: int, obs_cl, uv, weights=None, anchor_weight: float = 100.0):
    """Jacobi preconditioner of the CG path: ``x -> diag(J^T J)`` (the gauge
    prior on the first 9 variables, floored at 1e-12), the pose graphs'
    ``edge_jtj_diag`` core."""
    from .pose_graph import edge_jtj_diag

    scene = _Scene(n_cameras, obs_cl, uv, weights)

    def diag_fn(x):
        s = scene.at(x)
        d = edge_jtj_diag(_reprojection_residual, x, s["idx"], s["data"])
        d = torch.cat([d[:9] + anchor_weight * anchor_weight, d[9:]])
        return torch.maximum(d, torch.full_like(d, 1e-12))

    return diag_fn


def make_ba_retraction(n_cameras: int):
    """Additive update with the camera rotation vectors renormalized through
    the quaternion exp/log round trip (|w| <= pi); landmarks plain."""

    def retraction(x, dx, alpha):
        x_new = x + alpha * dx
        cams = x_new[: 6 * n_cameras].reshape(n_cameras, 6)
        cams = torch.cat([cams[:, 0:3], quat_log(quat_exp(cams[:, 3:6]))], dim=1)
        return torch.cat([cams.reshape(-1), x_new[6 * n_cameras:]])

    return retraction


def default_ba_params(dtype=torch.float64, max_iterations: int = 30) -> NLSParams:
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=1,  # unconstrained: one GN step per outer iteration
        absolute_exit_tol=1e-14,
        relative_exit_tol=1e-10,
        max_line_search_iterations=8,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        armijo_search_tau=0.5,
        lambda_initial=1e-4,
        min_lambda=1e-10,
    )


def _one_start(x0, device):
    """x0 (n,) (or (1, n)) as a (1, n) tensor, and whether it came unbatched:
    the problem pins camera 0 to the start's, so a solve takes one start."""
    from ..convert import _resolve_device

    x0 = x0 if torch.is_tensor(x0) else torch.as_tensor(np.asarray(x0), device=_resolve_device(device))
    if device is not None:
        x0 = x0.to(device)
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    if x0.shape[0] != 1:
        raise ValueError(f"x0 must be one start, (n,) or (1, n); got {tuple(x0.shape)}")
    return x0, single


def _solve(problem, params, x0, single, **kw):
    from ..structs import tree_map

    res = nls_solve(problem, params, x0, **kw)
    return tree_map(lambda t: t[0], res) if single else res


def solve_bundle_adjustment(
    n_cameras: int,
    n_landmarks: int,
    obs_cl,
    uv,
    x0,
    weights=None,
    scale_ref: float = 1.0,
    params: Optional[NLSParams] = None,
    robust: Optional[str] = None,
    robust_delta: float = 1.0,
    device=None,
) -> NLSResult:
    """Dense path (assembled Hessian); scenes up to a few hundred
    variables. numpy inputs follow a tensor ``x0``, else go to ``device``."""
    x0, single = _one_start(x0, device)
    problem = make_ba_problem(n_cameras, n_landmarks, obs_cl, _as_tensor(uv, like=x0), weights, scale_ref=scale_ref,
                              anchor_ref=x0[0, 0:6], robust=robust, robust_delta=robust_delta)
    if params is None:
        params = default_ba_params(x0.dtype)
    return _solve(problem, params, x0, single, retraction=make_ba_retraction(n_cameras))


def solve_bundle_adjustment_large(
    n_cameras: int,
    n_landmarks: int,
    obs_cl,
    uv,
    x0,
    weights=None,
    scale_ref: float = 1.0,
    params: Optional[NLSParams] = None,
    cg_iterations: int = 100,
    hard_anchor: bool = False,
    robust: Optional[str] = None,
    robust_delta: float = 1.0,
    device=None,
) -> NLSResult:
    """Large-scene path: matrix-free Jacobi-PCG Gauss-Newton over the
    observations, the (6C + 3L)^2 Hessian never formed; ``hard_anchor``
    fixes the 7-dim gauge exactly through the projected-CG equality path.
    For the Schur or block preconditioners, pass their factory to
    ``nls_solve(..., cg_preconditioner=...)`` with ``make_ba_problem``."""
    x0, single = _one_start(x0, device)
    uv = _as_tensor(uv, like=x0)
    problem = make_ba_problem(n_cameras, n_landmarks, obs_cl, uv, weights, scale_ref=scale_ref,
                              anchor_ref=x0[0, 0:6], hard_anchor=hard_anchor, robust=robust,
                              robust_delta=robust_delta)
    if params is None:
        params = default_ba_params(x0.dtype)
    params = dataclasses.replace(params, qp_solver="cg", cg_iterations=cg_iterations)
    diag_fn = make_ba_jacobi_preconditioner(n_cameras, obs_cl, uv, weights,
                                            anchor_weight=0.0 if hard_anchor else 100.0)
    return _solve(problem, params, x0, single, retraction=make_ba_retraction(n_cameras),
                  cg_diag_preconditioner=diag_fn)


def _blocks(scene, x, lam, C, L, anchor_weight):
    """The damped camera (C, 6, 6) and landmark (L, 3, 3) diagonal blocks of
    J^T J, and the per-observation Jacobian halves (Jc (K, 2, 6), Jl
    (K, 2, 3)). The gauge prior is added diagonally (camera 0's pose rows,
    the scale row's t_0 / t_1 parts): adequate for a preconditioner."""
    s = scene.at(x)
    J = scene.jacobians(x)
    Jc, Jl = J[:, :, 0:6], J[:, :, 6:9]
    kw = dict(dtype=x.dtype, device=x.device)
    eye6, eye3 = torch.eye(6, **kw), torch.eye(3, **kw)
    damp = lam + torch.full((), 1e-12, **kw)
    aw2 = anchor_weight * anchor_weight
    Hcc = torch.zeros((C, 6, 6), **kw).index_add(0, s["cam"], torch.einsum("koa,kob->kab", Jc, Jc))
    Hcc = torch.cat([(Hcc[0] + aw2 * eye6)[None], Hcc[1:]])
    top = torch.cat([torch.cat([Hcc[1, 0:3, 0:3] + aw2 * eye3, Hcc[1, 0:3, 3:6]], 1), Hcc[1, 3:6]], 0)
    Hcc = torch.cat([Hcc[:1], top[None], Hcc[2:]]) + damp * eye6
    Hll = torch.zeros((L, 3, 3), **kw).index_add(0, s["lmk"], torch.einsum("koa,kob->kab", Jl, Jl)) + damp * eye3
    return s, Jc, Jl, Hcc, Hll


def make_ba_block_preconditioner(n_cameras: int, n_landmarks: int, obs_cl, uv, weights=None,
                                 anchor_weight: float = 100.0):
    """Block-Jacobi preconditioner: per-camera 6x6 and per-landmark 3x3
    diagonal blocks of J^T J, damped and LDL^T-factored per outer
    iteration. Returns a factory ``(x, lam) -> apply`` for ``nls_solve``'s
    ``cg_preconditioner``."""
    scene = _Scene(n_cameras, obs_cl, uv, weights)
    C, L = n_cameras, n_landmarks

    def prec_fn(x, lam):
        _, _, _, Hcc, Hll = _blocks(scene, x, lam, C, L, anchor_weight)
        cam_fact, _ = ldlt_factorize(Hcc)
        lmk_fact, _ = ldlt_factorize(Hll)

        def apply(r):
            zc = ldlt_solve(cam_fact, r[: 6 * C].reshape(C, 6))
            zl = ldlt_solve(lmk_fact, r[6 * C:].reshape(L, 3))
            return torch.cat([zc.reshape(-1), zl.reshape(-1)])

        return apply

    return prec_fn


def _schur_apply(C, L, hll_fact, S_fact, coupling_c, coupling_l):
    """The exact (J^T J + lam I)^-1 r by back-substitution through the
    reduced camera system: ``coupling_c(yl)`` is W yl (C, 6) and
    ``coupling_l(zc)`` is W^T zc (L, 3)."""

    def apply(r):
        rc = r[: 6 * C]
        rl = r[6 * C:].reshape(L, 3)
        yl = ldlt_solve(hll_fact, rl)
        zc = ldlt_solve(S_fact, rc - coupling_c(yl).reshape(-1))
        zl = ldlt_solve(hll_fact, rl - coupling_l(zc.reshape(C, 6)))
        return torch.cat([zc, zl.reshape(-1)])

    return apply


def _ldlt_masked(H):
    """The JAX package's ``ldlt_factorize`` at any D (kkt.py:81-133): the
    column recurrence (``ops/kkt.py::ldlt_factorize``) up to 24 columns;
    past that its ``fori_loop`` form, column j from one masked
    matrix-vector product ``H[:, j] - L (d * L[j, :] * mask)``, so that a
    large system costs O(D) operations where the recurrence takes O(D^2).
    ``ops/kkt.py`` keeps the recurrence at every D, which the plain versions
    of kernels 4 and 5 match bit for bit; only the reduced camera system
    here passes 24 columns. Returns ``(L, d)``."""
    D = H.shape[-1]
    if D <= 24:
        return ldlt_factorize(H)[0]
    rows = torch.arange(D, device=H.device)
    L = torch.zeros_like(H)
    d = torch.zeros(H.shape[:-1], dtype=H.dtype, device=H.device)
    for j in range(D):
        mask = (rows < j).to(H.dtype)
        c = H[..., :, j] - torch.matmul(L, (d * L[..., j, :] * mask)[..., None])[..., 0]
        dj = c[..., j : j + 1]
        col = torch.where(rows > j, c / dj, torch.where(rows == j, torch.ones_like(c), torch.zeros_like(c)))
        L = torch.where(rows == j, col[..., :, None], L)
        d = torch.where(rows == j, dj, d)
    return L, d


def _reduced_system(Hcc, U):
    """S = blockdiag(Hcc) - U, U (C, 6, C, 6), as (6C, 6C), factored."""
    C = Hcc.shape[0]
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)
    S = (torch.einsum("cd,cab->cadb", eyeC, Hcc) - U).reshape(6 * C, 6 * C)
    L, d = _ldlt_masked(S[None])
    return L[0], d[0]


def make_ba_schur_preconditioner_sparse(n_cameras: int, n_landmarks: int, obs_cl, uv, weights=None,
                                        anchor_weight: float = 100.0):
    """Sparse-visibility exact Schur preconditioner: the reduced camera
    system S = H_cc - W H_ll^-1 W^T without W as (C, L, 6, 3); every term a
    scatter-add over the K observations, the Schur correction one over the
    per-landmark observation pairs (enumerated on the host from
    ``obs_cl``; duplicate (c, l) observations sum exactly). Memory O(K) +
    O(sum_l k_l^2) + the dense (6C)^2 system."""
    scene = _Scene(n_cameras, obs_cl, uv, weights)
    obs = np.asarray(obs_cl, dtype=np.int64)
    C, L = n_cameras, n_landmarks
    by_lmk: dict = {}
    for k, (_, l) in enumerate(obs):
        by_lmk.setdefault(int(l), []).append(k)
    pa = [a for ks in by_lmk.values() for a in ks for _ in ks]
    pb = [b for ks in by_lmk.values() for _ in ks for b in ks]
    pairs_host = dict(a=torch.as_tensor(np.asarray(pa, np.int64)), b=torch.as_tensor(np.asarray(pb, np.int64)),
                      cc=torch.as_tensor(obs[pa, 0] * C + obs[pb, 0]))
    pairs = {}

    def prec_fn(x, lam):
        if x.device not in pairs:
            pairs[x.device] = {k: v.to(x.device) for k, v in pairs_host.items()}
        p = pairs[x.device]
        s, Jc, Jl, Hcc, Hll = _blocks(scene, x, lam, C, L, anchor_weight)
        Wk = torch.einsum("koa,kob->kab", Jc, Jl)  # (K, 6, 3)
        hll_fact, _ = ldlt_factorize(Hll)
        # Y_k = W_k Hll_{l(k)}^-1: each row of W_k through its landmark's 3x3 solve.
        Lk, dk = hll_fact[0][s["lmk"]], hll_fact[1][s["lmk"]]
        Yk = ldlt_solve((Lk[:, None], dk[:, None]), Wk)
        Scontrib = torch.einsum("pax,pbx->pab", Yk[p["a"]], Wk[p["b"]])
        Soff = torch.zeros((C * C, 6, 6), dtype=x.dtype, device=x.device).index_add(0, p["cc"], Scontrib)
        S_fact = _reduced_system(Hcc, Soff.reshape(C, C, 6, 6).permute(0, 2, 1, 3))

        def coupling_c(yl):
            return torch.zeros((C, 6), dtype=x.dtype, device=x.device).index_add(
                0, s["cam"], torch.einsum("kab,kb->ka", Wk, yl[s["lmk"]]))

        def coupling_l(zc):
            return torch.zeros((L, 3), dtype=x.dtype, device=x.device).index_add(
                0, s["lmk"], torch.einsum("kab,ka->kb", Wk, zc[s["cam"]]))

        return _schur_apply(C, L, hll_fact, S_fact, coupling_c, coupling_l)

    return prec_fn


def make_ba_schur_preconditioner(n_cameras: int, n_landmarks: int, obs_cl, uv, weights=None,
                                 anchor_weight: float = 100.0):
    """Exact Gauss-Newton preconditioner through the Schur complement: the
    per-landmark 3x3 blocks H_ll eliminated in closed form, the coupling W
    materialized as (C, L, 6, 3), the dense reduced camera system S = H_cc -
    W H_ll^-1 W^T (6C x 6C) factored; ``apply`` solves (J^T J + lam I) z =
    r exactly by back-substitution, so CG needs about one trip (2 is
    enough). Memory O(C L) blocks. Both Schur preconditioners build from
    the plain reprojection Jacobians (a robustified problem only slows CG)."""
    scene = _Scene(n_cameras, obs_cl, uv, weights)
    obs = np.asarray(obs_cl, dtype=np.int64)
    C, L = n_cameras, n_landmarks
    pair_host = torch.as_tensor(obs[:, 0] * n_landmarks + obs[:, 1])
    pair = {}

    def prec_fn(x, lam):
        if x.device not in pair:
            pair[x.device] = pair_host.to(x.device)
        _, Jc, Jl, Hcc, Hll = _blocks(scene, x, lam, C, L, anchor_weight)
        W = torch.zeros((C * L, 6, 3), dtype=x.dtype, device=x.device).index_add(
            0, pair[x.device], torch.einsum("koa,kob->kab", Jc, Jl)).reshape(C, L, 6, 3)
        hll_fact, _ = ldlt_factorize(Hll)
        # W[c, l] Hll[l]^-1, row by row through landmark l's 3x3 solve.
        Winv = ldlt_solve((hll_fact[0][None, :, None], hll_fact[1][None, :, None]), W)
        S_fact = _reduced_system(Hcc, torch.einsum("clax,mlex->came", Winv, W))
        return _schur_apply(C, L, hll_fact, S_fact,
                            lambda yl: torch.einsum("clab,lb->ca", W, yl),
                            lambda zc: torch.einsum("clab,ca->lb", W, zc))

    return prec_fn


def make_synthetic_scene(
    n_cameras: int,
    n_landmarks: int,
    seed: int = 0,
    pixel_noise: float = 1e-3,
    outlier_fraction: float = 0.0,
    dtype=torch.float64,
    cameras_per_landmark: Optional[int] = None,
    device=None,
):
    """Synthetic ring-of-cameras scene: cameras on a circle of radius 4 in
    the z = 0 plane looking at the origin, landmarks in the unit cube, every
    camera seeing every landmark unless ``cameras_per_landmark`` limits each
    landmark to a window of consecutive ring cameras. The JAX package's
    generator in float64 numpy (its quaternion log and the clean
    reprojections included), so the same seed gives the same arrays.
    Returns (obs_cl (K, 2) numpy, uv (K, 2), x_true (6C + 3L,), scale_ref),
    uv and x_true tensors of ``dtype`` on ``device``."""
    from ..convert import _resolve_device

    rng = np.random.default_rng(seed)
    cams = np.zeros((n_cameras, 6))
    for c in range(n_cameras):
        ang = 2.0 * np.pi * c / n_cameras
        t = np.array([4.0 * np.cos(ang), 4.0 * np.sin(ang), 0.0])
        z = -t / np.linalg.norm(t)
        up = np.array([0.0, 0.0, 1.0])
        xaxis = np.cross(up, z)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(z, xaxis)
        R = np.stack([xaxis, yaxis, z], axis=1)  # camera-to-world columns
        # Shepperd's method: branch on the largest of (trace, R00, R11, R22).
        tr = np.trace(R)
        if tr > max(R[0, 0], R[1, 1], R[2, 2]):
            s4 = 2.0 * np.sqrt(tr + 1.0)
            q = np.array([s4 / 4.0, (R[2, 1] - R[1, 2]) / s4, (R[0, 2] - R[2, 0]) / s4, (R[1, 0] - R[0, 1]) / s4])
        else:
            i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
            j, k = (i + 1) % 3, (i + 2) % 3
            s4 = 2.0 * np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12))
            q = np.zeros(4)
            q[0] = (R[k, j] - R[j, k]) / s4
            q[1 + i] = s4 / 4.0
            q[1 + j] = (R[j, i] + R[i, j]) / s4
            q[1 + k] = (R[k, i] + R[i, k]) / s4
        q /= np.linalg.norm(q)
        cams[c, 0:3] = t
        cams[c, 3:6] = _np_quat_log(q)
    lmks = rng.uniform(-1.0, 1.0, (n_landmarks, 3))
    x_true = np.concatenate([cams.reshape(-1), lmks.reshape(-1)])
    obs_cl = np.stack(np.meshgrid(np.arange(n_cameras), np.arange(n_landmarks), indexing="ij"), axis=-1).reshape(-1, 2)
    if cameras_per_landmark is not None:
        c_all, l_all = obs_cl[:, 0], obs_cl[:, 1]
        start = (l_all * n_cameras) // n_landmarks
        keep = ((c_all - start) % n_cameras) < cameras_per_landmark
        obs_cl = obs_cl[keep]
    idx = _obs_indices(n_cameras, obs_cl)
    uv_clean = _np_reprojection(x_true[idx])
    uv = uv_clean + rng.normal(0.0, pixel_noise, uv_clean.shape)
    if outlier_fraction > 0.0:
        k = int(outlier_fraction * uv.shape[0])
        sel = rng.choice(uv.shape[0], size=k, replace=False)
        uv[sel] += rng.uniform(-0.5, 0.5, (k, 2))
    scale_ref = float(np.linalg.norm(cams[1, 0:3] - cams[0, 0:3]))
    dev = _resolve_device(device)
    return (obs_cl, torch.as_tensor(uv, dtype=dtype, device=dev), torch.as_tensor(x_true, dtype=dtype, device=dev),
            scale_ref)


def _np_quat_log(q):
    """``utils/so3.quat_log`` of one quaternion, in float64 numpy."""
    q = -q if q[0] < 0 else q
    w = min(max(q[0], -1.0), 1.0)
    v = q[1:4]
    vn_sq = np.sum(v * v)
    vn = np.sqrt(max(vn_sq, np.finfo(np.float64).tiny))
    angle = 2.0 * np.arctan2(vn, w)
    scale = 2.0 / w if vn_sq < 1e-24 else angle / vn
    return scale * v


def _np_reprojection(xl):
    """The clean reprojections (K, 2) of rows xl (K, 9) = (t_c, w_c, X):
    ``_reprojection_residual`` at (u, v) = 0, weight 1, in float64 numpy."""
    t_c, w_c, X = xl[:, 0:3], xl[:, 3:6], xl[:, 6:9]
    theta_sq = np.sum(w_c * w_c, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta_sq, np.finfo(np.float64).tiny))
    small = theta_sq < 1e-16
    half = 0.5 * theta
    k = np.where(small, 0.5 - theta_sq / 48.0, np.sin(half) / np.where(small, 1.0, theta))
    q = np.concatenate([np.cos(half), k * w_c], axis=-1)
    wq, u = q[:, 0:1], -q[:, 1:4]  # the conjugate
    v = X - t_c
    uv = np.cross(u, v)
    p = v + 2.0 * (wq * uv + np.cross(u, uv))
    d = p[:, 2:3]
    d_safe = np.where(np.abs(d) < 1e-6, np.where(d < 0, -1e-6, 1e-6), d)
    return 1.0 * (p[:, 0:2] / d_safe - 0.0)
