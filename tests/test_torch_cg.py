"""The port's matrix-free CG path against the JAX package's, on the CPU in
float64, from the same numpy inputs (tests/test_torch_cg_tiers.py holds it
without JAX).

* The CG step and whole CG solves on the setups of
  tests/test_cg_bounds.py:37 (a bounded least squares) and
  tests/test_cg_equality.py (a linear and a nonlinear equality, the sphere
  at B = 12 starts): x to 1e-10 (measured 1e-16 and 1.3e-11), iteration
  counts and statuses equal. torch's and JAX's dot products reduce in
  different orders; a converged solve forgets that.
* ``block_tridiag_factor`` + ``block_tridiag_apply`` and ``_affine_scan``
  against JAX's on the same blocks: 1e-12 relative (the port mirrors
  ``lax.associative_scan``'s pairing; the d x d products round alike up to
  BLAS's order), ``spanning_chain_order`` equal.
* ``solve_pose_graph_large`` (Jacobi, tree, hard anchor) on a 48-pose
  circle graph at 4 Gauss-Newton iterations of 30 CG trips: x to 1e-10
  (measured 3e-14), the final cost to 1e-12 relative.
* ``chordal_initialization``: under the tree preconditioner at 40 trips to
  1e-10 (measured 2e-14); unpreconditioned only once converged (300 trips,
  1e-9): without a preconditioner the anchor's 1e4 scale amplifies the two
  reduction orders' last bits about 1e3-fold a trip, so at 40 trips the two
  packages part by 7e-2 while each is right to its own rounding.
* Bundle adjustment at C = 4, L = 32: the dense and sparse Schur, the block
  and the Jacobi preconditioned solves, x to 1e-8 (measured 1e-10: the 3x3
  and 6C x 6C triangular solves round differently from LAPACK's).
* ``make_synthetic_scene``: obs, x_true and scale_ref bit for bit; uv to
  5e-16 in this process, where XLA contracts the reprojection's cross
  products into FMAs, and bit for bit in a JAX subprocess with
  ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no FMA).
* SE(3): ``solve_pose_graph3_large`` under the tree preconditioner on a
  16-pose helix, x to 1e-10; ``quat_from_matrix`` to 1e-15; the port's
  helix generator to 1e-13.
* The emitter's blocked-target retract: the generated planar family with
  ``_mod_pi`` through the port's plain blocked path against JAX's
  ``blocked_solve_batch`` (interpret mode, one compile at D = 13) at B = 24
  with a NaN-target lane: x and the state to 1e-9, the flags equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu as jx
import mini_opt_tpu_torch as port
from mini_opt_tpu.models import bundle_adjustment as jba
from mini_opt_tpu.models import ik as jax_ik
from mini_opt_tpu.models import pose_graph as jpg
from mini_opt_tpu.models import pose_graph3 as jpg3
from mini_opt_tpu.nonlinear import NLSParams as JParams
from mini_opt_tpu.nonlinear import Problem as JProblem
from mini_opt_tpu.nonlinear import _cg_step_direction as jax_cg_step
from mini_opt_tpu.nonlinear import nls_solve as jax_nls_solve
from mini_opt_tpu.ops import pallas_blocked as jax_blocked
from mini_opt_tpu.ops import tree_prec as jtp
from mini_opt_tpu.ops.pallas_ik import _mod_pi as jax_mod_pi
from mini_opt_tpu.utils import so3 as jso3
from mini_opt_tpu_torch.instances import circle_graph, helix_graph, medium_n_planar_instances
from mini_opt_tpu_torch.models import bundle_adjustment as ba
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.models import pose_graph3 as pg3
from mini_opt_tpu_torch.models.ik import scalar_planar_ik_builder
from mini_opt_tpu_torch.nonlinear import _box_bounds, _cg_step_direction
from mini_opt_tpu_torch.ops import tree_prec as tp
from mini_opt_tpu_torch.ops._common import _mod_pi
from mini_opt_tpu_torch.utils import so3

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size == 0:
        return
    err = np.abs(got - want).max() / (1.0 + np.abs(want).max())
    assert err < tol, err


# ---------------------------------------------------------------------------
# The CG step and solves on the JAX package's CG test problems.
# ---------------------------------------------------------------------------


def _bounded(seed=4, n=24, m=40, box=0.2):
    """tests/test_cg_bounds.py:_ls_problem in both packages."""
    rng = np.random.default_rng(seed)
    A, b = rng.normal(0, 1.0, (m, n)), rng.normal(0, 1.5, m)
    jA, jb, tA, tb = jnp.asarray(A), jnp.asarray(b), torch.as_tensor(A), torch.as_tensor(b)
    jprob = JProblem(dimension=n, costs=(jx.make_residual(list(range(n)), lambda p: jA @ p - jb, m),),
                     inequality_constraints=tuple(c for i in range(n) for c in (jx.Var(i) >= -box,
                                                                                  jx.Var(i) <= box)))
    tprob = port.Problem(dimension=n, costs=(port.make_residual(list(range(n)), lambda p: tA @ p - tb, m),),
                         inequality_constraints=tuple(c for i in range(n) for c in (port.Var(i) >= -box,
                                                                                      port.Var(i) <= box)))
    return jprob, tprob


def _equality(seed=3, n=20, m=36, k=4):
    """tests/test_cg_equality.py:test_eq_cg_matches_null_space_on_linear_problem."""
    rng = np.random.default_rng(seed)
    A, b = rng.normal(0, 1.0, (m, n)), rng.normal(0, 1.0, m)
    C, d = rng.normal(0, 1.0, (k, n)), rng.normal(0, 0.5, k)
    j = [jnp.asarray(a) for a in (A, b, C, d)]
    t = [torch.as_tensor(a) for a in (A, b, C, d)]
    jprob = JProblem(dimension=n, costs=(jx.make_residual(list(range(n)), lambda p: j[0] @ p - j[1], m),),
                     equality_constraints=(jx.make_residual(list(range(n)), lambda p: j[2] @ p - j[3], k),))
    tprob = port.Problem(dimension=n, costs=(port.make_residual(list(range(n)), lambda p: t[0] @ p - t[1], m),),
                         equality_constraints=(port.make_residual(list(range(n)), lambda p: t[2] @ p - t[3], k),))
    return jprob, tprob


CG_KW = dict(max_iterations=30, max_qp_iterations=1, absolute_exit_tol=1e-14, relative_exit_tol=1e-12,
             qp_solver="cg", cg_iterations=60)


@pytest.mark.parametrize("kind", ["bounded", "equality"])
def test_cg_step_direction_matches_jax(kind):
    jprob, tprob = _bounded() if kind == "bounded" else _equality()
    n = tprob.dimension
    x = np.random.default_rng(8).uniform(-0.15, 0.15, n)
    lam = 1e-3
    jb = tb = None
    if kind == "bounded":
        jb = tuple(jnp.asarray(v) for v in _box_bounds(tprob, F64, torch.device("cpu")))
        tb = _box_bounds(tprob, F64, torch.device("cpu"))
    jdx, jerr, jder, jl = jax_cg_step(jprob, jnp.asarray(x), jnp.asarray(lam), JParams(**CG_KW), None, None, jb,
                                      None)
    tdx, terr, tder, tl = _cg_step_direction(tprob, torch.as_tensor(x), torch.tensor(lam, dtype=F64),
                                             port.NLSParams(**CG_KW), None, None, tb, None)
    _close(tdx, jdx, 1e-10)
    for a, b in ((terr.f, jerr.f), (terr.equality, jerr.equality), (tder.d_f, jder.d_f),
                 (tder.d_equality, jder.d_equality)):
        _close(a, b, 1e-10)
    assert (tl is None) == (jl is None)
    if tl is not None:
        _close(tl, jl, 1e-8)


@pytest.mark.parametrize("kind", ["bounded", "equality"])
def test_cg_solve_matches_jax(kind):
    jprob, tprob = _bounded() if kind == "bounded" else _equality()
    n = tprob.dimension
    rj = jax.jit(lambda x: jax_nls_solve(jprob, JParams(**CG_KW), x))(jnp.zeros((n,)))
    rt = port.nls_solve(tprob, port.NLSParams(**CG_KW), torch.zeros((1, n), dtype=F64))
    _close(rt.x[0], rj.x, 1e-10)
    _close(rt.errors.f[0], rj.errors.f, 1e-12)
    assert int(rt.num_iterations[0]) == int(rj.num_iterations)
    assert int(rt.termination_state[0]) == int(rj.termination_state)
    assert int(rt.solver_variant[0]) == int(rj.solver_variant) == 2


def test_cg_sphere_constraint_matches_jax_vmap():
    """tests/test_cg_equality.py:test_eq_cg_nonlinear_sphere_constraint:
    the restoration step and the multiplier penalty update, 12 starts."""
    n = 8
    rng = np.random.default_rng(5)
    a = rng.normal(0, 2.0, n)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    jprob = JProblem(dimension=n, costs=(jx.make_residual(list(range(n)), lambda p: p - ja, n),),
                     equality_constraints=(jx.make_residual(list(range(n)),
                                                            lambda p: jnp.stack([jnp.dot(p, p) - 1.0]), 1),))
    tprob = port.Problem(dimension=n, costs=(port.make_residual(list(range(n)), lambda p: p - ta, n),),
                         equality_constraints=(port.make_residual(
                             list(range(n)), lambda p: torch.stack([torch.dot(p, p) - 1.0]), 1),))
    kw = dict(max_iterations=60, max_qp_iterations=1, relative_exit_tol=1e-13, absolute_first_derivative_tol=1e-10,
              qp_solver="cg", cg_iterations=40, lambda_initial=1e-3)
    starts = rng.uniform(-2.0, 2.0, (12, n))
    rj = jax.jit(jax.vmap(lambda x0: jax_nls_solve(jprob, JParams(**kw), x0)))(jnp.asarray(starts))
    rt = port.nls_solve(tprob, port.NLSParams(**kw), torch.as_tensor(starts))
    _close(rt.x, rj.x, 1e-10)
    np.testing.assert_array_equal(rt.num_iterations.numpy(), np.asarray(rj.num_iterations))
    np.testing.assert_array_equal(rt.termination_state.numpy(), np.asarray(rj.termination_state))
    _close(rt.iterations.penalty, rj.iterations.penalty, 1e-10)


# ---------------------------------------------------------------------------
# The tree preconditioner's pieces.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N, d", [(1, 3), (7, 3), (20, 6)])
def test_block_tridiag_matches_jax(N, d):
    rng = np.random.default_rng(N + d)
    M = rng.normal(size=(N, d, d))
    Hd = M @ np.swapaxes(M, 1, 2) + 3.0 * d * np.eye(d)
    Hu = rng.normal(0, 0.3, (N - 1, d, d))
    r = rng.normal(size=(N, d))
    jf = jtp.block_tridiag_factor(jnp.asarray(Hd), jnp.asarray(Hu))
    tf = tp.block_tridiag_factor(torch.as_tensor(Hd), torch.as_tensor(Hu))
    for a, b in zip(tf[:3], jf[:3]):
        _close(a, b, 1e-12)
    assert bool(tf.ok) == bool(jf.ok)
    _close(tp.block_tridiag_apply(tf, torch.as_tensor(r)), jtp.block_tridiag_apply(jf, jnp.asarray(r)), 1e-12)
    A = rng.normal(0, 0.5 / np.sqrt(d), (N, d, d))
    _close(tp._affine_scan(torch.as_tensor(A), torch.as_tensor(r)), jtp._affine_scan(jnp.asarray(A), jnp.asarray(r)),
           1e-12)


@pytest.mark.parametrize("graph", ["circle", "shuffled", "tree"])
def test_spanning_chain_order_matches_jax(graph):
    rng = np.random.default_rng(2)
    _, edges, _, _ = circle_graph(40, seed=1, loop_every=7)
    if graph == "shuffled":
        perm = rng.permutation(40)
        edges = perm[edges]
    elif graph == "tree":
        edges = np.asarray([(i, rng.integers(0, i)) for i in range(1, 40)])
    np.testing.assert_array_equal(tp.spanning_chain_order(edges, 40), jtp.spanning_chain_order(edges, 40))


# ---------------------------------------------------------------------------
# SE(2) large graphs.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def circle48():
    gt, edges, meas, x0 = circle_graph(48, seed=1, noise=0.02, loop_every=10)
    return 48, edges, meas, np.ones(len(edges)), x0


@pytest.mark.parametrize("kw", [dict(preconditioner="jacobi"), dict(preconditioner="tree"), dict(hard_anchor=True)],
                         ids=["jacobi", "tree", "hard_anchor"])
def test_solve_pose_graph_large_matches_jax(circle48, kw):
    n, edges, meas, w, x0 = circle48
    rj = jpg.solve_pose_graph_large(n, edges, jnp.asarray(meas), jnp.asarray(w), jnp.asarray(x0.ravel()),
                                    params=jpg.default_pose_graph_params(max_iterations=4), cg_iterations=30, **kw)
    rt = pg.solve_pose_graph_large(n, edges, meas, w, torch.as_tensor(x0.ravel()),
                                   params=pg.default_pose_graph_params(max_iterations=4), cg_iterations=30, **kw)
    assert rt.x.shape == (3 * n,)
    _close(rt.x, rj.x, 1e-10)
    _close(rt.errors.f, rj.errors.f, 1e-12)
    assert int(rt.num_iterations) == int(rj.num_iterations)
    assert int(rt.termination_state) == int(rj.termination_state)


@pytest.mark.parametrize("pre, trips, tol", [("tree", 40, 1e-10), ("none", 300, 1e-9)])
def test_chordal_initialization_matches_jax(circle48, pre, trips, tol):
    n, edges, meas, w, _ = circle48
    anchor = np.asarray([0.1, -0.2, 0.3])
    xj = jpg.chordal_initialization(n, edges, jnp.asarray(meas), jnp.asarray(w), anchor_pose=jnp.asarray(anchor),
                                    cg_iterations=trips, preconditioner=pre)
    xt = pg.chordal_initialization(n, edges, meas, w, anchor_pose=anchor, cg_iterations=trips,
                                   preconditioner=pre, device="cpu")
    _close(xt, xj, tol)


# ---------------------------------------------------------------------------
# Bundle adjustment.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    C, L = 4, 32
    obs, uv, xt, sref = jba.make_synthetic_scene(C, L, seed=3)
    rng = np.random.default_rng(1)
    x0 = np.asarray(xt).copy()
    x0[6:6 * C] += rng.normal(0, 0.01, 6 * (C - 1))
    x0[6 * C:] += rng.normal(0, 0.03, len(x0) - 6 * C)
    return C, L, obs, np.asarray(uv), x0, sref


@pytest.mark.parametrize("route", ["schur", "schur_sparse", "block", "jacobi"])
def test_bundle_adjustment_large_matches_jax(scene, route):
    C, L, obs, uv, x0, sref = scene
    if route == "jacobi":
        rj = jba.solve_bundle_adjustment_large(C, L, obs, jnp.asarray(uv), jnp.asarray(x0), scale_ref=sref,
                                               params=jba.default_ba_params(max_iterations=5), cg_iterations=20)
        rt = ba.solve_bundle_adjustment_large(C, L, obs, torch.as_tensor(uv), torch.as_tensor(x0), scale_ref=sref,
                                              params=ba.default_ba_params(max_iterations=5), cg_iterations=20)
    else:
        name = {"schur": "make_ba_schur_preconditioner", "schur_sparse": "make_ba_schur_preconditioner_sparse",
                "block": "make_ba_block_preconditioner"}[route]
        jp = dataclasses.replace(jba.default_ba_params(max_iterations=5), qp_solver="cg", cg_iterations=4)
        tpar = dataclasses.replace(ba.default_ba_params(max_iterations=5), qp_solver="cg", cg_iterations=4)
        jprob = jba.make_ba_problem(C, L, obs, jnp.asarray(uv), scale_ref=sref, anchor_ref=jnp.asarray(x0[:6]))
        tprob = ba.make_ba_problem(C, L, obs, torch.as_tensor(uv), scale_ref=sref,
                                   anchor_ref=torch.as_tensor(x0[:6]))
        rj = jax_nls_solve(jprob, jp, jnp.asarray(x0), retraction=jba.make_ba_retraction(C),
                           cg_preconditioner=getattr(jba, name)(C, L, obs, jnp.asarray(uv)))
        rt = port.nls_solve(tprob, tpar, torch.as_tensor(x0)[None], retraction=ba.make_ba_retraction(C),
                            cg_preconditioner=getattr(ba, name)(C, L, obs, torch.as_tensor(uv)))
    _close(rt.x.reshape(-1), rj.x, 1e-8)
    _close(rt.errors.f.reshape(()), rj.errors.f, 1e-8)
    assert int(rt.num_iterations.reshape(())) == int(rj.num_iterations)


@pytest.mark.parametrize("kw", [dict(), dict(cameras_per_landmark=3, outlier_fraction=0.1)],
                         ids=["dense", "sparse outliers"])
def test_synthetic_scene_matches_jax(kw):
    j = jba.make_synthetic_scene(8, 64, seed=3, **kw)
    t = ba.make_synthetic_scene(8, 64, seed=3, device="cpu", **kw)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[3] == j[3]
    assert np.abs(t[1].numpy() - np.asarray(j[1])).max() <= 5e-16


def test_synthetic_scene_bit_for_bit_without_fma(tmp_path):
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); jax.config.update('jax_enable_x64', True)\n"
        "import numpy as np, sys\n"
        "from mini_opt_tpu.models.bundle_adjustment import make_synthetic_scene\n"
        "o, uv, x, s = make_synthetic_scene(16, 2048, seed=0)\n"
        "np.save(sys.argv[1], np.asarray(uv))\n"
    )
    out = tmp_path / "scene_uv.npy"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code, str(out)], cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    want = np.load(out)
    np.testing.assert_array_equal(ba.make_synthetic_scene(16, 2048, seed=0, device="cpu")[1].numpy(), want)


# ---------------------------------------------------------------------------
# SE(3).
# ---------------------------------------------------------------------------


def test_helix_generator_matches_the_jax_tests():
    sys.path.insert(0, str(REPO / "tests"))
    from test_pose_graph3 import _helix_graph

    for a, b in zip(helix_graph(16, seed=4, noise=0.01, loop_every=6), _helix_graph(16, seed=4, noise=0.01,
                                                                                     loop_every=6)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-13


def test_solve_pose_graph3_large_matches_jax():
    """One SE(3) case: the tree preconditioner (6x6 blocks) on a 16-pose
    helix (the hard anchor and the chordal stage run in the tier file)."""
    gt, edges, meas, x0 = helix_graph(16, seed=4, noise=0.01, loop_every=6)
    n, w = 16, np.ones(len(edges))
    rj = jpg3.solve_pose_graph3_large(n, edges, jnp.asarray(meas), jnp.asarray(w), jnp.asarray(x0.ravel()),
                                      params=jpg3.default_pose_graph3_params(max_iterations=3), cg_iterations=20,
                                      preconditioner="tree")
    rt = pg3.solve_pose_graph3_large(n, edges, meas, w, torch.as_tensor(x0.ravel()),
                                     params=pg3.default_pose_graph3_params(max_iterations=3), cg_iterations=20,
                                     preconditioner="tree")
    _close(rt.x, rj.x, 1e-10)
    assert int(rt.num_iterations) == int(rj.num_iterations)


def test_quat_from_matrix_matches_jax():
    w = np.random.default_rng(0).normal(0, 1.5, (64, 3))
    w[:3] = np.pi * np.eye(3)  # half turns: the non-trace branches
    R = np.asarray(jax.vmap(jso3.quat_to_matrix)(jax.vmap(jso3.quat_exp)(jnp.asarray(w))))
    _close(so3.quat_from_matrix(torch.as_tensor(R)), jax.vmap(jso3.quat_from_matrix)(jnp.asarray(R)), 1e-15)


# ---------------------------------------------------------------------------
# The emitter's blocked-target retract: the generated planar family on the
# plain blocked path against JAX's blocked kernel.
# ---------------------------------------------------------------------------


def test_generated_planar_family_with_retract_on_the_blocked_path_matches_jax():
    n, B = 12, 24
    jfam = jx.family_from_problem(jax_ik.scalar_planar_ik_builder(n, 0.4), 2,
                                  retract=lambda th: [jax_mod_pi(t) for t in th])
    tfam = port.family_from_problem(scalar_planar_ik_builder(n, 0.4), 2, retract=lambda th: [_mod_pi(t) for t in th])
    data, x0 = medium_n_planar_instances(B, n, seed=5)
    x0 = x0 + np.where(np.arange(n) % 2, 2 * np.pi, 0.0)  # starts a turn away: the retract's floor
    data[3, 0] = np.nan
    kw = dict(max_iterations=4, qp_iterations=2, ls_iterations=2, barrier="mpc")
    ref = jax_blocked.blocked_solve_batch(jfam, jnp.asarray(data), jnp.asarray(x0), return_state=True, **kw)
    got = port.blocked_solve_batch(tfam, data, x0, return_state=True, device="cpu", **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9, equal_nan=True)
    np.testing.assert_array_equal(got[1][:, 2].numpy(), np.asarray(ref[1])[:, 2])
    assert got[1][3, 2] != 0 and torch.isfinite(got[0][np.arange(B) != 3]).all()
