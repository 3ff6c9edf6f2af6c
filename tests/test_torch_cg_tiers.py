"""The port's matrix-free CG path (``nls_solve(qp_solver="cg")``,
``ops/tree_prec.py``, the large pose-graph and bundle-adjustment modules)
and the emitter's per-variable retract, without JAX, on the CPU in float64
unless a case says otherwise (tests/test_torch_cg.py holds the same code
against the JAX package). Cheap cases, a fraction of a second each.

Tolerances:

* ``_pcg`` at 4n trips against ``torch.linalg.solve`` of the assembled
  damped J^T J (condition numbers below 1e3): 1e-9 relative.
* ``_affine_scan`` (the log-depth recursion) against the sequential
  recurrence, and the tree factor + apply against a dense solve of the
  assembled block-tridiagonal matrix: 1e-10 relative (the recursion
  multiplies the A's in another order; diagonally dominant blocks keep it
  well conditioned).
* The tree preconditioner on a pure chain is the exact inverse of the
  damped Gauss-Newton Hessian: one CG trip solves, 1e-8 relative.
* The sparse Schur apply equals the dense one to 1e-10, and both the exact
  solve of J^T J + lam I (with the gauge prior's diagonal part) to 1e-7
  relative.
* ``quat_from_matrix`` round trips to 1e-12 (1e-5 in float32).
* Instance generators against checksums of their float64 arrays: 1e-12
  relative (the sums' own rounding).
* The emitter's per-variable retract programs reproduce the family's plain
  retract bit for bit in both types.
* The ``cuda`` cases hold the generated kernel 2 instance with a retract to
  its plain version bit for bit, and the CG path on the card against the
  CPU in float64 to 1e-9; they skip without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges, circle_graph, helix_graph
from mini_opt_tpu_torch.models import bundle_adjustment as ba
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.models import pose_graph3 as pg3
from mini_opt_tpu_torch.models.ik import scalar_planar_ik_builder
from mini_opt_tpu_torch.nonlinear import NLSParams, Problem, _box_bounds, _pcg, nls_solve
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_emit
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import tree_prec as tp
from mini_opt_tpu_torch.qp import Var
from mini_opt_tpu_torch.residual import make_residual
from mini_opt_tpu_torch.utils import so3

F64 = torch.float64


def _rel(a, b):
    return float((a - b).abs().max()) / (1.0 + float(b.abs().max()))


# ---------------------------------------------------------------------------
# PCG and the CG step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_pcg_solves_the_damped_normal_equations(n, jacobi):
    rng = np.random.default_rng(n)
    J = torch.as_tensor(rng.normal(size=(2 * n + 3, n)))
    b = torch.as_tensor(rng.normal(size=n))
    lam = 0.1
    H = J.T @ J + lam * torch.eye(n, dtype=F64)
    diag = torch.diagonal(H) if jacobi else torch.ones(n, dtype=F64)
    x = _pcg(lambda v: J.T @ (J @ v) + lam * v, b, lambda r: r / diag, 4 * n)
    assert _rel(x, torch.linalg.solve(H, b)) < 1e-9


def test_pcg_stays_put_at_exact_convergence():
    """The guards keep alpha and beta finite once the residual is zero."""
    x = _pcg(lambda v: 2.0 * v, torch.zeros(4, dtype=F64), lambda r: r, 7)
    assert torch.equal(x, torch.zeros(4, dtype=F64))


def _box_problem(box=0.2, tensor_bounds=False):
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(0, 1.0, (12, 6)))
    b = torch.as_tensor(rng.normal(0, 1.5, 12))
    lo = torch.tensor(-box, dtype=F64) if tensor_bounds else -box
    hi = torch.tensor(box, dtype=F64) if tensor_bounds else box
    ineq = tuple(c for i in range(6) for c in (Var(i) >= lo, Var(i) <= hi))
    return Problem(dimension=6, costs=(make_residual(list(range(6)), lambda p: A @ p - b, 12),),
                   inequality_constraints=ineq), A, b


@pytest.mark.parametrize("tensor_bounds", [False, True], ids=["numbers", "tensors"])
def test_box_bounds_host_and_tensor_paths_agree(tensor_bounds):
    prob, _, _ = _box_problem(tensor_bounds=tensor_bounds)
    lo, hi = _box_bounds(prob, F64, torch.device("cpu"))
    assert torch.equal(lo, torch.full((6,), -0.2, dtype=F64)) and torch.equal(hi, torch.full((6,), 0.2, dtype=F64))


def test_bounded_cg_is_feasible_and_projected_stationary():
    prob, A, b = _box_problem()
    params = NLSParams(max_iterations=30, max_qp_iterations=1, absolute_exit_tol=1e-14, relative_exit_tol=1e-12,
                       qp_solver="cg", cg_iterations=30)
    res = nls_solve(prob, params, torch.zeros((2, 6), dtype=F64))
    x = res.x[0]
    assert (x.abs() <= 0.2 + 1e-12).all() and (res.solver_variant == 2).all()
    g = A.T @ (A @ x - b)
    pg_ = torch.where((x >= 0.2 - 1e-10) & (g < 0), 0.0, torch.where((x <= -0.2 + 1e-10) & (g > 0), 0.0, g))
    assert float(pg_.abs().max()) < 1e-6
    assert torch.equal(res.x[0], res.x[1])  # two lanes, one problem


def test_equality_cg_lands_on_the_constraint():
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.normal(size=(14, 8)))
    b = torch.as_tensor(rng.normal(size=14))
    C = torch.as_tensor(rng.normal(size=(2, 8)))
    d = torch.as_tensor(rng.normal(size=2))
    prob = Problem(dimension=8, costs=(make_residual(list(range(8)), lambda p: A @ p - b, 14),),
                   equality_constraints=(make_residual(list(range(8)), lambda p: C @ p - d, 2),))
    params = NLSParams(max_iterations=10, max_qp_iterations=1, absolute_exit_tol=1e-14, relative_exit_tol=1e-12,
                       qp_solver="cg", cg_iterations=20)
    x = nls_solve(prob, params, torch.zeros((1, 8), dtype=F64)).x[0]
    assert float((C @ x - d).abs().max()) < 1e-9
    # The KKT system of the equality-constrained least squares.
    K = torch.zeros((10, 10), dtype=F64)
    K[:8, :8], K[:8, 8:], K[8:, :8] = A.T @ A, C.T, C
    sol = torch.linalg.solve(K, torch.cat([A.T @ b, d]))
    assert _rel(x, sol[:8]) < 1e-8


# ---------------------------------------------------------------------------
# The tree preconditioner.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 6])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 7, 8, 16, 33, 100])
def test_affine_scan_matches_the_sequential_recurrence(N, d):
    rng = np.random.default_rng(N * 10 + d)
    A = torch.as_tensor(rng.normal(0, 0.4 / np.sqrt(d), (N, d, d)))
    b = torch.as_tensor(rng.normal(size=(N, d)))
    x, want = torch.zeros(d, dtype=F64), []
    for i in range(N):
        x = (A[i] @ x if i else torch.zeros(d, dtype=F64)) + b[i]
        want.append(x)
    assert _rel(tp._affine_scan(A, b), torch.stack(want)) < 1e-10


def _block_tridiag(N, d, seed):
    rng = np.random.default_rng(seed)
    Hu = torch.as_tensor(rng.normal(0, 0.3, (max(N - 1, 0), d, d)))
    M = torch.as_tensor(rng.normal(size=(N, d, d)))
    Hd = M @ M.transpose(1, 2) + 3.0 * d * torch.eye(d, dtype=F64)
    H = torch.zeros((N * d, N * d), dtype=F64)
    for i in range(N):
        H[i * d:(i + 1) * d, i * d:(i + 1) * d] = Hd[i]
        if i + 1 < N:
            H[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = Hu[i]
            H[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = Hu[i].T
    return Hd, Hu, H


@pytest.mark.parametrize("d", [2, 3, 6, 9])
@pytest.mark.parametrize("N", [1, 2, 7, 30])
def test_block_tridiag_factor_and_apply_solve_the_matrix(N, d):
    Hd, Hu, H = _block_tridiag(N, d, seed=N + d)
    fact = tp.block_tridiag_factor(Hd, Hu)
    assert bool(fact.ok)
    r = torch.as_tensor(np.random.default_rng(1).normal(size=(N, d)))
    assert _rel(tp.block_tridiag_apply(fact, r).reshape(-1), torch.linalg.solve(H, r.reshape(-1))) < 1e-10


def test_block_tridiag_factor_flags_an_indefinite_block():
    Hd, Hu, _ = _block_tridiag(4, 3, seed=2)
    Hd = torch.cat([Hd[:2], (-Hd[2])[None], Hd[3:]])
    assert not bool(tp.block_tridiag_factor(Hd, Hu).ok)


CHAIN_ORDERS = {
    "consecutive": ([(0, 1), (1, 2), (2, 3), (3, 0)], 4, [0, 1, 2, 3]),
    "permuted path": ([(2, 0), (0, 3), (3, 1)], 4, [1, 3, 0, 2]),
    "branching": ([(0, 1), (1, 2), (1, 3), (3, 4)], 5, [0, 1, 2, 3, 4]),
    "two components": ([(0, 2), (1, 3)], 4, [0, 2, 1, 3]),
    "self loop and duplicate": ([(1, 1), (0, 2), (2, 0), (2, 1)], 3, [0, 2, 1]),
}


@pytest.mark.parametrize("case", list(CHAIN_ORDERS))
def test_spanning_chain_order(case):
    pairs, n, want = CHAIN_ORDERS[case]
    got = tp.spanning_chain_order(np.asarray(pairs), n)
    assert got.tolist() == want and sorted(got.tolist()) == list(range(n))


def _gn_hessian(problem, x, lam):
    """The damped Gauss-Newton Hessian J^T J + lam I, assembled densely."""
    from mini_opt_tpu_torch.nonlinear import _stacked_residual

    J = torch.func.jacfwd(lambda v: _stacked_residual(problem, v))(x)
    return J.T @ J + lam * torch.eye(x.shape[0], dtype=x.dtype)


@pytest.mark.parametrize("family", ["se2", "se3"])
@pytest.mark.parametrize("N", [5, 17])
def test_tree_preconditioner_is_exact_on_a_pure_chain(family, N):
    """No closure: the tree Hessian is the whole Gauss-Newton Hessian (the
    anchor block and the damping included), so one CG trip solves."""
    edges = np.asarray([(i, i + 1) for i in range(N - 1)])
    rng = np.random.default_rng(N)
    d = 3 if family == "se2" else 6
    meas = torch.as_tensor(rng.normal(0, 0.3, (N - 1, d)))
    w = torch.ones(N - 1, dtype=F64)
    x = torch.as_tensor(rng.normal(0, 0.3, N * d))
    lam = torch.tensor(1e-3, dtype=F64)
    if family == "se2":
        problem = pg.make_pose_graph_problem(N, edges, meas, w)
        prec = pg.make_tree_preconditioner(N, edges, meas, w)
    else:
        problem = pg3.make_pose_graph3_problem(N, edges, meas, w)
        prec = pg3.make_tree_preconditioner3(N, edges, meas, w)
    H = _gn_hessian(problem, x, lam) + 1e-12 * torch.eye(N * d, dtype=F64)
    b = torch.as_tensor(rng.normal(size=N * d))
    apply = prec(x, lam)
    assert _rel(apply(b), torch.linalg.solve(H, b)) < 1e-8
    assert _rel(_pcg(lambda v: H @ v, b, apply, 1), torch.linalg.solve(H, b)) < 1e-8


def test_tree_order_follows_a_relabeled_chain():
    """A chain whose poses are labeled out of order: the factory finds the
    chain (spanning_chain_order) and is exact again."""
    N, perm = 6, np.asarray([3, 0, 5, 1, 4, 2])
    edges = np.asarray([(perm[i], perm[i + 1]) for i in range(N - 1)])
    rng = np.random.default_rng(9)
    meas = torch.as_tensor(rng.normal(0, 0.3, (N - 1, 3)))
    w = torch.ones(N - 1, dtype=F64)
    x = torch.as_tensor(rng.normal(0, 0.3, 3 * N))
    lam = torch.tensor(1e-3, dtype=F64)
    H = _gn_hessian(pg.make_pose_graph_problem(N, edges, meas, w), x, lam) + 1e-12 * torch.eye(3 * N, dtype=F64)
    b = torch.as_tensor(rng.normal(size=3 * N))
    got = pg.make_tree_preconditioner(N, edges, meas, w)(x, lam)(b)
    assert _rel(got, torch.linalg.solve(H, b)) < 1e-8


# ---------------------------------------------------------------------------
# Bundle adjustment's preconditioners.
# ---------------------------------------------------------------------------


def _scene(C=4, L=12, k=None):
    obs, uv, xt, sref = ba.make_synthetic_scene(C, L, seed=2, cameras_per_landmark=k, device="cpu")
    x = xt + torch.as_tensor(np.random.default_rng(3).normal(0, 0.01, xt.shape[0]))
    return obs, uv, x, sref


def _ba_hessian(C, L, obs, uv, x, sref, lam):
    """J^T J of the observations, the gauge prior's diagonal part as the
    preconditioners carry it (camera 0's pose rows and t_1), damped."""
    problem = ba.make_ba_problem(C, L, obs, uv, scale_ref=sref, anchor_ref=x[:6])
    block = dataclasses.replace(problem, costs=problem.costs[:1])
    H = _gn_hessian(block, x, lam) + 1e-12 * torch.eye(x.shape[0], dtype=F64)
    prior = torch.zeros(x.shape[0], dtype=F64)
    prior[:9] = 100.0 ** 2
    return H + torch.diag(prior)


@pytest.mark.parametrize("k", [None, 2], ids=["dense visibility", "k=2"])
def test_schur_preconditioners_are_the_exact_inverse(k):
    C, L = 4, 12
    obs, uv, x, sref = _scene(C, L, k)
    lam = torch.tensor(1e-3, dtype=F64)
    r = torch.as_tensor(np.random.default_rng(5).normal(size=x.shape[0]))
    dense = ba.make_ba_schur_preconditioner(C, L, obs, uv)(x, lam)(r)
    sparse = ba.make_ba_schur_preconditioner_sparse(C, L, obs, uv)(x, lam)(r)
    assert _rel(sparse, dense) < 1e-10
    assert _rel(dense, torch.linalg.solve(_ba_hessian(C, L, obs, uv, x, sref, lam), r)) < 1e-7


def test_block_preconditioner_inverts_the_diagonal_blocks():
    C, L = 4, 12
    obs, uv, x, sref = _scene(C, L)
    lam = torch.tensor(1e-3, dtype=F64)
    H = _ba_hessian(C, L, obs, uv, x, sref, lam)
    mask = torch.zeros_like(H)
    for c in range(C):
        mask[6 * c:6 * c + 6, 6 * c:6 * c + 6] = 1
    for l in range(L):
        s = 6 * C + 3 * l
        mask[s:s + 3, s:s + 3] = 1
    r = torch.as_tensor(np.random.default_rng(6).normal(size=x.shape[0]))
    got = ba.make_ba_block_preconditioner(C, L, obs, uv)(x, lam)(r)
    assert _rel(got, torch.linalg.solve(H * mask, r)) < 1e-9


def test_jacobi_preconditioner_is_the_diagonal():
    C, L = 3, 5
    obs, uv, x, sref = _scene(C, L)
    H = _ba_hessian(C, L, obs, uv, x, sref, torch.tensor(0.0, dtype=F64))
    got = ba.make_ba_jacobi_preconditioner(C, obs, uv)(x)
    assert _rel(got, torch.diagonal(H)) < 1e-9


def test_ldlt_factorize_any_past_24_columns():
    from mini_opt_tpu_torch.models.bundle_adjustment import _ldlt_masked
    from mini_opt_tpu_torch.ops.kkt import ldlt_factorize, ldlt_solve

    rng = np.random.default_rng(7)
    M = torch.as_tensor(rng.normal(size=(2, 40, 40)))
    H = M @ M.transpose(1, 2) + 40 * torch.eye(40, dtype=F64)
    L, d = _ldlt_masked(H)
    (L2, d2), _ = ldlt_factorize(H)
    assert torch.isfinite(L).all() and (d > 0).all() and _rel(L, L2) < 1e-12 and _rel(d, d2) < 1e-12
    rhs = torch.as_tensor(rng.normal(size=(2, 40)))
    assert _rel(ldlt_solve((L, d), rhs), torch.linalg.solve(H, rhs)) < 1e-10
    small = H[:, :24, :24]
    assert all(torch.equal(a, b) for a, b in zip(_ldlt_masked(small), ldlt_factorize(small)[0]))


# ---------------------------------------------------------------------------
# SO(3), the SE(3) projection and the instances.
# ---------------------------------------------------------------------------


QUAT_CASES = {
    "random": lambda: torch.as_tensor(np.random.default_rng(0).normal(0, 1.2, (64, 3))),
    "half turns": lambda: torch.tensor([[np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi],
                                        [np.pi / np.sqrt(2), np.pi / np.sqrt(2), 0]], dtype=F64),
    "identity and tiny": lambda: torch.tensor([[0.0, 0, 0], [1e-9, -2e-9, 0]], dtype=F64),
}


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(QUAT_CASES))
def test_quat_from_matrix_round_trips(case, dtype):
    w = QUAT_CASES[case]().to(dtype)
    R = so3.quat_to_matrix(so3.quat_exp(w))
    q = so3.quat_from_matrix(R)
    assert q.dtype == dtype and (q[:, 0] >= 0).all()
    tol = 1e-12 if dtype == F64 else 1e-5
    assert float((so3.quat_to_matrix(q) - R).abs().max()) < tol
    assert float((q.norm(dim=-1) - 1).abs().max()) < tol


def test_projection_to_so3_fixes_a_reflection():
    R = so3.quat_to_matrix(so3.quat_exp(torch.tensor([0.3, -0.2, 0.5], dtype=F64)))
    reflection = R @ torch.diag(torch.tensor([1.0, 1.0, -1.0], dtype=F64))
    assert float(torch.linalg.det(reflection)) < 0
    P = pg3._project_to_so3(torch.stack([reflection, 2.0 * R]))
    assert torch.allclose(torch.linalg.det(P), torch.ones(2, dtype=F64), atol=1e-12)
    assert float((P[1] - R).abs().max()) < 1e-12  # a scaled rotation projects to itself
    assert float((P[0] @ P[0].T - torch.eye(3, dtype=F64)).abs().max()) < 1e-12


INSTANCE_SUMS = {
    # (generator, args): (sum of meas, sum of x0), float64 on this generator.
    "circle 1200": (lambda: circle_graph(1200, seed=1, noise=0.01, loop_every=10), (1318, 138.9685592174218,
                                                                                     23722.303936057957)),
    "circle 10000": (lambda: circle_graph(10000, seed=7, noise=0.01, loop_every=10), (10998, 136.3263079621311,
                                                                                       57711.349641952685)),
    "helix 400": (lambda: helix_graph(400, seed=4, noise=0.01, loop_every=10), (438, 125.46504018783212,
                                                                                3270.2318728947457)),
}


@pytest.mark.parametrize("case", list(INSTANCE_SUMS))
def test_graph_generators_against_checksums(case):
    make, (E, meas_sum, x0_sum) = INSTANCE_SUMS[case]
    gt, edges, meas, x0 = make()
    assert edges.shape == (E, 2) and meas.shape[0] == E and x0.shape == gt.shape
    assert abs(meas.sum() - meas_sum) < 1e-12 * abs(meas_sum) + 1e-12
    assert abs(x0.sum() - x0_sum) < 1e-12 * abs(x0_sum)


@pytest.mark.parametrize("case", ["dense 16x2048", "sparse 64x8192 k=4"])
def test_synthetic_scene_against_checksums(case):
    if case.startswith("dense"):
        obs, uv, xt, s = ba.make_synthetic_scene(16, 2048, device="cpu")
        want = (-47.52953148968999, 2.382179206158998, 1.5607225761290262)
    else:
        obs, uv, xt, s = ba.make_synthetic_scene(64, 8192, cameras_per_landmark=4, device="cpu")
        want = (47.344255564113354, 146.59019091678263, 0.3925413946193441)
    assert obs.shape == (32768, 2) and uv.dtype == F64
    for got, w in zip((float(uv.sum()), float(xt.sum()), s), want):
        assert abs(got - w) < 1e-12 * (1 + abs(w))


# ---------------------------------------------------------------------------
# The emitter's per-variable retract (ROADMAP item 16a).
# ---------------------------------------------------------------------------


def _planar_family(n, retract):
    return port.family_from_problem(scalar_planar_ik_builder(n, 0.4), 2, retract=retract)


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [33, 48])
def test_per_variable_retract_reproduces_the_plain_retract(n, dtype):
    fam = _planar_family(n, lambda th: [fik._mod_pi(t) for t in th])
    progs = fam.cuda_program.blocked_retract(dtype)
    assert len(progs) == n and len(set(progs)) == 1  # every joint wraps alike
    th = torch.linspace(-20.0, 20.0, 1021, dtype=dtype)
    th = torch.cat([th, torch.tensor([np.nan, np.inf, -np.pi, np.pi], dtype=dtype)])
    for i in (0, n - 1):
        (got,) = fused_emit.run_program(progs[i], [th])
        assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(fik._mod_pi(th), nan=7.0))


def test_retract_that_mixes_variables_is_refused():
    fam = _planar_family(33, lambda th: [th[0]] + [fik._mod_pi(t + th[0]) for t in th[1:]])
    with pytest.raises(fused_emit.UnsupportedOp, match="output 1 reads variable 0"):
        fam.cuda_program.blocked_retract(torch.float64)


def test_retract_that_reads_a_value_is_refused():
    fam = _planar_family(33, lambda th: [t if bool((t > 0).all()) else -t for t in th])
    with pytest.raises(fused_emit.UnsupportedOp):
        fam.cuda_program.blocked_retract(torch.float64)


# ---------------------------------------------------------------------------
# Types, devices and argument checks of the new entry points.
# ---------------------------------------------------------------------------


F32_PATHS = {
    "pose graph jacobi": lambda g: pg.solve_pose_graph_large(
        g[0], g[1], g[2], g[3], torch.as_tensor(g[4].ravel(), dtype=torch.float32),
        params=pg.default_pose_graph_params(max_iterations=2), cg_iterations=5).x,
    "pose graph tree": lambda g: pg.solve_pose_graph_large(
        g[0], g[1], g[2], g[3], torch.as_tensor(g[4].ravel(), dtype=torch.float32),
        params=pg.default_pose_graph_params(max_iterations=2), cg_iterations=5, preconditioner="tree").x,
    "pose graph hard anchor": lambda g: pg.solve_pose_graph_large(
        g[0], g[1], g[2], g[3], torch.as_tensor(g[4].ravel(), dtype=torch.float32),
        params=pg.default_pose_graph_params(max_iterations=2), cg_iterations=5, hard_anchor=True).x,
    "chordal": lambda g: pg.chordal_initialization(
        g[0], g[1], torch.as_tensor(g[2], dtype=torch.float32), g[3], cg_iterations=5),
    "chordal tree": lambda g: pg.chordal_initialization(
        g[0], g[1], torch.as_tensor(g[2], dtype=torch.float32), g[3], cg_iterations=5, preconditioner="tree"),
}


@pytest.fixture(scope="module")
def small_graph():
    gt, edges, meas, x0 = circle_graph(12, seed=1, noise=0.02, loop_every=4)
    return 12, edges, meas, np.ones(len(edges)), x0


@pytest.mark.parametrize("path", list(F32_PATHS))
def test_float32_in_float32_out_se2(small_graph, path):
    x = F32_PATHS[path](small_graph)
    assert x.dtype == torch.float32 and x.shape == (36,) and torch.isfinite(x).all()


@pytest.fixture(scope="module")
def small_helix():
    gt, edges, meas, x0 = helix_graph(10, seed=4, noise=0.01, loop_every=4)
    return 10, edges, meas, np.ones(len(edges)), x0


@pytest.mark.parametrize("kw", [dict(), dict(preconditioner="tree"), dict(hard_anchor=True)],
                         ids=["jacobi", "tree", "hard anchor"])
def test_float32_in_float32_out_se3(small_helix, kw):
    n, edges, meas, w, x0 = small_helix
    x = pg3.solve_pose_graph3_large(n, edges, meas, w, torch.as_tensor(x0.ravel(), dtype=torch.float32),
                                    params=pg3.default_pose_graph3_params(max_iterations=2), cg_iterations=5,
                                    **kw).x
    assert x.dtype == torch.float32 and x.shape == (60,) and torch.isfinite(x).all()


@pytest.mark.parametrize("pre", ["none", "tree"])
def test_float32_chordal3(small_helix, pre):
    n, edges, meas, w, _ = small_helix
    x = pg3.chordal_initialization3(n, edges, torch.as_tensor(meas, dtype=torch.float32), w, cg_iterations=5,
                                    preconditioner=pre)
    assert x.dtype == torch.float32 and x.shape == (60,) and torch.isfinite(x).all()


BA_F32 = ["jacobi", "dense", "schur", "schur_sparse", "block"]


@pytest.mark.parametrize("route", BA_F32)
def test_float32_in_float32_out_bundle_adjustment(route):
    C, L = 3, 6
    obs, uv, xt, sref = ba.make_synthetic_scene(C, L, seed=1, dtype=torch.float32, device="cpu")
    x0 = xt + 0.01
    params = ba.default_ba_params(max_iterations=2)
    if route == "jacobi":
        res = ba.solve_bundle_adjustment_large(C, L, obs, uv, x0, scale_ref=sref, params=params, cg_iterations=4)
    elif route == "dense":
        res = ba.solve_bundle_adjustment(C, L, obs, uv, x0, scale_ref=sref, params=params)
    else:
        make = {"schur": ba.make_ba_schur_preconditioner, "schur_sparse": ba.make_ba_schur_preconditioner_sparse,
                "block": ba.make_ba_block_preconditioner}[route]
        prob = ba.make_ba_problem(C, L, obs, uv, scale_ref=sref, anchor_ref=x0[:6])
        res = nls_solve(prob, dataclasses.replace(params, qp_solver="cg", cg_iterations=2), x0[None],
                        retraction=ba.make_ba_retraction(C), cg_preconditioner=make(C, L, obs, uv))
    assert res.x.dtype == torch.float32 and res.errors.f.dtype == torch.float32
    assert torch.isfinite(res.x).all()


def test_solve_pose_graph_large_takes_a_batch_of_starts(small_graph):
    n, edges, meas, w, x0 = small_graph
    x = torch.as_tensor(np.stack([x0.ravel(), x0.ravel() + 0.01]))
    p = pg.default_pose_graph_params(max_iterations=2)
    res = pg.solve_pose_graph_large(n, edges, meas, w, x, params=p, cg_iterations=5)
    one = pg.solve_pose_graph_large(n, edges, meas, w, x[1], params=p, cg_iterations=5)
    assert res.x.shape == (2, 36) and one.x.shape == (36,)
    assert _rel(res.x[1], one.x) < 1e-12


ARG_CHECKS = {
    "tree with hard anchor": lambda g: pg.solve_pose_graph_large(*g[:4], g[4].ravel(), preconditioner="tree",
                                                                 hard_anchor=True, device="cpu"),
    "unknown preconditioner": lambda g: pg.solve_pose_graph_large(*g[:4], g[4].ravel(), preconditioner="ichol",
                                                                  device="cpu"),
    "se3 tree with hard anchor": lambda g: pg3.solve_pose_graph3_large(
        2, [(0, 1)], np.zeros((1, 6)), np.ones(1), np.zeros(12), preconditioner="tree", hard_anchor=True,
        device="cpu"),
    "ba with two starts": lambda g: ba.solve_bundle_adjustment_large(
        2, 2, [(0, 0), (1, 1)], np.zeros((2, 2)), np.zeros((2, 18)), device="cpu"),
}


@pytest.mark.parametrize("case", list(ARG_CHECKS))
def test_argument_checks(small_graph, case):
    with pytest.raises(ValueError):
        ARG_CHECKS[case](small_graph)


def test_distributed_tree_preconditioner_names_item_9():
    with pytest.raises(NotImplementedError, match="item 9"):
        tp.make_chain_tree_preconditioner(pg._edge_residual, np.zeros((1, 6), np.int64), np.zeros((1, 6)), 2, 3,
                                          axis_name="mp")


NUMPY_ENTRY_POINTS = {
    "solve_pose_graph_large": lambda g: pg.solve_pose_graph_large(*g[:4], g[4].ravel()),
    "chordal_initialization": lambda g: pg.chordal_initialization(*g[:4]),
    "make_synthetic_scene": lambda g: ba.make_synthetic_scene(2, 3),
}


@pytest.mark.parametrize("entry", list(NUMPY_ENTRY_POINTS))
def test_numpy_inputs_without_a_card_raise(monkeypatch, small_graph, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NUMPY_ENTRY_POINTS[entry](small_graph)


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 2 has no CPU mode, and the CG path's card run is the point")


def _heading_wrap_family():
    edges = chain_edges(11, ((2, 8),))
    return port.family_from_problem(
        pg.scalar_pose_graph_builder(11, edges), 3 * len(edges),
        retract=lambda th: [pg._wrap(t) if k % 3 == 2 else t for k, t in enumerate(th)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
def test_generated_kernel_2_with_a_retract_bit_identical_on_card(needs_cuda, dtype):
    fam = _heading_wrap_family()
    data, x0 = chain_closure_instances(8192 + 13, 11, ((2, 8),), seed=3)
    data[5, 0] = np.nan
    d = torch.as_tensor(data, dtype=dtype, device="cuda")
    x = torch.as_tensor(x0, dtype=dtype, device="cuda")
    args = (fam, d.T, x.T, 5, 1, 2, "armijo", "mpc")
    before = blk.GENERATED_LAUNCHES
    got = blk._blocked_solve_cuda(*args)
    torch.cuda.synchronize()
    assert blk.GENERATED_LAUNCHES == before + 1
    want = blk._blocked_solve_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))


@pytest.mark.cuda
def test_cg_path_on_card_matches_the_cpu(needs_cuda, small_graph):
    n, edges, meas, w, x0 = small_graph
    p = pg.default_pose_graph_params(max_iterations=3)
    on_card = pg.solve_pose_graph_large(n, edges, meas, w, x0.ravel(), params=p, cg_iterations=20,
                                        preconditioner="tree", device="cuda")
    on_cpu = pg.solve_pose_graph_large(n, edges, meas, w, x0.ravel(), params=p, cg_iterations=20,
                                       preconditioner="tree", device="cpu")
    assert on_card.x.is_cuda and _rel(on_card.x.cpu(), on_cpu.x) < 1e-9
