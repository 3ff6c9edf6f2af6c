"""The PyTorch port's general path held against its own references and
against dense linear algebra, on the CPU. No JAX compile: every case costs a
fraction of a second to about a second (tests/test_torch_general.py holds
the same code against the JAX package).

* The plain LDL^T factor and solve (kernels 4 and 5) against
  ``numpy.linalg.solve`` on well-conditioned quasi-definite KKT systems
  (condition numbers below 100), D = 1 to 40: 1e-12 relative in float64,
  1e-5 in float32; every ``ops/kkt.py`` backend against
  ``torch.linalg.solve``.
* The plain fused QP (kernel 6) against the port's own ``qp_ip_solve`` at
  ``early_exit=False`` and ``kkt_solver="ldlt"``, the reference semantics
  of pallas_qp.py:294-335, at N = 2..8 with both barriers, on IK-shaped
  QPs (one equality row, both bounds on variables 1..N-1). The two assemble
  and factor in different orders, so they agree to rounding, not bit for
  bit: within 1e-8 (1 + |x|), 4.7e-9 the largest gap seen. Complementarity
  runs 6 iterations. Mehrotra runs 1: from the second iteration on the two
  JAX schedules differ by design (pallas_qp.py:157-163 takes mu_aff from
  the complementarity at the probe point, qp.py:405-413 from the loop's mu,
  which is sigma times the last complementarity), so only the first
  iteration, where both are 1, is comparable. ROADMAP.md queue 3 records
  where the fused schedule stalls.
* The slice's main path, ``solve_ik_batch`` at planar n = 2, 10/6/2, on
  both inner-QP routes: every lane at its target in float64 and float32;
  lanes solved together equal single-lane calls; a NaN-target lane leaves
  the other lanes unchanged; ``early_exit`` changes no result.
* The checks: every option that is not ported yet raises
  NotImplementedError, and NLSParams keeps the JAX package's assertions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import effector_error, planar_instances
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.ops import kkt as kkt_ops
from mini_opt_tpu_torch.ops import ldlt
from mini_opt_tpu_torch.qp import QP, QPInteriorPointParams, qp_ip_solve
from mini_opt_tpu_torch.structs import BarrierStrategy, InitialGuessMethod


def _kkt(rng, Bk, D):
    """Quasi-definite condensed systems [[G, A^T], [A, 0]] with G = A A^T / n
    + I and K = D // 6 equality rows."""
    K = D // 6
    N = D - K
    A = rng.normal(size=(Bk, N, N))
    H = np.zeros((Bk, D, D))
    H[:, :N, :N] = A @ A.transpose(0, 2, 1) / N + np.eye(N)
    H[:, N:, :N] = rng.normal(size=(Bk, K, N))
    H[:, :N, N:] = H[:, N:, :N].transpose(0, 2, 1)
    return H


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("D", list(range(1, 41)))
def test_plain_ldlt_solves_like_numpy(D, dtype):
    rng = np.random.default_rng(D)
    H = _kkt(rng, 6, D)
    rhs = rng.normal(size=(6, D))
    want = np.linalg.solve(H, rhs[..., None])[..., 0]
    H_t, r_t = torch.as_tensor(H, dtype=dtype), torch.as_tensor(rhs, dtype=dtype)
    L, d, ok = ldlt._batched_factorize(H_t)
    assert bool(ok.all())
    assert torch.equal(torch.diagonal(L, dim1=1, dim2=2), torch.ones(6, D, dtype=dtype))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    x = ldlt._batched_solve(L, d, r_t)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = np.abs(want).max() + 1.0
    assert np.abs(x.double().numpy() - want).max() <= tol * scale


@pytest.mark.parametrize("solver", ["pallas_ldlt", "ldlt", "ldlt_ir", "lu", "auto"])
def test_kkt_backends_agree(solver):
    """Every ops/kkt.py backend solves the same systems; "pallas_ldlt"
    through the dispatch is ops/ldlt.py's plain pair exactly."""
    rng = np.random.default_rng(7)
    H = torch.as_tensor(_kkt(rng, 6, 12))
    rhs = torch.as_tensor(rng.normal(size=(6, 12)))
    fact, ok = kkt_ops.kkt_factorize(H, solver)
    x = kkt_ops.kkt_solve(fact, rhs, solver)
    assert bool(ok.all())
    torch.testing.assert_close(x, torch.linalg.solve(H, rhs), rtol=1e-10, atol=1e-10)
    if solver == "pallas_ldlt":
        L, d, _ = ldlt._batched_factorize(H)
        assert torch.equal(x, ldlt._batched_solve(L, d, rhs))


def _ik_qps(rng, Bq, N):
    """B QPs shaped like the IK linearization: G = J^T J + lam I, one
    equality row, [0, pi]-style bounds on variables 1..N-1."""
    J = rng.normal(size=(Bq, 1, N))
    G = J.transpose(0, 2, 1) @ J + 1e-3 * np.eye(N)
    c = rng.normal(size=(Bq, N)) * 0.3
    A = rng.normal(size=(Bq, 1, N))
    b = rng.normal(size=(Bq, 1)) * 0.1
    var = tuple(v for i in range(1, N) for v in (i, i))
    ia = np.tile([1.0, -1.0] * (N - 1), (Bq, 1))
    x_lin = rng.uniform(0.2, 2.9, size=(Bq, N))
    ib = np.where(ia > 0, x_lin[:, list(var)], np.pi - x_lin[:, list(var)])
    return [torch.as_tensor(a) for a in (G, c, A, b, ia, ib)], var


@pytest.mark.parametrize("barrier", ["complementarity", "mpc"])
@pytest.mark.parametrize("N", [2, 3, 4, 5, 6, 7, 8])
def test_plain_fused_qp_matches_qp_ip_solve(N, barrier):
    rng = np.random.default_rng(100 + N)
    (G, c, A, b, ia, ib), var = _ik_qps(rng, 24, N)
    iterations = 6 if barrier == "complementarity" else 1
    x, y = fq._fused_qp_batch(
        G, c, A, b, ia, ib, ineq_var=var, iterations=iterations, sigma=0.1, barrier=barrier,
        has_eq_guess=True,
    )
    qp = QP(G, c, A, b, torch.tensor(var), ia, ib)
    params = QPInteriorPointParams(
        max_iterations=iterations, sigma=0.1, termination_kkt_tol=1e-300, termination_complementarity_tol=1e-300,
        barrier_strategy=(
            BarrierStrategy.PREDICTOR_CORRECTOR if barrier == "mpc" else BarrierStrategy.COMPLEMENTARITY
        ),
        initial_guess_method=InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED,
        kkt_solver="ldlt", record_history=False, early_exit=False,
    )
    ref = qp_ip_solve(qp, params)
    assert bool((ref.num_iterations == iterations).all())
    torch.testing.assert_close(x, ref.x, rtol=1e-8, atol=1e-8)
    torch.testing.assert_close(y, ref.y, rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# The main path on the CPU.
# ---------------------------------------------------------------------------

ROUTES = {
    "pallas_ldlt": dict(kkt_solver="pallas_ldlt"),
    "pallas_fused": dict(qp_solver="pallas_fused"),
}


def _params(route, dtype):
    return dataclasses.replace(
        port.default_ik_params(dtype, max_iterations=10, max_qp_iterations=6),
        max_line_search_iterations=2, record_history=False, early_exit=False, **ROUTES[route],
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_main_path_reaches_every_target(route, dtype):
    targets, x0 = planar_instances(16, 2, seed=3)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    res = port.solve_ik_batch(
        targets.astype(np_dtype), x0.astype(np_dtype), params=_params(route, dtype), device="cpu"
    )
    assert res.x.shape == (16, 2) and res.x.dtype == dtype
    assert (effector_error("planar", res.x.numpy(), targets) < 1e-3).all()
    assert bool(port.termination_state_indicates_satisfied_tol(res.termination_state).all())
    assert bool((res.x[:, 1] >= -1e-6).all()) and bool((res.x[:, 1] <= np.pi).all())


@pytest.mark.parametrize("route", list(ROUTES))
def test_lanes_are_independent(route):
    """Lanes solved together equal single-lane calls (the first and the
    last lane of four); a NaN target fails only its own lane."""
    targets, x0 = planar_instances(4, 2, seed=5)
    params = _params(route, torch.float64)
    whole = port.solve_ik_batch(targets, x0, params=params, device="cpu")
    for b in (0, 3):
        one = port.solve_ik_batch(targets[b : b + 1], x0[b : b + 1], params=params, device="cpu")
        assert torch.equal(one.x[0], whole.x[b])
        assert torch.equal(one.termination_state[0], whole.termination_state[b])
    bad = targets.copy()
    bad[2, 0] = np.nan
    poisoned = port.solve_ik_batch(bad, x0, params=params, device="cpu")
    keep = [0, 1, 3]
    assert torch.equal(poisoned.x[keep], whole.x[keep])
    assert torch.equal(poisoned.termination_state[keep], whole.termination_state[keep])
    assert poisoned.termination_state[2] == port.NLSTerminationState.QP_INDEFINITE


def test_default_entry_point_and_null_space_path():
    """``solve_ik_batch(targets, x0)`` with the default parameters records
    the history (the default ``record_history=True``, ``kkt_solver="lu"``);
    without joint limits the problem has equality constraints only and
    takes the null-space QP (nonlinear.py:962-969)."""
    targets, x0 = planar_instances(6, 3, seed=1)
    res = port.solve_ik_batch(targets, x0, device="cpu")
    assert res.iterations.lam.shape == (6, 12)
    assert res.iterations.qp_iterations.mu.shape == (6, 12, 6)
    assert res.iterations.line_search.alpha.shape == (6, 12, 11)
    assert bool((res.solver_variant == port.QPSolverVariant.INTERIOR_POINT).all())
    ns = port.solve_ik_batch(targets, x0, with_joint_limits=False, device="cpu")
    assert bool((ns.solver_variant == port.QPSolverVariant.NULL_SPACE).all())
    assert ns.iterations.qp_iterations.mu.shape == (6, 12, 0)
    assert int(ns.num_qp_iterations().sum()) == 0
    for r in (res, ns):
        assert (effector_error("planar", r.x.numpy(), targets) < 1e-3).all()
        assert bool(port.termination_state_indicates_satisfied_tol(r.termination_state).all())


def test_early_exit_changes_no_result():
    targets, x0 = planar_instances(8, 2, seed=9)
    params = dataclasses.replace(_params("pallas_ldlt", torch.float64), record_history=True)
    fixed = port.solve_ik_batch(targets, x0, params=params, device="cpu")
    early = port.solve_ik_batch(
        targets, x0, params=dataclasses.replace(params, early_exit=True), device="cpu"
    )
    for a, b in ((fixed.x, early.x), (fixed.termination_state, early.termination_state),
                 (fixed.iterations.lam, early.iterations.lam),
                 (fixed.iterations.qp_iterations.mu, early.iterations.qp_iterations.mu)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Checks.
# ---------------------------------------------------------------------------

NOT_PORTED = {
    # Ported since: the CG path runs; its distributed form is item 9's.
    "cg": (dict(qp_solver="cg"), dict(axis_name="mp"), NotImplementedError, "item 9"),
    "cg_distributed_preconditioner": (
        dict(qp_solver="cg"), dict(distributed_cg_preconditioner=True), NotImplementedError, "item 9"),
    # parallel_line_search, fuse_probe_linearize, log_qp_eigenvalues and
    # exit_callback are ported since (tests/test_torch_general_rest*.py).
    "axis_name": ({}, dict(axis_name="mp"), NotImplementedError, "item 9"),
    # Ported since: the Riccati backend now runs and refuses a condensed
    # system that is not a horizon-4 MPC transcription.
    "riccati": (dict(kkt_solver="riccati:4:2:1"), {}, ValueError, "expects a"),
}


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_unported_options_raise(case):
    fields, kwargs, *expect = NOT_PORTED[case]
    exc, match = expect or (NotImplementedError, "ROADMAP")
    params = port.NLSParams(max_iterations=2, **fields)
    chain = port.make_planar_chain(2, dtype=torch.float64, device="cpu")
    targets, x0 = planar_instances(2, 2)
    with pytest.raises(exc, match=match):
        port.nls_solve(
            lambda t: port.make_ik_problem(chain, t), params, torch.as_tensor(x0),
            data=torch.as_tensor(targets), **kwargs,
        )


def test_params_keep_the_jax_assertions():
    with pytest.raises(AssertionError):
        port.NLSParams(qp_solver="pallas_fused", record_history=True)
    with pytest.raises(AssertionError):
        port.NLSParams(parallel_line_search=True)  # polynomial line search
    with pytest.raises(AssertionError):
        port.NLSParams(qp_initial_guess_method=InitialGuessMethod.USER_PROVIDED)
    with pytest.raises(AssertionError):
        QPInteriorPointParams(kkt_solver="cholesky")


@pytest.mark.parametrize("N, K, M, dtype, refused", [
    (192, 1, 0, torch.float32, "N \\+ K <= 192"),  # D = 193, past the warp route
    (200, 0, 2, torch.float64, "N \\+ K <= 192"),
    (150, 1, 3000, torch.float64, "shared memory"),  # one instance's slab past a CTA
    (191, 1, 4000, torch.float32, "shared memory"),
    (8, 1, 16, torch.float64, None),  # the register route's largest K = 1 instance
    (1, 2, 2, torch.float32, None),  # N = 1 and K = 2 on the register route
    (9, 1, 2, torch.float32, None),  # the warp route from here
    (191, 1, 380, torch.float64, None),  # D = 192 fits one CTA in float64
])
def test_fused_qp_kernel_sizes_are_checked(N, K, M, dtype, refused):
    """The CUDA wrapper refuses sizes the card has no route for, naming the
    limit, before it touches a device; every size within them has a route."""
    if refused is None:
        fq._check_cuda_shape(N, K, M, dtype)
    else:
        with pytest.raises(NotImplementedError, match=refused):
            fq._check_cuda_shape(N, K, M, dtype)
