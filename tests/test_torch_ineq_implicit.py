"""The port's nonlinear inequalities (``ineq.py``), implicit gradients
(``implicit.py`` and the implicit MPC policy) and serving-budget tuner
(``tuning.py``) held against the JAX package on the CPU, in float64, from
identical numpy inputs.

JAX compiles two jitted ``nls_solve`` programs, no more: Rosenbrock on the
unit disk (``tests/test_ineq.py:56``) and the lifted obstacle IK of
``examples/obstacle_ik.py`` at B = 16 (its rows: the targets and the
keep-out centres from the port's base solve). JAX's implicit Jacobians are its own
backward pass (``solve_bwd``) taken at a given solution: the test hands
``make_implicit_solver``'s forward solve that solution (it replaces
``mini_opt_tpu.implicit.nls_solve`` by one that returns ``x0``), so the
``jacrev`` programs compile no solver loop. The port's forward solutions are
held to closed forms (the joint-limit IK fleet of
``tests/test_implicit.py:149``: the pinned elbow, or the target reached, as
``tests/test_torch_general.py`` holds that problem's forward solve against
JAX's); each port VJP (one
backward pass, random weights per lane) against ``w^T J`` of JAX's
``jacrev`` per instance. The implicit obstacle case writes the arm's
forward kinematics out in both packages (tracing JAX's backward through the
chains takes longer than the rest of the file). ``mpc_feedback_gain`` is
held to the LQR oracle, not to JAX's gain, whose backward at T = 10 also
traces longer than the file's budget.

Tolerances: x within 1e-8, termination states equal, gradients within 1e-7
relative (|d| <= 1e-7 (1 + |ref|)), tuner traces equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu.implicit as jimplicit
from mini_opt_tpu import make_residual as jresidual
from mini_opt_tpu import tuning as jtuning
from mini_opt_tpu.ineq import with_nonlinear_inequalities as jlift
from mini_opt_tpu.models import ik as jik
from mini_opt_tpu.models import mpc as jmpc
from mini_opt_tpu.nonlinear import NLSParams as JParams
from mini_opt_tpu.nonlinear import Problem as JProblem
from mini_opt_tpu.nonlinear import nls_solve as jsolve
from mini_opt_tpu.structs import InitialGuessMethod as JGuess

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch import instances as inst
from mini_opt_tpu_torch import tuning
from mini_opt_tpu_torch.convert import params_from_dict
from mini_opt_tpu_torch.models import ik as pik
from mini_opt_tpu_torch.models import mpc as pmpc

X_TOL = 1e-8
G_TOL = 1e-7
F64 = torch.float64


def _params(jp):
    return params_from_dict(dataclasses.asdict(jp))


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * (1.0 + np.abs(want))), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# Nonlinear inequalities through nls_solve.
# ---------------------------------------------------------------------------

ROSEN_PARAMS = JParams(
    max_iterations=40, max_qp_iterations=10, max_line_search_iterations=5,
    termination_kkt_tolerance=1.0e-9, absolute_first_derivative_tol=1.0e-9,
    qp_initial_guess_method=JGuess.NAIVE,
)


def test_rosenbrock_on_unit_disk_matches_jax():
    """min rosenbrock s.t. ||x||^2 <= 1 (tests/test_ineq.py:56): the port
    handed the wrapper against JAX's solve of its augmented problem."""

    def j_rosen(xy):
        return jnp.stack([1.0 - xy[0], 10.0 * (xy[1] - xy[0] * xy[0])])

    jaug = jlift(JProblem(dimension=2, costs=(jresidual((0, 1), j_rosen, dim=2),)),
                 (jresidual((0, 1), lambda v: jnp.array([1.0 - v @ v]), dim=1),))
    jx0 = jaug.initial_guess(jnp.array([0.5, -0.5]))
    jres = jax.jit(lambda x: jsolve(jaug.problem, ROSEN_PARAMS, x))(jx0)

    def p_rosen(xy):
        return torch.stack([1.0 - xy[0], 10.0 * (xy[1] - xy[0] * xy[0])])

    paug = port.with_nonlinear_inequalities(
        port.Problem(dimension=2, costs=(port.make_residual((0, 1), p_rosen, 2),)),
        (port.make_residual((0, 1), lambda v: torch.stack([1.0 - v @ v]), 1),))
    px0 = paug.initial_guess(torch.tensor([[0.5, -0.5]], dtype=F64))
    np.testing.assert_array_equal(px0[0].numpy(), np.asarray(jx0))
    pres = port.nls_solve(paug, _params(ROSEN_PARAMS), px0)
    np.testing.assert_allclose(pres.x[0].numpy(), np.asarray(jres.x), atol=X_TOL, rtol=0)
    assert int(pres.termination_state[0]) == int(jres.termination_state)
    np.testing.assert_allclose(paug.extract(pres.x)[0].numpy(), [0.78641516, 0.61769831], atol=2e-5)


OBSTACLE_B = 16


@pytest.fixture(scope="module")
def obstacle_rows():
    """Targets near the example's and each lane's keep-out centre on the
    elbow of its base solve, from the port (float64, CPU)."""
    targets = torch.as_tensor(inst.obstacle_ik_targets(OBSTACLE_B, seed=0))
    x_ref = torch.as_tensor(inst.OBSTACLE_X_REF, dtype=F64).expand(OBSTACLE_B, 3)
    base = port.nls_solve(inst.obstacle_ik_base_problem, inst.obstacle_ik_params(), x_ref,
                          retraction=pik.mod_pi_retraction, data=targets)
    return inst.obstacle_ik_rows(targets, base.x).numpy()


_JCHAINS = {}


def _jchains():
    if not _JCHAINS:
        _JCHAINS["arm"] = jik.make_planar_chain(n_active=3, link_length=0.4, dtype=jnp.float64)
        _JCHAINS["elbow"] = jik.make_planar_chain(n_active=2, link_length=0.4, dtype=jnp.float64)
    return _JCHAINS["arm"], _JCHAINS["elbow"]


def _j_obstacle(row):
    """examples/obstacle_ik.py's lifted problem of one row in the JAX
    package (the proximal base, the keep-out on the row's centre)."""
    arm, elbow = _jchains()
    x_ref = jnp.asarray(inst.OBSTACLE_X_REF)
    base = jik.make_ik_problem(arm, row[:2], with_joint_limits=False)
    prox = jresidual((0, 1, 2), lambda p: 0.05 * (p - x_ref), 3)
    reg = JProblem(dimension=3, costs=base.costs + (prox,), equality_constraints=base.equality_constraints)
    centre = row[2:4]

    def keep_out(p2):
        d = elbow.update(p2).translation[:2] - centre
        return jnp.stack([d @ d - inst.OBSTACLE_RADIUS ** 2])

    return jlift(reg, (jresidual((0, 1), keep_out, 1),))


def test_obstacle_fleet_matches_jax(obstacle_rows):
    """The lifted obstacle IK at B = 16: the port's per-lane wrapper function
    against JAX's vmap of nls_solve on the wrapper, x, slacks, termination
    state and iteration count."""
    rows = obstacle_rows
    jp = JParams(max_iterations=60, max_qp_iterations=10, max_line_search_iterations=5, relative_exit_tol=0.0,
                 qp_initial_guess_method=JGuess.NAIVE)
    x_ref = jnp.asarray(inst.OBSTACLE_X_REF)
    jx0 = jax.vmap(lambda r: _j_obstacle(r).initial_guess(x_ref))(jnp.asarray(rows))
    jres = jax.jit(jax.vmap(lambda r, x: jsolve(_j_obstacle(r), jp, x, retraction=jik.mod_pi_retraction)))(
        jnp.asarray(rows), jx0)
    prow = torch.as_tensor(rows)
    px0 = torch.func.vmap(lambda r, x: inst.obstacle_ik_problem(r).initial_guess(x))(
        prow, torch.as_tensor(inst.OBSTACLE_X_REF, dtype=F64).expand(OBSTACLE_B, 3))
    np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), atol=1e-15, rtol=0)
    pres = port.nls_solve(inst.obstacle_ik_problem, _params(jp), px0, retraction=pik.mod_pi_retraction, data=prow)
    np.testing.assert_allclose(pres.x.numpy(), np.asarray(jres.x), atol=X_TOL, rtol=0)
    np.testing.assert_array_equal(pres.termination_state.numpy(), np.asarray(jres.termination_state))
    np.testing.assert_array_equal(pres.num_iterations.numpy(), np.asarray(jres.num_iterations))
    checks, g = inst.obstacle_ik_checks(pres.x.numpy(), rows)
    assert all(c.all() for c in checks) and (np.abs(g) < 1e-6).all()  # every keep-out binds


# ---------------------------------------------------------------------------
# Implicit gradients: the port's backward against JAX's at the same solution.
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_backward_only(monkeypatch):
    """JAX's make_implicit_solver with its forward solve replaced: the
    solution is what the caller passes as x0, so jacrev runs JAX's backward
    (solve_bwd) at that solution and compiles no solver loop."""
    monkeypatch.setattr(jimplicit, "nls_solve", lambda problem, params, x0, retraction=None: types.SimpleNamespace(x=x0))
    return jimplicit.make_implicit_solver


def _jac_at(make, problem_fn, jp, data, x_star, **kw):
    """JAX's Jacobian dx*/ddata of each instance at its solution x_star (one
    jitted jacrev of one instance, traced once: under vmap JAX traces the
    backward about twice as long)."""
    jac = jax.jit(jax.jacrev(make(problem_fn, jp, **kw)))
    return np.stack([np.asarray(jac(jnp.asarray(d), jnp.asarray(x))) for d, x in zip(data, x_star)])


def _port_vjp(problem_fn, params, data, x0, seed, **kw):
    """The port's solution and one backward pass with random weights w:
    (x*, w, w^T dx*/ddata per lane)."""
    solve = port.make_implicit_solver(problem_fn, params, **kw)
    d = torch.as_tensor(data).requires_grad_(True)
    x = solve(d, torch.as_tensor(x0))
    w = torch.as_tensor(np.random.default_rng(seed).normal(size=tuple(x.shape)))
    (vjp,) = torch.autograd.grad(x, d, grad_outputs=w)
    return x.detach().numpy(), w.numpy(), vjp.numpy()


PARAMS_IMPLICIT = JParams(max_iterations=20, max_qp_iterations=1, absolute_exit_tol=1e-14)


def _case_unconstrained():
    def jfn(t):
        return JProblem(dimension=2, costs=(jresidual([0, 1], lambda v: v - t, 2),))

    def pfn(t):
        return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda v: v - t, 2),))

    data = np.random.default_rng(1).uniform(-1, 1, (4, 2))
    return jfn, pfn, PARAMS_IMPLICIT, data, np.zeros((4, 2)), data, {}


def _case_equality():
    def jfn(v):
        return JProblem(dimension=2, costs=(jresidual([0, 1], lambda x: x, 2),), equality_constraints=(
            jresidual([0, 1], lambda x: jnp.stack([x[0] * x[1] - v[0]]), 1),))

    def pfn(v):
        return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda x: x, 2),), equality_constraints=(
            port.make_residual([0, 1], lambda x: torch.stack([x[0] * x[1] - v[0]]), 1),))

    v = np.array([[4.0], [2.25], [1.0], [6.0]])
    jp = dataclasses.replace(PARAMS_IMPLICIT, max_iterations=60, lambda_initial=1e-3)
    return jfn, pfn, jp, v, np.tile([1.5, 2.5], (4, 1)), np.sqrt(v) * np.ones((1, 2)), {}


LIMIT = 1.2


def _limit_params():
    return dataclasses.replace(jik.default_ik_params(jnp.float64, max_iterations=25, max_qp_iterations=10),
                               absolute_exit_tol=1e-14, termination_kkt_tolerance=1e-10)


def _case_ik_limit():
    jchain = jik.make_planar_chain(n_active=2, dtype=jnp.float64)
    pchain = port.make_planar_chain(2, dtype=F64)

    def jfn(t):
        return jik.make_ik_problem(jchain, t, with_joint_limits=True, joint_limit=LIMIT)

    def pfn(t):
        return pik.make_ik_problem(pchain, t, with_joint_limits=True, joint_limit=LIMIT)

    # tests/test_implicit.py:149's target first (the elbow pinned), then
    # farther ones (free).
    targets = np.array([[0.35, 0.25], [0.30, 0.30], [0.70, 0.20], [0.55, 0.45]])
    x0 = np.tile([0.7, 1.1], (4, 1))
    return jfn, pfn, _limit_params(), targets, x0, None, dict(
        retraction=(jik.mod_pi_retraction, pik.mod_pi_retraction), active_tol=1e-6)


def _obstacle_closed_form(lib, row):
    """examples/obstacle_ik.py's problem of one row, its planar forward
    kinematics written out (phi = cumsum(theta), p = 0.4 sum (cos phi, sin
    phi)) in either package: ``lib`` is (numpy-like module, Problem,
    make_residual, stack, lift). The chains' quaternion kinematics give the
    same positions; written out, JAX traces its backward many times faster
    than through the chains."""
    xp, problem, residual, stack, lift = lib
    x_ref = xp.asarray(inst.OBSTACLE_X_REF) if xp is jnp else torch.as_tensor(inst.OBSTACLE_X_REF, dtype=F64)

    def fk(p):
        phi = xp.cumsum(p, 0)
        return 0.4 * stack([xp.cos(phi).sum(), xp.sin(phi).sum()])

    def keep_out(p2):
        d = fk(p2) - row[2:4]
        return stack([d @ d - inst.OBSTACLE_RADIUS ** 2])

    base = problem(
        dimension=3,
        costs=(residual((0, 1, 2), lambda p: stack([fk(p)[1] - row[1]]), 1),
               residual((0, 1, 2), lambda p: 0.05 * (p - x_ref), 3)),
        equality_constraints=(residual((0, 1, 2), lambda p: stack([fk(p)[0] - row[0]]), 1),),
    )
    return lift(base, (residual((0, 1), keep_out, 1),))


JLIB = (jnp, JProblem, jresidual, jnp.stack, jlift)
PLIB = (torch, port.Problem, port.make_residual, torch.stack, port.with_nonlinear_inequalities)


def _case_obstacle(rows):
    """tests/test_implicit.py:260 on four rows (gradients with respect to the
    target and the keep-out centre): the implicit solver on the augmented
    Problem with the wrapper's params and lifted retraction."""
    jaug = _obstacle_closed_form(JLIB, jnp.asarray(rows[0]))
    paug = _obstacle_closed_form(PLIB, torch.as_tensor(rows[0]))
    jp = jaug.params(JParams(max_iterations=60, max_qp_iterations=10, max_line_search_iterations=5,
                             absolute_exit_tol=1e-14, relative_exit_tol=0.0, termination_kkt_tolerance=1e-10))
    x0 = np.concatenate([np.tile(inst.OBSTACLE_X_REF, (4, 1)), np.full((4, 1), 1e-2)], 1)
    return (lambda row: _obstacle_closed_form(JLIB, row).problem,
            lambda row: _obstacle_closed_form(PLIB, row).problem, jp, rows[:4], x0, None,
            dict(retraction=(jaug.wrap_retraction(jik.mod_pi_retraction),
                             paug.wrap_retraction(pik.mod_pi_retraction)), active_tol=1e-5))


@pytest.mark.parametrize("case", ["unconstrained", "equality", "ik_joint_limit", "obstacle_lifted"])
def test_implicit_vjp_matches_jax(case, jax_backward_only, obstacle_rows):
    """tests/test_implicit.py:17, :59, :149, :260: the port's VJP through
    make_implicit_solver against w^T of JAX's jacrev per instance."""
    make = {"unconstrained": _case_unconstrained, "equality": _case_equality, "ik_joint_limit": _case_ik_limit,
            "obstacle_lifted": lambda: _case_obstacle(obstacle_rows)}[case]
    jfn, pfn, jp, data, x0, want_x, kw = make()
    retraction = kw.pop("retraction", (None, None))
    x, w, vjp = _port_vjp(pfn, _params(jp), data, x0, seed=7, retraction=retraction[1], **kw)
    if want_x is not None:
        np.testing.assert_allclose(x, want_x, atol=X_TOL, rtol=0)
    J = _jac_at(jax_backward_only, jfn, jp, data, x, retraction=retraction[0], **kw)
    _close_rel(vjp, np.einsum("bi,bij->bj", w, J), G_TOL)
    if case == "ik_joint_limit":
        # Lanes 0-1 pin the elbow (their pinned row is 0); lanes 2-3 reach the target.
        assert (np.abs(x[:2, 1] - LIMIT) < 1e-6).all() and np.abs(J[:2, 1]).max() < 1e-4
        assert (inst.effector_error("planar", x[2:], data[2:]) < 1e-5).all() and (x[2:, 1] < LIMIT - 1e-3).all()
    if case == "obstacle_lifted":
        checks, g = inst.obstacle_ik_checks(x, data)
        assert (np.abs(g) < 1e-6).all() and np.abs(J[:, :3]).max() > 1e-3  # bound, non-degenerate


def test_mpc_feedback_gain_against_the_lqr_oracle():
    """mpc_feedback_gain at T = 10: at the upright equilibrium it equals -K_0
    of the JAX package's finite-horizon LQR oracle (tests/test_mpc.py:154-162's
    gate), and the port's oracle equals JAX's. JAX's own gain is not run: its
    jacrev of the T = 10 backward traces longer than this file's budget.
    One backward pass gives both states' gains."""
    T, dt = 10, 0.05
    states = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.05, -0.02, 0.03, 0.01]], dtype=F64)
    gains = pmpc.mpc_feedback_gain(pmpc.CartPole(), states, T, dt).numpy()
    K0 = np.asarray(jmpc.finite_horizon_lqr_gain(jmpc.CartPole(), T, dt))[0]
    np.testing.assert_allclose(pmpc.finite_horizon_lqr_gain(pmpc.CartPole(), T, dt)[0].numpy(), K0, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gains[0], -K0, rtol=1e-6, atol=1e-8)
    assert np.abs(gains[1] - gains[0]).max() > 1e-4  # off the equilibrium the gain moves


# ---------------------------------------------------------------------------
# The tuner: the same search on the same synthetic lattice.
# ---------------------------------------------------------------------------


def _lattice(min_ok, frac_stuck=0.0):
    def solve(outer, qp, ls):
        base = np.zeros((40, 3))
        base[: int(40 * frac_stuck)] = 5.0
        if not (outer >= min_ok[0] and qp >= min_ok[1] and ls >= min_ok[2]):
            base[int(40 * frac_stuck):] += 0.5 + 0.1 * outer
        return base

    return solve


@pytest.mark.parametrize("min_ok,max_budget,frac,stuck", [
    ((4, 2, 1), (10, 6, 2), 1.0, 0.0),
    ((1, 1, 0), (8, 4, 2), 1.0, 0.0),
    ((3, 5, 2), (12, 6, 2), 0.9, 0.1),
    ((7, 1, 1), (9, 3, 3), 0.8, 0.1),
])
def test_tuner_matches_jax(min_ok, max_budget, frac, stuck):
    """The port's tune_serving_budget against the JAX package's on the same
    synthetic lattice: budget, trace (order, ok, margins) and evaluations."""
    solve = _lattice(min_ok, stuck)
    want = jtuning.tune_serving_budget(solve, jtuning.parity_gate(1e-6, frac=frac), max_budget=max_budget)
    got = tuning.tune_serving_budget(solve, tuning.parity_gate(1e-6, frac=frac), max_budget=max_budget)
    assert got.budget == want.budget and got.n_evaluations == want.n_evaluations
    assert [(p.budget, p.ok, p.margin) for p in got.trace] == [(p.budget, p.ok, p.margin) for p in want.trace]
    assert tuning.budget_cost(got.budget) == jtuning.budget_cost(want.budget)
