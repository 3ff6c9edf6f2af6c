"""The port's nonlinear inequalities, implicit gradients and tuner on their
own (no JAX): closed forms of implicit gradients, the slack wrapper's API,
a singular lane in a batch, the transforms the implicit solver refuses, and
the tuner's edge cases (``tests/test_tuning.py:36-93``). The ``cuda`` case
holds the implicit backward on a card against the CPU and skips without one.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch import instances as inst
from mini_opt_tpu_torch import tuning
from mini_opt_tpu_torch.ineq import _slackened
from mini_opt_tpu_torch.models import ik as pik
from mini_opt_tpu_torch.models import mpc as pmpc
from mini_opt_tpu_torch.qp import Var
from mini_opt_tpu_torch.structs import InitialGuessMethod

F64 = torch.float64
PARAMS = port.NLSParams(max_iterations=20, max_qp_iterations=1, absolute_exit_tol=1e-14)


def _jacobian(solve, data, x0):
    """dx*/ddata per lane, (B, n, d), one backward pass per output."""
    d = data.detach().requires_grad_(True)
    x = solve(d, x0)
    rows = [torch.autograd.grad(x[:, i].sum(), d, retain_graph=True)[0] for i in range(x.shape[1])]
    return x.detach(), torch.stack(rows, 1)


# ---------------------------------------------------------------------------
# Closed forms.
# ---------------------------------------------------------------------------


def _target_problem(t):
    return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda v: v - t, 2),))


@pytest.mark.parametrize("B", [1, 3])
def test_unconstrained_gradient_is_identity(B):
    """min ||x - t||^2: x*(t) = t and dx*/dt = I in every lane."""
    t = torch.as_tensor(np.random.default_rng(B).uniform(-1, 1, (B, 2)))
    x, J = _jacobian(port.make_implicit_solver(_target_problem, PARAMS), t, torch.zeros(B, 2, dtype=F64))
    torch.testing.assert_close(x, t, atol=1e-12, rtol=0)
    torch.testing.assert_close(J, torch.eye(2, dtype=F64).expand(B, 2, 2), atol=1e-10, rtol=0)


@pytest.mark.parametrize("w,t", [(2.0, -0.5), (0.5, 1.5), (3.0, 0.0)])
def test_weighted_scalar_closed_form(w, t):
    """tests/test_implicit.py:31: min 0.5 (w (x - 1))^2 + 0.5 (x - t)^2, x* =
    (w^2 + t) / (w^2 + 1), with dx*/dw and dx*/dt in closed form."""

    def problem_fn(d):
        return port.Problem(dimension=1, costs=(
            port.make_residual([0], lambda v: torch.stack([d[0] * (v[0] - 1.0)]), 1),
            port.make_residual([0], lambda v: torch.stack([v[0] - d[1]]), 1)))

    x, J = _jacobian(port.make_implicit_solver(problem_fn, PARAMS), torch.tensor([[w, t]], dtype=F64),
                     torch.zeros(1, 1, dtype=F64))
    assert abs(float(x[0, 0]) - (w * w + t) / (w * w + 1)) < 1e-9
    dx_dw = (2 * w * (w * w + 1) - (w * w + t) * 2 * w) / (w * w + 1) ** 2
    np.testing.assert_allclose(J[0, 0].numpy(), [dx_dw, 1.0 / (w * w + 1)], atol=1e-9)


def _product_problem(v):
    return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda x: x, 2),), equality_constraints=(
        port.make_residual([0, 1], lambda x: torch.stack([x[0] * x[1] - v[0]]), 1),))


def test_sqrt_under_the_equality():
    """min ||x||^2 s.t. x0 x1 = v: x* = (sqrt v, sqrt v), dx*/dv = 1 / (2
    sqrt v) per coordinate, every lane."""
    v = torch.tensor([[4.0], [2.25], [1.0]], dtype=F64)
    solve = port.make_implicit_solver(_product_problem, dataclasses.replace(PARAMS, max_iterations=60,
                                                                            lambda_initial=1e-3))
    x, J = _jacobian(solve, v, torch.tensor([[1.5, 2.5]] * 3, dtype=F64))
    r = torch.sqrt(v)
    torch.testing.assert_close(x, r.expand(3, 2), atol=1e-6, rtol=0)
    torch.testing.assert_close(J[:, :, 0], (0.5 / r).expand(3, 2), atol=1e-5, rtol=0)


def test_active_box_constraint_gradient():
    """tests/test_implicit.py:109: x1 <= 1 active; x0* = t0 + 0.3 (t1 - 1)."""
    Q = torch.tensor([[2.0, 0.6], [0.6, 1.5]], dtype=F64)
    L = torch.linalg.cholesky(Q).T

    def problem_fn(t):
        return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda v: L @ (v - t), 2),),
                            inequality_constraints=(Var(1) <= 1.0,))

    solve = port.make_implicit_solver(problem_fn, dataclasses.replace(PARAMS, max_iterations=30,
                                                                      max_qp_iterations=20), active_tol=1e-5)
    x, J = _jacobian(solve, torch.tensor([[0.3, 1.8]], dtype=F64), torch.zeros(1, 2, dtype=F64))
    np.testing.assert_allclose(x[0].numpy(), [0.3 + 0.3 * 0.8, 1.0], atol=1e-5)
    np.testing.assert_allclose(J[0].numpy(), [[1.0, 0.3], [0.0, 0.0]], atol=1e-5)


def test_tuple_data_and_zero_x0_gradient():
    """Data as a tuple of tensors gets a gradient per leaf; x0 gets zero."""

    def problem_fn(d):
        a, b = d
        return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda v: v - a * b, 2),))

    a = torch.tensor([[1.0, 2.0], [0.5, -1.0]], dtype=F64, requires_grad=True)
    b = torch.tensor([[3.0], [2.0]], dtype=F64, requires_grad=True)
    x0 = torch.zeros(2, 2, dtype=F64, requires_grad=True)
    x = port.make_implicit_solver(problem_fn, PARAMS)((a, b), x0)
    ga, gb, g0 = torch.autograd.grad(x.sum(), (a, b, x0))
    torch.testing.assert_close(ga, b.detach().expand(2, 2), atol=1e-10, rtol=0)
    torch.testing.assert_close(gb, a.detach().sum(1, keepdim=True), atol=1e-10, rtol=0)
    assert not g0.any()


def test_numpy_inputs_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solve = port.make_implicit_solver(_target_problem, PARAMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(np.zeros((2, 2)), np.zeros((2, 2)))
    x = solve(np.ones((2, 2)), np.zeros((2, 2)), device="cpu")
    assert x.device.type == "cpu" and torch.allclose(x, torch.ones(2, 2, dtype=F64))


def test_a_singular_lane_does_not_fail_the_batch():
    """Lane 1's cost has zero weight: its KKT matrix is singular, so its
    gradient is non-finite (as jnp.linalg.solve gives it); the other lanes'
    gradients are those of the batch without it."""

    def problem_fn(d):
        return port.Problem(dimension=1, costs=(port.make_residual([0], lambda v: d[:1] * (v - d[1:]), 1),))

    data = torch.tensor([[1.0, 0.5], [0.0, 0.3], [2.0, -0.4]], dtype=F64)
    solve = port.make_implicit_solver(problem_fn, PARAMS)
    x, J = _jacobian(solve, data, torch.zeros(3, 1, dtype=F64))
    assert not torch.isfinite(J[1]).all()
    keep = torch.tensor([0, 2])
    x2, J2 = _jacobian(solve, data[keep], torch.zeros(2, 1, dtype=F64))
    torch.testing.assert_close(J[keep], J2, atol=0, rtol=0)
    np.testing.assert_allclose(J2[:, 0, 1].numpy(), [1.0, 1.0], atol=1e-10)


def test_transforms_over_solve_raise():
    """torch.func transforms over solve are refused by PyTorch (no
    setup_context), and so is a second derivative (once_differentiable)."""
    solve = port.make_implicit_solver(_target_problem, PARAMS)
    t = torch.tensor([[0.2, 0.4]], dtype=F64)
    with pytest.raises(RuntimeError, match="setup_context"):
        torch.func.grad(lambda d: solve(d, torch.zeros(1, 2, dtype=F64)).sum())(t)
    d = t.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(solve(d, torch.zeros(1, 2, dtype=F64)).sum(), d, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def test_joint_limit_pins_its_row():
    """tests/test_implicit.py:149's problem: at the 1.2 rad limit the elbow's
    row of dx*/dtarget is zero."""
    chain = port.make_planar_chain(2, dtype=F64)
    params = dataclasses.replace(pik.default_ik_params(F64, max_iterations=25, max_qp_iterations=10),
                                 absolute_exit_tol=1e-14, termination_kkt_tolerance=1e-10)
    solve = port.make_implicit_solver(lambda t: pik.make_ik_problem(chain, t, with_joint_limits=True,
                                                                    joint_limit=1.2),
                                      params, retraction=pik.mod_pi_retraction, active_tol=1e-6)
    x, J = _jacobian(solve, torch.tensor([[0.35, 0.25]], dtype=F64), torch.tensor([[0.7, 1.1]], dtype=F64))
    assert abs(float(x[0, 1]) - 1.2) < 1e-6
    assert float(J[0, 1].abs().max()) < 1e-4 and float(J[0, 0].abs().max()) > 0.1


def test_feedback_gain_shapes_at_a_short_horizon():
    """(NX,) in, (NX,) out; (B, NX) in, (B, NX) out from one backward pass,
    lane by lane equal to the one-state calls."""
    cp = pmpc.CartPole()
    states = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.02, 0.0, -0.03, 0.01]], dtype=F64)
    batch = pmpc.mpc_feedback_gain(cp, states, 3, 0.05)
    one = pmpc.mpc_feedback_gain(cp, states[1], 3, 0.05)
    assert batch.shape == (2, 4) and one.shape == (4,)
    torch.testing.assert_close(one, batch[1], atol=1e-12, rtol=0)
    np.testing.assert_allclose(batch[0].numpy(), -pmpc.finite_horizon_lqr_gain(cp, 3, 0.05)[0].numpy(),
                               rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# The slack wrapper.
# ---------------------------------------------------------------------------


def _disk(r2):
    """g(x) = r2 - ||x||^2 >= 0."""
    return port.make_residual((0, 1), lambda v: torch.stack([r2 - v @ v]), 1)


def _base():
    return port.Problem(dimension=2, costs=(port.make_residual((0, 1), lambda v: v - 1.0, 2),))


def test_lifted_structure():
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0), _disk(4.0)))
    assert aug.problem.dimension == 4 and aug.base_dimension == 2 and aug.slack_dim == 2
    assert [e.index for e in aug.problem.equality_constraints] == [(0, 1, 2), (0, 1, 3)]
    assert [(c.variable, c.a, c.b) for c in aug.problem.inequality_constraints] == [(2, 1.0, 0.0), (3, 1.0, 0.0)]
    assert len(aug.problem.costs) == 1


@pytest.mark.parametrize("x0,margin,want", [
    ((0.2, 0.1), 1e-2, 1.0 - 0.05),  # feasible: the constraint value
    ((2.0, 0.0), 1e-2, 1e-2),  # violated: the margin
    ((0.99, 0.0), 0.5, 0.5),  # feasible but under the margin
])
def test_initial_guess_margin(x0, margin, want):
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0),))
    got = aug.initial_guess(torch.tensor(x0, dtype=F64), margin=margin)
    np.testing.assert_allclose(got.numpy(), list(x0) + [want], rtol=0, atol=1e-15)


def test_initial_guess_batched_equals_per_row_and_keeps_float32():
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0), _disk(0.25)))
    x = torch.tensor([[0.2, 0.1], [2.0, 0.0], [0.0, 0.4]], dtype=torch.float32)
    batch = aug.initial_guess(x)
    assert batch.dtype == torch.float32 and batch.shape == (3, 4)
    for b in range(3):
        torch.testing.assert_close(batch[b], aug.initial_guess(x[b]), atol=0, rtol=0)


def test_no_inequalities_returns_x0():
    aug = port.with_nonlinear_inequalities(_base(), ())
    x = torch.tensor([0.3, 0.4], dtype=F64)
    assert aug.initial_guess(x) is x and aug.slack_dim == 0


@pytest.mark.parametrize("shape", [(4,), (3, 4)])
def test_extract_and_slacks(shape):
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0), _disk(4.0)))
    x = torch.arange(float(np.prod(shape)), dtype=F64).reshape(shape)
    torch.testing.assert_close(torch.cat([aug.extract(x), aug.slacks(x)], -1), x)
    assert aug.extract(x).shape[-1] == 2 and aug.slacks(x).shape[-1] == 2


def test_wrap_retraction_slacks_add():
    """The base retraction wraps the head; slacks update by plain addition
    (a large slack is not wrapped); a batch equals its rows."""
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0),))
    retract = aug.wrap_retraction(pik.mod_pi_retraction)
    x = torch.tensor([3.0, 0.0, 5.0], dtype=F64)
    dx = torch.tensor([1.0, 1.0, 2.0], dtype=F64)
    got = retract(x, dx, torch.tensor(0.5, dtype=F64))
    np.testing.assert_allclose(got.numpy(), [3.5 - 2 * np.pi, 0.5, 6.0], atol=1e-15)
    X = torch.stack([x, x * 0.5, -x])
    DX = torch.stack([dx, dx, -dx])
    A = torch.tensor([0.5, 1.0, 0.25], dtype=F64)
    batch = retract(X, DX, A)
    for b in range(3):
        torch.testing.assert_close(batch[b], retract(X[b], DX[b], A[b]), atol=0, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_constraint_values(batched):
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0), _disk(4.0)))
    x = torch.tensor([[0.5, 0.5, 9.0, 9.0], [1.0, 1.0, 0.0, 0.0]], dtype=F64)
    want = torch.tensor([[0.5, 3.5], [-1.0, 2.0]], dtype=F64)
    if batched:
        torch.testing.assert_close(aug.constraint_values(x), want)
    else:
        torch.testing.assert_close(aug.constraint_values(x[1]), want[1])


@pytest.mark.parametrize("base", [None, InitialGuessMethod.NAIVE, "default_params"])
def test_params_override_to_naive(base):
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0),))
    params = aug.params(port.NLSParams(max_iterations=7) if base == "default_params" else
                        (None if base is None else port.NLSParams(qp_initial_guess_method=base)))
    assert params.qp_initial_guess_method == InitialGuessMethod.NAIVE
    if base == "default_params":
        assert params.max_iterations == 7


def test_params_refuses_the_equality_guess():
    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0),))
    with pytest.raises(ValueError, match="SOLVE_EQUALITY_CONSTRAINED"):
        aug.params(port.NLSParams(qp_initial_guess_method=InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED))


def test_out_of_range_index_raises():
    bad = port.make_residual((0, 2), lambda v: v[:1], 1)
    with pytest.raises(ValueError, match="alias"):
        port.with_nonlinear_inequalities(_base(), (bad,))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_custom_jac_matches_jacfwd(dtype):
    """The slackened residual's custom jac is [J, -I] of the user's, equal to
    jacfwd of its function, in the working dtype."""

    def fn(v):
        return torch.stack([v[0] * v[1], torch.sin(v[0]) - v[1] * v[1]])

    def jac(v):
        return fn(v), torch.stack([torch.stack([v[1], v[0]]), torch.stack([torch.cos(v[0]), -2.0 * v[1]])])

    g = port.make_residual((0, 1), fn, 2, jac=jac)
    s = _slackened(g, (2, 3))
    xl = torch.tensor([0.3, -0.7, 0.1, 0.2], dtype=dtype)
    r, J = s.jac(xl)
    assert J.dtype == dtype and J.shape == (2, 4)
    torch.testing.assert_close(r, s.fn(xl))
    torch.testing.assert_close(J, jacfwd(s.fn)(xl))


def test_float32_lifted_linearization_stays_float32():
    """A float32 lift linearizes to float32 (the -I block and the margin in
    the working dtype)."""
    from mini_opt_tpu_torch.nonlinear import _linearize_one

    aug = port.with_nonlinear_inequalities(_base(), (_disk(1.0),))
    x = aug.initial_guess(torch.tensor([0.2, 0.1], dtype=torch.float32))
    G, c, f, A, b, l1, ia, ib = _linearize_one(aug.problem, x)
    assert {t.dtype for t in (G, c, f, A, b, ia, ib)} == {torch.float32}
    np.testing.assert_allclose(A.numpy(), [[-0.4, -0.2, -1.0]], atol=1e-7)


# ---------------------------------------------------------------------------
# nls_solve and solve_batch take the wrapper.
# ---------------------------------------------------------------------------

ROSEN = port.NLSParams(max_iterations=40, max_qp_iterations=10, max_line_search_iterations=5,
                       termination_kkt_tolerance=1.0e-9, absolute_first_derivative_tol=1.0e-9)


def _rosen_lift():
    base = port.Problem(dimension=2, costs=(port.make_residual(
        (0, 1), lambda xy: torch.stack([1.0 - xy[0], 10.0 * (xy[1] - xy[0] * xy[0])]), 2),))
    return port.with_nonlinear_inequalities(base, (_disk(1.0),))


def test_wrapper_equals_its_augmented_problem():
    """nls_solve(wrapper) is nls_solve(.problem, .params(params)) bit for bit,
    the retraction lifted; the default params get the NAIVE guess."""
    aug = _rosen_lift()
    x0 = aug.initial_guess(torch.tensor([[0.5, -0.5], [0.1, 0.2]], dtype=F64))
    got = port.nls_solve(aug, ROSEN, x0, retraction=pik.mod_pi_retraction)
    want = port.nls_solve(aug.problem, aug.params(ROSEN), x0, retraction=aug.wrap_retraction(pik.mod_pi_retraction))
    assert torch.equal(got.x, want.x) and torch.equal(got.termination_state, want.termination_state)
    np.testing.assert_allclose(aug.extract(got.x)[0].numpy(), [0.78641516, 0.61769831], atol=2e-5)
    assert float(aug.slacks(got.x)[0, 0]) < 1e-4  # the disk is active


def test_per_lane_wrapper_function_and_solve_batch():
    """A per-lane ``data_row -> wrapper`` function through nls_solve and
    solve_batch equals the per-lane ``.problem`` function with the
    override applied by hand."""
    rows = torch.tensor([[0.9, 0.35, 0.55, 0.45], [0.85, 0.4, 0.5, 0.5]], dtype=F64)
    x0 = torch.func.vmap(lambda r: inst.obstacle_ik_problem(r).initial_guess(
        torch.as_tensor(inst.OBSTACLE_X_REF, dtype=F64)))(rows)
    params = dataclasses.replace(inst.obstacle_ik_params(), max_iterations=6)
    got = port.nls_solve(inst.obstacle_ik_problem, params, x0, retraction=pik.mod_pi_retraction, data=rows)
    lifted = inst.obstacle_ik_problem(rows[0])
    want = port.nls_solve(lambda r: inst.obstacle_ik_problem(r).problem, lifted.params(params), x0,
                          retraction=lifted.wrap_retraction(pik.mod_pi_retraction), data=rows)
    via_batch = port.solve_batch(inst.obstacle_ik_problem, params, x0, rows, retraction=pik.mod_pi_retraction)
    assert torch.equal(got.x, want.x) and torch.equal(via_batch.x, got.x)


def test_solve_batch_without_data():
    aug = _rosen_lift()
    x0 = aug.initial_guess(torch.tensor([[0.5, -0.5]], dtype=F64))
    assert torch.equal(port.solve_batch(lambda: aug, ROSEN, x0).x, port.nls_solve(aug, ROSEN, x0).x)


# ---------------------------------------------------------------------------
# The tuner (tests/test_tuning.py:36-93).
# ---------------------------------------------------------------------------


def _mock(min_ok):
    calls = []

    def solve(outer, qp, ls):
        calls.append((outer, qp, ls))
        ok = outer >= min_ok[0] and qp >= min_ok[1] and ls >= min_ok[2]
        return np.zeros((16, 3)) if ok else np.full((16, 3), 7.0)

    return solve, calls


@pytest.mark.parametrize("min_ok", [(4, 2, 1), (10, 6, 2), (1, 6, 0), (7, 1, 2)])
def test_tuner_finds_the_componentwise_minimum(min_ok):
    solve, calls = _mock(min_ok)
    res = tuning.tune_serving_budget(solve, tuning.parity_gate(1e-9), max_budget=(10, 6, 2))
    assert res.budget == min_ok
    assert res.n_evaluations <= 20 and len(calls) == res.n_evaluations == len(res.trace)
    assert not res.trace[-1].ok or res.trace[-1].budget == res.budget


def test_tuner_reaches_the_min_budget():
    solve, _ = _mock((1, 1, 0))
    assert tuning.tune_serving_budget(solve, tuning.parity_gate(1e-9), max_budget=(8, 4, 2)).budget == (1, 1, 0)


def test_tuner_anchor_failing_its_gate_raises():
    with pytest.raises(ValueError, match="max_budget"):
        tuning.tune_serving_budget(lambda o, q, l: np.ones((4, 2)), lambda s, r: (False, -1.0), max_budget=(5, 3, 1))


def test_tuner_fractional_gate_and_metric():
    def solve(outer, qp, ls):
        base = np.zeros((100, 2))
        base[:10] = 5.0
        if outer < 3:
            base[10:] += 1.0
        return base

    gate = tuning.parity_gate(1e-6, frac=0.9, metric=lambda sol, ref: sol.max(axis=1))
    res = tuning.tune_serving_budget(solve, gate, max_budget=(6, 2, 1))
    assert res.budget[0] == 3 and res.margin_at(res.budget) == pytest.approx(0.0, abs=1e-12)
    with pytest.raises(KeyError):
        res.margin_at((9, 9, 9))


def test_budget_cost():
    assert tuning.budget_cost((4, 2, 1)) < tuning.budget_cost((10, 6, 2))
    assert tuning.budget_cost((2, 3, 2)) == 2 * (2.0 + 3 + 1.0)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "tensor_metric"])
def test_parity_gate_takes_tensors(kind):
    """A gate on tensors is the gate on their numpy values."""
    sol = np.array([[0.0, 1e-4], [0.3, 0.0], [0.0, 0.0]])
    ref = np.zeros((3, 2))
    want = tuning.parity_gate(1e-3, frac=0.5)(sol, ref)
    if kind == "numpy":
        got = want
    elif kind == "tensor":
        got = tuning.parity_gate(1e-3, frac=0.5)(torch.as_tensor(sol), torch.as_tensor(ref))
    else:
        got = tuning.parity_gate(1e-3, frac=0.5, metric=lambda s, r: (s - r).abs().amax(1))(
            torch.as_tensor(sol), torch.as_tensor(ref))
    assert got == want and want == (True, pytest.approx(2 / 3 - 0.5))


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_implicit_backward_on_the_card_matches_the_cpu():
    """The joint-limit IK fleet's dx*/dtarget on the card (kernels 4 and 5 in
    the forward solve) against the CPU, lane for lane, float64."""
    rng = np.random.default_rng(0)
    r, a = rng.uniform(0.45, 0.78, 64), rng.uniform(-0.4, 1.2, 64)
    targets = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    x0 = np.tile([0.7, 1.1], (64, 1))
    out = {}
    for device in ("cuda", "cpu"):
        chain = port.make_planar_chain(2, dtype=F64, device=device)
        params = dataclasses.replace(pik.default_ik_params(F64, max_iterations=25, max_qp_iterations=10),
                                     absolute_exit_tol=1e-14, termination_kkt_tolerance=1e-10,
                                     kkt_solver="pallas_ldlt")
        solve = port.make_implicit_solver(lambda t, c=chain: pik.make_ik_problem(c, t, joint_limit=1.2), params,
                                          retraction=pik.mod_pi_retraction)
        x, J = _jacobian(solve, torch.as_tensor(targets, device=device), torch.as_tensor(x0, device=device))
        out[device] = (x.cpu().numpy(), J.cpu().numpy())
    for a_, b_ in zip(out["cuda"], out["cpu"]):
        assert np.abs(a_ - b_).max() <= 1e-8 * (1.0 + np.abs(b_).max())
