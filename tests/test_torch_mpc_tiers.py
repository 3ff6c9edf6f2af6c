"""The PyTorch port's MPC path held against itself and against dense
linear algebra, without JAX (cheap cases: no solver compile).

* The Riccati KKT backend (``ops/riccati.py``) against ``numpy.linalg.solve``
  of the dense condensed system over a grid of (T, NX, NU), as the JAX
  package's ``test_riccati_matches_dense_solve`` does; off-pattern mass, a
  singular transition block and a non-PD reduced Hessian set ``ok`` False;
  ``solve_mpc`` under ``riccati:T:4:1`` equals the same call under
  ``ldlt``.
* The plain version of kernel 8 (``ops/mpc.py::_mpc_plain``): one outer
  step against the port's ``linearize_and_fill_qp`` + ``qp_ip_solve``
  (Mehrotra, SOLVE_EQUALITY_CONSTRAINED); whole solves against the port's
  ``nls_solve`` on ``make_family_mpc_problem`` for both plants at JAX's
  own tolerances (tests/test_pallas_mpc.py).
* The plain version of kernel 9 against a manual loop of solve ->
  ``family_rk4_step`` -> shift; the dual-number Jacobians against
  ``torch.func.jacfwd``; NaN lanes, lane independence, the argument checks
  and the layouts.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import cartpole_mpc_instances, quadrotor_mpc_instances
from mini_opt_tpu_torch.models import mpc
from mini_opt_tpu_torch.ops import kkt as kkt_ops
from mini_opt_tpu_torch.ops import mpc as pm
from mini_opt_tpu_torch.ops import riccati as rc
from mini_opt_tpu_torch.qp import QPInteriorPointParams, qp_ip_solve
from mini_opt_tpu_torch.structs import BarrierStrategy, InitialGuessMethod

T, DT = 3, 0.05
CP = mpc.CartPole()
PLANTS = {
    "cartpole": lambda: pm.cartpole_mpc_family(T, DT),
    "quadrotor": lambda: pm.quadrotor_mpc_family(T, DT),
}


def _fleet(kind, B, seed=0):
    """(family, x (B, nx), z (B, dim)): the bench distribution at T = 3 with
    its cold initial guess, float64 CPU tensors."""
    fam = PLANTS[kind]()
    x = (cartpole_mpc_instances if kind == "cartpole" else quadrotor_mpc_instances)(B, seed)
    x = torch.as_tensor(x)
    return fam, x, mpc.family_initial_guess(fam, x)


def _bits(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


# ---------------------------------------------------------------------------
# The Riccati KKT backend.
# ---------------------------------------------------------------------------


def _stagewise_system(rng, T_, NX, NU):
    """Dense (N+K)^2 saddle matrix with the LQR pattern: PD stage Hessian
    blocks, random defect blocks, near-identity transition blocks N_t
    (tests/test_riccati.py's generator)."""
    N = T_ * (NX + NU)
    K = T_ * NX
    H = np.zeros((N + K, N + K))

    def u(t):
        return slice(t * NU, (t + 1) * NU)

    def x(t):
        return slice(T_ * NU + (t - 1) * NX, T_ * NU + t * NX)

    def e(t):
        return slice(N + t * NX, N + (t + 1) * NX)

    for t in range(T_):
        Ru = rng.normal(size=(NU, NU))
        H[u(t), u(t)] = Ru @ Ru.T + 0.5 * np.eye(NU)
        Qx = rng.normal(size=(NX, NX))
        H[x(t + 1), x(t + 1)] = Qx @ Qx.T + 0.3 * np.eye(NX)
        H[e(t), u(t)] = rng.normal(size=(NX, NU))
        if t >= 1:
            H[e(t), x(t)] = rng.normal(size=(NX, NX))
        H[e(t), x(t + 1)] = np.eye(NX) + 0.2 * rng.normal(size=(NX, NX))
    H[:N, N:] = H[N:, :N].T
    return H, (u, x, e)


def _batch(T_, NX, NU, B=4, seed=0):
    rng = np.random.default_rng(seed + 100 * T_ + 10 * NX + NU)
    H = np.stack([_stagewise_system(rng, T_, NX, NU)[0] for _ in range(B)])
    rhs = rng.normal(size=(B, H.shape[1]))
    return H, rhs


@pytest.mark.parametrize("NU", [1, 2])
@pytest.mark.parametrize("NX", [1, 3, 4])
@pytest.mark.parametrize("T_", [1, 2, 5, 12])
def test_riccati_matches_dense_solve(T_, NX, NU):
    H, rhs = _batch(T_, NX, NU)
    fact, ok = rc.riccati_factorize(torch.as_tensor(H), T_, NX, NU)
    assert ok.all()
    sol = rc.riccati_solve(fact, torch.as_tensor(rhs), T_, NX, NU)
    ref = np.linalg.solve(H, rhs[..., None])[..., 0]
    np.testing.assert_allclose(sol.numpy(), ref, rtol=0, atol=1e-10)


def test_riccati_through_kkt_dispatch():
    H, rhs = _batch(5, 4, 1)
    name = rc.solver_name(5, 4, 1)
    assert kkt_ops.is_valid_solver(name) and rc.parse(name) == (5, 4, 1)
    fact, ok = kkt_ops.kkt_factorize(torch.as_tensor(H), name)
    sol = kkt_ops.kkt_solve(fact, torch.as_tensor(rhs), name)
    ref = np.linalg.solve(H, rhs[..., None])[..., 0]
    assert ok.all()
    np.testing.assert_allclose(sol.numpy(), ref, rtol=0, atol=1e-10)


def _poison(kind, H, slices, T_):
    u, x, e = slices
    if kind == "off_pattern":  # u_0 coupled to x_T: not an LQR system
        H[u(0), x(T_)] = 0.3
        H[x(T_), u(0)] = 0.3
    elif kind == "singular_N":
        H[e(1), x(2)] = 0.0
        H[x(2), e(1)] = 0.0
    else:  # a reduced Hessian F_t that is not positive definite
        H[u(1), u(1)] = -1e6 * np.eye(u(1).stop - u(1).start)


@pytest.mark.parametrize("kind", ["off_pattern", "singular_N", "non_pd_F"])
def test_riccati_flags_what_it_cannot_factor(kind):
    """Only the poisoned lane loses ``ok``; the others still solve."""
    T_, NX, NU = 4, 3, 1
    rng = np.random.default_rng(5)
    systems = [_stagewise_system(rng, T_, NX, NU) for _ in range(3)]
    H = np.stack([s[0] for s in systems])
    _poison(kind, H[1], systems[1][1], T_)
    fact, ok = rc.riccati_factorize(torch.as_tensor(H), T_, NX, NU)
    assert ok.tolist() == [True, False, True]
    rhs = rng.normal(size=(3, H.shape[1]))
    sol = rc.riccati_solve(fact, torch.as_tensor(rhs), T_, NX, NU)
    for lane in (0, 2):
        np.testing.assert_allclose(sol[lane].numpy(), np.linalg.solve(H[lane], rhs[lane]), rtol=0, atol=1e-10)


@pytest.mark.parametrize("spec", ["riccati:4:1", "ricati:4:4:1", "riccati:0:4:1", "riccati:a:4:1"])
def test_riccati_spec_checks(spec):
    with pytest.raises(ValueError):
        rc.parse(spec)


def test_riccati_checks_the_system_size():
    H, rhs = _batch(3, 4, 1)
    with pytest.raises(ValueError, match="expects a"):
        rc.riccati_factorize(torch.as_tensor(H), 4, 4, 1)
    fact, _ = rc.riccati_factorize(torch.as_tensor(H), 3, 4, 1)
    with pytest.raises(ValueError):
        rc.riccati_solve(fact, torch.as_tensor(rhs[:, :-1]), 3, 4, 1)


@pytest.mark.parametrize(
    "barrier,qp_iterations",
    [(BarrierStrategy.COMPLEMENTARITY, 8), (BarrierStrategy.PREDICTOR_CORRECTOR, 3)],
    ids=["complementarity", "mpc"],
)
def test_solve_mpc_identical_under_riccati_kkt(barrier, qp_iterations):
    """The structured backend changes nothing but the linear algebra:
    ``solve_mpc`` under ``riccati:3:4:1`` equals the same call under
    ``ldlt`` to 1e-10 (tests/test_riccati.py holds JAX to 1e-8).

    The complementarity case runs ``default_mpc_params``' 8 QP iterations:
    cut to 3, its barrier terms leave the condensed systems so
    ill-conditioned that the two dense backends, ``ldlt`` and ``lu``, part
    by up to 1.3e-6 on these lanes, and the Riccati backend by as much."""
    x0 = torch.as_tensor(cartpole_mpc_instances(4, 3))
    base = dataclasses.replace(
        mpc.default_mpc_params(torch.float64, max_iterations=3, max_qp_iterations=qp_iterations, early_exit=False),
        qp_barrier_strategy=barrier, record_history=False,
    )
    r_ric = mpc.solve_mpc(CP, x0, T, DT, params=dataclasses.replace(base, kkt_solver=mpc.riccati_kkt_solver(T)))
    r_ldl = mpc.solve_mpc(CP, x0, T, DT, params=dataclasses.replace(base, kkt_solver="ldlt"))
    torch.testing.assert_close(r_ric.x, r_ldl.x, rtol=0, atol=1e-10)
    assert torch.equal(r_ric.termination_state, r_ldl.termination_state)


def test_default_mpc_params_select_the_backend():
    assert mpc.default_mpc_params(horizon=20).kkt_solver == "riccati:20:4:1"
    assert mpc.default_mpc_params().kkt_solver == "auto"
    p64 = mpc.default_mpc_params(torch.float64)
    assert p64.absolute_exit_tol == 1e-12 and p64.lambda_initial == 1e-6 and p64.min_lambda == 1e-12
    params, warm = mpc.serving_mpc_params(horizon=20, warm=(1, 1, 1))
    assert params.early_exit is False and params.kkt_solver == "riccati:20:4:1"
    assert (warm.max_iterations, warm.max_qp_iterations, warm.max_line_search_iterations) == (1, 1, 1)


# ---------------------------------------------------------------------------
# Kernel 8's plain version against the general path.
# ---------------------------------------------------------------------------


def _problem_fn(fam):
    if fam.nx == 4:
        return lambda xr: mpc.make_cartpole_mpc_problem(CP, xr, T, DT)
    return lambda xr: mpc.make_family_mpc_problem(fam, xr)


@pytest.mark.parametrize("qp_iters", [1, 2, 3])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_qp_step_matches_general_interior_point(kind, qp_iters):
    """One outer iteration at ls = 0 (alpha = 1 accepted on this
    distribution): z - z0 is the inner QP's solution, held against
    ``qp_ip_solve`` on the port's own linearization through the whole
    Mehrotra loop."""
    fam, x0, z0 = _fleet(kind, 4, seed=7)
    z = pm.fused_mpc_solve_batch(fam, x0, z0, max_iterations=1, qp_iterations=qp_iters, ls_iterations=0)
    qp, _ = port.nonlinear.linearize_and_fill_qp(_problem_fn(fam), z0, torch.full((4,), 1e-6, dtype=torch.float64),
                                                 data=x0)
    params = QPInteriorPointParams(
        max_iterations=qp_iters, sigma=0.1, barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR,
        initial_guess_method=InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED, termination_kkt_tol=1e-300,
        early_exit=False,
    )
    torch.testing.assert_close(z - z0, qp_ip_solve(qp, params).x, rtol=0, atol=1e-10)


def _general_params(it, qp, ls):
    return dataclasses.replace(
        mpc.default_mpc_params(torch.float64, early_exit=False),
        max_iterations=it, max_qp_iterations=qp, max_line_search_iterations=ls,
        qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR,
    )


@pytest.mark.parametrize("budget", [(2, 2, 1), (6, 3, 2)], ids=["2-2-1", "6-3-2"])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_full_solve_matches_nls_solve(kind, budget):
    """Whole fixed-trip solves against ``nls_solve`` on the generic
    transcription at JAX's tolerances (1e-10 at 2/2/1, 2e-6 at 6/3/2).

    ``nls_solve`` stops a lane once it meets its tolerances; the fused
    kernel runs every trip. Past that point a failed line search can send
    the kernel's lambda to 1e-3 and its next step further along a flat
    valley of the merit, so at 6/3/2 the trajectories are held on the lanes
    whose line search accepted every step, and every lane's merit must be
    no worse than the general path's."""
    fam, x0, z0 = _fleet(kind, 6, seed=11)
    z, state, hist = pm.fused_mpc_solve_batch(fam, x0, z0, *budget, return_state=True, debug_history=True)
    res = port.nls_solve(_problem_fn_family(fam), _general_params(*budget), z0, data=x0)
    steady = (hist[:, :, 5] == 1.0).all(dim=1)
    atol = 1e-10 if budget[0] == 2 else 2e-6
    if budget[0] == 2:
        assert steady.all()
    torch.testing.assert_close(z[steady], res.x[steady], rtol=0, atol=atol)
    merit_k = state[:, 0] + state[:, 1]
    merit_g = res.errors.f + res.errors.equality
    assert (merit_k <= merit_g + 1e-9).all(), (merit_k - merit_g)


def test_converges_and_feasible():
    """At a verification budget every lane reaches defect feasibility and
    the best-merit return holds (f finite, flags clean)."""
    fam, x0, z0 = _fleet("cartpole", 8, seed=2)
    z, state = pm.fused_mpc_solve_batch(fam, x0, z0, 8, 3, 2, return_state=True)
    assert torch.isfinite(z).all()
    assert (state[:, 1] < 1e-10).all() and (state[:, 2] == 0).all()
    status = port.fused_termination_status(state, f_tol=float("inf"), eq_tol=1e-10)
    assert (status == int(port.NLSTerminationState.SATISFIED_ABSOLUTE_TOL)).all()


@pytest.mark.parametrize("unroll", [None, False, True])
def test_unroll_changes_nothing(unroll):
    fam, x0, z0 = _fleet("cartpole", 4, seed=3)
    ref = pm.fused_mpc_solve_batch(fam, x0, z0, 1, 1, 1)
    got = pm.fused_mpc_solve_batch(fam, x0, z0, 1, 1, 1, unroll=unroll)
    assert torch.equal(got, ref)


def test_debug_history_channels():
    """(B, iters, 7) channels [f, eq, penalty, lam, dd, accepted, alpha]:
    warm starts accept a descent step in the first iteration."""
    fam, x0, z0 = _fleet("cartpole", 4, seed=3)
    z, hist = pm.fused_mpc_solve_batch(fam, x0, z0, 2, 1, 1, debug_history=True)
    assert hist.shape == (4, 2, 7) and torch.isfinite(hist).all()
    assert (hist[:, 0, 5] == 1.0).all() and (hist[:, 0, 4] < 0).all() and (hist[:, 0, 6] > 0).all()
    assert (hist[:, 0, 3] == 1e-6).all()
    torch.testing.assert_close(hist[:, 1, 3], torch.full((4,), 1e-7, dtype=torch.float64), rtol=1e-15, atol=0)
    assert torch.equal(z, pm.fused_mpc_solve_batch(fam, x0, z0, 2, 1, 1))


def test_xla_backend_is_the_plain_version_on_cpu():
    fam, x0, z0 = _fleet("quadrotor", 5)
    a = pm.fused_mpc_solve_batch(fam, x0, z0, 2, 2, 1, return_state=True)
    b = pm.fused_mpc_solve_batch(fam, x0, z0, 2, 2, 1, return_state=True, backend="xla")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# Kernel 9's plain version.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periods", [1, 3])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_servo_matches_manual_rollout(kind, periods):
    """The servo loop equals the composition solve -> family_rk4_step ->
    shift, period by period, bit for bit; its stats are the last period's
    (f, |eq|_1), the sticky flags and the running max |u_0|."""
    fam, x0, z0 = _fleet(kind, 5, seed=4)
    xf, zf, stats = pm.fused_mpc_servo_batch(fam, x0, z0, periods, 1, 1, 1)
    x, z = x0, z0
    maxu = torch.zeros(5, dtype=torch.float64)
    for _ in range(periods):
        z, state = pm.fused_mpc_solve_batch(fam, x, z, 1, 1, 1, return_state=True)
        u0 = z[:, : fam.nu]
        maxu = torch.maximum(maxu, u0.abs().amax(dim=1))
        x = mpc.family_rk4_step(fam, x, u0)
        u, xs = z[:, : T * fam.nu].reshape(5, T, fam.nu), z[:, T * fam.nu :].reshape(5, T, fam.nx)
        x_term = mpc.family_rk4_step(fam, xs[:, -1], u[:, -1])
        z = torch.cat([torch.cat([u[:, 1:], u[:, -1:]], 1).reshape(5, -1),
                       torch.cat([xs[:, 1:], x_term[:, None]], 1).reshape(5, -1)], 1)
    assert torch.equal(xf, x) and torch.equal(zf, z)
    assert torch.equal(stats[:, :2], state[:, :2]) and torch.equal(stats[:, 3], maxu)


def test_servo_zero_periods_is_the_identity():
    fam, x0, z0 = _fleet("cartpole", 3)
    xf, zf, stats = pm.fused_mpc_servo_batch(fam, x0, z0, 0)
    assert torch.equal(xf, x0) and torch.equal(zf, z0) and torch.equal(stats, torch.zeros_like(stats))


def test_cartpole_shift_matches_the_servo():
    """models/mpc.py's cart-pole rk4_step and shift_warm_start compute what
    the family's plant does inside the servo."""
    fam, x0, z0 = _fleet("cartpole", 5, seed=6)
    xf, zf, _ = pm.fused_mpc_servo_batch(fam, x0, z0, 1, 1, 1, 1)
    z = pm.fused_mpc_solve_batch(fam, x0, z0, 1, 1, 1)
    assert torch.equal(xf, mpc.rk4_step(CP, x0, z[:, 0], DT))
    assert torch.equal(zf, mpc.shift_warm_start(CP, z, T, DT))


# ---------------------------------------------------------------------------
# Dual numbers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_dual_jacobians_match_jacfwd(kind, seed):
    fam = PLANTS[kind]()
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.uniform(-0.6, 0.6, fam.nx + fam.nu))
    pred, A, Bm = pm._rk4_linearized(fam, list(v[: fam.nx]), list(v[fam.nx :]))
    J = jacfwd(lambda w: torch.stack(pm._rk4(fam, list(w[: fam.nx]), list(w[fam.nx :]))))(v)
    torch.testing.assert_close(torch.cat([A, Bm], dim=1), J, rtol=0, atol=1e-13)
    assert torch.equal(torch.stack(pred), torch.stack(pm._rk4(fam, list(v[: fam.nx]), list(v[fam.nx :]))))


DUAL_RULES = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "quot": lambda a, b: pm._quot(a, b),
    "const": lambda a, b: 2.5 - (0.5 * a + 1.5) - pm._quot(b, 3.0) * (-a),
    "sin": lambda a, b: pm._sin(a) * b,
    "cos": lambda a, b: pm._cos(a) + b,
}


@pytest.mark.parametrize("rule", list(DUAL_RULES))
def test_dual_rules_match_jacfwd(rule):
    f = DUAL_RULES[rule]
    a0, b0 = torch.tensor([0.7, -0.3], dtype=torch.float64), torch.tensor([1.3, 2.1], dtype=torch.float64)
    eye = torch.eye(2, dtype=torch.float64)
    out = f(pm._Dual(a0, eye[0][:, None].expand(2, 2)), pm._Dual(b0, eye[1][:, None].expand(2, 2)))
    want = torch.stack([jacfwd(lambda ab: f(ab[0], ab[1]))(torch.stack([a0[k], b0[k]])) for k in range(2)])
    assert torch.equal(out.v, f(a0, b0))
    torch.testing.assert_close(out.t.T, want, rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# NaN lanes, lane independence.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("poison", ["x0", "z0"])
@pytest.mark.parametrize("entry", ["solve", "servo"])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_nan_lane_is_flagged_and_contained(kind, entry, poison):
    fam, x0, z0 = _fleet(kind, 6, seed=8)
    xb, zb = x0.clone(), z0.clone()
    (xb if poison == "x0" else zb)[2, 1] = float("nan")
    if entry == "solve":
        outs = pm.fused_mpc_solve_batch(fam, xb, zb, 2, 2, 1, return_state=True)
        ref = pm.fused_mpc_solve_batch(fam, x0, z0, 2, 2, 1, return_state=True)
        flags = outs[1][:, 2]
    else:
        outs = pm.fused_mpc_servo_batch(fam, xb, zb, 2, 1, 1, 1)
        ref = pm.fused_mpc_servo_batch(fam, x0, z0, 2, 1, 1, 1)
        flags = outs[2][:, 2]
    assert flags[2] != 0
    keep = torch.arange(6) != 2
    for got, want in zip(outs, ref):
        assert torch.equal(got[keep], want[keep])
        assert torch.isfinite(got[keep]).all()


@pytest.mark.parametrize("entry", ["solve", "servo"])
@pytest.mark.parametrize("kind", list(PLANTS))
def test_lanes_are_independent(kind, entry):
    fam, x0, z0 = _fleet(kind, 7, seed=9)

    def run(x, z):
        if entry == "solve":
            return pm.fused_mpc_solve_batch(fam, x, z, 2, 2, 1, return_state=True)
        return pm.fused_mpc_servo_batch(fam, x, z, 2, 1, 1, 1)

    full = run(x0, z0)
    for lane in (0, 4):
        one = run(x0[lane : lane + 1], z0[lane : lane + 1])
        for a, b in zip(one, full):
            assert _bits(a[0], b[lane])


# ---------------------------------------------------------------------------
# Argument checks, families, layouts.
# ---------------------------------------------------------------------------


def _bad_calls():
    fam, x0, z0 = _fleet("cartpole", 3)
    return {
        "x_shape": (ValueError, lambda: pm.fused_mpc_solve_batch(fam, x0[:, :3], z0)),
        "z_shape": (ValueError, lambda: pm.fused_mpc_solve_batch(fam, x0, z0[:, :-1])),
        "servo_shape": (ValueError, lambda: pm.fused_mpc_servo_batch(fam, x0, z0[:, :-1], 2)),
        "backend": (ValueError, lambda: pm.fused_mpc_solve_batch(fam, x0, z0, backend="mosaic")),
        "history_needs_unroll": (
            ValueError, lambda: pm.fused_mpc_solve_batch(fam, x0, z0, debug_history=True, unroll=False)),
        "zero_iterations": (ValueError, lambda: pm.fused_mpc_solve_batch(fam, x0, z0, max_iterations=0)),
        "negative_qp": (ValueError, lambda: pm.fused_mpc_servo_batch(fam, x0, z0, 1, qp_iterations=-1)),
        "negative_periods": (ValueError, lambda: pm.fused_mpc_servo_batch(fam, x0, z0, -1)),
        "dtype_mismatch": (TypeError, lambda: pm.fused_mpc_solve_batch(fam, x0.float(), z0)),
        "mixed_inputs": (TypeError, lambda: pm.fused_mpc_solve_batch(fam, x0.numpy(), z0)),
        "family_sizes": (ValueError, lambda: pm.MPCFamily(horizon=3, dt=0.05, nx=3)),
        "family_horizon": (ValueError, lambda: pm.MPCFamily(horizon=0, dt=0.05)),
        "convert_kind": (ValueError, lambda: port.convert.mpc_family_from_numpy("rocket", 3, 0.05)),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_argument_checks(case):
    exc, call = _bad_calls()[case]
    with pytest.raises(exc):
        call()


def test_numpy_inputs_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fam, x0, z0 = _fleet("cartpole", 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.fused_mpc_solve_batch(fam, x0.numpy(), z0.numpy())
    z = pm.fused_mpc_solve_batch(fam, x0.numpy(), z0.numpy(), 1, 1, 1, device="cpu")
    assert z.device.type == "cpu" and torch.equal(z, pm.fused_mpc_solve_batch(fam, x0, z0, 1, 1, 1))


def test_family_without_functor_runs_on_cpu_only():
    """A family with Python dynamics and no device functor solves on the CPU
    (the same arithmetic as the built-in cart-pole) and names the missing
    functor before it touches a card."""
    ref = pm.cartpole_mpc_family(T, DT)
    fam = dataclasses.replace(ref, cuda_functor=None)
    _, x0, z0 = _fleet("cartpole", 4)
    assert torch.equal(pm.fused_mpc_solve_batch(fam, x0, z0, 2, 1, 1), pm.fused_mpc_solve_batch(ref, x0, z0, 2, 1, 1))
    with pytest.raises(NotImplementedError, match="functor"):
        pm._cuda_args(fam)
    stock = pm.MPCFamily(horizon=T, dt=DT)  # xdot None: the stock cart-pole
    assert pm._cuda_args(stock)[0] == 0
    assert torch.equal(pm.fused_mpc_solve_batch(stock, x0, z0, 2, 1, 1), pm.fused_mpc_solve_batch(ref, x0, z0, 2, 1, 1))


@pytest.mark.parametrize("kind", list(PLANTS))
def test_convert_builds_the_same_family(kind):
    consts = (dict(u_max=8, mass_pole=0.2, length=0.6) if kind == "cartpole" else dict(u_max=6, mass=0.4, arm=0.2))
    fam = port.convert.mpc_family_from_numpy(kind, 5, 0.04, **consts)
    ref = (pm.cartpole_mpc_family if kind == "cartpole" else pm.quadrotor_mpc_family)(5, 0.04, **consts)
    assert fam is ref
    assert fam.cuda_functor[0] == kind and fam.horizon == 5 and fam.dim == 5 * (fam.nx + fam.nu)


def test_instances_copy_the_bench_distributions():
    x = cartpole_mpc_instances(1000, 0)
    assert x.shape == (1000, 4) and np.array_equal(x, cartpole_mpc_instances(1000, 0))
    assert (np.abs(x) <= [0.2, 0.2, 0.35, 0.2]).all() and np.abs(x[:, 2]).max() > 0.3
    q = quadrotor_mpc_instances(1000, 0)
    assert q.shape == (1000, 6) and (q[:, 3:] == 0).all() and (np.abs(q[:, :3]) <= [0.4, 0.4, 0.25]).all()


def test_layout_helpers():
    x = torch.as_tensor(cartpole_mpc_instances(3, 1))
    z = mpc.initial_guess(CP, x, 4, DT)
    assert z.shape == (3, mpc.mpc_dimension(4)) and (z[:, :4] == 0).all()
    u, X = mpc.split_z(z, 4)
    assert torch.equal(X[:, 2], x) and mpc.x_indices(4, 2) == (8, 9, 10, 11) and mpc.u_index(3) == 3
    assert torch.equal(mpc.initial_guess(CP, x[1], 4, DT), z[1])
    assert torch.equal(mpc.shift_warm_start(CP, z[1], 4, DT), mpc.shift_warm_start(CP, z, 4, DT)[1])
    fam = pm.quadrotor_mpc_family(4, DT)
    xq = torch.as_tensor(quadrotor_mpc_instances(2, 1))
    zq = mpc.family_initial_guess(fam, xq)
    assert zq.shape == (2, fam.dim) and torch.equal(zq[:, :2], torch.full((2, 2), fam.u_ref[0], dtype=torch.float64))


def test_linearized_dynamics_match_the_dual_jacobians():
    A, Bm = mpc.linearized_dynamics(CP, torch.zeros(4, dtype=torch.float64), 0.0, DT)
    zero = torch.zeros((), dtype=torch.float64)
    _, Ad, Bd = pm._rk4_linearized(pm.cartpole_mpc_family(T, DT), [zero] * 4, [zero])
    torch.testing.assert_close(A, Ad, rtol=0, atol=1e-14)
    torch.testing.assert_close(Bm, Bd, rtol=0, atol=1e-14)
    K = mpc.finite_horizon_lqr_gain(CP, 20, DT)
    assert K.shape == (1, 4) and torch.isfinite(K).all() and K[0, 2] < 0


def test_fused_rollout_is_one_solve_per_period():
    x0 = torch.as_tensor(cartpole_mpc_instances(4, 5))
    states, us, state = mpc.fused_mpc_rollout_batch(CP, x0, 3, T, DT, budget=(1, 1, 1), cold_budget=(2, 2, 1))
    fam = pm.cartpole_mpc_family(T, DT)
    x, z = x0, mpc.initial_guess(CP, x0, T, DT)
    for k, bud in enumerate([(2, 2, 1), (1, 1, 1), (1, 1, 1)]):
        z, st = pm.fused_mpc_solve_batch(fam, x, z, *bud, return_state=True)
        assert torch.equal(us[k], z[:, 0])
        x = mpc.rk4_step(CP, x, z[:, 0], DT)
        z = mpc.shift_warm_start(CP, z, T, DT)
        assert torch.equal(states[k + 1], x)
    assert states.shape == (4, 4, 4) and torch.equal(state, st)


def test_general_rollout_single_is_the_batch_row():
    x0 = torch.as_tensor(cartpole_mpc_instances(2, 6))
    params, warm = mpc.serving_mpc_params(torch.float64, horizon=T, warm=(1, 1, 1))
    params = dataclasses.replace(params, max_iterations=2, max_qp_iterations=2)
    states, us, merits, terms = mpc.mpc_rollout_batch(CP, x0, 2, T, DT, params=params, warm_params=warm)
    assert states.shape == (2, 3, 4) and us.shape == (2, 2) and merits.shape == (2, 2) and terms.shape == (2, 2)
    one = mpc.mpc_rollout(CP, x0[1], 2, T, DT, params=params, warm_params=warm)
    torch.testing.assert_close(one[0], states[1], rtol=0, atol=1e-12)
    torch.testing.assert_close(one[1], us[1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("problem", ["cartpole", "family_cartpole", "family_quadrotor"])
def test_float32_general_path_keeps_its_dtype(problem):
    """The transcriptions' Jacobians stay float32 under torch.func.jacfwd
    (a Python float times a zero tangent would come out float64)."""
    kind = "quadrotor" if problem == "family_quadrotor" else "cartpole"
    fam, x0, z0 = _fleet(kind, 3, seed=10)
    x0, z0 = x0.float(), z0.float()
    fn = (lambda xr: mpc.make_cartpole_mpc_problem(CP, xr, T, DT)) if problem == "cartpole" else _problem_fn_family(fam)
    params = dataclasses.replace(mpc.default_mpc_params(torch.float32, early_exit=False), max_iterations=2,
                                 max_qp_iterations=2)
    res = port.nls_solve(fn, params, z0, data=x0)
    assert res.x.dtype == torch.float32 and torch.isfinite(res.x).all()


def _problem_fn_family(fam):
    return lambda xr: mpc.make_family_mpc_problem(fam, xr)


# ---------------------------------------------------------------------------
# Kernels 8 and 9's launch plan: one warp per instance, its Layout slots a
# slab of the CTA's shared memory, or of a global scratch array past one
# CTA's 232,448 bytes.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the layout is read from the kernel library",
)
PLAN_FAMILIES = {"cartpole": pm.cartpole_mpc_family, "quadrotor": pm.quadrotor_mpc_family}
# Slots per stage: 4 (nx + nu) trajectory slots, A, B, r, cu, cx, F's L and
# d, K, V_{t+1}, 26 per-input and 7 per-state interior-point arrays.
SLOTS_PER_STAGE = {"cartpole": 4 * 5 + 16 + 4 + 4 + 1 + 4 + 1 + 1 + 4 + 16 + 26 + 28,
                   "quadrotor": 4 * 8 + 36 + 12 + 6 + 2 + 6 + 4 + 2 + 12 + 36 + 52 + 42}


@pytest.mark.parametrize("kind, T_, slots", [("cartpole", 20, 2500), ("quadrotor", 12, 2904)])
def test_layout_slots_at_the_main_path_horizons(kind, T_, slots):
    fam = PLAN_FAMILIES[kind](T_, DT)
    assert pm.layout_slots(T_, fam.nx, fam.nu) == slots


@pytest.mark.parametrize("T_", [1, 2, 7, 64, 500])
@pytest.mark.parametrize("kind", list(PLAN_FAMILIES))
def test_layout_slots_grow_by_stage(kind, T_):
    fam = PLAN_FAMILIES[kind](T_, DT)
    assert pm.layout_slots(T_, fam.nx, fam.nu) == SLOTS_PER_STAGE[kind] * T_


@pytest.mark.parametrize("B", [1, 5, 1024, 8192, 8205])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind, T_", [("cartpole", 20), ("quadrotor", 12)])
def test_launch_plan_at_the_main_path_shapes(kind, T_, dtype, B):
    """Shared memory, 4 warps per CTA, the grid covering B with at most one
    ragged CTA."""
    fam = PLAN_FAMILIES[kind](T_, DT)
    plan = pm.launch_plan(fam, B, dtype)
    slab = plan.slots * torch.empty((), dtype=dtype).element_size()
    assert plan.storage == "shared" and plan.warps == pm.WARPS_PER_CTA == 4
    assert plan.cta_bytes == plan.warps * slab <= pm.MAX_CTA_SMEM
    assert plan.grid * plan.warps >= B > (plan.grid - 1) * plan.warps


@pytest.mark.parametrize(
    "kind, T_, dtype, storage, warps",
    [("quadrotor", 128, torch.float64, "global", 4), ("quadrotor", 128, torch.float32, "shared", 1),
     ("quadrotor", 240, torch.float32, "shared", 1), ("quadrotor", 241, torch.float32, "global", 4),
     ("cartpole", 232, torch.float64, "shared", 1), ("cartpole", 233, torch.float64, "global", 4),
     ("cartpole", 464, torch.float32, "shared", 1), ("cartpole", 465, torch.float32, "global", 4),
     ("cartpole", 116, torch.float64, "shared", 2), ("cartpole", 117, torch.float64, "shared", 1)],
)
def test_launch_plan_past_the_shared_limit(kind, T_, dtype, storage, warps):
    """Fewer warps where four slabs do not fit a CTA, the global route
    where one does not."""
    plan = pm.launch_plan(PLAN_FAMILIES[kind](T_, DT), 67, dtype)
    assert (plan.storage, plan.warps) == (storage, warps)
    assert plan.cta_bytes == (0 if storage == "global" else warps * plan.slots * torch.empty((), dtype=dtype).element_size())
    assert plan.grid == -(-67 // warps)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", list(PLAN_FAMILIES))
def test_every_cta_fits_and_the_grid_covers_b(kind, dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for T_ in range(1, 600, 7):
        fam = PLAN_FAMILIES[kind](T_, DT)
        for B in (1, 3, 4, 5, 1000):
            plan = pm.launch_plan(fam, B, dtype)
            assert plan.cta_bytes <= pm.MAX_CTA_SMEM and 1 <= plan.warps <= 8
            assert (plan.storage == "shared") == (plan.slots * size <= pm.MAX_CTA_SMEM)
            assert plan.grid * plan.warps >= B > (plan.grid - 1) * plan.warps


@pytest.mark.cuda
@needs_cuda
def test_layout_mirror_matches_the_kernel_library():
    from mini_opt_tpu_torch.ops import _build

    lib = _build.load_library()
    for T_ in (1, 2, 12, 20, 128, 240, 500):
        for kind, plant in (("cartpole", 0), ("quadrotor", 1)):
            fam = PLAN_FAMILIES[kind](T_, DT)
            assert lib.mo_mpc_scratch_slots(plant, T_) == pm.layout_slots(T_, fam.nx, fam.nu)
