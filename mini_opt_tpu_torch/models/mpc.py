"""Model-predictive control family: cart-pole trajectory optimization, the
port of ``mini_opt_tpu/models/mpc.py``.

* ``make_cartpole_mpc_problem``: direct multiple-shooting transcription of a
  horizon-T cart-pole problem into a ``Problem``: RK4 dynamics defects as
  nonlinear equality constraints (one Residual per step), quadratic
  state-tracking costs (one BlockResidual over the horizon), a control-effort
  cost, and actuation/track limits through the box-constraint DSL.
* ``mpc_rollout`` / ``mpc_rollout_batch``: the receding-horizon servo loop on
  the general solver (``nls_solve``): solve, apply the first control, step the
  plant, shift the solution one step as the next warm start. JAX runs the
  periods as a ``lax.scan`` under ``vmap``; here the fleet is one batch and
  the periods a Python loop.
* ``fused_mpc_rollout_batch``: the same loop on kernel 8, one
  ``fused_mpc_solve_batch`` launch per period (``ops/mpc.py``).

State layout: x = [cart position p, cart velocity v, pole angle theta
(0 = upright), pole rate w]; control u = horizontal force on the cart.
Decision vector z = [u_0..u_{T-1}, x_1..x_T] (dimension 5T). The plant
helpers (``cartpole_xdot``, ``rk4_step``, ``shift_warm_start``,
``initial_guess``) take one instance, as in the JAX package, or a batch
with leading dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.func import jacfwd

from ..nonlinear import NLSParams, Problem, nls_solve
from ..qp import Var
from ..residual import BlockResidual, make_residual
from ..structs import LineSearchStrategy, NLSResult

NX = 4  # state dimension
NU = 1  # control dimension


@dataclasses.dataclass(frozen=True)
class CartPole:
    """Cart-pole plant constants (point-mass pole, frictionless)."""

    mass_cart: float = 1.0
    mass_pole: float = 0.1
    length: float = 0.5
    gravity: float = 9.81


def _as_tensor(a, like=None, device=None):
    if torch.is_tensor(a):
        return a
    from ..convert import _resolve_device

    if like is not None:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return torch.as_tensor(a, device=_resolve_device(device))


def _const(v, like):
    """A Python constant as a 0-dim tensor of ``like``'s dtype. (Under
    ``torch.func.jacfwd`` a Python float times a zero tangent comes out
    float64, which breaks a float32 Jacobian; a tensor constant rounds the
    same and keeps the dtype.)"""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def cartpole_xdot(cp: CartPole, state, u):
    """Continuous dynamics xdot = f(x, u); theta measured from upright.
    ``state (..., 4)``, ``u (...)``."""
    m, M, length, g = (_const(v, state) for v in (cp.mass_pole, cp.mass_cart, cp.length, cp.gravity))
    v, th, w = state[..., 1], state[..., 2], state[..., 3]
    s, c = torch.sin(th), torch.cos(th)
    denom = M + m * s * s
    a = (u + m * s * (length * w * w - g * c)) / denom
    alpha = (g * s - a * c) / length
    return torch.stack([v, a, w, alpha], dim=-1)


def rk4_step(cp: CartPole, state, u, dt: float):
    """One explicit RK4 step of the cart-pole dynamics."""
    hdt, dt_, dt6, two = (_const(v, state) for v in (0.5 * dt, dt, dt / 6.0, 2.0))
    k1 = cartpole_xdot(cp, state, u)
    k2 = cartpole_xdot(cp, state + hdt * k1, u)
    k3 = cartpole_xdot(cp, state + hdt * k2, u)
    k4 = cartpole_xdot(cp, state + dt_ * k3, u)
    return state + dt6 * (k1 + two * k2 + two * k3 + k4)


# ---------------------------------------------------------------------------
# Decision-vector layout.
# ---------------------------------------------------------------------------


def mpc_dimension(horizon: int) -> int:
    return horizon * (NU + NX)


def u_index(t: int) -> int:
    """Global index of u_t, t in [0, T)."""
    return t


def x_indices(horizon: int, t: int) -> Tuple[int, ...]:
    """Global indices of state x_t, t in [1, T]."""
    base = horizon + NX * (t - 1)
    return tuple(range(base, base + NX))


def split_z(z, horizon: int):
    """z (..., 5T) -> (controls (..., T), states (..., T, NX) for t = 1..T)."""
    return z[..., :horizon], z[..., horizon:].reshape(*z.shape[:-1], horizon, NX)


# ---------------------------------------------------------------------------
# Transcription.
# ---------------------------------------------------------------------------


def make_cartpole_mpc_problem(
    cp: CartPole,
    x0,  # (NX,) current plant state of one instance
    horizon: int,
    dt: float,
    u_max: float = 10.0,
    q: Tuple[float, float, float, float] = (1.0, 0.1, 10.0, 0.1),
    q_terminal: Tuple[float, float, float, float] = (10.0, 1.0, 100.0, 1.0),
    r_u: float = 0.01,
    goal=None,
    p_max: Optional[float] = None,
) -> Problem:
    """Direct multiple-shooting transcription over ``horizon`` steps.

    Equality constraints: x_{t+1} - rk4(x_t, u_t) = 0 for t = 0..T-1.
    Costs: sqrt(q)*(x_t - goal) for t = 1..T-1, sqrt(q_terminal)*(x_T -
    goal), sqrt(r_u)*u. Box constraints: |u_t| <= u_max, and |p_t| <= p_max
    (track limits) when given. Constants follow the plant state's dtype and
    device."""
    T = int(horizon)
    dim = mpc_dimension(T)
    kw = dict(dtype=x0.dtype, device=x0.device)
    goal_arr = torch.zeros(NX, **kw) if goal is None else torch.as_tensor(goal, **kw)

    eqs = []
    for t in range(T):
        xi_next = x_indices(T, t + 1)
        if t == 0:
            idx = (u_index(0),) + xi_next

            def defect0(zl, _x0=x0):
                return zl[1:] - rk4_step(cp, _x0.to(zl.dtype), zl[0], dt)

            eqs.append(make_residual(idx, defect0, NX))
        else:
            idx = (u_index(t),) + x_indices(T, t) + xi_next

            def defect(zl):
                return zl[1 + NX :] - rk4_step(cp, zl[1 : 1 + NX], zl[0], dt)

            eqs.append(make_residual(idx, defect, NX))

    w = torch.cat(
        [
            torch.sqrt(torch.as_tensor(q, **kw)).repeat(T - 1, 1),
            torch.sqrt(torch.as_tensor(q_terminal, **kw))[None, :],
        ]
    )  # (T, NX)
    data = torch.cat([w, goal_arr[None, :].repeat(T, 1)], dim=1)
    indices = tuple(x_indices(T, t) for t in range(1, T + 1))

    def track(xl, row):
        return row[:NX] * (xl - row[NX:])

    track_cost = BlockResidual(fn=track, indices=indices, dim=NX, data=data)

    su = float(r_u) ** 0.5

    def effort(ul):
        return su * ul

    effort_cost = make_residual(tuple(range(T)), effort, T)

    ineq = []
    for t in range(T):
        ineq += [Var(u_index(t)) >= -u_max, Var(u_index(t)) <= u_max]
    if p_max is not None:
        for t in range(1, T + 1):
            pi = x_indices(T, t)[0]
            ineq += [Var(pi) >= -p_max, Var(pi) <= p_max]

    return Problem(
        dimension=dim,
        costs=(track_cost, effort_cost),
        equality_constraints=tuple(eqs),
        inequality_constraints=tuple(ineq),
    )


def _jac_in_dtype(fn):
    """A residual's (r, J) with J in the residual's dtype. The family's
    plant and effort rows multiply by Python floats, which under
    ``torch.func.jacfwd`` turn a zero tangent float64 (see ``_const``); the
    Jacobian is cast back to the working dtype."""

    def jac(xl):
        return fn(xl), jacfwd(fn)(xl).to(xl.dtype)

    return jac


def make_family_mpc_problem(fam, x0) -> Problem:
    """Generic direct multiple-shooting transcription for any
    ``ops.mpc.MPCFamily``: the general-path (``nls_solve``) twin of
    ``fused_mpc_solve_batch``. The problem statement of
    ``make_cartpole_mpc_problem`` with the dynamics, dimensions and
    constants read off the family; decision layout [u_0 .. u_{T-1} (nu
    each), x_1 .. x_T]."""
    from ..ops.mpc import _rk4

    T, nx, nu = fam.horizon, fam.nx, fam.nu
    kw = dict(dtype=x0.dtype, device=x0.device)

    def u_idx(t):
        return tuple(range(t * nu, (t + 1) * nu))

    def x_idx(t):  # t in [1, T]
        base = T * nu + nx * (t - 1)
        return tuple(range(base, base + nx))

    eqs = []
    for t in range(T):
        if t == 0:
            idx = u_idx(0) + x_idx(1)

            def defect0(zl, _x0=x0):
                u = [zl[r] for r in range(nu)]
                xp = [_x0[i].to(zl.dtype) for i in range(nx)]
                pred = _rk4(fam, xp, u)
                return torch.stack([zl[nu + i] - pred[i] for i in range(nx)])

            eqs.append(make_residual(idx, defect0, nx, jac=_jac_in_dtype(defect0)))
        else:
            idx = u_idx(t) + x_idx(t) + x_idx(t + 1)

            def defect(zl):
                u = [zl[r] for r in range(nu)]
                xp = [zl[nu + i] for i in range(nx)]
                pred = _rk4(fam, xp, u)
                return torch.stack([zl[nu + nx + i] - pred[i] for i in range(nx)])

            eqs.append(make_residual(idx, defect, nx, jac=_jac_in_dtype(defect)))

    w = torch.cat(
        [
            torch.sqrt(torch.as_tensor(fam.q, **kw)).repeat(T - 1, 1),
            torch.sqrt(torch.as_tensor(fam.q_terminal, **kw))[None, :],
        ]
    )  # (T, nx)
    goal_arr = torch.as_tensor(fam.goal, **kw)
    data = torch.cat([w, goal_arr[None, :].repeat(T, 1)], dim=1)
    indices = tuple(x_idx(t) for t in range(1, T + 1))

    def track(xl, row, _nx=nx):
        return row[:_nx] * (xl - row[_nx:])

    track_cost = BlockResidual(fn=track, indices=indices, dim=nx, data=data)

    su = [float(r) ** 0.5 for r in fam.r_u]
    uref = [float(r) for r in fam.u_ref]

    def effort(ul):
        return torch.stack([su[r] * (ul[t * nu + r] - uref[r]) for t in range(T) for r in range(nu)])

    effort_cost = make_residual(tuple(range(T * nu)), effort, T * nu, jac=_jac_in_dtype(effort))

    ineq = []
    for t in range(T):
        for r in range(nu):
            ineq += [Var(t * nu + r) >= float(fam.u_min[r]), Var(t * nu + r) <= float(fam.u_max[r])]

    return Problem(
        dimension=fam.dim,
        costs=(track_cost, effort_cost),
        equality_constraints=tuple(eqs),
        inequality_constraints=tuple(ineq),
    )


def family_initial_guess(fam, x0):
    """Constant-state cold start for a generic MPCFamily: u = u_ref,
    x_t = x0 (see ``initial_guess`` for why constant beats a rollout).
    ``x0 (..., nx)`` -> ``(..., dim)``."""
    u = torch.as_tensor(fam.u_ref, dtype=x0.dtype, device=x0.device).repeat(fam.horizon)
    u = u.expand(*x0.shape[:-1], -1)
    return torch.cat([u, x0.repeat(*([1] * (x0.dim() - 1)), fam.horizon)], dim=-1)


def family_rk4_step(fam, x, u):
    """One RK4 plant step of a generic family's dynamics; ``x (..., nx)``,
    ``u (..., nu)``."""
    from ..ops.mpc import _rk4

    xs = [x[..., i] for i in range(fam.nx)]
    us = [u[..., i] for i in range(fam.nu)]
    return torch.stack(_rk4(fam, xs, us), dim=-1)


def riccati_kkt_solver(horizon: int) -> str:
    """KKT-solver name for the structured Riccati backend at this horizon
    (``ops/riccati.py``); pass it as ``NLSParams.kkt_solver``
    (``default_mpc_params(horizon=...)`` does it for you)."""
    from ..ops.riccati import solver_name

    return solver_name(horizon, NX, NU)


def default_mpc_params(
    dtype=torch.float32,
    max_iterations: int = 8,
    max_qp_iterations: int = 8,
    early_exit: bool = True,
    horizon: Optional[int] = None,
) -> NLSParams:
    """Solver configuration for the MPC family. float64 gets
    verification-grade tolerances; float32 the serving ladder.
    ``early_exit=False`` is the fixed-trip configuration for batches
    (``mpc_rollout`` forces it). Passing ``horizon`` selects the structured
    Riccati KKT backend."""
    f32 = dtype == torch.float32
    kkt = riccati_kkt_solver(horizon) if horizon else "auto"
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=max_qp_iterations,
        relative_exit_tol=1e-7 if f32 else 1e-12,
        absolute_first_derivative_tol=1e-6 if f32 else 1e-10,
        absolute_exit_tol=1e-8 if f32 else 1e-12,
        termination_kkt_tolerance=1e-5 if f32 else 1e-8,
        max_line_search_iterations=6,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        armijo_search_tau=0.5,
        equality_penalty_initial=1.0,
        lambda_initial=1e-6,
        min_lambda=1e-12,
        lambda_failure_init=1e-3,
        early_exit=early_exit,
        kkt_solver=kkt,
    )


def serving_mpc_params(
    dtype=torch.float32,
    horizon: int = 20,
    warm: Tuple[int, int, int] = (2, 2, 1),
):
    """(params, warm_params) for receding-horizon serving: the full
    verification budget on the cold first period, a lean fixed-trip budget
    at steady state (Riccati KKT backend in both). Pass both to
    ``mpc_rollout(_batch)``."""
    params = default_mpc_params(dtype, early_exit=False, horizon=horizon)
    warm_params = dataclasses.replace(
        params,
        max_iterations=warm[0],
        max_qp_iterations=warm[1],
        max_line_search_iterations=warm[2],
    )
    return params, warm_params


def initial_guess(cp: CartPole, x0, horizon: int, dt: float):
    """Constant-state cold start: u = 0, x_t = x0 for all t;
    ``x0 (..., NX)`` -> ``(..., 5T)``.

    Deliberately not the zero-control rollout: rolling the plant forward
    lets the pole fall across the horizon, and the tracking cost along that
    fallen trajectory creates a curved valley the SQP crawls through. The
    constant guess keeps costs small and its defects (one-step drift) are
    killed in the first SQP step."""
    del cp, dt
    lead = x0.shape[:-1]
    return torch.cat(
        [x0.new_zeros(*lead, horizon), x0.repeat(*([1] * len(lead)), horizon)], dim=-1
    )


def solve_mpc(
    cp: CartPole,
    x0,
    horizon: int,
    dt: float,
    params: Optional[NLSParams] = None,
    z0=None,
    device=None,
    **problem_kwargs,
) -> NLSResult:
    """Solve trajectory-optimization instances on the general path:
    ``x0 (NX,)`` is one instance, ``x0 (B, NX)`` a batch solved by one
    batched ``nls_solve``. The result's leaves have the leading batch
    dimension, as every result of the port's ``nls_solve`` has. numpy
    inputs go to ``device`` ("cuda" unless the caller passes "cpu")."""
    x0 = _as_tensor(x0, device=device)
    xb = x0[None] if x0.dim() == 1 else x0
    if params is None:
        params = default_mpc_params(x0.dtype)
    zb = initial_guess(cp, xb, horizon, dt) if z0 is None else _as_tensor(z0, like=xb).reshape(xb.shape[0], -1)

    def problem_fn(x_row):
        return make_cartpole_mpc_problem(cp, x_row, horizon, dt, **problem_kwargs)

    return nls_solve(problem_fn, params, zb, data=xb)


# ---------------------------------------------------------------------------
# Receding-horizon servo loop.
# ---------------------------------------------------------------------------


def shift_warm_start(cp: CartPole, z, horizon: int, dt: float):
    """Shift a solved trajectory one control period: u_t <- u_{t+1} (last
    repeated), x_t <- x_{t+1}, new terminal state integrated from the last
    shifted pair. ``z (..., 5T)``."""
    u, X = split_z(z, horizon)
    u_next = torch.cat([u[..., 1:], u[..., -1:]], dim=-1)
    x_term = rk4_step(cp, X[..., -1, :], u_next[..., -1], dt)
    X_next = torch.cat([X[..., 1:, :], x_term[..., None, :]], dim=-2)
    return torch.cat([u_next, X_next.reshape(*z.shape[:-1], -1)], dim=-1)


def _rollout(cp, x_init, n_steps, horizon, dt, params, disturbance, warm_params, problem_kwargs):
    """The fleet's receding-horizon loop on nls_solve: (states (B, n+1, NX),
    controls (B, n), merits (B, n), termination states (B, n))."""
    if params is None:
        params = default_mpc_params(x_init.dtype, early_exit=False)
    params = dataclasses.replace(params, early_exit=False)
    if warm_params is not None:
        warm_params = dataclasses.replace(warm_params, early_exit=False)
    dist = x_init.new_zeros(n_steps) if disturbance is None else _as_tensor(disturbance, like=x_init)

    def problem_fn(x_row):
        return make_cartpole_mpc_problem(cp, x_row, horizon, dt, **problem_kwargs)

    x, z = x_init, initial_guess(cp, x_init, horizon, dt)
    us, xs, merits, terms = [], [], [], []
    for k in range(n_steps):
        prm = params if (k == 0 or warm_params is None) else warm_params
        res = nls_solve(problem_fn, prm, z, data=x)
        u0 = res.x[:, 0]
        x = rk4_step(cp, x, u0 + dist[k], dt)
        z = shift_warm_start(cp, res.x, horizon, dt)
        us.append(u0)
        xs.append(x)
        merits.append(res.errors.f + res.errors.equality)
        terms.append(res.termination_state)
    return (
        torch.stack([x_init] + xs, dim=1),
        torch.stack(us, dim=1),
        torch.stack(merits, dim=1),
        torch.stack(terms, dim=1),
    )


def mpc_rollout(
    cp: CartPole,
    x_init,  # (NX,)
    n_steps: int,
    horizon: int,
    dt: float,
    params: Optional[NLSParams] = None,
    disturbance=None,  # (n_steps,) extra force on the plant
    warm_params: Optional[NLSParams] = None,
    device=None,
    **problem_kwargs,
):
    """Receding-horizon control for ``n_steps`` periods. Each period: solve
    the horizon problem from the current plant state (warm-started with the
    previous solution shifted one step), apply u_0 to the plant (plus the
    optional disturbance force), advance. Fixed-trip solver budgets
    (``early_exit`` is forced off). ``warm_params``: an optional leaner
    budget for periods 1..n-1.

    Returns (states (n_steps+1, NX), controls (n_steps,), solve_merit
    (n_steps,), term_states (n_steps,) int32)."""
    x_init = _as_tensor(x_init, device=device)
    out = _rollout(cp, x_init[None], n_steps, horizon, dt, params, disturbance, warm_params, problem_kwargs)
    return tuple(a[0] for a in out)


def mpc_rollout_batch(
    cp: CartPole,
    x_init,  # (B, NX)
    n_steps: int,
    horizon: int,
    dt: float,
    params: Optional[NLSParams] = None,
    warm_params: Optional[NLSParams] = None,
    device=None,
    **problem_kwargs,
):
    """A fleet of independent plants: ``mpc_rollout`` for every row of
    ``x_init``, solved as one batch per period. Returns (states (B, n+1,
    NX), controls (B, n), merits (B, n), term_states (B, n))."""
    x_init = _as_tensor(x_init, device=device)
    return _rollout(cp, x_init, n_steps, horizon, dt, params, None, warm_params, problem_kwargs)


# ---------------------------------------------------------------------------
# Linearization and the LQR oracle; the implicit policy gradient.
# ---------------------------------------------------------------------------


def linearized_dynamics(cp: CartPole, x_op, u_op, dt: float):
    """(A, B) of the discrete dynamics x+ = rk4(x, u) at an operating
    point."""
    u_op = torch.as_tensor(u_op, dtype=x_op.dtype, device=x_op.device)
    A = jacfwd(lambda x: rk4_step(cp, x, u_op, dt))(x_op)
    B = jacfwd(lambda u: rk4_step(cp, x_op, u, dt))(u_op)
    return A, B.reshape(NX, NU)


def finite_horizon_lqr_gain(
    cp: CartPole,
    horizon: int,
    dt: float,
    q: Tuple[float, float, float, float] = (1.0, 0.1, 10.0, 0.1),
    q_terminal: Tuple[float, float, float, float] = (10.0, 1.0, 100.0, 1.0),
    r_u: float = 0.01,
):
    """First-period feedback gain K_0 of the finite-horizon LQR matching the
    MPC transcription at the upright equilibrium (float64): u_0* = -K_0 x_0
    for min sum_{t=1}^{T-1} x_t'Qx_t + x_T'Q_T x_T + sum_t r u_t^2 with
    x+ = A x + B u (the RK4 dynamics linearized at the origin)."""
    A, B = linearized_dynamics(cp, torch.zeros(NX, dtype=torch.float64), 0.0, dt)
    Q = torch.diag(torch.as_tensor(q, dtype=A.dtype))
    R = torch.as_tensor([[r_u]], dtype=A.dtype)
    P = torch.diag(torch.as_tensor(q_terminal, dtype=A.dtype))
    K = None
    for t in range(horizon - 1, -1, -1):
        K = torch.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)  # (NU, NX)
        Qt = Q if t >= 1 else torch.zeros_like(Q)
        P = Qt + A.T @ P @ (A - B @ K)
    return K


def make_implicit_mpc_solver(cp: CartPole, horizon: int, dt: float, params: Optional[NLSParams] = None,
                             active_tol: float = 1.0e-6, **problem_kwargs):
    """``solve(x_plant (B, NX), z0 (B, 5T)) -> z*`` differentiable in the
    PLANT STATE through the KKT conditions at the solution
    (``implicit.make_implicit_solver``: exact at a converged point, one
    linear solve per lane in the backward pass whatever the forward
    iteration count, active-set handling for saturated actuation). The
    policy ``u_0(x_plant)`` is then a differentiable function; its
    derivative is the local feedback gain (``mpc_feedback_gain``)."""
    from ..implicit import make_implicit_solver

    if params is None:
        params = default_mpc_params(torch.float64)

    def problem_fn(x_plant):
        return make_cartpole_mpc_problem(cp, x_plant, horizon, dt, **problem_kwargs)

    return make_implicit_solver(problem_fn, params, active_tol=active_tol)


def mpc_feedback_gain(cp: CartPole, x_op, horizon: int, dt: float, params: Optional[NLSParams] = None,
                      device=None, **problem_kwargs):
    """du_0/dx_plant of the MPC policy at ``x_op``: ``(NX,)`` for one plant
    state, ``(B, NX)`` for a batch (one backward pass: u_0 is one scalar a
    lane), the local feedback gain the receding-horizon controller
    realizes. At the upright equilibrium it equals -K_0 of
    :func:`finite_horizon_lqr_gain`; away from it (or with active actuation
    limits) it is the exact derivative of the branch the solver landed on.
    numpy inputs go to ``device`` ("cuda" unless the caller passes "cpu")."""
    x_op = _as_tensor(x_op, device=device)
    xb = (x_op[None] if x_op.dim() == 1 else x_op).detach().requires_grad_(True)
    solve = make_implicit_mpc_solver(cp, horizon, dt, params=params, **problem_kwargs)
    z0 = initial_guess(cp, xb.detach(), horizon, dt)
    with torch.enable_grad():
        u0 = solve(xb, z0)[:, u_index(0)]
        (gain,) = torch.autograd.grad(u0.sum(), xb)
    return gain[0] if x_op.dim() == 1 else gain


# ---------------------------------------------------------------------------
# The fleet on kernel 8.
# ---------------------------------------------------------------------------


def fused_mpc_rollout_batch(
    cp: CartPole,
    x_init,  # (B, NX)
    n_steps: int,
    horizon: int,
    dt: float,
    budget: Tuple[int, int, int] = (2, 2, 1),
    cold_budget: Optional[Tuple[int, int, int]] = (8, 3, 2),
    disturbance=None,  # (n_steps,)
    backend: str = "pallas",
    u_max: float = 10.0,
    q: Tuple[float, float, float, float] = (1.0, 0.1, 10.0, 0.1),
    q_terminal: Tuple[float, float, float, float] = (10.0, 1.0, 100.0, 1.0),
    r_u: float = 0.01,
    device=None,
):
    """Receding-horizon control of a plant fleet on kernel 8: every period
    solves the whole fleet with one ``fused_mpc_solve_batch`` launch. The
    cold first period runs ``cold_budget``, steady state the lean
    ``budget``; solutions shift one step between periods.

    Returns (states (n_steps+1, B, NX), controls (n_steps, B), state (B, 3)
    = per-lane (f, |eq|_1, flags) of the last period's solve)."""
    from ..ops.mpc import cartpole_mpc_family, fused_mpc_solve_batch

    x_init = _as_tensor(x_init, device=device)
    fam = cartpole_mpc_family(
        horizon, float(dt), u_max=float(u_max), q=tuple(q), q_terminal=tuple(q_terminal), r_u=float(r_u),
        mass_cart=cp.mass_cart, mass_pole=cp.mass_pole, length=cp.length, gravity=cp.gravity,
    )
    dist = x_init.new_zeros(n_steps) if disturbance is None else _as_tensor(disturbance, like=x_init)

    x, z = x_init, initial_guess(cp, x_init, horizon, dt)
    states, us, state = [x_init], [], None
    for k in range(n_steps):
        bud = (cold_budget if cold_budget else budget) if k == 0 else budget
        z, state = fused_mpc_solve_batch(
            fam, x, z, max_iterations=bud[0], qp_iterations=bud[1], ls_iterations=bud[2],
            return_state=True, backend=backend,
        )
        u0 = z[:, 0]
        x = rk4_step(cp, x, u0 + dist[k], dt)
        z = shift_warm_start(cp, z, horizon, dt)
        states.append(x)
        us.append(u0)
    return torch.stack(states), torch.stack(us), state
