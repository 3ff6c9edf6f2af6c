"""Dense QP layer: problem definition, interior-point and null-space
solvers, the port of ``mini_opt_tpu/qp.py``.

Batch-first: every tensor of a ``QP`` carries a leading batch dimension B,
and one call solves all B instances, so that each KKT factorization and
each solve is one batched call (one kernel launch on the ``"pallas_ldlt"``
backend) per iteration. ``ineq_var`` is the exception: the constraint
structure is static and shared by the lanes, an ``(M,)`` integer tensor.

``bounded_loop`` runs a masked loop, as JAX's ``vmap`` of a ``while_loop``
computes it: each lane's carry freezes once its ``cond`` is false. So
``early_exit`` changes how many trips run, never a lane's result: with it
the loop stops once no lane is active (one host read per trip), without it
every trip runs.

Algorithmic source: Nocedal & Wright, Numerical Optimization 2nd ed.,
chapters 16/19, as the reference (qp.hpp:8-16).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from .ops import kkt as kkt_ops
from .structs import (
    AlphaValues,
    BarrierStrategy,
    InitialGuessMethod,
    KKTError,
    QPIPResult,
    QPIterationHistory,
    QPLagrangeMultipliers,
    QPNullSpaceResult,
    QPNullSpaceTerminationState,
    QPTerminationState,
    tree_map,
)
from .utils.tracing import traced_phase

# ---------------------------------------------------------------------------
# Constraint DSL.
# ---------------------------------------------------------------------------


class LinearInequalityConstraint(NamedTuple):
    """Diagonal/affine inequality ``a * x[variable] + b >= 0``
    (qp.hpp:28-70). ``a``/``b`` may be Python floats or tensors."""

    variable: int
    a: float
    b: float

    def is_feasible(self, x_var):
        return torch.as_tensor(self.a * x_var + self.b >= 0.0)

    def clamp_x(self, x_var):
        """Clamp a value into the feasible half-line (qp.hpp:43-53)."""
        a = torch.as_tensor(self.a)
        return torch.where(
            a < 0,
            torch.minimum(x_var, torch.as_tensor(self.b / -self.a)),
            torch.maximum(x_var, torch.as_tensor(-self.b / self.a)),
        )

    def shift_to(self, x_var) -> "LinearInequalityConstraint":
        """Shift to a new linearization point (qp.hpp:57-59)."""
        return LinearInequalityConstraint(self.variable, self.a, self.a * x_var + self.b)


class Var:
    """Sugar: ``Var(i) >= alpha`` / ``Var(i) <= alpha`` (qp.hpp:77-92)."""

    def __init__(self, variable: int):
        self.variable = int(variable)

    def __ge__(self, value) -> LinearInequalityConstraint:
        return LinearInequalityConstraint(self.variable, 1.0, -value)

    def __le__(self, value) -> LinearInequalityConstraint:
        return LinearInequalityConstraint(self.variable, -1.0, value)


# ---------------------------------------------------------------------------
# The batched QP.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QP:
    """B dense QPs ``min 0.5 x^T G x + c^T x`` s.t. ``A_eq x + b_eq = 0`` and
    ``ineq_a * x[ineq_var] + ineq_b >= 0`` (qp.hpp:94-124)."""

    G: torch.Tensor  # (B, N, N), symmetric
    c: torch.Tensor  # (B, N)
    A_eq: torch.Tensor  # (B, K, N)
    b_eq: torch.Tensor  # (B, K)
    ineq_var: torch.Tensor  # (M,) int64, shared by the lanes
    ineq_a: torch.Tensor  # (B, M)
    ineq_b: torch.Tensor  # (B, M)

    @property
    def N(self) -> int:
        return self.G.shape[-1]

    @property
    def K(self) -> int:
        return self.A_eq.shape[-2]

    @property
    def M(self) -> int:
        return self.ineq_var.shape[-1]

    @staticmethod
    def create(
        G, c, A_eq=None, b_eq=None, constraints: Sequence[LinearInequalityConstraint] = (), dtype=None
    ) -> "QP":
        """From batch-first ``G (B, N, N)``, ``c (B, N)`` and optional
        ``A_eq (B, K, N)``, ``b_eq (B, K)``; each constraint's ``a`` and ``b``
        a float or a ``(B,)`` tensor."""
        G = torch.as_tensor(G, dtype=dtype)
        kw = dict(dtype=G.dtype, device=G.device)
        c = torch.as_tensor(c, **kw)
        B, n = G.shape[0], G.shape[-1]
        if A_eq is None:
            A_eq = torch.zeros((B, 0, n), **kw)
            b_eq = torch.zeros((B, 0), **kw)
        else:
            A_eq, b_eq = torch.as_tensor(A_eq, **kw), torch.as_tensor(b_eq, **kw)

        def col(v):
            return torch.as_tensor(v, **kw).expand(B)

        ineq_var = torch.tensor([cst.variable for cst in constraints], dtype=torch.long, device=G.device)
        if constraints:
            ineq_a = torch.stack([col(cst.a) for cst in constraints], dim=1)
            ineq_b = torch.stack([col(cst.b) for cst in constraints], dim=1)
        else:
            ineq_a = ineq_b = torch.zeros((B, 0), **kw)
        return QP(G, c, A_eq, b_eq, ineq_var, ineq_a, ineq_b)

    def eigenvalue_stats(self):
        """Per-lane min / max / abs-min eigenvalues of G (qp.cc:12-16)."""
        w = torch.linalg.eigvalsh(self.G)
        return w.amin(-1), w.amax(-1), w.abs().amin(-1)


# ---------------------------------------------------------------------------
# Interior-point solver.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QPInteriorPointParams:
    """Static solver config; analog of QPInteriorPointSolver::Params
    (qp.hpp:134-164), with the JAX package's fields and defaults."""

    initial_mu: float = 1.0
    sigma: float = 0.5
    termination_kkt_tol: float = 1.0e-9
    termination_complementarity_tol: float = 1.0e-6
    max_iterations: int = 10
    barrier_strategy: BarrierStrategy = BarrierStrategy.COMPLEMENTARITY
    decrease_mu_only_on_small_error: bool = False
    initial_guess_method: InitialGuessMethod = InitialGuessMethod.NAIVE
    initialize_mu_with_complementarity: bool = False
    # One of ops.kkt.SOLVERS; "auto" is "lu" (see ops/kkt.py).
    kkt_solver: str = "auto"
    # False drops the per-iteration telemetry buffers.
    record_history: bool = True
    # False runs every trip of the masked loop; None = True (see
    # resolve_early_exit). Changes no lane's result.
    early_exit: Optional[bool] = None
    # The JAX package's scan unroll factor; accepted and unused (PyTorch
    # runs eagerly).
    unroll: int = 1

    def __post_init__(self):
        # Eager validation, mirroring CheckParams (qp.cc:76-82).
        assert self.initial_mu > 0
        assert 0 < self.sigma <= 1.0
        assert self.termination_kkt_tol > 0
        assert self.max_iterations > 0
        assert kkt_ops.is_valid_solver(self.kkt_solver), self.kkt_solver


class _IPState(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _mv(A, v):
    """Batched matrix-vector product (B, R, C) @ (B, C) -> (B, R)."""
    return torch.matmul(A, v[..., None])[..., 0]


def _mtv(A, v):
    """Batched A^T v: (B, R, C), (B, R) -> (B, C)."""
    return torch.matmul(A.transpose(-1, -2), v[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _ineq_matrix(qp: QP):
    """Dense (B, M, N) inequality matrix with A_i[m, ineq_var[m]] = ineq_a[m],
    built by comparison with a range (qp.py:211-223)."""
    onehot = (
        torch.arange(qp.N, device=qp.G.device)[None, :] == qp.ineq_var[:, None]
    ).to(qp.G.dtype)
    return onehot * qp.ineq_a[..., None]


def recommended_kkt_solver() -> str:
    """The solver ``kkt_solver="auto"`` resolves to here: 'lu'."""
    return kkt_ops.resolve_solver("auto")


def resolve_early_exit(early_exit: Optional[bool]) -> bool:
    """``None`` resolves as the JAX package resolves it off a TPU: True.
    Off a TPU JAX runs a data-dependent ``while_loop``; here that is the
    masked loop stopping once no lane is active."""
    return True if early_exit is None else early_exit


def _where_lane(keep, new, old):
    return torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def bounded_loop(cond, body, init, max_trips: int, early_exit: Optional[bool], unroll: int = 1):
    """At most ``max_trips`` trips of ``body``; each lane's carry freezes
    once its ``cond`` (a ``(B,)`` bool) is false. With ``early_exit`` the
    loop stops as soon as no lane is active; without it every trip runs.
    Either way a lane's result is the same. ``unroll`` is accepted for the
    JAX signature and unused."""
    del unroll
    early_exit = resolve_early_exit(early_exit)
    carry = init
    for _ in range(max_trips):
        keep = cond(carry)
        if early_exit and not bool(keep.any()):
            break
        carry = tree_map(lambda old, nv: _where_lane(keep, nv, old), carry, body(carry))
    return carry


def _set_row(buf, i, v):
    """``buf[b, i[b]] = v[b]`` for each lane b, functionally; lanes with
    ``i`` out of range keep their row."""
    rows = torch.arange(buf.shape[1], device=buf.device) == i[:, None]  # (B, R)
    rows = rows.view(rows.shape + (1,) * (buf.dim() - 2))
    return torch.where(rows, v[:, None].to(buf.dtype), buf)


def _get_row(buf, i):
    """``buf[b, i[b]]`` for each lane b."""
    idx = i.long().view((-1, 1) + (1,) * (buf.dim() - 2)).expand((-1, 1) + buf.shape[2:])
    return torch.gather(buf, 1, idx)[:, 0]


def _kkt_conditions(qp: QP, st: _IPState, include_inequalities: bool = True):
    """First-order KKT residuals, eqs 19.2a-d with mu = 0 (qp.cc:391-420):
    (r_d (B, N), r_comp (B, M), r_pe (B, K), r_pi (B, M))."""
    r_d = _mv(qp.G, st.x) + qp.c
    if qp.K > 0:
        r_d = r_d - _mtv(qp.A_eq, st.y)
        r_pe = _mv(qp.A_eq, st.x) + qp.b_eq
    else:
        r_pe = st.x[:, :0]
    if include_inequalities and qp.M > 0:
        A_i = _ineq_matrix(qp)
        r_d = r_d - _mtv(A_i, st.z)
        r_pi = _mv(A_i, st.x) + qp.ineq_b - st.s
        r_comp = st.s * st.z
    else:
        r_pi = torch.zeros_like(qp.ineq_b)
        r_comp = torch.zeros_like(qp.ineq_b)
    return r_d, r_comp, r_pe, r_pi


def _safe_norm(v):
    """L2 norm over the last axis with the JAX package's tiny floor."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + torch.finfo(v.dtype).tiny)


def _kkt_errors(r_d, r_comp, r_pe, r_pi, mu, M: int) -> KKTError:
    """L2 norms of the KKT residuals with the mu-corrected complementarity
    term (qp.cc:423-437)."""
    zero = torch.zeros_like(r_d[:, 0])
    r_dual = _safe_norm(r_d)
    r_primal_eq = _safe_norm(r_pe) if r_pe.shape[-1] > 0 else zero
    if M > 0:
        corrected = (
            torch.sum(r_comp * r_comp, -1) - 2.0 * torch.sum(r_comp, -1) * mu + mu * mu * M
        )
        r_comp_n = torch.sqrt(torch.clamp_min(corrected, torch.finfo(r_d.dtype).tiny))
        r_primal_ineq = _safe_norm(r_pi)
    else:
        r_comp_n = zero
        r_primal_ineq = zero
    return KKTError(r_dual, r_comp_n, r_primal_eq, r_primal_ineq)


def _build_condensed(qp: QP, st: _IPState, include_inequalities: bool):
    """Condensed (B, N+K, N+K) KKT matrix (qp.cc:228-298):
    ``[[G + A_i^T Sigma A_i, A_eq^T], [A_eq, 0]]``, Sigma = diag(z/s)."""
    G = qp.G
    if include_inequalities and qp.M > 0:
        A_i = _ineq_matrix(qp)
        G = G + torch.matmul(A_i.transpose(-1, -2), (st.z / st.s)[..., None] * A_i)
    if qp.K == 0:
        return G
    zero_kk = torch.zeros((G.shape[0], qp.K, qp.K), dtype=G.dtype, device=G.device)
    top = torch.cat([G, qp.A_eq.transpose(-1, -2)], dim=2)
    bottom = torch.cat([qp.A_eq, zero_kk], dim=2)
    return torch.cat([top, bottom], dim=1)


def _solve_condensed(fact, r_dual_aug, r_pe, N: int, K: int, solver: str):
    """Solve the condensed system for (dx, dy), the reference's sign
    convention (qp.cc:318-364)."""
    rhs = torch.cat([-r_dual_aug, -r_pe], dim=-1) if K > 0 else -r_dual_aug
    sol = kkt_ops.kkt_solve(fact, rhs, solver)
    dx = sol[:, :N]
    dy = -sol[:, N:] if K > 0 else sol[:, :0]
    return dx, dy


def _solve_for_update(qp: QP, st: _IPState, fact, r, mu, delta_affine, solver: str):
    """SolveForUpdate analog (qp.cc:318-364): eliminate the inequality rows,
    solve the condensed system, back-substitute (ds, dz)."""
    r_d, r_comp, r_pe, r_pi = r
    ds_aff, dz_aff = delta_affine
    N, K, M = qp.N, qp.K, qp.M
    mu = mu[:, None] if torch.is_tensor(mu) and mu.dim() == 1 else mu
    r_dual_aug = r_d
    if M > 0:
        A_i = _ineq_matrix(qp)
        zs = st.z / st.s
        contrib = zs * r_pi + (r_comp + ds_aff * dz_aff - mu) / st.s
        r_dual_aug = r_dual_aug + _mtv(A_i, contrib)
    dx, dy = _solve_condensed(fact, r_dual_aug, r_pe, N, K, solver)
    if M > 0:
        ds = _mv(A_i, dx) + r_pi
        dz = -(st.z / st.s) * ds - (r_comp + ds_aff * dz_aff - mu) / st.s
    else:
        ds = dz = torch.zeros_like(r_pi)
    return _IPState(dx, ds, dy, dz)


def _compute_alpha_vec(val, d_val, tau):
    """Fraction-to-boundary rule, formula 19.9 (qp.cc:491-507): the largest
    alpha <= 1 with val + alpha*d_val >= (1 - tau) * val, per lane."""
    one = torch.ones_like(val[:, 0])
    if val.shape[-1] == 0:
        return one
    blocking = (val + d_val <= 0.0) & (torch.abs(d_val) > 0.0)
    candidate = -tau * val / torch.where(blocking, d_val, torch.ones_like(d_val))
    return torch.minimum(one, torch.where(blocking, candidate, torch.ones_like(val)).amin(-1))


def _compute_alpha(st: _IPState, delta: _IPState, tau) -> AlphaValues:
    return AlphaValues(
        primal=_compute_alpha_vec(st.s, delta.s, tau),
        dual=_compute_alpha_vec(st.z, delta.z, tau),
    )


def _compute_mu(st: _IPState, M: int):
    """Average complementarity, eq 19.19 (qp.cc:509-516)."""
    if M == 0:
        return torch.zeros_like(st.x[:, 0])
    return _dot(st.s, st.z) / M


def _mu_affine(st: _IPState, delta_aff: _IPState, mu, alpha_probe: AlphaValues, M: int):
    """Predictor-corrector mu_affine, eq 19.22 (qp.cc:519-537)."""
    mu_aff = (
        mu
        + alpha_probe.dual * _dot(st.s, delta_aff.z) / M
        + alpha_probe.primal * _dot(st.z, delta_aff.s) / M
        + alpha_probe.dual * alpha_probe.primal * _dot(delta_aff.s, delta_aff.z) / M
    )
    return torch.clamp_min(mu_aff, 0.0)


def _clamp_feasible(qp: QP, x):
    """Clamp x[var] into each constraint's feasible half-line
    (qp.cc:463-467), as one additive one-hot update."""
    if qp.M == 0:
        return x
    A_i = _ineq_matrix(qp)
    t = _mv(A_i, x) + qp.ineq_b
    shift = torch.where(t < 0.0, -t / qp.ineq_a, torch.zeros_like(t))
    onehot = (A_i != 0.0).to(x.dtype)
    return x + _mtv(onehot, shift)


def _initial_sz(qp: QP, x):
    """Slack/dual heuristic s = max(1e-9, a*x+b), z = 1/s (qp.cc:469-481)."""
    if qp.M == 0:
        e = torch.zeros_like(qp.ineq_b)
        return e, e
    s = torch.clamp_min(_mv(_ineq_matrix(qp), x) + qp.ineq_b, 1.0e-9)
    return s, 1.0 / s


def _all_finite(v):
    return torch.isfinite(v).all(-1)


def _compute_initial_guess(qp: QP, params: QPInteriorPointParams, x0: Optional[_IPState]):
    """ComputeInitialGuess analog (qp.cc:439-482): (state, ok (B,))."""
    B, N, K = qp.G.shape[0], qp.N, qp.K
    kw = dict(dtype=qp.G.dtype, device=qp.G.device)
    ok = torch.ones(B, dtype=torch.bool, device=qp.G.device)
    if params.initial_guess_method == InitialGuessMethod.USER_PROVIDED:
        assert x0 is not None, "USER_PROVIDED requires an initial state"
        return x0, ok
    x = torch.zeros((B, N), **kw)
    y = torch.zeros((B, K), **kw)
    if params.initial_guess_method == InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED:
        zm = torch.zeros_like(qp.ineq_b)
        st0 = _IPState(x, zm, y, zm)
        H = _build_condensed(qp, st0, include_inequalities=False)
        fact, fac_ok = kkt_ops.kkt_factorize(H, params.kkt_solver)
        r_d, _, r_pe, _ = _kkt_conditions(qp, st0, include_inequalities=False)
        dx, dy = _solve_condensed(fact, r_d, r_pe, N, K, params.kkt_solver)
        good = fac_ok & _all_finite(dx) & _all_finite(dy)
        x = _where_lane(good, dx, x)
        y = _where_lane(good, dy, y)
        ok = ok & good
    x = _clamp_feasible(qp, x)
    s, z = _initial_sz(qp, x)
    return _IPState(x, s, y, z), ok


class _IPCarry(NamedTuple):
    st: _IPState
    mu: torch.Tensor
    it: torch.Tensor  # int32 iterations completed
    status: torch.Tensor  # int32, -1 = running
    history: Optional[QPIterationHistory]


def _i32(v, like):
    return torch.full(like.shape, int(v), dtype=torch.int32, device=like.device)


@traced_phase("QPInteriorPointSolve")
def qp_ip_solve(
    qp: QP,
    params: QPInteriorPointParams = QPInteriorPointParams(),
    x0=None,
    s0=None,
    y0=None,
    z0=None,
) -> QPIPResult:
    """Primal-dual interior-point solve of B QPs (qp.cc:100-201).

    Per iteration: KKT residuals, the condensed factorization (one batched
    call), the step (complementarity, fixed decrease or Mehrotra
    predictor-corrector), fraction-to-boundary with tau = 0.995, and the
    update of (x, s, y, z), in a masked loop (``bounded_loop``).
    """
    B = qp.G.shape[0]
    kw = dict(dtype=qp.G.dtype, device=qp.G.device)
    N, M, K = qp.N, qp.M, qp.K
    has_ineq = M > 0
    lane = torch.zeros(B, **kw)

    user_state = None
    guess_feasible = torch.ones(B, dtype=torch.bool, device=qp.G.device)
    if params.initial_guess_method == InitialGuessMethod.USER_PROVIDED:
        def given(v, width):
            return torch.as_tensor(v, **kw) if v is not None else torch.zeros((B, width), **kw)

        user_state = _IPState(given(x0, N), given(s0, M), given(y0, K), given(z0, M))
        if M > 0:
            # The barrier terms divide by s and assume s, z > 0; a lane that
            # violates it ends with INFEASIBLE_GUESS (qp.hpp:326-328).
            guess_feasible = (user_state.s > 0).all(-1) & (user_state.z > 0).all(-1)

    st, guess_ok = _compute_initial_guess(qp, params, user_state)
    mu0 = (
        _compute_mu(st, M)
        if params.initialize_mu_with_complementarity
        else torch.full((B,), params.initial_mu, **kw)
    )

    def iterate(st: _IPState, mu):
        """One interior-point step (qp.cc:153-201): (new_state, record, ok)."""
        r = _kkt_conditions(qp, st)
        H = _build_condensed(qp, st, include_inequalities=True)
        fact, ok = kkt_ops.kkt_factorize(H, params.kkt_solver)
        zeros_aff = (torch.zeros_like(qp.ineq_b), torch.zeros_like(qp.ineq_b))
        # 0 = "not computed" sentinel, as the JAX package records it.
        alpha_probe = AlphaValues(lane, lane)
        mu_aff = lane
        mu_used = mu
        if not has_ineq:
            delta = _solve_for_update(qp, st, fact, r, lane, zeros_aff, params.kkt_solver)
        elif params.barrier_strategy != BarrierStrategy.PREDICTOR_CORRECTOR:
            delta = _solve_for_update(qp, st, fact, r, mu_used, zeros_aff, params.kkt_solver)
        else:
            # Mehrotra predictor-corrector, algorithm 16.4 (qp.cc:170-188).
            delta_aff = _solve_for_update(qp, st, fact, r, lane, zeros_aff, params.kkt_solver)
            alpha_probe = _compute_alpha(st, delta_aff, torch.ones_like(lane)[:, None])
            mu_aff = _mu_affine(st, delta_aff, mu, alpha_probe, M)
            ratio = mu_aff / mu
            mu_used = ratio * (ratio * ratio) * mu  # eq 19.22, (mu_aff / mu) ** 3
            delta = _solve_for_update(
                qp, st, fact, r, mu_used, (delta_aff.s, delta_aff.z), params.kkt_solver
            )
        ok = ok & _all_finite(delta.x) & _all_finite(delta.y)
        if has_ineq:
            ok = ok & _all_finite(delta.s) & _all_finite(delta.z)
            alpha = _compute_alpha(st, delta, 0.995)
        else:
            alpha = AlphaValues(torch.ones_like(lane), torch.ones_like(lane))
        ap, ad = alpha.primal[:, None], alpha.dual[:, None]
        new_st = _IPState(st.x + delta.x * ap, st.s + delta.s * ap, st.y + delta.y * ad, st.z + delta.z * ad)
        # Freeze the state where the factorization failed.
        new_st = tree_map(lambda a, b: _where_lane(ok, a, b), new_st, st)
        return new_st, (mu_used, alpha, alpha_probe, mu_aff), ok

    def cond(carry: _IPCarry):
        return (carry.status < 0) & (carry.it < params.max_iterations)

    def body(carry: _IPCarry):
        st0_, mu, i = carry.st, carry.mu, carry.it
        kkt_prev = _kkt_errors(*_kkt_conditions(qp, st0_), mu, M)
        st1, (mu_used, alpha, alpha_probe, mu_aff), ok = iterate(st0_, mu)
        # Termination and the barrier gate read the incoming loop mu, not
        # the Mehrotra-adjusted mu_used (qp.cc:117-128).
        kkt_after = _kkt_errors(*_kkt_conditions(qp, st1), mu, M)

        h = carry.history
        if params.record_history:
            h = QPIterationHistory(
                kkt_initial=tree_map(lambda buf, v: _set_row(buf, i, v), h.kkt_initial, kkt_prev),
                kkt_final=tree_map(lambda buf, v: _set_row(buf, i, v), h.kkt_final, kkt_after),
                mu=_set_row(h.mu, i, mu_used),
                alpha=tree_map(lambda buf, v: _set_row(buf, i, v), h.alpha, alpha),
                alpha_probe=tree_map(lambda buf, v: _set_row(buf, i, v), h.alpha_probe, alpha_probe),
                mu_affine=_set_row(h.mu_affine, i, mu_aff),
            )

        comp = _compute_mu(st1, M)
        converged = (kkt_after.max() < params.termination_kkt_tol) & (
            comp < params.termination_complementarity_tol
        )
        status = torch.where(
            ~ok,
            _i32(QPTerminationState.FAILED_FACTORIZATION, i),
            torch.where(converged, _i32(QPTerminationState.SATISFIED_KKT_TOL, i), _i32(-1, i)),
        )
        # Barrier update (qp.cc:140-146).
        may_decrease = (kkt_after.max() <= mu) | (not params.decrease_mu_only_on_small_error)
        if params.barrier_strategy == BarrierStrategy.FIXED_DECREASE:
            mu_next = torch.where(may_decrease, mu * params.sigma, mu)
        else:
            mu_next = torch.where(may_decrease, params.sigma * comp, mu)
        return _IPCarry(st1, mu_next, i + 1, status, h)

    it0 = torch.zeros(B, dtype=torch.int32, device=qp.G.device)
    init = _IPCarry(
        st=st,
        mu=mu0,
        it=it0,
        status=torch.where(
            guess_feasible,
            torch.where(guess_ok, _i32(-1, it0), _i32(QPTerminationState.FAILED_FACTORIZATION, it0)),
            _i32(QPTerminationState.INFEASIBLE_GUESS, it0),
        ),
        history=QPIterationHistory.empty(
            (B, params.max_iterations if params.record_history else 0), **kw
        ),
    )
    out = bounded_loop(cond, body, init, params.max_iterations, params.early_exit, params.unroll)

    status = torch.where(out.status < 0, _i32(QPTerminationState.MAX_ITERATIONS, it0), out.status)
    if K > 0:
        lagrange = QPLagrangeMultipliers(
            min=out.st.y.amin(-1), l_infinity=out.st.y.abs().amax(-1)
        )
    else:
        lagrange = QPLagrangeMultipliers(lane, lane)
    return QPIPResult(
        termination_state=status,
        num_iterations=out.it,
        x=out.st.x,
        s=out.st.s,
        y=out.st.y,
        z=out.st.z,
        iterations=out.history,
        lagrange_multipliers=lagrange,
    )


def build_full_kkt_system(qp: QP, x, s, y, z):
    """Dense (N + 2M + K) Newton system of eq 19.12 of ONE instance, the
    brute-force test oracle (analog of BuildFullSystem, qp.cc:595-655):
    ``qp``'s leaves without the batch axis (G (N, N), c (N,), A_eq (K, N),
    b_eq (K,), ineq_var, ineq_a and ineq_b (M,)), the iterate x (N,), s and
    z (M,), y (K,). Returns (H, r) with the step ordered [p_x; p_s; -p_y;
    -p_z] and mu = 0, as the JAX package's. Vmappable over a batch."""
    N, M, K = qp.N, qp.M, qp.K
    kw = dict(dtype=qp.G.dtype, device=qp.G.device)

    def zeros(r, c):
        return torch.zeros((r, c), **kw)

    A_i = (torch.arange(N, device=qp.G.device)[None, :] == qp.ineq_var[:, None]).to(qp.G.dtype) * qp.ineq_a[:, None]
    eye_m = torch.eye(M, **kw)
    H = torch.cat([
        torch.cat([qp.G, zeros(N, M), qp.A_eq.T, A_i.T], 1),
        torch.cat([zeros(M, N), torch.diag(z / s), zeros(M, K), -eye_m], 1),
        torch.cat([qp.A_eq, zeros(K, M + K + M)], 1),
        torch.cat([A_i, -eye_m, zeros(M, K + M)], 1),
    ], 0)
    r_d = qp.G @ x + qp.c
    if K > 0:
        r_d = r_d - qp.A_eq.T @ y
    if M > 0:
        r_d = r_d - A_i.T @ z
    r = torch.cat([r_d, z, qp.A_eq @ x + qp.b_eq, A_i @ x + qp.ineq_b - s])
    return H, r


# ---------------------------------------------------------------------------
# Null-space solver.
# ---------------------------------------------------------------------------


@traced_phase("QPNullSpaceSolve")
def qp_null_space_solve(qp: QP) -> QPNullSpaceResult:
    """Equality-constrained QPs by the null-space method (qp.cc:657-729),
    rank-aware, as the JAX package computes them: an SVD
    ``A_eq^T = U S V^T`` whose trailing columns of U span null(A_eq),
    selected by a rank mask; the reduced system in the rotated basis is
    factored by Cholesky (not positive definite -> NOT_POSITIVE_DEFINITE);
    inconsistent rank-deficient constraints -> CONSTRAINT_RANK_DEFICIENT.
    """
    B, K, N = qp.A_eq.shape
    assert K > 0, "Problem must have at least one equality constraint"
    dtype = qp.G.dtype
    eps = torch.finfo(dtype).eps
    U, S, Vt = torch.linalg.svd(qp.A_eq.transpose(-1, -2), full_matrices=True)
    m_sv = S.shape[-1]
    smax = torch.clamp_min(S[:, 0], eps)
    nonzero = S > (smax * max(N, K) * eps)[:, None]
    rank = nonzero.to(torch.int32).sum(-1)

    # Minimum-norm particular solution u = A_eq^+ (-b_eq).
    s_inv = torch.where(nonzero, 1.0 / torch.where(nonzero, S, torch.ones_like(S)), torch.zeros_like(S))
    u = _mv(U[:, :, :m_sv], s_inv * _mv(Vt, -qp.b_eq)[:, :m_sv])
    resid = (_mv(qp.A_eq, u) + qp.b_eq).abs().amax(-1)
    consistent = resid <= eps**0.5 * (1.0 + qp.b_eq.abs().amax(-1))

    null_mask = (torch.arange(N, device=qp.G.device)[None, :] >= rank[:, None]).to(dtype)
    Bm = U.transpose(-1, -2) @ qp.G @ U
    B_masked = null_mask[:, :, None] * Bm * null_mask[:, None, :] + torch.diag_embed(1.0 - null_mask)
    L, info = torch.linalg.cholesky_ex(B_masked)
    ok_pd = (info == 0) & torch.isfinite(L).all(-1).all(-1)
    eye = torch.eye(N, dtype=dtype, device=qp.G.device).expand(B, N, N)
    L_safe = torch.where(ok_pd[:, None, None], L, eye)
    rhs = -_mtv(U, qp.c + _mv(qp.G, u)) * null_mask
    w = torch.linalg.solve_triangular(L_safe, rhs[..., None], upper=False)
    yv = torch.linalg.solve_triangular(L_safe.transpose(-1, -2), w, upper=True)[..., 0]
    x = u + _mv(U, yv * null_mask)

    ok = ok_pd & consistent
    status = torch.where(
        ~consistent,
        _i32(QPNullSpaceTerminationState.CONSTRAINT_RANK_DEFICIENT, rank),
        torch.where(
            ok_pd,
            _i32(QPNullSpaceTerminationState.SUCCESS, rank),
            _i32(QPNullSpaceTerminationState.NOT_POSITIVE_DEFINITE, rank),
        ),
    )
    return QPNullSpaceResult(
        termination_state=status, x=_where_lane(ok, x, torch.zeros_like(x)), rank=rank
    )
