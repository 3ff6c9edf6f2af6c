"""Nonlinear layer: the SQP / Levenberg-Marquardt constrained NLS driver,
the port of ``mini_opt_tpu/nonlinear.py`` (nonlinear.py:70-948, :972-1426).

Solves ``min 0.5 sum ||h_i(x)||^2  s.t. g(x) = 0, a x[v] + b >= 0`` by
linearize -> QP -> L1-merit line search (Nocedal & Wright ch. 18) for a
batch of B instances at once.

Residuals are written for ONE instance, as in the JAX package, and
evaluated for the whole batch under ``torch.func.vmap``; per-instance data
rides in ``data`` (``(B, ...)`` tensors), with ``problem`` then a function
``data_row -> Problem``, so that a ``problem_fn`` reads the same in both
packages. The solver loops run batch-first: every linearization is one
vmapped call, and every KKT factorization, KKT solve and QP is one batched
call (one kernel launch on the ``"pallas_ldlt"`` and ``"pallas_fused"``
routes) per iteration. The loops are masked (``qp.bounded_loop``): each
lane's state freezes once it terminates, which is what JAX's ``vmap`` of a
``while_loop`` computes.

``qp_solver="cg"`` is the matrix-free path (nonlinear.py:363-567): each
lane's Gauss-Newton step is solved by a fixed-trip preconditioned conjugate
gradient on ``(J^T J + lam I) v`` products through ``torch.func.jvp`` /
``vjp`` of the stacked residual, the whole step one instance's function run
per lane under ``torch.func.vmap`` as the JAX package runs it under its
``vmap``; box bounds by two-metric gradient projection (the line search's
candidates clipped into the box by ``_Clamped``), equality constraints by
the projected-CG composite step.

``parallel_line_search`` evaluates every Armijo probe of a line search in
one vmapped call over P x B instances and takes, per lane, the first probe
that passes (``torch.where`` masks, so a non-finite losing probe cannot
poison the winner); ``fuse_probe_linearize`` has each probe compute its
full linearization, and the winner's rides in the loop's carry in place of
the next iteration's standalone linearization. ``exit_callback`` is a
function of ONE lane's history row, run under ``torch.func.vmap`` over the
batch's rows; ``log_qp_eigenvalues`` writes the min, max and min |.| of each
iteration's G (``torch.linalg.eigvalsh``) into the history.

Not ported yet (ROADMAP.md queue 1, item 9, "parallel/batch.py, the rest"),
each raising ``NotImplementedError``: ``axis_name`` (cost terms sharded over
a mesh) and the distributed CG preconditioner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap

from .qp import (
    QP,
    LinearInequalityConstraint,
    QPInteriorPointParams,
    _get_row,
    _i32,
    _mv,
    _set_row,
    _where_lane,
    bounded_loop,
    qp_ip_solve,
    qp_null_space_solve,
    resolve_early_exit,
)
from .residual import (
    BlockResidual,
    Residual,
    accumulate_hessian,
    accumulate_hessian_block,
    constraint_rows,
    fill_jacobian_rows,
)
from .structs import (
    BarrierStrategy,
    DirectionalDerivatives,
    Errors,
    InitialGuessMethod,
    LineSearchHistory,
    LineSearchStrategy,
    NLSIterationHistory,
    NLSResult,
    NLSTerminationState,
    OptimizerState,
    QPNullSpaceTerminationState,
    QPSolverVariant,
    QPEigenvalues,
    QPTerminationState,
    StepSizeSelectionResult,
    tree_map,
)
from .utils.tracing import annotate, traced_phase

Retraction = Callable
CostTerm = Union[Residual, BlockResidual]

_TODO_SHARDED = "is not ported yet (ROADMAP.md queue 1, item 9: parallel/batch.py, the rest)"


@dataclasses.dataclass(frozen=True)
class Problem:
    """Constrained NLS problem definition of one instance
    (nonlinear.hpp:33-52)."""

    dimension: int
    costs: Tuple[CostTerm, ...] = ()
    equality_constraints: Tuple[Residual, ...] = ()
    inequality_constraints: Tuple[LinearInequalityConstraint, ...] = ()

    @property
    def total_eq_dim(self) -> int:
        return sum(constraint_rows(c) for c in self.equality_constraints)


@dataclasses.dataclass(frozen=True)
class NLSParams:
    """Outer-loop configuration (nonlinear.hpp:64-124): the JAX package's
    fields, defaults and checks. See ``mini_opt_tpu/nonlinear.py`` for the
    meaning of each; here ``kkt_solver="auto"`` is ``"lu"``,
    ``early_exit=None`` is True, and the unroll factors are accepted and
    unused."""

    max_iterations: int = 10
    max_qp_iterations: int = 10
    termination_kkt_tolerance: float = 1.0e-6
    absolute_exit_tol: float = 1.0e-12
    relative_exit_tol: float = 1.0e-5
    absolute_first_derivative_tol: float = 1.0e-6
    max_line_search_iterations: int = 2
    line_search_strategy: LineSearchStrategy = LineSearchStrategy.POLYNOMIAL_APPROXIMATION
    armijo_search_tau: float = 0.8
    equality_penalty_initial: float = 1.0
    equality_penalty_scale_factor: float = 1.01
    equality_penalty_rho: float = 0.1
    lambda_initial: float = 0.0
    lambda_failure_init: float = 1.0e-2
    lambda_decrease_on_success: float = 0.1
    lambda_decrease_on_restore: float = 0.8
    max_lambda: float = 1.0
    min_lambda: float = 0.0
    armijo_c1: float = 1.0e-4
    kkt_solver: str = "auto"
    record_history: bool = True
    early_exit: Optional[bool] = None
    log_qp_eigenvalues: bool = False
    qp_sigma: float = 0.1
    qp_barrier_strategy: BarrierStrategy = BarrierStrategy.COMPLEMENTARITY
    inner_unroll: int = 1
    outer_unroll: int = 1
    parallel_line_search: bool = False
    qp_solver: str = "default"
    cg_iterations: int = 50
    fuse_probe_linearize: bool = False
    qp_initial_guess_method: Optional[InitialGuessMethod] = None

    def __post_init__(self):
        # Eager validation mirroring CheckParams (nonlinear.cc:49-73).
        assert self.max_iterations >= 0
        assert self.max_qp_iterations >= 1
        assert self.termination_kkt_tolerance > 0
        assert self.absolute_exit_tol > 0
        assert self.max_line_search_iterations >= 0
        assert 0 <= self.relative_exit_tol <= 1
        assert self.absolute_first_derivative_tol >= 0
        assert 0 < self.armijo_search_tau < 1
        assert self.equality_penalty_initial >= 0
        assert self.equality_penalty_scale_factor >= 1.0
        assert 0 <= self.equality_penalty_rho < 1
        assert self.max_lambda >= 0
        assert self.min_lambda <= self.max_lambda
        assert self.min_lambda <= self.lambda_initial <= self.max_lambda
        assert self.lambda_failure_init >= 0
        assert 0 <= self.lambda_decrease_on_success < 1.0
        assert 0 <= self.lambda_decrease_on_restore < 1.0
        assert not (
            self.parallel_line_search
            and self.line_search_strategy != LineSearchStrategy.ARMIJO_BACKTRACK
        ), "parallel_line_search requires ARMIJO_BACKTRACK (polynomial probes depend on previous probe values)"
        assert self.qp_solver in ("default", "pallas_fused", "cg")
        assert self.cg_iterations >= 1
        assert not (self.fuse_probe_linearize and not self.parallel_line_search), (
            "fuse_probe_linearize requires parallel_line_search"
        )
        assert not (self.fuse_probe_linearize and self.qp_solver == "cg")
        assert self.qp_initial_guess_method != InitialGuessMethod.USER_PROVIDED, (
            "the NLS driver owns the inner-QP state; USER_PROVIDED warm "
            "starts enter through x0 of nls_solve itself"
        )
        assert not (self.qp_solver == "pallas_fused" and self.record_history), (
            "qp_solver='pallas_fused' runs the whole inner loop in one kernel "
            "and materializes no per-QP-iteration telemetry; set "
            "record_history=False"
        )


# ---------------------------------------------------------------------------
# Batched evaluation of one instance's problem.
# ---------------------------------------------------------------------------


def _per_lane(fn, problem, x, data, *rest):
    """``fn(Problem, x_row, *rest_rows)`` for every lane, under vmap."""
    if data is None:
        return vmap(lambda xr, *r: fn(problem, xr, *r))(x, *rest)
    return vmap(lambda xr, dr, *r: fn(problem(dr), xr, *r))(x, data, *rest)


def _no_axis(axis_name):
    if axis_name is not None:
        raise NotImplementedError(f"axis_name (cost terms sharded over a mesh) {_TODO_SHARDED}")


def _linearize_one(problem: Problem, x):
    """Gauss-Newton assembly of ONE instance without the LM damping term
    (nonlinear.py:234-287): (G, c, f, A_eq, b_eq, |b_eq|_1, ineq_a,
    ineq_b)."""
    n = problem.dimension
    kw = dict(dtype=x.dtype, device=x.device)
    G = torch.zeros((n, n), **kw)
    c = torch.zeros((n,), **kw)
    f_total = torch.zeros((), **kw)
    for cost in problem.costs:
        if isinstance(cost, BlockResidual):
            G, c, f = accumulate_hessian_block(G, c, cost, x)
        else:
            G, c, f = accumulate_hessian(G, c, cost, x)
        f_total = f_total + f
    k_total = problem.total_eq_dim
    A_eq = torch.zeros((k_total, n), **kw)
    b_eq = torch.zeros((k_total,), **kw)
    row = 0
    for eq in problem.equality_constraints:
        A_eq, b_eq = fill_jacobian_rows(A_eq, b_eq, eq, x, row)
        row += constraint_rows(eq)
    eq_l1 = torch.sum(torch.abs(b_eq)) if k_total > 0 else torch.zeros((), **kw)
    ineqs = problem.inequality_constraints
    if ineqs:
        a = torch.stack([torch.as_tensor(c_.a, **kw) for c_ in ineqs])
        # ShiftTo the linearization point (qp.hpp:57-59).
        b = torch.stack(
            [torch.as_tensor(c_.a, **kw) * x[c_.variable] + torch.as_tensor(c_.b, **kw) for c_ in ineqs]
        )
    else:
        a = b = torch.zeros((0,), **kw)
    return G, c, f_total, A_eq, b_eq, eq_l1, a, b


def _prototype(problem, data) -> Problem:
    """The Problem of lane 0, for what is static: the dimension and the
    constraint structure, which every lane shares."""
    return problem if data is None else problem(tree_map(lambda t: t[0], data))


def _ineq_var(proto: Problem):
    return tuple(int(c_.variable) for c_ in proto.inequality_constraints)


def _linearize_raw(problem, x, data=None, ineq_var=None) -> Tuple[QP, Errors]:
    G, c, f, A_eq, b_eq, eq_l1, a, b = _per_lane(_linearize_one, problem, x, data)
    if ineq_var is None:
        ineq_var = _ineq_var(_prototype(problem, data))
    var = torch.tensor(ineq_var, dtype=torch.long, device=x.device)
    qp = QP(G=G, c=c, A_eq=A_eq, b_eq=b_eq, ineq_var=var, ineq_a=a, ineq_b=b)
    return qp, Errors(f=f, equality=eq_l1)


def _damp(qp: QP, lam) -> QP:
    """Add the LM damping term ``lam (B,)`` to the Hessians."""
    eye = torch.eye(qp.N, dtype=qp.G.dtype, device=qp.G.device)
    return dataclasses.replace(qp, G=qp.G + lam[:, None, None] * eye)


@traced_phase("LinearizeAndFillQP")
def linearize_and_fill_qp(problem, x, lam, axis_name=None, data=None, ineq_var=None) -> Tuple[QP, Errors]:
    """LinearizeAndFillQP analog (nonlinear.cc:170-214) for a batch ``x
    (B, n)``: Gauss-Newton assembly of (G, c), LM damping ``lam (B,)`` of
    the diagonal, the equality Jacobian rows and the inequality constraints
    shifted to the linearization point. ``ineq_var`` (the constraints'
    variables) is read from the problem when not given."""
    _no_axis(axis_name)
    qp, errors = _linearize_raw(problem, x, data, ineq_var)
    return _damp(qp, lam), errors


def _errors_one(problem: Problem, x):
    f = torch.zeros((), dtype=x.dtype, device=x.device)
    for cost in problem.costs:
        r = cost.error_vectors(x) if isinstance(cost, BlockResidual) else cost.error_vector(x)
        f = f + 0.5 * torch.sum(r * r)
    eq = torch.zeros((), dtype=x.dtype, device=x.device)
    for eq_c in problem.equality_constraints:
        r = eq_c.error_vectors(x) if isinstance(eq_c, BlockResidual) else eq_c.error_vector(x)
        eq = eq + torch.sum(torch.abs(r))
    return f, eq


@traced_phase("EvaluateNonlinearErrors")
def evaluate_nonlinear_errors(problem, x, axis_name=None, data=None) -> Errors:
    """EvaluateNonlinearErrors analog (nonlinear.cc:279-293), per lane."""
    _no_axis(axis_name)
    f, eq = _per_lane(_errors_one, problem, x, data)
    return Errors(f=f, equality=eq)


# ---------------------------------------------------------------------------
# The matrix-free CG step (nonlinear.py:341-567), of ONE instance.
# ---------------------------------------------------------------------------


def _stacked_residual(problem: Problem, x):
    """All cost residuals as one flat vector (for matrix-free J^T J
    products)."""
    parts = [
        cost.error_vectors(x).reshape(-1) if isinstance(cost, BlockResidual) else cost.error_vector(x)
        for cost in problem.costs
    ]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _stacked_equality(problem: Problem, x):
    """All equality-constraint residuals as one flat vector (block-major for
    a BlockResidual, ``fill_jacobian_rows``' row order)."""
    parts = [
        c_.error_vectors(x).reshape(-1) if isinstance(c_, BlockResidual) else c_.error_vector(x)
        for c_ in problem.equality_constraints
    ]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _pcg(matvec, b, prec_apply, iterations: int):
    """Fixed-trip preconditioned conjugate gradient; ``prec_apply`` is the
    M^-1 application. The JAX package's ``lax.scan`` of ``iterations``
    trips as a Python loop with the same guards, which keep alpha and beta
    finite at exact convergence (converged iterates stay put)."""
    tiny = torch.finfo(b.dtype).tiny
    one, zero = torch.ones((), dtype=b.dtype, device=b.device), torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    z = prec_apply(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(iterations):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        live = torch.abs(denom) > tiny
        alpha = torch.where(live, rz / torch.where(live, denom, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec_apply(r)
        rz1 = torch.dot(r, z)
        moving = torch.abs(rz) > tiny
        beta = torch.where(moving, rz1 / torch.where(moving, rz, one), zero)
        p = z + beta * p
        rz = rz1
    return x


def _box_bounds(problem: Problem, dtype, device):
    """Per-variable (lo, hi) bound vectors from the diagonal inequality list
    (+-inf where unbounded): ``a x_v + b >= 0`` gives ``x_v >= -b/a`` for
    a > 0 and ``x_v <= -b/a`` for a < 0 (qp.hpp:28-70). Bounds that are
    Python numbers are assembled on the host and moved to ``device`` once;
    tensor bounds (per lane, from ``data``) are assembled with tensor
    operations, so that the caller can run this per lane under vmap."""
    n = problem.dimension
    cons = problem.inequality_constraints
    if not any(torch.is_tensor(c_.a) or torch.is_tensor(c_.b) for c_ in cons):
        lo, hi = np.full((n,), -np.inf), np.full((n,), np.inf)
        for c_ in cons:
            a = float(c_.a)
            bound = -float(c_.b) / a
            v = int(c_.variable)
            if a > 0:
                lo[v] = max(lo[v], bound)
            else:
                hi[v] = min(hi[v], bound)
        return (torch.as_tensor(lo, dtype=dtype, device=device), torch.as_tensor(hi, dtype=dtype, device=device))
    kw = dict(dtype=dtype, device=device)
    lo = [torch.full((), -math.inf, **kw)] * n
    hi = [torch.full((), math.inf, **kw)] * n
    for c_ in cons:
        a = torch.as_tensor(c_.a, **kw)
        bound = -torch.as_tensor(c_.b, **kw) / a
        v = int(c_.variable)
        lo[v] = torch.where(a > 0, torch.maximum(lo[v], bound), lo[v])
        hi[v] = torch.where(a < 0, torch.minimum(hi[v], bound), hi[v])
    return torch.stack(lo), torch.stack(hi)


@traced_phase("ComputeStepDirection")
def _cg_step_direction(problem: Problem, x, lam, params: NLSParams, diag_fn, axis_name=None, bounds=None,
                       prec_fn=None):
    """Matrix-free Gauss-Newton step of ONE instance: solve (J^T J + lam I)
    dx = -J^T r by PCG without materializing the Hessian
    (nonlinear.py:437-567). Returns (dx, errors_pre, derivatives,
    lagrange_l_inf or None).

    One ``torch.func.vjp`` of the stacked residual is taken per step and
    reused by every CG trip, as the JAX package reuses its ``jax.vjp``;
    each trip's J v is a ``torch.func.jvp``. Equality constraints take the
    projected-CG composite step (Nocedal & Wright 16.3): the minimum-norm
    restoration ``dx_p = -A^T (A A^T)^-1 c`` plus a tangential step by CG in
    null(A), only the m x m ``A A^T`` factored (``ops/kkt.py``'s LDL^T).
    Box bounds (``bounds = (lo, hi)``) take two-metric gradient
    projection: a variable pinned at a bound with its gradient pushing
    outward is frozen (its row the identity)."""
    _no_axis(axis_name)
    from torch.func import jacrev, jvp, vjp

    from .ops.kkt import ldlt_factorize, ldlt_solve

    def res(xx):
        return _stacked_residual(problem, xx)

    r0, pullback = vjp(res, x)
    f_total = 0.5 * torch.sum(r0 * r0)
    (g,) = pullback(r0)  # J^T r

    def matvec(v):
        _, jv = jvp(res, (x,), (v,))
        (jtjv,) = pullback(jv)
        return jtjv + lam * v

    if prec_fn is not None:
        # A general M^-1 apply (block-Jacobi, tree, Schur); the factory sees
        # (x, lam) and owns any damping of its blocks.
        prec_apply = prec_fn(x, lam)
    else:
        diag = diag_fn(x) + lam if diag_fn is not None else torch.ones_like(g)

        def prec_apply(r, _diag=diag):
            return r / _diag

    b = -g
    mv = matvec
    fmask = None
    if bounds is not None:
        lo, hi = bounds
        free = ~(((x <= lo) & (g > 0)) | ((x >= hi) & (g < 0)))
        fmask = free.to(x.dtype)

        def mv(v):  # noqa: F811 -- the masked system: the identity on frozen rows
            return fmask * matvec(fmask * v) + (1.0 - fmask) * v

        b = fmask * b
        inner_apply = prec_apply

        def prec_apply(r, _inner=inner_apply):  # noqa: F811
            return fmask * _inner(fmask * r) + (1.0 - fmask) * r

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if not problem.equality_constraints:
        dx = _pcg(mv, b, prec_apply, params.cg_iterations)
        return dx, Errors(f=f_total, equality=zero), DirectionalDerivatives(d_f=torch.dot(g, dx), d_equality=zero), None

    def eq(xx):
        return _stacked_equality(problem, xx)

    c0 = eq(x)
    A = jacrev(eq)(x)  # (m, n)
    if fmask is not None:
        # The equality projector restricted to the free subspace; a frozen
        # set that makes A_F rank-deficient NaNs the factor -> QP_INDEFINITE.
        A = A * fmask[None, :]
    fact, fact_ok = ldlt_factorize((A @ A.T)[None])
    bad = torch.where(fact_ok[0], zero, torch.full_like(zero, math.nan))

    def solve_nrm(rhs):  # (A A^T)^-1 rhs; NaN on rank deficiency -> status path
        return ldlt_solve(fact, rhs[None])[0] + bad

    def mask(v):
        return v if fmask is None else fmask * v

    def proj(v):  # orthogonal projector onto null(A_F) within the free set
        u = mask(v)
        return u - mask(A.T @ solve_nrm(A @ u))

    dx_p = -(A.T @ solve_nrm(c0))
    b_t = proj(-(g + matvec(dx_p)))

    def mv_t(v):  # the projected Hessian on range(P), the identity on its complement
        pv = proj(v)
        return proj(matvec(pv)) + (v - pv)

    dx = dx_p + _pcg(mv_t, b_t, prec_apply, params.cg_iterations)
    y = -solve_nrm(A @ (g + matvec(dx)))  # first-order multiplier estimate
    derivatives = DirectionalDerivatives(d_f=torch.dot(g, dx), d_equality=torch.sum(torch.sign(c0) * (A @ dx)))
    return dx, Errors(f=f_total, equality=torch.sum(torch.abs(c0))), derivatives, torch.abs(y).amax()


def compute_second_order_correction(problem: Problem, qp: QP, x_updated):
    """Second-order correction step of ONE instance (the reference's
    test-only prototype, nonlinear_test.cc:252-348): the nonlinear equality
    constraints re-evaluated at the stepped point ``x_updated (n,)`` and the
    minimum-norm correction ``dx_soc = -A_eq^+ g(x + dx)`` against the
    current linearization ``qp`` (one instance's ``A_eq (K, n)``), the
    anti-Maratos device of SQP line searches. ``nls_solve`` does not call
    it, as in the reference; vmappable over a batch. The pseudo-inverse cuts
    singular values below JAX's default, 10 max(K, n) eps of the largest."""
    g = torch.cat([
        eq.error_vectors(x_updated).reshape(-1) if isinstance(eq, BlockResidual) else eq.error_vector(x_updated)
        for eq in problem.equality_constraints
    ])
    A = qp.A_eq
    rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    return -torch.linalg.pinv(A, rtol=rtol) @ g


@traced_phase("ComputeQPCostDerivative")
def compute_qp_cost_derivative(qp: QP, dx) -> DirectionalDerivatives:
    """Directional derivative of cost + L1 equality merit along dx
    (nonlinear.cc:457-482), per lane."""
    d_f = torch.sum(qp.c * dx, -1)
    if qp.K > 0:
        d_eq = torch.sum(torch.sign(qp.b_eq) * _mv(qp.A_eq, dx), -1)
    else:
        d_eq = torch.zeros_like(d_f)
    return DirectionalDerivatives(d_f=d_f, d_equality=d_eq)


def select_penalty(qp: QP, dx, lagrange_l_inf, rho):
    """SelectPenalty analog (nonlinear.cc:484-502): eq 18.32 when Lagrange
    multipliers are available (interior-point path), else the eq 18.36
    bound."""
    if lagrange_l_inf is not None:
        return lagrange_l_inf
    eps = torch.finfo(dx.dtype).eps
    l1_eq = torch.clamp_min(torch.sum(torch.abs(qp.b_eq), -1), eps)
    quad = torch.sum(qp.c * dx, -1) + 0.5 * torch.clamp_min(torch.sum(dx * _mv(qp.G, dx), -1), 0.0)
    return quad / ((1.0 - rho) * l1_eq)


# ---------------------------------------------------------------------------
# Polynomial line-search fits (nonlinear.cc:504-605), elementwise.
# ---------------------------------------------------------------------------


def quadratic_approx_minimum(phi_0, phi_prime_0, alpha_0, phi_alpha_0):
    """Eq 3.57/3.58 quadratic fit; returns (alpha_min, valid)."""
    numerator = phi_alpha_0 - phi_prime_0 * alpha_0 - phi_0
    valid = (phi_prime_0 <= 0) & (numerator > 0)
    alpha = -phi_prime_0 * alpha_0 * alpha_0 / (2.0 * torch.where(valid, numerator, torch.ones_like(numerator)))
    return alpha, valid


def cubic_approx_coeffs(phi_0, phi_prime_0, alpha_0, phi_alpha_0, alpha_1, phi_alpha_1):
    """[a, b] of phi(a) = a x^3 + b x^2 + x phi'(0) + phi(0) through two
    probes (closed-form 2x2 inverse)."""
    a00 = alpha_0 * alpha_0 * alpha_0
    a01 = alpha_0 * alpha_0
    a10 = alpha_1 * alpha_1 * alpha_1
    a11 = alpha_1 * alpha_1
    r0 = phi_alpha_0 - phi_0 - phi_prime_0 * alpha_0
    r1 = phi_alpha_1 - phi_0 - phi_prime_0 * alpha_1
    det = a00 * a11 - a01 * a10
    # det == 0 only for degenerate probe pairs that the validity checks
    # discard downstream.
    det = torch.where(det == 0.0, torch.ones_like(det), det)
    a = (a11 * r0 - a01 * r1) / det
    b = (-a10 * r0 + a00 * r1) / det
    return a, b


def cubic_approx_minimum(phi_prime_0, a, b):
    """Minimum of the cubic fit; returns (alpha_min, valid)."""
    arg_sqrt = b * b - 3.0 * a * phi_prime_0
    valid = (a != 0.0) & (arg_sqrt >= -1.0e-12)
    denom = -b + torch.sqrt(torch.clamp_min(arg_sqrt, torch.finfo(arg_sqrt.dtype).tiny))
    alpha = denom / (3.0 * torch.where(valid, a, torch.ones_like(a)))
    return alpha, valid


# ---------------------------------------------------------------------------
# Line search.
# ---------------------------------------------------------------------------


class _LSCarry(NamedTuple):
    it: torch.Tensor  # int32 probe index
    status: torch.Tensor  # int32; -1 = keep searching
    alpha: torch.Tensor  # alpha of the most recent probe
    candidate: torch.Tensor  # x after the most recent retraction
    # The previous two probes, for the cubic fit.
    alpha_prev: torch.Tensor
    phi_prev: torch.Tensor
    alpha_prev2: torch.Tensor
    phi_prev2: torch.Tensor
    steps: LineSearchHistory


class _Clamped(NamedTuple):
    """A retraction whose every candidate is clipped into the box
    ``(lo, hi)``, each ``(B, n)``: the CG path's projected line search
    (nonlinear.py:1063-1067)."""

    base: Optional[Retraction]
    lo: torch.Tensor
    hi: torch.Tensor


def _retract(retraction, x, dx, alpha):
    """Every lane's candidate: ``retraction(x, dx, alpha)`` of one instance
    under vmap, or ``x + dx * alpha``."""
    if isinstance(retraction, _Clamped):
        return torch.clamp(_retract(retraction.base, x, dx, alpha), retraction.lo, retraction.hi)
    if retraction is None:
        return x + dx * alpha[:, None]
    return vmap(retraction)(x, dx, alpha)


def _repeat_lanes(t, P):
    """``(B, ...) -> (P B, ...)``, probe-major: row p B + b is lane b."""
    return t.repeat((P,) + (1,) * (t.dim() - 1))


def _select_step_size_parallel(problem, params: NLSParams, x, dx, errors_pre: Errors,
                               derivatives: DirectionalDerivatives, penalty, retraction, data=None,
                               ineq_var=None, return_linearization=False):
    """Armijo backtracking with every probe evaluated at once
    (nonlinear.py:676-793): the schedule alpha_p = tau^p is
    data-independent, so the P = max_line_search_iterations + 1 candidates
    of every lane are built as one ``(P, B, n)`` tensor, their errors (or,
    with ``return_linearization``, their full linearizations) come from ONE
    vmapped evaluation over the P B instances, and each lane takes the first
    probe that passes, as the sequential loop would. Statuses, history and
    the accepted candidate are the sequential path's. The winner is picked
    with ``torch.where`` masks summed over the probes, never a
    multiplicative one-hot: 0 * NaN would let a non-finite losing probe
    poison the winner."""
    B, n = x.shape
    P = params.max_line_search_iterations + 1
    phi_0 = errors_pre.total(penalty)
    dd_total = derivatives.total(penalty)
    dd_linf = derivatives.l_infinity()
    alphas = torch.tensor(params.armijo_search_tau, dtype=x.dtype, device=x.device) ** torch.arange(
        P, dtype=x.dtype, device=x.device)
    cand = _retract(retraction, _repeat_lanes(x, P), _repeat_lanes(dx, P), alphas.repeat_interleave(B))
    data_p = tree_map(lambda t: _repeat_lanes(t, P), data) if data is not None else None
    if return_linearization:
        qps, errs = _linearize_raw(problem, cand, data_p, ineq_var)
    else:
        errs = evaluate_nonlinear_errors(problem, cand, data=data_p)

    def probes(t):  # (P B, ...) -> (P, B, ...)
        return t.reshape((P, B) + t.shape[1:])

    f, eq = probes(errs.f), probes(errs.equality)
    phi = f + penalty * eq
    a = alphas[:, None]
    armijo = phi <= phi_0 + dd_total * a * params.armijo_c1
    lattice = torch.where(
        ~(torch.isfinite(f) & torch.isfinite(eq)),
        int(StepSizeSelectionResult.FAILURE_NON_FINITE_COST),
        torch.where(
            (dd_linf < params.absolute_first_derivative_tol)[None].expand(P, B),
            int(StepSizeSelectionResult.FIRST_ORDER_SATISFIED),
            torch.where(
                (dd_total > 0)[None].expand(P, B),
                int(StepSizeSelectionResult.POSITIVE_DERIVATIVE),
                torch.where(armijo, int(StepSizeSelectionResult.SUCCESS), -1),
            ),
        ),
    ).to(torch.int32)
    stops = lattice >= 0
    any_stop = stops.any(0)
    # The probe the sequential loop would have stopped at (the last when
    # none stops): argmax returns the first of equal maxima.
    k = torch.where(any_stop, stops.to(torch.int32).argmax(0), P - 1).to(torch.int32)
    sel = torch.arange(P, device=x.device)[:, None] == k[None, :]  # (P, B)

    def select(v):  # (P, B, ...) -> (B, ...)
        mask = sel.view((P, B) + (1,) * (v.dim() - 2))
        return torch.sum(torch.where(mask, v, torch.zeros_like(v)), 0)

    status = torch.where(any_stop, select(lattice).to(torch.int32), _i32(StepSizeSelectionResult.MAX_ITERATIONS, k))
    candidate = select(probes(cand))
    final_errors = Errors(f=select(f), equality=select(eq))
    evaluated = (torch.arange(P, device=x.device)[:, None] <= k[None, :])  # (P, B)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    steps = LineSearchHistory(
        alpha=torch.where(evaluated, a.expand(P, B), zero).T,
        f=torch.where(evaluated, f, zero).T,
        equality=torch.where(evaluated, eq, zero).T,
        num_steps=k + 1,
    )
    if not return_linearization:
        return status, candidate, final_errors, steps
    qp_sel = QP(
        G=select(probes(qps.G)), c=select(probes(qps.c)), A_eq=select(probes(qps.A_eq)),
        b_eq=select(probes(qps.b_eq)), ineq_var=qps.ineq_var, ineq_a=select(probes(qps.ineq_a)),
        ineq_b=select(probes(qps.ineq_b)),
    )
    return status, candidate, final_errors, steps, (qp_sel, final_errors)


@traced_phase("SelectStepSize")
def select_step_size(
    problem,
    params: NLSParams,
    x,
    dx,
    errors_pre: Errors,
    derivatives: DirectionalDerivatives,
    penalty,
    retraction: Optional[Retraction],
    axis_name=None,
    data=None,
    ineq_var=None,
):
    """SelectStepSize analog (nonlinear.cc:351-416): try alpha = 1, then
    Armijo backtracking or quadratic/cubic polynomial minimization, accepting
    on the Armijo condition over the L1 merit function, for every lane.

    Returns (status, accepted_candidate, candidate_errors, steps_log), and,
    with ``params.fuse_probe_linearize``, the accepted probe's raw
    linearization ``(QP, Errors)`` as a fifth element. With
    ``params.parallel_line_search`` every probe is evaluated at once
    (``_select_step_size_parallel``).
    """
    _no_axis(axis_name)
    if params.parallel_line_search and params.line_search_strategy == LineSearchStrategy.ARMIJO_BACKTRACK:
        return _select_step_size_parallel(
            problem, params, x, dx, errors_pre, derivatives, penalty, retraction, data, ineq_var,
            return_linearization=params.fuse_probe_linearize,
        )
    max_probes = params.max_line_search_iterations + 1
    phi_0 = errors_pre.total(penalty)
    dd_total = derivatives.total(penalty)
    dd_linf = derivatives.l_infinity()
    ones = torch.ones_like(phi_0)
    polynomial = params.line_search_strategy == LineSearchStrategy.POLYNOMIAL_APPROXIMATION

    def body(c: _LSCarry) -> _LSCarry:
        it = c.it
        if polynomial:
            qa, q_ok = quadratic_approx_minimum(phi_0, dd_total, c.alpha_prev, c.phi_prev)
            a_cub, b_cub = cubic_approx_coeffs(
                phi_0, dd_total, c.alpha_prev2, c.phi_prev2, c.alpha_prev, c.phi_prev
            )
            ca, c_ok = cubic_approx_minimum(dd_total, a_cub, b_cub)
            new_alpha = torch.where(it == 1, qa, ca)
            new_ok = torch.where(it == 1, q_ok, c_ok)
            new_ok = new_ok & torch.isfinite(new_alpha) & (new_alpha > 0.0) & (new_alpha < c.alpha)
            alpha = torch.where(it == 0, ones, new_alpha)
            invalid = (it > 0) & ~new_ok
        else:
            alpha = torch.where(it == 0, ones, c.alpha * params.armijo_search_tau)
            invalid = torch.zeros_like(it, dtype=torch.bool)

        candidate = _retract(retraction, x, dx, alpha)
        errs = evaluate_nonlinear_errors(problem, candidate, data=data)
        phi = errs.total(penalty)

        # An invalid polynomial fit is not logged: the reference returns
        # FAILURE_INVALID_ALPHA before evaluating the probe
        # (nonlinear.cc:374-377).
        def log(buf, v):
            return torch.where(invalid[:, None], buf, _set_row(buf, it, v))

        steps = LineSearchHistory(
            alpha=log(c.steps.alpha, alpha),
            f=log(c.steps.f, errs.f),
            equality=log(c.steps.equality, errs.equality),
            num_steps=c.steps.num_steps + (~invalid).to(torch.int32),
        )
        # Status lattice in the reference's order (nonlinear.cc:374-412).
        armijo = phi <= phi_0 + dd_total * alpha * params.armijo_c1
        status = torch.where(
            invalid,
            _i32(StepSizeSelectionResult.FAILURE_INVALID_ALPHA, it),
            torch.where(
                errs.contains_invalid_values(),
                _i32(StepSizeSelectionResult.FAILURE_NON_FINITE_COST, it),
                torch.where(
                    dd_linf < params.absolute_first_derivative_tol,
                    _i32(StepSizeSelectionResult.FIRST_ORDER_SATISFIED, it),
                    torch.where(
                        dd_total > 0,
                        _i32(StepSizeSelectionResult.POSITIVE_DERIVATIVE, it),
                        torch.where(armijo, _i32(StepSizeSelectionResult.SUCCESS, it), _i32(-1, it)),
                    ),
                ),
            ),
        )
        return _LSCarry(
            it=it + 1,
            status=status,
            alpha=alpha,
            candidate=candidate,
            alpha_prev=alpha,
            phi_prev=phi,
            alpha_prev2=c.alpha_prev,
            phi_prev2=c.phi_prev,
            steps=steps,
        )

    def cond(c: _LSCarry):
        return (c.status < 0) & (c.it < max_probes)

    it0 = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    # Benign initializers, only read after the first probe overwrites them.
    init = _LSCarry(
        it=it0,
        status=_i32(-1, it0),
        alpha=ones,
        candidate=x,
        alpha_prev=ones,
        phi_prev=phi_0,
        alpha_prev2=torch.full_like(phi_0, 2.0),
        phi_prev2=phi_0,
        steps=LineSearchHistory.empty(x.shape[0], max_probes, x.dtype, x.device),
    )
    out = bounded_loop(cond, body, init, max_probes, params.early_exit, params.inner_unroll)
    status = torch.where(out.status < 0, _i32(StepSizeSelectionResult.MAX_ITERATIONS, it0), out.status)
    final_errors = Errors(
        f=_get_row(out.steps.f, out.it - 1), equality=_get_row(out.steps.equality, out.it - 1)
    )
    return status, out.candidate, final_errors, out.steps


# ---------------------------------------------------------------------------
# The outer SQP/LM loop.
# ---------------------------------------------------------------------------


class _NLSCarry(NamedTuple):
    x: torch.Tensor
    lam: torch.Tensor
    penalty: torch.Tensor
    opt_state: torch.Tensor  # int32 OptimizerState
    it: torch.Tensor  # int32 iterations completed
    status: torch.Tensor  # int32 NLSTerminationState; NONE = continue
    history: NLSIterationHistory
    # fuse_probe_linearize: the raw linearization at x, (G, c, A_eq, b_eq,
    # ineq_a, ineq_b, f, equality), every leaf batched; else None.
    lin: Optional[tuple] = None


def _uses_null_space(problem: Problem) -> bool:
    """Solver variant choice (nonlinear.cc:83-89): null-space iff there are
    equality constraints and no inequality constraints."""
    return len(problem.inequality_constraints) == 0 and len(problem.equality_constraints) > 0


def _check_ported(params: NLSParams, exit_callback, axis_name, cg_args):
    if cg_args[2] or (params.qp_solver == "cg" and axis_name is not None):
        raise NotImplementedError(f"the distributed CG path (axis_name, distributed_cg_preconditioner) {_TODO_SHARDED}")
    _no_axis(axis_name)
    if exit_callback is not None:
        assert params.record_history, "exit_callback requires record_history"
    if params.qp_solver == "cg":
        assert not params.log_qp_eigenvalues, (
            "qp_solver='cg' is matrix-free: there is no assembled QP Hessian to log eigenvalues of"
        )


def _pack_lin(qp: QP, errors: Errors):
    """A raw linearization as the carry's tuple of batched leaves."""
    return (qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b, errors.f, errors.equality)


def _unpack_lin(lin, ineq_var):
    G, c, A_eq, b_eq, ia, ib, f, eq = lin
    return QP(G=G, c=c, A_eq=A_eq, b_eq=b_eq, ineq_var=ineq_var, ineq_a=ia, ineq_b=ib), Errors(f=f, equality=eq)


def _eigen_summary(G):
    """(min, max, min |.|) of the eigenvalues of each lane's symmetric G
    (B, N, N); NaN for a lane whose G is not finite (eigvalsh would refuse
    the batch)."""
    bad = ~torch.isfinite(G).all(-1).all(-1)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    w = torch.linalg.eigvalsh(torch.where(bad[:, None, None], eye, G))
    w = torch.where(bad[:, None], torch.full_like(w, math.nan), w)
    return w.amin(-1), w.amax(-1), w.abs().amin(-1)


def _callback_proceed(exit_callback, row):
    """``exit_callback`` of each lane's history row under
    ``torch.func.vmap``: (B,) bool."""
    leaves = []
    tree_map(lambda t: leaves.append(t) or t, row)

    def one(*lane_leaves):
        it = iter(lane_leaves)
        return torch.as_tensor(exit_callback(tree_map(lambda t: next(it), row)))

    return vmap(one)(*leaves).to(torch.bool)


def _unwrap_lifted(problem, params: NLSParams, retraction, data):
    """A ``NonlinearInequalityProblem`` (``ineq.py``), or a per-lane function
    returning one, becomes its augmented ``Problem`` (nonlinear.py:1019-1031):
    the slack-safe NAIVE QP warm start is forced (``.params``) and a base
    retraction is lifted so that slacks update additively
    (``.wrap_retraction``). For a per-lane function both are read from the
    prototype, lane 0's wrapper, and every lane solves its ``.problem``.
    Returns ``(problem, params, retraction, prototype)``, the prototype lane
    0's ``Problem``."""
    proto = _prototype(problem, data)
    if not (hasattr(proto, "base_dimension") and hasattr(proto, "inequalities")):
        return problem, params, retraction, proto
    if retraction is not None:
        retraction = proto.wrap_retraction(retraction)
    params = proto.params(params)
    if data is None:
        return proto.problem, params, retraction, proto.problem
    per_lane = problem
    return (lambda row: per_lane(row).problem), params, retraction, proto.problem


def _as_batch(x0, data, device):
    """Tensors stay where they lie; numpy inputs go to ``device`` (the card
    unless the caller names one)."""
    from .convert import _resolve_device

    def conv(a):
        if a is None or torch.is_tensor(a):
            return a
        if isinstance(a, (tuple, list)):
            return type(a)(conv(v) for v in a)
        return torch.as_tensor(a, device=_resolve_device(device))

    x0, data = conv(x0), conv(data)
    if device is not None:
        x0 = x0.to(device)
        data = tree_map(lambda t: t.to(device), data) if data is not None else None
    if x0.dim() != 2 or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x0 must be a (B, n) float32 or float64 batch, not {tuple(x0.shape)} {x0.dtype}")
    return x0, data


@traced_phase("Solve")
def nls_solve(
    problem,
    params: NLSParams,
    x0,
    retraction: Optional[Retraction] = None,
    exit_callback: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    cg_diag_preconditioner: Optional[Callable] = None,
    cg_preconditioner: Optional[Callable] = None,
    distributed_cg_preconditioner: bool = False,
    data=None,
    device=None,
) -> NLSResult:
    """Solve B constrained NLS instances (nonlinear.cc:75-157) at once.

    Args:
      problem: the ``Problem`` every lane shares, or, with ``data``, a
        function ``data_row -> Problem`` evaluated per lane under vmap;
        either may be a ``NonlinearInequalityProblem`` (``ineq.py``), solved
        as its augmented problem with the NAIVE QP warm start forced.
      params: solver configuration.
      x0: initial guesses ``(B, problem.dimension)``.
      retraction: optional manifold update ``(x, dx, alpha) -> x_new`` of
        ONE instance (nonlinear.hpp:127), applied per lane under vmap;
        default ``x + alpha * dx``.
      data: per-lane data, a ``(B, ...)`` tensor or a tuple of them.
      device: where numpy inputs go ("cuda" unless named); tensors run where
        they lie.

      cg_diag_preconditioner: for ``qp_solver="cg"``, an optional
        ``f(x) -> diag(J^T J)`` of one instance, the Jacobi preconditioner.
      cg_preconditioner: for ``qp_solver="cg"``, a preconditioner factory
        ``(x, lam) -> (apply: r -> M^-1 r)`` of one instance; overrides
        ``cg_diag_preconditioner`` and owns the damping of its blocks.
      exit_callback: optional ``f(history_row) -> bool`` of ONE lane, the
        analog of SetUserExitCallback (nonlinear.hpp:153-157): it gets that
        lane's row of the iteration history just written (an
        ``NLSIterationHistory`` whose leaves lack the iteration axis; an
        empty buffer, such as ``qp_eigenvalues`` when not logged, passes
        through whole) and returns a bool tensor; False ends a lane still
        running with ``USER_CALLBACK``. It runs under ``torch.func.vmap``
        over the batch's rows, as the residuals do, so it must be written
        in tensor operations: Python control flow on a value (``if
        row.lam > 1``) cannot run under vmap. Requires ``record_history``.

    ``axis_name`` and ``distributed_cg_preconditioner`` keep the JAX
    signature and raise ``NotImplementedError`` (ROADMAP item 9).

    Returns an ``NLSResult`` whose every leaf has the leading batch
    dimension.
    """
    from .assertions import validate_problem

    _check_ported(
        params, exit_callback, axis_name,
        (cg_diag_preconditioner, cg_preconditioner, distributed_cg_preconditioner),
    )
    x0, data = _as_batch(x0, data, device)
    problem, params, retraction, proto = _unwrap_lifted(problem, params, retraction, data)
    if params.early_exit is None:
        params = dataclasses.replace(params, early_exit=resolve_early_exit(None))
    validate_problem(proto)
    if x0.shape[1] != proto.dimension:
        raise ValueError(f"x0 has {x0.shape[1]} columns, the problem {proto.dimension} variables")
    ineq_var = _ineq_var(proto)

    B = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    use_ns = _uses_null_space(proto)
    has_eq = len(proto.equality_constraints) > 0
    max_probes = params.max_line_search_iterations + 1
    fused_qp = params.qp_solver == "pallas_fused"
    use_cg = params.qp_solver == "cg"
    cg_bounds = None
    if use_cg and proto.inequality_constraints:
        # Once per solve, on the iterate's device: (B, n) each.
        if data is None or not any(torch.is_tensor(c_.a) or torch.is_tensor(c_.b)
                                   for c_ in proto.inequality_constraints):
            cg_bounds = tuple(t.expand(B, -1) for t in _box_bounds(proto, dtype, dev))
        else:
            cg_bounds = _per_lane(lambda p, xr: _box_bounds(p, dtype, dev), problem, x0, data)
        x0 = torch.clamp(x0, cg_bounds[0], cg_bounds[1])
        retraction = _Clamped(retraction, *cg_bounds)

    def cg_lane(prob, x, lam, *lohi):
        dx, err, der, l_inf = _cg_step_direction(
            prob, x, lam, params, cg_diag_preconditioner, None, lohi or None, cg_preconditioner)
        return dx, err.f, err.equality, der.d_f, der.d_equality, l_inf if l_inf is not None else err.equality

    qp_params = QPInteriorPointParams(
        max_iterations=params.max_qp_iterations,
        termination_kkt_tol=params.termination_kkt_tolerance,
        initial_mu=1.0,
        sigma=params.qp_sigma,
        barrier_strategy=params.qp_barrier_strategy,
        initialize_mu_with_complementarity=False,
        initial_guess_method=(
            params.qp_initial_guess_method
            if params.qp_initial_guess_method is not None
            else (InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED if has_eq else InitialGuessMethod.NAIVE)
        ),
        kkt_solver=params.kkt_solver,
        record_history=params.record_history,
        early_exit=params.early_exit,
        unroll=params.inner_unroll,
    )
    if fused_qp:
        from .ops.fused_qp import make_fused_qp_solver

        fused = make_fused_qp_solver(
            ineq_var,
            params.max_qp_iterations,
            params.qp_sigma,
            "mpc" if params.qp_barrier_strategy == BarrierStrategy.PREDICTOR_CORRECTOR else "complementarity",
            has_eq,
        )

    fuse = params.fuse_probe_linearize
    ineq_var_t = torch.tensor(ineq_var, dtype=torch.long, device=dev) if fuse else None

    def body(carry: _NLSCarry) -> _NLSCarry:
        x, lam, penalty, opt_state, i = carry.x, carry.lam, carry.penalty, carry.opt_state, carry.it
        zero = torch.zeros_like(lam)
        # --- step direction (nonlinear.cc:216-259) ---------------------------
        qp_hist_row = None
        qp_kkt_final = zero
        lagrange_l_inf = None
        if use_cg:
            dx, f_pre, eq_pre, d_f, d_eq, l_inf = _per_lane(cg_lane, problem, x, data, lam, *(cg_bounds or ()))
            errors_pre = Errors(f=f_pre, equality=eq_pre)
            derivatives = DirectionalDerivatives(d_f=d_f, d_equality=d_eq)
            qp_indefinite = ~torch.isfinite(dx).all(-1)
            dx = _where_lane(qp_indefinite, torch.zeros_like(dx), dx)
            qp_term = torch.where(
                qp_indefinite,
                _i32(QPTerminationState.FAILED_FACTORIZATION, i),
                _i32(QPTerminationState.MAX_ITERATIONS, i),
            )
            qp_iters = _i32(params.cg_iterations, i)
            if has_eq:
                lagrange_l_inf = l_inf
        else:
            if fuse:
                # The accepted probe's linearization, carried from the last
                # line search (or x0's), damped here.
                qp_raw, errors_pre = _unpack_lin(carry.lin, ineq_var_t)
                qp = _damp(qp_raw, lam)
            else:
                qp, errors_pre = linearize_and_fill_qp(problem, x, lam, data=data, ineq_var=ineq_var)
            if use_ns:
                with annotate("ComputeStepDirection"):
                    ns = qp_null_space_solve(qp)
                dx = ns.x
                # Any failure ends the outer loop through QP_INDEFINITE (the
                # reference's early return, nonlinear.cc:103-105).
                qp_indefinite = ns.termination_state != QPNullSpaceTerminationState.SUCCESS
                qp_term = ns.termination_state
                qp_iters = torch.zeros_like(i)
            elif fused_qp:
                with annotate("ComputeStepDirection"):
                    dx, y_qp = fused(qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b)
                qp_indefinite = ~torch.isfinite(dx).all(-1)
                dx = _where_lane(qp_indefinite, torch.zeros_like(dx), dx)
                qp_term = torch.where(
                    qp_indefinite,
                    _i32(QPTerminationState.FAILED_FACTORIZATION, i),
                    _i32(QPTerminationState.MAX_ITERATIONS, i),
                )
                qp_iters = _i32(params.max_qp_iterations, i)
                if has_eq:
                    lagrange_l_inf = y_qp.abs().amax(-1)
            else:
                with annotate("ComputeStepDirection"):
                    ipres = qp_ip_solve(qp, qp_params)
                dx = ipres.x
                # The reference throws FailedFactorization here; the lane ends
                # with QP_INDEFINITE instead.
                qp_indefinite = ipres.termination_state == QPTerminationState.FAILED_FACTORIZATION
                qp_term = ipres.termination_state
                qp_iters = ipres.num_iterations
                if params.record_history:
                    last = torch.clamp_min(ipres.num_iterations - 1, 0)
                    qp_kkt_final = tree_map(lambda a: _get_row(a, last), ipres.iterations.kkt_final).max()
                    qp_hist_row = ipres.iterations
                if has_eq:
                    lagrange_l_inf = ipres.lagrange_multipliers.l_infinity
            derivatives = compute_qp_cost_derivative(qp, dx)

        # --- penalty update (nonlinear.cc:112-118) ---------------------------
        if has_eq:
            # The CG path has no QP object: select_penalty takes the eq-18.32
            # multiplier branch (its multipliers always exist).
            new_penalty = select_penalty(None if use_cg else qp, dx, lagrange_l_inf, params.equality_penalty_rho)
            penalty = torch.where(
                new_penalty > penalty, new_penalty * params.equality_penalty_scale_factor, penalty
            )

        # --- line search -----------------------------------------------------
        ls_out = select_step_size(
            problem, params, x, dx, errors_pre, derivatives, penalty, retraction, data=data, ineq_var=ineq_var
        )
        step_result, candidate, cand_errors, steps = ls_out[:4]

        # --- lambda update + exit conditions (nonlinear.cc:296-343) ----------
        success = step_result == StepSizeSelectionResult.SUCCESS
        x_next = _where_lane(success, candidate, x)
        lam_decrease = torch.where(
            opt_state == OptimizerState.ATTEMPTING_RESTORE_LM,
            torch.full_like(lam, params.lambda_decrease_on_restore),
            torch.full_like(lam, params.lambda_decrease_on_success),
        )
        lam_on_success = torch.clamp_min(lam * lam_decrease, params.min_lambda)
        failed = (step_result == StepSizeSelectionResult.MAX_ITERATIONS) | (
            step_result == StepSizeSelectionResult.POSITIVE_DERIVATIVE
        )
        lam_on_fail = torch.where(
            opt_state == OptimizerState.NOMINAL,
            torch.clamp_min(lam * 10.0, params.lambda_failure_init),
            lam * 10.0,
        )
        lam_next = torch.where(success, lam_on_success, torch.where(failed, lam_on_fail, lam))
        state_next = torch.where(
            success,
            _i32(OptimizerState.NOMINAL, i),
            torch.where(failed, _i32(OptimizerState.ATTEMPTING_RESTORE_LM, i), opt_state),
        )
        exit_abs = success & (cand_errors.l_infinity() < params.absolute_exit_tol)
        exit_rel = success & (
            cand_errors.total(penalty) > errors_pre.total(penalty) * (1.0 - params.relative_exit_tol)
        )
        exit_first_order = step_result == StepSizeSelectionResult.FIRST_ORDER_SATISFIED
        exit_max_lambda = failed & (lam_next > params.max_lambda)
        status = torch.where(
            qp_indefinite,
            _i32(NLSTerminationState.QP_INDEFINITE, i),
            torch.where(
                exit_abs,
                _i32(NLSTerminationState.SATISFIED_ABSOLUTE_TOL, i),
                torch.where(
                    exit_rel,
                    _i32(NLSTerminationState.SATISFIED_RELATIVE_TOL, i),
                    torch.where(
                        exit_first_order,
                        _i32(NLSTerminationState.SATISFIED_FIRST_ORDER_TOL, i),
                        torch.where(
                            exit_max_lambda,
                            _i32(NLSTerminationState.MAX_LAMBDA, i),
                            _i32(NLSTerminationState.NONE, i),
                        ),
                    ),
                ),
            ),
        )
        # On QP_INDEFINITE nothing is applied (the reference returns before
        # the line search).
        x_next = _where_lane(qp_indefinite, x, x_next)
        lam_next = torch.where(qp_indefinite, lam, lam_next)
        state_next = torch.where(qp_indefinite, opt_state, state_next)
        lin_next = carry.lin
        if fuse:
            # Adopt the winning probe's linearization only where its
            # candidate was adopted; else keep x's.
            adopt = success & ~qp_indefinite
            lin_next = tree_map(lambda nv, ov: _where_lane(adopt, nv, ov), _pack_lin(*ls_out[4]), carry.lin)

        # --- record history (nonlinear.cc:132-143) ---------------------------
        h = carry.history
        if params.record_history:
            def put(buf, v):
                return _set_row(buf, i, v)

            h = NLSIterationHistory(
                optimizer_state=put(h.optimizer_state, opt_state),
                lam=put(h.lam, lam),
                errors_initial=tree_map(put, h.errors_initial, errors_pre),
                directional_derivatives=tree_map(put, h.directional_derivatives, derivatives),
                penalty=put(h.penalty, penalty),
                step_result=put(h.step_result, step_result),
                qp_termination_state=put(h.qp_termination_state, qp_term),
                qp_num_iterations=put(h.qp_num_iterations, qp_iters),
                qp_kkt_final_max=put(h.qp_kkt_final_max, qp_kkt_final),
                line_search=tree_map(put, h.line_search, steps),
                qp_eigenvalues=h.qp_eigenvalues,
                qp_iterations=(
                    tree_map(put, h.qp_iterations, qp_hist_row)
                    if qp_hist_row is not None
                    else h.qp_iterations
                ),
            )
            if params.log_qp_eigenvalues:
                h.qp_eigenvalues = QPEigenvalues(
                    *(put(buf, v) for buf, v in zip(
                        (h.qp_eigenvalues.min, h.qp_eigenvalues.max, h.qp_eigenvalues.abs_min), _eigen_summary(qp.G)
                    ))
                )
            if exit_callback is not None:
                # Empty (disabled) buffers pass through whole.
                row = tree_map(lambda a: _get_row(a, i) if a.shape[1] > 0 else a, h)
                proceed = _callback_proceed(exit_callback, row)
                status = torch.where(
                    (status == NLSTerminationState.NONE) & ~proceed, _i32(NLSTerminationState.USER_CALLBACK, i), status
                )
        return _NLSCarry(x_next, lam_next, penalty, state_next, i + 1, status, h, lin_next)

    def cond(carry: _NLSCarry):
        return (carry.status == NLSTerminationState.NONE) & (carry.it < params.max_iterations)

    it0 = torch.zeros(B, dtype=torch.int32, device=dev)
    rec = params.record_history
    init = _NLSCarry(
        x=x0,
        lam=torch.full((B,), params.lambda_initial, dtype=dtype, device=dev),
        penalty=torch.full((B,), params.equality_penalty_initial, dtype=dtype, device=dev),
        opt_state=_i32(OptimizerState.NOMINAL, it0),
        it=it0,
        status=_i32(NLSTerminationState.NONE, it0),
        history=NLSIterationHistory.empty(
            B,
            params.max_iterations if rec else 0,
            max_probes if rec else 0,
            dtype,
            dev,
            max_qp_iterations=params.max_qp_iterations if (rec and not use_ns) else 0,
            with_eigenvalues=params.log_qp_eigenvalues and rec,
        ),
        lin=_pack_lin(*_linearize_raw(problem, x0, data, ineq_var)) if fuse else None,
    )
    out = bounded_loop(cond, body, init, params.max_iterations, params.early_exit, params.outer_unroll)
    status = torch.where(
        out.status == NLSTerminationState.NONE, _i32(NLSTerminationState.MAX_ITERATIONS, it0), out.status
    )
    return NLSResult(
        termination_state=status,
        num_iterations=out.it,
        x=out.x,
        errors=evaluate_nonlinear_errors(problem, out.x, data=data),
        iterations=out.history,
        solver_variant=_i32(
            QPSolverVariant.MATRIX_FREE_CG
            if use_cg
            else (QPSolverVariant.NULL_SPACE if use_ns else QPSolverVariant.INTERIOR_POINT),
            it0,
        ),
    )
