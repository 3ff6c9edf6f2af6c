"""Implicit differentiation of solves via the KKT conditions, the port of
``mini_opt_tpu/implicit.py`` (implicit.py:38-195).

``make_implicit_solver`` returns ``solve(data, x0) -> x*`` for a batch: the
forward pass is the port's batched ``nls_solve``; the backward pass applies
the implicit function theorem to the stationarity conditions at the returned
solution, one linear solve per lane whatever the forward iteration count,
exact at a converged point.

Supported problem class, as in the JAX package: sum-of-squares costs with
optional nonlinear EQUALITY constraints and diagonal box INEQUALITY
constraints. Box constraints within ``active_tol`` of their bound at the
solution are treated as equalities (strict complementarity assumed);
inactive ones contribute ``z_m = 0`` so that shapes stay static. At a point
where the active set changes the solution map is nonsmooth and this returns
the one-sided derivative of the branch the solver landed on.

The backward is a ``torch.autograd.Function``: per lane under
``torch.func.vmap`` it computes what the JAX package's ``solve_bwd``
computes (the active mask, the least-squares multipliers with the 1e-12
ridge, ``A = jacfwd(F)`` of the KKT residual, ``lambda = A^-T [g_x; 0]``,
``data_bar = vjp(F wrt data)(-lambda)``); the dense solves are batched
``torch.linalg.solve_ex`` calls, so a singular lane gives that lane inf or
NaN, as ``jnp.linalg.solve`` does, and never fails the batch. One backward
pass gives every lane's vector-Jacobian product; a lane's full Jacobian
takes one pass per one-hot weight. ``torch.func`` transforms over ``solve``
are not supported: PyTorch raises for them (the Function defines no
``setup_context``), as it does for a second derivative.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable
from torch.func import grad, jacfwd, vjp, vmap

from .nonlinear import NLSParams, Problem, _as_batch, nls_solve
from .residual import BlockResidual, constraint_rows


def _eq_rows(eq, x):
    """Flattened residual rows of one equality constraint: a BlockResidual
    contributes ``constraint_rows(eq)`` rows."""
    if isinstance(eq, BlockResidual):
        return eq.error_vectors(x).reshape(-1)
    return eq.error_vector(x)


def _problem_value_and_constraints(problem: Problem, x):
    """f0(x) = 0.5 sum ||h_i||^2 and the stacked equality residuals g(x)."""
    f = torch.zeros((), dtype=x.dtype, device=x.device)
    for cost in problem.costs:
        r = cost.error_vectors(x) if isinstance(cost, BlockResidual) else cost.error_vector(x)
        f = f + 0.5 * torch.sum(r * r)
    if problem.equality_constraints:
        g = torch.cat([_eq_rows(eq, x) for eq in problem.equality_constraints])
    else:
        g = x.new_zeros((0,))
    return f, g


def _const(v, x):
    """``v`` (a Python number or a tensor) in ``x``'s dtype on its device; a
    number is filled there (no host-to-device copy)."""
    if torch.is_tensor(v):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _ineq_values(problem: Problem, x):
    """Constraint values a_m * x[v_m] + b_m, shape (M,)."""
    cons = problem.inequality_constraints
    if not cons:
        return x.new_zeros((0,))
    return torch.stack([_const(c.a, x) * x[c.variable] + _const(c.b, x) for c in cons])


def _kkt_residual(problem: Problem, x, y, z, act):
    """F(x, y, z) = [grad f + Jg^T y + A_act^T z; g; act (a x[v] + b) +
    (1 - act) z], zero at a KKT point with the active set ``act``."""

    def f0(xx):
        return _problem_value_and_constraints(problem, xx)[0]

    def g0(xx):
        return _problem_value_and_constraints(problem, xx)[1]

    grad_l = grad(f0)(x)
    g = g0(x)
    if g.shape[0] > 0:
        _, jg_vjp = vjp(g0, x)
        grad_l = grad_l + jg_vjp(y)[0]
    vals = _ineq_values(problem, x)
    if vals.shape[0] > 0:
        _, ji_vjp = vjp(lambda xx: _ineq_values(problem, xx), x)
        grad_l = grad_l + ji_vjp(act * z)[0]
        comp = act * vals + (1.0 - act) * z
    else:
        comp = vals
    return torch.cat([grad_l, g, comp])


class _Solver:
    """What the autograd Function needs of one ``make_implicit_solver``."""

    def __init__(self, problem_fn, params, retraction, active_tol):
        self.problem_fn = problem_fn
        self.params = params
        self.retraction = retraction
        self.active_tol = active_tol

    def forward(self, x0, data):
        return nls_solve(self.problem_fn, self.params, x0, retraction=self.retraction, data=data).x

    def backward(self, x, gx, data):
        """Every lane's ``data_bar`` for the cotangent ``gx (B, n)``."""
        problem_fn, tol = self.problem_fn, self.active_tol
        proto = problem_fn(tuple(t[0] for t in data) if isinstance(data, tuple) else data[0])
        n = proto.dimension
        k = sum(constraint_rows(eq) for eq in proto.equality_constraints)
        m = len(proto.inequality_constraints)

        def lane_setup(xr, dr):
            """The active mask, grad f and the stacked constraint Jacobian
            [Jg; act * Ji] of one lane (implicit.py:123-152, :166-173)."""
            problem = problem_fn(dr)
            vals = _ineq_values(problem, xr)
            act = (torch.abs(vals) <= tol).to(xr.dtype)
            grad_f = grad(lambda xx: _problem_value_and_constraints(problem, xx)[0])(xr)
            rows = []
            if k > 0:
                rows.append(jacfwd(lambda xx: _problem_value_and_constraints(problem, xx)[1])(xr))
            if m > 0:
                rows.append(act[:, None] * jacfwd(lambda xx: _ineq_values(problem, xx))(xr))
            J = torch.cat(rows, dim=0) if rows else xr.new_zeros((0, n))
            return act, grad_f, J

        act, grad_f, J = vmap(lane_setup)(x, data)
        B = x.shape[0]
        if k + m > 0:
            eye = torch.eye(k + m, dtype=x.dtype, device=x.device)
            JJt = J @ J.transpose(1, 2) + 1e-12 * eye
            mult = torch.linalg.solve_ex(JJt, -(J @ grad_f[:, :, None]))[0][:, :, 0]
            y, z = mult[:, :k], act * mult[:, k:]
        else:
            y = z = x.new_zeros((B, 0))

        def lane_matrix(xr, yr, zr, ar, dr):
            problem = problem_fn(dr)

            def F_xyz(xyz):
                return _kkt_residual(problem, xyz[:n], xyz[n : n + k], xyz[n + k :], ar)

            return jacfwd(F_xyz)(torch.cat([xr, yr, zr]))

        A = vmap(lane_matrix)(x, y, z, act, data)  # (B, n+k+m, n+k+m)
        rhs = torch.cat([gx, gx.new_zeros((B, k + m))], dim=1)
        lam = torch.linalg.solve_ex(A.transpose(1, 2), rhs[:, :, None])[0][:, :, 0]

        def lane_bar(xr, yr, zr, ar, lr, dr):
            _, f_vjp = vjp(lambda d: _kkt_residual(problem_fn(d), xr, yr, zr, ar), dr)
            return f_vjp(-lr)[0]

        return vmap(lane_bar)(x, y, z, act, lam, data)


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, solver, packed, x0, *leaves):
        data = leaves if packed else leaves[0]
        x = solver.forward(x0, data)
        ctx.solver, ctx.packed = solver, packed
        ctx.save_for_backward(x, *leaves)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, gx):
        x, *leaves = ctx.saved_tensors
        data = tuple(leaves) if ctx.packed else leaves[0]
        bar = ctx.solver.backward(x, gx, data)
        bars = tuple(bar) if ctx.packed else (bar,)
        x0_bar = torch.zeros_like(x) if ctx.needs_input_grad[2] else None
        return (None, None, x0_bar) + bars


def make_implicit_solver(
    problem_fn: Callable[..., Problem],
    params: NLSParams,
    retraction=None,
    active_tol: float = 1.0e-6,
) -> Callable:
    """Build ``solve(data, x0, device=None) -> x*`` that is differentiable
    in ``data`` through the KKT conditions at the solution.

    ``problem_fn(data_row) -> Problem`` builds ONE instance (costs, equality
    constraints, diagonal box inequality constraints whose a/b may depend on
    the data row); ``data`` is a ``(B, ...)`` floating tensor or a tuple of
    them, ``x0`` is ``(B, n)``; numpy inputs go to ``device`` (the card
    unless the caller names one). ``active_tol`` classifies a box constraint
    as active when |a x[v] + b| <= active_tol at the solution. The gradient
    for ``x0`` is zero, as in the JAX package.
    """
    solver = _Solver(problem_fn, params, retraction, active_tol)

    def solve(data, x0, device=None):
        x0, data = _as_batch(x0, data, device)
        packed = isinstance(data, tuple)
        leaves = data if packed else (data,)
        return _ImplicitSolve.apply(solver, packed, x0, *leaves)

    return solve
