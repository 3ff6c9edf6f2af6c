"""Nonlinear inequality constraints via slack reformulation, the port of
``mini_opt_tpu/ineq.py`` (ineq.py:56-203).

Each user constraint ``g(x) >= 0`` gains a slack vector ``s`` and becomes

    g(x) - s = 0      (nonlinear equality, handled by the L1-merit SQP loop)
    s >= 0            (diagonal box constraint, handled by the IP inner QP)

(Nocedal & Wright, Numerical Optimization 2nd ed., eq. 18.10-18.12), so the
augmented problem is of the class ``nls_solve`` already handles.

``nls_solve`` (and ``solve_batch``) take the :class:`NonlinearInequalityProblem`
wrapper directly, or a per-lane ``data_row -> wrapper`` function: they solve
``.problem`` with ``qp_initial_guess_method=NAIVE`` forced (``.params``) and
lift a base-problem retraction to the augmented space (``.wrap_retraction``).
The structure-driven SOLVE_EQUALITY_CONSTRAINED warm start clamps slacks onto
their bound whenever the equality-only step violates ``s >= 0``; the
``s = max(1e-9, .)`` heuristic then weights the slack identity block of
``A_eq`` by 1e-18 in the condensed system, and because slackened rows are
often dependent in the base columns, the condensed KKT matrix becomes
singular in float64.

The helpers take ONE instance, as in the JAX package, or a ``(B, n)`` batch,
for which they compute what JAX's ``vmap`` of them computes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from .nonlinear import NLSParams, Problem
from .qp import Var
from .residual import Residual
from .structs import InitialGuessMethod


def _slackened(g: Residual, slack_index: Tuple[int, ...]) -> Residual:
    """``g(x) >= 0``  ->  equality residual ``g(x_g) - s`` over
    ``index = g.index + slack_index``."""
    p = len(g.index)

    def fn(xl):
        return g.fn(xl[:p]) - xl[p:]

    jac = None
    if g.jac is not None:

        def jac(xl):  # noqa: F811 - deliberate rebind
            r, J = g.jac(xl[:p])
            eye = torch.eye(g.dim, dtype=J.dtype, device=J.device)
            return r - xl[p:], torch.cat([J, -eye], dim=1)

    return Residual(fn=fn, index=tuple(g.index) + tuple(slack_index), dim=g.dim, jac=jac)


def _per_instance(fn, x, *rest):
    """``fn`` of one instance, or of every row of a ``(B, n)`` batch under
    vmap."""
    return vmap(fn)(x, *rest) if x.dim() > 1 else fn(x, *rest)


@dataclasses.dataclass(frozen=True)
class NonlinearInequalityProblem:
    """An augmented :class:`Problem` whose trailing ``slack_dim`` variables
    are slacks for nonlinear inequality constraints ``g(x) >= 0``.

    Feed the wrapper (or ``.problem`` with ``.params(base)``) and
    ``.initial_guess(x0)`` to ``nls_solve``; read the base solution back with
    ``.extract``.
    """

    problem: Problem
    base_dimension: int
    inequalities: Tuple[Residual, ...]

    @property
    def slack_dim(self) -> int:
        return self.problem.dimension - self.base_dimension

    def initial_guess(self, x0, margin: float = 1.0e-2):
        """Augment ``x0`` with slacks ``s = max(g(x0), margin)``: a strictly
        positive floor keeps the inner QP away from the boundary at the first
        linearization even when ``x0`` violates ``g``."""
        if not self.inequalities:
            return x0

        def one(x):
            floor = torch.full((), margin, dtype=x.dtype, device=x.device)
            return torch.cat([x] + [torch.maximum(g.error_vector(x), floor) for g in self.inequalities])

        return _per_instance(one, x0)

    def extract(self, x_aug):
        """Base-problem variables from an augmented iterate (batched OK)."""
        return x_aug[..., : self.base_dimension]

    def slacks(self, x_aug):
        return x_aug[..., self.base_dimension :]

    def wrap_retraction(self, retraction: Callable) -> Callable:
        """Lift a base-problem retraction to the augmented space: the user
        retraction acts on the first ``base_dimension`` coordinates, slacks
        update by plain addition. The lifted retraction takes one instance
        ``(x, dx, alpha)`` or a batch ``(B, n), (B, n), (B,)``."""
        n = self.base_dimension

        def one(x, dx, alpha):
            head = retraction(x[:n], dx[:n], alpha)
            return torch.cat([head, x[n:] + alpha * dx[n:]])

        def retract(x, dx, alpha):
            return _per_instance(one, x, dx, alpha)

        return retract

    def constraint_values(self, x_aug):
        """Stacked ``g(x)`` at an augmented iterate (the true constraint
        values at the extracted base point, not the slacks); a ``(B, n_aug)``
        batch maps over its rows."""

        def one(x):
            base = self.extract(x)
            return torch.cat([g.error_vector(base) for g in self.inequalities])

        return _per_instance(one, x_aug)

    def params(self, base: Optional[NLSParams] = None) -> NLSParams:
        """A solver configuration safe for this augmented problem: forces
        ``qp_initial_guess_method=NAIVE`` (see the module docstring);
        ``nls_solve`` applies the same override when handed this wrapper."""
        base = base if base is not None else NLSParams()
        if base.qp_initial_guess_method == InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED:
            raise ValueError(
                "SOLVE_EQUALITY_CONSTRAINED warm starts are singular on "
                "slack-lifted problems; use NAIVE (the default here)"
            )
        return dataclasses.replace(base, qp_initial_guess_method=InitialGuessMethod.NAIVE)


def with_nonlinear_inequalities(
    problem: Problem,
    inequalities: Sequence[Residual],
    extra_costs_on_slack: Sequence[Residual] = (),
) -> NonlinearInequalityProblem:
    """Augment ``problem`` with nonlinear inequality constraints
    ``g_i(x) >= 0`` given as :class:`Residual` blocks.

    The augmented ``problem`` has dimension ``problem.dimension + sum(g.dim)``:
    each ``g_i`` becomes the nonlinear equality ``g_i(x) - s_i = 0`` plus box
    rows ``s_i >= 0`` (N&W 18.12); existing costs, equalities and box rows
    are untouched. ``extra_costs_on_slack`` may add regularizers over
    augmented indices.
    """
    ineqs = tuple(inequalities)
    n = problem.dimension
    for k, g in enumerate(ineqs):
        if max(g.index) >= n:
            raise ValueError(
                f"inequality residual {k} references variable "
                f"{max(g.index)} but the base problem has dimension {n}; "
                "indices in [n, n+slack_dim) would alias another "
                "constraint's slack column"
            )
    offset = n
    eqs = list(problem.equality_constraints)
    box = list(problem.inequality_constraints)
    for g in ineqs:
        sidx = tuple(range(offset, offset + g.dim))
        eqs.append(_slackened(g, sidx))
        box.extend(Var(j) >= 0.0 for j in sidx)
        offset += g.dim
    aug = Problem(
        dimension=offset,
        costs=tuple(problem.costs) + tuple(extra_costs_on_slack),
        equality_constraints=tuple(eqs),
        inequality_constraints=tuple(box),
    )
    return NonlinearInequalityProblem(problem=aug, base_dimension=n, inequalities=ineqs)
