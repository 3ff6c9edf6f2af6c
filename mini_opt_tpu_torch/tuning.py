"""Serving-budget autotuner, the port of ``mini_opt_tpu/tuning.py`` (a copy:
the module is plain numpy; the port keeps its own). It finds the converged
(outer, qp, ls) minimum of a fixed-trip serving kernel:

    result = tune_serving_budget(solve, gate)
    result.budget          # e.g. (4, 2, 1)
    result.trace           # every lattice point evaluated, with margins

``solve(outer, qp, ls)`` runs the family's batch solve at one budget; on the
card the budgets are run-time arguments of the port's kernels, so a lattice
point is a launch, not a build. ``gate(solutions, reference)`` decides
whether a budget's solutions are acceptable, where ``reference`` is the
solutions at ``max_budget`` (the converged anchor); absolute gates ignore
the second argument. ``parity_gate`` takes numpy arrays or tensors on any
device (moved to the host before numpy).

Search: coordinate descent with per-coordinate binary search, iterated to a
fixed point, walking (outer, qp, ls) in that order (outer iterations
dominate cost; ls is nearly free on the parallel kernels). The result is
component-wise minimal: no coordinate can be reduced further while the
others hold. Cost: O(log budget) solves per coordinate per sweep, ~10-15
solves for the 10x6x2 lattice against 180 exhaustive. A distribution shift
invalidates a tuned budget: re-run the tuner when the instance distribution
moves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

Budget = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class BudgetPoint:
    """One evaluated lattice point."""

    budget: Budget
    ok: bool
    margin: float  # gate margin; >= 0 iff ok (gate-defined units)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    budget: Budget  # the converged minimum found
    max_budget: Budget  # the anchor the gate compared against
    trace: Tuple[BudgetPoint, ...]  # evaluation order, deduplicated
    n_evaluations: int  # number of distinct solves (== len(trace))

    def margin_at(self, budget: Budget) -> float:
        for p in self.trace:
            if p.budget == tuple(budget):
                return p.margin
        raise KeyError(budget)


def _host(a) -> np.ndarray:
    """A numpy array of ``a``: a tensor (on the card or not) is detached and
    copied to the host first."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def parity_gate(
    tol: float,
    frac: float = 1.0,
    metric: Optional[Callable] = None,
):
    """Gate: at least ``frac`` of instances within ``tol`` of the reference
    (max-budget) solutions.  ``metric(solutions, reference) -> (B,) errors``
    defaults to the per-instance infinity norm of the solution delta; pass a
    problem-space metric (e.g. effector error against targets) to gate on
    what the family actually serves.  Margin = pass fraction - frac."""

    def gate(solutions, reference):
        if metric is not None:
            err = _host(metric(solutions, reference))
        else:
            err = np.abs(_host(solutions) - _host(reference)).max(axis=-1)
        ok_frac = float((err <= tol).mean())
        return ok_frac >= frac, ok_frac - frac

    return gate


def tune_serving_budget(
    solve: Callable[[int, int, int], object],
    gate: Callable[[object, object], Tuple[bool, float]],
    max_budget: Budget = (10, 6, 2),
    min_budget: Budget = (1, 1, 0),
    max_sweeps: int = 4,
    verbose: bool = False,
) -> TuneResult:
    """Walk the (outer, qp, ls) lattice to the component-wise minimal budget
    whose solutions still pass ``gate`` against the ``max_budget`` anchor.

    Monotonicity along each coordinate is assumed for the binary search (more
    iterations never hurt -- the fused kernels' best-merit return makes this
    hold in practice even past convergence); the fixed-point sweep plus the
    final decrement check below it catch mild non-monotonicity.

    Raises ``ValueError`` if ``max_budget`` itself fails its own gate (a gate
    stricter than the anchor can satisfy).

    SERVING POLICY: a budget that passes with margin ~0 is NOT servable
    as-is -- margin 0 means the gate held with zero headroom on ONE
    evaluation of one distribution, and any drift (data, floating-point
    context, precision) can flip it. Ship the found budget only if its
    margin is comfortably positive; otherwise ship one step above it on the
    binding axis (bench.py ships planar (4, 2, 1) although the tuner found
    (4, 1, 1) at margin 0, for exactly this reason). The returned trace
    carries each point's margin for the call.
    """
    max_budget = tuple(int(v) for v in max_budget)
    min_budget = tuple(int(v) for v in min_budget)
    assert all(lo <= hi for lo, hi in zip(min_budget, max_budget))

    reference = solve(*max_budget)
    memo: dict = {}
    trace: List[BudgetPoint] = []

    def evaluate(budget: Budget) -> BudgetPoint:
        budget = tuple(int(v) for v in budget)
        if budget in memo:
            return memo[budget]
        if budget == max_budget:
            ok, margin = gate(reference, reference)
        else:
            ok, margin = gate(solve(*budget), reference)
        point = BudgetPoint(budget, bool(ok), float(margin))
        memo[budget] = point
        trace.append(point)
        if verbose:
            print(f"tune: {budget} -> {'ok' if ok else 'FAIL'} ({margin:+.4g})")
        return point

    anchor = evaluate(max_budget)
    if not anchor.ok:
        raise ValueError(
            f"max_budget {max_budget} fails its own gate "
            f"(margin {anchor.margin:+.4g}); loosen the gate or raise the anchor"
        )

    current = list(max_budget)
    for _ in range(max_sweeps):
        changed = False
        for axis in range(3):
            lo, hi = min_budget[axis], current[axis]
            # Binary search the smallest passing value on this axis.
            while lo < hi:
                mid = (lo + hi) // 2
                budget = tuple(current[:axis] + [mid] + current[axis + 1 :])
                if evaluate(budget).ok:
                    hi = mid
                else:
                    lo = mid + 1
            if hi < current[axis]:
                current[axis] = hi
                changed = True
        if not changed:
            break

    # Confirm component-wise minimality (also records the failing margins
    # one step below the result, useful when reading the trace).
    for axis in range(3):
        if current[axis] > min_budget[axis]:
            below = tuple(
                current[:axis] + [current[axis] - 1] + current[axis + 1 :]
            )
            evaluate(below)

    return TuneResult(
        budget=tuple(current),
        max_budget=max_budget,
        trace=tuple(trace),
        n_evaluations=len(trace),
    )


def budget_cost(budget: Budget, per_outer: float = 2.0) -> float:
    """Rough fixed-trip cost model: outer * (per_outer + qp + 0.5 * ls).
    Only used for reporting/comparison -- the tuner itself is gate-driven."""
    outer, qp, ls = budget
    return outer * (per_outer + qp + 0.5 * ls)
