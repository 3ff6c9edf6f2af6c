"""Host-side validation helpers, the port of ``mini_opt_tpu/assertions.py``.

Rich errors raised eagerly when a problem is built or a solve starts;
failures during a solve surface as per-lane status codes instead
(``structs.QPTerminationState`` / ``NLSTerminationState``).
"""

from __future__ import annotations


class MiniOptError(AssertionError):
    """Default error type (assertions.hpp:49-58 analog)."""


def f_assert(cond: bool, msg: str = "", *args) -> None:
    if not cond:
        raise MiniOptError(msg.format(*args) if args else msg)


def f_assert_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise MiniOptError(f"expected {a!r} == {b!r}. {msg}")


def f_assert_lt(a, b, msg: str = "") -> None:
    if not a < b:
        raise MiniOptError(f"expected {a!r} < {b!r}. {msg}")


def f_assert_le(a, b, msg: str = "") -> None:
    if not a <= b:
        raise MiniOptError(f"expected {a!r} <= {b!r}. {msg}")


def f_assert_gt(a, b, msg: str = "") -> None:
    if not a > b:
        raise MiniOptError(f"expected {a!r} > {b!r}. {msg}")


def f_assert_ge(a, b, msg: str = "") -> None:
    if not a >= b:
        raise MiniOptError(f"expected {a!r} >= {b!r}. {msg}")


def validate_problem(problem) -> None:
    """Structural checks of a Problem, mirroring the reference's
    constructor/Setup assertions (nonlinear.cc:13-47, qp.cc:20-73)."""
    f_assert_gt(problem.dimension, 0, "Need at least one variable")
    for res in list(problem.costs) + list(problem.equality_constraints):
        idx = getattr(res, "index", None)
        if idx is None:
            # BlockResidual: check the index rows in bulk (large graphs
            # carry 10^4+ rows).
            block_idx = getattr(res, "indices", None)
            if isinstance(block_idx, tuple) and block_idx:
                import numpy as _np

                arr = _np.asarray(block_idx)
                idx = [int(arr.min()), int(arr.max())]
            else:
                continue
        for i in idx:
            f_assert_ge(i, 0, "Residual index must be non-negative")
            f_assert_lt(i, problem.dimension, "Residual index exceeds problem dimension")
    for c in problem.inequality_constraints:
        f_assert_ge(c.variable, 0, "Constraint index must be non-negative")
        f_assert_lt(c.variable, problem.dimension, "Constraint index is out of bounds")
        f_assert(bool(c.a != 0), "Constraint coefficient `a` cannot be zero")
