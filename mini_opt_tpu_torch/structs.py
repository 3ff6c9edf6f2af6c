"""Status enums of the solver, the PyTorch port's copy of
``mini_opt_tpu/structs.py``'s enum block.

Names and integer values are identical to the JAX package's, so an int32
status produced by either package compares directly with the other's. The
result and history containers of the general path are not ported yet.
"""

from __future__ import annotations

import enum


class BarrierStrategy(enum.IntEnum):
    """How the interior-point barrier parameter mu is updated each iteration
    (structs.hpp:24-31)."""

    COMPLEMENTARITY = 0
    FIXED_DECREASE = 1
    PREDICTOR_CORRECTOR = 2


class InitialGuessMethod(enum.IntEnum):
    """QP interior-point initial guess selection (structs.hpp:34-41)."""

    NAIVE = 0
    SOLVE_EQUALITY_CONSTRAINED = 1
    USER_PROVIDED = 2


class LineSearchStrategy(enum.IntEnum):
    """Line search method for the nonlinear solver (structs.hpp:148-153)."""

    ARMIJO_BACKTRACK = 0
    POLYNOMIAL_APPROXIMATION = 1


class OptimizerState(enum.IntEnum):
    """LM restore state machine of the outer loop (structs.hpp:159-164)."""

    NOMINAL = 0
    ATTEMPTING_RESTORE_LM = 1


class StepSizeSelectionResult(enum.IntEnum):
    """Outcome of the line search (structs.hpp:215-228)."""

    SUCCESS = 0
    MAX_ITERATIONS = 1
    FIRST_ORDER_SATISFIED = 2
    POSITIVE_DERIVATIVE = 3
    FAILURE_NON_FINITE_COST = 4
    FAILURE_INVALID_ALPHA = 5


class QPTerminationState(enum.IntEnum):
    """Interior-point termination (structs.hpp:97-102), plus a numerical
    failure code in place of the reference's FailedFactorization exception
    (qp.cc:303-307) and a named infeasible warm start (qp.hpp:326-328)."""

    SATISFIED_KKT_TOL = 0
    MAX_ITERATIONS = 1
    FAILED_FACTORIZATION = 2
    INFEASIBLE_GUESS = 3


class QPNullSpaceTerminationState(enum.IntEnum):
    """Null-space solver termination (structs.hpp:137-142), plus a
    rank-deficiency status for an inconsistent degenerate constraint set."""

    SUCCESS = 0
    NOT_POSITIVE_DEFINITE = 1
    CONSTRAINT_RANK_DEFICIENT = 2


class QPSolverVariant(enum.IntEnum):
    """Which inner-QP solver an NLS solve used (structs.hpp:307)."""

    INTERIOR_POINT = 0
    NULL_SPACE = 1
    MATRIX_FREE_CG = 2


class NLSTerminationState(enum.IntEnum):
    """Nonlinear solve termination (structs.hpp:233-248). NONE is the
    in-progress sentinel."""

    NONE = -1
    MAX_ITERATIONS = 0
    SATISFIED_ABSOLUTE_TOL = 1
    SATISFIED_RELATIVE_TOL = 2
    SATISFIED_FIRST_ORDER_TOL = 3
    MAX_LAMBDA = 4
    QP_INDEFINITE = 5
    USER_CALLBACK = 6
