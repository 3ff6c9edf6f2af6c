"""Status enums and result containers of the solver, the PyTorch port of
``mini_opt_tpu/structs.py``.

Enum names and integer values are identical to the JAX package's, so an
int32 status produced by either package compares directly with the other's.
The containers are dataclasses of batched tensors: every leaf carries the
leading batch dimension B that JAX's ``vmap`` gives the same leaf, so
``result.iterations.line_search.alpha`` is ``(B, iterations, probes)`` in
both packages. The string renderers (``qp_iteration_to_string``,
``nls_result_to_string``) take one lane, what ``tree_map(lambda t: t[i],
result)`` gives, as the JAX package's take one unbatched result;
``summarize_counts`` takes the batch.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


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


def termination_state_indicates_satisfied_tol(state):
    """TerminationStateIndicatesSatisfiedTol (structs.hpp:250-261), per
    lane."""
    return (
        (state == NLSTerminationState.SATISFIED_ABSOLUTE_TOL)
        | (state == NLSTerminationState.SATISFIED_RELATIVE_TOL)
        | (state == NLSTerminationState.SATISFIED_FIRST_ORDER_TOL)
    )


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf to tensors held in dataclasses and tuples
    (named or plain) of the same structure; None stays None."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(
            **{
                f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                for f in dataclasses.fields(tree)
            }
        )
    if isinstance(tree, tuple):
        items = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


# ---------------------------------------------------------------------------
# Small value containers; every field is a (B,) tensor unless noted.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KKTError:
    """L2 norms of the four first-order KKT residuals (structs.hpp:68-78)."""

    r_dual: torch.Tensor
    r_comp: torch.Tensor
    r_primal_eq: torch.Tensor
    r_primal_ineq: torch.Tensor

    def max(self):
        return torch.maximum(
            torch.maximum(self.r_dual, self.r_comp),
            torch.maximum(self.r_primal_eq, self.r_primal_ineq),
        )


@dataclasses.dataclass
class Errors:
    """Nonlinear cost components (structs.hpp:169-186): ``f`` is the sum of
    squared residual costs, ``equality`` the L1 norm of equality-constraint
    violations."""

    f: torch.Tensor
    equality: torch.Tensor

    def total(self, penalty):
        return self.f + penalty * self.equality

    def l_infinity(self):
        return torch.maximum(self.f, self.equality)

    def contains_invalid_values(self):
        return ~(torch.isfinite(self.f) & torch.isfinite(self.equality))


@dataclasses.dataclass
class DirectionalDerivatives:
    """Directional derivatives of ``Errors`` along the QP step
    (structs.hpp:189-203)."""

    d_f: torch.Tensor
    d_equality: torch.Tensor

    def total(self, penalty):
        return self.d_f + penalty * self.d_equality

    def l_infinity(self):
        return torch.maximum(torch.abs(self.d_f), torch.abs(self.d_equality))


@dataclasses.dataclass
class AlphaValues:
    """Fraction-to-boundary step sizes (structs.hpp:45-50)."""

    primal: torch.Tensor
    dual: torch.Tensor


@dataclasses.dataclass
class QPLagrangeMultipliers:
    """Summary of equality-constraint multipliers (structs.hpp:108-113)."""

    min: torch.Tensor
    l_infinity: torch.Tensor


# ---------------------------------------------------------------------------
# Stacked iteration histories: row i of the axis after B is iteration i.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QPIterationHistory:
    """Stacked analog of vector<QPInteriorPointIteration>
    (structs.hpp:81-94). Leaves are ``(B, max_iterations)`` (with more
    leading axes when nested in an NLS history); rows at index >=
    ``num_iterations`` keep their initial values."""

    kkt_initial: KKTError
    kkt_final: KKTError
    mu: torch.Tensor
    alpha: AlphaValues
    alpha_probe: AlphaValues
    mu_affine: torch.Tensor

    @staticmethod
    def empty(shape, dtype=torch.float64, device=None) -> "QPIterationHistory":
        """Zeros of ``shape`` (alpha: ones), the JAX package's initial
        buffers: alpha_probe and mu_affine are 0 when the predictor-corrector
        is unused."""
        def v():
            return torch.zeros(shape, dtype=dtype, device=device)

        return QPIterationHistory(
            kkt_initial=KKTError(v(), v(), v(), v()),
            kkt_final=KKTError(v(), v(), v(), v()),
            mu=v(),
            alpha=AlphaValues(torch.ones_like(v()), torch.ones_like(v())),
            alpha_probe=AlphaValues(v(), v()),
            mu_affine=v(),
        )


@dataclasses.dataclass
class QPIPResult:
    """Result of the interior-point QP solve; analog of
    QPInteriorPointSolverOutputs (structs.hpp:116-134) plus the final
    iterate. x (B, N), s and z (B, M), y (B, K)."""

    termination_state: torch.Tensor  # int32, QPTerminationState
    num_iterations: torch.Tensor  # int32
    x: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    iterations: QPIterationHistory
    lagrange_multipliers: QPLagrangeMultipliers  # zeros when K == 0


@dataclasses.dataclass
class QPNullSpaceResult:
    """Result of the null-space equality-constrained QP solve."""

    termination_state: torch.Tensor  # int32, QPNullSpaceTerminationState
    x: torch.Tensor  # (B, N)
    rank: torch.Tensor  # int32 numerical rank of A_eq


@dataclasses.dataclass
class LineSearchHistory:
    """Stacked analog of vector<LineSearchStep> (structs.hpp:206-212):
    alpha, f and equality ``(B, max_steps)``, num_steps ``(B,)``."""

    alpha: torch.Tensor
    f: torch.Tensor
    equality: torch.Tensor
    num_steps: torch.Tensor  # int32

    @staticmethod
    def empty(batch, max_steps, dtype=torch.float64, device=None) -> "LineSearchHistory":
        def z():
            return torch.zeros((batch, max_steps), dtype=dtype, device=device)

        return LineSearchHistory(
            z(), z(), z(), torch.zeros((batch,), dtype=torch.int32, device=device)
        )


@dataclasses.dataclass
class QPEigenvalues:
    """Eigenvalue summary of the QP Hessian G (structs.hpp:267-274), per
    iteration: ``(B, max_iterations)``, or ``(B, 0)`` unless
    ``log_qp_eigenvalues``."""

    min: torch.Tensor
    max: torch.Tensor
    abs_min: torch.Tensor


@dataclasses.dataclass
class NLSIterationHistory:
    """Stacked analog of vector<NLSIteration> (structs.hpp:277-326). Leaves
    are ``(B, max_iterations)``; line-search leaves ``(B, max_iterations,
    max_steps)``; ``qp_eigenvalues`` ``(B, max_iterations)`` or ``(B, 0)``
    unless logged; the nested QP telemetry ``(B, max_iterations,
    max_qp_iterations)``, with a zero-size last axis when not recorded
    (null-space path, fused QP, history off)."""

    optimizer_state: torch.Tensor  # int32
    lam: torch.Tensor  # lambda at iteration start
    errors_initial: Errors
    directional_derivatives: DirectionalDerivatives
    penalty: torch.Tensor
    step_result: torch.Tensor  # int32 StepSizeSelectionResult
    qp_termination_state: torch.Tensor  # int32 (IP or null-space enum)
    qp_num_iterations: torch.Tensor  # int32
    qp_kkt_final_max: torch.Tensor
    line_search: LineSearchHistory
    qp_eigenvalues: QPEigenvalues
    qp_iterations: QPIterationHistory

    @staticmethod
    def empty(
        batch,
        max_iterations,
        max_line_search_steps,
        dtype=torch.float64,
        device=None,
        max_qp_iterations=0,
        with_eigenvalues=False,
    ) -> "NLSIterationHistory":
        kw = dict(dtype=dtype, device=device)

        def v():
            return torch.zeros((batch, max_iterations), **kw)

        def i():
            return torch.zeros((batch, max_iterations), dtype=torch.int32, device=device)

        def ls():
            return torch.zeros((batch, max_iterations, max_line_search_steps), **kw)

        return NLSIterationHistory(
            optimizer_state=i(),
            lam=v(),
            errors_initial=Errors(v(), v()),
            directional_derivatives=DirectionalDerivatives(v(), v()),
            penalty=v(),
            step_result=i(),
            qp_termination_state=i(),
            qp_num_iterations=i(),
            qp_kkt_final_max=v(),
            line_search=LineSearchHistory(ls(), ls(), ls(), i()),
            qp_eigenvalues=QPEigenvalues(*(
                torch.zeros((batch, max_iterations if with_eigenvalues else 0), **kw) for _ in range(3)
            )),
            qp_iterations=QPIterationHistory.empty(
                (batch, max_iterations, max_qp_iterations), **kw
            ),
        )


@dataclasses.dataclass
class NLSResult:
    """Result of the nonlinear solve; analog of NLSSolverOutputs
    (structs.hpp:329-347) plus the final iterate, batch-first."""

    termination_state: torch.Tensor  # int32 NLSTerminationState
    num_iterations: torch.Tensor  # int32
    x: torch.Tensor  # (B, N) final linearization point
    errors: Errors  # nonlinear errors at the final iterate
    iterations: NLSIterationHistory
    # int32 QPSolverVariant per lane (the reference's variant key).
    solver_variant: torch.Tensor

    def num_qp_iterations(self):
        """Total inner-QP iterations per lane (structs.cc:208-214)."""
        return self.iterations.qp_num_iterations.sum(-1)

    def num_line_search_steps(self):
        """Total line-search probes per lane (structs.cc:216-222)."""
        return self.iterations.line_search.num_steps.sum(-1)

    def num_failed_line_searches(self):
        """Iterations whose step selection failed, per lane
        (structs.cc:224-236)."""
        sr = self.iterations.step_result
        valid = torch.arange(sr.shape[-1], device=sr.device) < self.num_iterations[..., None]
        failed = (
            (sr == StepSizeSelectionResult.MAX_ITERATIONS)
            | (sr == StepSizeSelectionResult.FAILURE_NON_FINITE_COST)
            | (sr == StepSizeSelectionResult.FAILURE_INVALID_ALPHA)
        )
        return (valid & failed).sum(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Human-readable rendering (host side; analog of structs.cc ToString).
# ---------------------------------------------------------------------------

_GREEN = "\x1b[32m"
_RED = "\x1b[31m"
_RESET = "\x1b[0m"


def _color(text: str, good: bool, use_color: bool) -> str:
    if not use_color:
        return text
    return f"{_GREEN if good else _RED}{text}{_RESET}"


def qp_iteration_to_string(history: QPIterationHistory, i: int) -> str:
    """Render interior-point iteration ``i`` of ONE lane's QP history
    (leaves ``(max_qp_iterations,)``; structs.cc:122-148 analog)."""
    ki, kf = history.kkt_initial, history.kkt_final

    def _row(k: KKTError) -> str:
        return (
            f"dual={float(k.r_dual[i]):.3e} comp={float(k.r_comp[i]):.3e} "
            f"p_eq={float(k.r_primal_eq[i]):.3e} p_ineq={float(k.r_primal_ineq[i]):.3e}"
        )

    lines = [
        f"QP iteration {i}: mu={float(history.mu[i]):.3e} "
        f"alpha_p={float(history.alpha.primal[i]):.4f} "
        f"alpha_d={float(history.alpha.dual[i]):.4f}",
        f"  kkt initial: {_row(ki)}",
        f"  kkt final:   {_row(kf)}",
    ]
    mu_aff = float(history.mu_affine[i])
    if mu_aff != 0.0 and mu_aff == mu_aff:  # computed (predictor-corrector)
        lines.append(f"  mu_affine={mu_aff:.3e}")
    return "\n".join(lines)


def summarize_counts(batched_result: "NLSResult") -> dict:
    """Aggregate iteration statistics over a batched solve (mean, median,
    p95 and max over the lanes of the iterations, QP iterations,
    line-search steps and failed line searches); analog of the reference
    tests' StatCounters/SummarizeCounts (nonlinear_test.cc:350-373)."""
    import numpy as np

    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    r = batched_result
    iters = host(r.num_iterations)
    qp_iters = host(r.iterations.qp_num_iterations).sum(axis=-1)
    ls_steps = host(r.iterations.line_search.num_steps).sum(axis=-1)
    sr = host(r.iterations.step_result)
    valid = np.arange(sr.shape[-1])[None, :] < iters[..., None]
    failed_codes = (
        StepSizeSelectionResult.MAX_ITERATIONS,
        StepSizeSelectionResult.FAILURE_NON_FINITE_COST,
        StepSizeSelectionResult.FAILURE_INVALID_ALPHA,
    )
    failed_ls = (np.isin(sr, failed_codes) & valid).sum(axis=-1)

    def stats(v):
        v = np.asarray(v, np.float64).ravel()
        return {
            "mean": float(v.mean()),
            "median": float(np.median(v)),
            "p95": float(np.quantile(v, 0.95)),
            "max": float(v.max()),
        }

    return {
        "num_iterations": stats(iters),
        "num_qp_iterations": stats(qp_iters),
        "num_line_search_steps": stats(ls_steps),
        "num_failed_line_searches": stats(failed_ls),
    }


def nls_result_to_string(result: NLSResult, use_color: bool = False, include_qp: bool = False) -> str:
    """Render ONE lane's solve history (``tree_map(lambda t: t[i],
    batched_result)``); analog of NLSSolverOutputs::ToString
    (structs.cc:238-268)."""
    n = int(result.num_iterations)
    term = NLSTerminationState(int(result.termination_state))
    good = bool(termination_state_indicates_satisfied_tol(result.termination_state))
    out = [
        _color(f"Terminated with state: {term.name}", good, use_color),
        f"Iterations: {n}, total QP iterations: {int(result.num_qp_iterations())}, "
        f"line-search steps: {int(result.num_line_search_steps())}, "
        f"failed line searches: {int(result.num_failed_line_searches())}",
    ]
    it = result.iterations
    for i in range(n):
        step = StepSizeSelectionResult(int(it.step_result[i]))
        state = OptimizerState(int(it.optimizer_state[i]))
        out.append(
            f"iter={i} state={state.name} lambda={float(it.lam[i]):.3e} "
            f"f={float(it.errors_initial.f[i]):.6e} "
            f"|eq|={float(it.errors_initial.equality[i]):.6e} "
            f"penalty={float(it.penalty[i]):.3e} "
            f"df={float(it.directional_derivatives.d_f[i]):.3e} "
            f"deq={float(it.directional_derivatives.d_equality[i]):.3e} "
            f"step={_color(step.name, step == StepSizeSelectionResult.SUCCESS, use_color)}"
        )
        for j in range(int(it.line_search.num_steps[i])):
            out.append(
                f"    alpha={float(it.line_search.alpha[i, j]):.6f} "
                f"f={float(it.line_search.f[i, j]):.6e} "
                f"|eq|={float(it.line_search.equality[i, j]):.6e}"
            )
        if include_qp:
            variant = QPSolverVariant(int(getattr(result, "solver_variant", 0)))
            if variant == QPSolverVariant.NULL_SPACE:
                ns = QPNullSpaceTerminationState(int(it.qp_termination_state[i]))
                out.append(f"    qp (null-space): {ns.name}")
            elif variant == QPSolverVariant.MATRIX_FREE_CG:
                # No nested per-QP rows: qp_num_iterations is the fixed CG
                # trip count.
                cg_term = QPTerminationState(int(it.qp_termination_state[i]))
                out.append(f"    cg (matrix-free): term={cg_term.name} iters={int(it.qp_num_iterations[i])}")
            else:
                qp_term = QPTerminationState(int(it.qp_termination_state[i]))
                out.append(
                    f"    qp: term={qp_term.name} "
                    f"iters={int(it.qp_num_iterations[i])} "
                    f"kkt_final_max={float(it.qp_kkt_final_max[i]):.3e}"
                )
                # The nested per-QP-iteration rows when recorded
                # (structs.cc:159-206).
                if it.qp_iterations.mu.shape[-1] > 0:
                    row = tree_map(lambda a: a[i], it.qp_iterations)
                    for j in range(int(it.qp_num_iterations[i])):
                        out.extend("    " + ln for ln in qp_iteration_to_string(row, j).split("\n"))
    return "\n".join(out)
