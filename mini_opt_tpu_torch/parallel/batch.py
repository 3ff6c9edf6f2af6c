"""Scenario-batch parallelism, the port of
``mini_opt_tpu/parallel/batch.py``: ``solve_batch`` only. The sharded
wrappers (``shard_solve_batch``, ``shard_solve_batch_2d``) come after each
tier has a single-card port (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..nonlinear import NLSParams, Problem, nls_solve
from ..structs import NLSResult

ProblemFn = Callable[..., Problem]


def solve_batch(
    problem_fn: ProblemFn,
    params: NLSParams,
    x0_batch,
    data_batch=None,
    retraction=None,
    axis_name: Optional[str] = None,
    device=None,
) -> NLSResult:
    """Solve a batch of independent problem instances in one call.

    ``problem_fn(data_row) -> Problem`` builds the (structurally identical)
    problem of one instance, or ``problem_fn()`` without data; it is
    evaluated per lane under ``torch.func.vmap``, as the JAX package's
    ``vmap`` evaluates it. Every leaf of the NLSResult has a leading batch
    dimension.
    """
    if data_batch is None:
        return nls_solve(problem_fn(), params, x0_batch, retraction=retraction, axis_name=axis_name,
                         device=device)
    return nls_solve(problem_fn, params, x0_batch, retraction=retraction, axis_name=axis_name,
                     data=data_batch, device=device)
