"""2-D pose-graph optimization (SLAM-style), the port of
``mini_opt_tpu/models/pose_graph.py`` (pose_graph.py:33-330): the general
path's pose-graph ``Problem`` and the serving tier for batches of
chain-plus-closure graphs.

Pose i = (x_i, y_i, theta_i). Edge (i, j) with measurement (dx, dy, dtheta)
in frame i contributes the residual

    r = [ R(theta_i)^T (t_j - t_i) - (dx, dy) ;  wrap(theta_j - theta_i - dtheta) ]

weighted per edge. Not ported yet (ROADMAP.md queue 1): the scalar builder
for the generated fused families, and the large-graph CG path with its
Jacobi and tree preconditioners and the chordal initialization.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..nonlinear import NLSParams, Problem, nls_solve
from ..residual import BlockResidual, make_residual, robustify
from ..structs import LineSearchStrategy, NLSResult
from ..utils import so3


def _wrap(a):
    return so3.mod_pi(a)


def _edge_residual(xl, row):
    """Relative-pose residual of one edge; xl = (xi, yi, thi, xj, yj, thj),
    row = (dx, dy, dtheta, w0, w1, w2)."""
    xi, yi, thi, xj, yj, thj = xl[0], xl[1], xl[2], xl[3], xl[4], xl[5]
    meas, w = row[:3], row[3:]
    c, s = torch.cos(thi), torch.sin(thi)
    dx_w = xj - xi
    dy_w = yj - yi
    # world -> frame i
    rx = c * dx_w + s * dy_w
    ry = -s * dx_w + c * dy_w
    rt = _wrap(thj - thi - meas[2])
    return w * torch.stack([rx - meas[0], ry - meas[1], rt])


def _edge_data(measurements, weights):
    if weights.dim() == 1:
        weights = weights[:, None] * torch.ones((1, 3), dtype=weights.dtype, device=weights.device)
    return torch.cat([measurements, weights], dim=1)  # (E, 6)


def _edge_indices(edges_ij):
    edges = np.asarray(edges_ij, dtype=np.int64)
    return tuple(
        tuple(int(v) for v in (3 * i, 3 * i + 1, 3 * i + 2, 3 * j, 3 * j + 1, 3 * j + 2))
        for i, j in edges
    )


def _as_tensor(a, like=None, device=None):
    """Tensors stay where they lie; numpy inputs go to ``like``'s device and
    dtype, or to ``device`` ("cuda" unless the caller names one)."""
    if torch.is_tensor(a):
        return a
    if like is not None:
        return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
    from ..convert import _resolve_device

    return torch.as_tensor(np.asarray(a), device=_resolve_device(device))


def make_pose_graph_problem(
    n_poses: int,
    edges_ij,  # (E, 2) int array-like: (i, j) pose indices per edge
    measurements,  # (E, 3): (dx, dy, dtheta) in frame i
    weights,  # (E,) or (E, 3)
    anchor_weight: float = 100.0,
    hard_anchor: bool = False,
    robust: Optional[str] = None,  # "huber" | "cauchy" on the edge residuals
    robust_delta: float = 1.0,
    device=None,
) -> Problem:
    """Build the pose-graph Problem of one graph. Pose p occupies variables
    [3p, 3p+1, 3p+2]. Pose 0 fixes the gauge: softly (a weighted prior cost,
    default) or exactly (``hard_anchor=True``: a 3-row equality
    constraint). ``robust`` wraps every edge in a robust loss kernel
    (``residual.robustify``). numpy inputs go to ``device`` ("cuda" unless
    the caller names one)."""
    measurements = _as_tensor(measurements, device=device)
    weights = _as_tensor(weights, like=measurements)
    data = _edge_data(measurements, weights)
    indices = _edge_indices(edges_ij)

    def anchor(xl):
        return anchor_weight * torch.stack([xl[0], xl[1], _wrap(xl[2])])

    def gauge(xl):
        return torch.stack([xl[0], xl[1], _wrap(xl[2])])

    block = BlockResidual(fn=_edge_residual, indices=indices, dim=3, data=data)
    if robust is not None:
        block = robustify(block, kind=robust, delta=robust_delta)
    if hard_anchor:
        return Problem(
            dimension=3 * n_poses,
            costs=(block,),
            equality_constraints=(make_residual([0, 1, 2], gauge, 3),),
        )
    return Problem(dimension=3 * n_poses, costs=(block, make_residual([0, 1, 2], anchor, 3)))


def ring_edges(n_poses: int):
    """Edge list of the canonical ring topology: the odometry chain
    (t, t+1) plus the loop closure (N-1, 0)."""
    return tuple((t, (t + 1) % n_poses) for t in range(n_poses))


def solve_pose_graph_rings(
    measurements,  # (B, E, 3) edge measurements (chain first)
    x0,  # (B, N, 3) initial poses
    anchor_weight: float = 100.0,
    max_iterations: int = 6,
    ls_iterations: int = 2,
    return_state: bool = False,
    backend: str = "pallas",
    closures=None,  # tuple of (from, to) pairs; None = canonical ring
    device=None,
):
    """Serving tier for BATCHES of N-pose chain-plus-closure graphs (unit
    edge weights, soft pose-0 anchor): one bordered block-Thomas solve
    (``ops/pose_ring.py``, one kernel launch on the card). ``closures``
    selects the topology: ``None`` is the canonical ring (chain +
    (N-1, 0)); one or more (from, to) pairs run the border-set elimination.
    Edge order in ``measurements``: chain edges (t, t+1) for t < N-1, then
    the closures in declaration order (E = N-1 + len(closures)). Semantics
    are ``make_pose_graph_problem(N, edges, ...)`` + ``nls_solve`` at the
    matched fixed-trip budget. numpy inputs go to ``device`` ("cuda" unless
    the caller names one).

    Returns x (B, N, 3); with ``return_state`` also the per-lane (B, 3)
    (f, 0, flags) channel accepted by ``fused_termination_status``."""
    from ..ops.pose_ring import pose_ring_family, pose_ring_solve_batch

    if measurements.ndim != 3 or measurements.shape[-1] != 3:
        raise ValueError(f"measurements must have shape (B, E, 3); got {tuple(measurements.shape)}")
    B, E, _ = measurements.shape
    if x0.ndim != 3 or x0.shape[0] != B or x0.shape[-1] != 3:
        raise ValueError(f"x0 must have shape (B, N, 3) with B={B}; got {tuple(x0.shape)}")
    N = x0.shape[1]
    if closures is not None and len(closures) > 1:
        fam = pose_ring_family(
            N, anchor_weight=anchor_weight,
            closures=tuple(tuple(int(v) for v in c) for c in closures),
        )
    else:
        closure = tuple(int(v) for v in closures[0]) if closures else None
        fam = pose_ring_family(N, anchor_weight=anchor_weight, closure=closure)
    if E != fam.n_edges:
        raise ValueError(
            f"measurements carry {E} edges; topology needs {fam.n_edges} "
            f"(chain {N - 1} + closures {len(fam.closure_list)})"
        )
    res = pose_ring_solve_batch(
        fam,
        measurements.reshape(B, 3 * E),
        x0.reshape(B, 3 * N),
        max_iterations=max_iterations,
        ls_iterations=ls_iterations,
        return_state=return_state,
        backend=backend,
        device=device,
    )
    if return_state:
        x, state = res
        return x.reshape(B, N, 3), state
    return res.reshape(B, N, 3)


def pose_graph_retraction(x, dx, alpha):
    """Additive update with heading wrap on every third variable (a new
    tensor, where the JAX package writes with ``.at[].set``)."""
    x_new = x + alpha * dx
    heading = torch.arange(x_new.shape[0], device=x_new.device) % 3 == 2
    return torch.where(heading, _wrap(x_new), x_new)


def default_pose_graph_params(dtype=torch.float64, max_iterations: int = 30) -> NLSParams:
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=1,  # unconstrained: one Newton/GN step per outer
        absolute_exit_tol=1e-12,
        relative_exit_tol=1e-10,
        max_line_search_iterations=8,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        armijo_search_tau=0.5,
        lambda_initial=1e-4,
        min_lambda=1e-10,
    )


def solve_pose_graph(
    n_poses: int,
    edges_ij,
    measurements,
    weights,
    x0,  # (B, 3N): B starts of the one graph
    params: Optional[NLSParams] = None,
    robust: Optional[str] = None,
    robust_delta: float = 1.0,
    device=None,
) -> NLSResult:
    """Solve one pose graph from each of the B starts in ``x0``. numpy
    measurements follow a tensor ``x0``; numpy inputs otherwise go to
    ``device`` ("cuda" unless the caller names one)."""
    if torch.is_tensor(x0):
        measurements = _as_tensor(measurements, like=x0)
    problem = make_pose_graph_problem(
        n_poses, edges_ij, measurements, weights,
        robust=robust, robust_delta=robust_delta, device=device,
    )
    if params is None:
        params = default_pose_graph_params(x0.dtype)
    return nls_solve(problem, params, x0, retraction=pose_graph_retraction, device=device)
