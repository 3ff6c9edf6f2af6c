"""2-D pose-graph optimization (SLAM-style), the port of
``mini_opt_tpu/models/pose_graph.py`` (pose_graph.py:33-330): the general
path's pose-graph ``Problem`` and the serving tier for batches of
chain-plus-closure graphs.

Pose i = (x_i, y_i, theta_i). Edge (i, j) with measurement (dx, dy, dtheta)
in frame i contributes the residual

    r = [ R(theta_i)^T (t_j - t_i) - (dx, dy) ;  wrap(theta_j - theta_i - dtheta) ]

weighted per edge. ``scalar_pose_graph_builder`` states a small graph in the
fused compiler's scalar style, for ``family_from_problem``. The large-graph
path (pose_graph.py:219-390, 508-650) is matrix-free: ``solve_pose_graph_large``
runs ``nls_solve`` with ``qp_solver="cg"`` under the Jacobi
(``make_jacobi_preconditioner``) or the spanning-chain tree
(``make_tree_preconditioner``, ``ops/tree_prec.py``) preconditioner, from a
``chordal_initialization``. Not ported yet: ``solve_pose_graph_large_sharded``
(ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
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


def scalar_pose_graph_builder(n_poses, edges_ij, anchor_weight: float = 100.0):
    """``data -> Problem`` builder in the fused compiler's scalar style
    (``ops/fused_auto.py``): a whole small SE(2) pose graph as one generated
    family, the register tier's kernel 1 up to D = 3N = 32 and the blocked
    tier's kernel 2 past it. Payload rows: the E edge measurements raveled,
    ``data[3e:3e+3] = (dx, dy, dtheta)`` of edge e (unit weights; the edge
    set and the anchor are static). The general-path twin is
    ``make_pose_graph_problem`` with the same edges and soft anchor."""
    indices = _edge_indices(edges_ij)
    E = len(indices)

    def builder(data):
        one = torch.ones_like(data[0])
        rows = [torch.stack([data[3 * e], data[3 * e + 1], data[3 * e + 2], one, one, one]) for e in range(E)]
        block = BlockResidual(fn=_edge_residual, indices=indices, dim=3, data=torch.stack(rows))

        def anchor(xl):
            return anchor_weight * torch.stack([xl[0], xl[1], _wrap(xl[2])])

        return Problem(dimension=3 * n_poses, costs=(block, make_residual([0, 1, 2], anchor, 3)))

    return builder


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


def edge_jtj_diag(residual_fn, x, idx, data):
    """Exact diag(J^T J) of one edge-set BlockResidual: per-edge Jacobians
    (``torch.func.jacfwd``) squared and scatter-added at the edges'
    variable indices ``idx`` (E, P) -- the Jacobi preconditioner of the CG
    path, shared by the SE(2) and SE(3) families and bundle adjustment."""
    from torch.func import jacfwd, vmap

    def one(row_idx, row_data):
        J = jacfwd(lambda v: residual_fn(v, row_data))(x[row_idx])  # (dim, P)
        return torch.sum(J * J, dim=0)

    contrib = vmap(one)(idx, data)  # (E, P)
    return torch.zeros_like(x).index_add(0, idx.reshape(-1), contrib.reshape(-1))


def _host_edge_data(measurements, weights):
    """The (E, 6) edge data of numpy or tensor inputs, where they lie (numpy
    on the CPU): the preconditioners move it to the iterate's device."""
    meas = measurements if torch.is_tensor(measurements) else torch.as_tensor(np.asarray(measurements))
    return _edge_data(meas, _as_tensor(weights, like=meas))


def _device_consts(*arrays):
    """``at(device, dtype)`` -> the arrays as tensors there (integer arrays
    as long, floating ones in ``dtype``), moved once per device and type."""
    cache = {}

    def at(device, dtype):
        key = (device, dtype)
        if key not in cache:
            out = []
            for a in arrays:
                t = torch.as_tensor(a) if not torch.is_tensor(a) else a
                out.append(t.to(device=device, dtype=torch.long if not t.is_floating_point() else dtype))
            cache[key] = tuple(out)
        return cache[key]

    return at


def make_jacobi_preconditioner(edges_ij, measurements, weights, anchor_weight: float = 100.0):
    """Jacobi preconditioner ``x -> diag(J^T J)`` (floored at 1e-12) of one
    SE(2) graph for the CG path. numpy or tensor inputs; they follow the
    iterate's device and type."""
    idx = np.asarray(_edge_indices(edges_ij), dtype=np.int64)
    at = _device_consts(idx, _host_edge_data(measurements, weights))

    def diag_fn(x):
        idx_d, data_d = at(x.device, x.dtype)
        d = edge_jtj_diag(_edge_residual, x, idx_d, data_d)
        d = torch.cat([d[:3] + anchor_weight * anchor_weight, d[3:]])
        return torch.maximum(d, torch.full_like(d, 1e-12))

    return diag_fn


def make_tree_preconditioner(n_poses: int, edges_ij, measurements, weights, anchor_weight: float = 100.0):
    """Spanning-chain block-tridiagonal preconditioner of one SE(2) graph
    for the CG path (``ops/tree_prec.py``): the odometry chain's Hessian
    solved exactly each CG trip, so that CG corrects only for the loop
    closures. Use with ``nls_solve(..., cg_preconditioner=...)`` or
    ``solve_pose_graph_large(..., preconditioner="tree")``."""
    from ..ops.tree_prec import make_chain_tree_preconditioner

    data = _host_edge_data(measurements, weights)
    idx = np.asarray(_edge_indices(edges_ij), dtype=np.int64)
    anchor_block = (anchor_weight * anchor_weight) * torch.eye(3, dtype=torch.float64)
    return make_chain_tree_preconditioner(
        _edge_residual, idx, data, n_poses, 3, anchor_block=anchor_block,
        block_pairs=np.asarray(edges_ij, np.int64),
    )


def _large_inputs(x0, measurements, weights, device):
    """x0 as a (B, n) tensor (a (n,) one becomes B = 1) and the edge data
    beside it: numpy inputs follow a tensor x0, else go to ``device``."""
    from ..nonlinear import _as_batch

    x0 = _as_tensor(x0, device=device)
    single = x0.dim() == 1
    x0, _ = _as_batch(x0[None] if single else x0, None, device)
    meas = _as_tensor(measurements, like=x0)
    return x0, meas, _as_tensor(weights, like=x0), single


def _unbatch(res, single):
    """A B = 1 result of a single start as the JAX package returns it: every
    leaf without the batch axis."""
    from ..structs import tree_map

    return tree_map(lambda t: t[0], res) if single else res


def solve_pose_graph_large(
    n_poses: int,
    edges_ij,
    measurements,
    weights,
    x0,
    params: Optional[NLSParams] = None,
    cg_iterations: int = 100,
    hard_anchor: bool = False,
    robust: Optional[str] = None,
    robust_delta: float = 1.0,
    preconditioner: str = "jacobi",  # "jacobi" | "tree"
    device=None,
) -> NLSResult:
    """Large-N path: matrix-free preconditioned-CG Gauss-Newton; the (3N,
    3N) Hessian is never formed. ``preconditioner="tree"`` solves the
    odometry chain exactly each CG trip (soft anchor only: the chain factor
    needs the gauge prior to stay SPD); ``hard_anchor=True`` fixes pose 0
    exactly through the projected-CG equality path.

    ``x0`` is one start (3N,), as in the JAX package, or B starts (B, 3N)
    of the same graph; the result has the same leading shape. numpy inputs
    follow a tensor ``x0``, else go to ``device`` ("cuda" unless named)."""
    if preconditioner not in ("jacobi", "tree"):
        raise ValueError(f"preconditioner must be 'jacobi' or 'tree', not {preconditioner!r}")
    if preconditioner == "tree" and hard_anchor:
        raise ValueError(
            "preconditioner='tree' requires the soft anchor (the gauge prior keeps the chain factor SPD); "
            "use jacobi with hard_anchor=True")
    x0, meas, w, single = _large_inputs(x0, measurements, weights, device)
    problem = make_pose_graph_problem(
        n_poses, edges_ij, meas, w, hard_anchor=hard_anchor, robust=robust, robust_delta=robust_delta)
    if params is None:
        params = default_pose_graph_params(x0.dtype)
    params = dataclasses.replace(params, qp_solver="cg", cg_iterations=cg_iterations)
    if preconditioner == "tree":
        res = nls_solve(problem, params, x0, retraction=pose_graph_retraction,
                        cg_preconditioner=make_tree_preconditioner(n_poses, edges_ij, meas, w))
    else:
        diag_fn = make_jacobi_preconditioner(edges_ij, meas, w, anchor_weight=0.0 if hard_anchor else 100.0)
        res = nls_solve(problem, params, x0, retraction=pose_graph_retraction, cg_diag_preconditioner=diag_fn)
    return _unbatch(res, single)


def chordal_initialization(
    n_poses: int,
    edges_ij,
    measurements,  # (E, 3)
    weights,  # (E,) or (E, 3)
    anchor_pose=None,  # (3,) pose-0 gauge; origin if None
    cg_iterations: int = 300,
    anchor_weight: float = 100.0,
    preconditioner: str = "none",  # "none" | "tree"
    device=None,
):
    """Chordal initialization: two linear least-squares solves through the
    CG path (one Gauss-Newton step each) in place of a long nonlinear
    descent. Stage 1 relaxes each heading to a free 2-vector (cos, sin),
    whose edge residual r_j - Rot(dtheta_ij) r_i is linear; headings come
    back by atan2. Stage 2 solves the positions, linear once the rotations
    are fixed. ``preconditioner="tree"`` runs both stages under the
    spanning-chain preconditioner (2 x 2 blocks). Returns the (3 n_poses,)
    start, on the measurements' device (numpy measurements go to
    ``device``, "cuda" unless named)."""
    from ..residual import make_residual as _mk

    meas = _as_tensor(measurements, device=device)
    dtype, dev = meas.dtype, meas.device
    w = _as_tensor(weights, like=meas)
    if w.dim() == 1:
        w = w[:, None] * torch.ones((1, 3), dtype=dtype, device=dev)
    edges = np.asarray(edges_ij, dtype=np.int64)
    anchor = (torch.zeros((3,), dtype=dtype, device=dev) if anchor_pose is None
              else _as_tensor(anchor_pose, like=meas).to(device=dev, dtype=dtype))
    lin_params = NLSParams(
        max_iterations=1,
        max_qp_iterations=1,
        max_line_search_iterations=0,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        armijo_search_tau=0.5,
        relative_exit_tol=0.0,
        early_exit=False,
        qp_solver="cg",
        cg_iterations=cg_iterations,
    )
    stage_idx = np.stack([2 * edges[:, 0], 2 * edges[:, 0] + 1, 2 * edges[:, 1], 2 * edges[:, 1] + 1], axis=1)
    idx_t = torch.as_tensor(stage_idx, device=dev)

    # --- stage 1: chordal rotations ------------------------------------------
    rot_data = torch.stack([torch.cos(meas[:, 2]), torch.sin(meas[:, 2]), w[:, 2]], dim=1)

    def rot_res(xl, row):
        ci, si, cj, sj = xl[0], xl[1], xl[2], xl[3]
        c, s, wt = row[0], row[1], row[2]
        return wt * torch.stack([cj - (c * ci - s * si), sj - (s * ci + c * si)])

    def rot_anchor(xl):
        return anchor_weight * torch.stack([xl[0] - torch.cos(anchor[2]), xl[1] - torch.sin(anchor[2])])

    rot_problem = Problem(
        dimension=2 * n_poses,
        costs=(BlockResidual(fn=rot_res, indices=idx_t, dim=2, data=rot_data), _mk([0, 1], rot_anchor, 2)),
    )

    def tree(res_fn, stage_data):
        if preconditioner != "tree":
            return None
        from ..ops.tree_prec import make_chain_tree_preconditioner

        return make_chain_tree_preconditioner(
            res_fn, stage_idx, stage_data, n_poses, 2,
            anchor_block=(anchor_weight * anchor_weight) * torch.eye(2, dtype=dtype),
            block_pairs=edges,
        )

    r0 = torch.tensor([1.0, 0.0], dtype=dtype, device=dev).repeat(n_poses)
    r_sol = nls_solve(rot_problem, lin_params, r0[None], cg_preconditioner=tree(rot_res, rot_data)).x
    r_sol = r_sol.reshape(n_poses, 2)
    theta = torch.atan2(r_sol[:, 1], r_sol[:, 0])

    # --- stage 2: positions, exactly linear given the rotations --------------
    ei = torch.as_tensor(edges[:, 0], device=dev)
    pos_data = torch.stack(
        [torch.cos(theta)[ei], torch.sin(theta)[ei], meas[:, 0], meas[:, 1], 0.5 * (w[:, 0] + w[:, 1])], dim=1)

    def pos_res(xl, row):
        xi, yi, xj, yj = xl[0], xl[1], xl[2], xl[3]
        c, s, dx, dy, wt = row[0], row[1], row[2], row[3], row[4]
        rx = c * (xj - xi) + s * (yj - yi) - dx
        ry = -s * (xj - xi) + c * (yj - yi) - dy
        return wt * torch.stack([rx, ry])

    def pos_anchor(xl):
        return anchor_weight * torch.stack([xl[0] - anchor[0], xl[1] - anchor[1]])

    pos_problem = Problem(
        dimension=2 * n_poses,
        costs=(BlockResidual(fn=pos_res, indices=idx_t, dim=2, data=pos_data), _mk([0, 1], pos_anchor, 2)),
    )
    t0 = torch.zeros((1, 2 * n_poses), dtype=dtype, device=dev)
    t_sol = nls_solve(pos_problem, lin_params, t0, cg_preconditioner=tree(pos_res, pos_data)).x
    t_sol = t_sol.reshape(n_poses, 2)
    return torch.stack([t_sol[:, 0], t_sol[:, 1], theta], dim=1).reshape(-1)
