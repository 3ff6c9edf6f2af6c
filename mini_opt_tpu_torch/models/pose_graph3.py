"""3-D (SE(3)) pose-graph optimization, the port of
``mini_opt_tpu/models/pose_graph3.py``: pose i is (t_i in R^3, w_i in R^3),
w a rotation vector; one ``BlockResidual`` holds every relative-pose edge;
the retraction renormalizes rotation vectors through the quaternion exp/log
round trip so that |w| <= pi. Large graphs run matrix-free
(``qp_solver="cg"``) as the SE(2) family does, from
``chordal_initialization3``; ``hard_anchor=True`` pins the gauge through the
projected-CG equality path. Not ported yet:
``solve_pose_graph3_large_sharded`` (ROADMAP.md queue 1, item 9).

Edge (i, j) with measurement (dt in frame i, dw a rotation vector):

    r_t = w_t * ( R(w_i)^T (t_j - t_i) - dt )
    r_R = w_r * log( (R(w_i) R(dw))^T R(w_j) )
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..nonlinear import NLSParams, Problem, nls_solve
from ..residual import BlockResidual, make_residual, robustify
from ..structs import LineSearchStrategy, NLSResult
from ..utils.so3 import quat_conjugate, quat_exp, quat_from_matrix, quat_log, quat_multiply, quat_rotate, quat_to_matrix
from .pose_graph import _as_tensor, _device_consts, _large_inputs, _unbatch, edge_jtj_diag


def _edge_residual3(xl, row):
    """6-row relative-pose residual of one SE(3) edge; xl = (t_i, w_i, t_j,
    w_j), row = (dt(3), dw(3), w_t, w_r)."""
    ti, wi = xl[0:3], xl[3:6]
    tj, wj = xl[6:9], xl[9:12]
    dt, dw = row[0:3], row[3:6]
    wt, wr = row[6], row[7]
    qi = quat_exp(wi)
    qj = quat_exp(wj)
    r_t = quat_rotate(quat_conjugate(qi), tj - ti) - dt
    q_pred = quat_multiply(qi, quat_exp(dw))  # predicted world rotation of j
    r_r = quat_log(quat_multiply(quat_conjugate(q_pred), qj))
    return torch.cat([wt * r_t, wr * r_r])


def _edge_data3(measurements, weights):
    """(E, 8) data rows from (E, 6) measurements and (E,) | (E, 2) weights."""
    weights = _as_tensor(weights, like=measurements).to(measurements.dtype)
    if weights.dim() == 1:
        weights = weights[:, None] * torch.ones((1, 2), dtype=weights.dtype, device=weights.device)
    return torch.cat([measurements, weights], dim=1)


def _edge_indices3(edges_ij) -> np.ndarray:
    """(E, 12): pose i's six variables, then pose j's."""
    edges = np.asarray(edges_ij, dtype=np.int64)
    k = np.arange(6)[None, :]
    return np.concatenate([6 * edges[:, 0:1] + k, 6 * edges[:, 1:2] + k], axis=1)


def _host_data3(measurements, weights):
    meas = measurements if torch.is_tensor(measurements) else torch.as_tensor(np.asarray(measurements))
    return _edge_data3(meas, weights)


def make_pose_graph3_problem(
    n_poses: int,
    edges_ij,  # (E, 2) int array-like
    measurements,  # (E, 6): (dt(3) in frame i, dw(3) rotation vector)
    weights,  # (E,) or (E, 2): (translation, rotation) weights
    anchor_weight: float = 100.0,
    hard_anchor: bool = False,
    robust: Optional[str] = None,  # "huber" | "cauchy" on the edge residuals
    robust_delta: float = 1.0,
    device=None,
) -> Problem:
    """Pose p occupies variables [6p, 6p+6). Pose 0 fixes the gauge, softly
    (a prior cost) or exactly (a 6-row equality constraint,
    ``hard_anchor``); ``robust`` wraps every edge in a robust loss. numpy
    inputs go to ``device`` ("cuda" unless named)."""
    meas = _as_tensor(measurements, device=device)
    data = _edge_data3(meas, weights)
    indices = torch.as_tensor(_edge_indices3(edges_ij), device=meas.device)

    def gauge(xl):
        return torch.cat([xl[0:3], quat_log(quat_exp(xl[3:6]))])

    def anchor(xl):
        return anchor_weight * gauge(xl)

    block = BlockResidual(fn=_edge_residual3, indices=indices, dim=6, data=data)
    if robust is not None:
        block = robustify(block, kind=robust, delta=robust_delta)
    if hard_anchor:
        return Problem(dimension=6 * n_poses, costs=(block,),
                       equality_constraints=(make_residual(list(range(6)), gauge, 6),))
    return Problem(dimension=6 * n_poses, costs=(block, make_residual(list(range(6)), anchor, 6)))


def make_jacobi_preconditioner3(edges_ij, measurements, weights, anchor_weight: float = 100.0):
    """Jacobi preconditioner ``x -> diag(J^T J)`` (floored at 1e-12) of one
    SE(3) graph for the CG path; inputs follow the iterate's device and
    type."""
    at = _device_consts(_edge_indices3(edges_ij), _host_data3(measurements, weights))

    def diag_fn(x):
        idx_d, data_d = at(x.device, x.dtype)
        d = edge_jtj_diag(_edge_residual3, x, idx_d, data_d)
        d = torch.cat([d[:6] + anchor_weight * anchor_weight, d[6:]])
        return torch.maximum(d, torch.full_like(d, 1e-12))

    return diag_fn


def make_tree_preconditioner3(n_poses: int, edges_ij, measurements, weights, anchor_weight: float = 100.0):
    """Spanning-chain block-tridiagonal preconditioner of one SE(3) graph,
    the 6x6-block twin of ``pose_graph.make_tree_preconditioner``. The
    anchor block is aw^2 I_6 (quat_log(quat_exp(w)) has the identity
    Jacobian inside |w| < pi)."""
    from ..ops.tree_prec import make_chain_tree_preconditioner

    return make_chain_tree_preconditioner(
        _edge_residual3, _edge_indices3(edges_ij), _host_data3(measurements, weights), n_poses, 6,
        anchor_block=(anchor_weight * anchor_weight) * torch.eye(6, dtype=torch.float64),
        block_pairs=np.asarray(edges_ij, np.int64),
    )


def pose_graph3_retraction(x, dx, alpha):
    """Additive update; rotation vectors renormalized through the
    quaternion exp/log round trip so that every |w| stays in [0, pi]."""
    x_new = x + alpha * dx
    poses = x_new.reshape(-1, 6)
    return torch.cat([poses[:, 0:3], quat_log(quat_exp(poses[:, 3:6]))], dim=1).reshape(-1)


def default_pose_graph3_params(dtype=torch.float64, max_iterations: int = 30) -> NLSParams:
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=1,  # unconstrained: one GN step per outer iteration
        absolute_exit_tol=1e-12,
        relative_exit_tol=1e-10,
        max_line_search_iterations=8,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        armijo_search_tau=0.5,
        lambda_initial=1e-4,
        min_lambda=1e-10,
    )


def solve_pose_graph3(n_poses: int, edges_ij, measurements, weights, x0, params: Optional[NLSParams] = None,
                      device=None) -> NLSResult:
    """Dense path (assembled Hessian); graphs up to a few hundred poses.
    ``x0`` is one start (6N,) or B starts (B, 6N)."""
    x0, meas, w, single = _large_inputs(x0, measurements, weights, device)
    problem = make_pose_graph3_problem(n_poses, edges_ij, meas, w)
    if params is None:
        params = default_pose_graph3_params(x0.dtype)
    return _unbatch(nls_solve(problem, params, x0, retraction=pose_graph3_retraction), single)


def solve_pose_graph3_large(
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
    """Large-N path: matrix-free PCG Gauss-Newton over the edge set (the 6N
    x 6N Hessian never formed); ``preconditioner="tree"`` solves the
    odometry chain exactly each CG trip (soft anchor only). ``x0`` is one
    start (6N,) or B starts (B, 6N); numpy inputs follow a tensor ``x0``,
    else go to ``device``."""
    if preconditioner not in ("jacobi", "tree"):
        raise ValueError(f"preconditioner must be 'jacobi' or 'tree', not {preconditioner!r}")
    if preconditioner == "tree" and hard_anchor:
        raise ValueError("preconditioner='tree' requires the soft anchor; use jacobi with hard_anchor=True")
    x0, meas, w, single = _large_inputs(x0, measurements, weights, device)
    problem = make_pose_graph3_problem(n_poses, edges_ij, meas, w, hard_anchor=hard_anchor, robust=robust,
                                       robust_delta=robust_delta)
    if params is None:
        params = default_pose_graph3_params(x0.dtype)
    params = dataclasses.replace(params, qp_solver="cg", cg_iterations=cg_iterations)
    if preconditioner == "tree":
        res = nls_solve(problem, params, x0, retraction=pose_graph3_retraction,
                        cg_preconditioner=make_tree_preconditioner3(n_poses, edges_ij, meas, w))
    else:
        diag_fn = make_jacobi_preconditioner3(edges_ij, meas, w, anchor_weight=0.0 if hard_anchor else 100.0)
        res = nls_solve(problem, params, x0, retraction=pose_graph3_retraction, cg_diag_preconditioner=diag_fn)
    return _unbatch(res, single)


def _project_to_so3(M):
    """The nearest rotation to each M (..., 3, 3): U diag(1, 1, det(U V^T))
    V^T from the SVD, so that a reflection's nearest proper rotation comes
    out (det +1)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    d = torch.stack([one, one, det], dim=-1)
    return U @ (d[..., :, None] * Vt)


def chordal_initialization3(
    n_poses: int,
    edges_ij,
    measurements,  # (E, 6)
    weights,  # (E,) or (E, 2)
    anchor_pose=None,  # (6,) pose-0 gauge
    cg_iterations: int = 300,
    anchor_weight: float = 100.0,
    preconditioner: str = "none",  # "none" | "tree"
    device=None,
):
    """SE(3) chordal initialization: each rotation relaxed to a free 3x3
    matrix M_i in R^9 (the edge residual M_j - M_i R(dw_ij) is linear, one
    Gauss-Newton step through the CG path), projected to SO(3) by SVD; then
    the positions, linear given the rotations. ``preconditioner="tree"``
    runs both stages under the spanning-chain preconditioner (9x9 and 3x3
    blocks). Returns the (6 n_poses,) start on the measurements' device
    (numpy measurements go to ``device``, "cuda" unless named)."""
    meas = _as_tensor(measurements, device=device)
    dtype, dev = meas.dtype, meas.device
    w = _as_tensor(weights, like=meas).to(device=dev, dtype=dtype)
    if w.dim() == 1:
        w = w[:, None] * torch.ones((1, 2), dtype=dtype, device=dev)
    edges = np.asarray(edges_ij, dtype=np.int64)
    anchor = (torch.zeros((6,), dtype=dtype, device=dev) if anchor_pose is None
              else _as_tensor(anchor_pose, like=meas).to(device=dev, dtype=dtype))
    anchor_R = quat_to_matrix(quat_exp(anchor[3:6]))
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

    def tree(res_fn, idx, stage_data, dof):
        if preconditioner != "tree":
            return None
        from ..ops.tree_prec import make_chain_tree_preconditioner

        return make_chain_tree_preconditioner(
            res_fn, idx, stage_data, n_poses, dof,
            anchor_block=(anchor_weight * anchor_weight) * torch.eye(dof, dtype=dtype), block_pairs=edges)

    # --- stage 1: chordal rotations over R^9 ---------------------------------
    Rd = quat_to_matrix(quat_exp(meas[:, 3:6]))  # (E, 3, 3)
    k9 = np.arange(9)[None, :]
    rot_idx = np.concatenate([9 * edges[:, 0:1] + k9, 9 * edges[:, 1:2] + k9], axis=1)
    rot_data = torch.cat([Rd.reshape(-1, 9), w[:, 1:2]], dim=1)  # (E, 10)

    def rot_res(xl, row):
        wt = row[9]
        rows = []
        for r_ in range(3):
            for c in range(3):
                acc = xl[9 + 3 * r_ + c]
                for k in range(3):
                    acc = acc - xl[3 * r_ + k] * row[3 * k + c]
                rows.append(wt * acc)
        return torch.stack(rows)

    def rot_anchor(xl):
        return anchor_weight * (xl - anchor_R.reshape(-1))

    rot_problem = Problem(
        dimension=9 * n_poses,
        costs=(BlockResidual(fn=rot_res, indices=torch.as_tensor(rot_idx, device=dev), dim=9, data=rot_data),
               make_residual(list(range(9)), rot_anchor, 9)),
    )
    m0 = torch.eye(3, dtype=dtype, device=dev).reshape(-1).repeat(n_poses)
    M = nls_solve(rot_problem, lin_params, m0[None],
                  cg_preconditioner=tree(rot_res, rot_idx, rot_data, 9)).x.reshape(n_poses, 3, 3)
    R = _project_to_so3(M)
    w_vec = quat_log(quat_from_matrix(R))

    # --- stage 2: positions, linear given the rotations ----------------------
    Ri_dt = torch.einsum("eab,eb->ea", R[torch.as_tensor(edges[:, 0], device=dev)], meas[:, 0:3])
    k3 = np.arange(3)[None, :]
    pos_idx = np.concatenate([3 * edges[:, 0:1] + k3, 3 * edges[:, 1:2] + k3], axis=1)
    pos_data = torch.cat([Ri_dt, w[:, 0:1]], dim=1)  # (E, 4)

    def pos_res(xl, row):
        return row[3] * torch.stack([xl[3 + k] - xl[k] - row[k] for k in range(3)])

    def pos_anchor(xl):
        return anchor_weight * (xl - anchor[0:3])

    pos_problem = Problem(
        dimension=3 * n_poses,
        costs=(BlockResidual(fn=pos_res, indices=torch.as_tensor(pos_idx, device=dev), dim=3, data=pos_data),
               make_residual([0, 1, 2], pos_anchor, 3)),
    )
    t = nls_solve(pos_problem, lin_params, torch.zeros((1, 3 * n_poses), dtype=dtype, device=dev),
                  cg_preconditioner=tree(pos_res, pos_idx, pos_data, 3)).x.reshape(n_poses, 3)
    return torch.cat([t, w_vec], dim=1).reshape(-1)
