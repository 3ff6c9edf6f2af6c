"""mini_opt_tpu_torch: the PyTorch / CUDA port of mini_opt_tpu for NVIDIA
Hopper (H100).

It imports torch and never jax, and nothing of ``mini_opt_tpu``. The port
grows slice by slice. It carries:

* the fused batched-IK serving path: the hand-written planar and spatial
  families solved by one whole-SQP CUDA kernel (``csrc/fused_ik.cu``) up to
  D = n + m_eq = 32, and past it the blocked tier (``csrc/blocked.cu``, with
  the standalone LDL^T solve of ``csrc/blocked_kkt.cu``);
* the general batched SQP solver, ``nls_solve`` (linearize -> QP -> L1-merit
  line search) with its residual, QP and IK layers, whose inner QP runs on
  the lane-batched LDL^T kernels (``csrc/ldlt.cu``, ``kkt_solver=
  "pallas_ldlt"``) or as one fused interior-point kernel
  (``csrc/fused_qp.cu``, ``qp_solver="pallas_fused"``);
* SE(2) pose graphs: the general path's ``make_pose_graph_problem`` and
  ``solve_pose_graph``, and the serving tier for batches of
  chain-plus-closure graphs, ``models.pose_graph.solve_pose_graph_rings``,
  solved by one bordered block-Thomas CUDA kernel (``csrc/pose_ring.cu``,
  reached through ``ops.pose_ring``);

each kernel with a plain PyTorch version of the same computation for CPU
tensors.
"""

from .assertions import MiniOptError, validate_problem
from .convert import batch_from_numpy, batch_to_numpy, chain_from_numpy, params_from_dict
from .models.ik import (
    default_ik_params,
    make_ik_problem,
    make_planar_chain,
    mod_pi_retraction,
    solve_ik_batch,
)
from .models.pose_graph import make_pose_graph_problem, solve_pose_graph
from .nonlinear import NLSParams, Problem, nls_solve
from .ops.blocked import REGISTER_KKT_MAX, blocked_kkt_solve, blocked_solve_batch
from .ops.fused_ik import (
    FusedFamily,
    fused_ik_solve_batch,
    fused_solve_batch,
    fused_spatial_ik_solve_batch,
    fused_termination_status,
    planar_family,
    spatial_family,
)
from .ops.fused_qp import make_fused_qp_solver
from .parallel.batch import solve_batch
from .qp import QP, LinearInequalityConstraint, QPInteriorPointParams, Var, qp_ip_solve, qp_null_space_solve
from .residual import (
    BlockResidual,
    Residual,
    accumulate_hessian,
    accumulate_hessian_block,
    fill_jacobian_rows,
    make_residual,
    robustify,
)
from .structs import (
    AlphaValues,
    BarrierStrategy,
    DirectionalDerivatives,
    Errors,
    InitialGuessMethod,
    KKTError,
    LineSearchStrategy,
    NLSIterationHistory,
    NLSResult,
    NLSTerminationState,
    OptimizerState,
    QPIPResult,
    QPIterationHistory,
    QPLagrangeMultipliers,
    QPNullSpaceResult,
    QPNullSpaceTerminationState,
    QPSolverVariant,
    QPTerminationState,
    StepSizeSelectionResult,
    termination_state_indicates_satisfied_tol,
)

__all__ = [
    "AlphaValues",
    "BarrierStrategy",
    "BlockResidual",
    "DirectionalDerivatives",
    "Errors",
    "FusedFamily",
    "InitialGuessMethod",
    "KKTError",
    "LineSearchStrategy",
    "LinearInequalityConstraint",
    "MiniOptError",
    "NLSIterationHistory",
    "NLSParams",
    "NLSResult",
    "NLSTerminationState",
    "OptimizerState",
    "Problem",
    "QP",
    "QPIPResult",
    "QPInteriorPointParams",
    "QPIterationHistory",
    "QPLagrangeMultipliers",
    "QPNullSpaceResult",
    "QPNullSpaceTerminationState",
    "QPSolverVariant",
    "QPTerminationState",
    "REGISTER_KKT_MAX",
    "Residual",
    "StepSizeSelectionResult",
    "Var",
    "accumulate_hessian",
    "accumulate_hessian_block",
    "batch_from_numpy",
    "batch_to_numpy",
    "blocked_kkt_solve",
    "blocked_solve_batch",
    "chain_from_numpy",
    "default_ik_params",
    "fill_jacobian_rows",
    "fused_ik_solve_batch",
    "fused_solve_batch",
    "fused_spatial_ik_solve_batch",
    "fused_termination_status",
    "make_fused_qp_solver",
    "make_ik_problem",
    "make_planar_chain",
    "make_pose_graph_problem",
    "make_residual",
    "mod_pi_retraction",
    "nls_solve",
    "params_from_dict",
    "planar_family",
    "qp_ip_solve",
    "qp_null_space_solve",
    "robustify",
    "solve_batch",
    "solve_ik_batch",
    "solve_pose_graph",
    "spatial_family",
    "termination_state_indicates_satisfied_tol",
    "validate_problem",
]
