"""mini_opt_tpu_torch: the PyTorch / CUDA port of mini_opt_tpu for NVIDIA
Hopper (H100).

It imports torch and never jax, and nothing of ``mini_opt_tpu``. The port
grows slice by slice. It carries:

* the fused batched-IK serving path: the hand-written planar and spatial
  families solved by one whole-SQP CUDA kernel (``csrc/fused_ik.cu``) up to
  D = n + m_eq = 32, and past it the blocked tier (``csrc/blocked.cu``, with
  the standalone LDL^T solve of ``csrc/blocked_kkt.cu``);
* families generated from a general-path ``Problem``
  (``family_from_problem``, ``fused_nls_solve_batch``,
  ``fused_chain_ik_solve`` for any ``ActuatorChain``), each run on the card
  by its own instance of the same kernel, which ``ops/fused_emit.py`` emits
  from the family and builds at first use; and the serving wrappers
  ``fused_solve_refined``, ``fused_solve_proximal`` and
  ``fused_solve_multi_start``;
* the general batched SQP solver, ``nls_solve`` (linearize -> QP -> L1-merit
  line search) with its residual, QP and IK layers, whose inner QP runs on
  the lane-batched LDL^T kernels (``csrc/ldlt.cu``, ``kkt_solver=
  "pallas_ldlt"``) or as one fused interior-point kernel
  (``csrc/fused_qp.cu``, ``qp_solver="pallas_fused"``: one instance a
  thread for small QPs, one warp an instance up to N + K = 192); its options
  ``parallel_line_search``, ``fuse_probe_linearize``, ``exit_callback`` and
  ``log_qp_eigenvalues``; and what a caller does with a result: the
  renderers (``nls_result_to_string``, ``summarize_counts``), JSON and npz
  files (``utils.serialization``), warm starts and checkpoints
  (``utils.checkpoint``), the chrome-trace collector and ``device_profile``
  (``utils.tracing``) and the native CPU baseline (``native``, built with
  g++);
* SE(2) pose graphs: the general path's ``make_pose_graph_problem`` and
  ``solve_pose_graph``, and the serving tier for batches of
  chain-plus-closure graphs, ``models.pose_graph.solve_pose_graph_rings``,
  solved by one bordered block-Thomas CUDA kernel (``csrc/pose_ring.cu``,
  reached through ``ops.pose_ring``);
* the matrix-free large-problem path, ``nls_solve`` with
  ``qp_solver="cg"``: SE(2) and SE(3) pose graphs of thousands of poses
  (``solve_pose_graph_large``, ``solve_pose_graph3_large`` and their chordal
  initializations, under the Jacobi or the spanning-chain tree
  preconditioner, ``ops.tree_prec``) and bundle adjustment
  (``models.bundle_adjustment``, with its block and Schur-complement
  preconditioners), in PyTorch on the card (no kernel of its own);
* model-predictive control of plant fleets: the cart-pole transcription on
  the general path (``models.mpc``, with the structured Riccati KKT backend
  ``kkt_solver="riccati:T:NX:NU"``), and the fused serving tier, one MPC
  period per launch (``fused_mpc_solve_batch``, ``csrc/mpc.cu``) or the
  whole receding-horizon loop in one launch (``fused_mpc_servo_batch``);

* nonlinear inequality constraints by slack lifting
  (``with_nonlinear_inequalities``, which ``nls_solve`` takes directly or
  from a per-lane function), gradients of solves through the KKT conditions
  (``make_implicit_solver``, the implicit MPC policy and its feedback gain
  in ``models.mpc``) and the serving-budget tuner (``tuning``), all on the
  general path's kernels or the fused ones;
each kernel with a plain PyTorch version of the same computation for CPU
tensors.
"""

from .assertions import MiniOptError, validate_problem
from .implicit import make_implicit_solver
from .ineq import NonlinearInequalityProblem, with_nonlinear_inequalities
from .convert import (
    batch_from_numpy,
    batch_to_numpy,
    chain_from_numpy,
    mpc_family_from_numpy,
    params_from_dict,
)
from .models.ik import (
    default_ik_params,
    fused_chain_ik_solve,
    make_ik_problem,
    make_planar_chain,
    make_spatial_chain,
    make_spatial_ik_problem,
    mod_pi_retraction,
    scalar_chain_fk,
    scalar_chain_ik_builder,
    solve_ik_batch,
    solve_ik_multi_start,
)
from .models.bundle_adjustment import (
    make_ba_problem,
    make_ba_schur_preconditioner_sparse,
    make_synthetic_scene,
    solve_bundle_adjustment,
    solve_bundle_adjustment_large,
)
from .models.pose_graph import (
    chordal_initialization,
    make_pose_graph_problem,
    make_tree_preconditioner,
    solve_pose_graph,
    solve_pose_graph_large,
)
from .models.pose_graph3 import (
    chordal_initialization3,
    make_pose_graph3_problem,
    make_tree_preconditioner3,
    solve_pose_graph3,
    solve_pose_graph3_large,
)
from .models.mpc import CartPole, default_mpc_params, serving_mpc_params, solve_mpc
from .nonlinear import NLSParams, Problem, compute_second_order_correction, nls_solve
from .ops.blocked import REGISTER_KKT_MAX, blocked_kkt_solve, blocked_solve_batch
from .ops.fused_auto import check_family_against_problem, family_from_problem, fused_nls_solve_batch
from .ops.fused_ik import (
    FusedFamily,
    fused_ik_solve_batch,
    fused_solve_batch,
    fused_solve_multi_start,
    fused_solve_proximal,
    fused_solve_refined,
    fused_spatial_ik_solve_batch,
    fused_termination_status,
    planar_family,
    spatial_family,
)
from .ops.fused_qp import make_fused_qp_solver
from .ops.mpc import (
    MPCFamily,
    cartpole_mpc_family,
    fused_mpc_servo_batch,
    fused_mpc_solve_batch,
    quadrotor_mpc_family,
)
from .parallel.batch import solve_batch
from .qp import (
    QP,
    LinearInequalityConstraint,
    QPInteriorPointParams,
    Var,
    build_full_kkt_system,
    qp_ip_solve,
    qp_null_space_solve,
)
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
    QPEigenvalues,
    QPNullSpaceResult,
    QPNullSpaceTerminationState,
    QPSolverVariant,
    QPTerminationState,
    StepSizeSelectionResult,
    nls_result_to_string,
    qp_iteration_to_string,
    summarize_counts,
    termination_state_indicates_satisfied_tol,
)

__all__ = [
    "AlphaValues",
    "BarrierStrategy",
    "BlockResidual",
    "CartPole",
    "DirectionalDerivatives",
    "Errors",
    "FusedFamily",
    "InitialGuessMethod",
    "KKTError",
    "LineSearchStrategy",
    "LinearInequalityConstraint",
    "MPCFamily",
    "MiniOptError",
    "NLSIterationHistory",
    "NonlinearInequalityProblem",
    "NLSParams",
    "NLSResult",
    "NLSTerminationState",
    "OptimizerState",
    "Problem",
    "QP",
    "QPEigenvalues",
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
    "build_full_kkt_system",
    "blocked_solve_batch",
    "cartpole_mpc_family",
    "chain_from_numpy",
    "check_family_against_problem",
    "compute_second_order_correction",
    "default_ik_params",
    "default_mpc_params",
    "family_from_problem",
    "fill_jacobian_rows",
    "fused_chain_ik_solve",
    "fused_ik_solve_batch",
    "fused_mpc_servo_batch",
    "fused_mpc_solve_batch",
    "fused_nls_solve_batch",
    "fused_solve_batch",
    "fused_solve_multi_start",
    "fused_solve_proximal",
    "fused_solve_refined",
    "fused_spatial_ik_solve_batch",
    "fused_termination_status",
    "make_fused_qp_solver",
    "make_ik_problem",
    "make_implicit_solver",
    "make_planar_chain",
    "make_pose_graph_problem",
    "make_pose_graph3_problem",
    "make_tree_preconditioner",
    "make_tree_preconditioner3",
    "make_ba_problem",
    "make_ba_schur_preconditioner_sparse",
    "make_synthetic_scene",
    "chordal_initialization",
    "chordal_initialization3",
    "solve_bundle_adjustment",
    "solve_bundle_adjustment_large",
    "solve_pose_graph3",
    "solve_pose_graph3_large",
    "solve_pose_graph_large",
    "make_residual",
    "make_spatial_chain",
    "make_spatial_ik_problem",
    "mod_pi_retraction",
    "mpc_family_from_numpy",
    "nls_result_to_string",
    "nls_solve",
    "params_from_dict",
    "planar_family",
    "qp_ip_solve",
    "qp_iteration_to_string",
    "qp_null_space_solve",
    "quadrotor_mpc_family",
    "robustify",
    "scalar_chain_fk",
    "scalar_chain_ik_builder",
    "serving_mpc_params",
    "solve_batch",
    "solve_ik_batch",
    "solve_ik_multi_start",
    "solve_mpc",
    "solve_pose_graph",
    "spatial_family",
    "summarize_counts",
    "termination_state_indicates_satisfied_tol",
    "validate_problem",
    "with_nonlinear_inequalities",
]
