"""mini_opt_tpu_torch: the PyTorch / CUDA port of mini_opt_tpu for NVIDIA
Hopper (H100).

It imports torch and never jax, and nothing of ``mini_opt_tpu``. The port
grows slice by slice. It carries the fused batched-IK serving path: the
hand-written planar and spatial families solved by one whole-SQP CUDA kernel
(``csrc/fused_ik.cu``) up to D = n + m_eq = 32, and past it the blocked tier
(``csrc/blocked.cu``, with the standalone LDL^T solve of
``csrc/blocked_kkt.cu``), each with a plain PyTorch version of the same
computation for CPU tensors.
"""

from .convert import batch_from_numpy, batch_to_numpy
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
from .structs import NLSTerminationState

__all__ = [
    "FusedFamily",
    "NLSTerminationState",
    "REGISTER_KKT_MAX",
    "batch_from_numpy",
    "batch_to_numpy",
    "blocked_kkt_solve",
    "blocked_solve_batch",
    "fused_ik_solve_batch",
    "fused_solve_batch",
    "fused_spatial_ik_solve_batch",
    "fused_termination_status",
    "planar_family",
    "spatial_family",
]
