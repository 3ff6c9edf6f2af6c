"""The PyTorch port's fused IK path against the JAX package, on the CPU in
float64.

The same numpy instances go through ``mini_opt_tpu.ops.pallas_ik`` (the
Pallas kernel in interpret mode, as the JAX tests run it on the CPU) and through
``mini_opt_tpu_torch`` (CPU tensors run the plain PyTorch version of the
CUDA kernel). Each JAX reference is computed once per module: its
interpret-mode compile is the cost of this file.

Tolerance: 1e-9 abs on x, state and history, flags and statuses exactly
equal. What remains is libm's sin/cos against XLA's and XLA's FMA
contraction on an FMA-capable CPU, carried through a few iterations. The instances
come from the bench's own distribution (reachable targets, warm starts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu.ops import pallas_ik as jax_ik
from mini_opt_tpu_torch.instances import planar_instances, spatial_instances

TOL = 1e-9
B = 61
NAN_TARGET_LANE = 7
NAN_START_LANE = 11

# (family, n, budget): (a) the bench budget, (b) the other barrier and line
# search, (c) the spatial family.
CASES = {
    "a_planar2_mpc_armijo": (
        "planar", 2,
        dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo"),
    ),
    "b_planar3_complementarity_polynomial": (
        "planar", 3,
        dict(max_iterations=3, qp_iterations=2, ls_iterations=2,
             barrier="complementarity", line_search="polynomial"),
    ),
    "c_spatial3_mpc_armijo": (
        "spatial", 3,
        dict(max_iterations=3, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo"),
    ),
}


def _inputs(kind, n, seed):
    data, x0 = (planar_instances if kind == "planar" else spatial_instances)(B, n, seed=seed)
    # One lane with a NaN target and one with a NaN start pin the NaN
    # semantics (jnp.maximum/minimum/sign) of both packages.
    data[NAN_TARGET_LANE, 0] = np.nan
    x0[NAN_START_LANE, 1] = np.nan
    return data, x0


@pytest.fixture(scope="module")
def solved():
    """Per case: (jax outputs, port outputs, data, x0), outputs as numpy
    (x (B, n), state (B, 3), history (B, iters, 7 + n))."""
    out = {}
    for seed, (name, (kind, n, kw)) in enumerate(CASES.items()):
        data, x0 = _inputs(kind, n, seed)
        jax_fn = jax_ik.fused_ik_solve_batch if kind == "planar" else jax_ik.fused_spatial_ik_solve_batch
        port_fn = port.fused_ik_solve_batch if kind == "planar" else port.fused_spatial_ik_solve_batch
        ref = jax_fn(jnp.asarray(data), jnp.asarray(x0), return_state=True, debug_history=True, **kw)
        got = port_fn(data, x0, return_state=True, debug_history=True, device="cpu", **kw)
        out[name] = ([np.asarray(r) for r in ref], [g.numpy() for g in got], data, x0)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("output", ["x", "state", "history"])
def test_port_matches_jax(solved, case, output):
    ref, got, _, _ = solved[case]
    i = ["x", "state", "history"].index(output)
    assert got[i].shape == ref[i].shape
    assert got[i].dtype == np.float64
    np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("case", list(CASES))
def test_flags_and_status_identical(solved, case):
    ref, got, _, _ = solved[case]
    np.testing.assert_array_equal(got[1][:, 2], ref[1][:, 2])
    want = np.asarray(jax_ik.fused_termination_status(jnp.asarray(ref[1])))
    have = port.fused_termination_status(torch.from_numpy(got[1])).numpy()
    assert have.dtype == np.int32
    np.testing.assert_array_equal(have, want)


def test_nan_lanes_follow_jax(solved):
    """A NaN target leaves a finite cost but a NaN equality residual; a NaN
    start poisons every factorization. In both packages the lane keeps its
    start (no merit ever compares better) and ends QP_INDEFINITE; NaN-
    propagating clamps make the history's bounded dx channels NaN too."""
    ref, got, data, x0 = solved["a_planar2_mpc_armijo"]
    for lane in (NAN_TARGET_LANE, NAN_START_LANE):
        np.testing.assert_array_equal(got[0][lane], x0[lane])
        np.testing.assert_array_equal(ref[0][lane], x0[lane])
        np.testing.assert_array_equal(np.isnan(got[2][lane]), np.isnan(ref[2][lane]))
    assert np.isnan(got[2][NAN_TARGET_LANE, :, 7 + 1]).all()
    status = port.fused_termination_status(torch.from_numpy(got[1])).numpy()
    qp_indefinite = int(port.NLSTerminationState.QP_INDEFINITE)
    assert status[NAN_TARGET_LANE] == status[NAN_START_LANE] == qp_indefinite


@pytest.mark.parametrize("width", [3, 2])
def test_termination_status_matches_jax(width):
    """Hand-built terminal states: converged, budget-exhausted, NaN, inf,
    singular (flag 1), lambda-maxed (flag 2), both flags, and a converged
    lane whose flags do not matter; the (B, 2) form has no flags."""
    nan, inf = np.nan, np.inf
    state = np.array(
        [
            [1e-9, 1e-7, 0.0],
            [1e-3, 1e-7, 0.0],
            [nan, 1e-7, 0.0],
            [1e-9, inf, 0.0],
            [1e-3, 1e-2, 1.0],
            [1e-3, 1e-2, 2.0],
            [1e-3, 1e-2, 3.0],
            [1e-9, 1e-7, 3.0],
            [1e-6, 1e-5, 0.0],
        ]
    )[:, :width]
    want = np.asarray(jax_ik.fused_termination_status(jnp.asarray(state)))
    have = port.fused_termination_status(torch.from_numpy(state)).numpy()
    np.testing.assert_array_equal(have, want)
    if width == 3:
        S = port.NLSTerminationState
        assert list(have) == [
            S.SATISFIED_ABSOLUTE_TOL, S.MAX_ITERATIONS, S.MAX_LAMBDA, S.MAX_LAMBDA,
            S.QP_INDEFINITE, S.MAX_LAMBDA, S.QP_INDEFINITE, S.SATISFIED_ABSOLUTE_TOL,
            S.SATISFIED_ABSOLUTE_TOL,
        ]


def test_structs_enums_keep_jax_values():
    from mini_opt_tpu import structs as jax_structs
    from mini_opt_tpu_torch import structs as port_structs

    for name in (
        "BarrierStrategy", "InitialGuessMethod", "LineSearchStrategy", "OptimizerState",
        "StepSizeSelectionResult", "QPTerminationState", "QPNullSpaceTerminationState",
        "QPSolverVariant", "NLSTerminationState",
    ):
        want = {m.name: int(m) for m in getattr(jax_structs, name)}
        have = {m.name: int(m) for m in getattr(port_structs, name)}
        assert have == want, name
