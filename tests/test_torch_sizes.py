"""The port's fused tiers at sizes the earlier slices' comparisons leave out,
held against the JAX package on the CPU in float64.

The same seeded numpy instances go through the JAX package (its Pallas
kernels in interpret mode, as its own tests run them on the CPU, and the
pose ring's xla route) and through the port (CPU tensors run the plain
PyTorch versions of the CUDA kernels):

* the register tier past n = 8: ``fused_ik_solve_batch`` at planar n = 9
  and ``fused_spatial_ik_solve_batch`` at n = 9 (D = 10), whose card
  instances are built one per size since this slice;
* the blocked tier on the spatial chain, ``blocked_solve_batch`` on
  ``spatial_family(8)`` (D = 9): the plain version of kernel 2's new
  SpatialChain functor;
* the pose ring with more border poses and closures than kernel 7's
  template route takes: N = 8, every pose a border (k = 8) and 17 closures,
  the plain version of the run-time route.

Each JAX reference is computed once per module, the four in threads side
by side. Their compiles are the cost of this file: about 25, 40, 15 and
25 s one after another on this host; the budgets are the smallest that run
every part of each solve (2 outer iterations, one QP iteration, one
line-search probe). Tolerance: 1e-9 abs on x and the state
(tests/test_torch_fused_ik.py's), flags exactly equal: what remains is
libm's sin/cos against XLA's and XLA's FMA contraction on an FMA-capable
CPU.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import mini_opt_tpu_torch as port
from mini_opt_tpu.ops import pallas_blocked as jax_blocked
from mini_opt_tpu.ops import pallas_ik as jax_ik
from mini_opt_tpu.ops import pallas_pose_ring as jax_ring
from mini_opt_tpu_torch.instances import chain_closure_instances, planar_instances, spatial_fk, spatial_instances
from mini_opt_tpu_torch.ops import pose_ring as pr

TOL = 1e-9
B = 16
NAN_TARGET_LANE = 3
KW = dict(max_iterations=2, qp_iterations=1, ls_iterations=1)
# Every pose of the 8-pose chain a border, joined by the first 17 closures
# (a, b) with b - a >= 2: past the template route's 6 borders and 16
# closures.
RING_N = 8
RING_CLOSURES = tuple((a, b) for a in range(RING_N) for b in range(RING_N) if b - a >= 2)[:17]


def _spatial_arm(n, seed):
    """Reference poses off the straight chain's singularity as warm starts,
    targets a small task step from their effectors."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.3, 1.2, (B, n))
    th[:, 0] = rng.uniform(-0.3, 0.3, B)
    return spatial_fk(th) + rng.uniform(-0.05, 0.05, (B, 3)), th


def _jax_and_port(case):
    """One case's JAX reference and port result: (JAX (x, state), port
    (x, state)) as numpy."""
    if case in ("planar9", "spatial9"):
        data, x0 = (planar_instances if case == "planar9" else spatial_instances)(B, 9, seed=9)
        data[NAN_TARGET_LANE, 0] = np.nan
        jax_fn = jax_ik.fused_ik_solve_batch if case == "planar9" else jax_ik.fused_spatial_ik_solve_batch
        port_fn = port.fused_ik_solve_batch if case == "planar9" else port.fused_spatial_ik_solve_batch
        ref = jax_fn(jnp.asarray(data), jnp.asarray(x0), return_state=True, **KW)
        got = port_fn(data, x0, return_state=True, device="cpu", **KW)
    elif case == "blocked_spatial8":
        data, x0 = _spatial_arm(8, seed=8)
        data[NAN_TARGET_LANE, 0] = np.nan
        ref = jax_blocked.blocked_solve_batch(jax_ik.spatial_family(8, 0.4), jnp.asarray(data), jnp.asarray(x0),
                                              return_state=True, **KW)
        got = port.blocked_solve_batch(port.spatial_family(8, 0.4), data, x0, return_state=True, device="cpu", **KW)
    else:
        data, x0 = chain_closure_instances(B, RING_N, RING_CLOSURES, seed=5)
        data[NAN_TARGET_LANE, 4] = np.nan
        jfam = jax_ring.pose_ring_family(RING_N, closures=RING_CLOSURES)
        ref = jax_ring.pose_ring_solve_batch(jfam, jnp.asarray(data), jnp.asarray(x0), return_state=True,
                                             backend="xla", max_iterations=2, ls_iterations=1)
        fam, d_t, x_t = port.convert.pose_ring_from_numpy(
            dataclasses.asdict(jfam), data.reshape(B, -1, 3), x0.reshape(B, -1, 3), device="cpu")
        got = pr.pose_ring_solve_batch(fam, d_t, x_t, return_state=True, max_iterations=2, ls_iterations=1)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.fixture(scope="module")
def solved():
    """Every case, the four JAX compiles side by side in threads (XLA
    compiles outside the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(_jax_and_port, CASES)))


CASES = ["planar9", "spatial9", "blocked_spatial8", "ring8_k8_17closures"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("output", ["x", "state"])
def test_port_matches_jax(solved, case, output):
    ref, got = solved[case]
    i = ["x", "state"].index(output)
    assert got[i].shape == ref[i].shape and got[i].dtype == np.float64
    np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("case", CASES)
def test_flags_identical_and_nan_lane_contained(solved, case):
    ref, got = solved[case]
    np.testing.assert_array_equal(got[1][:, 2], ref[1][:, 2])
    assert got[1][NAN_TARGET_LANE, 2] != 0
    others = np.arange(B) != NAN_TARGET_LANE
    assert np.isfinite(got[0][others]).all() and np.isfinite(got[1][others]).all()


def test_ring_case_takes_the_run_time_route():
    assert pr.table_route(RING_CLOSURES) == RING_N
    assert len(RING_CLOSURES) > pr.TEMPLATE_MAX_CLOSURES
