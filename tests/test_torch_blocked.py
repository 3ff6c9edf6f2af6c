"""The PyTorch port's blocked tier against the JAX package, on the CPU in
float64.

The same numpy instances go through ``mini_opt_tpu.ops.pallas_blocked``
(the Pallas kernels in interpret mode, as tests/test_pallas_blocked.py runs
them) and through ``mini_opt_tpu_torch`` (CPU tensors run the plain PyTorch
versions of the CUDA kernels). Each JAX reference is computed once per
module; its interpret-mode compile is the cost of this file.

Sizes: D = 5 and 9. The blocked code is generic in D (its loops run over
the static D and the planar family has no sparsity hints), so these sizes
run the same statements as the 48-joint arm, and a JAX compile of the
blocked kernel past D = 16 costs half a minute or more per budget. The
full-width D = 49 runs on the card in chip_smoke.py; past D = 32 this file
checks the port's own dispatch, with no JAX compile.

Tolerance: 1e-9 relative (|port - jax| <= 1e-9 max(1, |jax|)) on x and
state, flags and statuses exactly equal. The instances come from the
medium-N example's warm-start distribution
(``instances.medium_n_planar_instances``). Budgets are chosen where the two
packages agree to that tolerance: compiled JAX on an FMA-capable CPU
contracts ``a*b + c``, and with the complementarity barrier past one QP
iteration, or the 6/3/2 Mehrotra budget, the near-stretched short chains'
KKT systems amplify that last-bit difference to 1e-8..1e-7 (it vanishes
under ``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` with the JAX summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu.ops import kkt
from mini_opt_tpu.ops import pallas_blocked as jax_blocked
from mini_opt_tpu.ops import pallas_ik as jax_ik
from mini_opt_tpu_torch.instances import medium_n_planar_instances
from mini_opt_tpu_torch.ops import blocked as blk

TOL = 1e-9
B = 24
NAN_TARGET_LANE = 3

# (n, budget): (a) D = 5, complementarity + polynomial with two line-search
# probes (the quadratic and the cubic fit); (b) D = 9, Mehrotra + Armijo.
# One JAX compile each (a few seconds each on a CPU).
CASES = {
    "a_planar4_complementarity_polynomial": (
        4,
        dict(max_iterations=4, qp_iterations=1, ls_iterations=2,
             barrier="complementarity", line_search="polynomial"),
    ),
    "b_planar8_mpc_armijo": (8, dict(max_iterations=4, qp_iterations=2, ls_iterations=1)),
}


@pytest.fixture(scope="module")
def solved():
    """Per case: (jax outputs, port outputs, data, x0), outputs as numpy
    (x (B, n), state (B, 3))."""
    out = {}
    for seed, (name, (n, kw)) in enumerate(CASES.items()):
        data, x0 = medium_n_planar_instances(B, n, seed=seed)
        data[NAN_TARGET_LANE, 0] = np.nan
        ref = jax_blocked.blocked_solve_batch(
            jax_ik.planar_family(n, 0.4), jnp.asarray(data), jnp.asarray(x0),
            return_state=True, **kw,
        )
        got = port.blocked_solve_batch(
            port.planar_family(n, 0.4), data, x0, return_state=True, device="cpu", **kw
        )
        out[name] = ([np.asarray(r) for r in ref], [g.numpy() for g in got], data, x0)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("output", ["x", "state"])
def test_port_matches_jax(solved, case, output):
    ref, got, _, _ = solved[case]
    i = ["x", "state"].index(output)
    assert got[i].shape == ref[i].shape
    assert got[i].dtype == np.float64
    np.testing.assert_allclose(got[i], ref[i], rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("case", list(CASES))
def test_flags_and_status_identical(solved, case):
    ref, got, _, _ = solved[case]
    np.testing.assert_array_equal(got[1][:, 2], ref[1][:, 2])
    want = np.asarray(jax_ik.fused_termination_status(jnp.asarray(ref[1])))
    have = port.fused_termination_status(torch.from_numpy(got[1])).numpy()
    np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("case", list(CASES))
def test_nan_target_lane_is_contained(solved, case):
    """As tests/test_pallas_blocked.py:224-252: a NaN target makes every
    merit NaN, so the lane keeps its start (f_best stays +inf) and reports
    a failure status, the same in both packages; the other lanes stay
    finite."""
    ref, got, _, x0 = solved[case]
    S = port.NLSTerminationState
    st_ref = np.asarray(jax_ik.fused_termination_status(jnp.asarray(ref[1])))
    st_got = port.fused_termination_status(torch.from_numpy(got[1])).numpy()
    lane = NAN_TARGET_LANE
    assert st_got[lane] == st_ref[lane]
    assert st_got[lane] in (int(S.MAX_LAMBDA), int(S.QP_INDEFINITE))
    np.testing.assert_array_equal(got[0][lane], x0[lane])
    others = np.arange(B) != lane
    assert np.isfinite(got[0][others]).all() and np.isfinite(got[1][others]).all()


# ---------------------------------------------------------------------------
# The standalone blocked KKT solve.
# ---------------------------------------------------------------------------


def _quasi_definite_kkt(rng, B, n, m):
    """Condensed-KKT-shaped systems (tests/test_pallas_blocked.py:32-43): PD
    (1,1) block, equality rows, zero (2,2) block."""
    A = rng.normal(size=(B, n, n))
    G = A @ np.swapaxes(A, 1, 2) + 2.0 * np.eye(n)
    Aeq = rng.normal(size=(B, m, n))
    D = n + m
    H = np.zeros((B, D, D))
    H[:, :n, :n] = G
    H[:, n:, :n] = Aeq
    H[:, :n, n:] = np.swapaxes(Aeq, 1, 2)
    return H


@pytest.fixture(scope="module")
def kkt_case():
    """D = 12 quasi-definite (so indefinite) systems, B = 150: no multiple of
    the JAX kernel's 128-lane tile. Returns (H, rhs, jax x, port x)."""
    rng = np.random.default_rng(0)
    H = _quasi_definite_kkt(rng, 150, 9, 3)
    rhs = rng.normal(size=(150, 12))
    ref = np.asarray(jax_blocked.blocked_kkt_solve(jnp.asarray(H), jnp.asarray(rhs)))
    got = port.blocked_kkt_solve(torch.from_numpy(H), torch.from_numpy(rhs)).numpy()
    return H, rhs, ref, got


def test_kkt_solve_matches_jax(kkt_case):
    H, _, ref, got = kkt_case
    assert np.linalg.eigvalsh(H[0]).min() < 0 < np.linalg.eigvalsh(H[0]).max()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lane", [0, 7, 149])
def test_kkt_solve_matches_ldlt_oracle(kkt_case, lane):
    """Against ops/kkt.py::ldlt_factorize / ldlt_solve, as
    tests/test_pallas_blocked.py:46-63 holds the JAX kernel."""
    H, rhs, _, got = kkt_case
    fact, ok = kkt.ldlt_factorize(jnp.asarray(H[lane]))
    assert bool(ok)
    ref = np.asarray(kkt.ldlt_solve(fact, jnp.asarray(rhs[lane])))
    scale = np.max(np.abs(ref)) + 1.0
    assert np.max(np.abs(got[lane] - ref)) / scale < 1e-10


def test_kkt_solve_reads_the_lower_triangle_only(kkt_case):
    H, rhs, _, got = kkt_case
    junk = np.triu(np.full_like(H, 7.0), 1)
    again = port.blocked_kkt_solve(torch.from_numpy(np.tril(H) + junk), torch.from_numpy(rhs))
    np.testing.assert_array_equal(again.numpy(), got)


# ---------------------------------------------------------------------------
# The port's own dispatch past D = 32 (no JAX compile).
# ---------------------------------------------------------------------------

KW33 = dict(max_iterations=2, qp_iterations=1, ls_iterations=1)


@pytest.fixture(scope="module")
def planar33():
    targets, x0 = medium_n_planar_instances(6, 33, seed=5)
    fam = port.planar_family(33, 0.4)
    return fam, torch.from_numpy(targets), torch.from_numpy(x0)


def test_fused_solve_batch_past_d32_is_the_blocked_tier(planar33):
    fam, targets, x0 = planar33
    assert fam.n + fam.m_eq > port.REGISTER_KKT_MAX
    via = port.fused_solve_batch(fam, targets, x0, return_state=True, **KW33)
    direct = port.blocked_solve_batch(fam, targets, x0, return_state=True, **KW33)
    for v, d in zip(via, direct):
        assert torch.equal(v, d)
    with pytest.raises(ValueError, match="debug_history"):
        port.fused_solve_batch(fam, targets, x0, debug_history=True, **KW33)


@pytest.mark.parametrize("lanes", [256, 1024])
def test_lanes_change_no_result(planar33, lanes):
    """``lanes`` is the JAX kernels' tile width, never a result.
    ``blocked_solve_batch`` checks it as pallas_blocked.py:686 does (a
    positive multiple of 128); ``blocked_kkt_solve`` takes any value, as
    JAX's does (pallas_blocked.py:750-767)."""
    fam, targets, x0 = planar33
    want = port.blocked_solve_batch(fam, targets, x0, **KW33)
    got = port.blocked_solve_batch(fam, targets, x0, lanes=lanes, **KW33)
    assert torch.equal(got, want)
    H, rhs = torch.eye(3)[None], torch.ones(1, 3)
    for bad in (100, 0):
        with pytest.raises(ValueError, match="lanes"):
            port.blocked_solve_batch(fam, targets, x0, lanes=bad, **KW33)
        assert torch.equal(port.blocked_kkt_solve(H, rhs, lanes=bad), port.blocked_kkt_solve(H, rhs))


def test_cpu_blocked_paths_launch_no_kernel(planar33):
    fam, targets, x0 = planar33
    before = (blk.BLOCKED_LAUNCHES, blk.KKT_LAUNCHES)
    port.blocked_solve_batch(fam, targets, x0, **KW33)
    port.blocked_kkt_solve(torch.eye(4, dtype=torch.float64)[None], torch.ones(1, 4, dtype=torch.float64))
    assert (blk.BLOCKED_LAUNCHES, blk.KKT_LAUNCHES) == before
