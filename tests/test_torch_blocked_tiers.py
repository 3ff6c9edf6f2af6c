"""The PyTorch port's blocked tier held against the port's own register tier
and against dense linear algebra, on the CPU. No JAX compile: every check
here costs a fraction of a second (tests/test_torch_blocked.py holds the
same code against the JAX package).

* Below REGISTER_KKT_MAX both tiers take the same families, so the blocked
  plain version (stacked (D, D, B) KKT, right-looking LDL^T) and the
  register plain version (unrolled LDL^T) must land on the same iterates,
  as tests/test_pallas_blocked.py::test_blocked_matches_register_kernel
  holds the two JAX kernels. They sum in different orders, and the
  near-stretched warm-start chains' KKT systems amplify last-bit
  differences to a few 1e-6 at the larger budgets (9.1e-6 the largest seen
  over these cases): the tolerance is 5e-5 on x and relative on f and
  |eq|_1, flags and statuses exactly equal.
* ``blocked_kkt_solve`` against ``numpy.linalg.solve`` on well-conditioned
  quasi-definite systems (condition numbers below 100), D = 1 to 120 (the
  widths chip_smoke.py gives the kernel included): 1e-12 relative in
  float64, 1e-5 in float32 (about 4e-7 seen).
* The slice's main path, the 48-joint arm (D = 49) with the 6/3/2 budget,
  at small B on the CPU: every lane reaches its target, as
  examples/blocked_medium_n.py asserts for the JAX package.
* The argument checks of both public entry points.
* Kernel 2's launch plan (``ops/blocked.py::launch_plan``, the mirror of
  csrc/blocked_sqp.cuh's ``carve``): bytes per warp against a count of the
  slab's arrays, warps per CTA against the 232,448 bytes of a CTA, every
  size the first design launched, the grid. The ``cuda``-marked cases hold
  kernel 2 to its plain version bit for bit on a card; they skip here.
* Kernel 3's launch plan (``ops/blocked.py::kkt_launch_plan``): the route
  and systems per CTA at every D = 1..256, bytes per system against a
  count of the slab's arrays, every size the first design launched, the
  grid.
"""

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import (
    effector_error,
    medium_n_planar_instances,
    planar_instances,
)
from mini_opt_tpu_torch.ops import blocked as blk

TIER_TOL = 5e-5
OPTIONS = [
    ("armijo", "mpc"),
    ("armijo", "complementarity"),
    ("polynomial", "mpc"),
    ("polynomial", "complementarity"),
]
GENERATORS = {"warm": medium_n_planar_instances, "bench": planar_instances}


@pytest.mark.parametrize("generator", list(GENERATORS))
@pytest.mark.parametrize("options", OPTIONS, ids=["-".join(o) for o in OPTIONS])
@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_blocked_tier_matches_register_tier(n, options, generator):
    line_search, barrier = options
    data, x0 = GENERATORS[generator](32, n, seed=n)
    fam = port.planar_family(n, 0.4)
    kw = dict(max_iterations=6, qp_iterations=3, ls_iterations=2,
              line_search=line_search, barrier=barrier, return_state=True, device="cpu")
    x_reg, s_reg = port.fused_solve_batch(fam, data, x0, **kw)
    x_blk, s_blk = port.blocked_solve_batch(fam, data, x0, **kw)
    assert x_blk.shape == x_reg.shape == (32, n) and s_blk.shape == s_reg.shape == (32, 3)
    torch.testing.assert_close(x_blk, x_reg, rtol=0, atol=TIER_TOL)
    torch.testing.assert_close(s_blk[:, :2], s_reg[:, :2], rtol=TIER_TOL, atol=TIER_TOL)
    assert torch.equal(s_blk[:, 2], s_reg[:, 2])
    assert torch.equal(port.fused_termination_status(s_blk), port.fused_termination_status(s_reg))


# ---------------------------------------------------------------------------
# The standalone KKT solve against dense algebra.
# ---------------------------------------------------------------------------


def _well_conditioned_kkt(rng, B, n, m):
    """Quasi-definite KKT-shaped systems: G = A A^T / n + I, equality rows,
    zero (2, 2) block."""
    A = rng.normal(size=(B, n, n))
    G = A @ np.swapaxes(A, 1, 2) / n + np.eye(n)
    Aeq = rng.normal(size=(B, m, n))
    H = np.zeros((B, n + m, n + m))
    H[:, :n, :n] = G
    H[:, n:, :n] = Aeq
    H[:, :n, n:] = np.swapaxes(Aeq, 1, 2)
    return H


KKT_SIZES = [(1, 0), (2, 1), (5, 0), (9, 3), (16, 0), (31, 3), (44, 4), (48, 1), (88, 8), (112, 8)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("size", KKT_SIZES, ids=[f"n{n}m{m}" for n, m in KKT_SIZES])
def test_kkt_solve_matches_dense_solve(size, dtype):
    n, m = size
    rng = np.random.default_rng(100 * n + m)
    H = _well_conditioned_kkt(rng, 8, n, m)
    rhs = rng.normal(size=(8, n + m))
    assert np.linalg.cond(H).max() < 100.0
    ref = np.linalg.solve(H, rhs[..., None])[..., 0]
    got = port.blocked_kkt_solve(torch.from_numpy(H).to(dtype), torch.from_numpy(rhs).to(dtype))
    assert got.dtype == dtype and got.shape == (8, n + m)
    scale = np.abs(ref).max(1, keepdims=True) + 1.0
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert (np.abs(got.double().numpy() - ref) / scale).max() < tol


PIVOT_CASES = {
    "healthy": None,
    "zero_pivot": (0, 0, 0.0),
    "nan_entry": (1, 0, float("nan")),
    "inf_pivot": (2, 2, float("inf")),
}


@pytest.mark.parametrize("case", list(PIVOT_CASES))
def test_bad_pivot_is_flagged_on_its_lane_only(case):
    """The factorization's failure flag (pallas_blocked.py:175-179) is
    raised on a lane with a zero or non-finite pivot, and the other lanes
    solve as if alone."""
    H = torch.eye(3, dtype=torch.float64).repeat(4, 1, 1) * 2.0
    rhs = torch.ones(4, 3, dtype=torch.float64)
    if PIVOT_CASES[case] is not None:
        i, j, v = PIVOT_CASES[case]
        H[1, i, j] = v
    _, d = blk._ldlt_factor(H.permute(1, 2, 0))
    want = torch.zeros(4, dtype=torch.float64)
    want[1] = 0.0 if case == "healthy" else 1.0
    assert torch.equal(blk._factor_bad(d), want)
    x = port.blocked_kkt_solve(H, rhs)
    lanes = torch.arange(4) if case == "healthy" else torch.tensor([0, 2, 3])
    assert torch.equal(x[lanes], torch.full((len(lanes), 3), 0.5, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The main path at full width, small B.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_48_joint_arm_reaches_its_targets(dtype):
    """The slice's entry point at the example's width and budget on its
    warm-start distribution: every lane within 1e-3 of its target (the
    example's gate) and reported SATISFIED_ABSOLUTE_TOL at its gates, the
    joint limits of joints 1.. kept, and no kernel launched for CPU
    tensors."""
    targets, x0 = medium_n_planar_instances(16, 48, seed=0)
    fam = port.planar_family(48, 0.4)
    assert fam.n + fam.m_eq > port.REGISTER_KKT_MAX
    before = blk.BLOCKED_LAUNCHES
    x, state = port.fused_solve_batch(
        fam, torch.as_tensor(targets, dtype=dtype), torch.as_tensor(x0, dtype=dtype),
        max_iterations=6, qp_iterations=3, ls_iterations=2, return_state=True,
    )
    assert blk.BLOCKED_LAUNCHES == before
    assert x.shape == (16, 48) and state.shape == (16, 3) and x.dtype == dtype
    assert torch.isfinite(x).all() and torch.isfinite(state).all()
    err = effector_error("planar", x.double().numpy(), targets)
    assert err.max() < (1e-9 if dtype == torch.float64 else 1e-3)
    eps = 1e-9 if dtype == torch.float64 else 1e-6
    assert (x[:, 1:] >= -eps).all() and (x[:, 1:] <= np.pi + eps).all()
    status = port.fused_termination_status(state, f_tol=1e-8, eq_tol=1e-5)
    assert (status == int(port.NLSTerminationState.SATISFIED_ABSOLUTE_TOL)).all()


# ---------------------------------------------------------------------------
# Argument checks.
# ---------------------------------------------------------------------------

SOLVE_REJECTS = {
    "barrier": (dict(barrier="fixed"), ValueError, "barrier"),
    "line_search": (dict(line_search="wolfe"), ValueError, "line_search"),
    "max_iterations": (dict(max_iterations=0), ValueError, "max_iterations"),
    "qp_iterations": (dict(qp_iterations=-1), ValueError, "qp_iterations"),
    "ls_iterations": (dict(ls_iterations=-1), ValueError, "ls_iterations"),
    "data_rows": (dict(data=np.zeros((4, 3))), ValueError, "expected data"),
    "x0_columns": (dict(x0=np.zeros((4, 33))), ValueError, "expected data"),
}


@pytest.mark.parametrize("case", list(SOLVE_REJECTS))
def test_blocked_solve_batch_rejects(case):
    bad, exc, match = SOLVE_REJECTS[case]
    targets, x0 = medium_n_planar_instances(4, 34, seed=1)
    kw = dict(data=targets, x0=x0, max_iterations=1, qp_iterations=0, ls_iterations=0)
    kw.update(bad)
    with pytest.raises(exc, match=match):
        port.blocked_solve_batch(port.planar_family(34, 0.4), device="cpu", **kw)


def _kkt_reject_cases():
    f64 = dict(dtype=torch.float64)
    return {
        "not_square": (torch.zeros(2, 3, 4, **f64), torch.zeros(2, 3, **f64), ValueError),
        "rhs_length": (torch.eye(3, **f64).repeat(2, 1, 1), torch.zeros(2, 4, **f64), ValueError),
        "rhs_batch": (torch.eye(3, **f64).repeat(2, 1, 1), torch.zeros(3, 3, **f64), ValueError),
        "unbatched": (torch.eye(3, **f64), torch.zeros(3, **f64), ValueError),
        "mixed_dtypes": (torch.eye(3, **f64)[None], torch.zeros(1, 3), TypeError),
        "integer": (torch.eye(3, dtype=torch.int64)[None], torch.zeros(1, 3, dtype=torch.int64),
                    TypeError),
        "tensor_and_array": (torch.eye(3, **f64)[None], np.zeros((1, 3)), TypeError),
    }


@pytest.mark.parametrize("case", list(_kkt_reject_cases()))
def test_blocked_kkt_solve_rejects(case):
    H, rhs, exc = _kkt_reject_cases()[case]
    with pytest.raises(exc):
        port.blocked_kkt_solve(H, rhs)


def test_blocked_kkt_solve_takes_any_lanes():
    """JAX's blocked_kkt_solve checks no ``lanes`` (pallas_blocked.py:750-767)
    and solves with a tile of 64; so does the port."""
    rng = np.random.default_rng(64)
    H = _well_conditioned_kkt(rng, 5, 5, 1)
    rhs = rng.normal(size=(5, 6))
    x = port.blocked_kkt_solve(torch.as_tensor(H), torch.as_tensor(rhs), lanes=64)
    resid = np.abs(np.einsum("bij,bj->bi", H, x.numpy()) - rhs).max()
    assert resid <= 1e-12


# ---------------------------------------------------------------------------
# Kernel 2's launch plan.
# ---------------------------------------------------------------------------

DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]
CTA_SMEM = 232_448


def _slab_arrays(n, dtype):
    """One planar-chain instance's slab, array by array (csrc/blocked_sqp.cuh
    Slab): slots of each."""
    D, nlo, nhi = n + 1, n - 1, n - 1
    size = torch.empty((), dtype=dtype).element_size()
    # Column j of the KKT lower triangle from row 4 (j // 4) to the next
    # multiple of 4 at or past D: whole 4-row tiles.
    kkt = sum(-(-(D - 4 * (j // 4)) // 4) * 4 for j in range(D))
    return {
        "A: KKT lower triangle by columns, in 4-row tiles": kkt,
        "vec: the factor's w, the published vector": D,
        "G: Gauss-Newton lower triangle packed by rows": n * (n + 1) // 2,
        "J_eq": 1 * n,
        "c": n,
        "r_eq": 1,
        "th": n,
        "targets": 2,
        # Four candidate arrays, each from a 4-slot boundary; whole tiles.
        "scratch: family (cos, sin, J_y), step candidates, terms":
            -(-max(3 * n, 2 * (-(-nlo // 4) * 4 + -(-nhi // 4) * 4), n) // 4) * 4,
        # 2 bytes per KKT tile, in whole slots of the dtype.
        "tiles: the KKT matrix's tile table": -(-2 * (kkt // 4) // size),
    }


# The first design (one CTA per instance, a full (D, D) matrix, 256 threads)
# launched n <= 190 in float32 and n <= 132 in float64; this one takes
# n <= 191 (D <= 192, 6 rows a lane) and n <= 161 (one slab per CTA).
PARENT_LIMIT = {torch.float32: 190, torch.float64: 132}
LIMIT = {torch.float32: 191, torch.float64: 161}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [1, 2, 33, 48, 63, 64, 111, 127, 161])
def test_launch_plan_bytes_per_warp_count_the_slab(n, dtype):
    plan = blk.launch_plan(blk.planar_slab_shape(n), 8192, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.slots == sum(_slab_arrays(n, dtype).values())
    # Whole 16-byte units, so that every slab is aligned alike.
    assert plan.warp_bytes % 16 == 0 and 0 <= plan.warp_bytes - plan.slots * size < 16
    assert plan.cta_bytes == plan.warps * plan.warp_bytes <= CTA_SMEM
    # The main path's width.
    if n == 48:
        assert plan.warp_bytes == {torch.float32: 12_768, torch.float64: 24_800}[dtype]
        assert plan.rows_per_lane == 2


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_launch_plan_warps_fall_where_slabs_pass_a_cta(dtype):
    """4 warps per CTA while 4 slabs fit, else the most that fit: W slabs
    within 232,448 B and W + 1 past it."""
    seen = set()
    for n in range(1, LIMIT[dtype] + 1):
        plan = blk.launch_plan(blk.planar_slab_shape(n), 1, dtype)
        seen.add(plan.warps)
        assert 1 <= plan.warps <= blk.WARPS_PER_CTA
        assert plan.warps * plan.warp_bytes <= CTA_SMEM
        if plan.warps < blk.WARPS_PER_CTA:
            assert (plan.warps + 1) * plan.warp_bytes > CTA_SMEM
    assert seen == {1, 2, 3, 4}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_every_size_the_first_design_launched_gets_a_plan(dtype):
    for n in range(33, PARENT_LIMIT[dtype] + 1):
        plan = blk.launch_plan(blk.planar_slab_shape(n), 8192, dtype)
        assert plan.rows_per_lane == blk.rows_per_lane(n + 1)
        assert 32 * plan.rows_per_lane >= n + 1 > 32 * (plan.rows_per_lane - 2)
    assert blk.launch_plan(blk.planar_slab_shape(LIMIT[dtype]), 1, dtype).storage == "shared"
    # Past the shared route's limit the global route takes the family, up to
    # D = 256; past that the plan raises and names the limit.
    assert blk.launch_plan(blk.planar_slab_shape(LIMIT[dtype] + 1), 1, dtype).storage == "global"
    assert blk.launch_plan(blk.planar_slab_shape(blk.MAX_GLOBAL_D - 1), 1, dtype).storage == "global"
    with pytest.raises(ValueError, match="global route's 256 rows"):
        blk.launch_plan(blk.planar_slab_shape(blk.MAX_GLOBAL_D), 1, dtype)


@pytest.mark.parametrize("case", [(48, torch.float32, 4), (48, torch.float64, 4), (111, torch.float64, 2),
                                  (112, torch.float64, 1), (159, torch.float32, 2), (191, torch.float32, 1)],
                         ids=["n48-f32", "n48-f64", "n111-f64", "n112-f64", "n159-f32", "n191-f32"])
def test_launch_plan_grid(case):
    n, dtype, W = case
    assert blk.launch_plan(blk.planar_slab_shape(n), 1, dtype).warps == W
    for B, grid in ((1, 1), (W, 1), (W + 1, 2), (8192, -(-8192 // W))):
        plan = blk.launch_plan(blk.planar_slab_shape(n), B, dtype)
        assert (plan.warps, plan.grid) == (W, grid)
        assert plan.grid * plan.warps >= B > (plan.grid - 1) * plan.warps


# ---------------------------------------------------------------------------
# Kernel 3's launch plan (ops/blocked.py::kkt_launch_plan, the mirror of
# csrc/blocked_kkt.cu's warp_slab_bytes and kkt_smem_bytes): one warp per
# system up to D = 192, one CTA per system past it.
# ---------------------------------------------------------------------------

# The largest D of the CTA route of the first design (one CTA per system, a
# (D, D | 1) matrix, d and w in shared memory), which took every D from 1.
KKT_PARENT_LIMIT = {torch.float32: 239, torch.float64: 169}


def _kkt_slab(D, dtype):
    """One system's slab on the warp route, array by array."""
    size = torch.empty((), dtype=dtype).element_size()
    kkt = sum(-(-(-(-D // 4) * 4 - 4 * (j // 4)) // 4) * 4 for j in range(D))
    return {
        "A: the lower triangle by columns, in 4-row tiles": kkt,
        "w: the factor's scratch, in whole tiles": -(-D // 4) * 4,
        "tiles: the table of A's tiles, 2 bytes each": -(-2 * (kkt // 4) // size),
    }


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kkt_launch_plan_routes_over_every_size(dtype):
    """D = 1..256: the warp route up to 32 * MAX_ROWS_PER_LANE (rows a lane
    as kernel 2's), W slabs within a CTA and W + 1 past it where W < 4; the
    CTA route past it while (D, D | 1) + 2 D slots and ceil(D / 32) warps fit
    one CTA; ValueError beyond. Every D the first design launched still
    gets a plan."""
    size = torch.empty((), dtype=dtype).element_size()
    for D in range(1, 257):
        cta = (D * (D | 1) + 2 * D) * size
        if D > 32 * blk.MAX_ROWS_PER_LANE and (cta > CTA_SMEM or D > blk.KKT_CTA_THREADS):
            assert D > KKT_PARENT_LIMIT[dtype]
            with pytest.raises(ValueError, match="does not fit a CTA"):
                blk.kkt_launch_plan(D, 1, dtype)
            continue
        plan = blk.kkt_launch_plan(D, 1, dtype)
        if D <= 32 * blk.MAX_ROWS_PER_LANE:
            assert (plan.route, plan.rows_per_lane) == ("warp", blk.rows_per_lane(D))
            assert 1 <= plan.warps <= blk.WARPS_PER_CTA and plan.threads == 32 * plan.warps
            assert plan.cta_bytes == plan.warps * plan.system_bytes <= CTA_SMEM
            if plan.warps < blk.WARPS_PER_CTA:
                assert (plan.warps + 1) * plan.system_bytes > CTA_SMEM
        else:
            assert (plan.route, plan.warps, plan.rows_per_lane) == ("cta", 1, 0)
            assert plan.threads == -(-D // 32) * 32 and plan.cta_bytes == plan.system_bytes == cta
    for D in range(1, KKT_PARENT_LIMIT[dtype] + 1):
        blk.kkt_launch_plan(D, 8192, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("D", [1, 2, 7, 33, 49, 64, 65, 128, 129, 192])
def test_kkt_launch_plan_bytes_count_the_slab(D, dtype):
    plan = blk.kkt_launch_plan(D, 8192, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    slots = sum(_kkt_slab(D, dtype).values())
    assert blk.kkt_slab_slots(D, dtype) == slots
    assert plan.system_bytes % 16 == 0 and 0 <= plan.system_bytes - slots * size < 16
    if D == 49:  # the standalone path's width
        assert (plan.warps, plan.system_bytes) == (4, {torch.float32: 6_720, torch.float64: 12_704}[dtype])


@pytest.mark.parametrize("case", [(49, torch.float32), (128, torch.float64), (192, torch.float64), (200, torch.float32)],
                         ids=["D49-f32", "D128-f64", "D192-f64", "D200-f32"])
def test_kkt_launch_plan_grid(case):
    D, dtype = case
    W = blk.kkt_launch_plan(D, 1, dtype).warps
    for B, grid in ((1, 1), (W, 1), (W + 1, 2), (8192, -(-8192 // W))):
        plan = blk.kkt_launch_plan(D, B, dtype)
        assert (plan.warps, plan.grid) == (W, grid)


# ---------------------------------------------------------------------------
# On a card: kernel 2 against its plain version. The skip condition is a
# string, so pytest evaluates it when each test is set up.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: kernel 2 (csrc/blocked.cu) has no CPU mode",
)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("batch", ["one", "ragged", "full"])
def test_kernel_2_bit_identical_to_plain_on_card(batch, dtype):
    """One instance, a ragged last CTA (W + 1 instances) and 8192 + 13 with
    a NaN-target lane, at the main path's width and budget: bit for bit,
    the NaN lane flagged."""
    n = 48
    W = blk.launch_plan(blk.planar_slab_shape(n), 1, dtype).warps
    B = {"one": 1, "ragged": W + 1, "full": 8192 + 13}[batch]
    data, x0 = medium_n_planar_instances(B, n, seed=3)
    if B > 5:
        data[5, 0] = np.nan
    d_t, x_t = port.batch_from_numpy(data, x0, "cuda", dtype)
    args = (port.planar_family(n, 0.4), d_t, x_t, 6, 3, 2, "armijo", "mpc")
    before = blk.BLOCKED_LAUNCHES
    got = blk._blocked_solve_cuda(*args)
    torch.cuda.synchronize()
    assert blk.BLOCKED_LAUNCHES == before + 1
    want = blk._blocked_solve_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if B > 5:
        assert got[1][2, 5] != 0
