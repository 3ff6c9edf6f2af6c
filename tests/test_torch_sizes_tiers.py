"""The port's fused tiers at every size the JAX package's entry points take,
with no JAX compile (float64 CPU tensors run the plain versions).

* Kernel 1's instance table (``ops/_build.py::fused_ik_flags`` /
  ``fused_ik_path``): every chain length n = 1..31 of both hand families and
  both types maps to its own instance, built at first use with the defines
  of that instance; n = 0 and 32 raise, and so does the wrapper at n = 32;
  a bound instance comes back by its key with no file work.
* Kernel 2's routes (``ops/blocked.py::launch_plan``): the shared route up
  to D = 192 where one slab fits a CTA, the global route past it (D = 193,
  256 and the float64 slab threshold n = 161 / 162), its rows a lane and
  the slab's count, and the refusal past D = 256 (D = 512) with its limit in
  the text.
* The spatial chain on the blocked tier: its slab shape, the entry point's
  dispatch past D = 32, and the plain blocked tier against the plain
  register tier at n = 4..8 within 5e-5 (the two tiers' algorithms differ
  in their summation orders, so they agree to the solve's tolerance, not to
  the bit).
* Kernel 7's run-time route (``ops/pose_ring.py::table_route``,
  ``ring_schedule``, ``layout_slots``): the route choice, the schedule
  against the plain version's borders and segments, the slab's Schur area,
  and 2/1 solves with k = 7..12 border poses within 1e-10 of the port's
  general twin (``nls_solve`` on ``make_pose_graph_problem``) on the same
  lanes.
* The ``cuda`` cases hold every new route bit for bit against its plain
  version on a card; they skip here.
"""

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import (
    chain_closure_instances,
    chain_edges,
    medium_n_planar_instances,
    spatial_fk,
    spatial_instances,
)
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.nonlinear import NLSParams, nls_solve
from mini_opt_tpu_torch.ops import _build
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import pose_ring as pr
from mini_opt_tpu_torch.structs import LineSearchStrategy

FAMILIES = {"planar": 0, "spatial": 1}


# ---------------------------------------------------------------------------
# Kernel 1: one instance per family, chain length and type.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n", range(1, 32))
def test_every_register_size_has_an_instance(n, family):
    f = FAMILIES[family]
    paths = set()
    for double in (False, True):
        flags = _build.fused_ik_flags(f, n, double)
        assert f"-DMO_IK_FAMILY={f}" in flags and f"-DMO_IK_N={n}" in flags
        assert f"-DMO_IK_DOUBLE={int(double)}" in flags
        assert "-DMO_FUSED_IK_MIN_N=1" in flags and "-DMO_FUSED_IK_MAX_N=31" in flags
        assert ("-Xcicc" in flags) == (n > _build.LARGE_FUSED_IK_N)
        path = _build.fused_ik_path(f, n, double)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"libmini_opt_fused_ik_{family}{n}_{'f64' if double else 'f32'}_")
        paths.add(path)
    assert len(paths) == 2


def test_the_cap_has_one_home():
    assert (fik.CUDA_MIN_N, fik.CUDA_MAX_N) == (1, blk.REGISTER_KKT_MAX - 1)
    assert "fused_ik.cu" in _build.INSTANCE_SOURCES
    assert all(p.name != "fused_ik.cu" for p in _build._cu_sources())


@pytest.mark.parametrize("n", [0, 32])
def test_no_instance_past_the_register_tier(n):
    with pytest.raises(ValueError, match=r"n = 1\.\.31"):
        _build.fused_ik_flags(0, n, False)
    if n == 32:
        data, x0 = torch.zeros(4, 2, dtype=torch.float64), torch.zeros(4, 32, dtype=torch.float64)
        with pytest.raises(NotImplementedError, match=r"n = 1\.\.31"):
            fik._fused_solve_cuda(fik.planar_family(32, 0.4), data, x0, 2, 1, 1, "armijo", "mpc", False)


def test_a_loaded_instance_is_returned_without_file_work(monkeypatch):
    # Kernel 1's wrapper asks for its instance on every launch: once bound,
    # the library comes back by (family, n, type) with no build, no stat and
    # no hash of the sources.
    loaded = object()
    monkeypatch.setitem(_build._fused_ik, (0, 2, False), loaded)

    def no_file_work(*args, **kwargs):
        raise AssertionError("a loaded instance touched the build")

    monkeypatch.setattr(_build, "build_fused_ik", no_file_work)
    monkeypatch.setattr(_build, "fused_ik_path", no_file_work)
    assert _build.load_fused_ik(0, 2, False) is loaded
    assert _build.load_fused_ik(0, 2, 0) is loaded
    with pytest.raises(AssertionError, match="touched the build"):
        _build.load_fused_ik(0, 3, False)


def test_unknown_family_has_no_instance():
    with pytest.raises(ValueError, match="families 0 and 1"):
        _build.fused_ik_flags(2, 4, False)


# ---------------------------------------------------------------------------
# Kernel 2: the shared and the global route.
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (family, n, dtype, storage, rows a lane)
    ("planar", 191, torch.float32, "shared", 6),  # D = 192, the shared route's last row count
    ("planar", 192, torch.float32, "global", 8),  # D = 193
    ("planar", 255, torch.float32, "global", 8),  # D = 256
    ("planar", 161, torch.float64, "shared", 6),  # the last float64 slab that fits a CTA
    ("planar", 162, torch.float64, "global", 6),
    ("spatial", 48, torch.float32, "shared", 2),
    ("spatial", 200, torch.float64, "global", 8),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[f"{c[0]}{c[1]}-{'f32' if c[2] == torch.float32 else 'f64'}"
                                                   for c in ROUTE_CASES])
def test_launch_plan_route(case):
    kind, n, dtype, storage, rows = case
    family = (fik.planar_family if kind == "planar" else fik.spatial_family)(n, 0.4)
    shape = blk.slab_shape(family)
    plan = blk.launch_plan(shape, 8192, dtype)
    assert (plan.storage, plan.rows_per_lane) == (storage, rows)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.warp_bytes % 16 == 0 and 0 <= plan.warp_bytes - plan.slots * size < 16
    if storage == "shared":
        assert plan.slabs == 0 and plan.cta_bytes == plan.warps * plan.warp_bytes <= blk.MAX_CTA_SMEM
        assert plan.grid == -(-8192 // plan.warps)
    else:
        # One warp a CTA, each with a slab of the global scratch that it
        # reuses for the instances it solves in turn.
        assert (plan.warps, plan.cta_bytes) == (1, 0)
        assert plan.slabs == plan.grid == min(8192, blk.GLOBAL_SLABS)
        assert blk.launch_plan(shape, 5, dtype).slabs == 5
        assert plan.slots == _carve_count(shape, dtype)


def _carve_count(shape, dtype):
    """One instance's slab, array by array, as csrc/blocked_sqp.cuh's carve
    takes it."""
    n, m = shape.n, shape.m
    D = n + m
    size = torch.empty((), dtype=dtype).element_size()
    kkt = sum(-(-(D - 4 * (j // 4)) // 4) * 4 for j in range(D))

    def r4(k):
        return -(-k // 4) * 4

    return (kkt + r4(max(shape.scratch, 2 * (r4(shape.nlo) + r4(shape.nhi)), n)) + D + n * (n + 1) // 2
            + m * n + n + m + n + shape.rows + -(-2 * (kkt // 4) // size))


@pytest.mark.parametrize("D", [192, 193, 256, 257, 512])
def test_global_rows_per_lane(D):
    want = 6 if D <= 192 else 8 if D <= 256 else 0
    assert blk.global_rows_per_lane(D) == want
    assert 32 * want >= D or want == 0
    assert blk.rows_per_lane(D) == (6 if D <= 192 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_past_the_global_route_the_plan_names_its_limit(dtype):
    with pytest.raises(ValueError, match=r"D = 257 passes its global route's 256 rows"):
        blk.launch_plan(blk.planar_slab_shape(256), 1, dtype)
    with pytest.raises(ValueError, match=r"D = 512 passes its global route's 256 rows"):
        blk.launch_plan(blk.planar_slab_shape(511), 1, dtype)
    with pytest.raises(ValueError, match=r"global route's 256 rows"):
        blk.launch_plan(blk.spatial_slab_shape(600), 1, dtype)


# ---------------------------------------------------------------------------
# The spatial chain on the blocked tier.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 33, 48])
def test_spatial_slab_shape(n):
    shape = blk.slab_shape(fik.spatial_family(n, 0.4))
    assert shape == blk.spatial_slab_shape(n) == blk.SlabShape(n, 1, 3, n - 1, n - 1, 8 * n)
    assert blk._CUDA_FAMILY_IDS == {"planar": 0, "spatial": 1}


def test_spatial_entry_point_past_d32_is_the_blocked_tier():
    data, x0 = spatial_instances(5, 33, seed=2)
    kw = dict(max_iterations=2, qp_iterations=1, ls_iterations=1, return_state=True, device="cpu")
    via = port.fused_spatial_ik_solve_batch(data, x0, **kw)
    direct = port.blocked_solve_batch(fik.spatial_family(33, 0.4), data, x0, **kw)
    for v, d in zip(via, direct):
        assert torch.equal(v, d)


def _spatial_arm(B, n, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.3, 1.2, (B, n))
    th[:, 0] = rng.uniform(-0.3, 0.3, B)
    return spatial_fk(th) + rng.uniform(-0.05, 0.05, (B, 3)), th


@pytest.mark.parametrize("n", [4, 5, 6, 7, 8])
def test_blocked_spatial_agrees_with_the_register_tier(n):
    data, x0 = _spatial_arm(12, n, seed=n)
    family = fik.spatial_family(n, 0.4)
    d, x = torch.tensor(data), torch.tensor(x0)
    budget = (6, 3, 2, "armijo", "mpc")
    xb, sb = blk._blocked_solve_plain(family, d.T, x.T, *budget)
    xr, sr, _ = fik._fused_solve_plain(family, d.T, x.T, *budget, False)
    np.testing.assert_allclose(xb.numpy(), xr.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(sb[:2].numpy(), sr[:2].numpy(), rtol=0, atol=5e-5)
    np.testing.assert_array_equal(sb[2].numpy(), sr[2].numpy())


# ---------------------------------------------------------------------------
# Kernel 7's run-time route.
# ---------------------------------------------------------------------------

TOPO_I = tuple((a, b) for a in range(0, 57, 8) for b in range(0, 57, 8) if b - a >= 16)
TOPO_II = tuple((8 * j, 8 * j + 8) for j in range(11))


def _k_borders(k):
    """N = 3k + 2 poses, border poses 2, 5, 8, ..., joined in pairs (the
    last to the first when k is odd): k = len(borders), no closure along a
    chain edge."""
    borders = [2 + 3 * j for j in range(k)]
    closures = [(borders[j], borders[j + 1]) for j in range(0, k - 1, 2)]
    if k % 2:
        closures.append((borders[-1], borders[0]))
    return 3 * k + 2, tuple(closures)


@pytest.mark.parametrize(
    "closures,k",
    [(((12, 4),), 0), (((15, 0), (4, 11)), 0), (((0, 4), (6, 9), (11, 15)), 0), (_k_borders(7)[1], 7),
     (TOPO_I, 8), (TOPO_II, 12), (((0, 5), (5, 0)) * 9, 0), (((0, 5), (2, 8)) * 9, 4)],
    ids=["one", "k4", "k6", "k7", "topology_i", "topology_ii", "18_closures_k2", "18_closures_k4"])
def test_table_route_choice(closures, k):
    """The template route up to 16 closures and 6 border poses, the run-time
    route (reporting k) past either."""
    if len(closures) > pr.TEMPLATE_MAX_CLOSURES:
        k = len({p for c in closures for p in c})
    assert pr.table_route(closures) == k


@pytest.mark.parametrize("n,closures", [(64, TOPO_I), (96, TOPO_II), _k_borders(9), (40, ((0, 20), (39, 2), (30, 10)))],
                         ids=["topology_i", "topology_ii", "k9", "k6_unordered"])
def test_ring_schedule_is_the_plain_versions(n, closures):
    k, n_seg, table = pr.ring_schedule(n, closures)
    borders = sorted({p for c in closures for p in c})
    assert k == len(borders)
    runs, cur = [], []
    for p in range(n):
        if p in borders:
            if cur:
                runs.append((cur[0], cur[-1]))
            cur = []
        else:
            cur.append(p)
    if cur:
        runs.append((cur[0], cur[-1]))
    n_cl = len(closures)
    assert n_seg == len(runs)
    assert table[:n_cl] == [c[0] for c in closures] and table[n_cl:2 * n_cl] == [c[1] for c in closures]
    assert table[2 * n_cl:2 * n_cl + k] == borders
    assert list(zip(table[2 * n_cl + k:2 * n_cl + k + n_seg], table[2 * n_cl + k + n_seg:])) == runs


@pytest.mark.parametrize("k", [2, 8, 12, 24])
def test_table_layout_adds_the_schur_area(k):
    for n, n_cl in ((64, 21), (96, 11)):
        extra = pr.layout_slots(n, n_cl, k) - pr.layout_slots(n, n_cl)
        assert extra == -(-9 * k * k // 4) * 4 + 2 * (-(-3 * k // 4) * 4)
        plan = pr.launch_plan(n, n_cl, 8192, torch.float32, k)
        assert plan.slots == pr.layout_slots(n, n_cl, k)
        assert plan.storage == "shared" and plan.warps == pr.WARPS_PER_CTA


def _general(it, ls):
    return NLSParams(
        max_iterations=it, max_qp_iterations=1, max_line_search_iterations=ls,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
        record_history=False, early_exit=False, kkt_solver="ldlt",
    )


@pytest.mark.parametrize("k", range(7, 13))
def test_table_route_solve_equals_nls_solve(k):
    n, closures = _k_borders(k)
    assert pr.table_route(closures) == k
    fam = pr.pose_ring_family(n, closures=closures)
    edges = chain_edges(n, closures)
    data, x0 = (torch.tensor(a) for a in chain_closure_instances(4, n, closures, seed=k))
    xk = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=2, ls_iterations=1)

    def problem(d):
        return pg.make_pose_graph_problem(
            n, edges, d.reshape(len(edges), 3), torch.ones(len(edges), dtype=d.dtype), anchor_weight=100.0
        )

    r = nls_solve(problem, _general(2, 1), x0, data=data)
    np.testing.assert_allclose(xk.numpy(), r.x.numpy(), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# On a card: every new route against its plain version, bit for bit.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the new routes are CUDA kernels with no CPU mode",
)

CARD_CASES = {
    "k1-planar1-f64": ("k1", "planar", 1, torch.float64),
    "k1-spatial9-f32": ("k1", "spatial", 9, torch.float32),
    "k1-planar31-f32": ("k1", "planar", 31, torch.float32),
    "k1-spatial31-f64": ("k1", "spatial", 31, torch.float64),
    "k2-spatial33-f64": ("k2", "spatial", 33, torch.float64),
    "k2-global-planar200-f32": ("k2", "planar", 200, torch.float32),
    "k2-global-planar162-f64": ("k2", "planar", 162, torch.float64),
    "k7-topology_i-f64": ("k7", "i", 64, torch.float64),
    "k7-topology_ii-f32": ("k7", "ii", 96, torch.float32),
}


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g, 7.0), torch.nan_to_num(w, 7.0))
        assert torch.equal(g.isnan(), w.isnan())


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_new_route_bit_identical_on_card(case):
    kernel, kind, n, dtype = CARD_CASES[case]
    if kernel == "k1":
        make = spatial_instances if kind == "spatial" else None
        data, x0 = make(67, n, seed=n) if make else port.instances.planar_instances(67, n, seed=n)
        data[5, 0] = np.nan
        family = (fik.spatial_family if kind == "spatial" else fik.planar_family)(n, 0.4)
        d, x = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (data, x0))
        args = (family, d, x, 4, 2, 1, "armijo", "mpc", False)
        _same(fik._fused_solve_cuda(*args)[:2], fik._fused_solve_plain_batch(*args)[:2])
    elif kernel == "k2":
        data, x0 = _spatial_arm(67, n, seed=n) if kind == "spatial" else medium_n_planar_instances(67, n, seed=n)
        data[5, 0] = np.nan
        family = (fik.spatial_family if kind == "spatial" else fik.planar_family)(n, 0.4)
        d_t, x_t = port.batch_from_numpy(data, x0, "cuda", dtype)
        args = (family, d_t, x_t, 2, 1, 1, "armijo", "mpc")
        _same(blk._blocked_solve_cuda(*args), blk._blocked_solve_plain(*args))
    else:
        closures = TOPO_I if kind == "i" else TOPO_II
        fam = pr.pose_ring_family(n, closures=closures)
        data, x0 = chain_closure_instances(67, n, closures, seed=n)
        data[5, 4] = np.nan
        d_t, x_t = port.batch_from_numpy(data, x0, "cuda", dtype)
        _same(pr._pose_ring_cuda(fam, d_t, x_t, 6, 2), pr._pose_ring_plain(fam, d_t, x_t, 6, 2))
