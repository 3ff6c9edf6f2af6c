"""SE(2) pose graphs through the generated family, without JAX: the port's
``scalar_pose_graph_builder`` -> ``family_from_problem`` -> ``fused_solve_batch``
on the register tier (N = 4, D = 12) and the blocked tier (N >= 11, D > 32),
and the emitter's blocked target, on the CPU (float64 unless a case says
otherwise); marked ``cuda``, the generated kernel 2 instance against its
plain version on a card.

Tolerances:

* The blocked target's computation (``FamilyProgram.run_blocked``: each
  residual block's traced program run statement by statement, then the
  scatter in the kernel's order) equals the family's plain ``linearize`` /
  ``errors`` bit for bit, NaN lanes included, in both types: it is the same
  arithmetic in the same order.
* The blocked functor's assembly, which writes only the blocks' cells (the
  ``g_pattern`` hints), equals the dense J^T J and J^T r of the whole
  residual vector's Jacobian (every column, zeros included, every row summed
  in order) bit for bit: the cells outside the hints are exact zeros, and a
  zero term leaves a sum's bits alone.
* The register route at N = 4 (6/1/2, Mehrotra + Armijo) and the blocked
  route at N = 16 (5/1/2) against ``nls_solve`` on the same builder at the
  matched fixed-trip budget: x within 1e-8 of the scale 1 + max|x| (JAX's
  tests/test_pallas_blocked.py:255-324; measured 9e-16 at N = 16); the
  register route's line search and QP are the blocked tier's, so the same
  bound holds there.
* Kernel 2's launch plan for a generated family counts its slab exactly as
  csrc/blocked_sqp.cuh's ``carve`` takes it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges, ring_instances
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.nonlinear import NLSParams, nls_solve
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_emit
from mini_opt_tpu_torch.residual import BlockResidual
from mini_opt_tpu_torch.structs import BarrierStrategy, LineSearchStrategy

DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]

# (N, closures): the blocked tier's smallest width (D = 33), the 16-pose
# chain-plus-closure cell (D = 48), the hints' test graph (D = 36) and the
# widest cell (D = 120, 4 rows a lane).
GRAPHS = {11: ((2, 8),), 12: ((2, 9),), 16: ((4, 12),), 40: ((5, 34), (12, 27))}
_CACHE = {}


def family(N):
    """(family, builder, edges) of the N-pose graph; the ring at N = 4."""
    if N not in _CACHE:
        edges = pg.ring_edges(4) if N == 4 else chain_edges(N, GRAPHS[N])
        builder = pg.scalar_pose_graph_builder(N, edges)
        _CACHE[N] = (port.family_from_problem(builder, 3 * len(edges)), builder, edges)
    return _CACHE[N]


def instances(N, B, seed, **kw):
    """Noisy odometry around a wandering trajectory (JAX's
    _pose_graph_instances, tests/test_pallas_blocked.py:327-351, by default),
    or the N-gon ring at N = 4."""
    if N == 4:
        return ring_instances(B, 4, seed=seed)
    kw = {"start_noise": 0.1, "meas_noise": 0.03, **kw}
    return chain_closure_instances(B, N, GRAPHS[N], seed=seed, **kw)


def _bit_equal(a, b):
    return a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _regs(N, dtype, B=29, seed=1):
    fam, _, _ = family(N)
    data, x0 = instances(N, B, seed)
    data[4, 0] = np.nan
    x0[6, 5] = np.nan
    x0[8] *= 3.0  # headings past +-pi
    return ([torch.as_tensor(x0[:, i], dtype=dtype) for i in range(fam.n)],
            [torch.as_tensor(data[:, i], dtype=dtype) for i in range(fam.data_rows)])


@pytest.mark.parametrize("fn", ["linearize", "errors"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N", [11, 16])
def test_blocked_program_reproduces_plain_callables(N, dtype, fn):
    fam, _, _ = family(N)
    x, d = _regs(N, dtype)
    want = (fam.linearize if fn == "linearize" else fam.errors)(x, d)
    got = fam.cuda_program.run_blocked(dtype, fn, x, d)
    if fn == "errors":
        assert all(_bit_equal(g, w) for g, w in zip(got, want))
        return
    (f, r_eq, J_eq, G, c), (f2, r_eq2, J_eq2, G2, c2) = want, got
    assert _bit_equal(f2, f) and len(r_eq2) == len(r_eq) == 0 and len(J_eq2) == len(J_eq) == 0
    assert all(_bit_equal(G2[i][j], G[i][j]) for i in range(fam.n) for j in range(i + 1))
    assert all(_bit_equal(a, b) for a, b in zip(c2, c))


def _blocked_writes(fam):
    """The packed-Hessian cells (i, j), j <= i, and the (row, variable)
    cells of J_eq that the blocked functor sums into: the cells of its
    residual groups' blocks (csrc/blocked_launch.cuh scatter_cost /
    scatter_eq)."""
    g_cells, eq_cells, row = set(), set(), 0
    for group in fam.cuda_program._blocks.groups:
        for idx in group.indices:
            if group.role == "cost":
                g_cells.update((max(a, b), min(a, b)) for a in idx for b in idx)
            else:
                eq_cells.update((row + k, v) for k in range(group.dim) for v in idx)
                row += group.dim
    return frozenset(g_cells), frozenset(eq_cells)


@pytest.mark.parametrize("N", [11, 16, 40])
def test_blocked_writes_are_the_sparsity_hints(N):
    fam, _, edges = family(N)
    g_cells, eq_cells = _blocked_writes(fam)
    assert g_cells == fam.g_pattern and eq_cells == frozenset() and fam.eq_patterns == ()
    # The edges' 6 x 6 blocks and the anchor's 3 x 3, overlapping on the
    # poses' own 3 x 3 blocks: far from the dense tri(3N).
    assert len(g_cells) < 3 * N * (3 * N + 1) // 2 // 2


def test_blocked_program_size_grows_with_groups_not_blocks():
    """The blocked target traces one block of each residual group: the
    16-pose and the 40-pose families' programs differ only in the payload
    reads they carry, and their scratch is one block's outputs per block."""
    sizes = {}
    for N in (16, 40):
        fam, _, edges = family(N)
        bp = fam.cuda_program.blocked_programs(torch.float64)
        assert len(bp.lin) == len(bp.err) == 2  # the edges, the anchor
        sizes[N] = [sum(s.op != "in" for s in p.stmts) for p in bp.lin]
        assert fam.cuda_program.blocked_scratch() == len(edges) * 3 * 7 + 3 * 4
        # Each edge's data row: its three measurements, then three unit weights.
        assert bp.data_src[0][1] == ((3, 0.0), (4, 0.0), (5, 0.0), (-1, 1.0), (-1, 1.0), (-1, 1.0))
    assert sizes[16] == sizes[40]


def test_emitted_blocked_source_declares_the_family():
    fam, _, _ = family(16)
    src = fam.cuda_program.blocked_source()
    for line in ("static constexpr int N = 48;", "static constexpr int M = 0;",
                 "static constexpr int ROWS = 48;", "static constexpr int NLO = 0;",
                 "static constexpr int NHI = 0;", "static constexpr int SCRATCH = 348;",
                 '#include "blocked_launch.cuh"', "mo::gen::scatter_cost<T, 6, 3>(lane, 16, kIx0",
                 "mo::gen::scatter_cost<T, 3, 3>(lane, 1, kIx1", 'extern "C" int mo_generated_blocked_launch('):
        assert line in src, line
    assert src == fam.cuda_program.blocked_source()
    assert port.family_from_problem(pg.scalar_pose_graph_builder(16, chain_edges(16, GRAPHS[16])),
                                    48).cuda_program.blocked_source() == src


def _retracted(headings_only=False):
    """The 11-pose family with a per-variable wrap, which kernel 2 takes
    variable by variable: every variable, or the headings alone (the
    general path's ``pose_graph_retraction``)."""
    edges = chain_edges(11, GRAPHS[11])
    return port.family_from_problem(
        pg.scalar_pose_graph_builder(11, edges), 3 * len(edges),
        retract=lambda th: [pg._wrap(t) if k % 3 == 2 or not headings_only else t for k, t in enumerate(th)])


def _mixing_retract():
    """A retract whose output 0 reads variable 1: no lane holds both."""
    edges = chain_edges(11, GRAPHS[11])
    return port.family_from_problem(pg.scalar_pose_graph_builder(11, edges), 3 * len(edges),
                                    retract=lambda th: [th[0] + th[1]] + [pg._wrap(t) for t in th[1:]])


def _repeated():
    def builder(data):
        return port.Problem(dimension=33, costs=(port.make_residual(
            [0, 0] + list(range(1, 33)), lambda p: torch.stack([p[i] * p[1] - data[0] for i in range(34)]), 34),))

    return port.family_from_problem(builder, 1)


def _computed_data():
    def builder(data):
        rows = torch.stack([torch.stack([data[0] * data[1]]) for _ in range(33)])
        return port.Problem(dimension=33, costs=(port.BlockResidual(
            fn=lambda xl, row: torch.stack([xl[0] - row[0]]), indices=tuple((i,) for i in range(33)), dim=1,
            data=rows),))

    return port.family_from_problem(builder, 2)


REFUSED = {"retract": (_mixing_retract, "output 0 reads variable 1"), "repeated": (_repeated, "reads a variable twice"),
           "computed_data": (_computed_data, "computed from the payload")}


@pytest.mark.parametrize("case", list(REFUSED))
def test_blocked_target_refuses_what_it_cannot_split(case):
    make, match = REFUSED[case]
    with pytest.raises(fused_emit.UnsupportedOp, match=match):
        make().cuda_program.blocked_source()


def test_blocked_target_takes_a_per_variable_retract():
    """The per-pose wrap, once refused, is emitted (retract(i, a) per type:
    one program for every variable, or a switch between the heading's wrap
    and the identity) and runs through the plain blocked path, every
    accepted candidate's headings wrapped."""
    src = _retracted().cuda_program.blocked_source()
    assert "__device__ __forceinline__ float retract(int, float a) const {" in src
    assert "__device__ __forceinline__ double retract(int, double a) const {" in src
    fam = _retracted(headings_only=True)
    src = fam.cuda_program.blocked_source()
    assert "double retract(int i, double a) const {" in src and "switch (kWhich[i])" in src
    data, x0 = chain_closure_instances(5, 11, GRAPHS[11], seed=3)
    x = port.blocked_solve_batch(fam, torch.tensor(data), torch.tensor(x0), max_iterations=4, qp_iterations=1,
                                 ls_iterations=2)
    assert torch.isfinite(x).all() and (x != torch.tensor(x0)).any(1).all()
    assert (x[:, 2::3].abs() <= np.pi + 1e-12).all()


def _dense_assembly(builder, x, d):
    """G (lower triangle by rows) and c of the dense assembly: the whole
    residual vector's Jacobian, every one of its n columns by a jvp (the
    zeros of the cells no block touches included), then J^T J and J^T r
    summed over every residual row in order."""
    n = len(x)
    problem = builder(torch.stack(d))

    def residuals(xs):
        out = []
        for res in problem.costs:
            if isinstance(res, BlockResidual):
                out += [res.fn(torch.stack([xs[i] for i in idx]), res.data[b]) for b, idx in enumerate(res.indices)]
            else:
                out.append(res.fn(torch.stack([xs[i] for i in res.index])))
        return torch.cat(out)

    xs = torch.stack(x)
    one, zero = torch.ones_like(x[0]), torch.zeros_like(x[0])
    J = []
    for a in range(n):
        r, dr = torch.func.jvp(residuals, (xs,), (torch.stack([one if i == a else zero for i in range(n)]),))
        J.append(dr.to(xs.dtype))
    G = [[zero] * (i + 1) for i in range(n)]
    c = [zero] * n
    for i in range(n):
        for j in range(i + 1):
            for k in range(r.shape[0]):
                G[i][j] = G[i][j] + J[i][k] * J[j][k]
        for k in range(r.shape[0]):
            c[i] = c[i] + J[i][k] * r[k]
    return G, c


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N", [11, 12])
def test_sparse_assembly_matches_dense_bitexact(N, dtype):
    """The port's counterpart of test_sparse_assembly_matches_dense_bitexact
    (tests/test_pallas_blocked.py:354-380): the blocked functor's assembly,
    which writes only the blocks' cells (the hints), against the dense
    J^T J and J^T r, on instances without NaN (a NaN turns the dense
    assembly's zero products into NaN)."""
    fam, builder, _ = family(N)
    data, x0 = instances(N, 29, seed=11)
    x0[8] *= 3.0  # headings past +-pi
    x = [torch.as_tensor(x0[:, i], dtype=dtype) for i in range(fam.n)]
    d = [torch.as_tensor(data[:, i], dtype=dtype) for i in range(fam.data_rows)]
    _, _, _, G, c = fam.cuda_program.run_blocked(dtype, "linearize", x, d)
    G_dense, c_dense = _dense_assembly(builder, x, d)
    assert all(_bit_equal(G[i][j], G_dense[i][j]) for i in range(fam.n) for j in range(i + 1))
    assert all(_bit_equal(a, b) for a, b in zip(c, c_dense))
    # Outside the hints the dense assembly holds exact zeros (inside them
    # some cells cancel to zero too: an edge's -c s + s c at (y_j, x_i)).
    filled = {(i, j) for i in range(fam.n) for j in range(i + 1) if bool((G_dense[i][j] != 0).any())}
    assert filled <= fam.g_pattern and len(filled) > len(fam.g_pattern) // 2


def _params(iters, ls):
    """nls_solve at the fused kernel's fixed trip counts and constants."""
    return NLSParams(
        max_iterations=iters, max_qp_iterations=1, max_line_search_iterations=ls,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
        equality_penalty_initial=0.01, lambda_initial=0.001, lambda_failure_init=0.001, min_lambda=1e-9,
        termination_kkt_tolerance=1e-14, absolute_exit_tol=1e-30, relative_exit_tol=0.0,
        absolute_first_derivative_tol=0.0, early_exit=False, kkt_solver="ldlt",
        qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR,
    )


@pytest.mark.parametrize("N, budget", [(4, (6, 1, 2)), (16, (5, 1, 2))], ids=["register-N4", "blocked-N16"])
def test_fused_route_matches_nls_solve(N, budget):
    fam, builder, _ = family(N)
    B = 6 if N == 4 else 4
    data, x0 = instances(N, B, seed=7)
    d, x = torch.tensor(data), torch.tensor(x0)
    iters, qp, ls = budget
    blocked_before = blk.BLOCKED_LAUNCHES + blk.GENERATED_LAUNCHES
    xf, state = port.fused_solve_batch(fam, d, x, max_iterations=iters, qp_iterations=qp, ls_iterations=ls,
                                       barrier="mpc", return_state=True)
    assert blk.BLOCKED_LAUNCHES + blk.GENERATED_LAUNCHES == blocked_before  # CPU: the plain version
    res = nls_solve(builder, _params(iters, ls), x, data=d)
    scale = 1.0 + float(res.x.abs().max())
    assert float((xf - res.x).abs().max()) / scale < 1e-8
    torch.testing.assert_close(state[:, 0], res.errors.f, rtol=1e-8, atol=1e-12)
    assert (state[:, 2] == 0).all()
    if N == 16:
        assert (state[:, 0] < 2e-3 * N).all()  # converged to the noise floor


def test_no_bound_no_equality_plain_paths():
    """M = 0 and no bound: the QP is the equality-free Newton step whatever
    its iteration budget (both plain versions return right after the first
    solve), |eq|_1 stays 0, and the register and blocked tiers agree."""
    fam, _, _ = family(4)
    data, x0 = instances(4, 9, seed=2)
    d, x = torch.tensor(data), torch.tensor(x0)
    kw = dict(max_iterations=4, ls_iterations=2, return_state=True)
    reg1, st1 = port.fused_solve_batch(fam, d, x, qp_iterations=1, **kw)
    reg3, st3 = port.fused_solve_batch(fam, d, x, qp_iterations=3, **kw)
    blk1, bst1 = port.blocked_solve_batch(fam, d, x, qp_iterations=1, **kw)
    blk3, bst3 = port.blocked_solve_batch(fam, d, x, qp_iterations=3, barrier="complementarity", **kw)
    assert _bit_equal(reg1, reg3) and _bit_equal(st1, st3)
    assert _bit_equal(blk1, blk3) and _bit_equal(bst1, bst3)
    assert (bst1[:, 1] == 0).all() and (st1[:, 1] == 0).all()
    torch.testing.assert_close(blk1, reg1, rtol=0, atol=1e-12)


def test_nan_lane_is_flagged_and_the_others_do_not_see_it():
    """A NaN measurement leaves the Hessian finite (the residual's Jacobian
    does not read it), so no factor fails: the lane's line search fails
    every iteration, and after four the damping passes 1 (MAX_LAMBDA, flag
    2), the start returned."""
    fam, _, _ = family(11)
    data, x0 = instances(11, 5, seed=9)
    d, x = torch.tensor(data), torch.tensor(x0)
    kw = dict(max_iterations=4, qp_iterations=1, ls_iterations=1, return_state=True)
    d_nan = d.clone()
    d_nan[2, 4] = float("nan")
    xs, st = port.blocked_solve_batch(fam, d_nan, x, **kw)
    assert st[2, 2] == 2 and _bit_equal(xs[2], x[2]) and torch.isfinite(xs[[0, 1, 3, 4]]).all()
    alone, st_alone = port.blocked_solve_batch(fam, d[[0, 1, 3, 4]], x[[0, 1, 3, 4]], **kw)
    assert _bit_equal(xs[[0, 1, 3, 4]], alone) and _bit_equal(st[[0, 1, 3, 4]], st_alone)


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


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N", [4, 11, 16, 40])
def test_launch_plan_counts_the_generated_slab(N, dtype):
    fam, _, edges = family(N)
    shape = blk.slab_shape(fam)
    assert shape == blk.SlabShape(3 * N, 0, 3 * len(edges), 0, 0, fam.cuda_program.blocked_scratch())
    plan = blk.launch_plan(shape, 8192, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    assert plan.slots == _carve_count(shape, dtype)
    assert plan.warp_bytes % 16 == 0 and 0 <= plan.warp_bytes - plan.slots * size < 16
    assert plan.rows_per_lane == blk.rows_per_lane(3 * N)
    assert plan.warps == min(blk.WARPS_PER_CTA, blk.MAX_CTA_SMEM // plan.warp_bytes)
    assert plan.grid == -(-8192 // plan.warps)
    # The hand-written planar chain's slab counts the same way.
    planar = blk.planar_slab_shape(fam.n)
    assert blk.slab_slots(planar, dtype) == _carve_count(planar, dtype)


def test_launch_plan_raises_past_the_kernel():
    # Past D = 192 the global route takes a family, up to D = 256.
    assert blk.launch_plan(blk.SlabShape(193, 0, 1, 0, 0, 0), 1, torch.float32).storage == "global"
    wide = blk.SlabShape(257, 0, 1, 0, 0, 0)
    with pytest.raises(ValueError, match="global route's 256 rows"):
        blk.launch_plan(wide, 1, torch.float32)


@pytest.fixture
def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernel 2 instance has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("batch", ["one", "ragged", "full"])
def test_generated_kernel_2_bit_identical_to_plain_on_card(needs_cuda, batch, dtype):
    """The 16-pose family's kernel 2 instance at one instance, a ragged last
    CTA (W + 1) and 8192 + 13 with a NaN-measurement lane: bit for bit, the
    NaN lane flagged; one launch on the generated counter."""
    fam, _, _ = family(16)
    W = blk.launch_plan(blk.slab_shape(fam), 1, dtype).warps
    B = {"one": 1, "ragged": W + 1, "full": 8192 + 13}[batch]
    data, x0 = chain_closure_instances(B, 16, GRAPHS[16], seed=3)
    if B > 5:
        data[5, 0] = np.nan
    d = torch.as_tensor(data, dtype=dtype, device="cuda")
    x = torch.as_tensor(x0, dtype=dtype, device="cuda")
    args = (fam, d.T, x.T, 5, 1, 2, "armijo", "mpc")
    before = blk.GENERATED_LAUNCHES
    got = blk._blocked_solve_cuda(*args)
    torch.cuda.synchronize()
    assert blk.GENERATED_LAUNCHES == before + 1
    want = blk._blocked_solve_plain(*args)
    for g, w in zip(got, want):
        assert _bit_equal(g, w)
    if B > 5:
        assert got[1][2, 5] != 0
