"""Generated families of the PyTorch port without JAX: the emitter's
programs, the emitted source, the sparsity hints and their validator, the
serving wrappers and the IK builders, on the CPU; and, marked ``cuda``,
the generated kernel against its plain version on a card.

* The emitter (``ops/fused_emit.py``) traces a family's plain ``linearize``
  / ``errors`` / ``retract`` into a program of scalar statements;
  ``run_program`` runs it one torch operation a statement, and on the CPU
  it must reproduce the plain callables bit for bit, NaN lanes included, in
  float32 and float64, for bench.py's planar family, the spatial chain
  builder, the BlockResidual chain and the robustified line fit (no
  equality row, no bound). A float32 program holds no float64 value.
* The generated planar family against the hand-written ``planar_family``:
  not bit for bit (the builder bounds joints at 3.14159265, not
  3.14159265358979, and sums the effector link by link), so within 1e-12
  at the bench budget and 1e-6 at 10/6/2 complementarity, where the
  barrier on the upper bound moves x by up to 6.1e-8 (measured on these
  seeds).
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import (
    block_chain_instances,
    block_chain_problem,
    effector_error,
    planar_instances,
    robust_line_fit_instances,
    robust_line_fit_problem,
    spatial_instances,
)
from mini_opt_tpu_torch.models import ik as pik
from mini_opt_tpu_torch.models.chains import compute_all_poses
from mini_opt_tpu_torch.ops import _build
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_auto, fused_emit
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops._common import _mod_pi
from mini_opt_tpu_torch.structs import BarrierStrategy, LineSearchStrategy

BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")
B = 37


def _wrap(th):
    return [_mod_pi(t) for t in th]


def _make(name):
    """(family, instances(B, seed)) of the test families."""
    if name == "planar2":
        return (port.family_from_problem(pik.scalar_planar_ik_builder(2), 2, retract=_wrap),
                lambda b, seed: planar_instances(b, 2, seed=seed))
    if name == "spatial3_chain":
        chain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
        return (port.family_from_problem(port.scalar_chain_ik_builder(chain, target_dim=3), 3, retract=_wrap),
                lambda b, seed: spatial_instances(b, 3, seed=seed))
    if name == "block_chain":
        return port.family_from_problem(block_chain_problem, 6), block_chain_instances
    return port.family_from_problem(robust_line_fit_problem, 4), robust_line_fit_instances


FAMILIES = ["planar2", "spatial3_chain", "block_chain", "robust_fit"]
_CACHE = {}


def family(name):
    if name not in _CACHE:
        _CACHE[name] = _make(name)
    return _CACHE[name]


def _inputs(name, dtype, seed=1):
    fam, instances = family(name)
    data, x0 = instances(B, seed)
    data[3, 0] = np.nan
    x0[5, 1] = np.nan
    x0[7] *= 3.0  # some angles past +-pi, for the retraction
    return [torch.as_tensor(data[:, i], dtype=dtype) for i in range(fam.data_rows)], [
        torch.as_tensor(x0[:, i], dtype=dtype) for i in range(fam.n)]


def _bit_equal(a, b):
    return a.dtype == b.dtype and bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("fn", ["linearize", "errors", "retract"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", FAMILIES)
def test_program_reproduces_plain_callables(name, dtype, fn):
    fam, _ = family(name)
    prog = fam.cuda_program.programs(dtype)[fn]
    d, x = _inputs(name, dtype)
    if fn == "retract":
        if fam.retract is None:
            assert prog is None
            return
        want, got = fam.cuda_program._flat_retract(*x), fused_emit.run_program(prog, x)
    elif fn == "errors":
        want, got = fam.cuda_program._flat_errors(*x, *d), fused_emit.run_program(prog, x + d)
    else:
        want, got = fam.cuda_program._flat_linearize(*x, *d), fused_emit.run_program(prog, x + d)
    assert len(got) == len(want)
    assert all(_bit_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", FAMILIES)
def test_float32_program_holds_no_float64(name):
    fam, _ = family(name)
    for fn, prog in fam.cuda_program.programs(torch.float32).items():
        if prog is None:
            continue
        kinds = {s.dtype for s in prog.stmts}
        kinds |= {a.dtype for s in prog.stmts for a in s.args if isinstance(a, fused_emit.Const)}
        assert kinds <= {torch.float32, torch.bool}, (fn, kinds)


EXPECTED = {
    # N, M, ROWS, NLO, NHI, lo_var / hi_var chains
    "planar2": (2, 1, 2, 1, 1, "j == 0 ? 1 : 0", "j == 0 ? 1 : 0"),
    "spatial3_chain": (3, 1, 3, 2, 2, "j == 0 ? 1 : j == 1 ? 2 : 0", "j == 0 ? 1 : j == 1 ? 2 : 0"),
    "block_chain": (4, 2, 6, 1, 0, "j == 0 ? 0 : 0", "0"),
    "robust_fit": (2, 0, 4, 0, 0, "0", "0"),
}


@pytest.mark.parametrize("name", FAMILIES)
def test_emitted_source_declares_the_family(name):
    fam, _ = family(name)
    src = fam.cuda_program.source()
    n, m, rows, nlo, nhi, lo_var, hi_var = EXPECTED[name]
    for key, value in (("N", n), ("M", m), ("ROWS", rows), ("NLO", nlo), ("NHI", nhi)):
        assert f"static constexpr int {key} = {value};" in src
    assert f"int lo_var(int j) {{ return {lo_var}; }}" in src
    assert f"int hi_var(int j) {{ return {hi_var}; }}" in src
    assert src.count("void linearize(const float") == 1 and src.count("void linearize(const double") == 1
    assert '#include "fused_ik_launch.cuh"' in src and 'extern "C" int mo_generated_launch' in src
    if name in ("planar2", "spatial3_chain"):
        # The bounds exactly, as C99 hex floats: 0 and the literal 3.14159265.
        assert f"return j == 0 ? {(0.0).hex()} : " in src
        assert (3.14159265).hex() in src
        # The link length 0.4 rounded to float in the float program, exact
        # in the double one.
        assert float(np.float32(0.4)).hex() + "f" in src and (0.4).hex() in src


def test_same_family_same_source_and_library_name():
    a = family("planar2")[0]
    b = port.family_from_problem(pik.scalar_planar_ik_builder(2), 2, retract=_wrap)
    c = family("robust_fit")[0]
    sa, sb, sc = (f.cuda_program.source() for f in (a, b, c))
    assert sa == sb and sa != sc
    assert _build._generated_path(sa) == _build._generated_path(sb) != _build._generated_path(sc)
    assert _build._generated_path(sa).parent == _build.BUILD_DIR


def _one_cost_family(fn, dim=1):
    def builder(data):
        return port.Problem(dimension=2, costs=(port.make_residual([0, 1], lambda p: fn(p, data), dim),))

    return port.family_from_problem(builder, 1)


REFUSED = {
    "div_by_python_scalar": (lambda p, d: torch.stack([p[0] / 2.0 - d[0]]), "aten.div.Tensor by a Python scalar"),
    "sum_of_three_terms": (lambda p, d: torch.stack([torch.sum(torch.stack([p[0], p[1], d[0]]), 0)]),
                           "aten.sum of 3 terms"),
    "unknown_op": (lambda p, d: torch.stack([torch.erf(p[0]) - d[0]]), "aten.erf"),
    "pow_by_1_5": (lambda p, d: torch.stack([p[0] ** 1.5 - d[0]]), r"aten\.pow\.Tensor_Scalar has no C\+\+ form"),
    # An operation no family held on the card uses.
    "exp_not_held_on_card": (lambda p, d: torch.stack([torch.exp(p[0]) - d[0]]),
                             r"aten\.exp\.default has no C\+\+ form"),
    # Python that reads a traced value: fixed into the program by a trace on
    # real tensors, evaluated per call by the plain version.
    "item_of_a_value": (lambda p, d: torch.stack([p[0] * p[1].sum().item() - d[0]]), "hands a traced value"),
    "branch_on_values": (lambda p, d: torch.stack([p[0] - d[0] if bool((p[0] > 0).all()) else p[1]]),
                         "could not be traced without values"),
    "tolist": (lambda p, d: torch.stack([p[0] * d[0].reshape(-1).tolist()[0]]), "could not be traced without values"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_emitter_refuses_what_it_cannot_mirror(case):
    fn, match = REFUSED[case]
    fam = _one_cost_family(fn)
    with pytest.raises(fused_emit.UnsupportedOp, match=match):
        fam.cuda_program.programs(torch.float32)


def test_sparsity_hints():
    planar, _ = family("planar2")
    assert planar.g_pattern == frozenset({(0, 0), (1, 0), (1, 1)})
    assert planar.eq_patterns == (frozenset({0, 1}),)
    block, _ = family("block_chain")
    assert block.g_pattern == frozenset({(0, 0), (1, 0), (1, 1), (2, 1), (2, 2), (3, 2), (3, 3)})
    assert block.eq_patterns == (frozenset({0, 1}), frozenset({2, 3}))
    robust, _ = family("robust_fit")
    assert robust.eq_patterns == () and robust.m_eq == 0
    with pytest.raises(ValueError, match="eq_patterns"):
        dataclasses.replace(planar, eq_patterns=(frozenset({0}), frozenset({1})))


@pytest.mark.parametrize("name", FAMILIES)
def test_validator_accepts_generated_families(name):
    fam, instances = family(name)
    data, x0 = instances(8, 2)
    builder = {
        "planar2": pik.scalar_planar_ik_builder(2),
        "spatial3_chain": port.scalar_chain_ik_builder(port.make_spatial_chain(3, dtype=torch.float64,
                                                                               device="cpu"), target_dim=3),
        "block_chain": block_chain_problem,
        "robust_fit": robust_line_fit_problem,
    }[name]
    assert port.check_family_against_problem(fam, builder, data, x0) < 1e-12


def test_validator_rejects_unsound_hints_and_non_scalar_style():
    fam, _ = family("planar2")
    builder = pik.scalar_planar_ik_builder(2)
    rng = np.random.default_rng(5)
    data, x = rng.uniform(0.1, 0.7, (4, 2)), rng.uniform(-1.0, 2.0, (4, 2))
    with pytest.raises(AssertionError, match="g_pattern unsound"):
        port.check_family_against_problem(dataclasses.replace(fam, g_pattern=frozenset({(0, 0), (1, 1)})),
                                          builder, data, x)
    with pytest.raises(AssertionError, match=r"eq_patterns\[0\] unsound"):
        port.check_family_against_problem(dataclasses.replace(fam, eq_patterns=(frozenset({0}),)), builder, data, x)

    def bad_builder(d):
        return port.Problem(
            dimension=2, costs=(port.make_residual([0, 1], lambda p: torch.stack([torch.sum(p) - d[0]]), 1),))

    bad = port.family_from_problem(bad_builder, 1)
    with pytest.raises(Exception):
        port.check_family_against_problem(bad, bad_builder, rng.uniform(0.5, 1.0, (4, 1)),
                                          rng.uniform(-1.0, 1.0, (4, 2)))
    with pytest.raises(ValueError, match="1024"):
        port.check_family_against_problem(fam, builder, np.zeros((1025, 2)), np.zeros((1025, 2)))


def test_traced_index_block_residual_rejected():
    def builder(data):
        return port.Problem(dimension=2, costs=(
            port.BlockResidual(fn=lambda p, d: p, indices=torch.tensor([[0, 1]]), dim=2, data=None),))

    with pytest.raises(TypeError, match="STATIC"):
        port.family_from_problem(builder, 1)


@pytest.mark.parametrize("budget, tol", [
    (BENCH, 1e-12),
    (dict(max_iterations=10, qp_iterations=6, ls_iterations=2, barrier="complementarity",
          line_search="polynomial"), 1e-6),
], ids=["bench_4_2_1", "10_6_2_complementarity"])
def test_generated_planar_family_against_hand_written(budget, tol):
    fam, _ = family("planar2")
    data, x0 = planar_instances(128, 2, seed=0)
    xg, sg = port.fused_solve_batch(fam, data, x0, device="cpu", return_state=True, **budget)
    xh, sh = port.fused_ik_solve_batch(data, x0, device="cpu", return_state=True, **budget)
    dx = (xg - xh).abs()
    assert float(torch.minimum(dx, 2 * np.pi - dx).max()) < tol
    torch.testing.assert_close(sg[:, :2], sh[:, :2], rtol=0, atol=tol)
    assert torch.equal(sg[:, 2], sh[:, 2])


def test_cpu_tensors_run_the_plain_generated_family():
    fam, _ = family("planar2")
    data, x0 = planar_instances(16, 2, seed=2)
    before = (fik.KERNEL_LAUNCHES, fik.GENERATED_LAUNCHES)
    x = port.fused_solve_batch(fam, torch.as_tensor(data), torch.as_tensor(x0), **BENCH)
    assert (fik.KERNEL_LAUNCHES, fik.GENERATED_LAUNCHES) == before
    assert fam.cuda_program._lib is None  # nothing was built
    want = fik._fused_solve_plain(fam, torch.as_tensor(data.T.copy()), torch.as_tensor(x0.T.copy()),
                                  4, 2, 1, "armijo", "mpc", False)[0].T
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_generated_family_past_the_register_tier_runs_blocked_on_cpu():
    """A generated family past D = 32 goes to the blocked tier: its plain
    version on the CPU (on the card its own kernel 2 instance; see the cuda
    cases)."""
    n = 32

    def builder(data):
        return port.Problem(dimension=n, costs=(port.make_residual(
            list(range(n)), lambda p: torch.stack([p[i] - data[0] for i in range(n)]), n),),
            equality_constraints=(port.make_residual([0], lambda p: torch.stack([p[0] - data[0]]), 1),))

    fam = port.family_from_problem(builder, 1)
    assert fam.n + fam.m_eq > port.REGISTER_KKT_MAX
    data = np.full((3, 1), 0.5)
    x0 = np.zeros((3, n))
    kw = dict(max_iterations=2, qp_iterations=1, ls_iterations=1)
    before = blk.BLOCKED_LAUNCHES
    got = port.fused_solve_batch(fam, data, x0, device="cpu", **kw)
    want = port.blocked_solve_batch(fam, data, x0, device="cpu", **kw)
    assert blk.BLOCKED_LAUNCHES == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((got - 0.5).abs().max()) < 1e-6


def test_fused_nls_solve_batch_matches_the_family_and_checks_params():
    params = port.NLSParams(max_iterations=4, max_qp_iterations=2, max_line_search_iterations=1,
                            line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
                            qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR)
    builder = pik.scalar_planar_ik_builder(2)
    data, x0 = planar_instances(16, 2, seed=4)
    before = fused_auto._cached_family.cache_info().currsize
    x1 = port.fused_nls_solve_batch(builder, data, x0, params, device="cpu")
    x2 = port.fused_nls_solve_batch(builder, data, x0, params, device="cpu")
    info = fused_auto._cached_family.cache_info()
    assert info.currsize == before + 1 and info.hits >= 1
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    direct = port.fused_solve_batch(port.family_from_problem(builder, 2), data, x0, device="cpu", **BENCH)
    torch.testing.assert_close(x1, direct, rtol=0, atol=0)
    with pytest.raises(ValueError, match="tau"):
        port.fused_nls_solve_batch(builder, data, x0, dataclasses.replace(params, armijo_search_tau=0.8),
                                   device="cpu")
    with pytest.raises(ValueError, match="barrier"):
        port.fused_nls_solve_batch(builder, data, x0, dataclasses.replace(
            params, qp_barrier_strategy=BarrierStrategy.FIXED_DECREASE), device="cpu")


def test_serving_wrappers_check_their_arguments():
    fam, _ = family("planar2")
    data, x0 = planar_instances(8, 2, seed=0)
    for reserved in ("return_state", "debug_history"):
        with pytest.raises(ValueError, match=reserved):
            port.fused_solve_refined(fam, data, x0, lambda d, x: x, device="cpu", **{reserved: True})
    with pytest.raises(ValueError, match="debug_history"):
        port.fused_solve_proximal(fam, data, x0, device="cpu", debug_history=True)
    with pytest.raises(ValueError, match=r"\(B, S, 2\)"):
        port.fused_solve_multi_start(fam, data, x0[:, None, :1], device="cpu")
    with pytest.raises(ValueError, match="solutions only"):
        port.fused_solve_multi_start(fam, data, x0[:, None], device="cpu", return_state=True)
    with pytest.raises(ValueError, match="target_dim"):
        port.scalar_chain_ik_builder(port.make_spatial_chain(3, device="cpu"), target_dim=4)
    builder = port.scalar_chain_ik_builder(port.make_spatial_chain(3, device="cpu"), target_dim=3, prox_weight=0.1)
    with pytest.raises(ValueError, match="6 data rows"):
        builder(torch.zeros(3))


def test_multi_start_keeps_the_best_start():
    fam, _ = family("planar2")
    data, x0 = planar_instances(12, 2, seed=6)
    bad = x0 + np.array([2.5, -2.0])  # a far start
    x0s = np.stack([bad, x0], axis=1)  # (B, 2 starts, n)
    x = port.fused_solve_multi_start(fam, data, x0s, device="cpu", **BENCH)
    each = [port.fused_solve_batch(fam, data, x0s[:, s], device="cpu", **BENCH) for s in range(2)]
    merit = []
    for xs in each:
        f, eq = fam.errors([xs[:, i] for i in range(2)], [torch.as_tensor(data[:, i]) for i in range(2)])
        merit.append(f + eq)
    best = torch.argmin(torch.stack(merit, 1), 1)
    torch.testing.assert_close(x, torch.stack(each, 1)[torch.arange(12), best], rtol=0, atol=0)
    assert (effector_error("planar", x, data) < 1e-3).all()


def test_proximal_stages_and_refinement():
    chain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
    fam = port.family_from_problem(port.scalar_chain_ik_builder(chain, target_dim=3, prox_weight=0.05), 6)
    data, x0 = spatial_instances(16, 3, seed=1)
    kw = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc")
    x = port.fused_solve_proximal(fam, data, x0, stages=2, device="cpu", **kw)
    step = port.fused_solve_batch(fam, np.concatenate([data, x0], 1), x0, device="cpu", **kw)
    want = port.fused_solve_batch(fam, torch.cat([torch.as_tensor(data), step], 1), step, device="cpu", **kw)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    # Refinement: a refine_fn that returns the truth wins on every picked lane.
    fam0 = port.family_from_problem(port.scalar_chain_ik_builder(chain, target_dim=3), 3)
    rng = np.random.default_rng(0)
    truth = np.column_stack([rng.uniform(-1.2, 1.2, 16), rng.uniform(0.25, 2.6, (16, 2))])
    from mini_opt_tpu_torch.instances import spatial_fk

    targets = spatial_fk(truth)
    lookup = {tuple(np.round(t, 12)): xt for t, xt in zip(targets, truth)}

    def refine(d, x):
        return torch.as_tensor(np.stack([lookup[tuple(np.round(r, 12))] for r in d.numpy()]))

    start = truth + 0.3
    plain = port.fused_solve_batch(fam0, targets, start, device="cpu", max_iterations=1, qp_iterations=1,
                                   ls_iterations=0)
    refined = port.fused_solve_refined(fam0, targets, start, refine, refine_k=4, device="cpu",
                                       max_iterations=1, qp_iterations=1, ls_iterations=0)
    changed = (refined != plain).any(1)
    assert int(changed.sum()) == 4
    torch.testing.assert_close(refined[changed], torch.as_tensor(truth)[changed], rtol=0, atol=0)


def test_scalar_chain_fk_matches_chain_update():
    """scalar_chain_fk against ActuatorChain.update for arbitrary masks:
    multi-axis euler actuators, prismatic joints, fixed links with rotated
    base poses."""
    from mini_opt_tpu_torch.models.chains import ActuatorChain, ActuatorLink, Pose
    from mini_opt_tpu_torch.utils import so3

    masks = [(0, 0, 1, 0, 0, 0), (1, 1, 0, 0, 0, 0), (0, 0, 0, 1, 0, 1), (0, 0, 0, 0, 0, 0), (1, 1, 1, 1, 1, 1)]
    rng = np.random.default_rng(0)
    links = []
    for mask in masks:
        q = so3.quat_exp(torch.as_tensor(rng.normal(0, 0.4, 3)))
        links.append(ActuatorLink.create(Pose(q, torch.as_tensor(rng.normal(0, 0.5, 3))), mask))
    chain = ActuatorChain(links=tuple(links))
    p = torch.as_tensor(rng.normal(0, 0.7, chain.total_active))
    st = chain.update(p)
    R, t = pik.scalar_chain_fk(chain, p)
    torch.testing.assert_close(torch.stack(t), st.translation, rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.stack([torch.stack([torch.as_tensor(v, dtype=p.dtype) for v in row])
                                            for row in R]), so3.quat_to_matrix(st.rotation), rtol=0, atol=1e-12)


def test_compute_all_poses_ends_at_the_effector():
    chain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
    p = torch.tensor([0.3, 1.1, -0.4], dtype=torch.float64)
    st = chain.update(p)
    poses = compute_all_poses(st.buffers)
    L = len(chain.links)
    assert poses.rotation.shape == (L + 1, 4) and poses.translation.shape == (L + 1, 3)
    torch.testing.assert_close(poses.translation[0], torch.zeros(3, dtype=torch.float64), rtol=0, atol=1e-12)
    torch.testing.assert_close(poses.translation[-1], st.translation, rtol=0, atol=1e-12)
    torch.testing.assert_close(poses.translation[1], torch.zeros(3, dtype=torch.float64), rtol=0, atol=1e-12)
    torch.testing.assert_close(poses.translation[2], torch.tensor([0.4 * np.cos(0.3), 0.4 * np.sin(0.3), 0.0],
                                                                  dtype=torch.float64), rtol=0, atol=1e-12)


def test_spatial_problems_and_multi_start_on_the_general_path():
    chain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
    data, x0 = spatial_instances(6, 3, seed=2)
    refine = pik.make_spatial_refine_fn(3, max_iterations=8, qp_iterations=6)
    x = refine(torch.as_tensor(data), torch.as_tensor(x0))
    assert x.shape == (6, 3) and x.dtype == torch.float64
    assert (effector_error("spatial", x, data) < 1e-6).all()
    W = 2
    offsets = torch.zeros(W, 3, dtype=torch.float64)
    targets = torch.as_tensor(data[:W], dtype=torch.float64)
    problem = pik.make_waypoint_ik_problem(chain, offsets, targets, torch.ones(W, dtype=torch.float64))
    assert problem.costs[0].num_blocks == W and problem.dimension == 3
    tg, starts = planar_instances(5, 2, seed=3)
    x0s = np.stack([starts, starts + 0.2, starts - 0.2], axis=1)
    res = port.solve_ik_multi_start(tg, x0s, device="cpu")
    assert res.x.shape == (5, 2)
    assert (effector_error("planar", res.x, tg) < 1e-3).all()


# ---------------------------------------------------------------------------
# On the card: the generated kernel against its plain version. The skip
# condition is a string, evaluated when each test is set up.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the generated kernel has no CPU mode",
)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", FAMILIES)
def test_generated_kernel_matches_plain_on_card(name, dtype):
    fam, instances = family(name)
    data, x0 = instances(300, 3)
    data[5, 0] = np.nan
    x0[9, 1] = np.nan
    d, x = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (data, x0))
    for budget, hist in (((4, 2, 1, "armijo", "mpc"), False), ((3, 2, 2, "polynomial", "complementarity"), True)):
        before = fik.GENERATED_LAUNCHES
        got = fik._fused_solve_cuda(fam, d, x, *budget, hist)
        torch.cuda.synchronize()
        assert fik.GENERATED_LAUNCHES == before + 1
        want = fik._fused_solve_plain_batch(fam, d, x, *budget, hist)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert _bit_equal(g, w)


@pytest.mark.cuda
@needs_cuda
def test_missing_device_code_raises_on_card():
    targets, x0 = planar_instances(8, 2)
    ref = fik.planar_family(2, 0.4)
    python_only = fik.FusedFamily(n=2, data_rows=2, m_eq=1, linearize=ref.linearize, errors=ref.errors,
                                  lower=ref.lower, upper=ref.upper, retract=ref.retract)
    with pytest.raises(NotImplementedError, match="cuda_program"):
        port.fused_solve_batch(python_only, targets, x0, **BENCH)
    n = 32

    def builder(data):
        return port.Problem(dimension=n, costs=(port.make_residual(
            list(range(n)), lambda p: torch.stack([p[i] - data[0] for i in range(n)]), n),),
            equality_constraints=(port.make_residual([0], lambda p: torch.stack([p[0] - data[0]]), 1),))

    big = port.family_from_problem(builder, 1)
    python_big = dataclasses.replace(big, cuda_program=None)
    hand, generated = blk.BLOCKED_LAUNCHES, blk.GENERATED_LAUNCHES
    with pytest.raises(NotImplementedError, match="cuda_program"):
        port.fused_solve_batch(python_big, np.full((4, 1), 0.5), np.zeros((4, n)), max_iterations=1)
    assert (blk.BLOCKED_LAUNCHES, blk.GENERATED_LAUNCHES) == (hand, generated)
    # Past the register tier a generated family runs its own kernel 2
    # instance (the emitter's blocked target), bit for bit as on the CPU.
    kw = dict(max_iterations=2, qp_iterations=1, ls_iterations=1)
    got = port.fused_solve_batch(big, np.full((4, 1), 0.5), np.zeros((4, n)), **kw)
    torch.cuda.synchronize()
    assert (blk.BLOCKED_LAUNCHES, blk.GENERATED_LAUNCHES) == (hand, generated + 1)
    want = port.fused_solve_batch(big, np.full((4, 1), 0.5), np.zeros((4, n)), device="cpu", **kw)
    assert _bit_equal(got.cpu(), want)
