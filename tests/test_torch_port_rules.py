"""Rules the PyTorch port keeps, and its kernel against its plain version on
a CUDA card.

The first group is cheap and runs anywhere: the port imports neither jax nor
the JAX package, numpy inputs never fall back to the CPU, the entry points
dispatch and validate as documented, and the CUDA sources are in the tree.

The tests marked ``cuda`` need a card and skip without one. They repeat
chip_smoke.py's kernel-vs-plain comparisons at small B. On a CUDA machine,
where jax may be missing (tests/conftest.py imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_port_rules.py
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import (
    effector_error,
    medium_n_planar_instances,
    planar_instances,
    spatial_instances,
)
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.ops import ldlt

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mini_opt_tpu")
BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_out():
    code = (
        "import sys, mini_opt_tpu_torch, mini_opt_tpu_torch.instances, "
        "mini_opt_tpu_torch.utils.numerical, mini_opt_tpu_torch.utils.tol, "
        "mini_opt_tpu_torch.ops.pose_ring, mini_opt_tpu_torch.models.pose_graph, "
        "mini_opt_tpu_torch.ops.mpc, mini_opt_tpu_torch.ops.riccati, mini_opt_tpu_torch.models.mpc, "
        "mini_opt_tpu_torch.ineq, mini_opt_tpu_torch.implicit, mini_opt_tpu_torch.tuning, mini_opt_tpu_torch.native, "
        "mini_opt_tpu_torch.utils.serialization, mini_opt_tpu_torch.utils.checkpoint; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path",
    sorted((REPO / "mini_opt_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"]
    + [REPO / "scripts" / f"{name}_kernel_times.py" for name in ("mpc", "blocked", "pose_ring", "ldlt", "fused")]
    + [REPO / "scripts" / "kernel_timing.py", REPO / "scripts" / "cg_path_times.py",
       REPO / "scripts" / "fused_ik_instances.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import_in_source(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


# What ROADMAP.md queue 1 still lists: item 9's sharding names
# (parallel/batch.py) and the three edge- or observation-partitioned CG
# solvers. Every other public name of a JAX module has its port.
STILL_QUEUED = {
    "parallel/batch.py": {
        "batch_shard_result", "make_mesh", "shard_fused_mpc_servo_batch", "shard_fused_mpc_solve_batch",
        "shard_fused_solve_batch", "shard_pose_ring_solve_batch", "shard_solve_batch", "shard_solve_batch_2d",
    },
    "models/pose_graph.py": {"solve_pose_graph_large_sharded"},
    "models/pose_graph3.py": {"solve_pose_graph3_large_sharded"},
    "models/bundle_adjustment.py": {"solve_bundle_adjustment_large_sharded"},
}
# The port's module of a JAX module whose name it does not keep.
PORT_MODULE = {
    "ops/pallas_ik.py": "ops/fused_ik.py",
    "ops/pallas_blocked.py": "ops/blocked.py",
    "ops/pallas_ldlt.py": "ops/ldlt.py",
    "ops/pallas_qp.py": "ops/fused_qp.py",
    "ops/pallas_pose_ring.py": "ops/pose_ring.py",
    "ops/pallas_mpc.py": "ops/mpc.py",
}


def _public_names(path, with_imports=False):
    """Top-level public names a module defines (and, with_imports, the names
    it imports), by an AST walk: no module is imported."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")} | (names if with_imports else set())


@pytest.mark.parametrize(
    "module", sorted(str(p.relative_to(REPO / "mini_opt_tpu")) for p in (REPO / "mini_opt_tpu").rglob("*.py"))
)
def test_every_public_name_has_its_port(module):
    """Each public name of a JAX module is defined or imported by its port
    counterpart, but for what ROADMAP.md still queues, which must really be
    missing (so the queue and the code cannot drift apart)."""
    port_path = REPO / "mini_opt_tpu_torch" / PORT_MODULE.get(module, module)
    assert port_path.exists(), f"no port of mini_opt_tpu/{module}"
    missing = _public_names(REPO / "mini_opt_tpu" / module) - _public_names(port_path, with_imports=True)
    assert missing == STILL_QUEUED.get(module, set())


def test_numpy_inputs_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    targets, x0 = planar_instances(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.fused_ik_solve_batch(targets, x0, **BENCH)


def test_cpu_tensors_run_the_plain_version():
    targets, x0 = planar_instances(16, 2)
    before = fik.KERNEL_LAUNCHES
    x = port.fused_ik_solve_batch(torch.from_numpy(targets), torch.from_numpy(x0), **BENCH)
    assert x.device.type == "cpu" and x.shape == (16, 2) and x.dtype == torch.float64
    assert fik.KERNEL_LAUNCHES == before
    xn = port.fused_ik_solve_batch(targets, x0, device="cpu", **BENCH)
    torch.testing.assert_close(x, xn, rtol=0, atol=0)


def test_layout_round_trip():
    targets, x0 = planar_instances(5, 3)
    d_t, x_t = port.batch_from_numpy(targets, x0, device="cpu", dtype=torch.float32)
    assert d_t.shape == (2, 5) and x_t.shape == (3, 5) and d_t.dtype == torch.float32
    assert d_t.is_contiguous() and x_t.is_contiguous()
    back_d, back_x = port.batch_to_numpy(d_t, x_t)
    np.testing.assert_array_equal(back_d, targets.astype(np.float32))
    np.testing.assert_array_equal(back_x, x0.astype(np.float32))


def test_python_only_family_runs_on_cpu():
    """A FusedFamily with no device functor is a CPU family: the plain
    version solves it (the same arithmetic as the built-in planar one)."""
    ref = fik.planar_family(2, 0.4)
    fam = fik.FusedFamily(
        n=2, data_rows=2, m_eq=1, linearize=ref.linearize, errors=ref.errors,
        lower=ref.lower, upper=ref.upper, retract=ref.retract,
    )
    targets, x0 = planar_instances(8, 2)
    got = port.fused_solve_batch(fam, targets, x0, device="cpu", **BENCH)
    want = port.fused_solve_batch(ref, targets, x0, device="cpu", **BENCH)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_blocked_tier_and_bad_options_raise():
    """Past REGISTER_KKT_MAX fused_solve_batch hands the family to the
    blocked tier (pallas_ik.py:862-880), which records no history."""
    big = fik.planar_family(port.REGISTER_KKT_MAX, 0.4)  # D = 33
    targets, x0 = medium_n_planar_instances(3, big.n)
    kw = dict(max_iterations=1, qp_iterations=0, ls_iterations=0)
    before = blk.BLOCKED_LAUNCHES
    got = port.fused_solve_batch(big, targets, x0, device="cpu", return_state=True, **kw)
    want = port.blocked_solve_batch(big, targets, x0, device="cpu", return_state=True, **kw)
    assert blk.BLOCKED_LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="debug_history"):
        port.fused_solve_batch(big, targets, x0, device="cpu", debug_history=True, **kw)
    targets, x0 = planar_instances(4, 2)
    for bad in (dict(barrier="fixed"), dict(line_search="wolfe"), dict(max_iterations=0)):
        with pytest.raises(ValueError):
            port.fused_ik_solve_batch(targets, x0, device="cpu", **bad)
    with pytest.raises(TypeError):
        port.fused_ik_solve_batch(targets.astype(np.float32), x0, device="cpu")


def test_sources_present_and_build_dir_ignored():
    csrc = REPO / "mini_opt_tpu_torch" / "csrc"
    for name in ("fused_sqp.cuh", "families.cuh", "fused_ik.cu", "error_text.cu", "blocked_sqp.cuh", "blocked.cu",
                 "blocked_f64.cu", "blocked_spatial.cu", "blocked_spatial_f64.cu", "blocked_global.cu",
                 "blocked_global_f64.cu", "blocked_spatial_global.cu", "blocked_spatial_global_f64.cu", "blocked_kkt.cu", "ldlt.cu", "fused_qp.cuh", "fused_qp.cu", "fused_qp_pairs.cu",
                 "fused_qp_k2.cu", "fused_qp_warp.cu",
                 "pose_ring.cuh", "pose_ring.cu", "pose_ring_f64.cu", "mpc.cuh", "mpc.cu", "mpc_f64.cu"):
        assert (csrc / name).is_file(), name
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version (chip_smoke.py phase 3
# at small B). The skip condition is a string, so pytest evaluates it when
# each test is set up, not while the module is imported.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the fused IK kernel has no CPU mode",
)


CUDA_CASES = [
    ("planar", 2, BENCH, False),
    ("planar", 4, dict(max_iterations=10, qp_iterations=6, ls_iterations=2,
                       barrier="complementarity", line_search="polynomial"), True),
    ("spatial", 3, BENCH, False),
]


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=["planar2", "planar4_history", "spatial3"])
def test_kernel_matches_plain_on_card(case, dtype):
    """The kernel is built without FMA contraction and runs the plain
    version's operations in the same order, so on the card both agree bit
    for bit, NaN lanes included, on batch-major tensors."""
    kind, n, kw, hist = case
    data, x0 = (planar_instances if kind == "planar" else spatial_instances)(300, n, seed=n)
    data[5, 0] = np.nan
    x0[9, 1] = np.nan
    family = (fik.planar_family if kind == "planar" else fik.spatial_family)(n, 0.4)
    d_t, x_t = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (data, x0))
    args = (family, d_t, x_t, kw["max_iterations"], kw["qp_iterations"], kw["ls_iterations"],
            kw["line_search"], kw["barrier"], hist)
    before = fik.KERNEL_LAUNCHES
    got = fik._fused_solve_cuda(*args)
    torch.cuda.synchronize()
    assert fik.KERNEL_LAUNCHES == before + 1
    want = fik._fused_solve_plain_batch(*args)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@needs_cuda
def test_cuda_entry_point_launches_or_raises():
    targets, x0 = planar_instances(8192, 2)
    before = fik.KERNEL_LAUNCHES
    x, state = port.fused_ik_solve_batch(
        targets.astype(np.float32), x0.astype(np.float32), return_state=True, **BENCH
    )
    assert x.is_cuda and fik.KERNEL_LAUNCHES == before + 1
    assert (effector_error("planar", x.cpu(), targets) < 1e-3).mean() == 1.0
    ref = fik.planar_family(2, 0.4)
    python_only = fik.FusedFamily(
        n=2, data_rows=2, m_eq=1, linearize=ref.linearize, errors=ref.errors,
        lower=ref.lower, upper=ref.upper, retract=ref.retract,
    )
    with pytest.raises(NotImplementedError, match="emitter"):
        port.fused_solve_batch(python_only, targets, x0, **BENCH)
    # Every chain length of the register tier has an instance, built at
    # first use; a device functor the kernels lack raises on both tiers.
    before = fik.KERNEL_LAUNCHES
    port.fused_ik_solve_batch(np.zeros((4, 2)), np.zeros((4, 9)), **BENCH)
    assert fik.KERNEL_LAUNCHES == before + 1
    unknown = dataclasses.replace(fik.spatial_family(33, 0.4), cuda_functor=("helical", 0.4))
    with pytest.raises(NotImplementedError):
        port.fused_solve_batch(dataclasses.replace(unknown, n=9, lower=(None,) * 9, upper=(None,) * 9),
                               np.zeros((4, 3)), np.zeros((4, 9)), **BENCH)
    with pytest.raises(NotImplementedError, match="emitter"):
        port.blocked_solve_batch(unknown, np.zeros((4, 3)), np.zeros((4, 33)))


@pytest.mark.cuda
@needs_cuda
def test_blocked_kernel_matches_plain_on_card():
    """csrc/blocked.cu against _blocked_solve_plain at D = 34, float64, with
    a NaN-target lane: both sum in the same order and round alike."""
    n, B = 33, 300
    data, x0 = medium_n_planar_instances(B, n, seed=n)
    data[5, 0] = np.nan
    d_t, x_t = port.batch_from_numpy(data, x0, "cuda", torch.float64)
    args = (fik.planar_family(n, 0.4), d_t, x_t, 6, 3, 2, "armijo", "mpc")
    before = blk.BLOCKED_LAUNCHES
    got = blk._blocked_solve_cuda(*args)
    torch.cuda.synchronize()
    assert blk.BLOCKED_LAUNCHES == before + 1
    want = blk._blocked_solve_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


KKT_CARD_CASES = {
    "D34-f64": (34, torch.float64),  # the warp route, R = 2
    "D1-f64": (1, torch.float64),  # the smallest system
    "D130-f64": (130, torch.float64),  # R = 6, 3 systems per CTA
    "D200-f32": (200, torch.float32),  # the CTA route
}


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("batch", ["one", "ragged", "full"])
@pytest.mark.parametrize("case", list(KKT_CARD_CASES))
def test_blocked_kkt_kernel_matches_plain_on_card(case, batch):
    """csrc/blocked_kkt.cu against _blocked_kkt_solve_plain on
    quasi-definite KKT systems, bit for bit: one system, a ragged last CTA
    (W + 1 systems) and B = 150 (no multiple of anything)."""
    D, dtype = KKT_CARD_CASES[case]
    B = {"one": 1, "ragged": blk.kkt_launch_plan(D, 1, dtype).warps + 1, "full": 150}[batch]
    rng = np.random.default_rng(D)
    m = max(1, D // 12) if D > 1 else 0
    n = D - m
    A = rng.normal(size=(B, n, n))
    H = np.zeros((B, n + m, n + m))
    H[:, :n, :n] = A @ A.transpose(0, 2, 1) + 2.0 * np.eye(n)
    H[:, n:, :n] = rng.normal(size=(B, m, n))
    H[:, :n, n:] = H[:, n:, :n].transpose(0, 2, 1)
    H_t = torch.as_tensor(H, dtype=dtype, device="cuda")
    rhs = torch.as_tensor(rng.normal(size=(B, n + m)), dtype=dtype, device="cuda")
    before = blk.KKT_LAUNCHES
    got = port.blocked_kkt_solve(H_t, rhs)
    torch.cuda.synchronize()
    assert blk.KKT_LAUNCHES == before + 1
    torch.testing.assert_close(got, blk._blocked_kkt_solve_plain(H_t, rhs), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The general path's kernels (csrc/ldlt.cu, csrc/fused_qp.cu) on the card.
# ---------------------------------------------------------------------------


def _bit_equal(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("D", [1, 2, 3, ldlt.REGISTER_MAX_D, ldlt.REGISTER_MAX_D + 1, 17, 40])
def test_ldlt_kernels_match_plain_on_card(D, dtype):
    """Kernels 4 and 5 against their plain versions, bit for bit, on
    batch-major SPD systems and right-hand sides as ``factorize`` and
    ``solve`` give them (the register route up to REGISTER_MAX_D, the
    generic route past it), at B = 1, 33 (a ragged CTA) and 300 with one
    NaN lane and one singular lane: L, d, x and the kernel's ``ok`` against
    ``_ok`` of the plain factor; one launch counted for each."""
    rng = np.random.default_rng(D)
    for B in (1, 33, 300):
        A = rng.normal(size=(B, D, D))
        H = A @ A.transpose(0, 2, 1) + D * np.eye(D)
        if B > 7:
            H[5] = np.nan
            H[7] = 0.0
        H_b = torch.as_tensor(H, dtype=dtype, device="cuda")
        rhs = torch.as_tensor(rng.normal(size=(B, D)), dtype=dtype, device="cuda")
        before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES)
        Lk, dk, okk = ldlt._ldlt_factor_cuda(H_b)
        xk = ldlt._ldlt_solve_cuda(Lk, dk, rhs)
        torch.cuda.synchronize()
        assert (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES) == (before[0] + 1, before[1] + 1)
        Lp, dp, okp = ldlt._factor_plain(H_b)
        xp = ldlt._solve_plain(Lp, dp, rhs)
        assert _bit_equal(Lk, Lp) and _bit_equal(dk, dp) and _bit_equal(xk, xp)
        assert xk.shape == (B, D)
        assert torch.equal(okk, ldlt._ok(Lp, dp)) and torch.equal(okk, okp)
        assert bool(okk[:5].all()) and (B < 8 or not bool(okk[5] or okk[7]))


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("barrier", ["complementarity", "mpc"])
def test_fused_qp_kernel_matches_plain_on_card(barrier, dtype):
    """Kernel 6 against its plain version, bit for bit, on the IK
    linearization of bench instances (N = 4, one equality row, both bounds on
    joints 1..3), one NaN-target lane."""
    targets, x0 = planar_instances(300, 4, seed=4)
    targets[5, 0] = np.nan
    chain = port.make_planar_chain(4, dtype=dtype, device="cuda")
    x_t = torch.as_tensor(x0, dtype=dtype, device="cuda")
    qp, _ = port.nonlinear.linearize_and_fill_qp(
        lambda t: port.make_ik_problem(chain, t), x_t, torch.full_like(x_t[:, 0], 1e-3),
        data=torch.as_tensor(targets, dtype=dtype, device="cuda"),
    )
    args = (
        qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b, tuple(int(v) for v in qp.ineq_var), 6, 0.1,
        barrier, True,
    )
    before = fq.FUSED_QP_LAUNCHES
    xk, yk = fq._fused_qp_cuda(*args)
    torch.cuda.synchronize()
    assert fq.FUSED_QP_LAUNCHES == before + 1
    xp, yp = fq._fused_qp_plain_batch(*args)
    assert _bit_equal(xk, xp) and _bit_equal(yk, yp)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 33, 8205])
@pytest.mark.parametrize("kernel", ["fused_qp", "fused_ik"])
def test_register_kernels_match_plain_at_edge_batches(kernel, B, dtype):
    """Kernels 6 and 1 bit for bit against their plain versions at one
    instance, a ragged CTA and past 8192 lanes (a NaN lane where there is
    one): kernel 6 on both routes (the general path's pairs, and the same QP
    with its rows reversed and one more on the run-time route), kernel 1 on
    strided caller tensors."""
    n = 4
    targets, x0 = planar_instances(B, n, seed=B)
    if B > 9:
        targets[5, 0] = np.nan
    if kernel == "fused_ik":
        d = torch.as_tensor(targets, dtype=dtype, device="cuda")
        x = torch.as_tensor(x0, dtype=dtype, device="cuda").T.contiguous().T
        args = (fik.planar_family(n, 0.4), torch.stack([d, d], 2)[:, :, 0], x, 4, 2, 1, "armijo", "mpc", False)
        got, want = fik._fused_solve_cuda(*args), fik._fused_solve_plain_batch(*args)
        assert all(_bit_equal(g, w) for g, w in zip(got[:2], want[:2]))
        return
    chain = port.make_planar_chain(n, dtype=dtype, device="cuda")
    x_t = torch.as_tensor(x0, dtype=dtype, device="cuda")
    qp, _ = port.nonlinear.linearize_and_fill_qp(
        lambda t: port.make_ik_problem(chain, t), x_t, torch.full_like(x_t[:, 0], 1e-3),
        data=torch.as_tensor(targets, dtype=dtype, device="cuda"),
    )
    var = tuple(int(v) for v in qp.ineq_var)
    rev = list(range(len(var) - 1, -1, -1))
    one = torch.ones_like(qp.ineq_b[:, :1])
    routes = {
        "pairs": (qp.ineq_a, qp.ineq_b, var),
        "any": (torch.cat([one, qp.ineq_a[:, rev]], 1), torch.cat([10.0 * one, qp.ineq_b[:, rev]], 1),
                (0,) + tuple(var[m] for m in rev)),
    }
    for route, (ia, ib, v) in routes.items():
        assert fq.qp_route(n, 1, v) == route
        for barrier in ("complementarity", "mpc"):
            args = (qp.G, qp.c, qp.A_eq, qp.b_eq, ia, ib, v, 6, 0.1, barrier, True)
            xk, yk = fq._fused_qp_cuda(*args)
            xp, yp = fq._fused_qp_plain_batch(*args)
            assert _bit_equal(xk, xp) and _bit_equal(yk, yp)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("route", ["pallas_ldlt", "pallas_fused"])
def test_general_path_launches_its_kernels(route):
    """solve_ik_batch at 10/6/2 with fixed trips: 70 factorizations and 70
    solves (1 + 6 per outer iteration), or 10 fused QPs; every lane at its
    target."""
    import dataclasses

    targets, x0 = planar_instances(300, 2, seed=0)
    params = dataclasses.replace(
        port.default_ik_params(torch.float32, max_iterations=10, max_qp_iterations=6),
        max_line_search_iterations=2, record_history=False, early_exit=False,
        **({"kkt_solver": "pallas_ldlt"} if route == "pallas_ldlt" else {"qp_solver": "pallas_fused"}),
    )
    before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES, fq.FUSED_QP_LAUNCHES)
    res = port.solve_ik_batch(targets.astype(np.float32), x0.astype(np.float32), params=params)
    torch.cuda.synchronize()
    after = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES, fq.FUSED_QP_LAUNCHES)
    launched = tuple(a - b for a, b in zip(after, before))
    assert launched == ((70, 70, 0) if route == "pallas_ldlt" else (0, 0, 10))
    assert res.x.is_cuda
    assert (effector_error("planar", res.x.cpu().numpy(), targets) < 1e-3).mean() >= 0.99


@pytest.mark.cuda
@needs_cuda
def test_mpc_entry_points_launch_or_raise():
    """fused_mpc_solve_batch and fused_mpc_servo_batch launch kernels 8 and 9
    once per call on CUDA tensors (numpy inputs go to the card), run the
    plain version only for backend="xla", and raise for a family without a
    device functor."""
    import dataclasses

    from mini_opt_tpu_torch.instances import cartpole_mpc_instances
    from mini_opt_tpu_torch.models import mpc
    from mini_opt_tpu_torch.ops import mpc as pm

    fam = pm.cartpole_mpc_family(20, 0.05)
    x0 = cartpole_mpc_instances(256, 0).astype(np.float32)
    z0 = mpc.initial_guess(mpc.CartPole(), torch.as_tensor(x0), 20, 0.05).numpy()
    before = (pm.KERNEL_LAUNCHES, pm.SERVO_LAUNCHES)
    z = port.fused_mpc_solve_batch(fam, x0, z0, 8, 3, 2)
    xf, zf, stats = port.fused_mpc_servo_batch(fam, x0, z.cpu().numpy(), 5)
    torch.cuda.synchronize()
    assert z.is_cuda and xf.is_cuda and (pm.KERNEL_LAUNCHES, pm.SERVO_LAUNCHES) == (before[0] + 1, before[1] + 1)
    zx = port.fused_mpc_solve_batch(fam, torch.as_tensor(x0, device="cuda"), torch.as_tensor(z0, device="cuda"),
                                    8, 3, 2, backend="xla")
    assert zx.is_cuda and pm.KERNEL_LAUNCHES == before[0] + 1
    assert bool(((zx == z) | (zx.isnan() & z.isnan())).all())
    with pytest.raises(NotImplementedError, match="functor"):
        port.fused_mpc_solve_batch(dataclasses.replace(fam, cuda_functor=None), x0, z0)
