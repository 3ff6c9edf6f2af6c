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
        "mini_opt_tpu_torch.ops.pose_ring, mini_opt_tpu_torch.models.pose_graph; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path",
    sorted((REPO / "mini_opt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import_in_source(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


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
    for name in ("fused_sqp.cuh", "families.cuh", "fused_ik.cu", "blocked_sqp.cuh", "blocked.cu",
                 "blocked_kkt.cu", "ldlt.cu", "fused_qp.cu", "pose_ring.cuh", "pose_ring.cu",
                 "pose_ring_f64.cu"):
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
    for bit, NaN lanes included."""
    kind, n, kw, hist = case
    data, x0 = (planar_instances if kind == "planar" else spatial_instances)(300, n, seed=n)
    data[5, 0] = np.nan
    x0[9, 1] = np.nan
    family = (fik.planar_family if kind == "planar" else fik.spatial_family)(n, 0.4)
    d_t, x_t = port.batch_from_numpy(data, x0, "cuda", dtype)
    args = (family, d_t, x_t, kw["max_iterations"], kw["qp_iterations"], kw["ls_iterations"],
            kw["line_search"], kw["barrier"], hist)
    before = fik.KERNEL_LAUNCHES
    got = fik._fused_solve_cuda(*args)
    torch.cuda.synchronize()
    assert fik.KERNEL_LAUNCHES == before + 1
    want = fik._fused_solve_plain(*args)
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
    with pytest.raises(NotImplementedError):
        port.fused_ik_solve_batch(np.zeros((4, 2)), np.zeros((4, 9)), **BENCH)
    # The blocked tier has a planar functor only.
    with pytest.raises(NotImplementedError, match="emitter"):
        port.blocked_solve_batch(fik.spatial_family(33, 0.4), np.zeros((4, 3)), np.zeros((4, 33)))


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


@pytest.mark.cuda
@needs_cuda
def test_blocked_kkt_kernel_matches_plain_on_card():
    """csrc/blocked_kkt.cu against _blocked_kkt_solve_plain at D = 34 on
    quasi-definite KKT systems, B = 150 (no multiple of anything)."""
    rng = np.random.default_rng(34)
    B, n, m = 150, 31, 3
    A = rng.normal(size=(B, n, n))
    H = np.zeros((B, n + m, n + m))
    H[:, :n, :n] = A @ A.transpose(0, 2, 1) + 2.0 * np.eye(n)
    H[:, n:, :n] = rng.normal(size=(B, m, n))
    H[:, :n, n:] = H[:, n:, :n].transpose(0, 2, 1)
    H_t = torch.as_tensor(H, device="cuda")
    rhs = torch.as_tensor(rng.normal(size=(B, n + m)), device="cuda")
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
@pytest.mark.parametrize("D", [3, 17, 40])
def test_ldlt_kernels_match_plain_on_card(D, dtype):
    """Kernels 4 and 5 against their plain versions, bit for bit, on SPD
    systems with one NaN lane and one singular lane (``ok`` equal)."""
    rng = np.random.default_rng(D)
    B = 300
    A = rng.normal(size=(B, D, D))
    H = A @ A.transpose(0, 2, 1) + D * np.eye(D)
    H[5] = np.nan
    H[7] = 0.0
    Ht = torch.as_tensor(H, dtype=dtype, device="cuda").permute(1, 2, 0).contiguous()
    rhs = torch.as_tensor(rng.normal(size=(D, B)), dtype=dtype, device="cuda")
    before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES)
    Lk, dk = ldlt._ldlt_factor_cuda(Ht)
    xk = ldlt._ldlt_solve_cuda(Lk, dk, rhs)
    torch.cuda.synchronize()
    assert (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    Lp, dp = ldlt._ldlt_factor_plain(Ht)
    xp = ldlt._ldlt_solve_plain(Lp, dp, rhs)
    assert _bit_equal(Lk, Lp) and _bit_equal(dk, dp) and _bit_equal(xk, xp)
    assert torch.equal(ldlt._ok(Lk, dk), ldlt._ok(Lp, dp))


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
        qp.G.permute(1, 2, 0).contiguous(), qp.c.T.contiguous(), qp.A_eq.permute(1, 2, 0).contiguous(),
        qp.b_eq.T.contiguous(), qp.ineq_a.T.contiguous(), qp.ineq_b.T.contiguous(),
        tuple(int(v) for v in qp.ineq_var), 6, 0.1, barrier, True,
    )
    before = fq.FUSED_QP_LAUNCHES
    xk, yk = fq._fused_qp_cuda(*args)
    torch.cuda.synchronize()
    assert fq.FUSED_QP_LAUNCHES == before + 1
    xp, yp = fq._fused_qp_plain(*args)
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
