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
from mini_opt_tpu_torch.instances import effector_error, planar_instances, spatial_instances
from mini_opt_tpu_torch.ops import fused_ik as fik

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
        "import sys, mini_opt_tpu_torch, mini_opt_tpu_torch.instances; "
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
    big = fik.FusedFamily(
        n=32, data_rows=1, m_eq=1, linearize=None, errors=None,
        lower=(None,) * 32, upper=(None,) * 32,
    )
    with pytest.raises(NotImplementedError, match="slice 2"):
        port.fused_solve_batch(big, np.zeros((2, 1)), np.zeros((2, 32)), device="cpu")
    targets, x0 = planar_instances(4, 2)
    for bad in (dict(barrier="fixed"), dict(line_search="wolfe"), dict(max_iterations=0)):
        with pytest.raises(ValueError):
            port.fused_ik_solve_batch(targets, x0, device="cpu", **bad)
    with pytest.raises(TypeError):
        port.fused_ik_solve_batch(targets.astype(np.float32), x0, device="cpu")


def test_sources_present_and_build_dir_ignored():
    csrc = REPO / "mini_opt_tpu_torch" / "csrc"
    for name in ("fused_sqp.cuh", "families.cuh", "fused_ik.cu"):
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
    with pytest.raises(NotImplementedError, match="slice 2"):
        port.fused_solve_batch(python_only, targets, x0, **BENCH)
    with pytest.raises(NotImplementedError):
        port.fused_ik_solve_batch(np.zeros((4, 2)), np.zeros((4, 9)), **BENCH)
