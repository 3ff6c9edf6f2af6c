"""The rest of the general path on the CPU, without JAX: ``nls_solve``'s
``parallel_line_search``, ``fuse_probe_linearize``, ``exit_callback`` and
``log_qp_eigenvalues``; the result files, warm starts and checkpoints; the
chrome-trace collector; the native CPU baseline; kernel 6's launch plan.
Every case takes well under a second.

* The parallel line search against the sequential one (x, statuses and the
  line-search history bit for bit) with ``early_exit`` on and off, on both
  QP routes; the fused probe linearization against the standalone one; the
  restricted-domain problem whose losing probe is NaN
  (tests/test_nonlinear.py:721) on all three line searches.
* ``exit_callback``: lanes it stops end ``USER_CALLBACK`` and freeze; the
  empty eigenvalue buffer reaches it whole; it needs ``record_history``.
* ``log_qp_eigenvalues`` against ``numpy.linalg.eigvalsh`` of each
  iteration's damped G, taken from ``linearize_and_fill_qp``.
* ``utils.serialization`` (one lane through JSON, the batch through npz),
  ``utils.checkpoint`` and the renderers.
* ``TraceCollector``'s bound of 100,000 events and the solver's phase
  events; ``device_profile`` writes a trace.
* ``native.planar_fk`` against the port's planar chain (needs g++).
* ``ops.fused_qp.launch_plan``: the route, the bytes an instance against a
  count of the warp kernel's slab, instances a CTA at every D = 1..200, the
  D = 192 boundary, the grid; the ``cuda`` cases hold both routes bit for
  bit against the plain version on a card.
"""

import dataclasses
import json
import math
import shutil

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch import nonlinear
from mini_opt_tpu_torch.instances import planar_instances
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.structs import NLSTerminationState, tree_map
from mini_opt_tpu_torch.utils import checkpoint, serialization, tracing

F64 = torch.float64
B = 16


def _params(**kw):
    base = dataclasses.replace(
        port.default_ik_params(F64, max_iterations=10, max_qp_iterations=6),
        max_line_search_iterations=3, record_history=True, early_exit=False,
    )
    return dataclasses.replace(base, **kw)


def _solve(params, B=B, seed=0, **kwargs):
    chain = port.make_planar_chain(2, dtype=F64, device="cpu")
    targets, x0 = planar_instances(B, 2, seed=seed)
    return port.nls_solve(
        lambda t: port.make_ik_problem(chain, t), params, torch.as_tensor(x0), data=torch.as_tensor(targets),
        retraction=port.mod_pi_retraction, **kwargs,
    )


def _same(a, b, msg=""):
    for u, v in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True, msg=msg)


def _leaves(tree):
    out = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


ROUTES = {"default": {}, "pallas_fused": dict(qp_solver="pallas_fused", record_history=False)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("early_exit", [False, True])
def test_parallel_line_search_matches_sequential(route, early_exit):
    seq = _solve(_params(early_exit=early_exit, **ROUTES[route]))
    par = _solve(_params(early_exit=early_exit, parallel_line_search=True, **ROUTES[route]))
    _same((seq.x, seq.termination_state, seq.num_iterations, seq.iterations.line_search),
          (par.x, par.termination_state, par.num_iterations, par.iterations.line_search))
    assert int(seq.iterations.line_search.num_steps.sum()) > 0 or not ROUTES[route].get("record_history", True)


@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_probe_linearization_matches_standalone(route):
    par = _solve(_params(parallel_line_search=True, **ROUTES[route]))
    fused = _solve(_params(parallel_line_search=True, fuse_probe_linearize=True, **ROUTES[route]))
    _same((par.x, par.termination_state, par.errors, par.iterations),
          (fused.x, fused.termination_state, fused.errors, fused.iterations))
    assert bool(port.termination_state_indicates_satisfied_tol(fused.termination_state).any())


def test_parallel_line_search_survives_a_nan_losing_probe():
    """tests/test_nonlinear.py:721: the alpha = 1 probe jumps a domain hole,
    the alpha = 0.5 probe lands in it (NaN); where-masked selection keeps
    the winner finite on every line search."""

    def res(p):  # domain hole: needs |x - 2| >= 1
        return torch.stack([torch.sqrt((p[0] - 2.0) ** 2 - 1.0), 2.0 * (p[0] - 6.0)])

    problem = port.Problem(dimension=1, costs=(port.make_residual([0], res, 2),))
    base = port.NLSParams(
        max_iterations=15, max_qp_iterations=1, relative_exit_tol=1e-13, max_line_search_iterations=4,
        line_search_strategy=port.LineSearchStrategy.ARMIJO_BACKTRACK, kkt_solver="ldlt",
    )
    x0 = torch.tensor([[0.5], [0.5]], dtype=F64)
    xs = {}
    for par, fuse in ((False, False), (True, False), (True, True)):
        r = port.nls_solve(problem, dataclasses.replace(base, parallel_line_search=par, fuse_probe_linearize=fuse), x0)
        assert bool(torch.isfinite(r.errors.f).all()), (par, fuse)
        assert not bool((r.termination_state == NLSTerminationState.QP_INDEFINITE).any()), (par, fuse)
        xs[(par, fuse)] = r.x
    for key, x in xs.items():
        torch.testing.assert_close(x, xs[(False, False)], rtol=0, atol=1e-9, msg=str(key))


def test_exit_callback_stops_lanes_with_user_callback():
    free = _solve(_params())
    seen = []

    def callback(row):
        seen.append(tuple(row.qp_eigenvalues.min.shape))  # the empty buffer, whole
        return row.errors_initial.f > 1e-7

    stopped = _solve(_params(), exit_callback=callback)
    assert seen and all(s == (0,) for s in seen)
    user = stopped.termination_state == NLSTerminationState.USER_CALLBACK
    assert bool(user.any()) and not bool(user.all())
    it, f0 = stopped.iterations, stopped.iterations.errors_initial.f
    last = stopped.num_iterations.long() - 1
    # A stopped lane's last recorded cost is the first under the threshold,
    # and the lane froze there: no row past it.
    assert bool((f0[user, :].gather(1, last[user, None])[:, 0] <= 1e-7).all())
    assert bool((it.step_result[user] * (torch.arange(f0.shape[1]) > last[user, None])).eq(0).all())
    keep = ~user
    torch.testing.assert_close(stopped.x[keep], free.x[keep], rtol=0, atol=0)
    with pytest.raises(AssertionError, match="record_history"):
        _solve(_params(record_history=False), exit_callback=lambda row: row.lam > 0)


def test_qp_eigenvalues_match_numpy():
    Gs = []
    real = nonlinear.linearize_and_fill_qp

    def spy(*args, **kwargs):
        qp, err = real(*args, **kwargs)
        Gs.append(qp.G.clone())
        return qp, err

    nonlinear.linearize_and_fill_qp = spy
    try:
        r = _solve(_params(log_qp_eigenvalues=True))
    finally:
        nonlinear.linearize_and_fill_qp = real
    ev = r.iterations.qp_eigenvalues
    assert ev.min.shape == (B, 10)
    for i, G in enumerate(Gs):
        w = np.linalg.eigvalsh(G.numpy())
        ran = (r.num_iterations > i).numpy()
        np.testing.assert_allclose(ev.min[:, i].numpy()[ran], w.min(1)[ran], rtol=0, atol=1e-12)
        np.testing.assert_allclose(ev.max[:, i].numpy()[ran], w.max(1)[ran], rtol=0, atol=1e-12)
        np.testing.assert_allclose(ev.abs_min[:, i].numpy()[ran], np.abs(w).min(1)[ran], rtol=0, atol=1e-12)
    off = _solve(_params())
    assert off.iterations.qp_eigenvalues.min.shape == (B, 0)
    with pytest.raises(AssertionError, match="matrix-free"):
        _solve(_params(qp_solver="cg", log_qp_eigenvalues=True))


def test_eigen_summary_of_a_nan_lane_is_nan():
    G = torch.eye(3, dtype=F64).expand(4, 3, 3).clone()
    G[2, 0, 0] = math.nan
    lo, hi, amin = nonlinear._eigen_summary(G)
    assert bool(torch.isnan(lo[2])) and bool(torch.isfinite(lo[[0, 1, 3]]).all())
    torch.testing.assert_close(hi[[0, 1, 3]], torch.ones(3, dtype=F64))


@pytest.fixture(scope="module")
def logged():
    return _solve(_params(log_qp_eigenvalues=True))


def test_json_round_trip_of_one_lane(logged, tmp_path):
    lane = tree_map(lambda t: t[3], logged)
    doc = serialization.nls_result_to_json(lane)
    assert doc["_shape"] == dict(max_iterations=10, max_line_search_steps=4, max_qp_iterations=6, dtype="float64",
                                 with_eigenvalues=True)
    assert "qp_eigenvalues" in doc["iterations"][0] and doc["solver_variant"] == "INTERIOR_POINT"
    path = tmp_path / "lane.json"
    serialization.save_result_json(str(path), lane)
    back = serialization.load_result_json(str(path), device="cpu")
    # Rows past num_iterations and QP rows past each QP's count come back 0.
    n = int(lane.num_iterations)
    _same((back.x, back.termination_state, back.errors, back.solver_variant),
          (lane.x, lane.termination_state, lane.errors, lane.solver_variant))
    for u, v in zip(_leaves(back.iterations.line_search), _leaves(lane.iterations.line_search)):
        torch.testing.assert_close(u[:n], v[:n], rtol=0, atol=0)
    _same(tree_map(lambda t: t[:n], back.iterations.qp_eigenvalues),
          tree_map(lambda t: t[:n], lane.iterations.qp_eigenvalues))
    assert json.loads(path.read_text()) == doc


def test_npz_round_trip_of_the_batch(logged, tmp_path):
    path = tmp_path / "batch.npz"
    serialization.save_result_npz(str(path), logged)
    _same(serialization.load_result_npz(str(path)), logged)
    with np.load(path) as data:
        fields = bytes(data["__fields__"]).decode().split("\n")
    assert fields[:3] == ["termination_state", "num_iterations", "x"]
    assert "iterations.qp_eigenvalues.abs_min" in fields


def test_warm_start_and_checkpoint_round_trips(logged, tmp_path):
    x, s = torch.randn(5, 3, dtype=F64), torch.rand(5, 4, dtype=F64)
    checkpoint.save_warm_start(str(tmp_path / "ws.npz"), x, s=s)
    back = checkpoint.load_warm_start(str(tmp_path / "ws.npz"))
    assert set(back) == {"x", "s"}
    torch.testing.assert_close(back["x"], x, rtol=0, atol=0)
    assert checkpoint.save_pytree_orbax(str(tmp_path / "tree.pt"), logged)
    _same(checkpoint.load_pytree_orbax(str(tmp_path / "tree.pt"), template=logged), logged)
    plain = checkpoint.load_pytree_orbax(str(tmp_path / "tree.pt"))
    torch.testing.assert_close(plain["iterations"]["lam"], logged.iterations.lam, rtol=0, atol=0)


def test_renderers(logged):
    lane = tree_map(lambda t: t[0], logged)
    text = port.nls_result_to_string(lane, include_qp=True)
    assert text.startswith("Terminated with state: ") and "QP iteration 0: mu=" in text
    assert f"Iterations: {int(lane.num_iterations)}," in text
    colored = port.nls_result_to_string(lane, use_color=True)
    assert "\x1b[" in colored
    stats = port.summarize_counts(logged)
    assert set(stats) == {"num_iterations", "num_qp_iterations", "num_line_search_steps", "num_failed_line_searches"}
    assert stats["num_iterations"]["max"] == float(logged.num_iterations.max())


def test_trace_collector_bound_and_phases(tmp_path):
    c = tracing.TraceCollector()
    for k in range(tracing._MAX_EVENTS + 5):
        c.submit("e", float(k), 1.0)
    assert len(json.loads(c.get_trace_json())["traceEvents"]) == tracing._MAX_EVENTS
    c.clear()
    assert json.loads(c.get_trace_json())["traceEvents"] == []
    tracing.trace_collector.clear()
    _solve(_params(max_iterations=2))
    names = {e["name"] for e in json.loads(tracing.trace_collector.get_trace_json())["traceEvents"]}
    assert {"Solve", "LinearizeAndFillQP", "SelectStepSize", "EvaluateNonlinearErrors"} <= names
    with tracing.scoped_trace("mine"):
        pass
    tracing.trace_collector.write(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"][-1]["name"] == "mine"
    with tracing.device_profile(str(tmp_path / "prof")):
        _solve(_params(max_iterations=1))
    trace = next((tmp_path / "prof").glob("trace_*.json")).read_text()
    assert "SelectStepSize" in trace


@pytest.mark.skipif(shutil.which("g++") is None, reason="native.py builds its library with g++")
def test_native_planar_fk_matches_the_planar_chain():
    from mini_opt_tpu_torch import native

    th = np.array([0.3, -0.7, 1.1])
    xy, J = native.planar_fk(th, 0.4)
    phi = np.cumsum(th)
    np.testing.assert_allclose(xy, 0.4 * np.array([np.cos(phi).sum(), np.sin(phi).sum()]), rtol=0, atol=1e-14)
    chain = port.make_planar_chain(3, dtype=F64, device="cpu")
    eff = chain.effector(torch.as_tensor(th)).translation
    np.testing.assert_allclose(xy, eff[:2].numpy(), rtol=0, atol=1e-14)
    Jn = torch.func.jacfwd(lambda p: chain.effector(p).translation[:2])(torch.as_tensor(th))
    np.testing.assert_allclose(J, Jn.numpy(), rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# Kernel 6's launch plan.
# ---------------------------------------------------------------------------


def _slab_count(N, K, M):
    """csrc/fused_qp_warp.cu's carve, counted from its arrays."""
    D = N + K
    arrays = {"H": D * (D + 1) // 2, "sol": D, "x": N, "rd": N, "y": K, "rpe": K}
    for name in ("ia", "ib", "s", "z", "rpi", "zs", "rc", "q", "ds", "dz", "ta", "tb"):
        arrays[name] = M
    return sum(arrays.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_launch_plan_at_every_size(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for D in range(1, 201):
        for K in sorted({0, 1, 2, min(3, D - 1)}):
            N = D - K
            if N < 1:
                continue
            M = 2 * (N - 1)
            if D > fq.WARP_MAX_D and not fq.register_route(N, K, M):
                with pytest.raises(NotImplementedError, match="192"):
                    fq.launch_plan(N, K, M, 8192, dtype)
                continue
            slab = -(-_slab_count(N, K, M) * size // 16) * 16
            if not fq.register_route(N, K, M) and slab > fq.MAX_CTA_SMEM:
                with pytest.raises(NotImplementedError, match="shared memory"):
                    fq.launch_plan(N, K, M, 8192, dtype)
                continue
            plan = fq.launch_plan(N, K, M, 8192, dtype)
            if fq.register_route(N, K, M):
                assert plan == fq.LaunchPlan("register", 32, 32, 0, 0, 256)
                assert N <= fq.REGISTER_MAX_N[K]
                continue
            assert plan.route == "warp" and plan.instance_bytes == slab
            assert fq.warp_slab_bytes(N, K, M, dtype) == slab
            W = min(fq.WARPS_PER_CTA, fq.MAX_CTA_SMEM // slab)
            assert (plan.instances_per_cta, plan.threads, plan.cta_bytes) == (W, 32 * W, W * slab)
            assert plan.grid == -(-8192 // W) and plan.cta_bytes <= fq.MAX_CTA_SMEM


@pytest.mark.parametrize("N, K, M, route", [
    (1, 0, 0, "register"), (1, 2, 2, "register"), (6, 2, 10, "register"), (7, 2, 12, "warp"),
    (8, 1, 14, "register"), (9, 1, 16, "warp"), (3, 3, 4, "warp"), (4, 1, 9, "warp"),
    (191, 1, 380, "warp"), (192, 0, 1, "warp"),
])
def test_launch_plan_routes(N, K, M, route):
    assert fq.launch_plan(N, K, M, 1, torch.float32).route == route


def test_launch_plan_past_the_limits():
    with pytest.raises(NotImplementedError, match="N \\+ K <= 192"):
        fq.launch_plan(192, 1, 0, 1, torch.float32)
    with pytest.raises(NotImplementedError, match="shared memory"):
        fq.launch_plan(150, 1, 3000, 1, torch.float64)
    with pytest.raises(ValueError):
        fq.launch_plan(0, 1, 0, 1, torch.float32)
    W = fq.launch_plan(48, 1, 94, 1, torch.float32).instances_per_cta
    assert [fq.launch_plan(48, 1, 94, b, torch.float32).grid for b in (1, W, W + 1)] == [1, 1, 2]


def test_rows_table():
    assert fq.rows_table((1, 1, 2, 0, 2), 3) == [1, 1, 2, 0, 2] + [0, 1, 3, 5] + [3, 0, 1, 2, 4]
    assert fq.rows_table((), 2) == [0, 0, 0]


needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: kernel 6 (csrc/fused_qp*.cu) has no CPU mode",
)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("N, K, var", [
    (1, 1, (0, 0)), (3, 2, (1, 1, 2, 2)), (5, 3, (1, 1, 2, 2, 3, 3, 4, 4)), (4, 1, (0, 3, 2, 1) * 3),
    (16, 1, tuple(1 + m // 2 for m in range(30))),
])
def test_kernel_6_routes_bit_identical_on_card(N, K, var, dtype):
    rng = np.random.default_rng(N + 10 * K)
    Bc, M = 37, len(var)
    R = rng.normal(size=(Bc, N, N))
    G = R @ R.transpose(0, 2, 1) / N + np.eye(N)
    arrays = (G, rng.normal(size=(Bc, N)), rng.normal(size=(Bc, K, N)), rng.normal(size=(Bc, K)),
              np.where(rng.random((Bc, M)) < 0.5, 1.0, -1.0), rng.uniform(0.2, 2.0, (Bc, M)))
    ts = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays]
    for barrier in ("complementarity", "mpc"):
        args = (*ts, var, 6, 0.1, barrier, True)
        got, want = fq._fused_qp_cuda(*args), fq._fused_qp_plain_batch(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
