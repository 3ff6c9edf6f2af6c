"""The port's pose-ring path held against the port's own general path, with
no JAX compile (float64, CPU tensors, so the plain version of kernel 7 runs).

* One Gauss-Newton step (1/0, lambda = 0) of ``pose_ring_solve_batch``
  equals the dense solve of the Gauss-Newton system that
  ``linearize_and_fill_qp`` assembles on ``make_pose_graph_problem`` for the
  same graph, by ``numpy.linalg.solve``, within 1e-12: canonical rings at
  N = 2..10, single closures at and next to the chain's ends (either
  direction), and graphs with two and three closures, one with a shared
  endpoint. The bordered block-Thomas elimination is algebraically that
  dense solve.
* Full fixed-trip solves equal ``nls_solve`` (Armijo tau = 0.5,
  ``kkt_solver="ldlt"``) on the same problem: at 2/1 within 1e-12; at 6/2
  within 2e-3 on x and rtol 1e-3 on the cost with clean flags, the JAX
  package's own tolerances (tests/test_pallas_pose_ring.py:96-120).
* NaN lanes are flagged and contained, a lane's answer does not depend on
  the rest of the batch, ``solve_pose_graph_rings`` is the kernel plus the
  (B, N, 3) reshape, and the argument checks raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges, ring_instances
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.nonlinear import NLSParams, linearize_and_fill_qp, nls_solve
from mini_opt_tpu_torch.ops import pose_ring as pr
from mini_opt_tpu_torch.structs import LineSearchStrategy


def _graph(n, closures, B, seed):
    """(family, edges, data (B, 3E), x0 (B, 3N)) as CPU float64 tensors."""
    if closures is None:
        fam, edges = pr.pose_ring_family(n), pg.ring_edges(n)
        data, x0 = ring_instances(B, n, seed=seed)
    else:
        fam = pr.pose_ring_family(n, closures=closures)
        edges = chain_edges(n, closures)
        data, x0 = chain_closure_instances(B, n, closures, seed=seed)
    return fam, edges, torch.tensor(data), torch.tensor(x0)


def _problem_fn(n, edges):
    def fn(d):
        return pg.make_pose_graph_problem(
            n, edges, d.reshape(len(edges), 3), torch.ones(len(edges), dtype=d.dtype), anchor_weight=100.0
        )

    return fn


def _general(it, ls):
    return NLSParams(
        max_iterations=it, max_qp_iterations=1, max_line_search_iterations=ls,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
        record_history=False, early_exit=False, kkt_solver="ldlt",
    )


GN_CASES = (
    [(n, None) for n in range(2, 11)]
    + [(7, (c,)) for c in ((6, 0), (0, 6), (5, 1), (1, 5), (4, 2), (6, 2), (2, 6))]
    + [(10, ((8, 3),)), (5, ((2, 0),))]
    + [
        (6, ((5, 0), (1, 4))),
        (6, ((1, 3), (2, 5))),
        (12, ((11, 0), (3, 8))),
        (16, ((15, 0), (4, 11))),
        (14, ((13, 0), (4, 10), (0, 6))),
        (9, ((0, 4), (4, 8), (2, 6))),
    ]
)


@pytest.mark.parametrize(
    "n,closures", GN_CASES, ids=[f"n{n}-{'ring' if c is None else c}" for n, c in GN_CASES]
)
def test_gn_step_is_the_dense_solve(n, closures):
    fam, edges, data, x0 = _graph(n, closures, 4, seed=n + 7 * len(closures or ()))
    x1 = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=1, ls_iterations=0)
    qp, _ = linearize_and_fill_qp(_problem_fn(n, edges), x0, torch.zeros(4, dtype=x0.dtype), data=data)
    dense = x0.numpy() + np.linalg.solve(qp.G.numpy(), -qp.c.numpy()[..., None])[..., 0]
    np.testing.assert_allclose(x1.numpy(), dense, rtol=0, atol=1e-12)


SOLVE_CASES = [(6, None), (8, None), (10, ((8, 3),)), (12, ((11, 0), (3, 8)))]


@pytest.mark.parametrize(
    "n,closures", SOLVE_CASES, ids=[f"n{n}-{'ring' if c is None else c}" for n, c in SOLVE_CASES]
)
def test_short_solve_equals_nls_solve(n, closures):
    fam, edges, data, x0 = _graph(n, closures, 6, seed=3)
    xk = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=2, ls_iterations=1)
    r = nls_solve(_problem_fn(n, edges), _general(2, 1), x0, data=data)
    np.testing.assert_allclose(xk.numpy(), r.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "n,closures", SOLVE_CASES[1:], ids=[f"n{n}-{'ring' if c is None else c}" for n, c in SOLVE_CASES[1:]]
)
def test_converged_solve_matches_nls_solve(n, closures):
    fam, edges, data, x0 = _graph(n, closures, 6, seed=5)
    xk, st = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=6, ls_iterations=2, return_state=True)
    r = nls_solve(_problem_fn(n, edges), _general(6, 2), x0, data=data)
    np.testing.assert_allclose(xk.numpy(), r.x.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(st[:, 0].numpy(), r.errors.f.numpy(), rtol=1e-3, atol=1e-8)
    assert (st[:, 0] <= r.errors.f + 1e-9).all()  # best-merit return never worse
    assert (st[:, 1] == 0).all() and (st[:, 2] == 0).all()
    assert (st[:, 0] < 2e-3 * n).all()  # the bench's noise gate


@pytest.mark.parametrize("closures", [None, ((15, 0), (4, 11))], ids=["ring", "two_closures"])
@pytest.mark.parametrize("poison", ["data", "x0"])
def test_nan_lane_is_flagged_and_contained(closures, poison):
    fam, _, data, x0 = _graph(16, closures, 8, seed=21)
    (data if poison == "data" else x0)[5, 4] = float("nan")
    x, st = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=3, ls_iterations=1, return_state=True)
    ok = torch.arange(8) != 5
    assert st[5, 2] >= 1  # the factorization flag fired
    assert (st[ok, 2] == 0).all() and torch.isfinite(x[ok]).all() and torch.isfinite(st[ok]).all()
    st_ok = port.fused_termination_status(st, f_tol=2e-3 * 16)
    assert int(st_ok[5]) == int(port.NLSTerminationState.QP_INDEFINITE)


@pytest.mark.parametrize("closures", [None, ((12, 4),), ((15, 0), (4, 11))], ids=["ring", "closure", "two_closures"])
def test_lanes_are_independent(closures):
    fam, _, data, x0 = _graph(16, closures, 9, seed=2)
    kw = dict(max_iterations=3, ls_iterations=2, return_state=True)
    x, st = pr.pose_ring_solve_batch(fam, data, x0, **kw)
    for lane in (0, 4, 8):
        xl, sl = pr.pose_ring_solve_batch(fam, data[lane:lane + 1], x0[lane:lane + 1], **kw)
        torch.testing.assert_close(xl[0], x[lane], rtol=0, atol=0)
        torch.testing.assert_close(sl[0], st[lane], rtol=0, atol=0)


@pytest.mark.parametrize("closures", [None, ((12, 4),), ((15, 0), (4, 11))], ids=["ring", "closure", "two_closures"])
def test_rings_entry_point_is_the_kernel_reshaped(closures):
    fam, _, data, x0 = _graph(16, closures, 4, seed=8)
    kw = dict(max_iterations=2, ls_iterations=1)
    x_k, st_k = pr.pose_ring_solve_batch(fam, data, x0, return_state=True, **kw)
    meas, starts = data.reshape(4, -1, 3), x0.reshape(4, 16, 3)
    x_w, st_w = pg.solve_pose_graph_rings(meas, starts, return_state=True, closures=closures, **kw)
    assert x_w.shape == (4, 16, 3)
    torch.testing.assert_close(x_w.reshape(4, 48), x_k, rtol=0, atol=0)
    torch.testing.assert_close(st_w, st_k, rtol=0, atol=0)
    x_only = pg.solve_pose_graph_rings(meas.numpy(), starts.numpy(), closures=closures, device="cpu", **kw)
    torch.testing.assert_close(x_only, x_w, rtol=0, atol=0)
    x_xla = pg.solve_pose_graph_rings(meas, starts, closures=closures, backend="xla", **kw)
    torch.testing.assert_close(x_xla, x_w, rtol=0, atol=0)


def test_ring_edges_and_family_fields():
    assert pg.ring_edges(4) == ((0, 1), (1, 2), (2, 3), (3, 0))
    fam = pr.pose_ring_family(12, closures=((11, 0), (3, 8)))
    assert fam.n_edges == 13 and fam.dim == 36 and fam.closure_list == ((11, 0), (3, 8))
    assert pr.pose_ring_family(12) is pr.pose_ring_family(12)  # cached
    assert pr.pose_ring_family(5).closure_list == ((4, 0),)
    assert pr.pose_ring_family(7, closure=(6, 2)).closure_list == ((6, 2),)


def test_convert_carries_the_family_and_batch():
    fields = dataclasses.asdict(pr.pose_ring_family(6, closures=((5, 0), (1, 4))))
    data, x0 = chain_closure_instances(3, 6, ((5, 0), (1, 4)), seed=1)
    fam, d_t, x_t = port.convert.pose_ring_from_numpy(
        fields, data.reshape(3, -1, 3), x0.reshape(3, 6, 3), device="cpu", dtype=torch.float32
    )
    assert fam == pr.pose_ring_family(6, closures=((5, 0), (1, 4)))
    assert d_t.shape == (3, 21) and x_t.shape == (3, 18) and d_t.dtype == torch.float32
    np.testing.assert_array_equal(d_t.numpy(), data.astype(np.float32))
    with pytest.raises(ValueError, match="expected measurements"):
        port.convert.pose_ring_from_numpy(fields, data.reshape(3, -1, 3)[:, 1:], x0.reshape(3, 6, 3), device="cpu")


@pytest.mark.parametrize(
    "kw", [dict(closure=(3, 3)), dict(closure=(2, 3)), dict(closure=(9, 0)), dict(closures=((4, 0), (2, 3))),
           dict(closure=(5, 0), closures=((5, 0), (1, 4)))],
    ids=["same_pose", "parallel", "out_of_range", "parallel_in_list", "both"],
)
def test_bad_closure_raises(kw):
    with pytest.raises(ValueError):
        pr.pose_ring_family(6, **kw)


def test_entry_point_checks():
    fam, _, data, x0 = _graph(6, None, 3, seed=0)
    with pytest.raises(ValueError, match="expected data"):
        pr.pose_ring_solve_batch(fam, data[:, 3:], x0)
    with pytest.raises(ValueError, match="backend"):
        pr.pose_ring_solve_batch(fam, data, x0, backend="mosaic")
    with pytest.raises(ValueError):
        pr.pose_ring_solve_batch(fam, data, x0, max_iterations=-1)
    with pytest.raises(TypeError):
        pr.pose_ring_solve_batch(fam, data.float(), x0)
    with pytest.raises(ValueError):
        pr.pose_ring_family(1)


def test_rings_entry_point_checks():
    _, _, data, x0 = _graph(6, None, 3, seed=0)
    meas, starts = data.reshape(3, 6, 3), x0.reshape(3, 6, 3)
    with pytest.raises(ValueError, match=r"measurements must have shape \(B, E, 3\)"):
        pg.solve_pose_graph_rings(data, starts)
    with pytest.raises(ValueError, match=r"x0 must have shape \(B, N, 3\)"):
        pg.solve_pose_graph_rings(meas, starts[:2])
    with pytest.raises(ValueError, match="measurements carry 6 edges; topology needs 7"):
        pg.solve_pose_graph_rings(meas, starts, closures=((5, 0), (1, 4)))
    with pytest.raises(ValueError, match="doubled edge"):
        pg.solve_pose_graph_rings(meas, starts, closures=((2, 3),))


def test_numpy_inputs_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, x0 = ring_instances(2, 5)
    fam = pr.pose_ring_family(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pr.pose_ring_solve_batch(fam, data, x0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pg.solve_pose_graph_rings(data.reshape(2, 5, 3), x0.reshape(2, 5, 3))
    before = pr.KERNEL_LAUNCHES
    x = pr.pose_ring_solve_batch(fam, data, x0, device="cpu", max_iterations=1, ls_iterations=0)
    assert x.device.type == "cpu" and x.shape == (2, 15) and pr.KERNEL_LAUNCHES == before


def test_retraction_wraps_headings_only():
    x = torch.tensor([3.0, -3.0, 3.0, 0.5, 0.5, -3.1], dtype=torch.float64)
    dx = torch.tensor([1.0, -1.0, 1.0, 0.0, 0.0, -1.0], dtype=torch.float64)
    out = pg.pose_graph_retraction(x, dx, 0.5)
    want = x + 0.5 * dx
    assert out[0] == want[0] and out[1] == want[1] and out[3] == want[3] and out[4] == want[4]
    assert -np.pi <= out[2] <= np.pi and -np.pi <= out[5] <= np.pi
    assert abs(float(out[2]) - (3.5 - 2 * np.pi)) < 1e-12


def test_solve_pose_graph_reaches_the_noise_floor():
    """The general path's own entry point: B starts of one ring, the
    default pose-graph parameters (LM from lambda 1e-4, Armijo 0.5)."""
    data, x0 = ring_instances(3, 6, seed=4)
    params = dataclasses.replace(pg.default_pose_graph_params(max_iterations=6), record_history=False)
    r = pg.solve_pose_graph(
        6, pg.ring_edges(6), torch.tensor(data[0].reshape(6, 3)), torch.ones(6, dtype=torch.float64),
        torch.tensor(x0), params=params,
    )
    assert r.x.shape == (3, 18) and torch.isfinite(r.x).all()
    assert (r.errors.f < 2e-3 * 6).all()


def test_float32_general_twin_keeps_its_dtype():
    """The general path differentiates the edge residual through the angle
    wrap; in float32 its Jacobians, and the solve, stay float32 (a Python
    scalar times floor's zero tangent comes out float64 under jacfwd, so
    ``so3.mod_pi`` detaches its whole turns)."""
    fam, edges, data, x0 = _graph(8, None, 4, seed=9)
    data, x0 = data.float(), x0.float()
    r = nls_solve(_problem_fn(8, edges), _general(2, 1), x0, data=data)
    xk = pr.pose_ring_solve_batch(fam, data, x0, max_iterations=2, ls_iterations=1)
    assert r.x.dtype == torch.float32 and xk.dtype == torch.float32
    np.testing.assert_allclose(xk.numpy(), r.x.numpy(), rtol=0, atol=1e-4)
