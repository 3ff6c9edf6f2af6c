"""The PyTorch port's SE(2) pose-ring path held against the JAX package on
the CPU, in float64.

The JAX side is the JAX package's ``pose_ring_solve_batch`` with
``backend="xla"``, the kernel's register program under ``vmap``, as
tests/test_pallas_pose_ring.py runs it; the port side is the plain version
of kernel 7 (``ops/pose_ring.py::_pose_ring_plain``), reached through the
public entry point on CPU tensors. Both get the same seeded numpy instances
(``instances.ring_instances`` / ``chain_closure_instances``, copies of the
JAX repo's bench distributions) and the family carried across by
``convert.pose_ring_from_numpy``. Two solver compiles, no more (the XLA
compile of the ring body grows fast with N: about 13 s at N = 6, minutes at
N = 16):

* the canonical ring, N = 6, 6/2, with ``return_state``;
* the two-closure graph ((5, 0), (1, 4)), N = 6, 2/1 (four border poses,
  the dense 12 x 12 Schur system).

Tolerance: x and the state's cost within 1e-10, flags identical. The
compiled JAX program contracts a*b + c into FMAs on an FMA CPU and the port
does not, so the two do not agree bit for bit. The largest gaps seen: 5.9e-11
on x for the ring at 6/2 (the last iterations move along a flat valley of
the cost, where rounding differences grow) and 8.9e-16 at 2/1; 5e-17 on
the cost.

The edge residual and ``make_pose_graph_problem``'s residual values are
compared with JAX's evaluated eagerly (no solver compile). The tests marked
``cuda`` hold kernel 7 against its plain version on a card (B = 1037, the
three topologies of the slice, both types); they skip without one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges, ring_instances
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.ops import pose_ring as pr

N = 6
B = 16
TOL = 1e-10


def _jax():
    """jax.numpy and the JAX package's pose-graph modules, imported by the
    tests that use them: the card's machine, which runs the ``cuda`` tests
    below, has no jax."""
    return tuple(
        importlib.import_module(m)
        for m in ("jax.numpy", "mini_opt_tpu.models.pose_graph", "mini_opt_tpu.ops.pallas_pose_ring")
    )


def _both(jfam, data, x0, **kw):
    """JAX's xla route and the port's plain route on the same instances:
    ((x, state) JAX, (x, state) port) as numpy arrays."""
    jnp, _, jpr = _jax()
    xj, sj = jpr.pose_ring_solve_batch(
        jfam, jnp.asarray(data), jnp.asarray(x0), return_state=True, backend="xla", **kw
    )
    fam, d_t, x_t = port.convert.pose_ring_from_numpy(
        dataclasses.asdict(jfam),
        data.reshape(len(data), -1, 3), x0.reshape(len(x0), -1, 3), device="cpu",
    )
    assert fam.closure_list == jfam.closure_list and fam.n_edges == jfam.n_edges
    before = pr.KERNEL_LAUNCHES
    xp, sp = pr.pose_ring_solve_batch(fam, d_t, x_t, return_state=True, **kw)
    assert pr.KERNEL_LAUNCHES == before
    return (np.asarray(xj), np.asarray(sj)), (xp.numpy(), sp.numpy())


def _check(got, want):
    (xj, sj), (xp, sp) = want, got
    assert xp.shape == xj.shape and sp.shape == sj.shape
    np.testing.assert_allclose(xp, xj, rtol=0, atol=TOL)
    np.testing.assert_allclose(sp[:, :2], sj[:, :2], rtol=0, atol=TOL)
    np.testing.assert_array_equal(sp[:, 2], sj[:, 2])


def test_ring_n6_matches_jax():
    _, _, jpr = _jax()
    data, x0 = ring_instances(B, N, seed=4)
    data[3, 7] = np.nan  # a poisoned lane: flagged alike, neighbours untouched
    want, got = _both(jpr.pose_ring_family(N), data, x0, max_iterations=6, ls_iterations=2)
    _check(got, want)
    ok = np.arange(B) != 3
    assert (got[1][ok, 2] == 0).all() and got[1][3, 2] >= 1
    assert np.isfinite(got[0][ok]).all()


def test_two_closures_n6_matches_jax():
    _, _, jpr = _jax()
    closures = ((5, 0), (1, 4))
    data, x0 = chain_closure_instances(B, N, closures, seed=6, step=0.8, start_noise=0.1)
    want, got = _both(jpr.pose_ring_family(N, closures=closures), data, x0, max_iterations=2, ls_iterations=1)
    _check(got, want)


def test_edge_residual_matches_jax():
    jnp, jpg, _ = _jax()
    rng = np.random.default_rng(0)
    for _ in range(6):
        xl = rng.normal(0, 2.0, 6)
        row = np.concatenate([rng.normal(0, 1.5, 3), rng.uniform(0.5, 2.0, 3)])
        want = np.asarray(jpg._edge_residual(jnp.asarray(xl), jnp.asarray(row)))
        got = pg._edge_residual(torch.tensor(xl), torch.tensor(row)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize(
    "kw", [{}, dict(robust="huber", robust_delta=0.3), dict(hard_anchor=True)],
    ids=["soft_anchor", "huber", "hard_anchor"],
)
def test_pose_graph_problem_residuals_match_jax(kw):
    jnp, jpg, _ = _jax()
    closures = ((7, 2),)
    n = 8
    edges = chain_edges(n, closures)
    data, x0 = chain_closure_instances(1, n, closures, seed=2, start_noise=0.4)
    meas = data.reshape(-1, 3)
    weights = np.random.default_rng(1).uniform(0.5, 2.0, (len(edges), 3))
    jprob = jpg.make_pose_graph_problem(n, edges, jnp.asarray(meas), jnp.asarray(weights), anchor_weight=30.0, **kw)
    prob = pg.make_pose_graph_problem(
        n, edges, torch.tensor(meas), torch.tensor(weights), anchor_weight=30.0, **kw
    )
    x = x0[0] + 0.5  # off the true poses, and pose 0 off the origin
    np.testing.assert_allclose(
        prob.costs[0].error_vectors(torch.tensor(x)).numpy(),
        np.asarray(jprob.costs[0].error_vectors(jnp.asarray(x))), rtol=0, atol=1e-13,
    )
    anchor = (prob.equality_constraints if kw.get("hard_anchor") else prob.costs[1:])[0]
    janchor = (jprob.equality_constraints if kw.get("hard_anchor") else jprob.costs[1:])[0]
    np.testing.assert_allclose(
        anchor.error_vector(torch.tensor(x)).numpy(), np.asarray(janchor.error_vector(jnp.asarray(x))),
        rtol=0, atol=1e-13,
    )
    np.testing.assert_allclose(
        pg.pose_graph_retraction(torch.tensor(x), torch.tensor(x0[0]), 0.7).numpy(),
        np.asarray(jpg.pose_graph_retraction(jnp.asarray(x), jnp.asarray(x0[0]), 0.7)),
        rtol=0, atol=1e-14,
    )


# ---------------------------------------------------------------------------
# On the card: kernel 7 against its plain version (chip_smoke.py's pose-ring
# comparison at small B). The skip condition is a string, evaluated when
# each test is set up.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the pose-ring kernel has no CPU mode",
)

CARD_CASES = {
    "ring16": (16, None, 6, 2),
    "closure_12_4": (16, ((12, 4),), 5, 2),
    "closures_15_0_4_11": (16, ((15, 0), (4, 11)), 5, 2),
}


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(case, dtype):
    """Built without FMA contraction and running the plain version's
    operations in the same order, the kernel agrees with it bit for bit on
    the card, NaN lanes included."""
    n, closures, iters, ls = CARD_CASES[case]
    Bc = 1037
    if closures is None:
        fam = pr.pose_ring_family(n)
        data, x0 = ring_instances(Bc, n, seed=1)
    else:
        fam = pr.pose_ring_family(n, closures=closures)
        data, x0 = chain_closure_instances(Bc, n, closures, seed=1)
    data[5, 4] = np.nan
    x0[9, 2] = np.nan
    d_t, x_t = port.batch_from_numpy(data, x0, "cuda", dtype)
    before = pr.KERNEL_LAUNCHES
    got = pr._pose_ring_cuda(fam, d_t, x_t, iters, ls)
    torch.cuda.synchronize()
    assert pr.KERNEL_LAUNCHES == before + 1
    want = pr._pose_ring_plain(fam, d_t, x_t, iters, ls)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert (got[1][2, 5] >= 1) and (got[1][2, 9] >= 1)
