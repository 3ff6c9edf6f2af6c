"""The port's SE(2) pose-graph families (``models.pose_graph.
scalar_pose_graph_builder`` -> ``ops.fused_auto.family_from_problem``)
against the JAX package's, on the CPU in float64.

The same numpy instances (JAX's ``_pose_graph_instances`` distribution,
tests/test_pallas_blocked.py:327-351, and the N-gon ring of
``fused_pose_graph_bench`` at N = 4) go through both packages:

* the families' structure: sizes, bounds and the sparsity hints
  ``g_pattern`` / ``eq_patterns``, equal;
* ``linearize`` and ``errors`` called eagerly (no ``jit``) on JAX's
  ``(8, 128)`` register arrays and on the port's ``(1024,)`` tensors, at
  N = 4 (the square ring, the register tier) and N = 12 (the chain with the
  closure (2, 9), the blocked tier): tolerance 1e-12 abs, the same as
  test_torch_fused_auto.py's TOL_LINEARIZE (both accumulate in the same
  order; what remains is libm's sin/cos against XLA's);
* the blocked tier's whole solve on the N = 4 family, forced at D = 12:
  JAX's ``blocked_solve_batch`` (its Pallas kernel in interpret mode, this
  file's one interpret compile, about 5 s) against the port's plain
  ``blocked_solve_batch`` at B = 16 and 3/1/1 Mehrotra + Armijo: x and the
  cost to 1e-10 abs, the flags exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu as jx
import mini_opt_tpu_torch as port
from mini_opt_tpu.models import pose_graph as jax_pg
from mini_opt_tpu.ops import pallas_blocked as jax_blocked
from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges, ring_instances
from mini_opt_tpu_torch.models import pose_graph as pg

TOL_LINEARIZE = 1e-12
TOL_SOLVE = 1e-10
GRAPHS = {4: None, 12: ((2, 9),)}


def _graph(N, B, seed):
    """(edges, data (B, 3E), x0 (B, 3N)) as numpy float64."""
    if N == 4:
        return pg.ring_edges(4), *ring_instances(B, 4, seed=seed)
    closures = GRAPHS[N]
    return chain_edges(N, closures), *chain_closure_instances(B, N, closures, seed=seed, start_noise=0.1,
                                                               meas_noise=0.03)


@pytest.fixture(scope="module")
def families():
    out = {}
    for N in GRAPHS:
        edges, data, x = _graph(N, 1024, seed=N)
        out[N] = (jx.family_from_problem(jax_pg.scalar_pose_graph_builder(N, edges), 3 * len(edges)),
                  port.family_from_problem(pg.scalar_pose_graph_builder(N, edges), 3 * len(edges)),
                  data, x)
    return out


def _flat(out):
    """(f, r_eq, J_eq, G, c) -> list of arrays, in one fixed order."""
    f, r_eq, J_eq, G, c = out
    return [f, *r_eq, *(v for row in J_eq for v in row), *(v for row in G for v in row), *c]


@pytest.mark.parametrize("N", list(GRAPHS))
def test_structure_matches_jax(families, N):
    jf, pf, _, _ = families[N]
    assert (pf.n, pf.m_eq, pf.data_rows) == (jf.n, jf.m_eq, jf.data_rows) == (3 * N, 0, pf.data_rows)
    assert pf.lower == jf.lower and pf.upper == jf.upper
    assert pf.g_pattern == jf.g_pattern and pf.eq_patterns == jf.eq_patterns


@pytest.mark.parametrize("fn", ["linearize", "errors"])
@pytest.mark.parametrize("N", list(GRAPHS))
def test_generated_callables_match_jax(families, N, fn):
    jf, pf, data, x = families[N]
    x = x.copy()
    x[7] *= 3.0  # headings past +-pi, through mod_pi's floor
    j_x = [jnp.asarray(x[:, i].reshape(8, 128)) for i in range(jf.n)]
    j_d = [jnp.asarray(data[:, i].reshape(8, 128)) for i in range(jf.data_rows)]
    p_x = [torch.as_tensor(x[:, i]) for i in range(pf.n)]
    p_d = [torch.as_tensor(data[:, i]) for i in range(pf.data_rows)]
    if fn == "linearize":
        ref, got = _flat(jf.linearize(j_x, j_d)), _flat(pf.linearize(p_x, p_d))
    else:
        ref, got = list(jf.errors(j_x, j_d)), list(pf.errors(p_x, p_d))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1), rtol=0, atol=TOL_LINEARIZE)


def test_blocked_solve_matches_jax(families):
    """The blocked tier on the register-sized ring (D = 12): JAX's kernel in
    interpret mode against the port's plain version."""
    jf, pf, _, _ = families[4]
    _, data, x0 = _graph(4, 16, seed=21)
    kw = dict(max_iterations=3, qp_iterations=1, ls_iterations=1, barrier="mpc", line_search="armijo",
              return_state=True)
    ref_x, ref_state = (np.asarray(a) for a in jax_blocked.blocked_solve_batch(
        jf, jnp.asarray(data), jnp.asarray(x0), **kw))
    got_x, got_state = port.blocked_solve_batch(pf, data, x0, device="cpu", **kw)
    np.testing.assert_allclose(got_x.numpy(), ref_x, rtol=0, atol=TOL_SOLVE)
    np.testing.assert_allclose(got_state[:, :2].numpy(), ref_state[:, :2], rtol=0, atol=TOL_SOLVE)
    np.testing.assert_array_equal(got_state[:, 2].numpy(), ref_state[:, 2])
    assert (ref_state[:, 2] == 0).all() and float(np.abs(got_x.numpy() - x0).max()) > 1e-3
