"""The rest of the port's general path held against the JAX package on the
CPU, in float64, with two JAX compiles:

* one ``jax.jit(jax.vmap(nls_solve))`` of the planar n = 2 IK at B = 16
  with ``parallel_line_search``, ``fuse_probe_linearize``,
  ``record_history`` and ``log_qp_eigenvalues`` (the JAX package's Pallas
  LDL^T route in interpret mode), against ``nls_solve`` of the port on the
  same seeded rows: x, statuses, the line-search history and the QP
  eigenvalues within 1e-12;
* one interpret-mode ``pallas_qp._fused_qp_batch`` at N = 3, K = 2, M = 4
  (kernel 6's new register instance), against the port's plain version,
  fused against fused (ROADMAP queue 3: the two packages' ``qp_ip_solve``
  run another Mehrotra schedule), within 1e-12.

Eagerly: ``compute_second_order_correction`` and ``build_full_kkt_system``
on tests/test_nonlinear.py:610-655's problem; the JSON document of the JAX
result against the port's, key for key, and each package loading the
other's files (JSON and npz); ``nls_result_to_string`` and
``summarize_counts`` of the same values giving the same text.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_opt_tpu import structs as jstructs
from mini_opt_tpu.models import ik as jik
from mini_opt_tpu.nonlinear import Problem as JProblem
from mini_opt_tpu.nonlinear import compute_second_order_correction as jsoc
from mini_opt_tpu.nonlinear import linearize_and_fill_qp as jlinearize
from mini_opt_tpu.nonlinear import nls_solve
from mini_opt_tpu.ops import pallas_qp
from mini_opt_tpu.qp import QP as JQP
from mini_opt_tpu.qp import build_full_kkt_system as jfull_kkt
from mini_opt_tpu.residual import make_residual as jmake_residual
from mini_opt_tpu.utils import serialization as jser

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch import nonlinear
from mini_opt_tpu_torch.instances import planar_instances
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.qp import QP
from mini_opt_tpu_torch.structs import tree_map
from mini_opt_tpu_torch.utils import serialization

TOL = 1e-12
B = 16


def _port_chain(chain):
    return port.chain_from_numpy(
        [np.asarray(l.rotation) for l in chain.links],
        [np.asarray(l.translation) for l in chain.links],
        [l.active for l in chain.links],
        rotation_xyz=[np.asarray(l.rotation_xyz) for l in chain.links],
        device="cpu",
    )


@pytest.fixture(scope="module")
def solved():
    targets, x0 = planar_instances(B, 2, seed=5)
    params = dataclasses.replace(
        jik.default_ik_params(jnp.float64, max_iterations=8, max_qp_iterations=6),
        max_line_search_iterations=3, kkt_solver="pallas_ldlt", early_exit=False, record_history=True,
        parallel_line_search=True, fuse_probe_linearize=True, log_qp_eigenvalues=True,
    )
    chain = jik.make_planar_chain(2, dtype=jnp.float64)

    def one(t, x):
        return nls_solve(jik.make_ik_problem(chain, t, True), params, x, retraction=jik.mod_pi_retraction)

    want = jax.jit(jax.vmap(one))(jnp.asarray(targets), jnp.asarray(x0))
    pchain = _port_chain(chain)
    got = port.nls_solve(
        lambda t: port.make_ik_problem(pchain, t), port.params_from_dict(dataclasses.asdict(params)),
        torch.as_tensor(x0), data=torch.as_tensor(targets), retraction=port.mod_pi_retraction,
    )
    return want, got


def test_parallel_fused_solve_matches_jax(solved):
    want, got = solved
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.termination_state.numpy(), np.asarray(want.termination_state))
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    th, jh = got.iterations, want.iterations
    np.testing.assert_array_equal(th.step_result.numpy(), np.asarray(jh.step_result))
    np.testing.assert_array_equal(th.line_search.num_steps.numpy(), np.asarray(jh.line_search.num_steps))
    for name in ("alpha", "f", "equality"):
        np.testing.assert_allclose(getattr(th.line_search, name).numpy(), np.asarray(getattr(jh.line_search, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    for name in ("min", "max", "abs_min"):
        t, j = getattr(th.qp_eigenvalues, name).numpy(), np.asarray(getattr(jh.qp_eigenvalues, name))
        assert t.shape == j.shape == (B, 8), name
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=name)
    assert bool(port.termination_state_indicates_satisfied_tol(got.termination_state).all())


def test_plain_fused_qp_matches_jax_at_n3_k2():
    rng = np.random.default_rng(32)
    Bq, N, K = 24, 3, 2
    R = rng.normal(size=(Bq, N, N))
    G = R @ R.transpose(0, 2, 1) / N + np.eye(N)
    c, A, b = rng.normal(size=(Bq, N)), rng.normal(size=(Bq, K, N)), rng.normal(size=(Bq, K)) * 0.1
    var = (1, 1, 2, 2)
    ia = np.tile([1.0, -1.0, 1.0, -1.0], (Bq, 1))
    ib = rng.uniform(1.0, 3.0, size=(Bq, 4))
    assert fq.qp_route(N, K, var) == "pairs"  # the register route's new K = 2 instance on the card
    # One compile: the Mehrotra schedule, which runs both solves a step.
    kw = dict(ineq_var=var, iterations=6, sigma=0.1, barrier="mpc", has_eq_guess=True)
    x_j, y_j = pallas_qp._fused_qp_batch(*(jnp.asarray(a) for a in (G, c, A, b, ia, ib)), **kw)
    x_t, y_t = fq._fused_qp_batch(*(torch.as_tensor(a) for a in (G, c, A, b, ia, ib)), **kw)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)


def test_second_order_correction_matches_jax():
    """tests/test_nonlinear.py:610-655's problem and bad step."""

    def eq_j(x):
        return jnp.stack([x[0] * x[0], x[1] * x[0] - x[2]])

    def eq_t(x):
        return torch.stack([x[0] * x[0], x[1] * x[0] - x[2]])

    x_lin = np.array([-0.5, 1.2, -0.5])
    jprob = JProblem(dimension=3, equality_constraints=(jmake_residual([0, 1, 2], eq_j, 2),))
    jqp, _ = jlinearize(jprob, jnp.asarray(x_lin), 0.0)
    dx0 = -np.linalg.pinv(np.asarray(jqp.A_eq)) @ np.asarray(jqp.b_eq)
    null = np.linalg.svd(np.asarray(jqp.A_eq))[2][-1]
    x_new = x_lin + dx0 + 5.334 * null
    want = np.asarray(jsoc(jprob, jqp, jnp.asarray(x_new)))

    tprob = port.Problem(dimension=3, equality_constraints=(port.make_residual([0, 1, 2], eq_t, 2),))
    tqp, _ = nonlinear.linearize_and_fill_qp(tprob, torch.as_tensor(x_lin)[None], torch.zeros(1, dtype=torch.float64))
    one = QP(G=tqp.G[0], c=tqp.c[0], A_eq=tqp.A_eq[0], b_eq=tqp.b_eq[0], ineq_var=tqp.ineq_var,
             ineq_a=tqp.ineq_a[0], ineq_b=tqp.ineq_b[0])
    got = port.compute_second_order_correction(tprob, one, torch.as_tensor(x_new))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # The correction reduces the re-evaluated constraint error.
    assert np.linalg.norm(eq_t(torch.as_tensor(x_new) + got).numpy()) < np.linalg.norm(eq_t(torch.as_tensor(x_new)).numpy())
    # Vmappable over a batch of stepped points.
    batch = torch.func.vmap(lambda x: port.compute_second_order_correction(tprob, one, x))(
        torch.as_tensor(x_new)[None].repeat(3, 1))
    np.testing.assert_allclose(batch.numpy(), np.repeat(want[None], 3, 0), rtol=0, atol=TOL)


def test_full_kkt_system_matches_jax():
    rng = np.random.default_rng(3)
    N, K, M = 3, 1, 2
    R = rng.normal(size=(N, N))
    arrays = dict(G=R @ R.T + np.eye(N), c=rng.normal(size=N), A_eq=rng.normal(size=(K, N)), b_eq=rng.normal(size=K),
                  ineq_a=np.array([1.0, -1.0]), ineq_b=np.array([0.5, 2.0]))
    var = np.array([1, 2])
    x, s, y, z = rng.normal(size=N), rng.uniform(0.5, 1.5, M), rng.normal(size=K), rng.uniform(0.5, 1.5, M)
    Hj, rj = jfull_kkt(JQP(ineq_var=jnp.asarray(var), **{k: jnp.asarray(v) for k, v in arrays.items()}),
                       *(jnp.asarray(v) for v in (x, s, y, z)))
    tq = QP(ineq_var=torch.as_tensor(var), **{k: torch.as_tensor(v) for k, v in arrays.items()})
    Ht, rt = port.build_full_kkt_system(tq, *(torch.as_tensor(v) for v in (x, s, y, z)))
    assert Ht.shape == (N + 2 * M + K,) * 2
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=TOL)


def _compare_docs(a, b, path="doc"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _compare_docs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _compare_docs(u, v, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, str):
        assert abs(a - b) <= TOL * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def test_json_documents_match_key_for_key(solved, tmp_path):
    want, got = solved
    for lane in (0, 7):
        jdoc = jser.nls_result_to_json(jax.tree.map(lambda a: a[lane], want))
        tdoc = serialization.nls_result_to_json(tree_map(lambda t: t[lane], got))
        _compare_docs(jdoc, tdoc)
    # Each package loads the other's file.
    jlane = jax.tree.map(lambda a: a[0], want)
    jser.save_result_json(str(tmp_path / "jax.json"), jlane)
    serialization.save_result_json(str(tmp_path / "port.json"), tree_map(lambda t: t[0], got))
    from_jax = serialization.load_result_json(str(tmp_path / "jax.json"), device="cpu")
    _compare_docs(serialization.nls_result_to_json(from_jax), json.loads((tmp_path / "jax.json").read_text()))
    from_port = jser.load_result_json(str(tmp_path / "port.json"))
    _compare_docs(jser.nls_result_to_json(from_port), json.loads((tmp_path / "port.json").read_text()))


def test_npz_files_cross_and_the_renderers_agree(solved, tmp_path):
    want, _ = solved
    jser.save_result_npz(str(tmp_path / "jax.npz"), want)
    batch = serialization.load_result_npz(str(tmp_path / "jax.npz"))
    jl, tl = jax.tree.leaves(want), []
    tree_map(lambda t: tl.append(t) or t, batch)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    serialization.save_result_npz(str(tmp_path / "port.npz"), batch)
    for j, t in zip(jl, jax.tree.leaves(jser.load_result_npz(str(tmp_path / "port.npz")))):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    # The same values render to the same text.
    assert port.summarize_counts(batch) == jstructs.summarize_counts(want)
    for lane in (0, 5):
        jlane = jax.tree.map(lambda a: a[lane], want)
        tlane = tree_map(lambda t: t[lane], batch)
        for kw in (dict(), dict(use_color=True, include_qp=True)):
            assert port.nls_result_to_string(tlane, **kw) == jstructs.nls_result_to_string(jlane, **kw)
