"""The PyTorch port's general batched SQP path held against the JAX package
on the CPU, in float64.

The JAX side is the JAX package's own ``jax.vmap(nls_solve)`` on
``make_ik_problem``, exactly as ``bench.py --general`` builds it, with its
Pallas kernels in interpret mode as tests/test_pallas_ldlt.py and
tests/test_pallas_qp.py run them. The port side is
``mini_opt_tpu_torch.solve_ik_batch`` on the same seeded instances
(``instances.planar_instances``, the numpy copy of ``bench.make_instances``),
with the chain and the ``NLSParams`` carried across by ``convert``. Three
solver compiles, no more (each costs 8-13 s here):

* planar n = 2, 10/6/2, ``kkt_solver="pallas_ldlt"``, complementarity,
  Armijo, the ``--general`` throughput configuration (no history, fixed
  trips);
* planar n = 2, ``qp_solver="pallas_fused"`` with the Mehrotra barrier;
* planar n = 4, ``pallas_ldlt``, polynomial line search, history recorded,
  the default early exit; its history rows are compared too.

Tolerances: x within 1e-8, termination state and iteration count equal per
lane, f and |eq|_1 within 1e-12 (the two packages round differently in
their sums, e.g. XLA contracts a*b + c into FMAs on this host; the largest
gaps seen were 3e-11 on x and 7e-16 on |eq|_1).

Module level: the port's plain LDL^T factor and solve (kernels 4 and 5)
against the JAX package's ``_batched_factorize`` / ``_batched_solve`` at
D in {3, 7, 12} to 1e-12, and the plain fused QP (kernel 6) against
``_fused_qp_batch`` on QPs from the port's own linearization of bench
instances at n = 2, both barriers, to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini_opt_tpu.models import ik as jik
from mini_opt_tpu.nonlinear import nls_solve
from mini_opt_tpu.ops import pallas_ldlt, pallas_qp
from mini_opt_tpu.structs import BarrierStrategy, LineSearchStrategy

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import effector_error, planar_instances
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.ops import ldlt

X_TOL = 1e-8
ERR_TOL = 1e-12
B = 32
FIXED = dict(record_history=False, early_exit=False)
CASES = {
    "n2_pallas_ldlt_armijo": (2, dict(kkt_solver="pallas_ldlt", **FIXED)),
    "n2_pallas_fused_mpc": (
        2,
        dict(qp_solver="pallas_fused", qp_barrier_strategy=BarrierStrategy.PREDICTOR_CORRECTOR, **FIXED),
    ),
    "n4_pallas_ldlt_polynomial_history": (
        4,
        dict(kkt_solver="pallas_ldlt", line_search_strategy=LineSearchStrategy.POLYNOMIAL_APPROXIMATION),
    ),
}


def _port_chain(chain):
    return port.chain_from_numpy(
        [np.asarray(l.rotation) for l in chain.links],
        [np.asarray(l.translation) for l in chain.links],
        [l.active for l in chain.links],
        rotation_xyz=[np.asarray(l.rotation_xyz) for l in chain.links],
        device="cpu",
    )


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    n, overrides = CASES[request.param]
    targets, x0 = planar_instances(B, n, seed=n)
    params = dataclasses.replace(
        jik.default_ik_params(jnp.float64, max_iterations=10, max_qp_iterations=6),
        max_line_search_iterations=2,
        **overrides,
    )
    chain = jik.make_planar_chain(n, dtype=jnp.float64)

    def one(t, x):
        return nls_solve(jik.make_ik_problem(chain, t, True), params, x, retraction=jik.mod_pi_retraction)

    want = jax.jit(jax.vmap(one))(jnp.asarray(targets), jnp.asarray(x0))
    before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES, fq.FUSED_QP_LAUNCHES)
    got = port.solve_ik_batch(
        targets, x0, chain=_port_chain(chain),
        params=port.params_from_dict(dataclasses.asdict(params)), device="cpu",
    )
    # CPU tensors run the plain versions: no kernel launch.
    assert (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES, fq.FUSED_QP_LAUNCHES) == before
    return request.param, want, got


def test_solution_matches_jax(solved):
    _, want, got = solved
    assert got.x.shape == (B, want.x.shape[1]) and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=X_TOL)


def test_termination_and_errors_match_jax(solved):
    name, want, got = solved
    np.testing.assert_array_equal(got.termination_state.numpy(), np.asarray(want.termination_state))
    np.testing.assert_array_equal(got.num_iterations.numpy(), np.asarray(want.num_iterations))
    np.testing.assert_array_equal(got.solver_variant.numpy(), np.asarray(want.solver_variant))
    np.testing.assert_allclose(got.errors.f.numpy(), np.asarray(want.errors.f), rtol=0, atol=ERR_TOL)
    np.testing.assert_allclose(
        got.errors.equality.numpy(), np.asarray(want.errors.equality), rtol=0, atol=ERR_TOL
    )
    # Every lane reaches its target (effector error below bench.py's parity
    # threshold of 1e-3), as the JAX package's does; at n = 4 some lanes end
    # on the iteration cap, in both packages alike.
    targets, _ = planar_instances(B, CASES[name][0], seed=CASES[name][0])
    assert (effector_error("planar", got.x.numpy(), targets) < 1e-3).all()


def test_history_matches_jax(solved):
    name, want, got = solved
    jh, th = want.iterations, got.iterations
    if name != "n4_pallas_ldlt_polynomial_history":
        assert th.lam.shape == np.asarray(jh.lam).shape == (B, 0)
        return
    exact = ["optimizer_state", "step_result", "qp_termination_state", "qp_num_iterations"]
    for field in exact:
        np.testing.assert_array_equal(getattr(th, field).numpy(), np.asarray(getattr(jh, field)), err_msg=field)
    np.testing.assert_array_equal(th.line_search.num_steps.numpy(), np.asarray(jh.line_search.num_steps))
    pairs = {
        "lam": (th.lam, jh.lam),
        "penalty": (th.penalty, jh.penalty),
        "f": (th.errors_initial.f, jh.errors_initial.f),
        "d_f": (th.directional_derivatives.d_f, jh.directional_derivatives.d_f),
        "qp_kkt_final_max": (th.qp_kkt_final_max, jh.qp_kkt_final_max),
        "ls_alpha": (th.line_search.alpha, jh.line_search.alpha),
        "ls_f": (th.line_search.f, jh.line_search.f),
        "qp_mu": (th.qp_iterations.mu, jh.qp_iterations.mu),
        "qp_alpha": (th.qp_iterations.alpha.primal, jh.qp_iterations.alpha.primal),
        "qp_kkt_dual": (th.qp_iterations.kkt_final.r_dual, jh.qp_iterations.kkt_final.r_dual),
    }
    for key, (t, j) in pairs.items():
        assert t.shape == np.asarray(j).shape, key
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-8, atol=X_TOL, err_msg=key)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX package's batched kernels.
# ---------------------------------------------------------------------------


def _kkt_batch(rng, Bk, D, K):
    """Quasi-definite condensed KKT systems [[G_pd, A^T], [A, 0]], one NaN
    lane and one singular lane."""
    N = D - K
    A = rng.normal(size=(Bk, N, N))
    H = np.zeros((Bk, D, D))
    H[:, :N, :N] = A @ A.transpose(0, 2, 1) / N + 0.5 * np.eye(N)
    H[:, N:, :N] = rng.normal(size=(Bk, K, N))
    H[:, :N, N:] = H[:, N:, :N].transpose(0, 2, 1)
    H[3] = np.nan
    H[5] = 0.0
    return H


@pytest.mark.parametrize("D", [3, 7, 12])
def test_plain_ldlt_matches_jax_kernels(D):
    rng = np.random.default_rng(D)
    H = _kkt_batch(rng, 40, D, max(1, D // 4))
    rhs = rng.normal(size=(40, D))
    L_j, d_j, ok_j = pallas_ldlt._batched_factorize(jnp.asarray(H))
    x_j = pallas_ldlt._batched_solve(L_j, d_j, jnp.asarray(rhs))
    L_t, d_t, ok_t = ldlt._batched_factorize(torch.as_tensor(H))
    x_t = ldlt._batched_solve(L_t, d_t, torch.as_tensor(rhs))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not ok_t[3] and not ok_t[5] and bool(ok_t[:3].all())
    good = np.asarray(ok_j)
    for got, want in ((L_t, L_j), (d_t, d_j), (x_t, x_j)):
        np.testing.assert_allclose(got.numpy()[good], np.asarray(want)[good], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("barrier", ["complementarity", "mpc"])
def test_plain_fused_qp_matches_jax_kernel(barrier):
    """IK-shaped QPs (N = 2, one equality row, [0, pi] bounds on joint 1)
    from the port's linearization of bench instances."""
    targets, x0 = planar_instances(48, 2, seed=11)
    chain = port.make_planar_chain(2, dtype=torch.float64, device="cpu")
    lam = torch.full((48,), 1e-3, dtype=torch.float64)
    qp, _ = port.nonlinear.linearize_and_fill_qp(
        lambda t: port.make_ik_problem(chain, t), torch.as_tensor(x0), lam, data=torch.as_tensor(targets)
    )
    var = tuple(int(v) for v in qp.ineq_var)
    assert var == (1, 1)
    kw = dict(ineq_var=var, iterations=6, sigma=0.1, barrier=barrier, has_eq_guess=True)
    args = (qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b)
    x_j, y_j = pallas_qp._fused_qp_batch(*(jnp.asarray(a.numpy()) for a in args), **kw)
    x_t, y_t = fq._fused_qp_batch(*args, **kw)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-10)
