"""The PyTorch port's MPC path held against the JAX package on the CPU, in
float64.

The JAX side is the JAX package's ``fused_mpc_solve_batch`` and
``fused_mpc_servo_batch`` with ``backend="xla"``, the kernels' register
programs under ``vmap``, as tests/test_pallas_mpc.py runs them; the port
side is the plain version of kernel 8 and kernel 9 (``ops/mpc.py``),
reached through the public entry points on CPU tensors. Both get the same
seeded numpy instances (``instances.cartpole_mpc_instances``, a copy of the
JAX repo's bench fleet) and the family carried across by
``convert.mpc_family_from_numpy``. Two solver compiles, no more, at the JAX
tests' own size (cart-pole, T = 3, B = 16: the XLA compile of the stage
body grows fast with T, about 30 s at T = 3 and minutes at T = 8):

* ``fused_mpc_solve_batch`` at 3/3/2 with ``return_state``;
* ``fused_mpc_servo_batch`` at 1/1/1 for 3 periods.

Tolerance 1e-9, flags identical. The compiled JAX program contracts
a*b + c into FMAs on an FMA CPU and the port does not, so the two do not
agree bit for bit; the largest gaps seen are 2.7e-15 on z and 8.9e-16 on
the cost after the solve, 1.8e-15 after the servo.

The plant, the transcription's residuals and the warm-start helpers are
compared with JAX's evaluated eagerly (no solver compile). The tests marked
``cuda`` hold kernels 8 and 9 against their plain versions on a card at the
bench's widths (T = 20 cart-pole, T = 12 quadrotor); they skip without
one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch.instances import cartpole_mpc_instances, quadrotor_mpc_instances
from mini_opt_tpu_torch.models import mpc
from mini_opt_tpu_torch.ops import mpc as pm

T, DT, B = 3, 0.05, 16
TOL = 1e-9
SOLVE_BUDGET = (3, 3, 2)
SERVO_PERIODS = 3


def _jax():
    """jax.numpy and the JAX package's MPC modules, imported by the tests
    that use them: the card's machine, which runs the ``cuda`` tests below,
    has no jax."""
    return tuple(
        importlib.import_module(m) for m in ("jax.numpy", "mini_opt_tpu.models.mpc", "mini_opt_tpu.ops.pallas_mpc")
    )


def _fleet():
    x0 = cartpole_mpc_instances(B, seed=3)
    z0 = np.concatenate([np.zeros((B, T)), np.tile(x0, T)], axis=1)
    return x0, z0


@pytest.fixture(scope="module")
def solved():
    """((z, state) JAX, (z, state) port) for one fleet at 3/3/2."""
    jnp, _, jpm = _jax()
    x0, z0 = _fleet()
    jfam = jpm.cartpole_mpc_family(T, DT)
    zj, sj = jpm.fused_mpc_solve_batch(
        jfam, jnp.asarray(x0), jnp.asarray(z0), *SOLVE_BUDGET, return_state=True, backend="xla"
    )
    fam = port.convert.mpc_family_from_numpy("cartpole", T, DT)
    before = pm.KERNEL_LAUNCHES
    zp, sp = port.fused_mpc_solve_batch(fam, x0, z0, *SOLVE_BUDGET, return_state=True, device="cpu")
    assert pm.KERNEL_LAUNCHES == before
    return (np.asarray(zj), np.asarray(sj)), (zp.numpy(), sp.numpy())


@pytest.fixture(scope="module")
def served():
    """((x, z, stats) JAX, (x, z, stats) port) after 3 servo periods."""
    jnp, _, jpm = _jax()
    x0, z0 = _fleet()
    jfam = jpm.cartpole_mpc_family(T, DT)
    outs_j = jpm.fused_mpc_servo_batch(jfam, jnp.asarray(x0), jnp.asarray(z0), SERVO_PERIODS, 1, 1, 1, backend="xla")
    fam = port.convert.mpc_family_from_numpy("cartpole", T, DT)
    before = pm.SERVO_LAUNCHES
    outs_p = port.fused_mpc_servo_batch(fam, x0, z0, SERVO_PERIODS, 1, 1, 1, device="cpu")
    assert pm.SERVO_LAUNCHES == before
    return tuple(np.asarray(a) for a in outs_j), tuple(t.numpy() for t in outs_p)


def test_solve_trajectories_match_jax(solved):
    (zj, _), (zp, _) = solved
    assert zp.shape == zj.shape == (B, T * 5)
    np.testing.assert_allclose(zp, zj, rtol=0, atol=TOL)


def test_solve_costs_match_jax(solved):
    (_, sj), (_, sp) = solved
    np.testing.assert_allclose(sp[:, :2], sj[:, :2], rtol=0, atol=TOL)


def test_solve_flags_match_jax(solved):
    (_, sj), (_, sp) = solved
    np.testing.assert_array_equal(sp[:, 2], sj[:, 2])


@pytest.mark.parametrize("output", ["x", "z", "stats"])
def test_servo_matches_jax(served, output):
    k = ("x", "z", "stats").index(output)
    got, want = served[1][k], served[0][k]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_family_fields_match_jax():
    _, _, jpm = _jax()
    for kind, jf in (("cartpole", jpm.cartpole_mpc_family(7, 0.04, u_max=6.0, r_u=0.02)),
                     ("quadrotor", jpm.quadrotor_mpc_family(7, 0.04, u_max=5.0, mass=0.6))):
        consts = dict(u_max=6.0, r_u=0.02) if kind == "cartpole" else dict(u_max=5.0, mass=0.6)
        pf = port.convert.mpc_family_from_numpy(kind, 7, 0.04, **consts)
        for f in ("horizon", "dt", "nx", "nu", "q", "q_terminal", "r_u", "goal", "u_ref", "u_min", "u_max"):
            assert getattr(pf, f) == getattr(jf, f), f
        assert pf.dim == jf.dim


@pytest.mark.parametrize("kind", ["cartpole", "quadrotor"])
def test_plant_step_matches_jax(kind):
    """One RK4 plant step of each family, eagerly, on the same states."""
    jnp, jmpc, jpm = _jax()
    rng = np.random.default_rng(4)
    jf = jpm.cartpole_mpc_family(T, DT) if kind == "cartpole" else jpm.quadrotor_mpc_family(T, DT)
    pf = port.convert.mpc_family_from_numpy(kind, T, DT)
    x = rng.uniform(-0.5, 0.5, (5, pf.nx))
    u = rng.uniform(-1.0, 3.0, (5, pf.nu))
    want = np.stack([np.asarray(jmpc.family_rk4_step(jf, jnp.asarray(x[i]), jnp.asarray(u[i]))) for i in range(5)])
    got = mpc.family_rk4_step(pf, torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_cartpole_helpers_match_jax():
    """rk4_step, initial_guess and shift_warm_start of models/mpc.py,
    eagerly."""
    jnp, jmpc, _ = _jax()
    cpj = jmpc.CartPole()
    x0, z0 = _fleet()
    rng = np.random.default_rng(5)
    z = z0 + rng.normal(scale=0.1, size=z0.shape)
    for i in range(3):
        np.testing.assert_allclose(
            mpc.rk4_step(mpc.CartPole(), torch.as_tensor(x0[i]), torch.tensor(0.7, dtype=torch.float64), DT).numpy(),
            np.asarray(jmpc.rk4_step(cpj, jnp.asarray(x0[i]), jnp.asarray(0.7), DT)), rtol=0, atol=1e-14)
        np.testing.assert_array_equal(
            mpc.initial_guess(mpc.CartPole(), torch.as_tensor(x0[i]), T, DT).numpy(),
            np.asarray(jmpc.initial_guess(cpj, jnp.asarray(x0[i]), T, DT)))
        np.testing.assert_allclose(
            mpc.shift_warm_start(mpc.CartPole(), torch.as_tensor(z[i]), T, DT).numpy(),
            np.asarray(jmpc.shift_warm_start(cpj, jnp.asarray(z[i]), T, DT)), rtol=0, atol=1e-14)


def test_transcription_residuals_match_jax():
    """make_cartpole_mpc_problem's defect, tracking and effort residuals at
    a point, eagerly, and its box rows."""
    jnp, jmpc, _ = _jax()
    x0, z0 = _fleet()
    rng = np.random.default_rng(6)
    z = z0[0] + rng.normal(scale=0.1, size=z0.shape[1])
    pj = jmpc.make_cartpole_mpc_problem(jmpc.CartPole(), jnp.asarray(x0[0]), T, DT)
    pp = mpc.make_cartpole_mpc_problem(mpc.CartPole(), torch.as_tensor(x0[0]), T, DT)
    zj, zt = jnp.asarray(z), torch.as_tensor(z)
    for cj, cpp in zip(pj.equality_constraints, pp.equality_constraints):
        assert cj.index == cpp.index
        np.testing.assert_allclose(cpp.error_vector(zt).numpy(), np.asarray(cj.error_vector(zj)), rtol=0, atol=1e-14)
    np.testing.assert_allclose(pp.costs[0].error_vectors(zt).numpy(), np.asarray(pj.costs[0].error_vectors(zj)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(pp.costs[1].error_vector(zt).numpy(), np.asarray(pj.costs[1].error_vector(zj)),
                               rtol=0, atol=1e-14)
    assert [(c.variable, c.a, c.b) for c in pp.inequality_constraints] == [
        (c.variable, c.a, c.b) for c in pj.inequality_constraints
    ]


# ---------------------------------------------------------------------------
# On the card: kernels 8 and 9 against their plain versions at the bench's
# widths. The skip condition is a string, so pytest evaluates it when each
# test is set up, not while the module is imported.
# ---------------------------------------------------------------------------

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the MPC kernels have no CPU mode",
)


# The global-scratch horizons: one float64 slab there exceeds a CTA's
# 232,448 bytes of shared memory (the float32 one runs one warp per CTA).
SLAB_T = {"cartpole": 240, "quadrotor": 128}


def _card_fleet(kind, dtype, B=300, T=None):
    if kind == "cartpole":
        fam, x = pm.cartpole_mpc_family(T or 20, DT), cartpole_mpc_instances(B, 1)
    else:
        fam, x = pm.quadrotor_mpc_family(T or 12, DT), quadrotor_mpc_instances(B, 1)
    z = mpc.family_initial_guess(fam, torch.as_tensor(x)).numpy()
    if B > 9:
        x[5, 2] = np.nan
        z[9, 1] = np.nan
    return (fam,) + port.batch_from_numpy(x, z, "cuda", dtype)


def _width(kind, dtype, width):
    """The fleet's size: 300 lanes with two NaN lanes, one instance, or one
    more than a CTA's warps (a ragged last CTA)."""
    fam = (pm.cartpole_mpc_family if kind == "cartpole" else pm.quadrotor_mpc_family)(20 if kind == "cartpole" else 12, DT)
    return {"fleet": 300, "one": 1, "ragged": pm.launch_plan(fam, 1, dtype).warps + 1}[width]


def _same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("width", ["fleet", "one", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["cartpole", "quadrotor"])
def test_solve_kernel_matches_plain_on_card(kind, dtype, width):
    """Kernel 8 is built without FMA contraction and runs the plain
    version's operations in the same order: bit for bit, NaN lanes
    included."""
    fam, x_t, z_t = _card_fleet(kind, dtype, _width(kind, dtype, width))
    before = pm.KERNEL_LAUNCHES
    got = pm._mpc_cuda(fam, x_t, z_t, 8, 3, 2, True)
    torch.cuda.synchronize()
    assert pm.KERNEL_LAUNCHES == before + 1
    _same(got, pm._mpc_plain(fam, x_t, z_t, 8, 3, 2, True))


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("width", ["fleet", "one", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["cartpole", "quadrotor"])
def test_servo_kernel_matches_plain_on_card(kind, dtype, width):
    fam, x_t, z_t = _card_fleet(kind, dtype, _width(kind, dtype, width))
    before = pm.SERVO_LAUNCHES
    got = pm._mpc_servo_cuda(fam, x_t, z_t, 4, 1, 1, 1)
    torch.cuda.synchronize()
    assert pm.SERVO_LAUNCHES == before + 1
    _same(got, pm._mpc_servo_plain(fam, x_t, z_t, 4, 1, 1, 1))


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["cartpole", "quadrotor"])
def test_kernels_match_plain_at_the_global_scratch_horizon(kind, dtype):
    """Past one CTA's shared memory the same kernel code runs on a global
    scratch slab (float64 here); float32 fits one warp per CTA."""
    fam, x_t, z_t = _card_fleet(kind, dtype, 67, SLAB_T[kind])
    plan = pm.launch_plan(fam, 67, dtype)
    assert (plan.storage, plan.warps) == (("global", 4) if dtype == torch.float64 else ("shared", 1))
    got = pm._mpc_cuda(fam, x_t, z_t, 1, 1, 1)
    torch.cuda.synchronize()
    _same(got, pm._mpc_plain(fam, x_t, z_t, 1, 1, 1))
    got = pm._mpc_servo_cuda(fam, x_t, z_t, 2, 1, 1, 1)
    torch.cuda.synchronize()
    _same(got, pm._mpc_servo_plain(fam, x_t, z_t, 2, 1, 1, 1))


@pytest.mark.cuda
@needs_cuda
def test_refused_launch_raises(monkeypatch):
    """Eight float32 quadrotor slabs at T = 128 exceed a CTA's shared
    memory: the launcher refuses and the wrapper raises; nothing runs the
    plain version instead."""
    fam, x_t, z_t = _card_fleet("quadrotor", torch.float32, 16, 128)
    plan = pm.launch_plan(fam, 16, torch.float32)
    monkeypatch.setattr(pm, "launch_plan", lambda *a: dataclasses.replace(plan, warps=8, grid=2))
    before = pm.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="does not fit"):
        pm._mpc_cuda(fam, x_t, z_t, 1, 1, 1)
    assert pm.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@needs_cuda
def test_general_twin_runs_on_card():
    """solve_mpc batched through nls_solve on the Riccati backend, float32,
    on CUDA tensors: finite, on the device, and within the kernel's cost."""
    x0 = torch.as_tensor(cartpole_mpc_instances(64, 2), dtype=torch.float32, device="cuda")
    params = dataclasses.replace(mpc.default_mpc_params(torch.float32, early_exit=False, horizon=20),
                                 max_iterations=2, max_qp_iterations=2, max_line_search_iterations=1)
    res = mpc.solve_mpc(mpc.CartPole(), x0, 20, DT, params=params)
    assert res.x.is_cuda and res.x.dtype == torch.float32 and torch.isfinite(res.x).all()
