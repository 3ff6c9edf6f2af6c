"""The port's generated families (``mini_opt_tpu_torch.ops.fused_auto``)
against the JAX package's, on the CPU in float64.

The same numpy instances, from the bench's warm-start distribution, go
through both packages' ``family_from_problem``: the families' ``linearize``
and ``errors`` are called eagerly (no ``jit``) on JAX's ``(8, 128)``
register arrays and on the port's ``(1024,)`` tensors, for bench.py's
planar n = 2 builder, the spatial chain builder (target_dim 3) and the
BlockResidual chain of ``tests/test_fused_auto.py``. Tolerance 1e-12 abs:
both accumulate in the same order; what remains is libm's sin/cos against
XLA's.

The ``prox_weight`` rows of the chain builder are held the same way, and
the general-path builders (``make_spatial_ik_problem``,
``make_waypoint_ik_problem``) residual by residual, value and Jacobian.

Then the whole solve: ``fused_solve_batch`` on the generated planar family
at the bench budget (4/2/1, Mehrotra, Armijo), the JAX kernel in interpret
mode (this file's one interpret compile), at B = 61 with one NaN-target lane
and one NaN-start lane: x and state to 1e-9 abs, the flags exactly. What
remains there is libm against XLA and XLA's FMA contraction on the CPU,
carried through four iterations.

The serving wrappers (``fused_solve_multi_start``, ``fused_solve_refined``,
``fused_solve_proximal``, ``fused_chain_ik_solve``) are held against the JAX
package's own wrappers without another kernel compile: JAX's
``fused_solve_batch`` is replaced, for the test, by the port's plain version
on the same numbers, so both wrappers see the same solutions and what is
compared is theirs alone: the budget they pass, the stage data they build,
the merits and the lanes they pick. ``make_spatial_refine_fn`` and
``solve_ik_multi_start`` are held against the JAX package's jitted
``vmap(nls_solve)``, as ``test_torch_general.py`` holds ``solve_ik_batch``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mini_opt_tpu as jx
import mini_opt_tpu_torch as port
from mini_opt_tpu.models import ik as jax_ik
from mini_opt_tpu.ops import pallas_ik as jax_pallas_ik
from mini_opt_tpu.ops.pallas_ik import _mod_pi as jax_mod_pi
from mini_opt_tpu.residual import BlockResidual as JaxBlockResidual
from mini_opt_tpu_torch.instances import (
    block_chain_instances,
    block_chain_problem,
    planar_instances,
    spatial_instances,
)
from mini_opt_tpu_torch.ops._common import _mod_pi

TOL_LINEARIZE = 1e-12
TOL_SOLVE = 1e-9
TOL_GENERAL = 1e-8  # the general path's x against JAX's (test_torch_general.py's X_TOL)
PROX = 0.05
BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")


def _jax_block_chain_problem(data):
    """tests/test_fused_auto.py::_block_chain_builder."""
    diffs = jnp.stack([data[1], data[2], data[3]])[:, None]
    prods = jnp.stack([data[4], data[5]])[:, None]
    return jx.Problem(
        dimension=4,
        costs=(
            jx.make_residual([0], lambda p: jnp.stack([p[0] - data[0]]), 1),
            JaxBlockResidual(fn=lambda p, d: jnp.stack([p[1] - p[0] - d[0]]),
                             indices=((0, 1), (1, 2), (2, 3)), dim=1, data=diffs),
        ),
        equality_constraints=(
            JaxBlockResidual(fn=lambda p, d: jnp.stack([p[0] * p[1] - d[0]]),
                             indices=((0, 1), (2, 3)), dim=1, data=prods),
        ),
        inequality_constraints=(jx.Var(0) >= 0.1,),
    )


def _families(name):
    """(jax family, port family, data, x) on 1024 instances, float64."""
    if name == "planar2":
        data, x = planar_instances(1024, 2, seed=3)
        return (
            jx.family_from_problem(jax_ik.scalar_planar_ik_builder(2), 2,
                                   retract=lambda th: [jax_mod_pi(t) for t in th]),
            port.family_from_problem(port.models.ik.scalar_planar_ik_builder(2), 2,
                                     retract=lambda th: [_mod_pi(t) for t in th]),
            data, x,
        )
    if name == "spatial3_chain":
        data, x = spatial_instances(1024, 3, seed=4)
        jchain = jax_ik.make_spatial_chain(3, dtype=jnp.float64)
        pchain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
        return (
            jx.family_from_problem(jax_ik.scalar_chain_ik_builder(jchain, target_dim=3), 3),
            port.family_from_problem(port.scalar_chain_ik_builder(pchain, target_dim=3), 3),
            data, x,
        )
    if name == "spatial4_prox":
        targets, x = spatial_instances(1024, 4, seed=7)
        x_ref = x + np.random.default_rng(7).uniform(-0.1, 0.1, x.shape)
        jchain = jax_ik.make_spatial_chain(4, dtype=jnp.float64)
        pchain = port.make_spatial_chain(4, dtype=torch.float64, device="cpu")
        return (
            jx.family_from_problem(jax_ik.scalar_chain_ik_builder(jchain, target_dim=3, prox_weight=PROX), 7),
            port.family_from_problem(port.scalar_chain_ik_builder(pchain, target_dim=3, prox_weight=PROX), 7),
            np.concatenate([targets, x_ref], 1), x,
        )
    data, x = block_chain_instances(1024, seed=6)
    return (
        jx.family_from_problem(_jax_block_chain_problem, 6),
        port.family_from_problem(block_chain_problem, 6),
        data, x,
    )


FAMILIES = ["planar2", "spatial3_chain", "spatial4_prox", "block_chain"]


@pytest.fixture(scope="module")
def families():
    return {name: _families(name) for name in FAMILIES}


def _flat(out):
    """(f, r_eq, J_eq, G, c) -> list of arrays, in one fixed order."""
    f, r_eq, J_eq, G, c = out
    return [f, *r_eq, *(v for row in J_eq for v in row), *(v for row in G for v in row), *c]


@pytest.mark.parametrize("name", FAMILIES)
def test_structure_matches_jax(families, name):
    jf, pf, _, _ = families[name]
    assert (pf.n, pf.m_eq, pf.data_rows) == (jf.n, jf.m_eq, jf.data_rows)
    assert pf.lower == jf.lower and pf.upper == jf.upper
    assert pf.g_pattern == jf.g_pattern and pf.eq_patterns == jf.eq_patterns


@pytest.mark.parametrize("fn", ["linearize", "errors"])
@pytest.mark.parametrize("name", FAMILIES)
def test_generated_callables_match_jax(families, name, fn):
    jf, pf, data, x = families[name]
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


@pytest.fixture(scope="module")
def solved():
    """The generated planar family solved by both packages at B = 61."""
    data, x0 = planar_instances(61, 2, seed=5)
    data[7, 0] = np.nan
    x0[11, 1] = np.nan
    jf = jx.family_from_problem(jax_ik.scalar_planar_ik_builder(2), 2,
                                retract=lambda th: [jax_mod_pi(t) for t in th])
    pf = port.family_from_problem(port.models.ik.scalar_planar_ik_builder(2), 2,
                                  retract=lambda th: [_mod_pi(t) for t in th])
    jk = {k: v for k, v in BENCH.items()}
    ref = jx.fused_solve_batch(jf, jnp.asarray(data), jnp.asarray(x0), return_state=True, **jk)
    got = port.fused_solve_batch(pf, data, x0, return_state=True, device="cpu", **BENCH)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("output", ["x", "f_eq", "flags"])
def test_generated_solve_matches_jax(solved, output):
    (x_ref, s_ref), (x_got, s_got) = solved
    if output == "x":
        assert x_got.shape == x_ref.shape == (61, 2)
        np.testing.assert_allclose(x_got, x_ref, rtol=0, atol=TOL_SOLVE, equal_nan=True)
    elif output == "f_eq":
        np.testing.assert_allclose(s_got[:, :2], s_ref[:, :2], rtol=0, atol=TOL_SOLVE, equal_nan=True)
    else:
        np.testing.assert_array_equal(s_got[:, 2], s_ref[:, 2])
        assert s_got[7, 2] == s_ref[7, 2]  # the NaN-target lane's flags


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=tol)


def _general_problems(kind, t):
    """(jax problem, port problem) of a general-path IK builder: the
    spatial one for target t, the waypoint one (three random waypoints)."""
    jchain = jax_ik.make_spatial_chain(3, dtype=jnp.float64)
    pchain = port.make_spatial_chain(3, dtype=torch.float64, device="cpu")
    if kind == "spatial_ik":
        return (jax_ik.make_spatial_ik_problem(jchain, jnp.asarray(t)),
                port.make_spatial_ik_problem(pchain, torch.as_tensor(t)))
    rng = np.random.default_rng(11)
    offsets, targets, weights = rng.normal(0, 0.1, (3, 3)), rng.normal(0, 0.5, (3, 3)), rng.uniform(0.5, 2, 3)
    return (jax_ik.make_waypoint_ik_problem(jchain, *(jnp.asarray(a) for a in (offsets, targets, weights))),
            port.models.ik.make_waypoint_ik_problem(pchain, *(torch.as_tensor(a) for a in (offsets, targets,
                                                                                            weights))))


@pytest.mark.parametrize("kind", ["spatial_ik", "waypoint"])
def test_general_ik_problems_match_jax(kind):
    """Every residual's value and Jacobian, and every bound, of the port's
    builder against JAX's, eagerly at 1e-12 at two points."""
    targets, xs = spatial_instances(2, 3, seed=12)
    waypoints = _general_problems(kind, None) if kind == "waypoint" else None
    jitted = {}
    for t, x in zip(targets, xs):
        jp, pp = waypoints or _general_problems(kind, t)
        assert pp.dimension == jp.dimension
        for group in ("costs", "equality_constraints"):
            jres, pres = getattr(jp, group), getattr(pp, group)
            assert len(jres) == len(pres)
            for jr, pr in zip(jres, pres):
                if hasattr(jr, "errors_and_jacobians"):  # one compile, not one per eager op
                    fn = jitted.setdefault(id(jr), jax.jit(jr.errors_and_jacobians))
                    (je, jJ), (pe, pJ) = fn(jnp.asarray(x)), pr.errors_and_jacobians(torch.as_tensor(x))
                else:
                    (je, jJ), (pe, pJ) = jr.error_and_jacobian(jnp.asarray(x)), pr.error_and_jacobian(
                        torch.as_tensor(x))
                _close(pe, je, TOL_LINEARIZE)
                _close(pJ, jJ, TOL_LINEARIZE)
        jineq = [(c.variable, float(c.a), float(c.b)) for c in jp.inequality_constraints]
        pineq = [(c.variable, float(c.a), float(c.b)) for c in pp.inequality_constraints]
        assert pineq == jineq


class _PortKernel:
    """Stands in for JAX's ``fused_solve_batch``: the port's plain version
    of ``family`` on the same numbers. Records every call's data, starts
    and budget, as the port's own wrapper calls are recorded."""

    def __init__(self, family):
        self.family = family
        self.calls = []

    def __call__(self, jax_family, data, x0, **kw):
        pf = self.family
        assert (jax_family.n, jax_family.m_eq, jax_family.data_rows) == (pf.n, pf.m_eq, pf.data_rows)
        data, x0 = np.array(data), np.array(x0)  # writable copies of JAX's arrays
        self.calls.append((data, x0, kw))
        out = port.fused_solve_batch(pf, data, x0, device="cpu", **kw)
        if isinstance(out, tuple):
            return tuple(jnp.asarray(o.numpy()) for o in out)
        return jnp.asarray(out.numpy())


class _Recorder:
    """Wraps the port's ``fused_solve_batch`` and records its calls."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, family, data, x0, **kw):
        self.calls.append((np.asarray(data), np.asarray(x0), {k: v for k, v in kw.items() if k != "device"}))
        return self.fn(family, data, x0, **kw)


def _both(monkeypatch, pf, run_jax, run_port):
    """Run a wrapper in JAX (over the port's plain kernel) and in the port,
    recording each one's kernel calls."""
    from mini_opt_tpu_torch.ops import fused_ik as pfik

    jk = _PortKernel(pf)
    monkeypatch.setattr(jax_pallas_ik, "fused_solve_batch", jk)
    ref = np.asarray(run_jax())
    monkeypatch.undo()
    pk = _Recorder(pfik.fused_solve_batch)
    monkeypatch.setattr(pfik, "fused_solve_batch", pk)
    got = run_port().numpy()
    monkeypatch.undo()
    assert len(jk.calls) == len(pk.calls) > 0
    for (jd, jx0, jkw), (pd, px0, pkw) in zip(jk.calls, pk.calls):
        np.testing.assert_array_equal(pd, jd)  # the data each stage passes
        np.testing.assert_array_equal(px0, jx0)
        assert pkw == jkw
    return ref, got


def test_multi_start_matches_jax(families, monkeypatch):
    """The start each instance keeps, by the merit f + |eq|_1 of the family's
    own errors: JAX's pick and the port's, on the same solutions."""
    jf, pf, _, _ = families["planar2"]
    data, x0 = planar_instances(24, 2, seed=13)
    far = x0[:, None] + np.random.default_rng(13).uniform(-2.5, 2.5, (24, 3, 2))
    # (B, 4 starts, n): the good start at place b % 4 of instance b.
    x0s = np.stack([np.insert(far[b], b % 4, x0[b], axis=0) for b in range(24)])
    kw = dict(BENCH, max_iterations=1)  # one iteration: |eq|_1 still weighs in the merit
    ref, got = _both(monkeypatch, pf,
                     lambda: jax_pallas_ik.fused_solve_multi_start(jf, jnp.asarray(data), jnp.asarray(x0s), **kw),
                     lambda: port.fused_solve_multi_start(pf, data, x0s, device="cpu", **kw))
    np.testing.assert_array_equal(got, ref)
    # Not every instance keeps its first start: the pick is exercised.
    picked = np.array([np.flatnonzero((np.abs(port.fused_solve_batch(
        pf, np.repeat(data, 4, 0), x0s.reshape(-1, 2), device="cpu", **kw).numpy().reshape(24, 4, 2)[b]
        - got[b]) == 0).all(1))[0] for b in range(24)])
    assert len(set(picked.tolist())) > 1


def test_refined_matches_jax(families, monkeypatch):
    """The lanes fused_solve_refined re-solves (the refine_k of highest
    merit) and which refined answers it takes (a strictly better float64
    merit): JAX's and the port's, on the same solutions and the same
    refine_fn."""
    jf, pf, _, _ = families["planar2"]
    data, x0 = planar_instances(32, 2, seed=14)
    x0 = x0 + np.random.default_rng(14).uniform(-0.8, 0.8, x0.shape)
    strong = port.fused_solve_batch(pf, data, x0, device="cpu", **dict(BENCH, max_iterations=8)).numpy()
    lookup = {tuple(r): s for r, s in zip(np.round(data, 12), strong)}

    def refine_np(d, x):
        # The strong solve for targets right of x = 0.3, the start elsewhere,
        # so some picked lanes take the refined answer and some do not.
        best = np.stack([lookup[tuple(r)] for r in np.round(d, 12)])
        return np.where(d[:, :1] > 0.3, best, x)

    kw = dict(BENCH, max_iterations=1, refine_k=10)
    ref, got = _both(
        monkeypatch, pf,
        lambda: jax_pallas_ik.fused_solve_refined(
            jf, jnp.asarray(data), jnp.asarray(x0), lambda d, x: jnp.asarray(refine_np(np.asarray(d), np.asarray(x))),
            **kw),
        lambda: port.fused_solve_refined(
            pf, data, x0, lambda d, x: torch.as_tensor(refine_np(d.numpy(), x.numpy())), device="cpu", **kw))
    np.testing.assert_array_equal(got, ref)
    base = port.fused_solve_batch(pf, data, x0, device="cpu", **dict(BENCH, max_iterations=1)).numpy()
    changed = (got != base).any(1)
    assert 0 < int(changed.sum()) < 10


def test_proximal_matches_jax(families, monkeypatch):
    """Each proximal stage's data (the payload, then x_ref at the previous
    stage's result) and the result: JAX's and the port's."""
    jf, pf, data, x = families["spatial4_prox"]
    payload, x0 = data[:16, :3], x[:16]
    kw = dict(max_iterations=3, qp_iterations=2, ls_iterations=1, barrier="mpc")
    ref, got = _both(monkeypatch, pf,
                     lambda: jax_pallas_ik.fused_solve_proximal(jf, jnp.asarray(payload), jnp.asarray(x0), stages=3,
                                                               **kw),
                     lambda: port.fused_solve_proximal(pf, payload, x0, stages=3, device="cpu", **kw))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["spatial3", "spatial4_prox", "planar3"])
def test_fused_chain_ik_solve_matches_jax(case, monkeypatch):
    """fused_chain_ik_solve: the builder it caches per chain, the budget it
    derives from its default params (10/3/1, Mehrotra, Armijo), the target
    width it reads, and its proximal stages, against JAX's."""
    n, prox, stages = {"spatial3": (3, 0.0, 4), "spatial4_prox": (4, PROX, 2), "planar3": (3, 0.0, 4)}[case]
    if case.startswith("spatial"):
        targets, x0 = spatial_instances(12, n, seed=15)
        jchain = jax_ik.make_spatial_chain(n, dtype=jnp.float64)
        pchain = port.make_spatial_chain(n, dtype=torch.float64, device="cpu")
    else:
        targets, x0 = planar_instances(12, n, seed=15)
        jchain = jax_ik.make_planar_chain(n, dtype=jnp.float64)
        pchain = port.models.ik.make_planar_chain(n, dtype=torch.float64, device="cpu")
    td = targets.shape[1]
    pf = port.family_from_problem(port.scalar_chain_ik_builder(pchain, target_dim=td, prox_weight=prox),
                                  td + (n if prox else 0))
    ref, got = _both(
        monkeypatch, pf,
        lambda: jax_ik.fused_chain_ik_solve(jchain, jnp.asarray(targets), jnp.asarray(x0), prox_weight=prox,
                                            prox_stages=stages),
        lambda: port.fused_chain_ik_solve(pchain, targets, x0, prox_weight=prox, prox_stages=stages,
                                          device="cpu"))
    np.testing.assert_array_equal(got, ref)


def test_spatial_refine_fn_matches_jax():
    """make_spatial_refine_fn: the port's nls_solve under torch.func.vmap
    against JAX's jitted vmap(nls_solve), float64."""
    targets, x0 = spatial_instances(4, 3, seed=16)
    x0 = x0 + 0.2
    ref = jax.jit(jax_ik.make_spatial_refine_fn(3, max_iterations=6, qp_iterations=4))(
        jnp.asarray(targets), jnp.asarray(x0))
    got = port.models.ik.make_spatial_refine_fn(3, max_iterations=6, qp_iterations=4)(
        torch.as_tensor(targets), torch.as_tensor(x0))
    assert got.dtype == torch.float64
    _close(got.numpy(), ref, TOL_GENERAL)


def test_solve_ik_multi_start_matches_jax():
    """solve_ik_multi_start: the start kept and its result, against JAX's
    jitted one (the general path, float64)."""
    targets, x0 = planar_instances(4, 2, seed=17)
    x0s = np.stack([x0, x0 + 1.5, x0 - 1.0], 1)
    params = dataclasses.replace(jax_ik.default_ik_params(jnp.float64, max_iterations=6, max_qp_iterations=4),
                                 early_exit=False)
    ref = jax.jit(lambda t, x: jax_ik.solve_ik_multi_start(t, x, params=params))(jnp.asarray(targets),
                                                                                  jnp.asarray(x0s))
    got = port.solve_ik_multi_start(targets, x0s, params=port.params_from_dict(dataclasses.asdict(params)),
                                    device="cpu")
    _close(got.x.numpy(), ref.x, TOL_GENERAL)
    _close(got.errors.f.numpy(), ref.errors.f, 1e-12)
    _close(got.errors.equality.numpy(), ref.errors.equality, 1e-12)
