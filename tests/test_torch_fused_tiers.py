"""The register tier's two kernels, 6 (the fused QP interior point,
``ops/fused_qp.py``) and 1 (the fused IK SQP, ``ops/fused_ik.py``), on the
CPU: their batch-major wrappers against the plain versions on
feature-major copies, kernel 6's route chooser and the wrappers' argument
checks. No JAX; every case takes well under a second.

* ``_fused_qp_batch`` on strided batch-major CPU tensors (G stored
  transposed, c and b every other column of a wider tensor, ia a stride-0
  broadcast, ib transposed storage) equals ``_fused_qp_plain`` on
  contiguous feature-major copies bit for bit, at N = 2..8, K = 0 and 1,
  both barriers, on box rows M = 0, the general path's pairs, repeated
  variables and 2N rows.
* ``qp_route``: on the register route "pairs" exactly for ``pair_rows(N)``
  and "any" for every other row pattern; "warp" past the register caps
  (``REGISTER_MAX_N``) or past 2N rows; a raise for a variable out of
  range, at every N and K around the caps.
* The CUDA wrappers raise on CPU tensors, wrong shapes, dtypes and
  out-of-range rows before touching a device.
* ``fused_ik_solve_batch`` on strided batch-major CPU tensors equals the
  plain version on contiguous feature-major copies bit for bit, history
  and state included.
"""

import numpy as np
import pytest
import torch

import mini_opt_tpu_torch as port
from mini_opt_tpu_torch import convert
from mini_opt_tpu_torch.instances import planar_instances, spatial_instances
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import fused_qp as fq

B = 9


def _qps(N, K, M, seed):
    """B convex QPs with N variables, K equality rows and M box-row
    coefficient columns, batch-major numpy, one NaN lane; garbage above G's
    diagonal (only its lower triangle is read)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, N, N))
    G = J @ J.transpose(0, 2, 1) / N + 1e-2 * np.eye(N) + np.triu(rng.normal(size=(B, N, N)), 1)
    c = rng.normal(size=(B, N)) * 0.3
    A = rng.normal(size=(B, K, N))
    b = rng.normal(size=(B, K)) * 0.1
    ia = rng.choice([1.0, -1.0, 0.5], size=(1, M))
    ib = rng.uniform(0.1, 2.0, size=(B, M))
    c[3, 0] = np.nan
    return G, c, A, b, ia, ib


def _strided(G, c, A, b, ia, ib):
    """Non-contiguous batch-major views holding the same values."""
    t = torch.as_tensor
    Gs = t(G.transpose(0, 2, 1).copy()).transpose(1, 2)
    cs = t(np.stack([c, c], 2))[:, :, 0]
    As = t(A.transpose(0, 2, 1).copy()).transpose(1, 2)
    bs = t(np.stack([b, b], 2))[:, :, 0]
    ias = t(ia).expand(B, ia.shape[1])
    ibs = t(ib.T.copy()).T
    return Gs, cs, As, bs, ias, ibs


def _row_patterns(N):
    """Box rows' variables: none, the general path's pairs, a repeated
    variable, and 2N rows (every variable twice, in another order)."""
    return {
        "none": (),
        "pairs": fq.pair_rows(N),
        "repeated": (0, N - 1, 0),
        "two_n": tuple(range(N - 1, -1, -1)) + tuple(range(N)),
    }


@pytest.mark.parametrize("barrier", ["complementarity", "mpc"])
@pytest.mark.parametrize("K", [0, 1])
@pytest.mark.parametrize("N", [2, 3, 4, 5, 6, 7, 8])
def test_fused_qp_batch_reads_strided_batch_major(N, K, barrier):
    for name, var in _row_patterns(N).items():
        G, c, A, b, ia, ib = _qps(N, K, len(var), seed=10 * N + K)
        x, y = fq._fused_qp_batch(
            *_strided(G, c, A, b, ia, ib), ineq_var=var, iterations=4, sigma=0.1, barrier=barrier,
            has_eq_guess=True,
        )
        fm = (G.transpose(1, 2, 0), c.T, A.transpose(1, 2, 0), b.T, np.repeat(ia, B, 0).T, ib.T)
        xp, yp = fq._fused_qp_plain(
            *(torch.as_tensor(np.ascontiguousarray(a)) for a in fm), var, 4, 0.1, barrier, True
        )
        assert x.shape == (B, N) and y.shape == (B, K), name
        torch.testing.assert_close(x, xp.T, rtol=0, atol=0, equal_nan=True, msg=name)
        torch.testing.assert_close(y, yp.T, rtol=0, atol=0, equal_nan=True, msg=name)
        assert bool(torch.isnan(x[3]).any()) and bool(torch.isfinite(x[np.arange(B) != 3]).all()), name


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_qp_route_chooser(N, K):
    register = N <= fq.REGISTER_MAX_N[K]
    patterns = dict(_row_patterns(max(N, 1)))
    patterns["pairs_reversed_with_x0"] = (0,) + fq.pair_rows(N)[::-1]
    for name, var in patterns.items():
        if not (register and len(var) <= 2 * N):
            assert fq.qp_route(N, K, var) == "warp", name
            continue
        want = "pairs" if var == tuple(1 + m // 2 for m in range(2 * (N - 1))) else "any"
        assert fq.qp_route(N, K, var) == want, name
    if register:
        assert fq.qp_route(N, K, fq.pair_rows(N)) == "pairs"
    assert fq.qp_route(N, K, (0,) * (2 * N + 1)) == "warp"  # more rows than 2N
    with pytest.raises(ValueError):
        fq.qp_route(N, K, (N,))  # a variable past N - 1
    with pytest.raises(ValueError):
        fq.qp_route(N, K, (-1,))


def test_fused_qp_cuda_wrapper_checks_its_arguments():
    """Every check raises on the host, before a device is touched."""
    G, c, A, b, ia, ib = (torch.as_tensor(a) for a in _qps(3, 1, 4, seed=1))
    ia = ia.expand(B, 4)
    var = fq.pair_rows(3)
    sched = (6, 0.1, "complementarity", True)
    with pytest.raises(ValueError, match="on"):
        fq._fused_qp_cuda(G, c, A, b, ia, ib, var, *sched)  # CPU tensors
    big = lambda n, k: tuple(torch.zeros(s, dtype=torch.float64) for s in ((B, n, n), (B, n), (B, k, n), (B, k)))  # noqa: E731
    with pytest.raises(NotImplementedError, match="192"):
        fq._fused_qp_cuda(*big(192, 1), ia[:, :0], ib[:, :0], (), *sched)  # D = 193
    with pytest.raises(NotImplementedError, match="shared memory"):
        fq._fused_qp_cuda(*big(150, 1), ia[:, :1].expand(B, 3000), ib[:, :1].expand(B, 3000), (0,) * 3000, *sched)
    with pytest.raises(ValueError, match="out of range"):
        fq._fused_qp_cuda(G, c, A, b, ia, ib, (1, 1, 2, 3), *sched)
    with pytest.raises(ValueError, match="columns"):
        fq._fused_qp_batch(G, c, A, b, ia, ib, ineq_var=(1, 1), iterations=6, sigma=0.1,
                           barrier="complementarity", has_eq_guess=True)
    with pytest.raises(ValueError, match="barrier"):
        fq._fused_qp_batch(G, c, A, b, ia, ib, ineq_var=var, iterations=6, sigma=0.1, barrier="newton",
                           has_eq_guess=True)
    with pytest.raises(TypeError):
        fq._fused_qp_cuda(G.half(), c.half(), A.half(), b.half(), ia.half(), ib.half(), var, *sched)


@pytest.mark.parametrize(
    "kind, n, budget, hist",
    [
        ("planar", 2, (4, 2, 1, "armijo", "mpc"), False),
        ("planar", 4, (3, 3, 2, "polynomial", "complementarity"), True),
        ("spatial", 3, (3, 2, 1, "armijo", "mpc"), True),
    ],
    ids=["planar2", "planar4_history", "spatial3_history"],
)
def test_fused_ik_reads_strided_batch_major(kind, n, budget, hist):
    data, x0 = (planar_instances if kind == "planar" else spatial_instances)(B, n, seed=n)
    data[2, 0] = np.nan
    x0[4, 1] = np.nan
    d = torch.as_tensor(np.stack([data, data], 2))[:, :, 0]
    x = torch.as_tensor(x0.T.copy()).T
    assert not d.is_contiguous() and not x.is_contiguous()
    kw = dict(max_iterations=budget[0], qp_iterations=budget[1], ls_iterations=budget[2],
              line_search=budget[3], barrier=budget[4])
    solve = port.fused_ik_solve_batch if kind == "planar" else port.fused_spatial_ik_solve_batch
    got = solve(d, x, link_len=0.4, return_state=True, debug_history=hist, **kw)
    family = (fik.planar_family if kind == "planar" else fik.spatial_family)(n, 0.4)
    want = fik._fused_solve_plain(
        family, torch.as_tensor(data.T.copy()), torch.as_tensor(x0.T.copy()), *budget, hist
    )
    assert got[0].shape == (B, n) and got[1].shape == (B, 3)
    torch.testing.assert_close(got[0], want[0].T, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[1], want[1].T, rtol=0, atol=0, equal_nan=True)
    if hist:
        assert got[2].shape == (B, budget[0], 7 + n)
        torch.testing.assert_close(got[2], want[2].permute(2, 0, 1), rtol=0, atol=0, equal_nan=True)


def test_fused_ik_cuda_wrapper_checks_its_arguments():
    family = fik.planar_family(2, 0.4)
    data, x0 = (torch.as_tensor(a) for a in planar_instances(B, 2, seed=0))
    budget = (4, 2, 1, "armijo", "mpc", False)
    with pytest.raises(ValueError, match="on"):
        fik._fused_solve_cuda(family, data, x0, *budget)  # CPU tensors
    with pytest.raises(NotImplementedError):
        fik._fused_solve_cuda(fik.planar_family(32, 0.4), data, torch.zeros(B, 32, dtype=data.dtype), *budget)
    with pytest.raises(ValueError, match="expected data"):
        port.fused_solve_batch(family, torch.zeros(B, 3, dtype=data.dtype).T.contiguous().T, x0, max_iterations=2)


def test_batch_major_conversion():
    """convert.to_batch_major: arrays go to the named device as they are,
    tensors stay at their own strides; mixes, shapes and dtypes raise."""
    data, x0 = planar_instances(B, 3, seed=0)
    d, x = convert.to_batch_major(data, x0, "cpu")
    assert d.shape == (B, 2) and x.shape == (B, 3) and d.dtype == torch.float64
    np.testing.assert_array_equal(d.numpy(), data)
    view = torch.as_tensor(x0.T.copy()).T
    d2, x2 = convert.to_batch_major(torch.as_tensor(data), view)
    assert x2.data_ptr() == view.data_ptr() and x2.stride() == view.stride()
    with pytest.raises(TypeError):
        convert.to_batch_major(torch.as_tensor(data), x0)
    with pytest.raises(ValueError):
        convert.to_batch_major(data, x0[:-1], "cpu")
    with pytest.raises(TypeError):
        convert.to_batch_major(data.astype(np.int64), x0.astype(np.int64), "cpu")
    with pytest.raises(TypeError):
        convert.to_batch_major(torch.as_tensor(data).float(), torch.as_tensor(x0))
