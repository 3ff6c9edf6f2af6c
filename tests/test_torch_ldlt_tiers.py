"""Kernels 4 and 5's launch plan and health flag, without JAX and without a
card.

``ops/ldlt.py::ldlt_launch_plan`` decides the route (the register route up
to ``REGISTER_MAX_D``, one system per thread with D a template parameter;
the generic route past it), the threads per CTA and the grid. ``_ok`` is the
flag's plain version, the rule the factor kernel reproduces per lane:
every entry of L finite and every |d_j| above the type's smallest normal
(pallas_ldlt.py:133-135). The tests pin both; the kernels themselves are
held to the plain versions on a card (tests/test_torch_port_rules.py,
chip_smoke.py phase 10).
"""

import numpy as np
import pytest
import torch

from mini_opt_tpu_torch.ops import ldlt

DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]


@pytest.mark.parametrize("D", list(range(1, 65)))
def test_launch_plan(D):
    for B in (1, 33, 8192 + 13):
        plan = ldlt.ldlt_launch_plan(D, B)
        assert plan.route == ("register" if D <= ldlt.REGISTER_MAX_D else "generic")
        # csrc/ldlt.cu's widths: a warp a CTA on the register route
        # (kRegisterThreads), four on the generic one (kGenericThreads).
        assert plan.threads == (32 if plan.route == "register" else 128)
        # The grid covers the batch, with no CTA left empty.
        assert plan.grid * plan.threads >= B > (plan.grid - 1) * plan.threads
    # B = 8192 spreads over every SM of an H100 (132) on the register route.
    assert ldlt.ldlt_launch_plan(D, 8192).grid >= 132 or D > ldlt.REGISTER_MAX_D


def _ok_rule(L, d):
    """The flag as numpy states it: (D, D, B) L and (D, B) d -> (B,)."""
    tiny = np.finfo(d.dtype).tiny
    return np.isfinite(L).all(axis=(0, 1)) & (np.abs(d) > tiny).all(axis=0)


LANES = ["healthy", "nan_in_L", "inf_in_L", "neg_inf_in_L", "zero_pivot", "subnormal_pivot",
         "negative_pivot", "nan_pivot", "inf_pivot", "smallest_normal_pivot"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("lane", LANES)
def test_ok_matches_numpy_rule(lane, dtype):
    """``_ok`` on a factor with one lane of each kind: a NaN or +-inf below
    the diagonal and a zero, subnormal, NaN or smallest-normal pivot fail
    (the test is |d_j| > tiny, strict); a negative pivot (the KKT system is
    indefinite) and an infinite one pass, as JAX's rule has it."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    finfo = np.finfo(np_dtype)
    D, B = 4, 6
    rng = np.random.default_rng(3)
    L = np.tril(rng.normal(size=(B, D, D)), -1) + np.eye(D)
    d = rng.uniform(0.5, 2.0, size=(B, D))
    bad = 2
    value = {
        "healthy": None, "nan_in_L": np.nan, "inf_in_L": np.inf, "neg_inf_in_L": -np.inf,
    }
    if lane in value:
        if value[lane] is not None:
            L[bad, 3, 1] = value[lane]
    else:
        d[bad, 2] = {"zero_pivot": 0.0, "subnormal_pivot": finfo.tiny / 4, "negative_pivot": -1.5,
                     "nan_pivot": np.nan, "inf_pivot": -np.inf, "smallest_normal_pivot": finfo.tiny}[lane]
    Lt = np.ascontiguousarray(L.transpose(1, 2, 0)).astype(np_dtype)
    dt = np.ascontiguousarray(d.T).astype(np_dtype)
    got = ldlt._ok(torch.as_tensor(Lt), torch.as_tensor(dt)).numpy()
    want = _ok_rule(Lt, dt)
    np.testing.assert_array_equal(got, want)
    expect_bad = lane not in ("healthy", "negative_pivot", "inf_pivot")
    assert bool(want[bad]) is not expect_bad
    assert want[np.arange(B) != bad].all()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_factor_flags_the_lanes_the_rule_names(dtype):
    """The plain factor's flag through ``factorize`` on systems that make
    each kind of bad lane: NaN and +-inf entries, a singular matrix, a
    subnormal first pivot; the flag equals the rule on its own outputs."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    D, B = 5, 8
    rng = np.random.default_rng(11)
    A = rng.normal(size=(B, D, D))
    H = A @ A.transpose(0, 2, 1) + D * np.eye(D)
    H[1] = np.nan
    H[2, 4, 0] = np.inf
    H[3, 3, 2] = -np.inf
    H[4] = 0.0
    H[5, 0, 0] = np.finfo(np_dtype).tiny / 8
    H[6, 0, 1] = np.nan  # above the diagonal: never read
    (Lt, dt), ok = ldlt.factorize(torch.as_tensor(H, dtype=dtype))
    np.testing.assert_array_equal(ok.numpy(), _ok_rule(Lt.numpy(), dt.numpy()))
    np.testing.assert_array_equal(ok.numpy(), [True, False, False, False, False, False, True, True])


def test_wrappers_refuse_cpu_tensors_and_other_devices():
    """The kernel wrappers take CUDA tensors only; factorize and solve run
    the plain versions on the CPU and raise on any other device."""
    H = torch.eye(3, dtype=torch.float64).expand(4, 3, 3).contiguous()
    with pytest.raises(ValueError, match="must be a"):
        ldlt._ldlt_factor_cuda(H)
    Lt, dt, _ = ldlt._factor_plain(H)
    with pytest.raises(ValueError, match="must be a"):
        ldlt._ldlt_solve_cuda(Lt, dt, torch.ones(4, 3, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        ldlt.factorize(H.to("meta"))
    with pytest.raises(NotImplementedError):
        ldlt.solve((Lt.to("meta"), dt.to("meta")), torch.ones(4, 3, device="meta"))
    x = ldlt.solve(ldlt.factorize(H)[0], torch.ones(4, 3, dtype=torch.float64))
    assert x.shape == (4, 3) and torch.equal(x, torch.ones(4, 3, dtype=torch.float64))
