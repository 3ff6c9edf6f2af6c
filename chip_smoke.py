#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mini_opt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (H100), the CUDA toolkit's nvcc and the repo
checkout; imports torch, numpy and the port, never jax or mini_opt_tpu.
Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
2. build csrc/ with nvcc for sm_90a, print the build seconds;
3. the kernel against its plain PyTorch version on the card, B = 8192 + 13
   (a ragged edge, one NaN-target lane and one NaN-start lane): planar n=2
   at the bench budget, planar n=4 at 10/6/2 complementarity + polynomial
   with history, spatial n=3 at 4/2/1. float64: x, state and history within
   1e-9 and identical flags. float32: flags agree on >= 99.9% of lanes, x
   within 1e-3 on >= 99.5%, parity fraction within 0.001 of the plain one;
4. the main path through the public entry point fused_ik_solve_batch at the
   bench budget in float32 at B = 8192 (parity must be 1.0) and B = 262144,
   with the launch counter set to 0 just before and read just after; its
   B = 8192 outputs against the plain version's; then CUDA-event timings
   (median of 5 repeats of 20 calls) of the entry point as a caller issues
   it, of its device work, and of the kernel alone on the card, and the
   plain version's time at B = 8192;
5. the blocked-tier kernel (csrc/blocked.cu) against its plain version,
   B = 2048 + 7 with one NaN-target lane, on the medium-N warm-start
   distribution: planar n=33 (D = 34) at 4/2/2 complementarity + polynomial
   and n=48 (D = 49) at the example's 6/3/2 Mehrotra + Armijo, float64 and
   float32, with phase 3's tolerances;
6. the blocked KKT kernel (csrc/blocked_kkt.cu) against its plain version
   on quasi-definite KKT systems at D = 49 and D = 120, B = 1037, float64
   (within 1e-9 of max|x| + 1, and the float64 kernel within 1e-8 of
   torch.linalg.solve) and float32 (within 1e-3 of max|x| + 1);
7. the blocked tier's main path: fused_solve_batch on the 48-joint arm
   (examples/blocked_medium_n.py) at B = 8192 in float32 with the example's
   budget, every launch counter set to 0 just before and read just after
   (parity, effector error < 1e-3, must exceed 0.9, the example's gate), its
   outputs against the plain version's; and the standalone path,
   blocked_kkt_solve at B = 8192, D = 49, float32, counted the same way;
8. timings of both blocked kernels at those shapes (held and unheld as in
   phase 4; the blocked kernel also at B = 1, one instance's latency), their
   plain versions, and for the KKT solve torch.linalg.ldl_factor_ex +
   ldl_solve as its library yardstick;
9. the general path's kernels (csrc/ldlt.cu, csrc/fused_qp.cu), built in
   phase 2's parallel nvcc pass: ptxas registers and spills per instance;
10. the LDL^T factor and solve kernels (kernels 4 and 5) against their plain
   versions at D = 3, 5, 9, 17, 33, 40, B = 8192 + 13, float64 and float32,
   with one NaN lane and one singular lane (the per-lane ``ok`` equal);
11. the fused QP kernel (kernel 6) against its plain version on QPs from
   the port's own linearization of bench instances at n = 2, 4 and 8, both
   barriers, float64 and float32, one NaN-target lane;
12. the general main path, ``solve_ik_batch`` (bench.py --general: planar
   n = 2, float32, B = 8192, 10/6/2, complementarity, Armijo) on both
   inner-QP routes, kkt_solver="pallas_ldlt" (kernels 4 and 5) and
   qp_solver="pallas_fused" (kernel 6), every launch counter set to 0 just
   before each route and read just after, checked against the formula (70
   factorizations and 70 solves, or 10 fused QPs, per call); parity
   (effector error < 1e-3) at least 0.99; each route against the same
   entry point with the kernels' plain versions swapped in, on the card,
   bit for bit; timings: the entry point per call, its device work and
   kernel share (torch.profiler) and the device's idle share of the
   unprofiled call, each kernel alone on the inputs the main
   path gave it (held), its bound, its plain version and, for kernels 4
   and 5, torch.linalg.ldl_factor_ex / ldl_solve;
13. the pose-ring kernel (csrc/pose_ring.cu), built in phase 2's parallel
   nvcc pass: ptxas registers, spill stores and stack frame per instance;
14. kernel 7 against its plain version, B = 8192 + 13 with one
   NaN-measurement lane and one NaN-start lane, float64 and float32, on
   the canonical ring N = 16 at 6/2 (scripts/bench_extras.py's
   pose_ring_bench distribution), the chain with the closure (12, 4) and
   the closures ((15, 0), (4, 11)) at N = 16, 5/2 (its
   pose_ring_chain_closure_bench distribution), and the ring N = 32 at
   6/2. float64: x and state within 1e-9, flags identical; float32: phase
   3's shares; the NaN lanes flagged, their neighbours finite;
15. the pose-ring main path, models.pose_graph.solve_pose_graph_rings on
   the N = 16 ring, float32, B = 8192, 6/2, with every launch counter set
   to 0 just before and read just after (exactly one pose-ring launch per
   call), the converged share (final cost < 2e-3 N, the bench's noise
   gate) at least 0.99, its outputs against the plain version's; then the
   two closure topologies through the same entry point (converged share,
   flags);
16. timings at the main path's shape: the entry point as a caller issues
   it, its device work and the kernel alone (held), the kernel at B = 1
   (one instance's latency), the plain version once, the bound; and the
   general twin, make_pose_graph_problem + nls_solve at 6/2
   (kkt_solver="ldlt") at B = 1024, per call and its median cost beside
   the kernel's (reported, not gated);
17. the kernel line, then the device line as the last line of stdout.

Tolerances, kernel against plain version: the kernels sum in the plain
versions' order and build without FMA contraction, so they are expected to
agree bit for bit (each comparison prints whether they did); the gates
allow float64 1e-9 and, in float32, where a chaotic lane may flip with one
rounding, the slice-1 shares. Kernels 4-6 and the general path (phases
10-12) are held bit for bit in both types. Kernel 7 (phases 14-15) keeps
phase 3's gates: its float32 solve runs sin, cos and an angle wrap in every
iteration.
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import mini_opt_tpu_torch as mot
from mini_opt_tpu_torch.instances import (
    chain_closure_instances,
    effector_error,
    medium_n_planar_instances,
    planar_instances,
    ring_instances,
    spatial_instances,
)
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.ops import _build
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.ops import ldlt
from mini_opt_tpu_torch.ops import pose_ring as pr

LINK = 0.4
BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# The blocked tier's main path: the 48-joint arm of
# examples/blocked_medium_n.py (D = 49) at the example's budget.
ARM_N = 48
ARM = dict(max_iterations=6, qp_iterations=3, ls_iterations=2, barrier="mpc", line_search="armijo")
# The same budget as the positional arguments of the blocked wrappers.
ARM_ARGS = tuple(ARM[k] for k in ("max_iterations", "qp_iterations", "ls_iterations",
                                  "line_search", "barrier"))


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def max_abs_diff(a, b):
    """Max |a - b| over entries that differ (equal infinities count 0); NaN
    positions must coincide (returns inf otherwise)."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    m = ~np.isnan(a) & (a != b)
    return float(np.abs(a[m] - b[m]).max()) if m.any() else 0.0


def bit_identical(*pairs):
    """True when every pair of tensors agrees bit for bit, NaN with NaN."""
    return all(bool(((a == b) | (a.isnan() & b.isnan())).all()) for a, b in pairs)


def lanes_agree(a, b, tol):
    """Per-lane agreement of feature-major (..., B) tensors within tol,
    NaN matching NaN."""
    a, b = a.double(), b.double()
    ok = ((a - b).abs() <= tol) | (a.isnan() & b.isnan())
    return ok.reshape(-1, ok.shape[-1]).all(0)


def check_against_plain(tag, fam_kind, data, got, want, max_err):
    """Hold the kernel's feature-major (x, state, history) against the plain
    version's on the same inputs; exit on disagreement. float64: x, state
    and history within 1e-9, flags identical. float32: flags on >= 99.9% of
    lanes, x within 1e-3 on >= 99.5%, parity within 0.001 (chaotic lanes may
    flip with fp context in float32). Records the largest |kernel - plain|
    per dtype in max_err."""
    (xk, sk, hk), (xp, sp, hp) = got, want
    dtype = str(xk.dtype).replace("torch.", "")
    tag = f"{tag} {dtype}"
    flags_agree = (sk[2] == sp[2]).double().mean().item()
    same = bit_identical((xk, xp), (sk, sp), *([(hk, hp)] if hp is not None else []))
    tag = f"{tag} (bit-identical {same})"
    diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk[:2], sp[:2])}
    if hp is not None:
        diffs["history"] = max_abs_diff(hk, hp)
    err = max(diffs.values())
    max_err[dtype] = max(max_err[dtype], err)
    if dtype == "float64":
        print(f"# {tag}: max|kernel - plain| {diffs}, flags identical {flags_agree == 1.0}", flush=True)
        if err > 1e-9 or flags_agree != 1.0:
            fail(f"{tag}: kernel disagrees with the plain version ({diffs}, flags {flags_agree})")
    else:
        x_agree = lanes_agree(xk, xp, 1e-3).double().mean().item()
        par_k = (effector_error(fam_kind, xk.T.cpu(), data) < 1e-3).mean()
        par_p = (effector_error(fam_kind, xp.T.cpu(), data) < 1e-3).mean()
        print(f"# {tag}: flags agree {flags_agree:.6f}, x within 1e-3 {x_agree:.6f}, "
              f"parity kernel {par_k:.6f} plain {par_p:.6f}, max|kernel - plain| {diffs}", flush=True)
        if flags_agree < 0.999 or x_agree < 0.995 or abs(par_k - par_p) > 0.001:
            fail(f"{tag}: float32 agreement below threshold")


def time_ms(fn, repeats=5, launches=20, warmup=3, held=False):
    """Median over repeats of the mean CUDA-event time of `launches` calls.

    Unheld, the events time the calls as a caller issues them back to back:
    where the host takes longer to issue a call than the card to run it,
    that is the host's rate. Held, a device-side sleep holds the stream
    while the host issues all the calls, so they run back to back on the
    card and the events time device work alone; the run fails if the sleep
    ended before the last call was issued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        cycles = 50_000_000  # about 25 ms at the H100's 1.98 GHz boost clock
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if held:
                torch.cuda._sleep(cycles)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            released_early = held and start.query()
            end.synchronize()
            if not released_early:
                break
            cycles *= 4
        else:
            fail("the device-side sleep ended before the timed calls were issued")
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times)), [float(t) for t in times]


def count_ops(fn):
    """Elementwise operations the plain version performs, each counted once
    per element (sin, cos and sqrt included as one each), via a dispatch
    mode over the aten calls."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = {
        "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "sin", "cos",
        "floor", "maximum", "minimum", "where", "gt", "lt", "ge", "le", "eq", "ne",
        "bitwise_and", "logical_and", "bitwise_not", "logical_not", "reciprocal",
        "pow", "remainder", "isfinite", "isinf", "isnan",
    }

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in counted and torch.is_tensor(out):
                Count.ops += out.numel()
            return out

    with Count():
        fn()
    return Count.ops


def event_ms(fn):
    """One call of fn timed with CUDA events: (ms, what fn returned)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def ptxas_report(text):
    """Per kernel instance in ptxas's -v output: (mangled name, registers,
    spill-store bytes, shared-memory bytes, stack-frame bytes)."""
    rows, name, spill, stack = [], None, 0, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill, stack = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            stack = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill, int(m.group(2) or 0), stack))
            name = None
    return rows


def roofline(ops, bytes_moved):
    """The least time (ms) for `ops` FP32 operations and `bytes_moved` bytes
    of device memory, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, bytes_moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kkt_systems(B, D, seed, dtype):
    """B random quasi-definite KKT systems, the class qp.cc factors (a
    positive definite (1,1) block, m = D // 12 equality rows, a zero (2,2)
    block: indefinite), and right-hand sides, as CUDA tensors."""
    rng = np.random.default_rng(seed)
    m = max(1, D // 12)
    n = D - m
    A = rng.normal(size=(B, n, n))
    H = np.zeros((B, D, D))
    H[:, :n, :n] = A @ A.transpose(0, 2, 1) + 2.0 * np.eye(n)
    Aeq = rng.normal(size=(B, m, n))
    H[:, n:, :n] = Aeq
    H[:, :n, n:] = Aeq.transpose(0, 2, 1)
    rhs = rng.normal(size=(B, D))
    return (torch.as_tensor(H, dtype=dtype, device="cuda"),
            torch.as_tensor(rhs, dtype=dtype, device="cuda"))


def blocked_vs_plain(max_err):
    """Phase 5: csrc/blocked.cu against _blocked_solve_plain."""
    B = 2048 + 7
    cases = [
        ("planar n=33 (D=34) 4/2/2 complementarity polynomial", 33,
         dict(max_iterations=4, qp_iterations=2, ls_iterations=2,
              barrier="complementarity", line_search="polynomial")),
        ("planar n=48 (D=49) 6/3/2 mpc armijo", ARM_N, ARM),
    ]
    for name, n, kw in cases:
        data, x0 = medium_n_planar_instances(B, n, seed=n)
        data[5, 0] = np.nan
        family = fik.planar_family(n, LINK)
        for dtype in (torch.float64, torch.float32):
            data_t, x0_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            args = (family, data_t, x0_t, kw["max_iterations"], kw["qp_iterations"],
                    kw["ls_iterations"], kw["line_search"], kw["barrier"])
            before = blk.BLOCKED_LAUNCHES
            xk, sk = blk._blocked_solve_cuda(*args)
            torch.cuda.synchronize()
            if blk.BLOCKED_LAUNCHES != before + 1:
                fail(f"{name}: the blocked kernel wrapper did not count its launch")
            xp, sp = blk._blocked_solve_plain(*args)
            torch.cuda.synchronize()
            check_against_plain(f"phase5 {name}", "planar", data, (xk, sk, None), (xp, sp, None), max_err)


def check_kkt(tag, H, rhs, xk, xp, max_err):
    """The KKT kernel's x against the plain version's: within 1e-9 (float64)
    or 1e-3 (float32) of max|x| + 1; float64 also within 1e-8 of
    torch.linalg.solve."""
    dtype = str(H.dtype).replace("torch.", "")
    scale = xp.abs().max().item() + 1.0
    err = max_abs_diff(xk, xp)
    max_err[dtype] = max(max_err[dtype], err)
    line = (f"# {tag} {dtype}: max|kernel - plain| {err:.3e} (scale {scale:.3e}), "
            f"bit-identical {bit_identical((xk, xp))}")
    if H.dtype == torch.float64:
        ref = torch.linalg.solve(H, rhs)
        ref_err = (xk - ref).abs().max().item() / (ref.abs().max().item() + 1.0)
        line += f", relative to torch.linalg.solve {ref_err:.3e}"
        if not ref_err <= 1e-8:
            fail(f"{tag}: the float64 kernel is {ref_err} from torch.linalg.solve")
    print(line, flush=True)
    if not err <= (1e-9 if H.dtype == torch.float64 else 1e-3) * scale:
        fail(f"{tag} {dtype}: the KKT kernel disagrees with the plain version ({err})")


def kkt_vs_plain(max_err):
    """Phase 6: csrc/blocked_kkt.cu against _blocked_kkt_solve_plain."""
    B = 1037
    for D in (49, 120):
        for dtype in (torch.float64, torch.float32):
            H, rhs = kkt_systems(B, D, seed=D, dtype=dtype)
            before = blk.KKT_LAUNCHES
            xk = blk._blocked_kkt_solve_cuda(H, rhs)
            torch.cuda.synchronize()
            if blk.KKT_LAUNCHES != before + 1:
                fail(f"D={D}: the KKT kernel wrapper did not count its launch")
            xp = blk._blocked_kkt_solve_plain(H, rhs)
            torch.cuda.synchronize()
            check_kkt(f"phase6 blocked KKT D={D} B={B}", H, rhs, xk, xp, max_err)


def reset_counts():
    fik.KERNEL_LAUNCHES = 0
    pr.KERNEL_LAUNCHES = 0
    blk.BLOCKED_LAUNCHES = 0
    blk.KKT_LAUNCHES = 0
    ldlt.LDLT_FACTOR_LAUNCHES = 0
    ldlt.LDLT_SOLVE_LAUNCHES = 0
    fq.FUSED_QP_LAUNCHES = 0


def counts():
    return dict(fused_ik=fik.KERNEL_LAUNCHES, blocked=blk.BLOCKED_LAUNCHES, blocked_kkt=blk.KKT_LAUNCHES,
                ldlt_factor=ldlt.LDLT_FACTOR_LAUNCHES, ldlt_solve=ldlt.LDLT_SOLVE_LAUNCHES,
                fused_qp=fq.FUSED_QP_LAUNCHES, pose_ring=pr.KERNEL_LAUNCHES)


def blocked_paths(card, kind):
    """Phases 5-8 for the blocked tier; returns its two kernel rows."""
    max_err_blk = {"float64": 0.0, "float32": 0.0}
    max_err_kkt = {"float64": 0.0, "float32": 0.0}
    blocked_vs_plain(max_err_blk)
    kkt_vs_plain(max_err_kkt)

    # Phase 7: the main path, fused_solve_batch past D = 32.
    B = 8192
    targets, x0 = medium_n_planar_instances(B, ARM_N, seed=0)
    arm = fik.planar_family(ARM_N, LINK)
    t32, x32 = targets.astype(np.float32), x0.astype(np.float32)
    reset_counts()
    x_arm, state_arm = mot.fused_solve_batch(arm, t32, x32, return_state=True, **ARM)
    torch.cuda.synchronize()
    arm_counts = counts()
    if arm_counts["blocked"] < 1:
        fail(f"the blocked main path launched the blocked kernel no time ({arm_counts})")
    if x_arm.shape != (B, ARM_N) or state_arm.shape != (B, 3) or not x_arm.is_cuda:
        fail(f"blocked main path: unexpected outputs {tuple(x_arm.shape)} {tuple(state_arm.shape)}")
    if not torch.isfinite(x_arm).all():
        fail("blocked main path: non-finite solutions")
    err = effector_error("planar", x_arm.cpu(), targets)
    parity = float((err < 1e-3).mean())
    status = mot.fused_termination_status(state_arm, f_tol=1e-8, eq_tol=1e-5)
    satisfied = (status == int(mot.NLSTerminationState.SATISFIED_ABSOLUTE_TOL)).double().mean().item()
    print(f"# phase7 blocked main path fused_solve_batch planar n={ARM_N} (D=49) B={B} float32 "
          f"{ARM}: launches {arm_counts} for 1 call; parity {parity:.6f} (effector error p50 "
          f"{np.median(err):.3e}, max {err.max():.3e}), status satisfied {satisfied:.6f}", flush=True)
    if not parity > 0.9:
        fail(f"blocked main path parity {parity} is not above 0.9 (examples/blocked_medium_n.py:75)")
    data_t, x0_t = mot.batch_from_numpy(t32, x32, "cuda")
    plain_arm = lambda: blk._blocked_solve_plain(arm, data_t, x0_t, *ARM_ARGS)  # noqa: E731
    xp, sp = plain_arm()
    torch.cuda.synchronize()
    check_against_plain(f"phase7 main path B={B}", "planar", targets,
                        (x_arm.T, state_arm.T, None), (xp, sp, None), max_err_blk)

    # The standalone path: blocked_kkt_solve at the main path's D and B.
    D = ARM_N + 1
    H, rhs = kkt_systems(B, D, seed=7, dtype=torch.float32)
    reset_counts()
    x_kkt = mot.blocked_kkt_solve(H, rhs)
    torch.cuda.synchronize()
    kkt_counts = counts()
    if kkt_counts["blocked_kkt"] < 1:
        fail(f"blocked_kkt_solve launched the KKT kernel no time ({kkt_counts})")
    print(f"# phase7 blocked_kkt_solve D={D} B={B} float32: launches {kkt_counts} for 1 call", flush=True)
    plain_kkt = lambda: blk._blocked_kkt_solve_plain(H, rhs)  # noqa: E731
    check_kkt(f"phase7 blocked_kkt_solve D={D} B={B}", H, rhs, x_kkt, plain_kkt(), max_err_kkt)

    # Phase 8: times at those shapes.
    t_d, x_d = torch.as_tensor(t32, device="cuda"), torch.as_tensor(x32, device="cuda")
    entry = lambda: mot.fused_solve_batch(arm, t_d, x_d, **ARM)  # noqa: E731
    kern = lambda: blk._blocked_solve_cuda(arm, data_t, x0_t, *ARM_ARGS)  # noqa: E731
    e2e_ms, e2e_all = time_ms(entry, launches=10)
    dev_ms, dev_all = time_ms(entry, launches=10, held=True)
    k2_ms, k2_all = time_ms(kern, launches=10, held=True)
    k2_unheld_ms, _ = time_ms(kern, launches=10)
    # One instance alone: the latency of one CTA's dependent chain.
    one = lambda: blk._blocked_solve_cuda(  # noqa: E731
        arm, data_t[:, :1].contiguous(), x0_t[:, :1].contiguous(), *ARM_ARGS)
    k2_one_ms, _ = time_ms(one, launches=10, held=True)
    plain2_ms, _ = event_ms(plain_arm)
    ops2 = count_ops(plain_arm)
    bound2_ms, bound2_by = roofline(ops2, B * (2 + ARM_N + ARM_N + 3) * 4)
    print(f"# phase8 blocked kernel B={B} D=49 float32 on {kind} ({card}): kernel alone on the card "
          f"{k2_ms:.4f} ms ({B / k2_ms * 1e3:.4e} solves/s), unheld {k2_unheld_ms:.4f} ms, "
          f"at B=1 {k2_one_ms:.4f} ms, "
          f"entry point issued back to back "
          f"{e2e_ms:.4f} ms/call, its device work {dev_ms:.4f} ms; plain {plain2_ms:.3f} ms; "
          f"{ops2 / B:.0f} elementwise ops per instance -> bound {bound2_ms:.6f} ms ({bound2_by}), "
          f"kernel = {k2_ms / bound2_ms:.1f}x bound; repeats: entry {e2e_all} device {dev_all} "
          f"kernel {k2_all}", flush=True)

    kern3 = lambda: blk._blocked_kkt_solve_cuda(H, rhs)  # noqa: E731
    k3_ms, k3_all = time_ms(kern3, held=True)
    k3_unheld_ms, _ = time_ms(kern3)
    e3_ms, _ = time_ms(lambda: mot.blocked_kkt_solve(H, rhs))
    plain3_ms, _ = event_ms(plain_kkt)
    ops3 = count_ops(plain_kkt)
    # Reads the lower triangle with the diagonal and the rhs, writes x.
    bound3_ms, bound3_by = roofline(ops3, B * (D * (D + 1) // 2 + D + D) * 4)

    def library(H=H, rhs=rhs):
        LD, pivots, _ = torch.linalg.ldl_factor_ex(H)
        return torch.linalg.ldl_solve(LD, pivots, rhs[..., None])[..., 0]

    # The yardstick only: the port never calls it. One timed call after a
    # warm-up on 8 systems: at this batch the call takes seconds (it factors
    # the systems one by one).
    library(H[:8], rhs[:8])
    lib3_ms, lib_x = event_ms(library)
    lib_note = (f"library ldl_factor_ex + ldl_solve {lib3_ms:.4f} ms (one call), "
                f"max|kernel - library| {max_abs_diff(x_kkt, lib_x):.3e}")
    print(f"# phase8 blocked KKT kernel B={B} D={D} float32 on {kind} ({card}): kernel alone "
          f"{k3_ms:.4f} ms, unheld {k3_unheld_ms:.4f} ms, blocked_kkt_solve issued back to back {e3_ms:.4f} ms/call; plain "
          f"{plain3_ms:.3f} ms; {ops3 / B:.0f} elementwise ops per system -> bound {bound3_ms:.6f} ms "
          f"({bound3_by}), kernel = {k3_ms / bound3_ms:.1f}x bound; {lib_note}; repeats {k3_all}",
          flush=True)

    return [
        {
            "name": "blocked_sqp",
            "route": "cuda",
            "source": "mini_opt_tpu_torch/csrc/blocked.cu",
            "replaces": "mini_opt_tpu/ops/pallas_blocked.py:96",
            "function": "_make_blocked_kernel",
            "launches": arm_counts["blocked"],
            "max_abs_err": max(max_err_blk.values()),
            "max_abs_diff_f64": max_err_blk["float64"],
            "ms": k2_ms,
            "plain_ms": plain2_ms,
            "bound_ms": bound2_ms,
            "bound_by": bound2_by,
            "library_ms": None,
            "shape": f"B={B} n=48 (D=49) float32 6/3/2 mpc armijo",
            "ops_per_instance": ops2 / B,
            "parity": parity,
            "card": card,
        },
        {
            "name": "blocked_kkt_ldlt",
            "route": "cuda",
            "source": "mini_opt_tpu_torch/csrc/blocked_kkt.cu",
            "replaces": "mini_opt_tpu/ops/pallas_blocked.py:751",
            "function": "blocked_kkt_solve (inline kernel :769)",
            "launches": kkt_counts["blocked_kkt"],
            "max_abs_err": max(max_err_kkt.values()),
            "max_abs_diff_f64": max_err_kkt["float64"],
            "ms": k3_ms,
            "plain_ms": plain3_ms,
            "bound_ms": bound3_ms,
            "bound_by": bound3_by,
            "library_ms": lib3_ms,
            "shape": f"B={B} D={D} float32",
            "ops_per_instance": ops3 / B,
            "card": card,
        },
    ]


# ---------------------------------------------------------------------------
# Phases 10-12: the general path (kernels 4-6).
# ---------------------------------------------------------------------------

GENERAL_B = 8192
GENERAL_ROUTES = {
    "pallas_ldlt": dict(kkt_solver="pallas_ldlt"),
    "pallas_fused": dict(qp_solver="pallas_fused"),
}


def general_params(route, dtype=torch.float32):
    """bench.py --general: default_ik_params at 10/6/2, fixed trips, no
    history (bench.py:66-88, :273), on one inner-QP route."""
    return dataclasses.replace(
        mot.default_ik_params(dtype, max_iterations=10, max_qp_iterations=6),
        max_line_search_iterations=2, record_history=False, early_exit=False,
        **GENERAL_ROUTES[route],
    )


@contextlib.contextmanager
def plain_kernels():
    """The general path with each kernel wrapper's launch replaced by its
    plain version, on the same CUDA tensors: the reference the kernels are
    held to on the card."""
    saved = (ldlt._ldlt_factor_cuda, ldlt._ldlt_solve_cuda, fq._fused_qp_cuda)
    ldlt._ldlt_factor_cuda, ldlt._ldlt_solve_cuda, fq._fused_qp_cuda = (
        ldlt._ldlt_factor_plain, ldlt._ldlt_solve_plain, fq._fused_qp_plain)
    try:
        yield
    finally:
        ldlt._ldlt_factor_cuda, ldlt._ldlt_solve_cuda, fq._fused_qp_cuda = saved


@contextlib.contextmanager
def recording(module, name, store):
    """Keep the arguments of the last call of ``module.name`` in ``store``."""
    fn = getattr(module, name)

    def wrapper(*args):
        store[name] = args
        return fn(*args)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def check_bits(tag, got, want, max_err, ok_pair=None):
    """Kernel outputs against the plain version's: bit for bit, NaN with
    NaN, or fail. Records the largest |kernel - plain| per dtype."""
    dtype = str(got[0].dtype).replace("torch.", "")
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    max_err[dtype] = max(max_err[dtype], err)
    same = bit_identical(*zip(got, want))
    line = f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {err:.3e}"
    if ok_pair is not None:
        ok_same = torch.equal(*ok_pair)
        line += f", ok equal {ok_same} ({int((~ok_pair[0]).sum())} lanes not ok)"
        same = same and ok_same
    print(line, flush=True)
    if not same:
        fail(f"{tag} {dtype}: the kernel disagrees with its plain version")


def ldlt_vs_plain(max_err):
    """Phase 10: kernels 4 and 5 against their plain versions."""
    B = 8192 + 13
    for D in (3, 5, 9, 17, 33, 40):
        rng = np.random.default_rng(D)
        A = rng.normal(size=(B, D, D))
        H = A @ A.transpose(0, 2, 1) / D + np.eye(D)
        m = max(1, D // 6)  # a KKT-shaped zero block, as the QP gives
        H[:, D - m:, D - m:] = 0.0
        H[5] = np.nan
        H[7] = 0.0
        rhs = rng.normal(size=(D, B))
        for dtype in (torch.float64, torch.float32):
            Ht = torch.as_tensor(H, dtype=dtype, device="cuda").permute(1, 2, 0).contiguous()
            rt = torch.as_tensor(rhs, dtype=dtype, device="cuda")
            before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES)
            Lk, dk = ldlt._ldlt_factor_cuda(Ht)
            Lp, dp = ldlt._ldlt_factor_plain(Ht)
            xk = ldlt._ldlt_solve_cuda(Lp, dp, rt)
            torch.cuda.synchronize()
            if (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES) != (before[0] + 1, before[1] + 1):
                fail(f"D={D}: an LDL^T wrapper did not count its launch")
            xp = ldlt._ldlt_solve_plain(Lp, dp, rt)
            check_bits(f"phase10 LDL^T factor D={D} B={B}", (Lk, dk), (Lp, dp), max_err["factor"],
                       ok_pair=(ldlt._ok(Lk, dk), ldlt._ok(Lp, dp)))
            check_bits(f"phase10 LDL^T solve D={D} B={B}", (xk,), (xp,), max_err["solve"])


def ik_qps(n, B, dtype, seed):
    """The QPs of the general path's first outer iteration at planar n:
    the port's own linearization of bench instances (lambda = 1e-3), one
    NaN-target lane. Returns the feature-major kernel arguments but the
    schedule."""
    targets, x0 = planar_instances(B, n, seed=seed)
    targets[5, 0] = np.nan
    chain = mot.make_planar_chain(n, dtype=dtype, device="cuda")
    x_t = torch.as_tensor(x0, dtype=dtype, device="cuda")
    qp, _ = mot.nonlinear.linearize_and_fill_qp(
        lambda t: mot.make_ik_problem(chain, t), x_t, torch.full_like(x_t[:, 0], 1e-3),
        data=torch.as_tensor(targets, dtype=dtype, device="cuda"),
    )
    return (qp.G.permute(1, 2, 0).contiguous(), qp.c.T.contiguous(),
            qp.A_eq.permute(1, 2, 0).contiguous(), qp.b_eq.T.contiguous(),
            qp.ineq_a.T.contiguous(), qp.ineq_b.T.contiguous(), tuple(int(v) for v in qp.ineq_var))


def fused_qp_vs_plain(max_err):
    """Phase 11: kernel 6 against its plain version."""
    B = 8192 + 13
    for n in (2, 4, 8):
        for dtype in (torch.float64, torch.float32):
            qp_args = ik_qps(n, B, dtype, seed=n)
            for barrier in ("complementarity", "mpc"):
                args = qp_args + (6, 0.1, barrier, True)
                before = fq.FUSED_QP_LAUNCHES
                got = fq._fused_qp_cuda(*args)
                torch.cuda.synchronize()
                if fq.FUSED_QP_LAUNCHES != before + 1:
                    fail(f"n={n}: the fused QP wrapper did not count its launch")
                want = fq._fused_qp_plain(*args)
                check_bits(f"phase11 fused QP n={n} (M={len(qp_args[-1])}) {barrier} B={B}",
                           got, want, max_err)


def profile_call(fn):
    """One call of fn under torch.profiler: (wall ms of the profiled call,
    device-busy ms as the union of the intervals of the device's kernels and
    copies, their number, {name: (count, summed ms)}); busy ms is None when
    the profiler recorded no device activity. The solver's phase labels
    (utils/tracing.py) also appear on the device timeline, as user
    annotations spanning whole phases; they are not device work and are
    left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, per_kernel = [], {}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        count, ms = per_kernel.get(e.name, (0, 0.0))
        per_kernel[e.name] = (count + 1, ms + (end - start) / 1e3)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return wall_ms, (busy_us / 1e3 if spans else None), len(spans), per_kernel


def general_paths(card, kind):
    """Phases 10-12; returns the kernel rows of kernels 4, 5 and 6."""
    err4 = {"float64": 0.0, "float32": 0.0}
    err5 = {"float64": 0.0, "float32": 0.0}
    err6 = {"float64": 0.0, "float32": 0.0}
    ldlt_vs_plain({"factor": err4, "solve": err5})
    fused_qp_vs_plain(err6)

    # Phase 12: the general main path at full width, both routes.
    B = GENERAL_B
    targets, x0 = planar_instances(B, 2, seed=0)
    t32, x32 = targets.astype(np.float32), x0.astype(np.float32)
    expected = {"pallas_ldlt": dict(ldlt_factor=70, ldlt_solve=70, fused_qp=0),
                "pallas_fused": dict(ldlt_factor=0, ldlt_solve=0, fused_qp=10)}
    seen, launched, timing = {}, {}, {}
    for route in GENERAL_ROUTES:
        params = general_params(route)
        mot.solve_ik_batch(t32[:64], x32[:64], params=params)  # warm-up, uncounted
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            for module, name in ((ldlt, "_ldlt_factor_cuda"), (ldlt, "_ldlt_solve_cuda"),
                                 (fq, "_fused_qp_cuda")):
                stack.enter_context(recording(module, name, seen))
            reset_counts()
            res = mot.solve_ik_batch(t32, x32, params=params)
            torch.cuda.synchronize()
            got = counts()
        launched[route] = got
        want = dict(fused_ik=0, blocked=0, blocked_kkt=0, pose_ring=0, **expected[route])
        if got != want:
            fail(f"phase12 {route}: launches {got}, the formula gives {want}")
        if res.x.shape != (B, 2) or not res.x.is_cuda or not torch.isfinite(res.x).all():
            fail(f"phase12 {route}: unexpected solutions {tuple(res.x.shape)} {res.x.device}")
        err = effector_error("planar", res.x.cpu().numpy(), targets)
        parity = float((err < 1e-3).mean())
        satisfied = mot.termination_state_indicates_satisfied_tol(res.termination_state).double().mean().item()
        with plain_kernels():
            ref = mot.solve_ik_batch(t32, x32, params=params)
            torch.cuda.synchronize()
        same = bit_identical((res.x, ref.x), (res.termination_state, ref.termination_state),
                             (res.errors.f, ref.errors.f), (res.errors.equality, ref.errors.equality))
        print(f"# phase12 {route} solve_ik_batch planar n=2 B={B} float32 10/6/2 complementarity "
              f"armijo: launches {got} for 1 call (formula {expected[route]}); parity {parity:.6f} "
              f"(effector error p50 {np.median(err):.3e}, max {err.max():.3e}), satisfied "
              f"{satisfied:.6f}; against the plain kernels on the card: bit-identical {same}, "
              f"max|dx| {max_abs_diff(res.x, ref.x):.3e}", flush=True)
        if not same:
            fail(f"phase12 {route}: the kernel route disagrees with the plain route")
        if not parity >= 0.99:
            fail(f"phase12 {route}: parity {parity} is below 0.99")

        entry = lambda: mot.solve_ik_batch(t32, x32, params=params)  # noqa: E731
        e2e_ms, e2e_all = time_ms(entry, repeats=3, launches=1, warmup=1)
        with plain_kernels():
            plain_e2e_ms, _ = event_ms(entry)
        prof_wall, busy_ms, n_kernels, per_kernel = profile_call(entry)
        ours = {k: v for k, v in per_kernel.items() if re.search(r"ldlt_(factor|solve)_kernel|fused_qp_kernel", k)}
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
        timing[route] = dict(e2e_ms=e2e_ms, busy_ms=busy_ms, parity=parity)
        dev_txt = "not measured (the profiler recorded no device activity)" if busy_ms is None else (
            f"device busy {busy_ms:.3f} ms in {n_kernels} kernels, idle share {1 - busy_ms / e2e_ms:.4f} "
            f"of the unprofiled call ({e2e_ms:.3f} ms; the profiled call's own wall is {prof_wall:.3f} ms, "
            f"idle share {1 - busy_ms / prof_wall:.4f} of it); this slice's kernels "
            f"{ {k[:48]: (c, round(ms, 5)) for k, (c, ms) in ours.items()} }; the largest "
            f"{ [(k[:48], c, round(ms, 3)) for k, (c, ms) in top] }")
        print(f"# phase12 {route} on {kind} ({card}): entry point {e2e_ms:.3f} ms/call "
              f"({B / e2e_ms * 1e3:.4e} solves/s), repeats {e2e_all}; with the plain "
              f"kernels {plain_e2e_ms:.3f} ms; profiled call: {dev_txt}", flush=True)

    rows = []
    # Each kernel alone, on the inputs the main path last gave it.
    Ht = seen["_ldlt_factor_cuda"][0]
    Lt, dt, rt = seen["_ldlt_solve_cuda"]
    qp_args = seen["_fused_qp_cuda"]
    D, = Ht.shape[:1]
    N, K, M = qp_args[1].shape[0], qp_args[3].shape[0], len(qp_args[6])
    f32 = 4
    H_b = Ht.permute(2, 0, 1).contiguous()
    rhs_b = rt.T.contiguous()

    # The library yardsticks, timed once each after a warm-up on 8 systems
    # (the port never calls them).
    torch.linalg.ldl_factor_ex(H_b[:8])
    lib_factor_ms, (LD, piv, _) = event_ms(lambda: torch.linalg.ldl_factor_ex(H_b))
    torch.linalg.ldl_solve(LD[:8], piv[:8], rhs_b[:8, :, None])
    lib_solve_ms, _ = event_ms(lambda: torch.linalg.ldl_solve(LD, piv, rhs_b[..., None]))

    kernels = [
        ("ldlt_factor", "mini_opt_tpu/ops/pallas_ldlt.py:47", "_ldlt_kernel (launched :115)",
         lambda: ldlt._ldlt_factor_cuda(Ht), lambda: ldlt._ldlt_factor_plain(Ht),
         # reads the lower triangle, writes L and d
         B * (D * (D + 1) // 2 + D * D + D) * f32, lib_factor_ms, "pallas_ldlt", "ldlt_factor", err4,
         f"B={B} D={D} float32",
         # what a consumer reads of the output: L's strict lower triangle and d
         B * (D * (D + 1) // 2 + D * (D - 1) // 2 + D) * f32),
        ("ldlt_solve", "mini_opt_tpu/ops/pallas_ldlt.py:70", "_solve_kernel (launched :155)",
         lambda: ldlt._ldlt_solve_cuda(Lt, dt, rt), lambda: ldlt._ldlt_solve_plain(Lt, dt, rt),
         # reads L's strict lower triangle, d and the rhs, writes x
         B * (D * (D - 1) // 2 + 3 * D) * f32, lib_solve_ms, "pallas_ldlt", "ldlt_solve", err5,
         f"B={B} D={D} float32", None),
        ("fused_qp", "mini_opt_tpu/ops/pallas_qp.py:36", "_make_qp_kernel (launched :262)",
         lambda: fq._fused_qp_cuda(*qp_args), lambda: fq._fused_qp_plain(*qp_args),
         # reads G's lower triangle, c, A, b, ia, ib; writes x, y
         B * (N * (N + 1) // 2 + N + K * N + K + 2 * M + N + K) * f32, None, "pallas_fused",
         "fused_qp", err6, f"B={B} N={N} K={K} M={M} float32 6 iterations complementarity", None),
    ]
    for (name, replaces, function, kern, plain, nbytes, lib_ms, route, count_key, err, shape,
         needed_bytes) in kernels:
        k_ms, k_all = time_ms(kern, held=True)
        k_unheld_ms, _ = time_ms(kern)
        plain_ms, _ = event_ms(plain)
        ops = count_ops(plain)
        bound_ms, bound_by = roofline(ops, nbytes)
        print(f"# phase12 kernel {name} {shape} on {kind} ({card}): alone on the card {k_ms:.5f} ms "
              f"(held; unheld {k_unheld_ms:.5f}), {launched[route][count_key]} "
              f"launches per call; plain {plain_ms:.3f} ms; {ops / B:.0f} elementwise ops per instance, "
              f"{nbytes / B:.0f} bytes -> bound {bound_ms:.6f} ms ({bound_by}), kernel = "
              f"{k_ms / bound_ms:.1f}x bound; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; repeats {k_all}", flush=True)
        if needed_bytes is not None:
            tight_ms, tight_by = roofline(ops, needed_bytes)
            print(f"# phase12 kernel {name}: counting only the output a consumer reads, "
                  f"{needed_bytes / B:.0f} bytes -> bound {tight_ms:.6f} ms ({tight_by}), kernel = "
                  f"{k_ms / tight_ms:.1f}x that bound", flush=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "mini_opt_tpu_torch/csrc/" + ("fused_qp.cu" if name == "fused_qp" else "ldlt.cu"),
            "replaces": replaces,
            "function": function,
            "launches": launched[route][count_key],
            "max_abs_err": max(err.values()),
            "max_abs_diff_f64": err["float64"],
            "ms": k_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
            "shape": shape,
            "ops_per_instance": ops / B,
            "entry_ms": timing[route]["e2e_ms"],
            "entry_device_busy_ms": timing[route]["busy_ms"],
            "parity": timing[route]["parity"],
            "card": card,
        })
    return rows


# ---------------------------------------------------------------------------
# Phases 13-16: the pose-ring path (kernel 7).
# ---------------------------------------------------------------------------

RING_N = 16
RING_B = 8192
RING_BUDGET = (6, 2)
RING_GATE = 2e-3 * RING_N  # bench_extras.py:927, the noise floor's gate
# (name, N, closures or None for the canonical ring, budget): the three
# configurations of bench_extras.py's pose-ring cells and the N = 32 ring.
RING_CASES = [
    ("ring N=16 6/2", RING_N, None, RING_BUDGET),
    ("closure (12, 4) N=16 5/2", RING_N, ((12, 4),), (5, 2)),
    ("closures ((15, 0), (4, 11)) N=16 5/2", RING_N, ((15, 0), (4, 11)), (5, 2)),
    ("ring N=32 6/2", 32, None, RING_BUDGET),
]


def ring_case(n, closures, B, seed):
    """The family and float64 (B, 3E) measurements, (B, 3N) starts of one
    configuration, from the JAX repo's bench distributions."""
    if closures is None:
        return (pr.pose_ring_family(n),) + ring_instances(B, n, seed=seed)
    return (pr.pose_ring_family(n, closures=closures),) + chain_closure_instances(B, n, closures, seed=seed)


def check_ring(tag, got, want, max_err, nan_lanes=()):
    """Kernel 7's feature-major (x, state) against the plain version's:
    float64 within 1e-9 with identical flags, float32 flags on >= 99.9% of
    lanes and x within 1e-3 on >= 99.5%; the NaN lanes flagged and every
    other lane finite. Records the largest |kernel - plain| per dtype."""
    (xk, sk), (xp, sp) = got, want
    dtype = str(xk.dtype).replace("torch.", "")
    same = bit_identical((xk, xp), (sk, sp))
    diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk[:2], sp[:2])}
    err = max(diffs.values())
    max_err[dtype] = max(max_err[dtype], err)
    flags_agree = (sk[2] == sp[2]).double().mean().item()
    x_agree = lanes_agree(xk, xp, 1e-3).double().mean().item()
    others = torch.ones(xk.shape[1], dtype=torch.bool, device=xk.device)
    others[list(nan_lanes)] = False
    flagged = all(bool(sk[2, lane] != 0) for lane in nan_lanes)
    finite = bool(torch.isfinite(xk[:, others]).all() and torch.isfinite(sk[:, others]).all())
    print(f"# {tag} {dtype} (bit-identical {same}): max|kernel - plain| {diffs}, flags agree "
          f"{flags_agree:.6f}, x within 1e-3 {x_agree:.6f}, NaN lanes flagged {flagged}, others finite "
          f"{finite}, lanes flagged {int((sk[2] != 0).sum())}", flush=True)
    if not (flagged and finite):
        fail(f"{tag} {dtype}: NaN lanes not flagged or their neighbours not finite")
    if dtype == "float64" and (err > 1e-9 or flags_agree != 1.0):
        fail(f"{tag}: kernel disagrees with the plain version ({diffs}, flags {flags_agree})")
    if dtype == "float32" and (flags_agree < 0.999 or x_agree < 0.995):
        fail(f"{tag}: float32 agreement below threshold")


def pose_ring_paths(card, kind):
    """Phases 14-16; returns kernel 7's row."""
    max_err = {"float64": 0.0, "float32": 0.0}
    B = 8192 + 13
    for name, n, closures, (iters, ls) in RING_CASES:
        fam, data, x0 = ring_case(n, closures, B, seed=n)
        data[5, 4] = np.nan
        x0[9, 2] = np.nan
        for dtype in (torch.float64, torch.float32):
            d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            before = pr.KERNEL_LAUNCHES
            got = pr._pose_ring_cuda(fam, d_t, x_t, iters, ls)
            torch.cuda.synchronize()
            if pr.KERNEL_LAUNCHES != before + 1:
                fail(f"{name}: the pose-ring wrapper did not count its launch")
            want = pr._pose_ring_plain(fam, d_t, x_t, iters, ls)
            check_ring(f"phase14 {name} B={B}", got, want, max_err, nan_lanes=(5, 9))

    # Phase 15: the main path, solve_pose_graph_rings at full width.
    iters, ls = RING_BUDGET
    launched, converged = None, {}
    for name, n, closures, (it_c, ls_c) in RING_CASES[:3]:
        fam, data, x0 = ring_case(n, closures, RING_B, seed=0)
        meas = data.astype(np.float32).reshape(RING_B, -1, 3)
        starts = x0.astype(np.float32).reshape(RING_B, n, 3)
        reset_counts()
        x, state = pg.solve_pose_graph_rings(meas, starts, closures=closures, max_iterations=it_c,
                                             ls_iterations=ls_c, return_state=True)
        torch.cuda.synchronize()
        got = counts()
        want = {k: (1 if k == "pose_ring" else 0) for k in got}
        if got != want:
            fail(f"phase15 {name}: launches {got}, expected one pose-ring launch")
        if x.shape != (RING_B, n, 3) or state.shape != (RING_B, 3) or not x.is_cuda:
            fail(f"phase15 {name}: unexpected outputs {tuple(x.shape)} {tuple(state.shape)} {x.device}")
        f = state[:, 0].double().cpu().numpy()
        share = float(np.mean(f < 2e-3 * n))
        converged[name] = share
        print(f"# phase15 main path solve_pose_graph_rings {name} B={RING_B} float32: launches {got} for 1 "
              f"call; converged share (cost < {2e-3 * n:.3g}) {share:.6f}, cost median {np.median(f):.4e} "
              f"p99 {np.quantile(f, 0.99):.4e}, lanes flagged {int((state[:, 2] != 0).sum())}, all finite "
              f"{bool(torch.isfinite(x).all())}", flush=True)
        if launched is None:
            launched = got["pose_ring"]
            ring = (fam, meas, starts, x, state)
    fam, meas, starts, x_main, state_main = ring
    if not converged[RING_CASES[0][0]] >= 0.99:
        fail(f"phase15: converged share {converged[RING_CASES[0][0]]} is below 0.99")
    d_t = torch.as_tensor(meas.reshape(RING_B, -1), device="cuda").T.contiguous()
    x_t = torch.as_tensor(starts.reshape(RING_B, -1), device="cuda").T.contiguous()
    plain = lambda: pr._pose_ring_plain(fam, d_t, x_t, iters, ls)  # noqa: E731
    check_ring(f"phase15 main path B={RING_B}", (x_main.reshape(RING_B, -1).T, state_main.T), plain(), max_err)

    # Phase 16: times at the main path's shape.
    m_d, s_d = torch.as_tensor(meas, device="cuda"), torch.as_tensor(starts, device="cuda")
    entry = lambda: pg.solve_pose_graph_rings(m_d, s_d, max_iterations=iters, ls_iterations=ls)  # noqa: E731
    kern = lambda: pr._pose_ring_cuda(fam, d_t, x_t, iters, ls)  # noqa: E731
    one = lambda: pr._pose_ring_cuda(  # noqa: E731
        fam, d_t[:, :1].contiguous(), x_t[:, :1].contiguous(), iters, ls)
    e2e_ms, e2e_all = time_ms(entry, launches=10)
    dev_ms, dev_all = time_ms(entry, launches=10, held=True)
    k_ms, k_all = time_ms(kern, launches=10, held=True)
    k_unheld_ms, _ = time_ms(kern, launches=10)
    k_one_ms, _ = time_ms(one, launches=10, held=True)
    plain_ms, _ = event_ms(plain)
    ops = count_ops(plain)
    E = fam.n_edges
    # Reads the 3E measurements and 3N starts, writes 3N poses and 3 state
    # scalars per instance.
    bound_ms, bound_by = roofline(ops, RING_B * (3 * E + 3 * RING_N + 3 * RING_N + 3) * 4)
    print(f"# phase16 pose-ring kernel ring N={RING_N} B={RING_B} float32 {iters}/{ls} on {kind} ({card}): "
          f"kernel alone on the card {k_ms:.4f} ms ({RING_B / k_ms * 1e3:.4e} graphs/s), unheld "
          f"{k_unheld_ms:.4f} ms, at B=1 {k_one_ms:.4f} ms; entry point issued back to back "
          f"{e2e_ms:.4f} ms/call, its device work {dev_ms:.4f} ms; plain {plain_ms:.3f} ms; "
          f"{ops / RING_B:.0f} elementwise ops per instance -> bound {bound_ms:.6f} ms ({bound_by}), "
          f"kernel = {k_ms / bound_ms:.1f}x bound; library none; repeats: entry {e2e_all} device "
          f"{dev_all} kernel {k_all}", flush=True)

    # The general twin on the same instances at the same budget (reported).
    Bg = 1024
    edges = pg.ring_edges(RING_N)
    params = mot.NLSParams(
        max_iterations=iters, max_qp_iterations=1, max_line_search_iterations=ls,
        line_search_strategy=mot.LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
        record_history=False, early_exit=False, kkt_solver="ldlt",
    )
    ones = torch.ones(len(edges), dtype=torch.float32, device="cuda")

    def problem_fn(d):
        return pg.make_pose_graph_problem(RING_N, edges, d.reshape(len(edges), 3), ones, anchor_weight=100.0)

    d_g, x_g = d_t.T[:Bg].contiguous(), x_t.T[:Bg].contiguous()
    general = lambda: mot.nls_solve(problem_fn, params, x_g, data=d_g)  # noqa: E731
    general()
    torch.cuda.synchronize()
    gen_ms, res = event_ms(general)
    f_gen = res.errors.f.double().cpu().numpy()
    f_k = state_main[:Bg, 0].double().cpu().numpy()
    print(f"# phase16 general twin make_pose_graph_problem + nls_solve ring N={RING_N} B={Bg} float32 "
          f"{iters}/{ls} kkt_solver=ldlt on {kind} ({card}): {gen_ms:.3f} ms/call ({Bg / gen_ms * 1e3:.4e} "
          f"graphs/s), cost median {np.median(f_gen):.4e} (kernel on the same lanes {np.median(f_k):.4e}), "
          f"converged share {np.mean(f_gen < RING_GATE):.6f}; kernel graphs/s over the twin's "
          f"{(RING_B / k_ms) / (Bg / gen_ms):.1f}x", flush=True)

    return [{
        "name": "pose_ring",
        "route": "cuda",
        "source": "mini_opt_tpu_torch/csrc/pose_ring.cu",
        "replaces": "mini_opt_tpu/ops/pallas_pose_ring.py:184",
        "function": "_make_ring_kernel (launched :712)",
        "launches": launched,
        "max_abs_err": max(max_err.values()),
        "max_abs_diff_f64": max_err["float64"],
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"B={RING_B} ring N={RING_N} float32 {iters}/{ls}",
        "ops_per_instance": ops / RING_B,
        "converged_share": converged[RING_CASES[0][0]],
        "entry_ms": e2e_ms,
        "general_twin_ms_B1024": gen_ms,
        "card": card,
    }]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"# build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spilling = sum(int(b) > 0 for b in re.findall(r"(\d+) bytes spill stores", text))
        print(f"# ptxas: {len(regs)} kernel instances, registers max {max(regs, default=0)}, "
              f"{spilling} with spill stores", flush=True)
        for name, nreg, spill, smem, _ in ptxas_report(text):
            if "blocked" in name:
                print(f"# ptxas {name}: {nreg} registers, {spill} bytes spill stores, "
                      f"{smem} bytes static smem", flush=True)
        # Phase 9: the general path's kernels, from the same build.
        for name, nreg, spill, _, _ in ptxas_report(text):
            m = re.search(r"(ldlt_factor|ldlt_solve|fused_qp)_kernelI([fd])(?:Li(\d+)ELi(\d+)E)?", name)
            if m:
                kernel, t, n, k = m.groups()
                label = f"{kernel}<{'float' if t == 'f' else 'double'}" + (f", N={n}, K={k}>" if n else ">")
                print(f"# phase9 ptxas {label}: {nreg} registers, {spill} bytes spill stores", flush=True)
        # Phase 13: the pose-ring kernel, from the same build.
        for name, nreg, spill, _, stack in ptxas_report(text):
            m = re.search(r"pose_ring_kernelI([fd])Li(\d+)E", name)
            if m:
                t, k = m.groups()
                print(f"# phase13 ptxas pose_ring<{'float' if t == 'f' else 'double'}, K={k}>: {nreg} "
                      f"registers, {spill} bytes spill stores, {stack} bytes stack frame", flush=True)

    # Phase 3: kernel vs plain version on the card.
    B3 = 8192 + 13
    cases = [
        ("planar n=2 4/2/1 mpc armijo", "planar", 2, BENCH, False),
        ("planar n=4 10/6/2 complementarity polynomial +history", "planar", 4,
         dict(max_iterations=10, qp_iterations=6, ls_iterations=2,
              barrier="complementarity", line_search="polynomial"), True),
        ("spatial n=3 4/2/1 mpc armijo", "spatial", 3, BENCH, False),
    ]
    max_err = {"float64": 0.0, "float32": 0.0}
    for name, fam_kind, n, kw, hist in cases:
        data, x0 = (planar_instances if fam_kind == "planar" else spatial_instances)(B3, n, seed=n)
        data[5, 0] = np.nan
        x0[9, 1] = np.nan
        family = (fik.planar_family if fam_kind == "planar" else fik.spatial_family)(n, LINK)
        for dtype in (torch.float64, torch.float32):
            data_t, x0_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            args = (family, data_t, x0_t, kw["max_iterations"], kw["qp_iterations"],
                    kw["ls_iterations"], kw["line_search"], kw["barrier"], hist)
            before = fik.KERNEL_LAUNCHES
            got = fik._fused_solve_cuda(*args)
            torch.cuda.synchronize()
            if fik.KERNEL_LAUNCHES != before + 1:
                fail(f"{name}: the kernel wrapper did not count its launch")
            want = fik._fused_solve_plain(*args)
            torch.cuda.synchronize()
            check_against_plain(f"phase3 {name}", fam_kind, data, got, want, max_err)

    # Phase 4: the main path through the public entry point.
    batches = (8192, 262144)
    inst = {B: planar_instances(B, 2, seed=0) for B in batches}
    fik.KERNEL_LAUNCHES = 0
    results = {}
    for B in batches:
        targets, x0 = (a.astype(np.float32) for a in inst[B])
        x, state = mot.fused_ik_solve_batch(targets, x0, link_len=LINK, return_state=True, **BENCH)
        results[B] = (x, state)
    torch.cuda.synchronize()
    launches = fik.KERNEL_LAUNCHES
    if launches < 1:
        fail("the main path launched the kernel no time")
    print(f"# phase4 main path: {launches} kernel launches for {len(batches)} calls", flush=True)

    rows = {}
    for B in batches:
        x, state = results[B]
        targets, x0 = inst[B]
        if x.shape != (B, 2) or state.shape != (B, 3) or not x.is_cuda:
            fail(f"B={B}: unexpected outputs {tuple(x.shape)} {tuple(state.shape)} {x.device}")
        if not torch.isfinite(x).all():
            fail(f"B={B}: non-finite solutions")
        err = effector_error("planar", x.cpu(), targets)
        parity = float((err < 1e-3).mean())
        status = mot.fused_termination_status(state)
        satisfied = (status == int(mot.NLSTerminationState.SATISFIED_ABSOLUTE_TOL)).double().mean().item()
        t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))
        data_t, x0_t = t_d.T.contiguous(), x_d.T.contiguous()
        family = fik.planar_family(2, LINK)
        entry = lambda: mot.fused_ik_solve_batch(t_d, x_d, link_len=LINK, **BENCH)  # noqa: E731
        kernel = lambda: fik._fused_solve_cuda(  # noqa: E731
            family, data_t, x0_t, 4, 2, 1, "armijo", "mpc", False)
        e2e_ms, e2e_all = time_ms(entry)
        dev_ms, dev_all = time_ms(entry, held=True)
        kern_ms, kern_all = time_ms(kernel, held=True)
        rows[B] = dict(parity=parity, kernel_ms=kern_ms)
        print(f"# phase4 B={B} float32 on {kind} ({card}): parity {parity:.6f} (max err {err.max():.3e}), "
              f"status satisfied {satisfied:.6f}; entry point issued back to back {e2e_ms:.4f} ms/call "
              f"({B / e2e_ms * 1e3:.4e} solves/s), its device work {dev_ms:.4f} ms, "
              f"kernel alone on the card {kern_ms:.4f} ms ({B / kern_ms * 1e3:.4e} solves/s); "
              f"repeats: entry {e2e_all} device {dev_all} kernel {kern_all}", flush=True)
    if rows[8192]["parity"] != 1.0:
        fail(f"parity at B=8192 is {rows[8192]['parity']}, not 1.0")

    # The plain version at B=8192, once, and the work it counts.
    B = 8192
    targets, x0 = inst[B]
    data_t, x0_t = mot.batch_from_numpy(targets, x0, "cuda", torch.float32)
    family = fik.planar_family(2, LINK)
    plain = lambda: fik._fused_solve_plain(family, data_t, x0_t, 4, 2, 1, "armijo", "mpc", False)  # noqa: E731
    # The main path's own outputs at B = 8192 against the plain version on
    # the same inputs.
    x_main, state_main = results[B]
    x_plain, state_plain, _ = plain()
    torch.cuda.synchronize()
    check_against_plain(f"phase4 main path B={B}", "planar", targets,
                        (x_main.T, state_main.T, None), (x_plain, state_plain, None), max_err)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    ops = count_ops(plain)
    ops_per_instance = ops / B
    bytes_moved = B * (2 + 2 + 2 + 3) * 4  # read targets, x0; write x, state
    bound_ms = max(ops / PEAK_FP32_OPS, bytes_moved / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_FP32_OPS >= bytes_moved / PEAK_BYTES else "bytes"
    print(f"# plain version B={B} float32: {plain_ms:.3f} ms; {ops_per_instance:.0f} elementwise ops per "
          f"instance -> bound {bound_ms:.6f} ms ({bound_by}, {PEAK_FP32_OPS / 1e12:.0f} TFLOP/s FP32 peak); "
          f"kernel {rows[B]['kernel_ms']:.4f} ms = {bound_ms / rows[B]['kernel_ms']:.3f} of bound", flush=True)

    blocked_rows = blocked_paths(card, kind)
    general_rows = general_paths(card, kind)
    ring_rows = pose_ring_paths(card, kind)

    print(json.dumps({"kernels": [{
        "name": "fused_ik_sqp",
        "route": "cuda",
        "source": "mini_opt_tpu_torch/csrc/fused_ik.cu",
        "replaces": "mini_opt_tpu/ops/pallas_ik.py:323",
        "function": "_make_kernel",
        "launches": launches,
        "max_abs_err": max(max_err.values()),
        "max_abs_diff_f64": max_err["float64"],
        "ms": rows[B]["kernel_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"B={B} n=2 float32 4/2/1 mpc armijo",
        "ops_per_instance": ops_per_instance,
        "card": card,
    }] + blocked_rows + general_rows + ring_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
