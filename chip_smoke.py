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
5. the kernel line, then the device line as the last line of stdout.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import mini_opt_tpu_torch as mot
from mini_opt_tpu_torch.instances import effector_error, planar_instances, spatial_instances
from mini_opt_tpu_torch.ops import _build
from mini_opt_tpu_torch.ops import fused_ik as fik

LINK = 0.4
BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32
# outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def max_abs_diff(a, b):
    """Max |a - b| where both are finite; NaN positions must coincide
    (returns inf otherwise)."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    m = ~np.isnan(a)
    return float(np.abs(a[m] - b[m]).max()) if m.any() else 0.0


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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
