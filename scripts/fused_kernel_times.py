#!/usr/bin/env python3
"""Held times of kernels 6 and 1 of the PyTorch port (the fused QP interior
point, ``mini_opt_tpu_torch/ops/fused_qp.py``, and the register-tier fused IK
SQP, ``ops/fused_ik.py``) on one CUDA card, so that two trees can be
compared on one card.

    python3 scripts/fused_kernel_times.py [--tree DIR] [--label NAME] [--family hand|generated|both]
                                          [--spans] [--ptxas] [--kernel1]

DIR (default: this checkout) is the root of the tree whose
``mini_opt_tpu_torch`` is timed; only its ``csrc/fused_*.cu`` are built,
into ``DIR/build/kernels`` (the other entry points stay unbound; kernel 1's
instances each into a library of their own where the tree builds them so,
at first use). The timer
is ``chip_smoke.time_ms`` of this checkout (held: a device-side sleep holds
the stream while the calls are issued). Rows, float32:

* kernel 6 alone at N = 2, 4, 8 (the general path's QPs: one equality row,
  lo and hi rows on variables 1..N-1, 6 iterations), both barriers, B = 1,
  1024 and 8192, on the port's own linearization of bench instances, and
  the same at B = 8192 in float64;
* its wrapper call ``_fused_qp_batch`` on the tensors the linearization
  gives (batch-major; the kernel plus whatever the wrapper copies), held,
  and its device kernels per call under ``torch.profiler``;
* kernel 6 alone and its wrapper call on the QPs of the general path's last
  outer iteration (``solve_ik_batch`` at ``bench.py --general``'s settings,
  planar n = 2, B = 8192, 10/6/2, complementarity, on the
  ``pallas_fused`` route), and the kernel on the first of them (B = 1):
  ``chip_smoke.py`` phase 12's shape;
* kernel 1 alone at planar n = 2, 4/2/1 Mehrotra + Armijo (bench.py's
  cell), B = 1, 8192 and 262144, and the entry point
  ``fused_ik_solve_batch`` on batch-major card tensors (held), with its
  device kernels per call. ``--family generated`` times instead the
  instance that ``ops/fused_emit.py`` emits for bench.py's default family
  (``family_from_problem(scalar_planar_ik_builder(2), 2)`` with the
  ``_mod_pi`` retraction) and the entry point ``fused_solve_batch`` on it;
  ``--family both`` times the two in turns (generated, hand, hand,
  generated), each in its own row. ``--kernel1`` builds kernel 1's sources
  only and prints only its rows (the kernel-6 rows are left out).

A tree whose wrappers take feature-major tensors (before the batch-major
redesign) gets feature-major copies for its kernel-alone rows; its wrapper
rows include the copies it makes. ``--ptxas`` prints the registers, spill
stores and stack frame of every kernel-6 and kernel-1 instance from the
tree's build log, and the SASS instruction counts (all, MUFU.RCP, FCHK,
CALL, BRA) of the main paths' instances, kernel 6 at float N = 2, K = 1 and
kernel 1 at float planar n = 2 (hand-written, or generated, or both, by
``--family``), from the toolkit's cuobjdump.
``--spans`` builds the tree's two kernels once more with
MO_FUSED_SPANS defined and prints the clock64() cycles of each
phase of instance 0 at B = 1 and 8192 (kernel 6 at N = 2, both barriers;
kernel 1 at n = 2, 4/2/1). Prints the card's name and power limit, then one
JSON object per measurement. Exits non-zero without a CUDA card."""

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

from kernel_timing import add_tree_args, bind_subset, open_tree

LINK = 0.4
BENCH = dict(max_iterations=4, qp_iterations=2, ls_iterations=1, barrier="mpc", line_search="armijo")
QP_ITERATIONS = 6
QP_SPANS = ("loads", "guess", "residuals", "assemble_factor", "solve_affine", "mu_affine", "solve", "ftb",
            "update", "store")
IK_SPANS = ("loads", "linearize", "qp", "step", "line_search", "lambda", "store")


def qp_inputs(mot, n, B, dtype, seed):
    """The general path's QPs at planar n: the port's linearization of bench
    instances (lambda = 1e-3), batch-major as it gives them."""
    import torch

    from mini_opt_tpu_torch.instances import planar_instances

    targets, x0 = planar_instances(B, n, seed=seed)
    chain = mot.make_planar_chain(n, dtype=dtype, device="cuda")
    x_t = torch.as_tensor(x0, dtype=dtype, device="cuda")
    qp, _ = mot.nonlinear.linearize_and_fill_qp(
        lambda t: mot.make_ik_problem(chain, t), x_t, torch.full_like(x_t[:, 0], 1e-3),
        data=torch.as_tensor(targets, dtype=dtype, device="cuda"),
    )
    return (qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b), tuple(int(v) for v in qp.ineq_var)


def batch_major(fq):
    """Whether the tree's kernel-6 and kernel-1 wrappers take batch-major
    tensors (the route chooser came with that layout)."""
    return hasattr(fq, "qp_route")


def qp_kernel(fq, tensors, var, barrier, iterations=QP_ITERATIONS, sigma=0.1, has_eq_guess=True):
    """A call of kernel 6 alone on the tree's own layout."""
    sched = (var, iterations, sigma, barrier, has_eq_guess)
    if batch_major(fq):
        return lambda: fq._fused_qp_cuda(*tensors, *sched)
    G, c, A, b, ia, ib = tensors
    fm = (G.permute(1, 2, 0).contiguous(), c.T.contiguous(), A.permute(1, 2, 0).contiguous(),
          b.T.contiguous(), ia.T.contiguous(), ib.T.contiguous())
    return lambda: fq._fused_qp_cuda(*fm, *sched)


def ik_kernel(fq, fik, family, data, x0):
    """A call of kernel 1 alone on the tree's own layout."""
    budget = (4, 2, 1, "armijo", "mpc", False)
    if batch_major(fq):
        return lambda: fik._fused_solve_cuda(family, data, x0, *budget)
    data_t, x0_t = data.T.contiguous(), x0.T.contiguous()
    return lambda: fik._fused_solve_cuda(family, data_t, x0_t, *budget)


def demangle(names):
    """Readable kernel names (cu++filt beside nvcc, else c++filt, else as
    they are)."""
    from mini_opt_tpu_torch.ops import _build

    for tool in (str(Path(_build.nvcc_path()).parent / "cu++filt"), shutil.which("c++filt")):
        if tool and Path(tool).exists():
            out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
            if out.returncode == 0:
                return out.stdout.splitlines()
    return list(names)


def fused_sources(build):
    """Kernels 6 and 1's sources of the main library: csrc/fused_*.cu, less
    the sources a tree builds once per instance (kernel 1's fused_ik.cu,
    where the tree has them)."""
    return {p.name for p in build.CSRC.glob("fused_*.cu")} - set(getattr(build, "INSTANCE_SOURCES", ()))


def kernel1_sources(build):
    """Kernel 1's sources of the main library: fused_ik.cu in a tree that
    builds every instance into it, else only error_text.cu."""
    names = {p.name for p in build.CSRC.glob("*.cu")}
    return ({"fused_ik.cu", "error_text.cu"} & names) - set(getattr(build, "INSTANCE_SOURCES", ()))


def ik_library(build):
    """Where kernel 1's planar n = 2 float instance lives: its own library,
    or the main one in a tree that builds every instance into it."""
    if hasattr(build, "build_fused_ik"):
        return build.build_fused_ik([(0, 2, False)])[0]
    return build.library_path()


def ptxas_rows(timer, build, row):
    logs = {build.library_path().with_suffix(".log"), ik_library(build).with_suffix(".log")}
    rows = [r for log in sorted(logs) for r in timer.ptxas_report(log.read_text())
            if "fused_qp" in r[0] or "fused_ik" in r[0]]
    for (name, regs, spill, _, stack), label in zip(rows, demangle([r[0] for r in rows])):
        row(ptxas=label.replace("(anonymous namespace)::", ""), registers=regs, spill_store_bytes=spill,
            stack_frame_bytes=stack)


SASS_KERNELS = {
    "kernel 6, float, N = 2, K = 1": re.compile(r"fused_qp_kernelIfLi2ELi1E"),
    "kernel 1, float, planar n = 2": re.compile(r"fused_ik_kernelIfN2mo6PlanarILi2EEE"),
}


def sass_counts(build, row, library=None, kernels=SASS_KERNELS):
    """Instruction counts of the main paths' instances in the tree's
    libraries (kernel 1's planar n = 2 instance's own, where the tree has
    one), or in ``library`` (cuobjdump beside nvcc)."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    libs = [library] if library else sorted({build.library_path(), ik_library(build)})
    text = "".join(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                                  check=True).stdout for lib in libs)
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        for label, pattern in kernels.items():
            if pattern.search(name):
                ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
                count = lambda prefix: sum(op.startswith(prefix) for op in ops)  # noqa: E731
                row(sass=label, function=name[:120], instructions=len(ops), mufu_rcp=count("MUFU.RCP"),
                    fchk=count("FCHK"), calls=count("CALL"), branches=count("BRA"), ffma=count("FFMA"),
                    fmul=count("FMUL"), fadd=count("FADD"))


GENERATED_SASS = {"kernel 1, float, generated planar n = 2": re.compile(r"fused_ik_kernelIf")}


def generated_family(mot):
    """bench.py's default family: the planar n = 2 builder through
    family_from_problem, with the angle-wrap retraction."""
    from mini_opt_tpu_torch.models.ik import scalar_planar_ik_builder
    from mini_opt_tpu_torch.ops._common import _mod_pi

    return mot.family_from_problem(scalar_planar_ik_builder(2, LINK), 2, retract=lambda th: [_mod_pi(t) for t in th])


def generated_ptxas(timer, build, row, family):
    """The generated instances' ptxas lines and SASS counts."""
    path = build.build_generated([family.cuda_program.source()])[0]
    for name, regs, spill, _, stack in timer.ptxas_report(path.with_suffix(".log").read_text()):
        if "fused_ik_kernel" in name:
            row(ptxas=f"generated planar n = 2, {'float' if 'kernelIf' in name else 'double'}", registers=regs,
                spill_store_bytes=spill, stack_frame_bytes=stack, library=path.name)
    sass_counts(build, row, path, GENERATED_SASS)


def spans(build, timer, row, fq, fik, mot):
    """Both kernels built with MO_FUSED_SPANS: instance 0's phase cycles."""
    import ctypes

    import torch

    build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-DMO_FUSED_SPANS")
    build.BUILD_DIR = Path(build.BUILD_DIR) / "spans"
    build._lib = None
    bind_subset(build, fused_sources(build))
    lib = build.load_library()
    ik_lib = build.load_fused_ik(0, 2, False) if hasattr(build, "load_fused_ik") else lib
    n_out = ctypes.c_ulonglong * 16

    def read(fn, names, call):
        call()  # warm-up
        torch.cuda.synchronize()
        source = ik_lib if fn == "mo_fused_ik_spans" else lib
        getattr(source, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        if getattr(source, fn)(None, 1) != 0:
            sys.exit(f"fused_kernel_times: could not reset {fn}")
        call()
        torch.cuda.synchronize()
        out = n_out()
        if getattr(source, fn)(out, 0) != 0:
            sys.exit(f"fused_kernel_times: could not read {fn}")
        return dict(zip(names, (int(v) for v in out)))

    for B in (1, 8192):
        tensors, var = qp_inputs(mot, 2, B, torch.float32, seed=2)
        for barrier in ("complementarity", "mpc"):
            cyc = read("mo_fused_qp_spans", QP_SPANS, qp_kernel(fq, tensors, var, barrier))
            row(kernel=6, B=B, N=2, barrier=barrier, iterations=QP_ITERATIONS, clock64_cycles_per_phase=cyc,
                total_cycles=sum(cyc.values()))
        targets, x0 = planar_x(mot, B)
        cyc = read("mo_fused_ik_spans", IK_SPANS, ik_kernel(fq, fik, fik.planar_family(2, LINK), targets, x0))
        row(kernel=1, B=B, n=2, budget="4/2/1", clock64_cycles_per_phase=cyc, total_cycles=sum(cyc.values()))


def general_qp_inputs(timer, mot, fq):
    """The batch-major QPs of the last ``_fused_qp_batch`` call of one
    ``solve_ik_batch`` call at phase 12's settings, and its keywords."""
    import numpy as np

    from mini_opt_tpu_torch.instances import planar_instances

    targets, x0 = planar_instances(8192, 2, seed=0)
    seen = {}
    wrapped = fq._fused_qp_batch

    def record(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return wrapped(*args, **kw)

    fq._fused_qp_batch = record
    try:
        mot.solve_ik_batch(targets.astype(np.float32), x0.astype(np.float32),
                           params=timer.general_params("pallas_fused"))
    finally:
        fq._fused_qp_batch = wrapped
    return seen["args"], seen["kw"]


def planar_x(mot, B):
    import torch

    from mini_opt_tpu_torch.instances import planar_instances

    targets, x0 = planar_instances(B, 2, seed=0)
    return (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))


def kernel6_rows(timer, row, mot, fq):
    """Kernel 6's rows: alone at N = 2, 4, 8, its wrapper call, and both on
    the general path's last QPs."""
    import torch

    cases = [("float32", n, B) for n in (2, 4, 8) for B in (1, 1024, 8192)]
    cases += [("float64", n, 8192) for n in (2, 4, 8)]
    for dtype, n, B in cases:
        tensors, var = qp_inputs(mot, n, B, getattr(torch, dtype), seed=n)
        extra = dict(route=fq.qp_route(n, 1, var)) if batch_major(fq) else {}
        for barrier in ("complementarity", "mpc"):
            ms, repeats = timer.time_ms(qp_kernel(fq, tensors, var, barrier), held=True)
            row(kernel=6, N=n, K=1, M=len(var), B=B, dtype=dtype, barrier=barrier, ms=ms, repeats=repeats,
                **extra)
        if n == 2 and dtype == "float32":
            def wrapper():
                return fq._fused_qp_batch(*tensors, ineq_var=var, iterations=QP_ITERATIONS, sigma=0.1,
                                          barrier="complementarity", has_eq_guess=True)

            ms, repeats = timer.time_ms(wrapper, held=True)
            wrapper()
            torch.cuda.synchronize()
            _, _, n_kernels, per_kernel = timer.profile_call(wrapper)
            row(kernel=6, call="_fused_qp_batch", N=n, B=B, barrier="complementarity", ms=ms,
                repeats=repeats, device_kernels_per_call=n_kernels,
                kernels=sorted(k[:60] for k in per_kernel))

    tensors, kw = general_qp_inputs(timer, mot, fq)
    var = tuple(kw["ineq_var"])
    for B in (8192, 1):
        ts = tuple(t[:B] for t in tensors)
        ms, repeats = timer.time_ms(qp_kernel(fq, ts, var, kw["barrier"], kw["iterations"], kw["sigma"],
                                              kw["has_eq_guess"]), held=True)
        row(kernel=6, inputs="general path, last outer iteration", N=ts[1].shape[1], B=B, barrier=kw["barrier"],
            iterations=kw["iterations"], ms=ms, repeats=repeats)
    ms, repeats = timer.time_ms(lambda: fq._fused_qp_batch(*tensors, **kw), held=True)
    fq._fused_qp_batch(*tensors, **kw)
    torch.cuda.synchronize()
    _, _, n_kernels, _ = timer.profile_call(lambda: fq._fused_qp_batch(*tensors, **kw))
    row(kernel=6, call="_fused_qp_batch", inputs="general path, last outer iteration", B=8192, ms=ms,
        repeats=repeats, device_kernels_per_call=n_kernels)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    ap.add_argument("--spans", action="store_true", help="also print the phase cycles of one instance")
    ap.add_argument("--ptxas", action="store_true",
                    help="print every kernel-6 and kernel-1 instance's ptxas line and the main-path "
                         "instances' SASS instruction counts")
    ap.add_argument("--family", choices=("hand", "generated", "both"), default="hand",
                    help="kernel 1's rows: the hand-written planar family, the one generated from a "
                         "Problem, or both in turns")
    ap.add_argument("--kernel1", action="store_true",
                    help="build kernel 1's sources only and print kernel 1's rows only")
    args = ap.parse_args()
    timer, _, row = open_tree("fused_kernel_times", args)

    import torch

    import mini_opt_tpu_torch as mot
    from mini_opt_tpu_torch.ops import _build
    from mini_opt_tpu_torch.ops import fused_ik as fik
    from mini_opt_tpu_torch.ops import fused_qp as fq

    bind_subset(_build, kernel1_sources(_build) if args.kernel1 else fused_sources(_build))
    families = {"hand": fik.planar_family(2, LINK)} if args.family != "generated" else {}
    if args.family != "hand":
        families["generated"] = generated_family(mot)
        families["generated"].cuda_program.library()
    if args.ptxas:
        ptxas_rows(timer, _build, row)
        if "hand" in families:
            sass_counts(_build, row)
        if "generated" in families:
            generated_ptxas(timer, _build, row, families["generated"])

    if not args.kernel1:
        kernel6_rows(timer, row, mot, fq)

    order = list(families) + list(families)[::-1]  # in turns: a, b, b, a
    for B in (1, 8192, 262144):
        targets, x0 = planar_x(mot, B)
        for name in order:
            family = families[name]
            ms, repeats = timer.time_ms(ik_kernel(fq, fik, family, targets, x0), held=True)
            row(kernel=1, family=name, n=2, budget="4/2/1", B=B, ms=ms, repeats=repeats)
        for name, family in families.items():
            if name == "hand":
                def entry():
                    return mot.fused_ik_solve_batch(targets, x0, link_len=LINK, **BENCH)
            else:
                def entry(family=family):
                    return mot.fused_solve_batch(family, targets, x0, **BENCH)

            ms, repeats = timer.time_ms(entry, held=True)
            unheld_ms, _ = timer.time_ms(entry)
            entry()
            torch.cuda.synchronize()
            _, _, n_kernels, per_kernel = timer.profile_call(entry)
            row(kernel=1, family=name, call="fused_ik_solve_batch" if name == "hand" else "fused_solve_batch",
                n=2, budget="4/2/1", B=B, ms=ms, unheld_ms=unheld_ms, repeats=repeats,
                device_kernels_per_call=n_kernels, kernels=sorted(k[:60] for k in per_kernel))

    if args.spans:
        spans(_build, timer, row, fq, fik, mot)


if __name__ == "__main__":
    main()
