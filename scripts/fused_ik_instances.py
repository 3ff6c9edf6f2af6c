#!/usr/bin/env python3
"""Kernel 1's hand-written instances (``csrc/fused_ik.cu``, one library per
family, chain length and type, built at first use by
``ops/_build.py::build_fused_ik``) at every size the port takes, on one
CUDA card:

    python3 scripts/fused_ik_instances.py [--tree DIR] [--label NAME] [--no-times]

Builds every instance, planar and spatial, n = 1..31, float and double (8
nvcc processes at a time, each instance's own), and prints one JSON object
per instance: its build seconds, the optimization level (-O3, or -O1 past
``_build.LARGE_FUSED_IK_N``), and ptxas's registers, spill stores and stack
frame. Then, unless ``--no-times``, the float instances' held kernel time at
B = 8192 and 1 on ``instances.planar_instances`` / ``spatial_instances``
at the bench budget 4/2/1 (Mehrotra, Armijo), the timer of chip_smoke.py.
Prints the card's name and power limit first. Exits non-zero without a CUDA
card."""

import argparse
import time

from kernel_timing import add_tree_args, open_tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    ap.add_argument("--no-times", action="store_true", help="only build and report ptxas")
    args = ap.parse_args()
    timer, _, row = open_tree("fused_ik_instances", args)

    import torch

    from mini_opt_tpu_torch.instances import planar_instances, spatial_instances
    from mini_opt_tpu_torch.ops import _build
    from mini_opt_tpu_torch.ops import fused_ik as fik

    families = {0: "planar", 1: "spatial"}
    ns = range(fik.CUDA_MIN_N, fik.CUDA_MAX_N + 1)
    instances = [(f, n, dbl) for f in families for n in ns for dbl in (False, True)]
    t0 = time.perf_counter()
    paths = _build.build_fused_ik(instances)
    row(built=len(paths), wall_s=round(time.perf_counter() - t0, 1))
    for (f, n, dbl), path in zip(instances, paths):
        secs = path.with_suffix(".seconds")
        for name, regs, spill, _, stack in timer.ptxas_report(path.with_suffix(".log").read_text()):
            if "fused_ik_kernel" in name:
                row(family=families[f], n=n, dtype="float64" if dbl else "float32",
                    opt="-O1" if n > _build.LARGE_FUSED_IK_N else "-O3",
                    build_s=float(secs.read_text()) if secs.exists() else None, registers=regs,
                    spill_store_bytes=spill, stack_frame_bytes=stack)
    if args.no_times:
        return
    for f, kind in families.items():
        make = planar_instances if kind == "planar" else spatial_instances
        for n in ns:
            family = (fik.planar_family if kind == "planar" else fik.spatial_family)(n, 0.4)
            data, x0 = make(8192, n, seed=n)
            d, x = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (data, x0))
            out = {}
            for B in (8192, 1):
                ms, _ = timer.time_ms(lambda: fik._fused_solve_cuda(family, d[:B], x[:B], 4, 2, 1, "armijo", "mpc",
                                                                     False), repeats=3, launches=5, held=True)
                out[f"ms_B{B}"] = ms
            row(family=kind, n=n, dtype="float32", budget="4/2/1 mpc armijo", **out)


if __name__ == "__main__":
    main()
