#!/usr/bin/env python3
"""Held times of kernel 7 of the PyTorch port (the SE(2) pose-ring whole
solve, ``mini_opt_tpu_torch/ops/pose_ring.py``) on one CUDA card, at B = 1,
1024 and 8192, so that two trees can be compared on one card; kernel 3 (the
standalone blocked KKT solve) beside it.

    python3 scripts/pose_ring_kernel_times.py [--tree DIR] [--label NAME] [--subset] [--spans] [--routes]

DIR (default: this checkout) is the root of the tree whose
``mini_opt_tpu_torch`` is timed; its kernels build into ``DIR/build/kernels``.
``--subset`` builds only the sources of kernels 7 and 3 (pose_ring.cu,
pose_ring_f64.cu, blocked_kkt.cu) instead of every ``csrc/*.cu``, which
saves most of a tree's build time; the other entry points are then left
unbound. The timer is ``chip_smoke.time_ms`` of this checkout (held: a
device-side sleep holds the stream while the calls are issued). Settings
are chip_smoke.py phase 16's: the canonical ring N = 16, float32, on
``instances.ring_instances(B, 16, seed=0)`` at the bench budget 6/2 (6
outer iterations, 2 line-search probe halvings); then, at B = 1 and 8192,
the same solve under budgets that part its time: 6/0 (no halving: one
probe per iteration), 1/0, and 6/2 on the closures ((15, 0), (4, 11))
(k = 4 border poses); and kernel 3 at B = 1 and 8192, D = 49, float32, on
chip_smoke.kkt_systems(8192, 49, seed=7). ``--routes`` prints instead, for
each of chip_smoke.py phase 14's multi-closure topologies (k = 2..6), the
template route's and the run-time route's held times at B = 8192, 6/2, in
turns, and whether they give the same bits. ``--spans`` (this checkout's
kernel only) builds kernel 7 once more with MO_RING_SPANS defined and
prints the clock64() cycles of each phase of one graph's solve at B = 1,
6/2. Prints the card's name and power limit, then one JSON object per
measurement. Exits non-zero without a CUDA card."""

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

from kernel_timing import ROOT, add_tree_args, bind_subset, open_tree

RING_N = 16
SPAN_NAMES = ("setup", "linearize", "solve", "step_dot", "line_search", "update", "write_out")


def span_cycles(build, fam, data_t, x0_t, budget):
    """Kernel 7 built with MO_RING_SPANS: the phase cycles of one graph."""
    import torch

    out_dir = Path(build.BUILD_DIR) / "spans"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        srcs = [build.CSRC / "pose_ring.cu", build.CSRC / "pose_ring_f64.cu"]
        objs = [str(Path(tmp) / (p.stem + ".o")) for p in srcs]
        build._run_all([[nvcc, *build.NVCC_FLAGS, "-DMO_RING_SPANS", "-c", str(p), "-o", o]
                        for p, o in zip(srcs, objs)])
        lib_path = str(out_dir / "libpose_ring_spans.so")
        build._run_all([[nvcc, *build.NVCC_FLAGS, "-shared", *objs, "-o", lib_path]])
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mo_pose_ring_launch.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.c_double, p, p, p, p, p, i, i, i, i, p]
    lib.mo_pose_ring_launch.restype = i
    lib.mo_pose_ring_spans.argtypes = [p, i]
    lib.mo_pose_ring_spans.restype = i
    cl = fam.closure_list
    flat = (ctypes.c_int * (2 * len(cl)))(*(v for c in cl for v in c))
    x_out = torch.empty_like(x0_t)
    state = torch.empty((3, x0_t.shape[1]), dtype=x0_t.dtype, device=x0_t.device)
    spans = (ctypes.c_ulonglong * len(SPAN_NAMES))()

    def launch():
        rc = lib.mo_pose_ring_launch(0, fam.n_poses, len(cl), flat, ctypes.c_double(float(fam.anchor_weight)),
                                     data_t.data_ptr(), x0_t.data_ptr(), x_out.data_ptr(), state.data_ptr(), None,
                                     1, 1, *budget, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"pose_ring_kernel_times: spans launch failed ({rc})")

    launch()  # warm-up
    torch.cuda.synchronize()
    if lib.mo_pose_ring_spans(None, 1) != 0:
        sys.exit("pose_ring_kernel_times: could not reset the spans")
    launch()
    torch.cuda.synchronize()
    if lib.mo_pose_ring_spans(spans, 0) != 0:
        sys.exit("pose_ring_kernel_times: could not read the spans")
    return dict(zip(SPAN_NAMES, (int(v) for v in spans)))


# chip_smoke.py phase 14's multi-closure topologies at N = 16 (k = 2..6
# border poses), each within the template route's limits.
ROUTE_TOPOLOGIES = (((2, 9), (9, 2)), ((2, 9), (9, 13)), ((15, 0), (4, 11)), ((1, 5), (5, 9), (11, 14)),
                    ((0, 4), (6, 9), (11, 15)))


def route_rows(timer, row, torch, pr, chain_closure_instances, batch_from_numpy, B=8192):
    """Kernel 7 on each of ROUTE_TOPOLOGIES at B = 8192, float32, 6/2: the
    template route (``launch<T, K>``, the schedule passed by value) and the
    run-time route (the schedule a device table, the Schur system in the
    slab), the latter forced by setting the template limits to 0, in turns
    (template, run-time, run-time, template), held; and whether the two
    give the same bits."""
    limits = pr.TEMPLATE_MAX_CLOSURES, pr.TEMPLATE_MAX_BORDERS

    def route(table):
        pr.TEMPLATE_MAX_CLOSURES, pr.TEMPLATE_MAX_BORDERS = (0, 0) if table else limits

    for closures in ROUTE_TOPOLOGIES:
        fam = pr.pose_ring_family(RING_N, closures=closures)
        data, x0 = chain_closure_instances(B, RING_N, closures, seed=0)
        data_t, x0_t = batch_from_numpy(data, x0, "cuda", torch.float32)
        solve = lambda: pr._pose_ring_cuda(fam, data_t, x0_t, 6, 2)  # noqa: E731
        got, ms = {}, {"template": [], "run-time": []}
        for table in (False, True, True, False):
            route(table)
            name = "run-time" if table else "template"
            got[name] = solve()
            ms[name].append(timer.time_ms(solve, launches=10, held=True)[0])
        route(False)
        same = all(torch.equal(a, b) for a, b in zip(got["template"], got["run-time"]))
        k = len({p for c in closures for p in c})
        row(kernel=7, N=RING_N, closures=closures, k=k, B=B, budget="6/2", dtype="float32",
            template_ms=ms["template"], runtime_ms=ms["run-time"], bit_identical=same)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    ap.add_argument("--subset", action="store_true", help="build only kernels 7 and 3's sources")
    ap.add_argument("--spans", action="store_true", help="also print the phase cycles of one graph")
    ap.add_argument("--routes", action="store_true",
                    help="only the k = 2..6 topologies on the template route and the run-time route")
    args = ap.parse_args()
    timer, _, row = open_tree("pose_ring_kernel_times", args)

    import torch

    from mini_opt_tpu_torch import batch_from_numpy
    from mini_opt_tpu_torch.instances import chain_closure_instances, ring_instances
    from mini_opt_tpu_torch.ops import _build
    from mini_opt_tpu_torch.ops import blocked as blk
    from mini_opt_tpu_torch.ops import pose_ring as pr

    if args.subset:
        bind_subset(_build, ("blocked_kkt.cu", "pose_ring.cu", "pose_ring_f64.cu"))

    if args.routes:
        return route_rows(timer, row, torch, pr, chain_closure_instances, batch_from_numpy)

    ring = pr.pose_ring_family(RING_N)
    closures = ((15, 0), (4, 11))
    multi = pr.pose_ring_family(RING_N, closures=closures)
    inputs = {}
    for B in (1, 1024, 8192):
        data, x0 = ring_instances(B, RING_N, seed=0)
        inputs["ring", B] = batch_from_numpy(data, x0, "cuda", torch.float32)
    for B in (1, 8192):
        data, x0 = chain_closure_instances(B, RING_N, closures, seed=0)
        inputs["k4", B] = batch_from_numpy(data, x0, "cuda", torch.float32)

    def solve(B, budget, kind="ring"):
        data_t, x0_t = inputs[kind, B]
        fam = ring if kind == "ring" else multi
        return lambda: pr._pose_ring_cuda(fam, data_t, x0_t, *budget)

    plan = getattr(pr, "launch_plan", None)
    for B in (1, 1024, 8192):
        ms, repeats = timer.time_ms(solve(B, (6, 2)), launches=10, held=True)
        extra = {}
        if plan is not None:
            p = plan(RING_N, 1, B, torch.float32)
            extra = dict(warps_per_cta=p.warps, cta_bytes=p.cta_bytes, grid=p.grid, storage=p.storage)
        row(kernel=7, B=B, N=RING_N, budget="6/2", ms=ms, repeats=repeats, **extra)

    # Where kernel 7's time goes: 6/0 against 6/2 parts the two probe
    # halvings from the rest, 1/0 one outer iteration, and the closures
    # ((15, 0), (4, 11)) the k = 4 Schur route at the same budget.
    for B in (1, 8192):
        sweep = {}
        for budget in ((6, 0), (6, 2), (1, 0)):
            sweep["/".join(map(str, budget))], _ = timer.time_ms(solve(B, budget), launches=5, held=True)
        sweep["6/2 closures ((15, 0), (4, 11))"], _ = timer.time_ms(solve(B, (6, 2), "k4"), launches=5, held=True)
        row(kernel=7, B=B, N=RING_N, budget_sweep_ms=sweep,
            ms_per_probe_halving=(sweep["6/2"] - sweep["6/0"]) / 12,
            ms_per_outer_iteration_without_halving=sweep["6/0"] / 6)

    H, rhs = timer.kkt_systems(8192, 49, seed=7, dtype=torch.float32)
    kkt_plan = getattr(blk, "kkt_launch_plan", None)
    for B in (1, 8192):
        H_b, rhs_b = H[:B].contiguous(), rhs[:B].contiguous()
        ms, repeats = timer.time_ms(lambda: blk._blocked_kkt_solve_cuda(H_b, rhs_b), held=True)
        extra = {}
        if kkt_plan is not None:
            p = kkt_plan(49, B, torch.float32)
            extra = dict(route=p.route, warps_per_cta=p.warps, cta_bytes=p.cta_bytes, grid=p.grid)
        row(kernel=3, B=B, D=49, ms=ms, repeats=repeats, **extra)

    if args.spans:
        if Path(args.tree).resolve() != ROOT:
            sys.exit("pose_ring_kernel_times: --spans times this checkout's kernel only")
        data_t, x0_t = inputs["ring", 1]
        cycles = span_cycles(_build, ring, data_t, x0_t, (6, 2))
        row(kernel=7, B=1, N=RING_N, budget="6/2", clock64_cycles_per_phase=cycles,
            total_cycles=sum(cycles.values()))


if __name__ == "__main__":
    main()
