#!/usr/bin/env python3
"""Held times of kernel 2 of the PyTorch port (the blocked-tier fused SQP,
``mini_opt_tpu_torch/ops/blocked.py``) on one CUDA card, at B = 1, 1024 and
8192, so that two trees can be compared on one card; kernel 3 (the
standalone KKT solve) beside it as the control.

    python3 scripts/blocked_kernel_times.py [--tree DIR] [--label NAME] [--subset] [--pose16]

DIR (default: this checkout) is the root of the tree whose
``mini_opt_tpu_torch`` is timed; its kernels build into ``DIR/build/kernels``.
The timer is ``chip_smoke.time_ms`` of this checkout (held: a device-side
sleep holds the stream while the calls are issued). Settings are
chip_smoke.py phase 8's: the 48-joint arm of examples/blocked_medium_n.py
(D = 49, link 0.4), float32, on ``instances.medium_n_planar_instances(B,
48, seed=0)``, at the example's budget 6/3/2 with the Mehrotra barrier and
the Armijo line search; then, at B = 1 and 8192, the same solve under
budgets that part its time: 6 outer iterations with 0, 1 or 3 QP
iterations and 0 or 2 line-search probes, and 6/3/2 with the
complementarity barrier; and kernel 3 at B = 8192, D = 49, float32, on
chip_smoke.kkt_systems(8192, 49, seed=7). ``--subset`` builds only the
tree's kernel-2 and kernel-3 sources (``csrc/blocked*.cu``; the other entry
points stay unbound). ``--pose16`` also times the generated pose chain
N = 16 + (4, 12) (D = 48, chip_smoke.py phase 28's cell: float32, 5/1/2,
B = 8192, ``instances.chain_closure_instances``) on the tree's kernel 2,
emitted and built with the tree's emitter. Prints the card's name and power
limit, then one JSON object per measurement. Exits non-zero without a CUDA
card."""

import argparse

from kernel_timing import add_tree_args, bind_subset, open_tree
ARM_N, LINK = 48, 0.4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    ap.add_argument("--subset", action="store_true", help="build only csrc/blocked*.cu")
    ap.add_argument("--pose16", action="store_true", help="also time the generated pose chain N = 16")
    args = ap.parse_args()
    timer, _, row = open_tree("blocked_kernel_times", args)

    import torch

    from mini_opt_tpu_torch.ops import _build

    if args.subset:
        bind_subset(_build, {p.name for p in _build.CSRC.glob("blocked*.cu")})

    from mini_opt_tpu_torch import batch_from_numpy
    from mini_opt_tpu_torch.instances import medium_n_planar_instances
    from mini_opt_tpu_torch.ops import blocked as blk
    from mini_opt_tpu_torch.ops import fused_ik as fik

    arm = fik.planar_family(ARM_N, LINK)
    inputs = {}
    for B in (1, 1024, 8192):
        data, x0 = medium_n_planar_instances(B, ARM_N, seed=0)
        inputs[B] = batch_from_numpy(data, x0, "cuda", torch.float32)

    def solve(B, budget, barrier="mpc"):
        data_t, x0_t = inputs[B]
        return lambda: blk._blocked_solve_cuda(arm, data_t, x0_t, *budget, "armijo", barrier)

    plan = getattr(blk, "launch_plan", None)
    for B in (1, 1024, 8192):
        ms, repeats = timer.time_ms(solve(B, (6, 3, 2)), launches=10, held=True)
        extra = {}
        if plan is not None:
            # A tree before slab shapes takes the joint count itself.
            shape = blk.planar_slab_shape(ARM_N) if hasattr(blk, "planar_slab_shape") else ARM_N
            p = plan(shape, B, torch.float32)
            extra = dict(warps_per_cta=p.warps, cta_bytes=p.cta_bytes, grid=p.grid)
        row(kernel=2, B=B, D=ARM_N + 1, budget="6/3/2 mpc armijo", ms=ms, repeats=repeats, **extra)

    # Where kernel 2's time goes: per outer iteration, one factor and solve
    # of the equality-constrained guess, then per QP iteration one factor
    # and two (Mehrotra) or one (complementarity) solves; then the probes.
    for B in (1, 8192):
        sweep = {}
        for budget in ((6, 0, 0), (6, 1, 0), (6, 3, 0), (6, 3, 2)):
            sweep["/".join(map(str, budget))], _ = timer.time_ms(solve(B, budget), launches=5, held=True)
        sweep["6/3/2 complementarity"], _ = timer.time_ms(solve(B, (6, 3, 2), "complementarity"),
                                                          launches=5, held=True)
        row(kernel=2, B=B, D=ARM_N + 1, budget_sweep_ms=sweep,
            ms_per_qp_iteration=(sweep["6/3/0"] - sweep["6/0/0"]) / 18,
            ms_per_line_search_probe=(sweep["6/3/2"] - sweep["6/3/0"]) / 12,
            ms_per_outer_iteration_without_qp_iterations=sweep["6/0/0"] / 6)

    H, rhs = timer.kkt_systems(8192, ARM_N + 1, seed=7, dtype=torch.float32)
    ms, repeats = timer.time_ms(lambda: blk._blocked_kkt_solve_cuda(H, rhs), held=True)
    row(kernel=3, B=8192, D=ARM_N + 1, ms=ms, repeats=repeats)

    if args.pose16:
        from mini_opt_tpu_torch import family_from_problem
        from mini_opt_tpu_torch.instances import chain_closure_instances, chain_edges
        from mini_opt_tpu_torch.models import pose_graph as pg

        closures = ((4, 12),)
        edges = chain_edges(16, closures)
        fam = family_from_problem(pg.scalar_pose_graph_builder(16, edges), 3 * len(edges))
        data, x0 = chain_closure_instances(8192, 16, closures, seed=0)
        data_t, x0_t = batch_from_numpy(data, x0, "cuda", torch.float32)
        pose = lambda: blk._blocked_solve_cuda(fam, data_t, x0_t, 5, 1, 2, "armijo", "mpc")  # noqa: E731
        ms, repeats = timer.time_ms(pose, launches=10, held=True)
        row(kernel=2, family="generated pose N=16 + (4, 12)", B=8192, D=48, budget="5/1/2 mpc armijo", ms=ms,
            repeats=repeats)


if __name__ == "__main__":
    main()
