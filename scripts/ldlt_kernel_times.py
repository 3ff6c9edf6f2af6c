#!/usr/bin/env python3
"""Held times of kernels 4 and 5 of the PyTorch port (the general path's
lane-batched LDL^T factor and solve, ``mini_opt_tpu_torch/ops/ldlt.py``) on
one CUDA card, so that two trees can be compared on one card.

    python3 scripts/ldlt_kernel_times.py [--tree DIR] [--label NAME] [--subset] [--general]

DIR (default: this checkout) is the root of the tree whose
``mini_opt_tpu_torch`` is timed; its kernels build into ``DIR/build/kernels``.
``--subset`` builds only ``ldlt.cu`` instead of every ``csrc/*.cu`` (the
other entry points are then left unbound). The timer is
``chip_smoke.time_ms`` of this checkout: held (a device-side sleep holds
the stream while the calls are issued, so the events time the card's work
alone) and, for the pair, unheld (as a caller issues it).

Measured, on ``chip_smoke.kkt_systems`` (quasi-definite KKT systems made
from a seed, float32):
- the launch floor: a held, back-to-back ``torch.cuda._sleep(1)`` (a kernel
  that spins one cycle) and a one-element ``add_``, the least a launch
  costs on the card in this harness;
- at B = 1, 1024 and 8192 and D = 3 (the general path's), 5, 8, 9, 17 and
  40, and in float64 at D = 3: the factor kernel alone, the solve kernel
  alone (on the factor's output), and the ``factorize(H)`` +
  ``solve(fact, rhs)`` pair as ``ops/kkt.py`` calls it on the general path.

``--general`` (not with ``--subset``: it needs every kernel) also times the
general path the kernels serve, ``solve_ik_batch`` on the
``kkt_solver="pallas_ldlt"`` route at ``chip_smoke.py`` phase 12's settings
(planar n = 2, float32, B = 8192, 10/6/2), as a caller issues it (median of
3 calls), and counts its device kernels under ``torch.profiler``.

Both kernels are given batch-major ``H (B, D, D)`` and ``rhs (B, D)``; a tree
whose wrappers take feature-major tensors (no ``ldlt_launch_plan``) gets
them copied beforehand, outside the timed calls. Past the register route's
cap the wrappers copy them feature-major inside the timed calls; the rows
then also give the generic kernels alone (``factor_kernel_ms``,
``solve_kernel_ms``), launched on copies made beforehand, as the other
tree's are. Prints the card's name and
power limit, then one JSON object per measurement. Exits non-zero without a
CUDA card."""

import argparse
import sys

import numpy as np

from kernel_timing import add_tree_args, bind_subset, open_tree

SIZES = [(B, D, "float32") for D in (3, 5, 8, 9, 17, 40) for B in (1, 1024, 8192)]
SIZES += [(B, 3, "float64") for B in (1, 1024, 8192)]


def generic_kernels_ms(lib, H, rhs, Lt, dt, timer):
    """Held times of the generic route's factor and solve kernels alone, on
    feature-major copies of H and rhs made beforehand."""
    import torch

    B, D = rhs.shape
    Ht, rt = H.permute(1, 2, 0).contiguous(), rhs.T.contiguous()
    L2, d2, x2 = torch.empty_like(Ht), torch.empty_like(rt), torch.empty_like(rt)
    ok = torch.empty(B, dtype=torch.bool, device=H.device)
    kind = 0 if H.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    def factor():
        if lib.mo_ldlt_factor_launch(kind, D, Ht.data_ptr(), L2.data_ptr(), d2.data_ptr(), ok.data_ptr(), B, stream):
            sys.exit("ldlt_kernel_times: the generic factor kernel did not launch")

    def solve():
        if lib.mo_ldlt_solve_launch(kind, D, Lt.data_ptr(), dt.data_ptr(), rt.data_ptr(), x2.data_ptr(), B, stream):
            sys.exit("ldlt_kernel_times: the generic solve kernel did not launch")

    factor_ms, _ = timer.time_ms(factor, held=True)
    solve_ms, _ = timer.time_ms(solve, held=True)
    return dict(factor_kernel_ms=factor_ms, solve_kernel_ms=solve_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    ap.add_argument("--subset", action="store_true", help="build only ldlt.cu")
    ap.add_argument("--general", action="store_true", help="also time solve_ik_batch on the pallas_ldlt route")
    args = ap.parse_args()
    if args.subset and args.general:
        raise SystemExit("ldlt_kernel_times: --general needs every kernel, not --subset")
    timer, _, row = open_tree("ldlt_kernel_times", args)

    import torch

    import mini_opt_tpu_torch
    from mini_opt_tpu_torch.ops import _build
    from mini_opt_tpu_torch.ops import ldlt

    if args.subset:
        bind_subset(_build, ("ldlt.cu",))
    else:
        _build.load_library()
    batch_major = hasattr(ldlt, "ldlt_launch_plan")

    floor_ms, floor_parts = timer.launch_floor_ms()
    row(launch_floor_ms=floor_ms, **floor_parts)

    for B, D, dtype_name in SIZES:
        dtype = getattr(torch, dtype_name)
        H, rhs = timer.kkt_systems(B, D, seed=D, dtype=dtype)
        if batch_major:
            h_arg, r_arg = H, rhs
        else:
            h_arg, r_arg = H.permute(1, 2, 0).contiguous(), rhs.T.contiguous()
        Lt, dt = ldlt._ldlt_factor_cuda(h_arg)[:2]

        def pair():
            fact, _ = ldlt.factorize(H)
            return ldlt.solve(fact, rhs)

        factor_ms, factor_all = timer.time_ms(lambda: ldlt._ldlt_factor_cuda(h_arg), held=True)
        solve_ms, solve_all = timer.time_ms(lambda: ldlt._ldlt_solve_cuda(Lt, dt, r_arg), held=True)
        pair_ms, pair_all = timer.time_ms(pair, held=True)
        pair_unheld_ms, _ = timer.time_ms(pair)
        extra = {}
        if batch_major:
            p = ldlt.ldlt_launch_plan(D, B)
            extra = dict(route=p.route, threads=p.threads, grid=p.grid)
            if p.route == "generic":
                # The wrappers time a feature-major copy with the kernel
                # here; the kernels alone, launched on copies made once:
                extra.update(generic_kernels_ms(_build.load_library(), H, rhs, Lt, dt, timer))
        row(B=B, D=D, dtype=dtype_name, factor_ms=factor_ms, solve_ms=solve_ms, pair_ms=pair_ms,
            pair_unheld_ms=pair_unheld_ms, repeats=dict(factor=factor_all, solve=solve_all, pair=pair_all),
            **extra)

    if args.general:
        from mini_opt_tpu_torch.instances import planar_instances

        targets, x0 = (a.astype(np.float32) for a in planar_instances(timer.GENERAL_B, 2, seed=0))
        params = timer.general_params("pallas_ldlt")
        entry = lambda: mini_opt_tpu_torch.solve_ik_batch(targets, x0, params=params)  # noqa: E731
        ms, repeats = timer.time_ms(entry, repeats=3, launches=1, warmup=1)
        _, busy_ms, n_kernels, _ = timer.profile_call(entry)
        row(general_path="solve_ik_batch pallas_ldlt planar n=2 float32 10/6/2", B=timer.GENERAL_B,
            ms_per_call=ms, repeats=repeats, device_kernels_per_call=n_kernels, device_busy_ms=busy_ms)


if __name__ == "__main__":
    main()
