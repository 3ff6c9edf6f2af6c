#!/usr/bin/env python3
"""Held times of kernels 8 and 9 of the PyTorch port (the MPC cold solve and
the servo loop, ``mini_opt_tpu_torch/ops/mpc.py``) on one CUDA card, at
B = 1, 1024 and 8192, so that two trees can be compared on one card.

    python3 scripts/mpc_kernel_times.py [--tree DIR] [--label NAME]

DIR (default: this checkout) is the root of the tree whose
``mini_opt_tpu_torch`` is timed; its kernels build into ``DIR/build/kernels``.
The timer is ``chip_smoke.time_ms`` of this checkout (held: a device-side
sleep holds the stream while the calls are issued). Settings are
chip_smoke.py phase 20's: the cart-pole at T = 20, dt = 0.05, float32, on
``instances.cartpole_mpc_instances(B, 0)``; kernel 8 at the cold budget
8/3/2 from the cold initial guess; kernel 9 at 1/1/1 from the cold-solved,
shifted warm start, per period as (servo(65) - servo(1)) / 64; the
quadrotor at T = 12 (kernel 8 at 8/3/2, kernel 9 at 2/1/1) at B = 1024;
and kernel 8 on the cart-pole at B = 1 and 1024 under budgets that part
its time: 8 outer iterations with 0, 1 or 3 QP iterations and 0 or 2
line-search probes. Prints the card's name and power limit, then one JSON object per
measurement. Exits non-zero without a CUDA card."""

import argparse

from kernel_timing import add_tree_args, open_tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_tree_args(ap)
    args = ap.parse_args()
    timer, _, row = open_tree("mpc_kernel_times", args)

    import torch

    from mini_opt_tpu_torch import fused_mpc_solve_batch
    from mini_opt_tpu_torch.instances import cartpole_mpc_instances, quadrotor_mpc_instances
    from mini_opt_tpu_torch.models import mpc as mpcm
    from mini_opt_tpu_torch.ops import mpc as pm
    K = 65

    T, dt = 20, 0.05
    fam = pm.cartpole_mpc_family(T, dt)
    cart = mpcm.CartPole()
    for B in (1, 1024, 8192):
        x0 = torch.as_tensor(cartpole_mpc_instances(B, 0), dtype=torch.float32, device="cuda")
        z0 = mpcm.initial_guess(cart, x0, T, dt)
        z = fused_mpc_solve_batch(fam, x0, z0, 8, 3, 2)
        x1 = mpcm.rk4_step(cart, x0, z[:, 0], dt)
        z1 = mpcm.shift_warm_start(cart, z, T, dt)
        xt, zt, x1t, z1t = (a.T.contiguous() for a in (x0, z0, x1, z1))
        k8, k8_all = timer.time_ms(lambda: pm._mpc_cuda(fam, xt, zt, 8, 3, 2), launches=10, held=True)
        s1, _ = timer.time_ms(lambda: pm._mpc_servo_cuda(fam, x1t, z1t, 1, 1, 1, 1), launches=10, held=True)
        sK, sK_all = timer.time_ms(lambda: pm._mpc_servo_cuda(fam, x1t, z1t, K, 1, 1, 1), launches=3, held=True)
        row(kernel=8, plant="cartpole", T=T, B=B, budget="8/3/2", ms=k8, repeats=k8_all)
        row(kernel=9, plant="cartpole", T=T, B=B, budget="1/1/1", ms_per_period=(sK - s1) / (K - 1),
            servo1_ms=s1, servo65_ms=sK, repeats65=sK_all)

    qfam = pm.quadrotor_mpc_family(12, dt)
    B = 1024
    xq = torch.as_tensor(quadrotor_mpc_instances(B, 0), dtype=torch.float32, device="cuda")
    zq0 = mpcm.family_initial_guess(qfam, xq)
    zq = fused_mpc_solve_batch(qfam, xq, zq0, 8, 3, 2)
    xt, zt, zqt = (a.T.contiguous() for a in (xq, zq0, zq))
    k8, k8_all = timer.time_ms(lambda: pm._mpc_cuda(qfam, xt, zt, 8, 3, 2), launches=10, held=True)
    s1, _ = timer.time_ms(lambda: pm._mpc_servo_cuda(qfam, xt, zqt, 1, 2, 1, 1), launches=10, held=True)
    sK, _ = timer.time_ms(lambda: pm._mpc_servo_cuda(qfam, xt, zqt, K, 2, 1, 1), launches=3, held=True)
    row(kernel=8, plant="quadrotor", T=12, B=B, budget="8/3/2", ms=k8, repeats=k8_all)
    row(kernel=9, plant="quadrotor", T=12, B=B, budget="2/1/1", ms_per_period=(sK - s1) / (K - 1))

    # Where kernel 8's time goes: the same solve with fewer QP iterations
    # or line-search probes (each outer iteration runs one Riccati factor
    # and solve besides those of its QP iterations).
    for B in (1, 1024):
        x0 = torch.as_tensor(cartpole_mpc_instances(B, 0), dtype=torch.float32, device="cuda")
        xt, zt = x0.T.contiguous(), mpcm.initial_guess(cart, x0, T, dt).T.contiguous()
        sweep = {}
        for bud in ((8, 0, 0), (8, 1, 0), (8, 3, 0), (8, 0, 2), (8, 3, 2)):
            sweep["/".join(map(str, bud))], _ = timer.time_ms(lambda: pm._mpc_cuda(fam, xt, zt, *bud), launches=5,
                                                               held=True)
        row(kernel=8, plant="cartpole", T=T, B=B, budget_sweep_ms=sweep,
            ms_per_qp_iteration=(sweep["8/3/0"] - sweep["8/0/0"]) / 24,
            ms_per_line_search_probe=(sweep["8/0/2"] - sweep["8/0/0"]) / 16,
            ms_per_outer_iteration_without_qp_iterations=sweep["8/0/0"] / 8)


if __name__ == "__main__":
    main()
