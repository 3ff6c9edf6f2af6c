#!/usr/bin/env python3
"""Times of the matrix-free CG path (``nls_solve(qp_solver="cg")``) on one
CUDA card at the scale points that ``chip_smoke.py`` leaves out:

    python3 scripts/cg_path_times.py [--only scale ba_sparse]

* ``scale``: the JAX repo's ``pose_graph_scale_bench``
  (scripts/bench_extras.py:301): a 10,000-pose SE(2) circle graph (30,000
  variables, 10,998 edges), ``chordal_initialization`` under the tree
  preconditioner at 1,200 CG trips, then 3 Gauss-Newton iterations of
  ``solve_pose_graph_large`` (tree, 400 trips), float32;
* ``ba_sparse``: ``bundle_adjustment_sparse_bench`` (:1552): 64 cameras x
  8,192 landmarks, each seen by 4 cameras, the sparse exact-Schur
  preconditioner, 20 Gauss-Newton iterations of 2 CG trips, float32.

Each path prints one JSON row: its wall time (host clock, synchronized),
the device memory it allocates at its peak, the result's quality (final cost; drift against
the ground truth, or the largest landmark error), and one Gauss-Newton
step's device operations a CG trip and outside the trips (one step
captured in a CUDA graph), ms a CG trip and the preconditioner factory's
ms. The card's name and power limit come first. Imports torch, numpy, the
port and ``chip_smoke.py``'s helpers; never jax. Exits non-zero without a
CUDA card or when a result is not finite.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=["scale", "ba_sparse"], choices=["scale", "ba_sparse"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cg_path_times.py: torch.cuda.is_available() is False: it times the card")
    import chip_smoke as cs
    from mini_opt_tpu_torch.instances import circle_graph
    from mini_opt_tpu_torch.models import pose_graph as pg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    def row(**kw):
        print(json.dumps(dict(card=card, device=torch.cuda.get_device_name(0), **kw)), flush=True)

    if "scale" in args.only:
        n = 10000
        gt, edges, meas, x0 = circle_graph(n, seed=7, noise=0.01, loop_every=10)
        m = torch.as_tensor(meas, dtype=torch.float32, device="cuda")
        w = torch.ones(len(edges), dtype=torch.float32, device="cuda")
        anchor = torch.as_tensor(x0[0], dtype=torch.float32, device="cuda")

        def pipeline():
            xc = pg.chordal_initialization(n, edges, m, w, anchor_pose=anchor, cg_iterations=1200,
                                           preconditioner="tree")
            return pg.solve_pose_graph_large(n, edges, m, w, xc, params=pg.default_pose_graph_params(torch.float32, 3),
                                             cg_iterations=400, preconditioner="tree")

        peak, (secs, res) = cs.device_bytes(lambda: cs.wall_s(pipeline))
        if not torch.isfinite(res.x).all():
            sys.exit("scale: a non-finite result")
        prof = cs.cg_step_profile(pg.make_pose_graph_problem(n, edges, m, w), res.x,
                                  prec_fn=pg.make_tree_preconditioner(n, edges, m, w), trips=(1, 3, 11))
        row(path="pose_graph_scale: chordal(tree, cg 1200) + 3 GN (tree, cg 400)", n_poses=n, variables=3 * n,
            edges=int(len(edges)), wall_s=secs, peak_bytes=peak, f_final=float(res.errors.f),
            drift_before=cs.drift(x0, gt, 2), drift_after=cs.drift(res.x.cpu(), gt, 2),
            gn_iterations=int(res.num_iterations), dtype="float32", **prof)

    if "ba_sparse" in args.only:
        C, L, k = 64, 8192, 4
        scene = cs.ba_scene(C, L, k)
        t0 = time.perf_counter()
        peak, (secs, (res, problem, prec)) = cs.device_bytes(
            lambda: cs.wall_s(lambda: cs.ba_solve(scene, C, L, "cuda", torch.float32, sparse=True)))
        if not torch.isfinite(res.x).all():
            sys.exit("ba_sparse: a non-finite result")
        x = res.x[0].double().cpu().numpy()
        prof = cs.cg_step_profile(problem, res.x[0], prec_fn=prec, trips=(1, 2, 11))
        row(path=f"bundle_adjustment_sparse: C={C} L={L} k={k}, sparse Schur, 20 GN x cg 2",
            observations=int(scene[0].shape[0]), variables=6 * C + 3 * L, wall_s=secs, peak_bytes=peak,
            f_final=float(res.errors.f[0]), max_landmark_err=float(np.abs(x[6 * C:] - scene[2][6 * C:]).max()),
            gn_iterations=int(res.num_iterations[0]), setup_and_run_s=time.perf_counter() - t0, dtype="float32",
            **prof)


if __name__ == "__main__":
    main()
