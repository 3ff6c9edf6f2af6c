#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mini_opt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (H100), the CUDA toolkit's nvcc and the repo
checkout; imports torch, numpy and the port, never jax or mini_opt_tpu.
Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 1;
2. build csrc/ with nvcc for sm_90a and, beside it, the hand-written
   kernel-1 instances phases 3-4 and 35 launch (one nvcc each,
   csrc/fused_ik.cu at one family, n and type); print the build seconds and each kernel-1
   instance's ptxas registers, spill stores, stack frame and build seconds;
3. the kernel against its plain PyTorch version on batch-major card
   tensors, bit for bit in float64 and float32, flags and history included
   (the kernel's parity printed beside): at B = 8192 + 13 (a ragged
   edge, one NaN-target lane and one NaN-start lane) planar n=2 at the
   bench budget, planar n=4 at 10/6/2 complementarity + polynomial with
   history, spatial n=3 at 4/2/1; planar n=2 at B = 1; planar n=4 with
   history at B = 33 on non-contiguous caller tensors;
4. the main path through the public entry point fused_ik_solve_batch at the
   bench budget in float32 at B = 8192 (parity must be 1.0) and B = 262144,
   with the launch counter set to 0 just before and read just after; its
   B = 8192 outputs against the plain version's; then CUDA-event timings
   (median of 5 repeats of 20 calls) of the entry point as a caller issues
   it, of its device work, and of the kernel alone on the card; one device
   kernel a call on card tensors (one launch on the counter, one kernel
   node in a CUDA graph of one call, and 20 calls under torch.profiler
   record no other device kernel; kernels_a_call),
   the kernel alone at B = 1, and the plain version's time at B = 8192;
5. kernel 2, the blocked-tier fused SQP (csrc/blocked.cu, blocked_f64.cu),
   against its plain version, bit for bit in float64 and float32, on the
   medium-N warm-start distribution: planar n=33 (D = 34) at 4/2/2
   complementarity + polynomial and n=48 (D = 49) at the example's 6/3/2
   Mehrotra + Armijo at B = 2048 + 7 with one NaN-target lane (flagged,
   every other lane finite); n=48 at B = 1 and at B = W + 1 (a ragged last
   CTA of W warps); at 2/1/1 the largest n whose float64 launch plan keeps
   W > 1 warps per CTA (B = W + 1), the next n, where W falls to 1 (B =
   2W + 1, a NaN lane), and each type's largest n (6 rows per lane);
6. the blocked KKT kernel (csrc/blocked_kkt.cu, kernel 3) against its
   plain version, bit for bit in float64 and float32, on quasi-definite KKT
   systems at B = 1037 and D = 1, 2, 7, 31, 33, 49, 64, 65, 120, 128, 129,
   169, 192 (the warp route: 2, 4 and 6 rows a lane) and, in float32,
   D = 193 and 239 (the CTA route and its limit; float64 refuses D = 193,
   as it did before); at D = 49 also B = 1 and B = W + 1 (a ragged last
   CTA); the float64 kernel also within 1e-8 of torch.linalg.solve;
7. the blocked tier's main path: fused_solve_batch on the 48-joint arm
   (examples/blocked_medium_n.py) at B = 8192 in float32 with the example's
   budget, every launch counter set to 0 just before and read just after
   (parity, effector error < 1e-3, must exceed 0.9, the example's gate), its
   outputs bit for bit against the plain version's; and the standalone path,
   blocked_kkt_solve at B = 8192, D = 49, float32, counted the same way;
8. the blocked kernels' ptxas registers, spill stores and stack frame per
   instance (from phase 2's build), kernel 2's and kernel 3's launch plans
   at the main paths' shapes in both types (warps per CTA, rows per lane,
   bytes per warp and per CTA, CTAs per SM from mo_blocked_occupancy and
   mo_blocked_kkt_occupancy); timings of both blocked kernels at the main
   paths' shapes (held and unheld as in phase 4; both also at B = 1, one
   instance's latency, and kernel 2 at B = 1024), their plain versions,
   and for the KKT solve torch.linalg.ldl_factor_ex + ldl_solve as its
   library yardstick;
9. the general path's kernels (csrc/ldlt.cu, csrc/fused_qp.cu,
   fused_qp_pairs.cu, fused_qp_k2.cu, fused_qp_warp.cu), built in phase 2's
   parallel nvcc pass: ptxas registers, spills and stack frame per instance
   (kernel 6's with its route, PairRows, AnyRows or the warp route; a spill
   in an instance of kernels 4 and 5's register route, or in a float
   PairRows instance of kernel 6 with N = 1 or K = 2, fails the run), and
   the launch plan at D = 3;
10. the LDL^T factor and solve kernels (kernels 4 and 5) against their plain
   versions, bit for bit, on batch-major H and rhs as factorize and solve
   give them: D = 1, 2, 3, 5, 9, 13 (the register route's largest), 14
   (the generic route from here), 17, 33, 40, at B = 8192 + 13 (a ragged
   last CTA, one NaN lane and one singular lane) and B = 1, both types,
   L, d, x and the kernel's per-lane ``ok`` against ``_ok`` of the plain
   factor; then a factorize + solve pair at D = 3, B = 8192 must be two
   device kernels (one launch of each on the counters, and 20 pairs under
   torch.profiler record no other device kernel);
11. the fused QP kernel (kernel 6) against its plain version, bit for
   bit, on batch-major QPs from the port's own linearization of bench
   instances at n = 2, 4 and 8, B = 8192 + 13 (one NaN-target lane), 33
   and 1, both barriers, float64 and float32: as the linearization gives
   them (the pairs route, ia a stride-0 broadcast), without the equality
   row (K = 0), on the run-time route (one more row, the rows reversed),
   and with every input a non-contiguous view; then a _fused_qp_batch call
   must be one device kernel (one launch on the counter, and 20 calls under
   torch.profiler record no other device kernel);
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
   unprofiled call (its device kernels a call beside PERF.md's 50,532 for
   the feature-major LDL^T wrappers and 34,956 for the feature-major fused
   QP wrapper), each kernel alone on the inputs the main path gave it
   (held; kernel 6 also on the first of them, B = 1), its bound, its plain
   version and, for kernels
   4 and 5, torch.linalg.ldl_factor_ex / ldl_solve, the launch floor (a
   held torch.cuda._sleep(1) and a one-element add_) and the held
   factorize + solve pair, and H's bytes read whole (B D^2) beside its
   lower triangle's;
13. the pose-ring kernel (csrc/pose_ring.cu), built in phase 2's parallel
   nvcc pass: ptxas registers, spill stores and stack frame per instance;
   kernel 7's launch plan at the main path's shape and at each type's
   smallest global-route ring in both types (graphs per CTA, bytes per
   graph and per CTA, the route, CTAs per SM from mo_pose_ring_occupancy);
14. kernel 7 against its plain version, bit for bit in float64 and
   float32, with one NaN-measurement lane and one NaN-start lane (flagged,
   every other lane finite): at B = 8192 + 13 on the canonical ring N = 16
   at 6/2 (scripts/bench_extras.py's pose_ring_bench distribution), the
   chain with the closure (12, 4) (k = 1) and the closures ((15, 0),
   (4, 11)) (k = 4) at N = 16, 5/2 (its pose_ring_chain_closure_bench
   distribution), and the ring N = 32 at 6/2; at B = 1037 one topology for
   each other border count k = 2, 3, 5, 6 at N = 16, 5/2 (float64 for k = 2
   and 5, float32 for k = 3 and 6); the ring N = 16
   at B = 1 and B = W + 1 (a ragged last CTA); and in each type the
   smallest ring N whose slab does not fit one CTA (the global-scratch
   route) at B = 67, 2/1;
15. the pose-ring main path, models.pose_graph.solve_pose_graph_rings on
   the N = 16 ring, float32, B = 8192, 6/2, with every launch counter set
   to 0 just before and read just after (exactly one pose-ring launch per
   call), the converged share (final cost < 2e-3 N, the bench's noise
   gate) at least 0.99, its outputs against the plain version's, bit for
   bit; then the two closure topologies through the same entry point (converged share,
   flags);
16. timings at the main path's shape: the entry point as a caller issues
   it, its device work and the kernel alone (held), the kernel at B = 1
   (one instance's latency), the plain version once, the bound; and the
   general twin, make_pose_graph_problem + nls_solve at 6/2
   (kkt_solver="ldlt") at B = 1024, per call and its median cost beside
   the kernel's (reported, not gated);
17. the MPC kernels (csrc/mpc.cu, mpc_f64.cu), built in phase 2's parallel
   nvcc pass: ptxas registers, spill stores and stack frame per instance
   (solve and servo, float and double, cart-pole and quadrotor), and the
   launch plan at the main path's horizon (and the quadrotor at T = 128):
   warps (instances) per CTA, dynamic shared memory per CTA, CTAs per SM;
18. kernels 8 and 9 against their plain versions, bit for bit, float64
   and float32: at B = 8192 + 13 with one NaN-state lane and one
   NaN-warm-start lane, kernel 8 on the cart-pole at T = 20 at the cold
   budget 8/3/2 and at 2/2/1 with history, and on the quadrotor at T = 12,
   8/3/2; kernel 9 on the cart-pole at 1/1/1 and the quadrotor at 2/1/1, 8
   periods each; then both plants at B = 1 and at B = W + 1 (a ragged last
   CTA of W warps), and the quadrotor at T = 128, B = 67, 1/1/1 (kernel 9
   for 2 periods), where float64 takes the global-scratch route and
   float32 one warp per CTA; the NaN lanes flagged, every other lane
   finite;
19. the MPC main path in float32 at B = 1024 (scripts/bench_extras.py's
   fleet) and B = 8192, every launch counter set to 0 just before and read
   just after: the cart-pole at mpc_servo_bench's settings (T = 20,
   dt = 0.05: fused_mpc_solve_batch at 8/3/2, exactly one kernel-8 launch;
   rk4_step and shift_warm_start; fused_mpc_servo_batch at 1/1/1 for 29
   periods, exactly one kernel-9 launch; stabilized share |theta| < 0.05 at
   least 0.99), its B = 1024 outputs against the same sequence on the plain
   versions; fused_mpc_rollout_batch at 2/2/1 for 8 steps (exactly 8
   kernel-8 launches, its stabilized share reported); the quadrotor at
   mpc_quadrotor_bench's settings (T = 12, cold 8/3/2, servo 2/1/1 for 64
   periods, one launch each; hover share at least 0.99);
20. timings (held): kernel 8 at the cold budget at B = 1024, B = 1 and
   B = 8192, kernel 9 per period as (servo(65) - servo(1)) / 64 (the bench's
   difference method) at the same three widths and its control solves/s,
   the entry points as a caller
   issues them, each plain version once, the bounds; and the general twin,
   solve_mpc batched through nls_solve with kkt_solver="riccati:20:4:1" at
   B = 1024 and 2/2/1 (Mehrotra), ms per call and its cost median beside the
   kernel's (reported, not gated);
21. families generated from a Problem (ops/fused_auto.py::family_from_problem)
   and their device programs (ops/fused_emit.py), emitted and built in
   phase 2's parallel nvcc pass: bench.py's default family (planar n = 2
   from scalar_planar_ik_builder, the _mod_pi retraction), the spatial
   chain builder at n = 3, the BlockResidual chain and the robustified line
   fit (no equality row, no bound); the emit and build seconds, and ptxas
   registers, spill stores and stack frame of each instance;
22. each generated instance of kernel 1 against its plain version (the
   family's own linearize / errors / retract in _fused_solve_plain) on card
   tensors, bit for bit in float64 and float32, flags and history
   included: at B = 8192 + 13 with one NaN-target and one NaN-start lane at
   4/2/1 Mehrotra + Armijo, at 3/2/2 complementarity + polynomial with
   history, at B = 1, and at B = 33 on non-contiguous caller tensors;
23. bench.py's default route through the public entry points in float32:
   fused_solve_batch on the generated planar family at B = 8192 (parity
   must be 1.0) and B = 262144, every launch counter set to 0 just before
   and read just after (generated launches only), one device kernel a call
   (kernels_a_call), the B = 8192 outputs bit for bit against the plain
   version and max |dx| against the hand-written family
   (fused_ik_solve_batch); then fused_chain_ik_solve on make_spatial_chain(3)
   at B = 8192 (its serving budget 10/3/1), counted the same way, its
   parity printed and its outputs bit for bit against its plain version;
24. held timings of the generated instance and of the hand-written planar
   instance in the same call, in turns (generated, hand, hand, generated),
   at B = 8192, 262144 and 1; the entry point as a caller issues it and its
   device work; the plain version once and the bound from its operation
   count;
25. SE(2) pose graphs through the generated family
   (models.pose_graph.scalar_pose_graph_builder -> family_from_problem),
   emitted and built in phase 2's parallel nvcc pass: the ring N = 4 (D =
   12, the register target: kernel 1) and the chains with closures N = 16
   ((4, 12), D = 48) and N = 40 ((5, 34), (12, 27), D = 120, 4 rows a
   lane), both on the emitter's blocked target (kernel 2); the emit seconds,
   the programs' sizes, kernel 2's launch plan and CTAs per SM
   (mo_generated_blocked_occupancy), and ptxas registers, spill stores and
   stack frame of each instance;
26. each pose instance against its plain version on card tensors, bit for
   bit in float64 and float32: at B = 1024 + 13 with a NaN-measurement lane
   (flagged, every other lane finite), at B = 1 and at B = W + 1 (a ragged
   last CTA);
27. the cells through the public entry point fused_solve_batch in float32
   at B = 8192: fused_pose_graph_bench's (N = 4, 6/1/2) and
   blocked_pose16_bench's (N = 16, 5/1/2, Mehrotra + Armijo), and N = 40 at
   5/1/2, every launch counter set to 0 just before and read just after (one
   generated launch a call, nothing else), one device kernel a call
   (kernels_a_call), the converged share (cost < 2e-3 N) at least 0.99, the
   outputs on the first 1024 lanes bit for bit against the plain version on
   theirs; and in float64 at
   B = 512 against nls_solve on the same Problem at the matched fixed-trip
   budget, x and the final cost within 1e-8 (relative);
28. held times of each instance at B = 8192, 1024 and 1, the entry point
   as a caller issues it and its device work, the plain version once (at
   B = 1024) and the bound from its operation count, and the general twin
   (make_pose_graph_problem + nls_solve at B = 512, float32, the bench's
   parameters) per call and its cost median beside the kernel's;
29. the matrix-free large-problem path (``nls_solve`` with ``qp_solver="cg"``,
   PyTorch on the card, no kernel of its own) at scripts/bench_extras.py's
   pose_graph_bench: the 1,200-pose SE(2) circle graph
   (instances.circle_graph, seed 1), chordal_initialization + 3
   Gauss-Newton iterations of solve_pose_graph_large, under Jacobi (CG
   1,200 / 300 trips) and under the spanning-chain tree preconditioner
   (200 / 100), float32; gates, against the port's float64 CPU result at
   the same budgets: the final cost within CG_F_GATE and the drift from the
   ground truth within CG_X_GATE (relative), and the drift lower than the
   start's (the float64 CPU references of phases 29-31 run in phase 32's
   worker processes beside the card's runs); printed: wall seconds, the
   device memory
   allocated at the peak above what was allocated before,
   one Gauss-Newton step's device operations a CG trip and outside the
   trips (a step captured in a CUDA graph, at 1 and 3 trips), ms a trip,
   the tree factor's ms;
30. bundle_adjustment_bench's dense exact-Schur solve, 16 cameras x 2,048
   landmarks (make_synthetic_scene), 20 Gauss-Newton iterations of 2 CG
   trips, float32; gates: the final cost within CG_F_GATE and the largest
   landmark error within CG_X_GATE of the float64 CPU result; the same
   printout;
31. pose_graph3_bench's 400-pose SE(3) helix (instances.helix_graph, seed 4):
   chordal_initialization3 + 3 Gauss-Newton iterations, Jacobi with the
   hard gauge anchor (CG 300 / 150) and the tree (80 / 50), float32; gates
   as phase 29's, against float64 on the CPU, and the polish lowered the
   cost; the same printout;
32. the emitter's blocked target with a retract (ROADMAP item 16a):
   bench.py's generated planar family (scalar_planar_ik_builder, the
   _mod_pi retraction) at n = 33 and n = 48 on kernel 2, its traces made by
   worker processes from phase 1 on (minutes of Python), its source emitted
   and built in a thread beside phases 2-31 (nvcc at -O1 for sources this
   large: ops/_build.py), against its plain version bit for bit (both types
   at n = 33, float32 at n = 48) at 6/3/2 Mehrotra + Armijo, B = 2048 + 7 with a NaN-target lane and starts a
   turn away (the retract's floor at work); then bench.py's route itself at
   n = 33, float32: fused_solve_batch launches the generated kernel 2 once
   (the counts set to 0 just before it), bit for bit against the plain
   blocked version, one device kernel a call (kernels_a_call);
33. examples/obstacle_ik.py's lifted problem (ineq.py) as a fleet:
   obstacle_ik_targets(8192, seed 0) near the example's target, each
   lane's keep-out centre the elbow of its base solve (the example's arm
   with the proximal cost, no keep-out), float64, kkt_solver="pallas_ldlt",
   through nls_solve on the per-lane wrapper function, the counts of kernels
   4 and 5 set to 0 just before the lifted solve and read just after; the
   share of lanes passing the example's asserts, on the first 256 lanes at
   least the JAX package's share there (OBSTACLE_JAX_SHARE), and the first
   64 lanes (x and slacks) within 1e-8 of the port's float64 CPU result (a
   worker process), their termination states equal; each solve's wall
   seconds;
34. implicit gradients (implicit.py): (a) dx*/dtarget of the 2-link IK
   fleet with the elbow limit 1.2 (tests/test_implicit.py:149's problem)
   at B = 8192, float64, kernels 4 and 5 in the forward solve: the pinned
   joint's row 0 within 1e-4 on the lanes at the limit, the first 64 lanes
   (x and dx*/dtarget) within 1e-8 (relative) of the port's float64 CPU
   result, the forward and one backward pass's milliseconds and the
   backward's device kernels (torch.profiler: a CUDA graph does not
   capture the backward on the card); (b) mpc_feedback_gain at the
   cart-pole's upright state, T = 20, against -K_0 of the LQR oracle (rtol
   1e-6, atol 1e-8), then over 1024 plant states near it (one backward
   pass), four of its lanes within 1e-8 (relative) of one-state float64 CPU
   calls (worker processes);
35. the serving-budget tuner (tuning.py) on scripts/tune_budgets.py's
   families with their gates and anchors: the generated planar family at
   B = 8192 (kernel 1; the budget (4, 2, 1) or cheaper in every component),
   the hand spatial n = 3 (kernel 1), the generated pose ring N = 4 (kernel
   1), the pose ring N = 16 (kernel 7), the MPC servo fleet at B = 1024
   (kernels 8 and 9) and the 48-joint arm (kernel 2, parity above 0.9,
   anchor (6, 3, 2)); every budget a launch at run-time trip counts, the
   counts set to 0 before each family; one JSON line per family, with the
   budgets STATUS.md records from TPU runs beside as context;
36. kernel 6 at the sizes past its first instances (N = 2..8, K <= 1, M
   <= 2N): the register route's N = 1 and K = 2 instances and the warp
   route (csrc/fused_qp_warp.cu, one warp an instance, D = N + K <= 192)
   against the plain version, bit for bit in both types: N = 1 (K = 0, and
   K = 1 with two rows on x0), N = 3 K = 2 and N = 5 K = 3 with the pair
   rows, N = 4 K = 1 with 3N rows on repeated variables (random
   well-conditioned QPs), and N = 9, 16 and 48 from the port's linearization
   of planar IK instances (pair rows, K = 1), at B = 1037 with a NaN lane in
   both barriers, B = 1 and B = W + 1 (a ragged last CTA); at D = 120 and
   192 (the plain version costs D^3 tensor operations) against qp_ip_solve
   under the complementarity barrier at 6 iterations, within 1e-4 (float32)
   and 1e-9 (float64); one device kernel a call on the warp route
   (kernels_a_call); the warp route's launch plans, slab bytes (the
   launcher's against launch_plan's) and CTAs per SM; its ptxas lines come
   with phase 9's;
37. the 48-joint arm (examples/blocked_medium_n.py's rows and budget 6/3/2,
   Mehrotra + Armijo) on the general path, solve_ik_batch(qp_solver=
   "pallas_fused") at B = 8192 in float32: one kernel-6 launch (the warp
   route) per outer iteration and nothing else, parity beside the blocked
   tier's on the same rows (phase 7), kernel 6 on the call's last QPs bit
   for bit against its plain version, ms a call, kernel 6 alone (held),
   its bound and its plain version;
38. bench.py --general's cell (planar n = 2, 10/6/2, complementarity,
   Armijo, B = 8192, float32) on both QP routes with the sequential, the
   parallel and the parallel + fused-probe line search: launches, parity
   (at least 0.99 each), ms and device kernels a call; in float64 at
   B = 1024 each parallel variant within 1e-12 of the sequential one, every
   termination state equal;
39. one float64 solve at B = 64 with record_history, log_qp_eigenvalues and
   an exit_callback that stops a lane once its cost falls under 1e-9: the
   eigenvalues within 1e-10 of numpy.linalg.eigvalsh of each iteration's G,
   the stopped lanes USER_CALLBACK, lane 0 through JSON and the batch
   through npz exactly, one device_profile trace holding the solver's
   phases;
40. kernel 1 at n = 1, 9, 16, 24 and 31, planar and spatial, float64 and
   float32 (their twenty instances built first, on every core, so that no
   build runs beside the host-timed phases before), against its plain version bit for bit at B = 8192 + 13 (a
   NaN-target and a NaN-start lane), B = 1 and on strided inputs (the
   smaller batches against the same plain call's lanes); then planar
   n = 31 (D = 32) through fused_ik_solve_batch at B = 8192, float32, the
   arm's instances and budget 6/3/2: one launch, parity on the first 256
   lanes at least the float64 CPU plain version's there (phase 1's
   workers), bit for bit, kernel ms (held), one device kernel a call (a CUDA
   graph of one call), the plain version's ms and the bound;
41. kernel 2 on the spatial chain (families.cuh SpatialChain) at n = 33 and
   48, both types, bit for bit at B = 2055 (a NaN lane), 1 and W + 1; then
   the spatial arm n = 48 (D = 49) through fused_spatial_ik_solve_batch at
   B = 8192, float32, 6/3/2, gated and timed as phase 40's cell;
42. kernel 2's global route (each warp's slab in a global scratch) bit for
   bit at planar n = 192 and 255 (float32), 162 and 200 (float64), and on
   the generated pose chain N = 72 + two closures (D = 216) in both types,
   B = GLOBAL_SLABS + 7 (seven warps solve two instances each) at 2/1/1;
   then planar n = 255 (D = 256) through fused_ik_solve_batch at B = 8192,
   float32, 6/3/2, gated and timed as phase 40's cell;
43. kernel 7's run-time route (the schedule a device table, the 3k x 3k
   Schur system in the slab) bit for bit in both types on topology (i)
   (N = 64, borders {0, 8, ..., 56}, the 21 closures spanning at least 16
   poses: k = 8), (ii) (N = 96, a closure every 8 poses: k = 12, 11
   closures) and (iii) ((i) plus three closures to pose 63: k = 9, 24
   closures) at B = 1037 (a NaN-measurement and a NaN-start lane), 1 and
   W + 1; then (i) and (ii) through solve_pose_graph_rings at B = 8192,
   float32, 6/2: one launch, converged share at least 0.99, bit for bit,
   timed as phase 40's cell;
44. the kernel line (this slice's cells in the rows of kernels 1, 2 and 7,
   the earlier slices' launches in theirs), the seconds of each phase, then
   the device line as the last line of stdout.

The 10,000-pose scale point and the sparse bundle adjustment (64 x 8,192,
4 cameras a landmark) run in scripts/cg_path_times.py, not here.

Tolerances, kernel against plain version: the kernels sum in the plain
versions' order and build without FMA contraction, so they are expected to
agree bit for bit (each comparison prints whether they did). Kernels 2 and
3 and the blocked main paths (phases 5-7), kernels 4-6 and the general
path (phases 10-12), kernel 7 and the pose-ring main path (phases 14-15)
and kernels 8-9 (phases 18-19) are held bit for bit in both types, and so
is kernel 1, hand-written (phases 3-4) and generated (phases 22-23), and
the generated pose instances of kernels 1 and 2 (phases 26-27) and the
generated instances of kernel 2 with a retract (phase 32), and kernel 6's
new routes and the arm on the general path (phases 36-37), and every new
size and route of kernels 1, 2 and 7 (phases 40-43). The CG path
(phases 29-31) runs no kernel: float32 on the card against float64 on the
CPU, CG_F_GATE on the final cost and CG_X_GATE on the drift or landmark
error, each set from the readings in PERF.md §6. Phases 33-34
run the general path in float64, held to the port's float64 CPU result
within 1e-8 (kernels 4 and 5 are bit-identical to their plain versions;
the chain's trigonometry rounds differently on the card).
"""

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import multiprocessing
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import mini_opt_tpu_torch as mot
from mini_opt_tpu_torch.instances import (
    block_chain_instances,
    block_chain_problem,
    robust_line_fit_instances,
    robust_line_fit_problem,
    cartpole_mpc_instances,
    chain_closure_instances,
    chain_edges,
    effector_error,
    medium_n_planar_instances,
    planar_instances,
    quadrotor_mpc_instances,
    ring_instances,
    spatial_fk,
    spatial_instances,
)
from mini_opt_tpu_torch.models import mpc as mpcm
from mini_opt_tpu_torch.models import pose_graph as pg
from mini_opt_tpu_torch.models.ik import _CHAIN_BUILDER_CACHE, scalar_planar_ik_builder
from mini_opt_tpu_torch.ops import _build
from mini_opt_tpu_torch.ops import fused_auto
from mini_opt_tpu_torch.ops import blocked as blk
from mini_opt_tpu_torch.ops import fused_ik as fik
from mini_opt_tpu_torch.ops import fused_qp as fq
from mini_opt_tpu_torch.ops import ldlt
from mini_opt_tpu_torch.ops import mpc as pm
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


class PhaseClock:
    """Prints the seconds each phase took (host clock), so that a later
    change knows where the script's time goes; ``summary`` lists them all."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.rows = []

    def mark(self, label):
        now = time.perf_counter()
        self.rows.append((label, now - self.last))
        print(f"# seconds {label}: {now - self.last:.1f} s ({now - self.start:.1f} s into the run)", flush=True)
        self.last = now

    def summary(self):
        return {label: round(sec, 1) for label, sec in self.rows}


CLOCK = PhaseClock()


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
    """Hold kernel 1's feature-major (x, state, history) against the plain
    version's on the same inputs, bit for bit, flags and NaN lanes included;
    exit on any difference. Prints the kernel's parity (effector error
    < 1e-3) and records the largest |kernel - plain| per dtype in max_err."""
    (xk, sk, hk), (xp, sp, hp) = got, want
    dtype = str(xk.dtype).replace("torch.", "")
    same = bit_identical((xk, xp), (sk, sp), *([(hk, hp)] if hp is not None else []))
    diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk, sp)}
    if hp is not None:
        diffs["history"] = max_abs_diff(hk, hp)
    max_err[dtype] = max(max_err[dtype], max(diffs.values()))
    parity = (effector_error(fam_kind, xk.T.cpu(), data) < 1e-3).mean()
    print(f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {diffs}, parity {parity:.6f}", flush=True)
    if not same:
        fail(f"{tag} {dtype}: the kernel disagrees with its plain version ({diffs})")


# Phase 3's cases: (name, family, n, budget, history, B, strided inputs).
IK_CASES = [
    ("planar n=2 4/2/1 mpc armijo", "planar", 2, BENCH, False, 8192 + 13, False),
    ("planar n=4 10/6/2 complementarity polynomial +history", "planar", 4,
     dict(max_iterations=10, qp_iterations=6, ls_iterations=2, barrier="complementarity",
          line_search="polynomial"), True, 8192 + 13, False),
    ("spatial n=3 4/2/1 mpc armijo", "spatial", 3, BENCH, False, 8192 + 13, False),
    ("planar n=2 4/2/1 mpc armijo, one instance", "planar", 2, BENCH, False, 1, False),
    ("planar n=4 10/6/2 complementarity polynomial +history, strided inputs", "planar", 4,
     dict(max_iterations=10, qp_iterations=6, ls_iterations=2, barrier="complementarity",
          line_search="polynomial"), True, 33, True),
]


def ik_vs_plain(max_err):
    """Phase 3: kernel 1 against its plain version on batch-major card
    tensors, bit for bit: past B = 9 one NaN-target and one NaN-start lane;
    the strided case reads data as every other column of a wider tensor and
    x0 as a transposed view."""
    for name, fam_kind, n, kw, hist, B, strided in IK_CASES:
        data, x0 = (planar_instances if fam_kind == "planar" else spatial_instances)(B, n, seed=n)
        if B > 9:
            data[5, 0] = np.nan
            x0[9, 1] = np.nan
        family = (fik.planar_family if fam_kind == "planar" else fik.spatial_family)(n, LINK)
        for dtype in (torch.float64, torch.float32):
            d = torch.as_tensor(data, dtype=dtype, device="cuda")
            x = torch.as_tensor(x0, dtype=dtype, device="cuda")
            if strided:
                d, x = torch.stack([d, d], 2)[:, :, 0], x.T.contiguous().T
            args = (family, d, x, kw["max_iterations"], kw["qp_iterations"],
                    kw["ls_iterations"], kw["line_search"], kw["barrier"], hist)
            before = fik.KERNEL_LAUNCHES
            got = fik._fused_solve_cuda(*args)
            torch.cuda.synchronize()
            if fik.KERNEL_LAUNCHES != before + 1:
                fail(f"{name}: the kernel wrapper did not count its launch")
            want = fik._fused_solve_plain_batch(*args)
            torch.cuda.synchronize()
            check_against_plain(f"phase3 {name} B={B}", fam_kind, data, *(
                (r[0].T, r[1].T, None if r[2] is None else r[2].permute(1, 2, 0)) for r in (got, want)), max_err)


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


def stored(t):
    """Elements of t that a kernel reading it at its strides touches: a
    dimension of stride 0 (a broadcast) counts once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def roofline(ops, bytes_moved):
    """The least time (ms) for `ops` FP32 operations and `bytes_moved` bytes
    of device memory, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, bytes_moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kkt_systems(B, D, seed, dtype):
    """B random quasi-definite KKT systems, the class qp.cc factors (a
    positive definite (1,1) block, m = D // 12 equality rows (at least one
    past D = 1), a zero (2,2) block: indefinite), and right-hand sides, as
    CUDA tensors."""
    rng = np.random.default_rng(seed)
    m = max(1, D // 12) if D > 1 else 0
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


def check_blocked(tag, got, want, max_err, nan_lanes=()):
    """Kernel 2's feature-major (x, state) against the plain version's: bit
    for bit in both types (the kernel sums in the plain version's order and
    builds without FMA contraction), NaN with NaN; the NaN-target lanes
    flagged and every other lane finite. Records the largest |kernel -
    plain| per dtype."""
    dtype = str(got[0].dtype).replace("torch.", "")
    same = bit_identical(*zip(got, want))
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    max_err[dtype] = max(max_err[dtype], err)
    xk, sk = got
    others = torch.ones_like(sk[2], dtype=torch.bool)
    others[list(nan_lanes)] = False
    flagged = all(bool(sk[2, lane] != 0) for lane in nan_lanes)
    finite = bool(torch.isfinite(xk[:, others]).all() and torch.isfinite(sk[:, others]).all())
    print(f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {err:.3e}, NaN lanes flagged "
          f"{flagged}, others finite {finite}, lanes flagged {int((sk[2] != 0).sum())} of {sk.shape[1]}",
          flush=True)
    if nan_lanes and not (flagged and finite):
        fail(f"{tag} {dtype}: NaN lanes not flagged or their neighbours not finite")
    if not same:
        fail(f"{tag} {dtype}: kernel 2 and its plain version are not bit-identical (max diff {err})")


def plan_bounds():
    """(the largest n whose float64 plan keeps more than one warp per CTA,
    the largest n of each type's shared-memory plan): where W falls to 1 and
    the sizes past which kernel 2 takes its global route."""
    last, wide = {}, None
    for dtype in (torch.float64, torch.float32):
        for n in range(33, 400):
            plan = blk.launch_plan(blk.planar_slab_shape(n), 1, dtype)
            if plan.storage != "shared":  # phase 42 takes the global route
                break
            last[dtype] = n
            if dtype == torch.float64 and plan.warps > 1:
                wide = n
    return wide, last


def blocked_vs_plain(max_err):
    """Phase 5: kernel 2 (csrc/blocked.cu) against _blocked_solve_plain, bit
    for bit, in both types."""
    B = 2048 + 7
    poly = dict(max_iterations=4, qp_iterations=2, ls_iterations=2, barrier="complementarity",
                line_search="polynomial")
    short = dict(max_iterations=2, qp_iterations=1, ls_iterations=1, barrier="mpc", line_search="armijo")
    wide, last = plan_bounds()
    per_dtype = (torch.float64, torch.float32)

    def ragged(dtype, n):  # a last CTA with one instance of its W
        return blk.launch_plan(blk.planar_slab_shape(n), 1, dtype).warps + 1

    cases = [
        ("planar n=33 (D=34) 4/2/2 complementarity polynomial", 33, poly, lambda dt, n: B, (5,), per_dtype),
        ("planar n=48 (D=49) 6/3/2 mpc armijo", ARM_N, ARM, lambda dt, n: B, (5,), per_dtype),
        ("planar n=48 (D=49) 6/3/2 mpc armijo, one instance", ARM_N, ARM, lambda dt, n: 1, (), per_dtype),
        ("planar n=48 (D=49) 6/3/2 mpc armijo, B = W + 1", ARM_N, ARM, ragged, (), per_dtype),
        (f"planar n={wide} 2/1/1 (the last float64 plan with W > 1), B = W + 1", wide, short, ragged, (),
         per_dtype),
        (f"planar n={wide + 1} 2/1/1 (float64: W falls to 1), B = 2W + 1", wide + 1, short,
         lambda dt, n: 2 * ragged(dt, n) - 1, (1,), per_dtype),
        (f"planar n={last[torch.float64]} 2/1/1 (the float64 limit), B = 3", last[torch.float64], short,
         lambda dt, n: 3, (), per_dtype),
        (f"planar n={last[torch.float32]} 2/1/1 (the float32 limit), B = 3", last[torch.float32], short,
         lambda dt, n: 3, (), (torch.float32,)),
    ]
    for name, n, kw, batch, nan_lanes, dtypes in cases:
        family = fik.planar_family(n, LINK)
        for dtype in dtypes:
            Bc = batch(dtype, n)
            data, x0 = medium_n_planar_instances(Bc, n, seed=n)
            for lane in nan_lanes:
                data[lane, 0] = np.nan
            data_t, x0_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            args = (family, data_t, x0_t, kw["max_iterations"], kw["qp_iterations"],
                    kw["ls_iterations"], kw["line_search"], kw["barrier"])
            before = blk.BLOCKED_LAUNCHES
            got = blk._blocked_solve_cuda(*args)
            torch.cuda.synchronize()
            if blk.BLOCKED_LAUNCHES != before + 1:
                fail(f"{name}: the blocked kernel wrapper did not count its launch")
            want = blk._blocked_solve_plain(*args)
            torch.cuda.synchronize()
            plan = blk.launch_plan(blk.planar_slab_shape(n), Bc, dtype)
            check_blocked(f"phase5 {name} B={Bc} ({plan.warps} warps/CTA, {plan.rows_per_lane} rows/lane)",
                          got, want, max_err, nan_lanes)


def check_kkt(tag, H, rhs, xk, xp, max_err):
    """The KKT kernel's x against the plain version's: bit for bit in both
    types (the kernel keeps the plain version's order of operations and
    builds without FMA contraction); float64 also within 1e-8 of
    torch.linalg.solve, relative to max|x| + 1."""
    dtype = str(H.dtype).replace("torch.", "")
    same = bit_identical((xk, xp))
    err = max_abs_diff(xk, xp)
    max_err[dtype] = max(max_err[dtype], err)
    line = f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {err:.3e}"
    if H.dtype == torch.float64:
        ref = torch.linalg.solve(H, rhs)
        ref_err = (xk - ref).abs().max().item() / (ref.abs().max().item() + 1.0)
        line += f", relative to torch.linalg.solve {ref_err:.3e}"
        if not ref_err <= 1e-8:
            fail(f"{tag}: the float64 kernel is {ref_err} from torch.linalg.solve")
    print(line, flush=True)
    if not same:
        fail(f"{tag} {dtype}: kernel 3 and its plain version are not bit-identical (max diff {err})")


# Kernel 3's sizes in phase 6: the warp route from D = 1 (R = 2, 4 and 6
# rows a lane, each side of every boundary), then past D = 192 the CTA route
# (float32 to D = 239; float64 takes D <= 192, all on the warp route, and
# refuses D = 193 as before this route existed, when its CTA route stopped
# at D = 169).
KKT_SIZES = (1, 2, 7, 31, 33, 49, 64, 65, 120, 128, 129, 169, 192, 193, 239)


def kkt_vs_plain(max_err):
    """Phase 6: csrc/blocked_kkt.cu against _blocked_kkt_solve_plain, bit
    for bit, at every size of KKT_SIZES in both types where the kernel has
    a route, at B = 1037 (B = 1 and W + 1 at D = 49)."""
    for D in KKT_SIZES:
        for dtype in (torch.float64, torch.float32):
            batches = (1037, 1, blk.kkt_launch_plan(D, 1, dtype).warps + 1) if D == 49 else (1037,)
            try:
                plan = blk.kkt_launch_plan(D, 1037, dtype)
            except ValueError as e:
                if not (D > 192 and dtype == torch.float64):
                    fail(f"phase6 D={D} {dtype}: no launch plan ({e})")
                print(f"# phase6 blocked KKT D={D} {str(dtype).replace('torch.', '')}: no route, as before "
                      f"(ValueError: {e})", flush=True)
                continue
            for B in batches:
                H, rhs = kkt_systems(B, D, seed=D, dtype=dtype)
                before = blk.KKT_LAUNCHES
                xk = blk._blocked_kkt_solve_cuda(H, rhs)
                torch.cuda.synchronize()
                if blk.KKT_LAUNCHES != before + 1:
                    fail(f"D={D}: the KKT kernel wrapper did not count its launch")
                xp = blk._blocked_kkt_solve_plain(H, rhs)
                torch.cuda.synchronize()
                check_kkt(f"phase6 blocked KKT D={D} B={B} ({plan.route} route, {plan.warps} systems/CTA)",
                          H, rhs, xk, xp, max_err)


def reset_counts():
    fik.KERNEL_LAUNCHES = 0
    fik.GENERATED_LAUNCHES = 0
    pr.KERNEL_LAUNCHES = 0
    blk.BLOCKED_LAUNCHES = 0
    blk.GENERATED_LAUNCHES = 0
    blk.KKT_LAUNCHES = 0
    ldlt.LDLT_FACTOR_LAUNCHES = 0
    ldlt.LDLT_SOLVE_LAUNCHES = 0
    fq.FUSED_QP_LAUNCHES = 0
    pm.KERNEL_LAUNCHES = 0
    pm.SERVO_LAUNCHES = 0


def counts():
    return dict(fused_ik=fik.KERNEL_LAUNCHES, fused_ik_generated=fik.GENERATED_LAUNCHES,
                blocked=blk.BLOCKED_LAUNCHES, blocked_generated=blk.GENERATED_LAUNCHES, blocked_kkt=blk.KKT_LAUNCHES,
                ldlt_factor=ldlt.LDLT_FACTOR_LAUNCHES, ldlt_solve=ldlt.LDLT_SOLVE_LAUNCHES,
                fused_qp=fq.FUSED_QP_LAUNCHES, pose_ring=pr.KERNEL_LAUNCHES,
                mpc=pm.KERNEL_LAUNCHES, mpc_servo=pm.SERVO_LAUNCHES)


def blocked_paths(card, kind):
    """Phases 5-8 for the blocked tier; returns its two kernel rows."""
    max_err_blk = {"float64": 0.0, "float32": 0.0}
    max_err_kkt = {"float64": 0.0, "float32": 0.0}
    blocked_vs_plain(max_err_blk)
    CLOCK.mark("phase 5")
    kkt_vs_plain(max_err_kkt)
    CLOCK.mark("phase 6")

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
    check_blocked(f"phase7 main path fused_solve_batch B={B}", (x_arm.T, state_arm.T), (xp, sp), max_err_blk)

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

    CLOCK.mark("phase 7")
    # Phase 8: times at those shapes.
    t_d, x_d = torch.as_tensor(t32, device="cuda"), torch.as_tensor(x32, device="cuda")
    entry = lambda: mot.fused_solve_batch(arm, t_d, x_d, **ARM)  # noqa: E731
    kern = lambda: blk._blocked_solve_cuda(arm, data_t, x0_t, *ARM_ARGS)  # noqa: E731
    e2e_ms, e2e_all = time_ms(entry, launches=10)
    dev_ms, dev_all = time_ms(entry, launches=10, held=True)
    k2_ms, k2_all = time_ms(kern, launches=10, held=True)
    k2_unheld_ms, _ = time_ms(kern, launches=10)
    # One instance alone (the latency of one warp's dependent chain), and
    # 1024 instances (1024 / W CTAs, under one wave).
    k2_at = {}
    for Bs in (1, 1024):
        d_s, x_s = data_t[:, :Bs].contiguous(), x0_t[:, :Bs].contiguous()
        k2_at[Bs], _ = time_ms(lambda: blk._blocked_solve_cuda(arm, d_s, x_s, *ARM_ARGS), launches=10, held=True)
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for dtype in (torch.float32, torch.float64):
        plan = blk.launch_plan(blk.planar_slab_shape(ARM_N), B, dtype)
        ctas = lib.mo_blocked_occupancy(0, ARM_N, blk._CUDA_DTYPE_IDS[dtype], plan.warps, 0)
        if ctas < 1:
            fail(f"phase8: occupancy query for n={ARM_N} {dtype} returned {ctas}")
        plans.append(f"{str(dtype).replace('torch.', '')}: {plan.warps} warps/CTA, {plan.rows_per_lane} rows/lane, "
                     f"{plan.warp_bytes} B/warp, {plan.cta_bytes} B/CTA, grid {plan.grid}, {ctas} CTAs/SM "
                     f"({ctas * plan.warps} instances/SM, {ctas * plan.warps * sms} on {sms} SMs)")
    print(f"# phase8 kernel 2 launch plan n={ARM_N} (D=49) B={B}: " + "; ".join(plans), flush=True)
    plain2_ms, _ = event_ms(plain_arm)
    ops2 = count_ops(plain_arm)
    bound2_ms, bound2_by = roofline(ops2, B * (2 + ARM_N + ARM_N + 3) * 4)
    print(f"# phase8 blocked kernel B={B} D=49 float32 on {kind} ({card}): kernel alone on the card "
          f"{k2_ms:.4f} ms ({B / k2_ms * 1e3:.4e} solves/s), unheld {k2_unheld_ms:.4f} ms, "
          f"at B=1 {k2_at[1]:.4f} ms, at B=1024 {k2_at[1024]:.4f} ms, "
          f"entry point issued back to back "
          f"{e2e_ms:.4f} ms/call, its device work {dev_ms:.4f} ms; plain {plain2_ms:.3f} ms; "
          f"{ops2 / B:.0f} elementwise ops per instance -> bound {bound2_ms:.6f} ms ({bound2_by}), "
          f"kernel = {k2_ms / bound2_ms:.1f}x bound; repeats: entry {e2e_all} device {dev_all} "
          f"kernel {k2_all}", flush=True)

    kern3 = lambda: blk._blocked_kkt_solve_cuda(H, rhs)  # noqa: E731
    k3_ms, k3_all = time_ms(kern3, held=True)
    k3_unheld_ms, _ = time_ms(kern3)
    H1, rhs1 = H[:1].contiguous(), rhs[:1].contiguous()
    k3_one_ms, _ = time_ms(lambda: blk._blocked_kkt_solve_cuda(H1, rhs1), held=True)
    kplans = []
    for dtype in (torch.float32, torch.float64):
        plan = blk.kkt_launch_plan(D, B, dtype)
        ctas = lib.mo_blocked_kkt_occupancy(blk._CUDA_DTYPE_IDS[dtype], D, plan.warps)
        if ctas < 1:
            fail(f"phase8: occupancy query for the KKT kernel at D={D} {dtype} returned {ctas}")
        kplans.append(f"{str(dtype).replace('torch.', '')}: {plan.route} route, {plan.warps} systems/CTA, "
                      f"{plan.rows_per_lane} rows/lane, {plan.system_bytes} B/system, {plan.cta_bytes} B/CTA, "
                      f"grid {plan.grid}, {ctas} CTAs/SM ({ctas * plan.warps} systems/SM)")
    print(f"# phase8 kernel 3 launch plan D={D} B={B}: " + "; ".join(kplans), flush=True)
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
          f"{k3_ms:.4f} ms, at B=1 {k3_one_ms:.4f} ms, unheld {k3_unheld_ms:.4f} ms, blocked_kkt_solve issued back to back {e3_ms:.4f} ms/call; plain "
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
            "ms_at_B1": k2_at[1],
            "ms_at_B1024": k2_at[1024],
            "launch_plan": plans[0],
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
            "ms_at_B1": k3_one_ms,
            "launch_plan": kplans[0],
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
        ldlt._factor_plain, ldlt._solve_plain, fq._fused_qp_plain_batch)
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


def ldlt_systems(B, D, seed):
    """B SPD systems with a KKT-shaped zero block (as the QP gives), garbage
    above the diagonal (only the lower triangle is read), and right-hand
    sides, float64 numpy; past B = 7 lane 5 NaN and lane 7 singular."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, D, D))
    H = A @ A.transpose(0, 2, 1) / D + np.eye(D)
    m = min(max(1, D // 6), D - 1)
    if m:
        H[:, D - m:, D - m:] = 0.0
    upper = np.triu_indices(D, 1)
    H[:, upper[0], upper[1]] = rng.normal(size=(B, len(upper[0])))
    if B > 7:
        H[5] = np.nan
        H[7] = 0.0
    return H, rng.normal(size=(B, D))


def ldlt_vs_plain(max_err):
    """Phase 10: kernels 4 and 5 against their plain versions on batch-major
    H and rhs, as factorize and solve give them, on both routes; then one
    factorize + solve pair under the profiler."""
    cap = ldlt.REGISTER_MAX_D
    for D in sorted({1, 2, 3, 5, cap, cap + 1, 9, 17, 33, 40}):
        for B in (8192 + 13, 1):
            H, rhs = ldlt_systems(B, D, seed=D)
            for dtype in (torch.float64, torch.float32):
                H_b = torch.as_tensor(H, dtype=dtype, device="cuda")
                r_b = torch.as_tensor(rhs, dtype=dtype, device="cuda")
                plan = ldlt.ldlt_launch_plan(D, B)
                before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES)
                Lk, dk, okk = ldlt._ldlt_factor_cuda(H_b)
                Lp, dp, okp = ldlt._factor_plain(H_b)
                xk = ldlt._ldlt_solve_cuda(Lp, dp, r_b)
                torch.cuda.synchronize()
                if (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES) != (before[0] + 1, before[1] + 1):
                    fail(f"D={D}: an LDL^T wrapper did not count its launch")
                xp = ldlt._solve_plain(Lp, dp, r_b)
                where = f"D={D} B={B} ({plan.route} route, {plan.threads} threads a CTA)"
                check_bits(f"phase10 LDL^T factor {where}", (Lk, dk), (Lp, dp), max_err["factor"],
                           ok_pair=(okk, okp))
                check_bits(f"phase10 LDL^T solve {where}", (xk,), (xp,), max_err["solve"])

    # One factorize + solve pair at the general path's D = 3, B = 8192, as
    # ops/kkt.py calls it: the two kernels and nothing else on the card.
    H, rhs = ldlt_systems(GENERAL_B, 3, seed=3)
    H_b = torch.as_tensor(H, dtype=torch.float32, device="cuda")
    r_b = torch.as_tensor(rhs, dtype=torch.float32, device="cuda")

    def pair():
        fact, _ = ldlt.factorize(H_b)
        return ldlt.solve(fact, r_b)

    before = (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES)
    pair()
    torch.cuda.synchronize()
    if (ldlt.LDLT_FACTOR_LAUNCHES, ldlt.LDLT_SOLVE_LAUNCHES) != (before[0] + 1, before[1] + 1):
        fail("phase10: a factorize + solve pair did not launch each kernel once")
    kernels_a_call(f"phase10 factorize + solve D=3 B={GENERAL_B} float32 (the feature-major design before "
                   f"the register route issued 14)", pair, (r"ldlt_factor_reg_kernel", r"ldlt_solve_reg_kernel"))


def launch_floor_ms():
    """The least a held, back-to-back launch costs on the card in time_ms's
    harness: torch.cuda._sleep(1) (a kernel that spins one cycle) and a
    one-element add_; returns the smaller, in ms, and both."""
    sleep_ms, _ = time_ms(lambda: torch.cuda._sleep(1), held=True)
    one = torch.zeros(1, device="cuda")
    add_ms, _ = time_ms(lambda: one.add_(1.0), held=True)
    return min(sleep_ms, add_ms), dict(sleep1_ms=sleep_ms, add_ms=add_ms)


def ik_qps(n, B, dtype, seed):
    """The QPs of the general path's first outer iteration at planar n:
    the port's own linearization of bench instances (lambda = 1e-3), past
    B = 5 one NaN-target lane. Returns the batch-major tensors as the
    linearization gives them (ia a stride-0 broadcast) and the box rows'
    variables."""
    targets, x0 = planar_instances(B, n, seed=seed)
    if B > 5:
        targets[5, 0] = np.nan
    chain = mot.make_planar_chain(n, dtype=dtype, device="cuda")
    x_t = torch.as_tensor(x0, dtype=dtype, device="cuda")
    qp, _ = mot.nonlinear.linearize_and_fill_qp(
        lambda t: mot.make_ik_problem(chain, t), x_t, torch.full_like(x_t[:, 0], 1e-3),
        data=torch.as_tensor(targets, dtype=dtype, device="cuda"),
    )
    return (qp.G, qp.c, qp.A_eq, qp.b_eq, qp.ineq_a, qp.ineq_b), tuple(int(v) for v in qp.ineq_var)


def qp_variants(tensors, var):
    """Phase 11's variants of one batch of QPs, (label, tensors, ineq_var):
    as given (the pairs route), without the equality row (K = 0), on the
    run-time route (a row x_0 >= -10 first, then the box rows reversed), and
    every input a non-contiguous view (G and A stored transposed, c and b
    every other column of a wider tensor, ia the linearization's stride-0
    broadcast, ib transposed storage)."""
    G, c, A, b, ia, ib = tensors
    rev = list(range(len(var) - 1, -1, -1))
    first = torch.ones_like(ib[:, :1])
    any_rows = (G, c, A, b, torch.cat([first, ia[:, rev]], 1), torch.cat([10.0 * first, ib[:, rev]], 1))
    strided = (G.transpose(1, 2).contiguous().transpose(1, 2), torch.stack([c, c], 2)[:, :, 0],
               A.transpose(1, 2).contiguous().transpose(1, 2), torch.stack([b, b], 2)[:, :, 0],
               ia, ib.T.contiguous().T)
    return [
        ("pairs", tensors, var),
        ("pairs, K=0", (G, c, A[:, :0], b[:, :0], ia, ib), var),
        ("any rows", any_rows, (0,) + tuple(var[m] for m in rev)),
        ("pairs, non-contiguous inputs", strided, var),
    ]


def fused_qp_vs_plain(max_err):
    """Phase 11: kernel 6 against its plain version, bit for bit, on
    batch-major inputs as the general path gives them, every route, both
    barriers and types, at B = 8192 + 13 (one NaN lane), 33 and 1; then a
    _fused_qp_batch call must be one device kernel (kernels_a_call)."""
    for n in (2, 4, 8):
        for B in (8192 + 13, 33, 1):
            for dtype in (torch.float64, torch.float32):
                tensors, var = ik_qps(n, B, dtype, seed=n)
                for label, ts, v in qp_variants(tensors, var):
                    route = fq.qp_route(n, ts[3].shape[1], v)
                    for barrier in ("complementarity", "mpc"):
                        args = (*ts, v, 6, 0.1, barrier, True)
                        before = fq.FUSED_QP_LAUNCHES
                        got = fq._fused_qp_cuda(*args)
                        torch.cuda.synchronize()
                        if fq.FUSED_QP_LAUNCHES != before + 1:
                            fail(f"n={n}: the fused QP wrapper did not count its launch")
                        want = fq._fused_qp_plain_batch(*args)
                        check_bits(f"phase11 fused QP n={n} {label} (M={len(v)}, {route} route) {barrier} "
                                   f"B={B}", got, want, max_err)

    tensors, var = ik_qps(2, GENERAL_B, torch.float32, seed=2)

    def call():
        return fq._fused_qp_batch(*tensors, ineq_var=var, iterations=6, sigma=0.1, barrier="complementarity",
                                  has_eq_guess=True)

    before = fq.FUSED_QP_LAUNCHES
    call()
    torch.cuda.synchronize()
    if fq.FUSED_QP_LAUNCHES != before + 1:
        fail("phase11: a _fused_qp_batch call did not launch kernel 6 once")
    kernels_a_call(f"phase11 _fused_qp_batch N=2 B={GENERAL_B} float32 (the feature-major wrapper issued 6)",
                   call, (r"fused_qp_kernel",))


def graph_nodes(fn):
    """The nodes of one call of fn captured in a CUDA graph, by type
    ({"kernel": 1}: one device kernel and nothing else). An exact count,
    where the profiler can miss records; the captured launches do not run,
    but their wrappers count them."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
    out = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        kind = kinds.get(t.value, f"type {t.value}")
        out[kind] = out.get(kind, 0) + 1
    return out


def kernels_a_call(tag, fn, names, reps=20):
    """One device kernel a call for each regex in ``names`` and nothing
    else (each of ``fn``'s wrappers has just shown one launch a call on its
    counter): one call captured in a CUDA graph must hold len(names) kernel
    nodes and no other node (graph_nodes), and ``reps`` calls under the
    profiler (profile_call) must record no device kernel that matches none
    of ``names`` (a copy, say) and no more of one than ``reps``. The
    profiler can miss records (a session of long kernels once recorded none
    of them), so fewer than ``reps`` is printed, not failed."""

    def calls():
        for _ in range(reps):
            fn()

    nodes = graph_nodes(fn)
    _, _, _, per_kernel = profile_call(calls)
    seen = {pat: sum(c for k, (c, _) in per_kernel.items() if re.search(pat, k)) for pat in names}
    other = {k[:60]: c for k, (c, _) in per_kernel.items() if not any(re.search(p, k) for p in names)}
    print(f"# {tag}: one call captured in a CUDA graph holds {nodes}; under torch.profiler, {reps} calls: "
          f"{len(names)} device kernel(s) a call, recorded { {p: f'{c} of {reps}' for p, c in seen.items()} }, "
          f"other device kernels {other}", flush=True)
    if nodes != {"kernel": len(names)} or other or any(c > reps for c in seen.values()):
        fail(f"{tag}: not one device kernel a call for each of {names} and nothing else "
             f"(graph nodes {nodes}, recorded {seen}, others {other})")


def profile_call(fn, sessions=3):
    """One call of fn under torch.profiler: (wall ms of the profiled call,
    device-busy ms as the union of the intervals of the device's kernels and
    copies, their number, {name: (count, summed ms)}); busy ms is None when
    the profiler recorded no device activity. The solver's phase labels
    (utils/tracing.py) also appear on the device timeline, as user
    annotations spanning whole phases; they are not device work and are
    left out. A session can miss kernel records (on this card's profiler
    one recorded none of a call's one kernel, another the solve but not the
    factor of a pair, another 15 of 20 calls' kernels): so each session
    opens with a marker kernel (torch.cuda._sleep's spin kernel, left out
    of the result), and of ``sessions`` sessions the one that recorded the
    most device work is kept. A missed record only lowers a count. The
    sessions record device activity alone: the host's, which nothing here
    reads, took most of the time of a profiled call of tens of thousands of
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans, per_kernel = [], {}
        for e in prof.events():
            if (not str(getattr(e, "device_type", "")).endswith("CUDA") or getattr(e, "is_user_annotation", False)
                    or re.search(r"spin_kernel|sleep", e.name, re.I)):
                continue
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            count, ms = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (count + 1, ms + (end - start) / 1e3)
        if best is None or len(spans) > len(best[1]):
            best = (wall_ms, spans, per_kernel)
    wall_ms, spans, per_kernel = best
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
    CLOCK.mark("phase 10")
    fused_qp_vs_plain(err6)
    CLOCK.mark("phase 11")

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
        want = {k: expected[route].get(k, 0) for k in got}
        if got != want:
            fail(f"phase12 {route}: launches {got}, the formula gives {want}")
        if res.x.shape != (B, 2) or not res.x.is_cuda or not torch.isfinite(res.x).all():
            fail(f"phase12 {route}: unexpected solutions {tuple(res.x.shape)} {res.x.device}")
        err = effector_error("planar", res.x.cpu().numpy(), targets)
        parity = float((err < 1e-3).mean())
        satisfied = mot.termination_state_indicates_satisfied_tol(res.termination_state).double().mean().item()
        with plain_kernels():
            plain_e2e_ms, ref = event_ms(lambda: mot.solve_ik_batch(t32, x32, params=params))
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
        # One session: the count of ~35,000 kernels is reported, not gated.
        prof_wall, busy_ms, n_kernels, per_kernel = profile_call(entry, sessions=1)
        ours = {k: v for k, v in per_kernel.items() if re.search(r"ldlt_(factor|solve)(_reg)?_kernel|fused_qp_kernel", k)}
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
        timing[route] = dict(e2e_ms=e2e_ms, busy_ms=busy_ms, parity=parity)
        dev_txt = "not measured (the profiler recorded no device activity)" if busy_ms is None else (
            f"device busy {busy_ms:.3f} ms in {n_kernels} device kernels a call"
            f"{' (PERF.md §5: 50,532 with the feature-major LDL^T wrappers)' if route == 'pallas_ldlt' else ' (34,956 with the feature-major fused QP wrapper)'}, "
            f"idle share {1 - busy_ms / e2e_ms:.4f} "
            f"of the unprofiled call ({e2e_ms:.3f} ms; the profiled call's own wall is {prof_wall:.3f} ms, "
            f"idle share {1 - busy_ms / prof_wall:.4f} of it); this slice's kernels "
            f"{ {k[:48]: (c, round(ms, 5)) for k, (c, ms) in ours.items()} }; the largest "
            f"{ [(k[:48], c, round(ms, 3)) for k, (c, ms) in top] }")
        print(f"# phase12 {route} on {kind} ({card}): entry point {e2e_ms:.3f} ms/call "
              f"({B / e2e_ms * 1e3:.4e} solves/s), repeats {e2e_all}; with the plain "
              f"kernels {plain_e2e_ms:.3f} ms; profiled call: {dev_txt}", flush=True)

    rows = []
    # Each kernel alone, on the inputs the main path last gave it.
    H_b = seen["_ldlt_factor_cuda"][0]  # (B, D, D), batch-major
    Lt, dt, rhs_b = seen["_ldlt_solve_cuda"]  # (D, D, B), (D, B), rhs (B, D)
    qp_args = seen["_fused_qp_cuda"]  # batch-major, as the general path gave them
    D = H_b.shape[-1]
    N, K, M = qp_args[1].shape[1], qp_args[3].shape[1], len(qp_args[6])
    # One QP's latency: kernel 6 alone on the first lane.
    qp_one = tuple(t[:1] for t in qp_args[:6]) + tuple(qp_args[6:])
    qp_one_ms, qp_one_all = time_ms(lambda: fq._fused_qp_cuda(*qp_one), held=True)
    print(f"# phase12 kernel fused_qp B=1 N={N} K={K} M={M} float32 ({fq.qp_route(N, K, qp_args[6])} route) on "
          f"{kind} ({card}): alone on the card {qp_one_ms:.5f} ms (held; repeats {qp_one_all})", flush=True)
    f32 = 4

    # The library yardsticks, timed once each after a warm-up on 8 systems
    # (the port never calls them).
    torch.linalg.ldl_factor_ex(H_b[:8])
    lib_factor_ms, (LD, piv, _) = event_ms(lambda: torch.linalg.ldl_factor_ex(H_b))
    torch.linalg.ldl_solve(LD[:8], piv[:8], rhs_b[:8, :, None])
    lib_solve_ms, _ = event_ms(lambda: torch.linalg.ldl_solve(LD, piv, rhs_b[..., None]))

    # The floor under any held launch, and kernels 4 and 5 as the general
    # path pairs them (ops/kkt.py: factorize, then solve).
    floor_ms, floor_parts = launch_floor_ms()

    def ldlt_pair():
        fact, _ = ldlt.factorize(H_b)
        return ldlt.solve(fact, rhs_b)

    pair_ms, pair_all = time_ms(ldlt_pair, held=True)
    print(f"# phase12 launch floor on {kind} ({card}): {floor_ms:.5f} ms a held launch "
          f"({floor_parts}); factorize + solve pair at B={B} D={D} float32 {pair_ms:.5f} ms (held; "
          f"repeats {pair_all})", flush=True)

    kernels = [
        ("ldlt_factor", "mini_opt_tpu/ops/pallas_ldlt.py:47", "_ldlt_kernel (launched :115)",
         lambda: ldlt._ldlt_factor_cuda(H_b), lambda: ldlt._factor_plain(H_b),
         # reads the batch-major H whole, writes L, d and the one-byte flag
         B * (D * D + D * D + D) * f32 + B, lib_factor_ms, "pallas_ldlt", "ldlt_factor", err4,
         f"B={B} D={D} float32",
         # what a consumer needs: H's lower triangle read, L's strict lower
         # triangle, d and the flag written
         B * (D * (D + 1) // 2 + D * (D - 1) // 2 + D) * f32 + B),
        ("ldlt_solve", "mini_opt_tpu/ops/pallas_ldlt.py:70", "_solve_kernel (launched :155)",
         lambda: ldlt._ldlt_solve_cuda(Lt, dt, rhs_b), lambda: ldlt._solve_plain(Lt, dt, rhs_b),
         # reads L's strict lower triangle, d and the rhs, writes x
         B * (D * (D - 1) // 2 + 3 * D) * f32, lib_solve_ms, "pallas_ldlt", "ldlt_solve", err5,
         f"B={B} D={D} float32", None),
        ("fused_qp", "mini_opt_tpu/ops/pallas_qp.py:36", "_make_qp_kernel (launched :262)",
         lambda: fq._fused_qp_cuda(*qp_args), lambda: fq._fused_qp_plain_batch(*qp_args),
         # reads G's lower triangle, c, A, b, ia, ib, each as stored (the
         # general path's ia is a stride-0 broadcast: M values); writes x, y
         (stored(qp_args[0][:, :, 0]) * (N + 1) // 2 + sum(stored(t) for t in qp_args[1:6])
          + B * (N + K)) * f32, None, "pallas_fused",
         "fused_qp", err6, f"B={B} N={N} K={K} M={M} float32 6 iterations complementarity", None),
    ]
    for (name, replaces, function, kern, plain, nbytes, lib_ms, route, count_key, err, shape,
         needed_bytes) in kernels:
        k_ms, k_all = time_ms(kern, held=True)
        k_unheld_ms, _ = time_ms(kern)
        plain_ms, _ = event_ms(plain)
        ops = count_ops(plain)
        bound_ms, bound_by = roofline(ops, nbytes)
        beside = (f"; launch floor {floor_ms:.5f} ms, the factorize + solve pair {pair_ms:.5f} ms"
                  if route == "pallas_ldlt" else "")
        print(f"# phase12 kernel {name} {shape} on {kind} ({card}): alone on the card {k_ms:.5f} ms "
              f"(held; unheld {k_unheld_ms:.5f}{beside}), {launched[route][count_key]} "
              f"launches per call; plain {plain_ms:.3f} ms; {ops / B:.0f} elementwise ops per instance, "
              f"{nbytes / B:.0f} bytes -> bound {bound_ms:.6f} ms ({bound_by}), kernel = "
              f"{k_ms / bound_ms:.1f}x bound; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; repeats {k_all}", flush=True)
        if needed_bytes is not None:
            tight_ms, tight_by = roofline(ops, needed_bytes)
            print(f"# phase12 kernel {name}: H read {B * D * D * f32} bytes (B D^2, batch-major, whole) "
                  f"against {B * D * (D + 1) // 2 * f32} (B D (D + 1) / 2, its lower triangle); counting "
                  f"only that triangle and the output a consumer reads, {needed_bytes / B:.0f} bytes a "
                  f"system -> bound {tight_ms:.6f} ms ({tight_by}), kernel = {k_ms / tight_ms:.1f}x that "
                  f"bound", flush=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "mini_opt_tpu_torch/csrc/" + ("fused_qp.cuh" if name == "fused_qp" else "ldlt.cu"),
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
            **({"pair_ms": pair_ms, "launch_floor_ms": floor_ms} if route == "pallas_ldlt" else
               {"ms_b1": qp_one_ms, "qp_route": fq.qp_route(N, K, qp_args[6])}),
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


# Phase 14's other topologies at N = 16, 5/2: one for each border count the
# cases above leave out (k = 2, 3, 5, 6; the closures valid, k = 2 two
# closures between the same poses).
RING_EXTRA_CASES = [
    ("closures ((2, 9), (9, 2)) N=16 5/2 (k=2)", RING_N, ((2, 9), (9, 2)), (5, 2)),
    ("closures ((2, 9), (9, 13)) N=16 5/2 (k=3)", RING_N, ((2, 9), (9, 13)), (5, 2)),
    ("closures ((1, 5), (5, 9), (11, 14)) N=16 5/2 (k=5)", RING_N, ((1, 5), (5, 9), (11, 14)), (5, 2)),
    ("closures ((0, 4), (6, 9), (11, 15)) N=16 5/2 (k=6)", RING_N, ((0, 4), (6, 9), (11, 15)), (5, 2)),
]


def global_ring_n(dtype):
    """The smallest ring N whose slab does not fit one CTA in ``dtype``:
    kernel 7's global-scratch route."""
    n = 2
    while pr.launch_plan(n, 1, 1, dtype).storage != "global":
        n += 1
    return n


def ring_case(n, closures, B, seed):
    """The family and float64 (B, 3E) measurements, (B, 3N) starts of one
    configuration, from the JAX repo's bench distributions."""
    if closures is None:
        return (pr.pose_ring_family(n),) + ring_instances(B, n, seed=seed)
    return (pr.pose_ring_family(n, closures=closures),) + chain_closure_instances(B, n, closures, seed=seed)


def check_ring(tag, got, want, max_err, nan_lanes=()):
    """Kernel 7's feature-major (x, state) against the plain version's: bit
    for bit in both types (the kernel keeps the plain version's order of
    operations and builds without FMA contraction), NaN with NaN; the NaN
    lanes flagged and every other lane finite. Records the largest |kernel -
    plain| per dtype."""
    (xk, sk), (xp, sp) = got, want
    dtype = str(xk.dtype).replace("torch.", "")
    same = bit_identical((xk, xp), (sk, sp))
    diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk, sp)}
    err = max(diffs.values())
    max_err[dtype] = max(max_err[dtype], err)
    others = torch.ones(xk.shape[1], dtype=torch.bool, device=xk.device)
    others[list(nan_lanes)] = False
    flagged = all(bool(sk[2, lane] != 0) for lane in nan_lanes)
    finite = bool(torch.isfinite(xk[:, others]).all() and torch.isfinite(sk[:, others]).all())
    print(f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {diffs}, NaN lanes flagged {flagged}, "
          f"others finite {finite}, lanes flagged {int((sk[2] != 0).sum())} of {sk.shape[1]}", flush=True)
    if not (flagged and finite):
        fail(f"{tag} {dtype}: NaN lanes not flagged or their neighbours not finite")
    if not same:
        fail(f"{tag} {dtype}: kernel 7 and its plain version are not bit-identical ({diffs})")


def ring_vs_plain(max_err):
    """Phase 14: kernel 7 (csrc/pose_ring.cu) against _pose_ring_plain, bit
    for bit, in both types."""
    def ragged(dtype):  # a last CTA with one graph of its W
        return pr.launch_plan(RING_N, 1, 1, dtype).warps + 1

    nan = (5, 9)
    cases = [(name, n, cl, bud, lambda dt: 8192 + 13, nan, None) for name, n, cl, bud in RING_CASES]
    # The other border counts in one type each, alternating (slice 16 cut
    # the script's depth: each plain call costs its operations, not its B).
    cases += [(name, n, cl, bud, lambda dt: 1037, nan, (torch.float64, torch.float32)[k % 2])
              for k, (name, n, cl, bud) in enumerate(RING_EXTRA_CASES)]
    for dtype in (torch.float64, torch.float32):
        n = global_ring_n(dtype)
        # 1/1 (slice 17 cut it from 2/1: the plain call costs N's operations).
        cases.append((f"ring N={n} 1/1 (the smallest global-route N in {str(dtype).replace('torch.', '')})", n,
                      None, (1, 1), lambda dt: 67, nan, dtype))
    for name, n, closures, (iters, ls), batch, nan_lanes, only in cases:
        for dtype in (torch.float64, torch.float32) if only is None else (only,):
            B = batch(dtype)
            fam, data, x0 = ring_case(n, closures, B, seed=n)
            if nan_lanes:
                data[5, 4] = np.nan  # a NaN measurement
                x0[9, 2] = np.nan  # a NaN start
            d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            before = pr.KERNEL_LAUNCHES
            got = pr._pose_ring_cuda(fam, d_t, x_t, iters, ls)
            torch.cuda.synchronize()
            if pr.KERNEL_LAUNCHES != before + 1:
                fail(f"{name}: the pose-ring wrapper did not count its launch")
            want = pr._pose_ring_plain(fam, d_t, x_t, iters, ls)
            plan = pr.launch_plan(n, len(fam.closure_list), B, dtype)
            check_ring(f"phase14 {name} B={B} ({plan.storage}, {plan.warps} graphs/CTA)", got, want, max_err,
                       nan_lanes)
            if name == RING_CASES[0][0]:
                # One graph and a ragged last CTA (W + 1 graphs), against
                # the same plain call's lanes: every lane's arithmetic is
                # its own (slice 17 cut the two plain calls of their own).
                for label, Bs in (("one graph", 1), ("B = W + 1", ragged(dtype))):
                    one = pr._pose_ring_cuda(fam, d_t[:, :Bs].contiguous(), x_t[:, :Bs].contiguous(), iters, ls)
                    check_ring(f"phase14 {name}, {label} B={Bs}", one, tuple(t[:, :Bs] for t in want), max_err)


def ring_plan_lines():
    """Phase 13's plan lines: kernel 7's launch plan at the main path's
    shape and at each type's global-route N, with CTAs per SM."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ring = (ctypes.c_int * 2)(RING_N - 1, 0)
    for dtype in (torch.float32, torch.float64):
        for n in (RING_N, global_ring_n(dtype)):
            plan = pr.launch_plan(n, 1, RING_B, dtype)
            closure = (ctypes.c_int * 2)(n - 1, 0) if n != RING_N else ring
            ctas = lib.mo_pose_ring_occupancy(pr._CUDA_DTYPE_IDS[dtype], n, 1, closure, plan.warps,
                                              int(plan.storage == "global"))
            if ctas < 1:
                fail(f"phase13: occupancy query for ring N={n} {dtype} returned {ctas}")
            print(f"# phase13 kernel 7 launch plan ring N={n} B={RING_B} {str(dtype).replace('torch.', '')}: "
                  f"{plan.warps} graphs/CTA, {plan.warp_bytes} B/graph, {plan.cta_bytes} B/CTA ({plan.storage}), "
                  f"grid {plan.grid}, {ctas} CTAs/SM ({ctas * plan.warps} graphs/SM, {ctas * plan.warps * sms} on "
                  f"{sms} SMs)", flush=True)


def pose_ring_paths(card, kind):
    """Phases 13 (the plan lines) to 16; returns kernel 7's row."""
    max_err = {"float64": 0.0, "float32": 0.0}
    ring_plan_lines()
    ring_vs_plain(max_err)
    CLOCK.mark("phase 14")

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

    CLOCK.mark("phase 15")
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
        "ms_at_B1": k_one_ms,
        "launch_plan": (lambda p: f"{p.warps} graphs/CTA, {p.cta_bytes} B/CTA ({p.storage}), grid {p.grid}")(
            pr.launch_plan(RING_N, 1, RING_B, torch.float32)),
        "converged_share": converged[RING_CASES[0][0]],
        "entry_ms": e2e_ms,
        "general_twin_ms_B1024": gen_ms,
        "card": card,
    }]

# ---------------------------------------------------------------------------
# Phases 17-20: the MPC path (kernels 8 and 9).
# ---------------------------------------------------------------------------

MPC_T, MPC_DT = 20, 0.05
MPC_COLD = (8, 3, 2)
MPC_SERVO = (1, 1, 1)
MPC_GATE_PERIODS = 30  # bench_extras.py:752: the cold period, then 29 servo periods
QUAD_T, QUAD_PERIODS, QUAD_SERVO = 12, 64, (2, 1, 1)  # bench_extras.py:1195-1196
CART = mpcm.CartPole()


# The global-scratch route: at this horizon one float64 quadrotor slab
# (247,808 B) exceeds a CTA's 232,448 B of shared memory; float32 (123,904
# B) stays in shared memory, one warp per CTA.
SLAB_T, SLAB_B = 128, 67


def mpc_family(kind, T=None):
    if kind == "cartpole":
        return pm.cartpole_mpc_family(T or MPC_T, MPC_DT)
    return pm.quadrotor_mpc_family(T or QUAD_T, MPC_DT)


def mpc_build_report(text):
    """Phase 17: per MPC kernel instance, ptxas's registers, spill stores
    and stack frame, and at the main path's horizon (and the global-scratch
    one) the launch plan: warps (instances) per CTA, dynamic shared memory
    per CTA, CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load_library()
    dtypes = {"f": torch.float32, "d": torch.float64}
    for name, nreg, spill, _, stack in ptxas_report(text):
        m = re.search(r"mpc_(solve|servo)_kernelI([fd])NS0_\d+(CartPole|Quadrotor)", name)
        if not m:
            continue
        which, t, plant = m.groups()
        kind = "cartpole" if plant == "CartPole" else "quadrotor"
        dtype = dtypes[t]
        plans = []
        for T in ((MPC_T,) if kind == "cartpole" else (QUAD_T, SLAB_T)):
            plan = pm.launch_plan(mpc_family(kind, T), 1024, dtype)
            ctas = lib.mo_mpc_occupancy(pm._CUDA_DTYPE_IDS[dtype], pm._CUDA_PLANTS[kind], T, int(which == "servo"),
                                        plan.warps, int(plan.storage == "global"))
            if ctas < 1:
                fail(f"phase17: mpc_{which}<{t}, {plant}> at T={T}: occupancy query returned {ctas}")
            plans.append(f"T={T}: {plan.warps} warps/CTA, {plan.cta_bytes} B {plan.storage}, {ctas} CTAs/SM "
                         f"({ctas * plan.warps} instances/SM)")
        print(f"# phase17 ptxas mpc_{which}<{'float' if t == 'f' else 'double'}, {plant}>: {nreg} "
              f"registers, {spill} bytes spill stores, {stack} bytes stack frame; " + "; ".join(plans), flush=True)


def mpc_inputs(kind, B, seed, dtype, poison=False, T=None):
    """(family, x (nx, B), z (dim, B)): the bench's fleet as feature-major
    CUDA tensors and the cold initial guess; ``poison`` makes lane 5's
    state and lane 9's warm start NaN."""
    fam = mpc_family(kind, T)
    x = (cartpole_mpc_instances if kind == "cartpole" else quadrotor_mpc_instances)(B, seed)
    z = mpcm.family_initial_guess(fam, torch.as_tensor(x)).numpy()
    if poison:
        x[5, 2] = np.nan
        z[9, 1] = np.nan
    return (fam,) + mot.batch_from_numpy(x, z, "cuda", dtype)


def check_mpc(tag, got, want, flag_row, max_err, nan_lanes=()):
    """Kernel 8's or 9's feature-major outputs against the plain version's:
    bit for bit in both types (the kernels sum in the plain versions' order
    and build without FMA contraction); the NaN lanes flagged and every
    other lane finite. Also reports the float64 1e-9 and float32 share
    measures of phase 3. Records the largest |kernel - plain| per dtype."""
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    dtype = str(got[0].dtype).replace("torch.", "")
    same = bit_identical(*pairs)
    err = max(max_abs_diff(g, w) for g, w in pairs)
    max_err[dtype] = max(max_err[dtype], err)
    fk, fp = got[flag_row][2], want[flag_row][2]
    flags_agree = (fk == fp).double().mean().item()
    others = torch.ones_like(fk, dtype=torch.bool)
    others[list(nan_lanes)] = False
    agree = others.clone()
    for g, w in pairs:
        agree &= lanes_agree(g, w, 1e-3)
    # Over the lanes with finite inputs (a NaN lane's cost is +inf on both
    # sides, which lanes_agree does not count as agreeing).
    z_agree = (agree.double().sum() / others.double().sum()).item()
    flagged = all(bool(fk[lane] != 0) for lane in nan_lanes)
    finite = all(bool(torch.isfinite(g[..., others]).all()) for g, _ in pairs)
    print(f"# {tag} {dtype} (bit-identical {same}): max|kernel - plain| {err:.3e}, flags agree "
          f"{flags_agree:.6f}, outputs within 1e-3 {z_agree:.6f}, NaN lanes flagged {flagged}, others finite "
          f"{finite}, lanes flagged {int((fk != 0).sum())}", flush=True)
    if nan_lanes and not (flagged and finite):
        fail(f"{tag} {dtype}: NaN lanes not flagged or their neighbours not finite")
    if not same:
        fail(f"{tag} {dtype}: kernel and plain version are not bit-identical (max diff {err})")
    if dtype == "float64" and (err > 1e-9 or flags_agree != 1.0):
        fail(f"{tag}: kernel disagrees with the plain version ({err}, flags {flags_agree})")
    if dtype == "float32" and (flags_agree < 0.999 or z_agree < 0.995):
        fail(f"{tag}: float32 agreement below threshold")


def mpc_vs_plain(err8, err9):
    """Phase 18: kernels 8 and 9 against their plain versions, bit for bit."""
    B = 8192 + 13
    # One instance and a ragged last CTA (W + 1 instances for W warps per
    # CTA) at the main path's budgets run against the first lanes of the
    # same plain call (its lanes are independent, and a plain call costs its
    # operations, not B; slice 17 cut the plain calls of their own).
    solves = [("cart-pole T=20 8/3/2 +history", "cartpole", MPC_COLD, True),
              ("cart-pole T=20 2/2/1 +history", "cartpole", (2, 2, 1), True),
              ("quadrotor T=12 8/3/2 +history", "quadrotor", MPC_COLD, True)]
    for name, kind, bud, hist in solves:
        for dtype in (torch.float64, torch.float32):
            fam, x_t, z_t = mpc_inputs(kind, B, 1, dtype, poison=True)
            want = pm._mpc_plain(fam, x_t, z_t, *bud, hist)
            solve_vs_plain(f"phase18 kernel 8 {name} B={B}", fam, x_t, z_t, bud, hist, err8, (5, 9), want=want)
            if bud == MPC_COLD:
                for Bs in (1, pm.launch_plan(fam, 1, dtype).warps + 1):
                    solve_vs_plain(f"phase18 kernel 8 {name} B={Bs}", fam, x_t[:, :Bs].contiguous(),
                                   z_t[:, :Bs].contiguous(), bud, hist, err8,
                                   want=tuple(w[..., :Bs] for w in want))
    servos = [("cart-pole T=20 1/1/1 x 8 periods", "cartpole", MPC_SERVO),
              ("quadrotor T=12 2/1/1 x 8 periods", "quadrotor", QUAD_SERVO)]
    for name, kind, bud in servos:
        for dtype in (torch.float64, torch.float32):
            fam, x_t, z_t = mpc_inputs(kind, B, 2, dtype, poison=True)
            want = pm._mpc_servo_plain(fam, x_t, z_t, 8, *bud)
            servo_vs_plain(f"phase18 kernel 9 {name} B={B}", fam, x_t, z_t, 8, bud, err9, (5, 9), want=want)
            for Bs in (1, pm.launch_plan(fam, 1, dtype).warps + 1):
                servo_vs_plain(f"phase18 kernel 9 {name} B={Bs}", fam, x_t[:, :Bs].contiguous(),
                               z_t[:, :Bs].contiguous(), 8, bud, err9, want=tuple(w[..., :Bs] for w in want))

    # The global-scratch route (float64) and one warp per CTA (float32).
    for dtype, storage in ((torch.float64, "global"), (torch.float32, "shared")):
        fam, x_t, z_t = mpc_inputs("quadrotor", SLAB_B, 4, dtype, poison=True, T=SLAB_T)
        plan = pm.launch_plan(fam, SLAB_B, dtype)
        if plan.storage != storage:
            fail(f"phase18: quadrotor T={SLAB_T} {dtype} plans {plan}, not the {storage} route")
        tag = f"quadrotor T={SLAB_T} B={SLAB_B} ({plan.storage}, {plan.warps} warps/CTA)"
        solve_vs_plain(f"phase18 kernel 8 {tag} 1/1/1", fam, x_t, z_t, (1, 1, 1), False, err8, (5, 9))
        servo_vs_plain(f"phase18 kernel 9 {tag} 1/1/1 x 2 periods", fam, x_t, z_t, 2, (1, 1, 1), err9, (5, 9))


def solve_vs_plain(tag, fam, x_t, z_t, bud, hist, err8, nan_lanes=(), want=None):
    """Kernel 8 against its plain version on the same inputs (``want``: the
    plain version's outputs on these lanes, when already computed)."""
    before = pm.KERNEL_LAUNCHES
    got = pm._mpc_cuda(fam, x_t, z_t, *bud, hist)
    torch.cuda.synchronize()
    if pm.KERNEL_LAUNCHES != before + 1:
        fail(f"{tag}: the kernel-8 wrapper did not count its launch")
    if want is None:
        want = pm._mpc_plain(fam, x_t, z_t, *bud, hist)
    check_mpc(tag, got, want, 1, err8, nan_lanes=nan_lanes)


def servo_vs_plain(tag, fam, x_t, z_t, periods, bud, err9, nan_lanes=(), want=None):
    """Kernel 9 against its plain version, as solve_vs_plain."""
    before = pm.SERVO_LAUNCHES
    got = pm._mpc_servo_cuda(fam, x_t, z_t, periods, *bud)
    torch.cuda.synchronize()
    if pm.SERVO_LAUNCHES != before + 1:
        fail(f"{tag}: the kernel-9 wrapper did not count its launch")
    if want is None:
        want = pm._mpc_servo_plain(fam, x_t, z_t, periods, *bud)
    check_mpc(tag, got, want, 2, err9, nan_lanes=nan_lanes)


def expect_launches(tag, want_nonzero):
    got = counts()
    want = {k: want_nonzero.get(k, 0) for k in got}
    if got != want:
        fail(f"{tag}: launches {got}, expected {want_nonzero}")
    return got


def mpc_paths(card, kind):
    """Phases 18-20; returns the rows of kernels 8 and 9."""
    err8 = {"float64": 0.0, "float32": 0.0}
    err9 = {"float64": 0.0, "float32": 0.0}
    mpc_vs_plain(err8, err9)
    CLOCK.mark("phase 18")

    # Phase 19: the main path, mpc_servo_bench's cold solve + servo loop.
    fam = pm.cartpole_mpc_family(MPC_T, MPC_DT)
    main = {}
    for B in (1024, 8192):
        x0 = torch.as_tensor(cartpole_mpc_instances(B, 0), dtype=torch.float32, device="cuda")
        reset_counts()
        z0 = mpcm.initial_guess(CART, x0, MPC_T, MPC_DT)
        z = mot.fused_mpc_solve_batch(fam, x0, z0, *MPC_COLD)
        x1 = mpcm.rk4_step(CART, x0, z[:, 0], MPC_DT)
        z1 = mpcm.shift_warm_start(CART, z, MPC_T, MPC_DT)
        xf, zf, stats = mot.fused_mpc_servo_batch(fam, x1, z1, MPC_GATE_PERIODS - 1, *MPC_SERVO)
        torch.cuda.synchronize()
        got = expect_launches(f"phase19 cart-pole B={B}", {"mpc": 1, "mpc_servo": 1})
        if xf.shape != (B, 4) or zf.shape != (B, fam.dim) or stats.shape != (B, 4) or not xf.is_cuda:
            fail(f"phase19: unexpected outputs {tuple(xf.shape)} {tuple(zf.shape)} {tuple(stats.shape)}")
        theta = xf[:, 2].abs().double().cpu().numpy()
        share = float(np.mean(theta < 0.05))
        print(f"# phase19 main path cart-pole T={MPC_T} B={B} float32: cold fused_mpc_solve_batch "
              f"{MPC_COLD}, rk4_step + shift_warm_start, fused_mpc_servo_batch {MPC_SERVO} x "
              f"{MPC_GATE_PERIODS - 1}: launches {got}; stabilized share (|theta| < 0.05) {share:.6f}, "
              f"|theta| median {np.median(theta):.3e} max {theta.max():.3e}, max|u0| {stats[:, 3].max().item():.4f}, "
              f"lanes flagged {int((stats[:, 2] != 0).sum())}, all finite {bool(torch.isfinite(zf).all())}", flush=True)
        if not share >= 0.99:
            fail(f"phase19: stabilized share {share} is below 0.99")
        main[B] = dict(x0=x0, z0=z0, x1=x1, z1=z1, share=share, launches=got)
        if B == 1024:
            xt, zt = x0.T.contiguous(), z0.T.contiguous()
            zp, sp0, _ = pm._mpc_plain(fam, xt, zt, *MPC_COLD)
            x1p = mpcm.rk4_step(CART, x0, zp[0], MPC_DT)
            z1p = mpcm.shift_warm_start(CART, zp.T, MPC_T, MPC_DT)
            want = pm._mpc_servo_plain(fam, x1p.T.contiguous(), z1p.T.contiguous(), MPC_GATE_PERIODS - 1,
                                       *MPC_SERVO)
            check_mpc(f"phase19 main path B={B} against the plain sequence", (z.T, xf.T, zf.T, stats.T),
                      (zp,) + tuple(want), 3, err9)

    B = 1024
    x0 = main[B]["x0"]
    reset_counts()
    states, _, st_roll = mpcm.fused_mpc_rollout_batch(CART, x0, 8, MPC_T, MPC_DT, budget=(2, 2, 1))
    torch.cuda.synchronize()
    got = expect_launches("phase19 fused_mpc_rollout_batch", {"mpc": 8})
    roll_share = float((states[-1][:, 2].abs() < 0.05).double().mean().item())
    print(f"# phase19 fused_mpc_rollout_batch cart-pole B={B} float32 cold {MPC_COLD} then (2, 2, 1), 8 steps: "
          f"launches {got}; stabilized share after 8 steps {roll_share:.6f}, lanes flagged "
          f"{int((st_roll[:, 2] != 0).sum())}", flush=True)

    quad = pm.quadrotor_mpc_family(QUAD_T, MPC_DT)
    for Bq in (1024, 8192):
        xq = torch.as_tensor(quadrotor_mpc_instances(Bq, 0), dtype=torch.float32, device="cuda")
        reset_counts()
        zq1 = mot.fused_mpc_solve_batch(quad, xq, mpcm.family_initial_guess(quad, xq), *MPC_COLD)
        xqf, _, sq = mot.fused_mpc_servo_batch(quad, xq, zq1, QUAD_PERIODS, *QUAD_SERVO)
        torch.cuda.synchronize()
        got = expect_launches(f"phase19 quadrotor B={Bq}", {"mpc": 1, "mpc_servo": 1})
        hover = ((xqf[:, :2].abs() < 0.1).all(1) & (xqf[:, 2].abs() < 0.05)).double().mean().item()
        print(f"# phase19 quadrotor T={QUAD_T} B={Bq} float32: cold {MPC_COLD}, servo {QUAD_SERVO} x "
              f"{QUAD_PERIODS}: launches {got}; hover share {hover:.6f}, lanes flagged "
              f"{int((sq[:, 2] != 0).sum())}", flush=True)
        if not hover >= 0.99:
            fail(f"phase19: quadrotor hover share {hover} is below 0.99")

    CLOCK.mark("phase 19")
    # Phase 20: times at the main path's shapes (B = 1024).
    m = main[B]
    x0, z0, x1, z1 = m["x0"], m["z0"], m["x1"], m["z1"]
    xt, zt, x1t, z1t = (a.T.contiguous() for a in (x0, z0, x1, z1))
    k8 = lambda: pm._mpc_cuda(fam, xt, zt, *MPC_COLD)  # noqa: E731
    k8_ms, k8_all = time_ms(k8, launches=10, held=True)
    k8_one = lambda: pm._mpc_cuda(fam, xt[:, :1].contiguous(), zt[:, :1].contiguous(), *MPC_COLD)  # noqa: E731
    k8_one_ms, _ = time_ms(k8_one, launches=10, held=True)
    K = 65

    def period_ms(x1t_, z1t_):
        """Kernel 9 per period at these inputs, (servo(K) - servo(1)) / (K - 1)
        held; with servo(1), servo(K) and servo(K)'s repeats."""
        s1, _ = time_ms(lambda: pm._mpc_servo_cuda(fam, x1t_, z1t_, 1, *MPC_SERVO), launches=10, held=True)
        sK, sK_all = time_ms(lambda: pm._mpc_servo_cuda(fam, x1t_, z1t_, K, *MPC_SERVO), launches=3, held=True)
        return (sK - s1) / (K - 1), s1, sK, sK_all

    per_period, s1_ms, sK_ms, sK_all = period_ms(x1t, z1t)
    # One instance and the large fleet: B = 1 (lane 0) and B = 8192.
    per_period_one = period_ms(x1t[:, :1].contiguous(), z1t[:, :1].contiguous())[0]
    m8 = main[8192]
    xt8, zt8, x1t8, z1t8 = (a.T.contiguous() for a in (m8["x0"], m8["z0"], m8["x1"], m8["z1"]))
    k8_big_ms, _ = time_ms(lambda: pm._mpc_cuda(fam, xt8, zt8, *MPC_COLD), launches=10, held=True)
    per_period_big = period_ms(x1t8, z1t8)[0]
    plan = pm.launch_plan(fam, B, torch.float32)
    plan_txt = f"{plan.warps} warps/CTA, {plan.cta_bytes} B {plan.storage} per CTA"
    e8_ms, _ = time_ms(lambda: mot.fused_mpc_solve_batch(fam, x0, z0, *MPC_COLD), launches=10)
    e9_ms, _ = time_ms(lambda: mot.fused_mpc_servo_batch(fam, x1, z1, MPC_GATE_PERIODS - 1, *MPC_SERVO),
                       launches=3)
    plain8 = lambda: pm._mpc_plain(fam, xt, zt, *MPC_COLD)  # noqa: E731
    plain8_ms, _ = event_ms(plain8)
    plain9_ms, _ = event_ms(lambda: pm._mpc_servo_plain(fam, x1t, z1t, 2, *MPC_SERVO))
    plain9_ms /= 2
    ops8 = count_ops(plain8)
    ops9 = count_ops(lambda: pm._mpc_servo_plain(fam, x1t, z1t, 1, *MPC_SERVO))
    nx, dim = fam.nx, fam.dim
    # Kernel 8 reads x0 and z0 and writes z and the state; kernel 9's K-period
    # launch reads x and z and writes x, z and 4 stats, a 1/K share per period.
    bound8_ms, bound8_by = roofline(ops8, B * (nx + dim + dim + 3) * 4)
    bound9_ms, bound9_by = roofline(ops9, B * (nx + dim + nx + dim + 4) * 4 / K)
    print(f"# phase20 kernel 8 cart-pole T={MPC_T} B={B} float32 {MPC_COLD} on {kind} ({card}): alone on the card "
          f"{k8_ms:.4f} ms ({B / k8_ms * 1e3:.4e} solves/s), at B=1 {k8_one_ms:.4f} ms; fused_mpc_solve_batch "
          f"issued back to back {e8_ms:.4f} ms/call; plain {plain8_ms:.1f} ms; {ops8 / B:.0f} elementwise ops "
          f"per instance -> bound {bound8_ms:.6f} ms ({bound8_by}), kernel = {k8_ms / bound8_ms:.1f}x bound; "
          f"library none; repeats {k8_all}; at B=8192 {k8_big_ms:.4f} ms ({8192 / k8_big_ms * 1e3:.4e} solves/s, "
          f"{k8_big_ms / (8 * bound8_ms):.1f}x its bound); {plan_txt}", flush=True)
    print(f"# phase20 kernel 9 cart-pole T={MPC_T} B={B} float32 {MPC_SERVO} on {kind} ({card}): servo(1) "
          f"{s1_ms:.4f} ms, servo({K}) {sK_ms:.4f} ms -> {per_period:.5f} ms per period "
          f"({B / per_period * 1e3:.4e} control solves/s); fused_mpc_servo_batch x {MPC_GATE_PERIODS - 1} "
          f"issued back to back {e9_ms:.4f} ms/call; plain {plain9_ms:.1f} ms per period; {ops9 / B:.0f} "
          f"elementwise ops per instance-period -> bound {bound9_ms:.6f} ms ({bound9_by}), kernel = "
          f"{per_period / bound9_ms:.1f}x bound; library none; repeats servo({K}) {sK_all}; per period at B=1 "
          f"{per_period_one:.5f} ms, at B=8192 {per_period_big:.5f} ms ({8192 / per_period_big * 1e3:.4e} "
          f"control solves/s); {plan_txt}", flush=True)

    # The general twin: solve_mpc batched through nls_solve on the Riccati
    # KKT backend at 2/2/1, Mehrotra, on the same lanes (reported).
    params = dataclasses.replace(
        mpcm.default_mpc_params(torch.float32, early_exit=False, horizon=MPC_T),
        max_iterations=2, max_qp_iterations=2, max_line_search_iterations=1,
        qp_barrier_strategy=mot.BarrierStrategy.PREDICTOR_CORRECTOR, record_history=False,
    )
    general = lambda: mpcm.solve_mpc(CART, x0, MPC_T, MPC_DT, params=params, z0=z0)  # noqa: E731
    general()
    torch.cuda.synchronize()
    gen_ms, res = event_ms(general)
    _, st_k = mot.fused_mpc_solve_batch(fam, x0, z0, 2, 2, 1, return_state=True)
    k221_ms, _ = time_ms(lambda: pm._mpc_cuda(fam, xt, zt, 2, 2, 1), launches=10, held=True)
    f_gen = res.errors.f.double().cpu().numpy()
    f_k = st_k[:, 0].double().cpu().numpy()
    print(f"# phase20 general twin solve_mpc + nls_solve kkt_solver={params.kkt_solver} cart-pole T={MPC_T} "
          f"B={B} float32 2/2/1 mpc on {kind} ({card}): {gen_ms:.3f} ms/call ({B / gen_ms * 1e3:.4e} "
          f"solves/s), cost median {np.median(f_gen):.6e} (kernel 8 at 2/2/1 on the same lanes "
          f"{np.median(f_k):.6e}, {k221_ms:.4f} ms held); kernel solves/s over the twin's "
          f"{gen_ms / k221_ms:.1f}x", flush=True)

    common = dict(route="cuda", source="mini_opt_tpu_torch/csrc/mpc.cu", library_ms=None, card=card)
    return [
        dict(common, name="mpc_solve", replaces="mini_opt_tpu/ops/pallas_mpc.py:419",
             function="_make_mpc_kernel (launched :1268)", launches=m["launches"]["mpc"],
             max_abs_err=max(err8.values()), max_abs_diff_f64=err8["float64"], ms=k8_ms, plain_ms=plain8_ms,
             bound_ms=bound8_ms, bound_by=bound8_by, shape=f"B={B} cart-pole T={MPC_T} float32 8/3/2",
             ops_per_instance=ops8 / B, ms_at_B1=k8_one_ms, ms_at_B8192=k8_big_ms, entry_ms=e8_ms,
             general_twin_ms_221=gen_ms, launch_plan=plan_txt),
        dict(common, name="mpc_servo", replaces="mini_opt_tpu/ops/pallas_mpc.py:992",
             function="_make_mpc_servo_kernel (launched :1131)", launches=m["launches"]["mpc_servo"],
             max_abs_err=max(err9.values()), max_abs_diff_f64=err9["float64"], ms=per_period,
             plain_ms=plain9_ms, bound_ms=bound9_ms, bound_by=bound9_by,
             shape=f"B={B} cart-pole T={MPC_T} float32 1/1/1, per period of a {K}-period launch",
             ops_per_instance=ops9 / B, control_solves_per_s=B / per_period * 1e3,
             stabilized_share=m["share"], entry_ms_29_periods=e9_ms, ms_at_B1=per_period_one,
             ms_at_B8192=per_period_big, launch_plan=plan_txt),
    ]


# ---------------------------------------------------------------------------
# Phases 21-24: families generated from a Problem (kernel 1, emitted).
# ---------------------------------------------------------------------------


def _wrap(th):
    return [fik._mod_pi(t) for t in th]


def generated_families():
    """Phase 21's families: name -> (family, instances(B, seed), parity kind
    or None)."""
    chain = mot.make_spatial_chain(3, LINK, dtype=torch.float64, device="cpu")
    return {
        "planar n=2": (mot.family_from_problem(scalar_planar_ik_builder(2, LINK), 2, retract=_wrap),
                       lambda B, seed: planar_instances(B, 2, seed=seed), "planar"),
        "spatial chain n=3": (
            mot.family_from_problem(mot.scalar_chain_ik_builder(chain, target_dim=3), 3, retract=_wrap),
            lambda B, seed: spatial_instances(B, 3, seed=seed), "spatial"),
        "block chain": (mot.family_from_problem(block_chain_problem, 6), block_chain_instances, None),
        "robust line fit": (mot.family_from_problem(robust_line_fit_problem, 4), robust_line_fit_instances, None),
    }


def emit_and_build(emitters):
    """Emit every source (name -> a call that returns it) and build them all
    (one nvcc each, all together); returns ({name: emit seconds}, build
    seconds, {name: library path})."""
    sources, emit_s = {}, {}
    for name, emit in emitters.items():
        t0 = time.perf_counter()
        sources[name] = emit()
        emit_s[name] = time.perf_counter() - t0
    t1 = time.perf_counter()
    paths = _build.build_generated(list(sources.values()))
    return emit_s, time.perf_counter() - t1, dict(zip(sources, paths))


def generated_build_report(families, emit_s, build_s, paths):
    """Phase 21: emit and build seconds, program sizes, ptxas per instance."""
    print(f"# phase21 emitted {len(families)} generated families in {emit_s:.1f} s (traces of linearize, "
          f"errors and retract in float32 and float64), built them in {build_s:.1f} s (in phase 2's pass)",
          flush=True)
    for name, (fam, _, _) in families.items():
        progs = fam.cuda_program.programs(torch.float32)
        sizes = {k: len(v.stmts) for k, v in progs.items() if v is not None}
        print(f"# phase21 {name}: n={fam.n} m_eq={fam.m_eq} rows={fam.data_rows} lower={fam.lower} "
              f"upper={fam.upper}, float32 statements {sizes}, library {paths[name].name}", flush=True)
        log = paths[name].with_suffix(".log")
        for kname, nreg, spill, _, stack in ptxas_report(log.read_text() if log.exists() else ""):
            m = re.search(r"fused_ik_kernelI([fd])", kname)
            if m:
                t = "float" if m.group(1) == "f" else "double"
                print(f"# phase21 ptxas fused_ik<{t}, generated {name}>: {nreg} registers, {spill} bytes spill "
                      f"stores, {stack} bytes stack frame", flush=True)


def check_generated(tag, got, want, max_err, parity_kind=None, data=None):
    """Hold a generated instance's batch-major (x, state, history) against
    the plain version's, bit for bit; exit on any difference."""
    (xk, sk, hk), (xp, sp, hp) = got, want
    dtype = str(xk.dtype).replace("torch.", "")
    pairs = [(xk, xp), (sk, sp)] + ([(hk, hp)] if hp is not None else [])
    same = bit_identical(*pairs)
    diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk, sp)}
    if hp is not None:
        diffs["history"] = max_abs_diff(hk, hp)
    max_err[dtype] = max(max_err[dtype], max(diffs.values()))
    extra = ""
    if parity_kind is not None:
        extra = f", parity {(effector_error(parity_kind, xk.cpu(), data) < 1e-3).mean():.6f}"
    print(f"# {tag} {dtype}: bit-identical {same}, max|kernel - plain| {diffs}{extra}", flush=True)
    if not same:
        fail(f"{tag} {dtype}: the generated kernel disagrees with its plain version ({diffs})")


GEN_CASES = [
    ("4/2/1 mpc armijo", BENCH, False, 8192 + 13, False),
    ("3/2/2 complementarity polynomial +history", dict(max_iterations=3, qp_iterations=2, ls_iterations=2,
                                                         barrier="complementarity", line_search="polynomial"),
     True, 8192 + 13, False),
    ("4/2/1 mpc armijo, one instance", BENCH, False, 1, False),
    ("3/2/2 complementarity polynomial +history, strided inputs", dict(
        max_iterations=3, qp_iterations=2, ls_iterations=2, barrier="complementarity", line_search="polynomial"),
     True, 33, True),
]


def generated_vs_plain(families, max_err):
    """Phase 22: every generated instance against its plain version."""
    for name, (fam, instances, kind) in families.items():
        for case, kw, hist, B, strided in GEN_CASES:
            data, x0 = instances(B, 7)
            if B > 9:
                data[5, 0] = np.nan
                x0[9, 1] = np.nan
            for dtype in (torch.float64, torch.float32):
                d = torch.as_tensor(data, dtype=dtype, device="cuda")
                x = torch.as_tensor(x0, dtype=dtype, device="cuda")
                if strided:
                    d, x = torch.stack([d, d], 2)[:, :, 0], x.T.contiguous().T
                args = (fam, d, x, kw["max_iterations"], kw["qp_iterations"], kw["ls_iterations"],
                        kw["line_search"], kw["barrier"], hist)
                before = fik.GENERATED_LAUNCHES
                got = fik._fused_solve_cuda(*args)
                torch.cuda.synchronize()
                if fik.GENERATED_LAUNCHES != before + 1:
                    fail(f"phase22 {name}: the generated kernel's wrapper did not count its launch")
                want = fik._fused_solve_plain_batch(*args)
                torch.cuda.synchronize()
                check_generated(f"phase22 {name} {case} B={B}", got, want, max_err, kind, data)


def wrapped_dx(a, b):
    """Largest angle difference per lane, modulo 2 pi."""
    d = (a.double() - b.double()).abs().cpu().numpy()
    return np.minimum(d, 2 * np.pi - d).max(axis=1)


def generated_paths(card, kind, families, max_err):
    """Phases 22-24; returns the generated route's kernel row."""
    generated_vs_plain(families, max_err)
    CLOCK.mark("phase 22")
    fam = families["planar n=2"][0]

    # Phase 23: bench.py's default route through the public entry point.
    batches = (8192, 262144)
    inst = {B: planar_instances(B, 2, seed=0) for B in batches}
    reset_counts()
    results = {}
    for B in batches:
        targets, x0 = (a.astype(np.float32) for a in inst[B])
        results[B] = mot.fused_solve_batch(fam, targets, x0, return_state=True, **BENCH)
    torch.cuda.synchronize()
    launched = counts()
    if launched["fused_ik_generated"] != len(batches) or any(
            v for k, v in launched.items() if k != "fused_ik_generated"):
        fail(f"phase23: the generated route launched {launched}, not one generated kernel a call")
    launches = launched["fused_ik_generated"]
    print(f"# phase23 main path (generated family): launches {launched} for {len(batches)} calls", flush=True)
    rows = {}
    for B in batches:
        x, state = results[B]
        targets, x0 = inst[B]
        if x.shape != (B, 2) or state.shape != (B, 3) or not x.is_cuda or not torch.isfinite(x).all():
            fail(f"phase23 B={B}: unexpected outputs {tuple(x.shape)} {tuple(state.shape)} {x.device}")
        err = effector_error("planar", x.cpu(), targets)
        parity = float((err < 1e-3).mean())
        t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))
        x_hand = mot.fused_ik_solve_batch(t_d, x_d, link_len=LINK, **BENCH)
        dx = wrapped_dx(x, x_hand)
        print(f"# phase23 B={B} float32 on {kind} ({card}): parity {parity:.6f} (max err {err.max():.3e}); "
              f"against the hand-written family (fused_ik_solve_batch): max |dx| {dx.max():.3e}, "
              f"lanes with |dx| > 1e-3 {int((dx > 1e-3).sum())}", flush=True)
        entry = lambda: mot.fused_solve_batch(fam, t_d, x_d, **BENCH)  # noqa: E731
        kernels_a_call(f"phase23 fused_solve_batch (generated family) B={B} float32", entry, (r"fused_ik_kernel",))
        rows[B] = dict(parity=parity)
        if B == 8192:
            want = fik._fused_solve_plain_batch(fam, t_d, x_d, 4, 2, 1, "armijo", "mpc", False)
            check_generated(f"phase23 main path B={B}", (x, state, None), want, max_err)
    if rows[8192]["parity"] != 1.0:
        fail(f"phase23: parity at B=8192 is {rows[8192]['parity']}, not 1.0")

    chain = mot.make_spatial_chain(3, LINK, dtype=torch.float32, device="cuda")
    targets, x0 = spatial_instances(8192, 3, seed=0)
    t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))
    reset_counts()
    x_chain = mot.fused_chain_ik_solve(chain, t_d, x_d)
    torch.cuda.synchronize()
    launched = counts()
    if launched["fused_ik_generated"] != 1 or any(v for k, v in launched.items() if k != "fused_ik_generated"):
        fail(f"phase23: fused_chain_ik_solve launched {launched}, not one generated kernel")
    builder = next(b for c, b in _CHAIN_BUILDER_CACHE.values() if c is chain)
    chain_fam = fused_auto._cached_family(builder, 3, None)
    want = fik._fused_solve_plain_batch(chain_fam, t_d, x_d, 10, 3, 1, "armijo", "mpc", False)
    parity = float((effector_error("spatial", x_chain.cpu(), targets) < 1e-3).mean())
    same, diff = bit_identical((x_chain, want[0])), max_abs_diff(x_chain, want[0])
    max_err["float32"] = max(max_err["float32"], diff)
    print(f"# phase23 fused_chain_ik_solve make_spatial_chain(3) B=8192 float32 10/3/1: launches {launched}, "
          f"parity {parity:.6f}; bit-identical to its plain version {same}, max|kernel - plain| {diff}", flush=True)
    if not same:
        fail(f"phase23 fused_chain_ik_solve: the generated kernel disagrees with its plain version ({diff})")

    CLOCK.mark("phase 23")
    # Phase 24: held times, generated and hand-written in turns.
    hand = fik.planar_family(2, LINK)
    inst[1] = tuple(a[:1] for a in inst[8192])
    for B in (8192, 262144, 1):
        t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in inst[B])
        gen_k = lambda: fik._fused_solve_cuda(fam, t_d, x_d, 4, 2, 1, "armijo", "mpc", False)  # noqa: E731
        hand_k = lambda: fik._fused_solve_cuda(hand, t_d, x_d, 4, 2, 1, "armijo", "mpc", False)  # noqa: E731
        g1, _ = time_ms(gen_k, held=True)
        h1, _ = time_ms(hand_k, held=True)
        h2, _ = time_ms(hand_k, held=True)
        g2, _ = time_ms(gen_k, held=True)
        entry = lambda: mot.fused_solve_batch(fam, t_d, x_d, **BENCH)  # noqa: E731
        e_ms, _ = time_ms(entry)
        ed_ms, _ = time_ms(entry, held=True)
        rows.setdefault(B, {}).update(ms=float(np.median([g1, g2])), hand_ms=float(np.median([h1, h2])),
                                      entry_ms=e_ms, entry_device_ms=ed_ms)
        print(f"# phase24 B={B} float32 on {kind} ({card}): generated kernel {g1:.5f} / {g2:.5f} ms, hand-written "
              f"kernel {h1:.5f} / {h2:.5f} ms (held, in turns); fused_solve_batch issued back to back "
              f"{e_ms:.5f} ms/call, its device work {ed_ms:.5f} ms", flush=True)

    B = 8192
    targets, x0 = inst[B]
    t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))
    plain = lambda: fik._fused_solve_plain_batch(fam, t_d, x_d, 4, 2, 1, "armijo", "mpc", False)  # noqa: E731
    plain()
    plain_ms, _ = event_ms(plain)
    # The bound counts the operations the function needs: the fewer of the
    # two plain versions' counts on the same inputs. The generated one
    # evaluates the primal again for each tangent and keeps its zero-tangent
    # products; what it counts past the hand-written one is the emitter's
    # overhead, not work of the solve.
    ops_generated = count_ops(plain)
    ops_hand = count_ops(lambda: fik._fused_solve_plain_batch(hand, t_d, x_d, 4, 2, 1, "armijo", "mpc", False))
    ops = min(ops_generated, ops_hand)
    bound_ms, bound_by = roofline(ops, B * (2 + 2 + 2 + 3) * 4)
    print(f"# phase24 plain version (generated family) B={B} float32: {plain_ms:.3f} ms; {ops_generated / B:.0f} "
          f"elementwise ops per instance ({ops_hand / B:.0f} in the hand-written family's plain version; the "
          f"emitter's overhead {ops_generated / ops_hand - 1:+.1%}) -> bound from {ops / B:.0f}: {bound_ms:.6f} ms "
          f"({bound_by}); generated kernel {rows[B]['ms']:.5f} ms = {rows[B]['ms'] / bound_ms:.1f}x its bound, "
          f"hand-written {rows[B]['hand_ms']:.5f} ms = {rows[B]['hand_ms'] / bound_ms:.1f}x", flush=True)
    return dict(
        name="fused_ik_sqp_generated", route="cuda",
        source="mini_opt_tpu_torch/ops/fused_emit.py + csrc/fused_ik_launch.cuh + csrc/fused_sqp.cuh",
        replaces="mini_opt_tpu/ops/pallas_ik.py:323", function="_make_kernel (generated family, "
        "ops/fused_auto.py:135)", launches=launches, max_abs_err=max(max_err.values()),
        max_abs_diff_f64=max_err["float64"], ms=rows[B]["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, shape=f"B={B} planar n=2 float32 4/2/1 mpc armijo",
        ms_b1=rows[1]["ms"], ms_b262144=rows[262144]["ms"], hand_ms=rows[B]["hand_ms"],
        hand_ms_b1=rows[1]["hand_ms"], hand_ms_b262144=rows[262144]["hand_ms"],
        entry_ms=rows[B]["entry_ms"], ops_per_instance=ops / B, ops_per_instance_generated_plain=ops_generated / B,
        card=card)


# ---------------------------------------------------------------------------
# Phases 25-28: SE(2) pose graphs through the generated family
# (scalar_pose_graph_builder -> family_from_problem -> fused_solve_batch):
# kernel 1 at D = 12, kernel 2 past D = 32 (the emitter's blocked target).
# ---------------------------------------------------------------------------

POSE_BUDGET_4 = dict(max_iterations=6, qp_iterations=1, ls_iterations=2, barrier="mpc", line_search="armijo")
POSE_BUDGET = dict(max_iterations=5, qp_iterations=1, ls_iterations=2, barrier="mpc", line_search="armijo")
# (N, closures or None for the ring, budget): fused_pose_graph_bench's cell
# (scripts/bench_extras.py:469, the ring N = 4), blocked_pose16_bench's
# (:1084, the chain with the closure (4, 12)) and the wider instance of
# tests/test_pallas_blocked.py:415-437 (D = 120, 4 rows a lane).
POSE_CELLS = ((4, None, POSE_BUDGET_4), (16, ((4, 12),), POSE_BUDGET), (40, ((5, 34), (12, 27)), POSE_BUDGET))
POSE_B = 8192
# Phases 26-28 run the plain versions on this many lanes (and phase 26 the
# kernel beside it, with a ragged edge): the N = 40 plain version took 8.5 s
# a call at B = 8192 and 7.4 s at 1024 (NVIDIA H100 80GB HBM3, 700 W).
POSE_PLAIN_B = 1024
POSE_GENERAL_B = 512  # blocked_pose16_bench's general twin
POSE_TOL = 1e-8  # tests/test_pallas_blocked.py:324, x and the cost against nls_solve in float64


def pose_families():
    """Phases 25-28's families: N -> (family, closures, budget)."""
    out = {}
    for N, closures, budget in POSE_CELLS:
        edges = pg.ring_edges(N) if closures is None else chain_edges(N, closures)
        out[N] = (mot.family_from_problem(pg.scalar_pose_graph_builder(N, edges), 3 * len(edges)), closures, budget)
    return out


def pose_register(fam):
    return fam.n + fam.m_eq <= blk.REGISTER_KKT_MAX


def pose_emitters(poses):
    """Phase 2's emit calls for the pose families: the register target up to
    D = 32, the blocked target past it."""
    return {f"pose N={N}": (fam.cuda_program.source if pose_register(fam) else fam.cuda_program.blocked_source)
            for N, (fam, _, _) in poses.items()}


def pose_instances(N, closures, B, seed):
    """The cells' data: the N-gon ring (fused_pose_graph_bench) or the
    wandering chain with closures (blocked_pose16_bench)."""
    return ring_instances(B, N, seed=seed) if closures is None else chain_closure_instances(B, N, closures, seed=seed)


def pose_lean_family(fam, edges, anchor_weight=100.0):
    """The pose family with the linearization that the solve needs, for
    phase 28's bound alone: each edge's primal once and the nonzero entries
    of its analytic Jacobian (the unit weights are static and not
    multiplied, a +-1 entry is no product), each J^T J and J^T r cell summed
    over its nonzero products only. The generated family evaluates the
    primal again for each basis tangent and keeps every zero-tangent
    product: what its plain version counts past this one is the emitter's
    overhead, not work of the solve."""

    def mul(a, b):
        if isinstance(a, float):
            a, b = b, a
        if not isinstance(b, float) or isinstance(a, float):
            return a * b
        return a if b == 1.0 else -a if b == -1.0 else a * b

    def linearize(x, d):
        zero = torch.zeros_like(x[0])
        G = [[zero] * (i + 1) for i in range(fam.n)]
        c = [zero] * fam.n
        f = zero

        def add(idx, rows, jac):
            nonlocal f
            for r in rows:
                f = f + 0.5 * r * r
            for a, ga in enumerate(idx):
                for b, gb in enumerate(idx):
                    if gb <= ga:
                        for k in range(len(rows)):
                            if (k, a) in jac and (k, b) in jac:
                                G[ga][gb] = G[ga][gb] + mul(jac[k, a], jac[k, b])
                for k in range(len(rows)):
                    if (k, a) in jac:
                        c[ga] = c[ga] + mul(jac[k, a], rows[k])

        for e, (i, j) in enumerate(edges):
            idx = (3 * i, 3 * i + 1, 3 * i + 2, 3 * j, 3 * j + 1, 3 * j + 2)
            xi, yi, thi, xj, yj, thj = (x[v] for v in idx)
            co, si = torch.cos(thi), torch.sin(thi)
            dx, dy = xj - xi, yj - yi
            rx, ry = co * dx + si * dy, co * dy - si * dx
            nc, ns = -co, -si
            add(idx, [rx - d[3 * e], ry - d[3 * e + 1], pg._wrap(thj - thi - d[3 * e + 2])],
                {(0, 0): nc, (0, 1): ns, (0, 2): ry, (0, 3): co, (0, 4): si,
                 (1, 0): si, (1, 1): nc, (1, 2): -rx, (1, 3): ns, (1, 4): co, (2, 2): -1.0, (2, 5): 1.0})
        w = anchor_weight
        add((0, 1, 2), [w * x[0], w * x[1], w * pg._wrap(x[2])], {(0, 0): w, (1, 1): w, (2, 2): w})
        return f, [], [], G, c

    return dataclasses.replace(fam, linearize=linearize, cuda_program=None)


def pose_report(poses, emit_s, build_s, paths):
    """Phase 25: emit and build seconds, program sizes, launch plans and
    ptxas per instance."""
    lib_occ = {}
    for N, (fam, closures, _) in poses.items():
        name = f"pose N={N}"
        if pose_register(fam):
            sizes = {k: len(v.stmts) for k, v in fam.cuda_program.programs(torch.float32).items() if v is not None}
            what = f"register target (kernel 1), float32 statements {sizes}"
        else:
            bp = fam.cuda_program.blocked_programs(torch.float32)
            plans = []
            lib = fam.cuda_program.blocked_library()
            for dtype in (torch.float32, torch.float64):
                plan = blk.launch_plan(blk.slab_shape(fam), POSE_B, dtype)
                ctas = lib.mo_generated_blocked_occupancy(blk._CUDA_DTYPE_IDS[dtype], plan.warps,
                                                          int(plan.storage == "global"))
                if ctas < 1:
                    fail(f"phase25 {name}: occupancy query for {dtype} returned {ctas}")
                lib_occ[(N, dtype)] = ctas
                plans.append(f"{str(dtype).replace('torch.', '')}: {plan.warps} warps/CTA, {plan.rows_per_lane} "
                             f"rows/lane, {plan.warp_bytes} B/warp, grid {plan.grid}, {ctas} CTAs/SM")
            what = (f"blocked target (kernel 2), {len(bp.lin)} residual groups, float32 block programs "
                    f"{[len(p.stmts) for p in bp.lin]} statements (linearize) and {[len(p.stmts) for p in bp.err]} "
                    f"(errors), scratch {fam.cuda_program.blocked_scratch()} slots; launch plan at B={POSE_B}: "
                    + "; ".join(plans))
        print(f"# phase25 {name} (closures {closures}): n={fam.n} m_eq={fam.m_eq} rows={fam.data_rows}, "
              f"g_pattern {len(fam.g_pattern)} of {fam.n * (fam.n + 1) // 2} cells; emitted in {emit_s[name]:.1f} s, "
              f"built in {build_s:.1f} s (phase 2's pass); {what}; library {paths[name].name}", flush=True)
        log = paths[name].with_suffix(".log")
        for kname, nreg, spill, _, stack in ptxas_report(log.read_text() if log.exists() else ""):
            m = re.search(r"(fused_ik|blocked_sqp)_kernelI([fd])(?:Li(\d+)E)?", kname)
            if m:
                kernel, t, rows = m.groups()
                label = f"{kernel}<{'float' if t == 'f' else 'double'}" + (f", R={rows}" if rows else "")
                print(f"# phase25 ptxas {label}, pose N={N}>: {nreg} registers, {spill} bytes spill stores, "
                      f"{stack} bytes stack frame", flush=True)


def pose_kernel(fam, d, x, budget, plain=True):
    """The family's generated instance on batch-major card tensors, and its
    plain version on the same: ((x, state), (x, state)), batch-major; with
    ``plain=False`` the instance's alone."""
    bud = tuple(budget[k] for k in ("max_iterations", "qp_iterations", "ls_iterations", "line_search", "barrier"))
    if pose_register(fam):
        before = fik.GENERATED_LAUNCHES
        got = fik._fused_solve_cuda(fam, d, x, *bud, False)[:2]
        torch.cuda.synchronize()
        if fik.GENERATED_LAUNCHES != before + 1:
            fail("phase26: the generated kernel 1 wrapper did not count its launch")
        return (got, fik._fused_solve_plain_batch(fam, d, x, *bud, False)[:2]) if plain else got
    before = blk.GENERATED_LAUNCHES
    got = blk._blocked_solve_cuda(fam, d.T, x.T, *bud)
    torch.cuda.synchronize()
    if blk.GENERATED_LAUNCHES != before + 1:
        fail("phase26: the generated kernel 2 wrapper did not count its launch")
    got = (got[0].T, got[1].T)
    if not plain:
        return got
    want = blk._blocked_solve_plain(fam, d.T, x.T, *bud)
    return got, (want[0].T, want[1].T)


def pose_vs_plain(poses, max_err):
    """Phase 26: every generated pose instance against its plain version,
    bit for bit, in both types: B = 1024 + 13 with a NaN-measurement lane
    (flagged, every other lane finite), B = 1 and B = W + 1 (a ragged last
    CTA: W warps of kernel 2, or kernel 1's 128 threads). The kernel runs
    each batch; the plain version, whose lanes are independent and whose
    cost is its operations' count, not B, runs once on the three batches'
    lanes together (a quarter of this phase's time before)."""
    t0 = time.perf_counter()
    for N, (fam, closures, budget) in poses.items():
        for dtype in (torch.float64, torch.float32):
            W = 128 if pose_register(fam) else blk.launch_plan(blk.slab_shape(fam), 1, dtype).warps
            batches, got = [], []
            for B in (POSE_PLAIN_B + 13, 1, W + 1):
                data, x0 = pose_instances(N, closures, B, seed=7)
                if B > 9:
                    data[5, 0] = np.nan
                d = torch.as_tensor(data, dtype=dtype, device="cuda")
                x = torch.as_tensor(x0, dtype=dtype, device="cuda")
                batches.append((d, x))
                got.append(pose_kernel(fam, d, x, budget, plain=False))
            _, (xp_all, sp_all) = pose_kernel(fam, torch.cat([d for d, _ in batches]),
                                              torch.cat([x for _, x in batches]), budget)
            torch.cuda.synchronize()
            lo = 0
            for (d, _), (xk, sk) in zip(batches, got):
                B = d.shape[0]
                xp, sp = xp_all[lo:lo + B], sp_all[lo:lo + B]
                lo += B
                same = bit_identical((xk, xp), (sk, sp))
                diffs = {"x": max_abs_diff(xk, xp), "state": max_abs_diff(sk, sp)}
                t = str(dtype).replace("torch.", "")
                max_err[t] = max(max_err[t], max(diffs.values()))
                note = ""
                if B > 9:
                    others = torch.ones(B, dtype=torch.bool, device="cuda")
                    others[5] = False
                    flagged, finite = float(sk[5, 2]) != 0, bool(torch.isfinite(xk[others]).all())
                    note = f", NaN lane flagged {flagged}, other lanes finite {finite}"
                    if not (flagged and finite):
                        fail(f"phase26 pose N={N} B={B} {t}: NaN lane not contained{note}")
                print(f"# phase26 pose N={N} B={B} {t}: bit-identical {same}, max|kernel - plain| {diffs}{note}",
                      flush=True)
                if not same:
                    fail(f"phase26 pose N={N} B={B} {t}: the generated kernel disagrees with its plain version")
    print(f"# phase26 {time.perf_counter() - t0:.1f} s", flush=True)


def pose_general_params(iters, ls, matched):
    """nls_solve at the cell's budget: ``matched``, the fused kernel's fixed
    trip counts and constants (tests/test_torch_pose_graph_fused_tiers.py);
    else blocked_pose16_bench's general twin."""
    if not matched:
        return mot.NLSParams(
            max_iterations=iters, max_qp_iterations=1, max_line_search_iterations=ls,
            line_search_strategy=mot.LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
            record_history=False, early_exit=False, qp_barrier_strategy=mot.BarrierStrategy.PREDICTOR_CORRECTOR,
        )
    return mot.NLSParams(
        max_iterations=iters, max_qp_iterations=1, max_line_search_iterations=ls,
        line_search_strategy=mot.LineSearchStrategy.ARMIJO_BACKTRACK, armijo_search_tau=0.5,
        equality_penalty_initial=0.01, lambda_initial=0.001, lambda_failure_init=0.001, min_lambda=1e-9,
        termination_kkt_tolerance=1e-14, absolute_exit_tol=1e-30, relative_exit_tol=0.0,
        absolute_first_derivative_tol=0.0, early_exit=False, kkt_solver="ldlt", record_history=False,
        qp_barrier_strategy=mot.BarrierStrategy.PREDICTOR_CORRECTOR,
    )


def pose_paths(card, kind, poses):
    """Phases 26-28; returns the pose instances' kernel rows."""
    max_err = {"float64": 0.0, "float32": 0.0}
    pose_vs_plain(poses, max_err)
    CLOCK.mark("phase 26")
    rows = []
    for N, (fam, closures, budget) in poses.items():
        register = pose_register(fam)
        key, pattern = ("fused_ik_generated", r"fused_ik_kernel") if register else ("blocked_generated",
                                                                                  r"blocked_sqp_kernel")
        iters, ls = budget["max_iterations"], budget["ls_iterations"]
        bud = (iters, 1, ls, "armijo", "mpc")
        edges = pg.ring_edges(N) if closures is None else chain_edges(N, closures)
        builder = pg.scalar_pose_graph_builder(N, edges)

        # Phase 27: the cell through the public entry point, float32.
        t_cell = time.perf_counter()
        data, x0 = pose_instances(N, closures, POSE_B, seed=0)
        d32, x32 = data.astype(np.float32), x0.astype(np.float32)
        reset_counts()
        x, state = mot.fused_solve_batch(fam, d32, x32, return_state=True, **budget)
        torch.cuda.synchronize()
        launched = counts()
        if launched[key] != 1 or any(v for k, v in launched.items() if k != key):
            fail(f"phase27 pose N={N}: fused_solve_batch launched {launched}, not one generated kernel")
        if x.shape != (POSE_B, fam.n) or state.shape != (POSE_B, 3) or not x.is_cuda or not torch.isfinite(x).all():
            fail(f"phase27 pose N={N}: unexpected outputs {tuple(x.shape)} {tuple(state.shape)}")
        f = state[:, 0].double().cpu().numpy()
        converged = float(np.mean(f < 2e-3 * N))
        t_d, x_d = (torch.as_tensor(a, device="cuda") for a in (d32, x32))
        # The main path's first POSE_PLAIN_B lanes against the plain version
        # on theirs (the lanes are independent); phase 28 reports this
        # call's time as the plain version's.
        Bp = POSE_PLAIN_B
        if register:
            kern = lambda d_, x_: fik._fused_solve_cuda(fam, d_, x_, *bud, False)  # noqa: E731
            plain_of = lambda F, d_, x_: fik._fused_solve_plain_batch(F, d_, x_, *bud, False)[:2]  # noqa: E731
        else:
            kern = lambda d_, x_: blk._blocked_solve_cuda(fam, d_.T, x_.T, *bud)  # noqa: E731
            plain_of = lambda F, d_, x_: tuple(  # noqa: E731
                v.T for v in blk._blocked_solve_plain(F, d_.T, x_.T, *bud))
        plain_ms, (xp, sp) = event_ms(lambda: plain_of(fam, t_d[:Bp], x_d[:Bp]))
        same = bit_identical((x[:Bp], xp), (state[:Bp], sp))
        max_err["float32"] = max(max_err["float32"], max_abs_diff(x[:Bp], xp), max_abs_diff(state[:Bp], sp))
        print(f"# phase27 pose N={N} (D={fam.n}) fused_solve_batch B={POSE_B} float32 {iters}/1/{ls} mpc armijo on "
              f"{kind} ({card}): launches {launched} for 1 call; cost median {np.median(f):.4e}, p99 "
              f"{np.quantile(f, 0.99):.4e}, converged share (cost < {2e-3 * N:.3g}) {converged:.6f}, flags 0 share "
              f"{float((state[:, 2] == 0).double().mean()):.6f}; the first {Bp} lanes bit-identical to the plain "
              f"version {same}",
              flush=True)
        if converged < 0.99 or not same:
            fail(f"phase27 pose N={N}: converged share {converged} or bits ({same})")
        entry = lambda: mot.fused_solve_batch(fam, t_d, x_d, **budget)  # noqa: E731
        # Fewer calls a session where one call runs for tens of ms.
        kernels_a_call(f"phase27 pose N={N} fused_solve_batch B={POSE_B} float32 on card tensors", entry, (pattern,),
                       reps=20 if N <= 16 else 4)

        # The same Problem through nls_solve in float64 at the general twin's
        # width: the JAX test's bound on x and on the final cost.
        Bg = POSE_GENERAL_B
        d64, x64 = (torch.as_tensor(a[:Bg], device="cuda") for a in (data, x0))
        xf, sf = mot.fused_solve_batch(fam, d64, x64, return_state=True, **budget)
        res = mot.nls_solve(builder, pose_general_params(iters, ls, matched=True), x64, data=d64)
        torch.cuda.synchronize()
        dev_x = float((xf - res.x).abs().max()) / (1.0 + float(res.x.abs().max()))
        dev_f = float(((sf[:, 0] - res.errors.f).abs() / res.errors.f.abs().clamp_min(1e-300)).max())
        print(f"# phase27 pose N={N} float64 B={Bg}: the fused route against nls_solve on the same Problem "
              f"(matched fixed-trip budget): max |dx| / (1 + max|x|) {dev_x:.3e}, max relative cost difference "
              f"{dev_f:.3e} (bound {POSE_TOL:g})", flush=True)
        if not (dev_x < POSE_TOL and dev_f < POSE_TOL):
            fail(f"phase27 pose N={N}: the fused route is not within {POSE_TOL} of nls_solve ({dev_x}, {dev_f})")

        # Phase 28: held times, the plain version, the bound, the general twin.
        plain = functools.partial(plain_of, fam)
        k_ms, k_all = time_ms(lambda: kern(t_d, x_d), launches=10, held=True)
        k_at = {Bs: time_ms(lambda: kern(t_d[:Bs].contiguous(), x_d[:Bs].contiguous()), launches=10, held=True)[0]
                for Bs in (1, 1024)}
        e_ms, _ = time_ms(entry, launches=10)
        ed_ms, _ = time_ms(entry, launches=10, held=True)
        # Every operation of the plain version is elementwise over the
        # instances at fixed trip counts: the count on the first 256
        # instances, times B / 256, is the count at B (and a dispatch-mode
        # run at B = 8192 would take a minute at N = 40). The bound counts
        # the operations the solve needs: the plain solve with the lean
        # linearization (pose_lean_family), which must agree with the
        # generated one in float64 first; the generated plain version's
        # count is printed beside it as the emitter's overhead.
        lean = pose_lean_family(fam, edges)
        x_gen, x_lean = (plain_of(F, t_d[:64].double(), x_d[:64].double())[0] for F in (fam, lean))
        dev_lean = float((x_gen - x_lean).abs().max()) / (1.0 + float(x_gen.abs().max()))
        if not dev_lean < POSE_TOL:
            fail(f"phase28 pose N={N}: the lean linearization's solve is {dev_lean} off the generated family's")
        ops_generated = count_ops(lambda: plain(t_d[:256], x_d[:256])) * (POSE_B // 256)
        ops_lean = count_ops(lambda: plain_of(lean, t_d[:256], x_d[:256])) * (POSE_B // 256)
        ops = min(ops_generated, ops_lean)
        # Reads the 3E measurements and 3N starts, writes 3N poses and 3
        # state scalars per instance.
        bound_ms, bound_by = roofline(ops, POSE_B * (fam.data_rows + 2 * fam.n + 3) * 4)
        ones = torch.ones(len(edges), dtype=torch.float32, device="cuda")

        def problem_fn(dd, N=N, edges=edges, ones=ones):
            return pg.make_pose_graph_problem(N, edges, dd.reshape(len(edges), 3), ones, anchor_weight=100.0)

        d_g, x_g = t_d[:Bg].contiguous(), x_d[:Bg].contiguous()
        general = lambda: mot.nls_solve(problem_fn, pose_general_params(iters, ls, matched=False),  # noqa: E731
                                        x_g, data=d_g)
        general()
        torch.cuda.synchronize()
        gen_ms, gres = event_ms(general)
        f_gen = gres.errors.f.double().cpu().numpy()
        print(f"# phase28 pose N={N} B={POSE_B} float32 on {kind} ({card}) ({time.perf_counter() - t_cell:.1f} s "
              f"for the cell's phases 27-28): kernel alone {k_ms:.4f} ms "
              f"({POSE_B / k_ms * 1e3:.4e} graphs/s), at B=1 {k_at[1]:.4f} ms, at B=1024 {k_at[1024]:.4f} ms; "
              f"fused_solve_batch issued back to back {e_ms:.4f} ms/call, its device work {ed_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms at B={Bp}; {ops_generated / POSE_B:.0f} elementwise ops per instance in the generated "
              f"plain version, {ops_lean / POSE_B:.0f} with the lean linearization (its solve {dev_lean:.1e} off in "
              f"float64; the emitter's overhead {ops_generated / ops_lean - 1:+.1%}) -> bound from "
              f"{ops / POSE_B:.0f}: {bound_ms:.6f} ms ({bound_by}), kernel = {k_ms / bound_ms:.1f}x bound; general "
              f"twin make_pose_graph_problem + nls_solve at B={Bg} {gen_ms:.3f} ms/call ({Bg / gen_ms * 1e3:.4e} graphs/s, cost median "
              f"{np.median(f_gen):.4e} against the kernel's {np.median(f[:Bg]):.4e} on the same lanes), kernel "
              f"graphs/s over the twin's {(POSE_B / k_ms) / (Bg / gen_ms):.1f}x; repeats {k_all}", flush=True)
        rows.append({
            "name": f"{'fused_ik_sqp' if register else 'blocked_sqp'}_generated_pose_graph_n{N}",
            "route": "cuda",
            "source": ("mini_opt_tpu_torch/ops/fused_emit.py + csrc/"
                       + ("fused_ik_launch.cuh + csrc/fused_sqp.cuh" if register
                          else "blocked_launch.cuh + csrc/blocked_sqp.cuh")),
            "replaces": "mini_opt_tpu/ops/pallas_ik.py:323" if register else "mini_opt_tpu/ops/pallas_blocked.py:96",
            "function": ("_make_kernel" if register else "_make_blocked_kernel")
            + f" (generated SE(2) pose graph, N={N}, closures {closures})",
            "launches": launched[key],
            "max_abs_err": max(max_err.values()),
            "max_abs_diff_f64": max_err["float64"],
            "ms": k_ms,
            "plain_ms": plain_ms,
            "plain_ms_at_B": Bp,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": f"B={POSE_B} N={N} (D={fam.n}) float32 {iters}/1/{ls} mpc armijo",
            "ops_per_instance": ops / POSE_B,
            "ops_per_instance_generated_plain": ops_generated / POSE_B,
            "ms_at_B1": k_at[1],
            "ms_at_B1024": k_at[1024],
            "entry_ms": e_ms,
            "converged_share": converged,
            "f64_dev_x_vs_nls_solve": dev_x,
            "f64_dev_cost_vs_nls_solve": dev_f,
            "general_twin_ms_B512": gen_ms,
            "card": card,
        })
    return rows


# ---------------------------------------------------------------------------
# Phases 29-31: the matrix-free large-problem path (nls_solve with
# qp_solver="cg"; no kernel of its own) at the JAX repo's bench widths
# (scripts/bench_extras.py), float32 on the card, each against the port's
# float64 CPU result at the same budgets; and phase 32, kernel 2's
# generated instances with a per-variable retract.
# ---------------------------------------------------------------------------

# float32 on the card against float64 on the CPU at the same budgets,
# relative, each about 4x its largest reading (PERF.md, PR 16): f_final
# 2.8e-5 (SE(3) Jacobi; SE(2) 1.1e-7, BA 8.0e-7, SE(3) tree 3.9e-7), the
# drift 2.5e-3 (SE(3) Jacobi; SE(2) 1.6e-5, SE(3) tree 3.8e-6) and BA's
# largest landmark error 5.0e-4. The card's float32 runs differ from run
# to run (SE(3) Jacobi's drift: 2.0e-3 and 2.5e-3 in two runs).
CG_F_GATE = 1e-4  # f_final
CG_X_GATE = 1e-2  # a distance from the ground truth: the drift, BA's largest landmark error
BA_SIZE = (16, 2048)  # bundle_adjustment_bench's cameras and landmarks
# pose_graph_bench's two pipelines on the 1200-pose circle (scripts/bench_extras.py:200):
# name -> (chordal CG trips, chordal preconditioner, polish CG trips, polish preconditioner).
SE2_PIPELINES = {"jacobi": (1200, "none", 300, "jacobi"), "tree": (200, "tree", 100, "tree")}
# pose_graph3_bench's (:367): the hard anchor under Jacobi, and the tree.
SE3_PIPELINES = {"jacobi": (300, "none", 150, "jacobi"), "tree": (80, "tree", 50, "tree")}


def device_ops(fn):
    """Device operations of one call of fn: the nodes of one call captured
    in a CUDA graph (graph_nodes), exact. Fails if the call does not
    capture (a copy from the host inside it, say): the profiler's count of
    a CG step's tens of thousands of operations took minutes on the card."""
    try:
        return sum(graph_nodes(fn).values())
    except RuntimeError as e:
        fail(f"one CG step did not capture in a CUDA graph: {e}")


def wall_s(fn):
    """(seconds, result) of one call of fn on the host's clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def cg_step_profile(problem, x, diag_fn=None, prec_fn=None, trips=(1, 3, 11)):
    """One Gauss-Newton step of the CG path (``_cg_step_direction`` on one
    lane, as nls_solve runs a single instance) at the iterate x (n,): device
    operations a CG trip and outside the trips (graph counts at 1 and 3
    trips), ms a trip (host clock, 11 trips less 1, median of 3, the
    preconditioner factored once beforehand so that its time does not
    enter), and the preconditioner factory's ms with one apply."""
    from mini_opt_tpu_torch.nonlinear import NLSParams, _cg_step_direction

    lam = torch.full((), 1e-4, dtype=x.dtype, device=x.device)

    def step(k, prec=prec_fn):
        params = NLSParams(qp_solver="cg", cg_iterations=k)
        return _cg_step_direction(problem, x, lam, params, diag_fn, None, None, prec)[0]

    ops = {k: device_ops(lambda k=k: step(k)) for k in trips[:2]}
    per_trip = (ops[trips[1]] - ops[trips[0]]) / (trips[1] - trips[0])
    factored = None if prec_fn is None else prec_fn(x, lam)
    once = None if prec_fn is None else (lambda xx, ll: factored)
    times = {k: float(np.median([wall_s(lambda k=k: step(k, once))[0] for _ in range(3)]))
             for k in (trips[0], trips[2])}
    out = dict(ops_per_trip=per_trip, ops_outside_trips=ops[trips[0]] - per_trip * trips[0],
               ms_per_trip=(times[trips[2]] - times[trips[0]]) / (trips[2] - trips[0]) * 1e3)
    if prec_fn is not None:
        out["factor_ms"] = float(np.median([wall_s(lambda: prec_fn(x, lam)(x))[0] for _ in range(3)])) * 1e3
    return out


def device_bytes(fn):
    """(device bytes fn allocates at its peak beyond what was allocated
    before it, its result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def rel_diff(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def se2_pipeline(graph, pre, device, dtype):
    """pose_graph_bench's pipeline: chordal_initialization, then 3 Gauss-Newton
    iterations of solve_pose_graph_large, at the pipeline's CG budgets."""
    n, edges, meas, x0 = graph
    c_trips, c_pre, g_trips, g_pre = SE2_PIPELINES[pre]
    m = torch.as_tensor(meas, dtype=dtype, device=device)
    w = torch.ones(len(edges), dtype=dtype, device=device)
    anchor = torch.as_tensor(x0[0], dtype=dtype, device=device)
    xc = pg.chordal_initialization(n, edges, m, w, anchor_pose=anchor, cg_iterations=c_trips, preconditioner=c_pre)
    return pg.solve_pose_graph_large(n, edges, m, w, xc, params=pg.default_pose_graph_params(dtype, 3),
                                     cg_iterations=g_trips, preconditioner=g_pre)


def se3_pipeline(graph, pre, device, dtype):
    """pose_graph3_bench's pipelines: chordal_initialization3, then 3
    Gauss-Newton iterations (Jacobi with the hard anchor, or the tree)."""
    from mini_opt_tpu_torch.models import pose_graph3 as pg3

    n, edges, meas, x0 = graph
    c_trips, c_pre, g_trips, g_pre = SE3_PIPELINES[pre]
    m = torch.as_tensor(meas, dtype=dtype, device=device)
    w = torch.ones(len(edges), dtype=dtype, device=device)
    anchor = torch.as_tensor(x0[0], dtype=dtype, device=device)
    xc = pg3.chordal_initialization3(n, edges, m, w, anchor_pose=anchor, cg_iterations=c_trips,
                                     preconditioner=c_pre)
    return pg3.solve_pose_graph3_large(n, edges, m, w, xc, params=pg3.default_pose_graph3_params(dtype, 3),
                                       cg_iterations=g_trips, preconditioner=g_pre, hard_anchor=pre == "jacobi")


def ba_scene(C, L, k=None):
    """bundle_adjustment_bench's scene and start (:1472; :1552 with k)."""
    from mini_opt_tpu_torch.models import bundle_adjustment as ba

    obs, uv, x_true, scale_ref = ba.make_synthetic_scene(C, L, pixel_noise=1e-3, cameras_per_landmark=k,
                                                         device="cpu")
    rng = np.random.default_rng(1 if k is None else 2)
    x0 = x_true.numpy().copy()
    x0[6:6 * C] += rng.normal(0, 0.01, 6 * (C - 1))
    x0[6 * C:] += rng.normal(0, 0.03, len(x0) - 6 * C)
    return obs, uv.numpy(), x_true.numpy(), scale_ref, x0


def ba_solve(scene, C, L, device, dtype, sparse=False):
    """The bench's exact-Schur CG solve: 20 Gauss-Newton iterations of 2 CG
    trips, the bench's exit tolerances."""
    from mini_opt_tpu_torch.models import bundle_adjustment as ba

    obs, uv, _, scale_ref, x0 = scene
    uv_t = torch.as_tensor(uv, dtype=dtype, device=device)
    x0_t = torch.as_tensor(x0, dtype=dtype, device=device)
    params = dataclasses.replace(ba.default_ba_params(dtype, 20), absolute_exit_tol=1e-8, relative_exit_tol=1e-6,
                                 qp_solver="cg", cg_iterations=2)
    problem = ba.make_ba_problem(C, L, obs, uv_t, scale_ref=scale_ref, anchor_ref=x0_t[0:6])
    make = ba.make_ba_schur_preconditioner_sparse if sparse else ba.make_ba_schur_preconditioner
    res = mot.nls_solve(problem, params, x0_t[None], retraction=ba.make_ba_retraction(C),
                        cg_preconditioner=make(C, L, obs, uv_t))
    return res, problem, make(C, L, obs, uv_t)


def drift(x, gt, d):
    return float(np.abs(np.asarray(x, dtype=np.float64).reshape(-1, gt.shape[1]) - gt)[:, :d].max())


def cg_report(tag, card, **row):
    print(f"# {tag} on {card}: " + json.dumps(row), flush=True)


def cg_reference(path, pre):
    """A worker's job: one of phases 29-31's float64 CPU references at the
    card's budgets: (seconds, f_final, the drift from the ground truth or
    BA's largest landmark error)."""
    from mini_opt_tpu_torch.instances import circle_graph, helix_graph

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    if path == "se2":
        gt, edges, meas, x0 = circle_graph(1200, seed=1, noise=0.01, loop_every=10)
        ref = se2_pipeline((1200, edges, meas, x0), pre, "cpu", torch.float64)
        return time.perf_counter() - t0, float(ref.errors.f), drift(ref.x, gt, 2)
    if path == "se3":
        gt, edges, meas, x0 = helix_graph(400, seed=4, noise=0.01, loop_every=10)
        ref = se3_pipeline((400, edges, meas, x0), pre, "cpu", torch.float64)
        return time.perf_counter() - t0, float(ref.errors.f), drift(ref.x, gt, 3)
    C, L = BA_SIZE
    scene = ba_scene(C, L)
    ref, _, _ = ba_solve(scene, C, L, "cpu", torch.float64)
    x_true = scene[2]
    return (time.perf_counter() - t0, float(ref.errors.f[0]),
            float(np.abs(ref.x[0].numpy()[6 * C:] - x_true[6 * C:]).max()))


def cg_references(pool):
    """Start phases 29-31's CPU references in the workers: {(path, pre):
    async result}."""
    jobs = [("se2", pre) for pre in SE2_PIPELINES] + [("ba", None)] + [("se3", pre) for pre in SE3_PIPELINES]
    return {job: pool.apply_async(cg_reference, job) for job in jobs}


def se2_path(card, graph, gt, refs):
    """Phase 29: the 1200-pose SE(2) pipelines, Jacobi and tree."""
    n, edges, meas, x0 = graph
    drift0 = drift(x0, gt, 2)
    for pre in SE2_PIPELINES:
        peak, (secs, res) = device_bytes(lambda: wall_s(lambda: se2_pipeline(graph, pre, "cuda", torch.float32)))
        if res.x.dtype != torch.float32 or not res.x.is_cuda or not torch.isfinite(res.x).all():
            fail(f"phase29 {pre}: {res.x.dtype} {res.x.device}, finite {bool(torch.isfinite(res.x).all())}")
        cpu_s, f64, d64 = refs[("se2", pre)].get()
        f32 = float(res.errors.f)
        d_after = drift(res.x.cpu(), gt, 2)
        m = torch.as_tensor(meas, dtype=torch.float32, device="cuda")
        w = torch.ones(len(edges), dtype=torch.float32, device="cuda")
        problem = pg.make_pose_graph_problem(n, edges, m, w)
        kw = (dict(prec_fn=pg.make_tree_preconditioner(n, edges, m, w)) if pre == "tree"
              else dict(diag_fn=pg.make_jacobi_preconditioner(edges, m, w)))
        prof = cg_step_profile(problem, res.x, **kw)
        c_trips, _, g_trips, _ = SE2_PIPELINES[pre]
        cg_report(f"phase29 SE(2) {n} poses, {pre}", card, wall_s=secs, cpu_float64_s=cpu_s, peak_bytes=peak,
                  f_final=f32, f_final_cpu_float64=f64, rel_diff=rel_diff(f32, f64), drift_before=drift0,
                  drift_after=d_after, drift_after_cpu_float64=d64, drift_rel_diff=rel_diff(d_after, d64),
                  gn_iterations=int(res.num_iterations), status=int(res.termination_state),
                  cg_trips=f"chordal {c_trips} x 2 stages, polish {g_trips} x 3", **prof)
        if rel_diff(f32, f64) > CG_F_GATE or rel_diff(d_after, d64) > CG_X_GATE or not d_after < drift0:
            fail(f"phase29 {pre}: f_final {f32} against {f64} in float64 on the CPU, drift {drift0} -> {d_after} "
                 f"({d64} in float64)")


def ba_path(card, refs):
    """Phase 30: bundle_adjustment_bench's dense-Schur solve, C = 16, L = 2048."""
    C, L = BA_SIZE
    scene = ba_scene(C, L)
    x_true = scene[2]
    peak, (secs, (res, problem, prec)) = device_bytes(lambda: wall_s(lambda: ba_solve(scene, C, L, "cuda",
                                                                                      torch.float32)))
    cpu_s, f64, lm64 = refs[("ba", None)].get()
    x = res.x[0].double().cpu().numpy()
    lm = float(np.abs(x[6 * C:] - x_true[6 * C:]).max())
    f32 = float(res.errors.f[0])
    prof = cg_step_profile(problem, res.x[0], prec_fn=prec, trips=(1, 2, 11))
    cg_report(f"phase30 BA dense Schur C={C} L={L}", card, wall_s=secs, cpu_float64_s=cpu_s, peak_bytes=peak,
              f_final=f32, f_final_cpu_float64=f64, rel_diff=rel_diff(f32, f64), max_landmark_err=lm,
              max_landmark_err_cpu_float64=lm64, landmark_err_rel_diff=rel_diff(lm, lm64), gn_iterations=int(res.num_iterations[0]), status=int(res.termination_state[0]), **prof)
    if res.x.dtype != torch.float32 or not torch.isfinite(res.x).all():
        fail("phase30: not a finite float32 result")
    if rel_diff(f32, f64) > CG_F_GATE or rel_diff(lm, lm64) > CG_X_GATE:
        fail(f"phase30: f_final {f32} / {f64}, max landmark error {lm} / {lm64} (float32 card / float64 CPU)")


def se3_path(card, refs):
    """Phase 31: pose_graph3_bench's 400-pose helix, Jacobi (hard anchor) and
    tree, against the float64 CPU result at the same budgets, as phase 29."""
    from mini_opt_tpu_torch.instances import helix_graph
    from mini_opt_tpu_torch.models import pose_graph3 as pg3

    gt, edges, meas, x0 = helix_graph(400, seed=4, noise=0.01, loop_every=10)
    graph = (400, edges, meas, x0)
    for pre in SE3_PIPELINES:
        peak, (secs, res) = device_bytes(lambda: wall_s(lambda: se3_pipeline(graph, pre, "cuda", torch.float32)))
        cpu_s, f64, d64 = refs[("se3", pre)].get()
        f_start, f_final = float(res.iterations.errors_initial.f[0]), float(res.errors.f)
        d_after = drift(res.x.cpu(), gt, 3)
        m = torch.as_tensor(meas, dtype=torch.float32, device="cuda")
        w = torch.ones(len(edges), dtype=torch.float32, device="cuda")
        problem = pg3.make_pose_graph3_problem(400, edges, m, w, hard_anchor=pre == "jacobi")
        kw = (dict(prec_fn=pg3.make_tree_preconditioner3(400, edges, m, w)) if pre == "tree"
              else dict(diag_fn=pg3.make_jacobi_preconditioner3(edges, m, w, anchor_weight=0.0)))
        prof = cg_step_profile(problem, res.x, **kw)
        cg_report(f"phase31 SE(3) 400 poses, {pre}", card, wall_s=secs, cpu_float64_s=cpu_s, peak_bytes=peak,
                  f_chordal_start=f_start, f_final=f_final, f_final_cpu_float64=f64, rel_diff=rel_diff(f_final, f64),
                  drift_before=drift(x0, gt, 3), drift_after=d_after, drift_after_cpu_float64=d64,
                  drift_rel_diff=rel_diff(d_after, d64), gauge_residual=float(res.x[:6].abs().max()), gn_iterations=int(res.num_iterations),
                  status=int(res.termination_state), **prof)
        if res.x.dtype != torch.float32 or not torch.isfinite(res.x).all() or not f_final <= f_start:
            fail(f"phase31 {pre}: {res.x.dtype}, finite {bool(torch.isfinite(res.x).all())}, f {f_start} -> "
                 f"{f_final}")
        if rel_diff(f_final, f64) > CG_F_GATE or rel_diff(d_after, d64) > CG_X_GATE:
            fail(f"phase31 {pre}: f_final {f_final} against {f64} in float64 on the CPU, drift {d_after} against "
                 f"{d64}")


def cg_paths(card, pool):
    """Phases 29-31, their float64 CPU references in the workers beside the
    card's runs."""
    from mini_opt_tpu_torch.instances import circle_graph

    refs = cg_references(pool)
    gt, edges, meas, x0 = circle_graph(1200, seed=1, noise=0.01, loop_every=10)
    se2_path(card, (1200, edges, meas, x0), gt, refs)
    CLOCK.mark("phase 29")
    ba_path(card, refs)
    CLOCK.mark("phase 30")
    se3_path(card, refs)
    CLOCK.mark("phase 31")


# Phase 32: the generated planar family with the _mod_pi retraction past
# D = 32, on kernel 2 (ROADMAP item 16a). Its blocked target's traces take
# minutes of Python, so worker processes trace them from the start of the
# run (retract_traces), beside the other phases.
RETRACT_NS = (33, 48)


def retract_family(n):
    """bench.py's default family at n joints: scalar_planar_ik_builder with
    the _mod_pi retraction of every joint."""
    return mot.family_from_problem(scalar_planar_ik_builder(n, LINK), 2, retract=_wrap)


def trace_retract_family(n, dtype_name):
    """A worker's job: the blocked target's traces of retract_family(n)."""
    return retract_family(n).cuda_program.blocked_traces(getattr(torch, dtype_name))


def retract_traces(pool):
    """Start the traces: {(n, dtype name): async result}."""
    return {(n, dt): pool.apply_async(trace_retract_family, (n, dt))
            for n in RETRACT_NS for dt in ("float64", "float32")}


class RetractBuild(threading.Thread):
    """Phase 32's set-up beside the other phases: waits for the workers'
    traces, emits each family's kernel-2 source and builds them (one nvcc
    each, outside the GIL)."""

    def __init__(self, jobs):
        super().__init__(daemon=True)
        self.jobs, self.result, self.error = jobs, None, None

    def run(self):
        try:
            t0 = time.perf_counter()
            fams = {}
            for n in RETRACT_NS:
                fams[n] = retract_family(n)
                for dt in ("float64", "float32"):
                    fams[n].cuda_program.adopt_blocked_traces(getattr(torch, dt), self.jobs[(n, dt)].get())
            traced = time.perf_counter() - t0
            t1 = time.perf_counter()
            paths = _build.build_generated([f.cuda_program.blocked_source() for f in fams.values()])
            self.result = (fams, traced, time.perf_counter() - t1, paths)
        except Exception as e:  # noqa: BLE001 -- handed to the main thread, which fails the run
            self.error = e


def retract_paths(builder, max_err, wait_s=900):
    """Phase 32: each family's kernel 2 instance, emitted from the workers'
    traces and built beside the other phases (RetractBuild), against its
    plain version bit for bit in both types at the arm's budget (6/3/2
    Mehrotra + Armijo), B = 2048 + 7 with a NaN-target lane."""
    t0 = time.perf_counter()
    builder.join(wait_s)
    if builder.is_alive() or builder.error is not None:
        fail(f"phase32: the retract families' traces and build did not finish ({builder.error!r})")
    fams, traced, build_s, paths = builder.result
    print(f"# phase32 traces ready {traced:.1f} s after the run began (4 worker processes); kernel-2 instances "
          f"emitted and built in {build_s:.1f} s ({[p.name for p in paths]}), beside phases 2-31; this phase "
          f"waited {time.perf_counter() - t0:.1f} s for them", flush=True)
    for path in paths:
        log = path.with_suffix(".log")
        for kname, nreg, spill, _, stack in ptxas_report(log.read_text() if log.exists() else ""):
            print(f"# phase32 ptxas {path.name} {kname[:60]}: {nreg} registers, {spill} bytes spill stores, {stack} "
                  "bytes stack frame", flush=True)
    B = 2048 + 7
    plain = {}
    for n, fam in fams.items():
        progs = fam.cuda_program.blocked_retract(torch.float32)
        print(f"# phase32 planar n={n} (D={n + 1}): {len(set(progs))} distinct retract program(s) over {n} "
              f"variables, {sum(s.op != 'in' for s in progs[0].stmts)} statements each", flush=True)
        # float64 at the first n only (slice 16 cut the script's depth: a
        # plain blocked call costs its operations, ~25 s at n = 48).
        for dtype in (torch.float64, torch.float32) if n == RETRACT_NS[0] else (torch.float32,):
            data, x0 = medium_n_planar_instances(B, n, seed=n)
            x0 = x0 + np.where(np.arange(n) % 2, 2 * np.pi, 0.0)  # a turn away: the retract's floor
            data[5, 0] = np.nan
            data_t, x0_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            args = (fam, data_t, x0_t, ARM["max_iterations"], ARM["qp_iterations"], ARM["ls_iterations"],
                    ARM["line_search"], ARM["barrier"])
            before = blk.GENERATED_LAUNCHES
            got = blk._blocked_solve_cuda(*args)
            torch.cuda.synchronize()
            if blk.GENERATED_LAUNCHES != before + 1:
                fail(f"phase32 n={n}: the generated kernel 2 wrapper did not count its launch")
            want = blk._blocked_solve_plain(*args)
            torch.cuda.synchronize()
            check_blocked(f"phase32 generated planar n={n} with _mod_pi, 6/3/2 mpc armijo B={B}", got, want,
                          max_err, (5,))
            plain[(n, dtype)] = want
    n = RETRACT_NS[0]
    return retract_entry(fams[n], n, B, plain[(n, torch.float32)])


def retract_entry(fam, n, B, want):
    """Phase 32's main path: bench.py's route, Problem -> family_from_problem
    -> fused_solve_batch, at n joints (D = n + 1 > 32: the blocked tier) in
    float32 at the arm's budget: one generated kernel 2 launch and no other,
    bit for bit against the plain blocked version (``want``, phase 32's
    float32 run on the same inputs), one device kernel a call. Returns the
    launches of the counted run."""
    data, x0 = medium_n_planar_instances(B, n, seed=n)
    x0 = x0 + np.where(np.arange(n) % 2, 2 * np.pi, 0.0)
    data[5, 0] = np.nan
    d32, x32 = data.astype(np.float32), x0.astype(np.float32)
    reset_counts()
    x, state = mot.fused_solve_batch(fam, d32, x32, return_state=True, **ARM)
    torch.cuda.synchronize()
    launched = counts()
    if launched["blocked_generated"] != 1 or any(v for k, v in launched.items() if k != "blocked_generated"):
        fail(f"phase32 n={n}: fused_solve_batch launched {launched}, not one generated kernel 2")
    t_d, x_d = (torch.as_tensor(a, device="cuda") for a in (d32, x32))
    xp, sp = want
    same = bit_identical((x, xp.T), (state, sp.T))
    print(f"# phase32 generated planar n={n} fused_solve_batch B={B} float32 6/3/2 mpc armijo: launches {launched} "
          f"for 1 call; bit-identical to the plain blocked version {same}; lane 5 (NaN target) flagged "
          f"{bool(state[5, 2] != 0)}", flush=True)
    if x.shape != (B, n) or state.shape != (B, 3) or not same or not bool(state[5, 2] != 0):
        fail(f"phase32 n={n}: fused_solve_batch gave {tuple(x.shape)} {tuple(state.shape)}, bit-identical {same}")
    kernels_a_call(f"phase32 n={n} fused_solve_batch B={B} float32 on card tensors",
                   lambda: mot.fused_solve_batch(fam, t_d, x_d, **ARM), (r"blocked_sqp_kernel",), reps=4)
    return launched["blocked_generated"]


# ---------------------------------------------------------------------------
# Phases 33-35: nonlinear inequalities (ineq.py), implicit gradients
# (implicit.py and the implicit MPC policy) and the serving-budget tuner
# (tuning.py), on kernels 4 and 5 (the general path, kkt_solver=
# "pallas_ldlt") and kernels 1, 2, 7, 8 and 9 (the tuner's families). The
# port's float64 CPU references run in phase 32's worker processes beside
# the card's runs.
# ---------------------------------------------------------------------------

OBSTACLE_B = 8192
OBSTACLE_REF_LANES = 64  # the card against the port's float64 CPU result on these lanes
OBSTACLE_TOL = 1e-8  # x and slacks, card against CPU, float64
# The JAX package's share of examples/obstacle_ik.py's asserts passed, float64
# on the CPU, on the first 256 lanes of obstacle_ik_targets(8192, seed=0), each
# lane's keep-out centre the elbow of its base solve: 256 of 256 (PERF.md
# §6). The card's share on those lanes must reach it.
OBSTACLE_JAX_SHARE = 1.0
OBSTACLE_GATE_LANES = 256
LIMIT_B = 8192
JOINT_LIMIT = 1.2  # tests/test_implicit.py::test_implicit_ik_joint_limit_matches_unrolled
LIMIT_X0 = (0.7, 1.1)
IMPLICIT_TOL = 1e-8  # x and dx*/dtarget on the first lanes, card against CPU, relative
PIN_TOL = 1e-4  # the pinned joint's row of dx*/dtarget at the limit
GAIN_T, GAIN_DT, GAIN_B = 20, 0.05, 1024  # the bench horizon; a fleet of plant states near upright
GAIN_REF_LANES = (0, 1, GAIN_B // 2, GAIN_B - 1)  # fleet lanes against one-state CPU calls, IMPLICIT_TOL
TUNER_B, TUNER_MPC_B = 8192, 1024  # scripts/tune_budgets.py's widths
# tuned budgets that STATUS.md records from the JAX package's TPU runs
# (scripts/tune_budgets.py): context only, never the card's.
TPU_STATUS_BUDGETS = {"planar_ik": (4, 1, 1), "spatial_ik": (7, 1, 2), "pose_graph_n4": (2, 1, 0),
                      "pose_ring_n16": (2, 1, 0), "mpc_servo_T20": (1, 1, 0), "arm_n48": None}


def obstacle_lifted(rows, params):
    """The lifted fleet: each lane's start is the example's x_ref with its
    slack, through nls_solve on the per-lane wrapper function."""
    from mini_opt_tpu_torch.instances import OBSTACLE_X_REF, obstacle_ik_problem
    from mini_opt_tpu_torch.models.ik import mod_pi_retraction

    x_ref = torch.as_tensor(OBSTACLE_X_REF, dtype=rows.dtype, device=rows.device).expand(rows.shape[0], 3)
    x0 = torch.func.vmap(lambda r, x: obstacle_ik_problem(r).initial_guess(x))(rows, x_ref)
    return mot.nls_solve(obstacle_ik_problem, params, x0, retraction=mod_pi_retraction, data=rows)


def obstacle_reference(rows):
    """A worker's job: the lifted solve of ``rows`` in float64 on the CPU."""
    from mini_opt_tpu_torch.instances import obstacle_ik_params

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = obstacle_lifted(torch.as_tensor(rows), obstacle_ik_params("pallas_ldlt"))
    return res.x.numpy(), res.termination_state.numpy(), time.perf_counter() - t0


def limit_instances(B, seed=0):
    """Targets at distance 0.45-0.78 from the base, so that the closest
    reachable configuration pins the elbow at 1.2 rad on part of the lanes
    (closer than 0.660), and a common start (0.7, 1.1)."""
    rng = np.random.default_rng(seed)
    r, a = rng.uniform(0.45, 0.78, B), rng.uniform(-0.4, 1.2, B)
    return np.stack([r * np.cos(a), r * np.sin(a)], 1), np.tile(LIMIT_X0, (B, 1))


def limit_solver(device):
    from mini_opt_tpu_torch.models.ik import default_ik_params, make_ik_problem, mod_pi_retraction

    chain = mot.make_planar_chain(2, LINK, dtype=torch.float64, device=device)
    params = dataclasses.replace(default_ik_params(torch.float64, max_iterations=25, max_qp_iterations=10),
                                 absolute_exit_tol=1e-14, termination_kkt_tolerance=1e-10,
                                 kkt_solver="pallas_ldlt")
    return mot.make_implicit_solver(lambda t: make_ik_problem(chain, t, with_joint_limits=True,
                                                              joint_limit=JOINT_LIMIT),
                                    params, retraction=mod_pi_retraction, active_tol=1e-6)


def limit_jacobian(solve, targets, x0):
    """x* (B, 2) and dx*/dtarget (B, 2, 2), one backward pass per row."""
    t = targets.detach().requires_grad_(True)
    x = solve(t, x0)
    rows = [torch.autograd.grad(x[:, i].sum(), t, retain_graph=i == 0)[0] for i in range(2)]
    return x.detach(), torch.stack(rows, 1)


def limit_reference(targets, x0):
    """A worker's job: x* and dx*/dtarget of the joint-limit fleet in float64
    on the CPU."""
    torch.set_num_threads(1)
    x, J = limit_jacobian(limit_solver("cpu"), torch.as_tensor(targets), torch.as_tensor(x0))
    return x.numpy(), J.numpy()


def gain_states():
    """Phase 34b's fleet: plant states within 0.05 of upright."""
    return np.random.default_rng(3).uniform(-0.05, 0.05, (GAIN_B, 4))


def gain_reference(lane):
    """A worker's job: mpc_feedback_gain of one fleet lane's state, alone,
    in float64 on the CPU."""
    torch.set_num_threads(1)
    state = torch.as_tensor(gain_states()[lane])
    return mpcm.mpc_feedback_gain(mpcm.CartPole(), state, GAIN_T, GAIN_DT).numpy()


def scaled_max_dev(a, b):
    """max |a - b| / (1 + max |b|) over arrays (rel_diff is |a - b| / |b| of
    two scalars)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def obstacle_path(card, kind, pool):
    """Phase 33: examples/obstacle_ik.py's lifted problem as a fleet at
    B = 8192 in float64 on kernels 4 and 5."""
    from mini_opt_tpu_torch.instances import (OBSTACLE_X_REF, obstacle_ik_base_problem, obstacle_ik_checks,
                                              obstacle_ik_params, obstacle_ik_rows, obstacle_ik_targets)
    from mini_opt_tpu_torch.models.ik import mod_pi_retraction

    B = OBSTACLE_B
    params = obstacle_ik_params("pallas_ldlt")
    targets = torch.as_tensor(obstacle_ik_targets(B, seed=0), device="cuda")
    x_ref = torch.as_tensor(OBSTACLE_X_REF, dtype=torch.float64, device="cuda").expand(B, 3)
    base_s, base = wall_s(lambda: mot.nls_solve(obstacle_ik_base_problem, params, x_ref,
                                                retraction=mod_pi_retraction, data=targets))
    rows = obstacle_ik_rows(targets, base.x)
    ref = pool.apply_async(obstacle_reference, (rows[:OBSTACLE_REF_LANES].cpu().numpy(),))
    reset_counts()
    lifted_s, res = wall_s(lambda: obstacle_lifted(rows, params))
    launched = counts()
    if launched["ldlt_factor"] < 1 or launched["ldlt_solve"] < 1:
        fail(f"phase33: the lifted fleet launched kernels 4 and 5 {launched}")
    x = res.x.cpu().numpy()
    rows_np = rows.cpu().numpy()
    checks, g = obstacle_ik_checks(x, rows_np)
    ok = np.logical_and.reduce(checks)
    share, share_gate = float(ok.mean()), float(ok[:OBSTACLE_GATE_LANES].mean())
    active = float((np.abs(g) < 1e-6).mean())
    term = res.termination_state.cpu().numpy()
    x_cpu, term_cpu, cpu_s = ref.get()
    dev = float(np.abs(x[:OBSTACLE_REF_LANES] - x_cpu).max())
    same_term = bool((term[:OBSTACLE_REF_LANES] == term_cpu).all())
    print(f"# phase33 obstacle IK (examples/obstacle_ik.py) fleet B={B} float64 kkt_solver=pallas_ldlt on {kind} "
          f"({card}): base solve (no keep-out) {base_s:.2f} s, lifted solve {lifted_s:.2f} s (nls_solve on the "
          f"per-lane wrapper; launches {launched}); asserts passed: effector x {checks[0].mean():.6f}, y "
          f"{checks[1].mean():.6f}, g >= -1e-6 {checks[2].mean():.6f}, elbow outside {checks[3].mean():.6f}; keep-out "
          f"active (|g| < 1e-6) {active:.6f}; share {share:.6f}, on the first "
          f"{OBSTACLE_GATE_LANES} lanes {share_gate:.6f} (the JAX package's {OBSTACLE_JAX_SHARE:.6f}); termination "
          f"states {dict(zip(*np.unique(term, return_counts=True)))}; iterations max "
          f"{int(res.num_iterations.max())}; the first {OBSTACLE_REF_LANES} lanes against the port's float64 CPU "
          f"result ({cpu_s:.1f} s in a worker): max |dx| {dev:.3e} (bound {OBSTACLE_TOL:g}), termination states "
          f"equal {same_term}", flush=True)
    if share_gate < OBSTACLE_JAX_SHARE or not dev <= OBSTACLE_TOL or not same_term or not np.isfinite(x).all():
        fail(f"phase33: share {share_gate} on the first {OBSTACLE_GATE_LANES} lanes (JAX {OBSTACLE_JAX_SHARE}), "
             f"card against CPU {dev}, termination states equal {same_term}")
    return launched


def implicit_path(card, kind, pool):
    """Phase 34: implicit gradients on the card: (a) the 2-link IK fleet with
    an active joint limit, dx*/dtarget per lane; (b) the MPC policy's
    feedback gain at the cart-pole's upright equilibrium against the LQR
    gain, then over a fleet of plant states."""
    targets_np, x0_np = limit_instances(LIMIT_B, seed=0)
    lanes = OBSTACLE_REF_LANES
    ref = pool.apply_async(limit_reference, (targets_np[:lanes], x0_np[:lanes]))
    gain_ref = pool.map_async(gain_reference, GAIN_REF_LANES)
    solve = limit_solver("cuda")
    targets, x0 = (torch.as_tensor(a, device="cuda") for a in (targets_np, x0_np))
    reset_counts()
    x, J = limit_jacobian(solve, targets, x0)
    torch.cuda.synchronize()
    launched = counts()
    if launched["ldlt_factor"] < 1 or launched["ldlt_solve"] < 1:
        fail(f"phase34: the implicit forward solve launched kernels 4 and 5 {launched}")
    t = targets.detach().requires_grad_(True)
    fwd_ms, xt = event_ms(lambda: solve(t, x0))
    w = torch.zeros_like(xt)
    w[:, 1] = 1.0
    backward = lambda: torch.autograd.grad(xt, t, grad_outputs=w, retain_graph=True)  # noqa: E731
    bwd_ms, _ = event_ms(backward)
    _, busy_ms, n_kernels, _ = profile_call(backward, sessions=1)
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
    x_np, J_np = x.cpu().numpy(), J.cpu().numpy()
    pinned = np.abs(x_np[:, 1] - JOINT_LIMIT) < 1e-6
    pin_row = float(np.abs(J_np[pinned, 1, :]).max()) if pinned.any() else 0.0
    x_cpu, J_cpu = ref.get()
    dev_x, dev_J = scaled_max_dev(x_np[:lanes], x_cpu), scaled_max_dev(J_np[:lanes], J_cpu)
    print(f"# phase34a implicit dx*/dtarget, 2-link IK, joint limit {JOINT_LIMIT}, B={LIMIT_B} float64 "
          f"kkt_solver=pallas_ldlt on {kind} ({card}): lanes at the limit {pinned.mean():.6f}, their pinned row max "
          f"|dx1/dt| {pin_row:.3e} (bound {PIN_TOL:g}); forward {fwd_ms:.1f} ms (launches {launched} for a forward "
          f"and two backward passes), backward {bwd_ms:.1f} ms a pass, its device kernels recorded by "
          f"torch.profiler (a lower bound) {n_kernels} (busy {busy}); the first {lanes} lanes against the port's "
          f"float64 CPU result: x {dev_x:.3e}, J {dev_J:.3e} (bound {IMPLICIT_TOL:g}, relative); finite "
          f"{bool(np.isfinite(J_np).all())}", flush=True)
    if not pinned.any() or pinned.all() or pin_row > PIN_TOL or not dev_x <= IMPLICIT_TOL \
            or not dev_J <= IMPLICIT_TOL or not np.isfinite(J_np).all():
        fail(f"phase34a: pinned share {pinned.mean()}, pinned row {pin_row}, card against CPU x {dev_x} J {dev_J}")

    cp = mpcm.CartPole()
    gain_s, gain = wall_s(lambda: mpcm.mpc_feedback_gain(cp, torch.zeros(4, dtype=torch.float64, device="cuda"),
                                                         GAIN_T, GAIN_DT))
    K0 = -mpcm.finite_horizon_lqr_gain(cp, GAIN_T, GAIN_DT)[0].numpy()
    g = gain.cpu().numpy()
    close = bool(np.all(np.abs(g - K0) <= 1e-8 + 1e-6 * np.abs(K0)))
    fleet_s, fleet = wall_s(lambda: mpcm.mpc_feedback_gain(cp, torch.as_tensor(gain_states(), device="cuda"),
                                                           GAIN_T, GAIN_DT))
    fg = fleet.cpu().numpy()
    dev_gain = scaled_max_dev(fg[list(GAIN_REF_LANES)], np.stack(gain_ref.get()))
    print(f"# phase34b mpc_feedback_gain cart-pole T={GAIN_T} dt={GAIN_DT} float64 on {kind} ({card}): at the "
          f"upright equilibrium {g.tolist()} against -K_0 {K0.tolist()}: max |diff| {np.abs(g - K0).max():.3e} "
          f"(rtol 1e-6, atol 1e-8: {close}), {gain_s:.2f} s; the fleet of B={GAIN_B} states within 0.05 of it "
          f"{fleet_s:.2f} s (one backward pass), gain spread {np.abs(fg - K0).max():.3e}, finite "
          f"{bool(np.isfinite(fg).all())}; lanes {list(GAIN_REF_LANES)} against one-state float64 CPU calls "
          f"{dev_gain:.3e} (bound {IMPLICIT_TOL:g}, relative)", flush=True)
    if not close or fleet.shape != (GAIN_B, 4) or not np.isfinite(fg).all() or not dev_gain <= IMPLICIT_TOL:
        fail(f"phase34b: gain {g} against -K_0 {K0}, fleet {tuple(fleet.shape)}, lanes against CPU {dev_gain}")
    return launched, dict(forward_ms=fwd_ms, backward_ms=bwd_ms, backward_device_kernels=n_kernels,
                          gain_s=gain_s, gain_fleet_s=fleet_s)


def tuner_families(families, poses):
    """Phase 35's families, as scripts/tune_budgets.py tunes them: name ->
    (solve(outer, qp, ls), gate, max_budget, counter keys)."""
    from mini_opt_tpu_torch.tuning import parity_gate

    out = {}
    # planar: bench.py's default generated route, every lane within 1e-3.
    fam = families["planar n=2"][0]
    targets, x0 = planar_instances(TUNER_B, 2, seed=3)
    t_d, x_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (targets, x0))
    out["planar_ik"] = (
        lambda o, q, l: mot.fused_solve_batch(fam, t_d, x_d, max_iterations=o, qp_iterations=q, ls_iterations=l),
        parity_gate(1e-3, frac=1.0, metric=lambda sol, ref: effector_error("planar", sol.cpu(), targets)),
        (10, 6, 2), ("fused_ik_generated",))
    # spatial n = 3 on the hand-written family, 99.8% within 1e-3.
    st, sx = spatial_instances(TUNER_B, 3, seed=0)
    st_d, sx_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (st, sx))
    out["spatial_ik"] = (
        lambda o, q, l: mot.fused_spatial_ik_solve_batch(st_d, sx_d, max_iterations=o, qp_iterations=q,
                                                         ls_iterations=l),
        parity_gate(1e-3, frac=0.998, metric=lambda sol, ref: effector_error("spatial", sol.cpu(), st)),
        (12, 6, 2), ("fused_ik",))
    # the generated pose ring N = 4, every lane's terminal cost below 1e-2.
    pfam = poses[4][0]
    pd, px = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in ring_instances(TUNER_B, 4, seed=0))
    out["pose_graph_n4"] = (
        lambda o, q, l: mot.fused_solve_batch(pfam, pd, px, max_iterations=o, qp_iterations=q, ls_iterations=l,
                                              return_state=True)[1][:, 0],
        parity_gate(1e-2, frac=1.0, metric=lambda sol, ref: sol), (10, 4, 2), ("fused_ik_generated",))
    # the pose ring N = 16 on kernel 7 (no inner-QP axis), cost below 2e-3 N.
    rfam = pr.pose_ring_family(16)
    rd, rx = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in ring_instances(TUNER_B, 16, seed=0))
    out["pose_ring_n16"] = (
        lambda o, q, l: pr.pose_ring_solve_batch(rfam, rd, rx, max_iterations=o, ls_iterations=l,
                                                 return_state=True)[1][:, 0],
        parity_gate(2e-3 * 16, frac=1.0, metric=lambda sol, ref: sol), (10, 1, 2), ("pose_ring",))
    # the MPC servo fleet: 64 periods from a cold 8/3/2 solve, |theta| <= 0.05.
    mfam = pm.cartpole_mpc_family(20, 0.05)
    rng = np.random.default_rng(0)
    m0 = np.zeros((TUNER_MPC_B, 4), np.float32)
    m0[:, 0] = rng.uniform(-0.5, 0.5, TUNER_MPC_B)
    m0[:, 2] = rng.uniform(-0.35, 0.35, TUNER_MPC_B)
    m_d = torch.as_tensor(m0, device="cuda")
    z1 = mot.fused_mpc_solve_batch(mfam, m_d, mpcm.initial_guess(mpcm.CartPole(), m_d, 20, 0.05), 8, 3, 2)
    out["mpc_servo_T20"] = (
        lambda o, q, l: mot.fused_mpc_servo_batch(mfam, m_d, z1, 64, max_iterations=o, qp_iterations=q,
                                                  ls_iterations=l)[0][:, 2],
        parity_gate(0.05, frac=1.0, metric=lambda sol, ref: sol.abs()), (4, 3, 2), ("mpc_servo",))
    # the 48-joint arm on kernel 2, examples/blocked_medium_n.py's gate: parity above 0.9.
    arm = fik.planar_family(ARM_N, LINK)
    at, ax = medium_n_planar_instances(TUNER_B, ARM_N, seed=0)
    at_d, ax_d = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (at, ax))

    def arm_gate(sol, ref):
        share = float((effector_error("planar", sol.cpu(), at) < 1e-3).mean())
        return share > 0.9, share - 0.9

    out["arm_n48"] = (
        lambda o, q, l: mot.fused_solve_batch(arm, at_d, ax_d, max_iterations=o, qp_iterations=q, ls_iterations=l,
                                              barrier="mpc", line_search="armijo"),
        arm_gate, (6, 3, 2), ("blocked",))
    return out


def tuner_path(card, kind, families, poses):
    """Phase 35: tune_serving_budget on each family, every budget a launch of
    its kernel at run-time trip counts; one JSON line per family."""
    from mini_opt_tpu_torch.tuning import budget_cost, tune_serving_budget

    reset_counts()
    fams = tuner_families(families, poses)
    torch.cuda.synchronize()
    cold = counts()["mpc"]  # the MPC fleet's cold solve, once
    if cold != 1:
        fail(f"phase35: the MPC fleet's cold solve launched kernel 8 {cold} times")
    launched = {}
    for name, (solve, gate, anchor, keys) in fams.items():
        reset_counts()
        t0 = time.perf_counter()
        res = tune_serving_budget(solve, gate, max_budget=anchor, min_budget=(1, 1, 0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        launched[name] = {k: c[k] for k in keys}
        if name == "mpc_servo_T20":
            launched[name]["mpc"] = cold
        if any(v < 1 for v in launched[name].values()) or any(v for k, v in c.items() if k not in keys):
            fail(f"phase35 {name}: the tuner's solves launched {c}, not the family's kernel alone")
        print(f"# phase35 " + json.dumps({
            "family": name, "budget": list(res.budget), "anchor": list(res.max_budget),
            "margin_at_budget": res.margin_at(res.budget), "n_evaluations": res.n_evaluations,
            "cost_vs_anchor": budget_cost(res.budget) / budget_cost(res.max_budget),
            "trace": [[list(p.budget), p.ok, p.margin] for p in res.trace], "wall_s": wall,
            "launches": launched[name], "card": card,
            "tpu_budget_in_status_md": TPU_STATUS_BUDGETS[name]}), flush=True)
        if name == "planar_ik" and not all(a <= b for a, b in zip(res.budget, (4, 2, 1))):
            fail(f"phase35 planar: tuned budget {res.budget} is not (4, 2, 1) or cheaper in every component")
    return launched


# ---------------------------------------------------------------------------
# Phases 36-39: the rest of the general path (slice 16) and kernel 6 at
# every size the JAX kernel takes.
# ---------------------------------------------------------------------------

ARM_GENERAL_B = 8192


def random_qps(B, N, K, var, dtype, seed):
    """B well-conditioned QPs on the card: G = R R^T / N + I (garbage above
    the diagonal: only the lower triangle is read), c, A and b standard
    normal, box rows a x[var] + b >= 0 with |a| in [0.5, 2] of either sign
    and b in [0.2, 2] (x = 0 strictly inside); past B = 5 lane 3's c NaN."""
    rng = np.random.default_rng(seed)
    M = len(var)
    R = rng.normal(size=(B, N, N))
    G = R @ R.transpose(0, 2, 1) / N + np.eye(N)
    up = np.triu_indices(N, 1)
    G[:, up[0], up[1]] = rng.normal(size=(B, len(up[0])))
    c, A, b = rng.normal(size=(B, N)), rng.normal(size=(B, K, N)), rng.normal(size=(B, K))
    ia = np.where(rng.random((B, M)) < 0.5, 1.0, -1.0) * rng.uniform(0.5, 2.0, (B, M))
    ib = rng.uniform(0.2, 2.0, (B, M))
    if B > 5:
        c[3, 0] = np.nan
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda") for a in (G, c, A, b, ia, ib))


def loose_box_qps(B, N, dtype, seed):
    """B QPs where kernel 6 and qp_ip_solve follow the same arithmetic: G
    = R R^T / N + I, c standard normal, one equality row A / sqrt(N), b
    small, a box |x_i| <= 3 on variables 1..N-1 (the pair rows) that the
    equality-constrained guess lands inside, so no clamp starts a lane at
    the boundary (where the two schedules part: on such lanes float64 gaps
    of 1e-8 and more appear, float32 gaps past 1). On the CPU in float64 the
    two agree to 4e-16 at N = 12 and 24, and qp_ip_solve's float32 stays
    within 8e-7 of its float64 at N = 191."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(B, N, N))
    G = R @ R.transpose(0, 2, 1) / N + np.eye(N)
    c, A, b = rng.normal(size=(B, N)), rng.normal(size=(B, 1, N)) / math.sqrt(N), rng.normal(size=(B, 1)) * 0.1
    ia = np.tile([1.0, -1.0] * (N - 1), (B, 1))
    ib = np.full((B, 2 * (N - 1)), 3.0)
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda") for a in (G, c, A, b, ia, ib))


def qp6_cases():
    """Phase 36's shapes: (label, N, K, box rows' variables, source) with
    source "random" (random_qps) or "ik" (ik_qps, the port's linearization
    of planar IK instances: pair rows, K = 1, ia a stride-0 broadcast)."""
    return [
        ("N=1 K=0 M=0", 1, 0, (), "random"),
        ("N=1 K=1 M=2 (lo and hi on x0)", 1, 1, (0, 0), "random"),
        ("N=3 K=2 pairs", 3, 2, fq.pair_rows(3), "random"),
        ("N=5 K=3 pairs", 5, 3, fq.pair_rows(5), "random"),
        ("N=4 K=1 M=3N repeated rows", 4, 1, tuple((3 * m) % 4 for m in range(12)), "random"),
        ("N=9 K=1 pairs (IK)", 9, 1, fq.pair_rows(9), "ik"),
        ("N=16 K=1 pairs (IK)", 16, 1, fq.pair_rows(16), "ik"),
        ("N=48 K=1 pairs (IK)", 48, 1, fq.pair_rows(48), "ik"),
    ]


def qp6_inputs(N, K, var, source, B, dtype, seed):
    if source == "ik":
        tensors, v = ik_qps(N, B, dtype, seed)
        if v != tuple(var):
            fail(f"phase36: the IK linearization's rows {v} are not pair_rows({N})")
        return tensors
    return random_qps(B, N, K, var, dtype, seed)


def qp6_new_routes(max_err):
    """Phase 36: kernel 6's new sizes against its plain version, bit for
    bit: each qp6_cases shape at B = 1037 (a NaN lane) in both types and
    barriers, at B = 1 and W + 1 (a ragged last CTA) in float64 with the
    complementarity barrier and float32 with Mehrotra; at D = 120 and 192
    against qp_ip_solve (complementarity, 6 iterations; the plain version
    costs D^3 tensor operations, so it is held only to D = 49); one device
    kernel a call on the warp route."""
    for label, N, K, var, source in qp6_cases():
        for dtype in (torch.float64, torch.float32):
            plan = fq.launch_plan(N, K, len(var), 1037, dtype)
            w = plan.instances_per_cta if plan.route == "warp" else 32
            small = "complementarity" if dtype == torch.float64 else "mpc"
            route = fq.qp_route(N, K, var, dtype)
            ts = qp6_inputs(N, K, var, source, 1037, dtype, seed=7 * N + K)
            for barrier in ("complementarity", "mpc"):
                args = (*ts, var, 6, 0.1, barrier, True)
                want = fq._fused_qp_plain_batch(*args)
                # One QP and a ragged last CTA against the same plain call's
                # first lanes (slice 17 cut their plain calls of their own);
                # at N = 48 the kernel's B = 1037 alone.
                batches = (1037, 1, w + 1) if barrier == small and N < ARM_N else (1037,)
                for B in batches:
                    before = fq.FUSED_QP_LAUNCHES
                    got = fq._fused_qp_cuda(*(t[:B] for t in ts), var, 6, 0.1, barrier, True)
                    torch.cuda.synchronize()
                    if fq.FUSED_QP_LAUNCHES != before + 1:
                        fail(f"phase36 {label}: the fused QP wrapper did not count its launch")
                    if B > 5 and not bool(got[0].isnan().any()):
                        fail(f"phase36 {label} B={B}: the NaN lane came out finite")
                    finite = torch.isfinite(got[0]).all(-1).double().mean().item()
                    check_bits(f"phase36 fused QP {label} ({route} route, {plan.instances_per_cta} a CTA) {barrier} "
                               f"B={B} (finite lanes {finite:.4f})", got, tuple(t[:B] for t in want), max_err)

    # Past the plain version's reach: against qp_ip_solve.
    B = 64
    for D in (120, 192):
        N = D - 1
        var = fq.pair_rows(N)
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
            try:
                plan = fq.launch_plan(N, 1, len(var), B, dtype)
            except NotImplementedError as e:
                print(f"# phase36 D={D} {dtype}: {e}", flush=True)
                continue
            G, c, A, b, ia, ib = loose_box_qps(B, N, dtype, seed=D)
            x, y = fq._fused_qp_batch(G, c, A, b, ia, ib, ineq_var=var, iterations=6, sigma=0.1,
                                      barrier="complementarity", has_eq_guess=True)
            qp = mot.QP(G, c, A, b, torch.tensor(var, device="cuda"), ia, ib)
            params = mot.QPInteriorPointParams(
                max_iterations=6, sigma=0.1, termination_kkt_tol=1e-300, termination_complementarity_tol=1e-300,
                barrier_strategy=mot.BarrierStrategy.COMPLEMENTARITY,
                initial_guess_method=mot.InitialGuessMethod.SOLVE_EQUALITY_CONSTRAINED,
                kkt_solver="ldlt", record_history=False, early_exit=False)
            ref = mot.qp_ip_solve(qp, params)
            gap = max(float(((x - ref.x).abs() / (1 + ref.x.abs())).max()),
                      float(((y - ref.y).abs() / (1 + ref.y.abs())).max()))
            print(f"# phase36 fused QP D={D} (N={N}, K=1, M={len(var)}) {str(dtype)[6:]} B={B} ({plan.route} route, "
                  f"{plan.instances_per_cta} a CTA, {plan.instance_bytes} B an instance): against qp_ip_solve "
                  f"(complementarity, 6 iterations) max |dx| / (1 + |x|) {gap:.3e} (gate {tol:g})", flush=True)
            if not gap <= tol:
                fail(f"phase36 D={D} {dtype}: kernel 6 is {gap:.3e} from qp_ip_solve")

    tensors, var = ik_qps(ARM_N, GENERAL_B, torch.float32, seed=48)

    def call():
        return fq._fused_qp_batch(*tensors, ineq_var=var, iterations=3, sigma=0.1, barrier="mpc",
                                  has_eq_guess=True)

    kernels_a_call(f"phase36 _fused_qp_batch N={ARM_N} K=1 B={GENERAL_B} float32 (warp route)", call,
                   (r"fused_qp_warp_kernel",))
    for dtype in (torch.float32, torch.float64):
        for N, K, M in ((48, 1, 94), (119, 1, 236), (191, 1, 380)):
            try:
                plan = fq.launch_plan(N, K, M, GENERAL_B, dtype)
            except NotImplementedError as e:
                print(f"# phase36 plan N={N} K={K} M={M} {dtype}: {e}", flush=True)
                continue
            lib = _build.load_library()
            occ = lib.mo_fused_qp_warp_occupancy(ldlt_dtype_id(dtype), N, K, M, plan.instances_per_cta)
            slab = lib.mo_fused_qp_warp_slab_bytes(ldlt_dtype_id(dtype), N, K, M)
            print(f"# phase36 warp plan N={N} K={K} M={M} {str(dtype)[6:]}: {plan}; the launcher's slab {slab} B; "
                  f"CTAs per SM {occ}", flush=True)
            if slab != plan.instance_bytes:
                fail(f"phase36: the launcher's slab ({slab} B) is not launch_plan's ({plan.instance_bytes} B)")


def ldlt_dtype_id(dtype):
    return 0 if dtype == torch.float32 else 1


def arm_general_params(dtype=torch.float32, qp_solver="pallas_fused"):
    """examples/blocked_medium_n.py's budget (6/3/2, Mehrotra, Armijo) on the
    general path, fixed trips, no history."""
    return dataclasses.replace(
        mot.default_ik_params(dtype, max_iterations=6, max_qp_iterations=3),
        max_line_search_iterations=2, qp_barrier_strategy=mot.BarrierStrategy.PREDICTOR_CORRECTOR,
        record_history=False, early_exit=False, qp_solver=qp_solver,
    )


def arm_general_path(card, kind, blocked_parity):
    """Phase 37: the 48-joint arm through solve_ik_batch(qp_solver=
    "pallas_fused") at B = 8192, float32: kernel 6's warp route, one launch
    a QP call; parity beside the blocked tier's on the same rows; kernel 6
    on the call's last QPs against its plain version bit for bit; times,
    kernel 6 alone and its bound. Returns kernel 6's row fields. (Slice 17
    cut its depth: the whole call with the plain kernels swapped in, six
    3.5-s plain QP calls, and a profiled call of some 348,000 device kernels
    went; the earlier readings of both stand in PERF.md.)"""
    B = ARM_GENERAL_B
    targets, x0 = medium_n_planar_instances(B, ARM_N, seed=0)
    t32, x32 = targets.astype(np.float32), x0.astype(np.float32)
    params = arm_general_params()
    seen = {}
    with recording(fq, "_fused_qp_cuda", seen):
        reset_counts()
        res = mot.solve_ik_batch(t32, x32, params=params)  # no warm-up: a call costs its host, not its B
        torch.cuda.synchronize()
        got = counts()
    if got["fused_qp"] != params.max_iterations or any(v for k, v in got.items() if k != "fused_qp"):
        fail(f"phase37: launches {got}, not one kernel-6 launch per outer iteration ({params.max_iterations})")
    if res.x.shape != (B, ARM_N) or not res.x.is_cuda or not torch.isfinite(res.x).all():
        fail(f"phase37: unexpected solutions {tuple(res.x.shape)} {res.x.device}")
    err = effector_error("planar", res.x.cpu().numpy(), targets)
    parity = float((err < 1e-3).mean())
    qp_args = seen["_fused_qp_cuda"]
    qp_got = fq._fused_qp_cuda(*qp_args)
    plain_ms, qp_want = event_ms(lambda: fq._fused_qp_plain_batch(*qp_args))
    same = bit_identical(*zip(qp_got, qp_want))
    print(f"# phase37 solve_ik_batch planar n={ARM_N} B={B} float32 6/3/2 mpc armijo qp_solver=pallas_fused: "
          f"launches {got} for 1 call; parity {parity:.6f} (effector error p50 {np.median(err):.3e}, max "
          f"{err.max():.3e}; the blocked tier's on the same rows, phase 7: {blocked_parity:.6f}); kernel 6 on the "
          f"call's last QPs against its plain version ({plain_ms:.1f} ms): bit-identical {same}", flush=True)
    if not same:
        fail("phase37: kernel 6 disagrees with its plain version on the arm's QPs")
    entry = lambda: mot.solve_ik_batch(t32, x32, params=params)  # noqa: E731
    # One timed call (a call takes seconds: the host issues some 350,000
    # device kernels); the counted call above warmed it.
    e2e_ms, _ = event_ms(entry)
    e2e_all = [e2e_ms]
    busy_ms, n_kernels = None, None
    k_ms, k_all = time_ms(lambda: fq._fused_qp_cuda(*qp_args), held=True)
    plan = fq.launch_plan(ARM_N, 1, len(qp_args[6]), B, torch.float32)
    # The plain version's operations on 64 of the QPs, per instance.
    small = tuple(t[:64] for t in qp_args[:6]) + tuple(qp_args[6:])
    ops = count_ops(lambda: fq._fused_qp_plain_batch(*small)) / 64 * B
    N, K, M = ARM_N, 1, len(qp_args[6])
    nbytes = (stored(qp_args[0][:, :, 0]) * (N + 1) // 2 + sum(stored(t) for t in qp_args[1:6]) + B * (N + K)) * 4
    bound_ms, bound_by = roofline(ops, nbytes)
    dev = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms busy in {n_kernels} device kernels"
    print(f"# phase37 on {kind} ({card}): entry point {e2e_ms:.3f} ms/call (repeats {e2e_all}), profiled call "
          f"{dev}; kernel 6 alone at B={B} N={N} K=1 M={M} float32 3 iterations mpc ({plan.route} route, "
          f"{plan.instances_per_cta} a CTA, {plan.instance_bytes} B an instance) {k_ms:.5f} ms (held; repeats "
          f"{k_all}), {got['fused_qp']} launches a call; plain {plain_ms:.1f} ms; {ops / B:.0f} ops an instance, "
          f"{nbytes / B:.0f} bytes -> bound {bound_ms:.6f} ms ({bound_by}), kernel = {k_ms / bound_ms:.1f}x bound",
          flush=True)
    return dict(arm_launches=got["fused_qp"], arm_ms=k_ms, arm_plain_ms=plain_ms, arm_bound_ms=bound_ms,
                arm_bound_by=bound_by, arm_entry_ms=e2e_ms, arm_device_kernels=n_kernels, arm_parity=parity,
                arm_shape=f"B={B} N={N} K=1 M={M} float32 3 iterations mpc (warp route)")


LINE_SEARCHES = {
    "sequential": {},
    "parallel": dict(parallel_line_search=True),
    "parallel + fused probe": dict(parallel_line_search=True, fuse_probe_linearize=True),
}


def line_search_paths(card, kind):
    """Phase 38: bench.py --general's cell (planar n = 2, 10/6/2,
    complementarity, Armijo, B = 8192, float32) on both QP routes, with the
    sequential, the parallel and the parallel + fused-probe line search:
    launches, parity (>= 0.99 each), ms a call; then in float64 at B = 1024
    each parallel variant against the sequential one (x within 1e-12,
    termination states equal). Returns the launches."""
    B = GENERAL_B
    targets, x0 = planar_instances(B, 2, seed=0)
    t32, x32 = targets.astype(np.float32), x0.astype(np.float32)
    launches = {}
    for route in GENERAL_ROUTES:
        for name, extra in LINE_SEARCHES.items():
            params = dataclasses.replace(general_params(route), **extra)
            mot.solve_ik_batch(t32[:64], x32[:64], params=params)  # warm-up, uncounted
            torch.cuda.synchronize()
            reset_counts()
            res = mot.solve_ik_batch(t32, x32, params=params)
            torch.cuda.synchronize()
            got = {k: v for k, v in counts().items() if v}
            launches[f"{route}, {name}"] = got
            err = effector_error("planar", res.x.cpu().numpy(), targets)
            parity = float((err < 1e-3).mean())
            entry = lambda: mot.solve_ik_batch(t32, x32, params=params)  # noqa: E731
            e2e_ms, e2e_all = time_ms(entry, repeats=1, launches=1, warmup=0)  # the counted call warmed it
            # No profiled call (slice 17 cut the script's depth; the earlier
            # readings of each variant's device kernels stand in PERF.md).
            dev = "not measured"
            print(f"# phase38 {route}, {name} line search, solve_ik_batch planar n=2 B={B} float32 10/6/2 on {kind} "
                  f"({card}): launches {got} for 1 call; parity {parity:.6f}; {e2e_ms:.3f} ms/call (repeats "
                  f"{e2e_all}); profiled call {dev}", flush=True)
            if not parity >= 0.99:
                fail(f"phase38 {route}, {name}: parity {parity} is below 0.99")
    Bd = 1024
    t64, x64 = planar_instances(Bd, 2, seed=1)
    for route in GENERAL_ROUTES:
        ref = None
        for name, extra in LINE_SEARCHES.items():
            params = dataclasses.replace(general_params(route, torch.float64), **extra)
            res = mot.solve_ik_batch(t64, x64, params=params)
            torch.cuda.synchronize()
            if ref is None:
                ref = res
                continue
            gap = max_abs_diff(res.x, ref.x)
            same_states = torch.equal(res.termination_state, ref.termination_state)
            print(f"# phase38 float64 B={Bd} {route}: {name} against sequential max|dx| {gap:.3e}, termination "
                  f"states equal {same_states}", flush=True)
            if not (gap <= 1e-12 and same_states):
                fail(f"phase38 float64 {route}, {name}: {gap:.3e} from the sequential line search or states differ")
    return launches


def history_path(card, kind):
    """Phase 39: one float64 solve at B = 64 (the planar n = 2 cell on
    kernels 4 and 5) with record_history, log_qp_eigenvalues and an
    exit_callback that stops a lane once its cost falls under 1e-9:
    the eigenvalues within 1e-10 of numpy.linalg.eigvalsh of each
    iteration's G, the stopped lanes USER_CALLBACK, lane 0 through JSON and
    the batch through npz exactly, one device_profile trace with the
    solver's phases. Returns the launches."""
    import tempfile

    from mini_opt_tpu_torch.utils import serialization, tracing

    Bh = 64
    targets, x0 = planar_instances(Bh, 2, seed=2)
    t_t, x_t = (torch.as_tensor(a, device="cuda") for a in (targets, x0))
    chain = mot.make_planar_chain(2, dtype=torch.float64, device="cuda")
    params = dataclasses.replace(general_params("pallas_ldlt", torch.float64), record_history=True,
                                 log_qp_eigenvalues=True)
    threshold = 1e-9

    def solve():
        return mot.nls_solve(lambda t: mot.make_ik_problem(chain, t), params, x_t, data=t_t,
                             retraction=mot.mod_pi_retraction,
                             exit_callback=lambda row: row.errors_initial.f > threshold)

    Gs = []
    real = mot.nonlinear.linearize_and_fill_qp

    def spy(*args, **kwargs):
        qp, err = real(*args, **kwargs)
        Gs.append(qp.G.detach().cpu().numpy())
        return qp, err

    mot.nonlinear.linearize_and_fill_qp = spy
    try:
        reset_counts()
        res = solve()
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
    finally:
        mot.nonlinear.linearize_and_fill_qp = real
    ev = res.iterations.qp_eigenvalues
    n_it = res.num_iterations.cpu().numpy()
    worst = 0.0
    for i, G in enumerate(Gs):
        w = np.linalg.eigvalsh(G)
        ran = n_it > i
        for name, want in (("min", w.min(1)), ("max", w.max(1)), ("abs_min", np.abs(w).min(1))):
            have = getattr(ev, name)[:, i].cpu().numpy()
            worst = max(worst, float(np.abs(have[ran] - want[ran]).max(initial=0.0)))
    user = (res.termination_state == mot.NLSTerminationState.USER_CALLBACK).cpu().numpy()
    last_f = res.iterations.errors_initial.f.cpu().numpy()[np.arange(Bh), np.maximum(n_it - 1, 0)]
    print(f"# phase39 float64 B={Bh} history + eigenvalues + exit_callback (cost under {threshold:g}) on {kind}: "
          f"launches {got}; eigenvalues against numpy.linalg.eigvalsh of {len(Gs)} iterations' G max|diff| "
          f"{worst:.3e} (gate 1e-10); {int(user.sum())} lanes USER_CALLBACK, their last costs max "
          f"{last_f[user].max(initial=0.0):.3e}; states {np.bincount(res.termination_state.cpu().numpy() + 1).tolist()} "
          f"(NONE=-1 first)", flush=True)
    if not worst <= 1e-10:
        fail(f"phase39: the logged eigenvalues are {worst:.3e} from numpy's")
    if not user.any() or not (last_f[user] <= threshold).all():
        fail("phase39: the exit callback stopped no lane, or a lane above its threshold")
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        lane0 = mot.structs.tree_map(lambda t: t[0], res)
        serialization.save_result_json(f"{tmp}/lane0.json", lane0)
        back = serialization.load_result_json(f"{tmp}/lane0.json", device="cuda")
        json_same = serialization.nls_result_to_json(back) == serialization.nls_result_to_json(lane0)
        serialization.save_result_npz(f"{tmp}/batch.npz", res)
        leaves, back_leaves = [], []
        mot.structs.tree_map(lambda t: leaves.append(t) or t, res)
        mot.structs.tree_map(lambda t: back_leaves.append(t) or t,
                             serialization.load_result_npz(f"{tmp}/batch.npz", device="cuda"))
        npz_same = len(leaves) == len(back_leaves) and bit_identical(*zip(leaves, back_leaves))
        tracing.trace_collector.clear()
        with tracing.device_profile(f"{tmp}/profile"):
            solve()
            torch.cuda.synchronize()
        import glob

        traces = glob.glob(f"{tmp}/profile/trace_*.json")
        text = open(traces[0]).read() if traces else ""
        phases = {name: text.count(f'"{name}"') for name in
                  ("Solve", "LinearizeAndFillQP", "ComputeStepDirection", "QPInteriorPointSolve", "SelectStepSize",
                   "EvaluateNonlinearErrors")}
        collected = len(json.loads(tracing.trace_collector.get_trace_json())["traceEvents"])
    print(f"# phase39 lane 0 through JSON exactly {json_same}; the batch through npz bit-identical {npz_same}; "
          f"device_profile wrote {len(traces)} trace(s), the solver's phase spans in it {phases}, "
          f"{collected} events in trace_collector", flush=True)
    if not (json_same and npz_same and len(traces) == 1 and all(phases.values())):
        fail("phase39: a round trip differs, or the profile trace lacks a solver phase")
    return got


# ---------------------------------------------------------------------------
# Phases 40-43 (slice 17): the hand-written fused tiers at every size the
# JAX package's entry points take.
# ---------------------------------------------------------------------------

# Phase 40: kernel 1's instances past n = 2..8 (each built at first use, one
# nvcc an instance; phase 2 builds these beside the main library).
SIZE_NS = (1, 9, 16, 24, 31)
SIZE_B = 8192 + 13
WIDE_N = 31  # the widest chain of the register tier (D = 32)
WIDE_B = 8192
# The spatial arm on kernel 2 (D = 49, examples/blocked_medium_n.py's width)
# and the blocked tier's sizes past one CTA's slab or D = 192.
SPATIAL_NS = (33, ARM_N)
GLOBAL_CASES = ((192, torch.float32), (255, torch.float32), (162, torch.float64), (200, torch.float64))
GLOBAL_N = 255  # the global route's cell: D = 256
PLAIN_LANES = 1024  # its plain version's lanes
SHORT = dict(max_iterations=2, qp_iterations=1, ls_iterations=1, barrier="mpc", line_search="armijo")
# A generated pose chain past D = 192 on the global route (D = 216).
POSE_GLOBAL = (72, ((10, 60), (30, 70)))
# Phase 43: kernel 7's run-time route. (i) eight border poses joined by
# every closure spanning at least 16 poses (k = 8, 21 closures); (ii) the
# N = 96 chain with a closure every 8 poses (k = 12, 11 closures); (iii)
# (i) plus three closures to pose 63 (k = 9, 24 closures).
TOPO_I = tuple((a, b) for a in range(0, 57, 8) for b in range(0, 57, 8) if b - a >= 16)
TOPO_II = tuple((8 * j, 8 * j + 8) for j in range(11))
TOPO_III = TOPO_I + ((8, 63), (24, 63), (40, 63))
TABLE_CASES = (("(i) k=8, 21 closures", 64, TOPO_I), ("(ii) k=12, 11 closures", 96, TOPO_II),
               ("(iii) k=9, 24 closures", 64, TOPO_III))
CELL_TOPOLOGIES = ("(i) k=8, 21 closures", "(ii) k=12, 11 closures")  # also run at B = 8192
TABLE_B = 1024 + 13
# Lanes of each full-width cell whose float64 CPU plain version sets the
# parity gate (solved in phase 1's worker pool).
REF_LANES = {"planar31": 256, "spatial48": 64, "planar255": 64}


def kernel1_instances(late=False):
    """The hand-written kernel-1 instances this script launches, as
    _build.build_fused_ik takes them, in both types: phases 3-4's and 35's
    (planar n = 2 and 4, spatial n = 3), or with ``late`` phase 40's."""
    sizes = {(f, n) for f in (0, 1) for n in SIZE_NS} if late else {(0, 2), (0, 4), (1, 3)}
    return sorted((f, n, dbl) for f, n in sizes for dbl in (False, True))


def print_instances(instances, paths, tag):
    """Each kernel-1 instance's ptxas line and build seconds."""
    for (f, n, dbl), path in zip(instances, paths):
        secs = path.with_suffix(".seconds")
        for name, nreg, spill, _, stack in ptxas_report(path.with_suffix(".log").read_text()):
            if "fused_ik_kernel" in name:
                print(f"# {tag} ptxas fused_ik<{'double' if dbl else 'float'}, {('Planar', 'Spatial')[f]}<{n}>>: "
                      f"{nreg} registers, {spill} bytes spill stores, {stack} bytes stack frame; build "
                      f"{secs.read_text().strip() if secs.exists() else '-'} s "
                      f"({'-O1' if n > _build.LARGE_FUSED_IK_N else '-O3'})", flush=True)


def spatial_arm_instances(B, n, seed=0):
    """The spatial arm's cell (the 48-joint arm's construction,
    examples/blocked_medium_n.py, on the spatial chain): a reference pose
    per instance (joint 0 in [-0.3, 0.3], the others in [0.3, 1.2] rad, off
    the straight chain's singularity) as the warm start, and a target a small
    task step (+-0.05 per axis) from its effector."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.3, 1.2, (B, n))
    th[:, 0] = rng.uniform(-0.3, 0.3, B)
    return spatial_fk(th, LINK) + rng.uniform(-0.05, 0.05, (B, 3)), th


def size_reference(name):
    """A full-width cell's float64 CPU plain version on its first REF_LANES
    lanes (run in a worker process): the effector errors."""
    torch.set_num_threads(2)
    lanes = REF_LANES[name]
    if name == "planar31":
        data, x0 = medium_n_planar_instances(WIDE_B, WIDE_N, seed=0)
        solve, kind = mot.fused_ik_solve_batch, "planar"
    elif name == "spatial48":
        data, x0 = spatial_arm_instances(WIDE_B, ARM_N, seed=0)
        solve, kind = mot.fused_spatial_ik_solve_batch, "spatial"
    else:
        data, x0 = medium_n_planar_instances(WIDE_B, GLOBAL_N, seed=0)
        solve, kind = mot.fused_ik_solve_batch, "planar"
    d, x = (torch.as_tensor(a[:lanes]) for a in (data, x0))
    xs = solve(d, x, device="cpu", **ARM)
    return effector_error(kind, xs.numpy(), data[:lanes])


def size_references(pool):
    return {name: pool.apply_async(size_reference, (name,)) for name in REF_LANES}


def cell_gate(tag, kind, x, data, ref):
    """The full-width cells' gate: the share of lanes with effector error <
    1e-3 on the reference lanes at least the float64 CPU plain version's
    there."""
    err = effector_error(kind, x.detach().cpu(), data)
    lanes = len(ref)
    share, share_ref = float((err[:lanes] < 1e-3).mean()), float((ref < 1e-3).mean())
    print(f"# {tag}: parity {float((err < 1e-3).mean()):.6f} over {len(err)} lanes (p50 {np.median(err):.3e}); "
          f"on the first {lanes} lanes {share:.6f}, the float64 CPU plain version {share_ref:.6f}", flush=True)
    if not share >= share_ref:
        fail(f"{tag}: parity {share} on the reference lanes is below the float64 CPU plain version's {share_ref}")
    return float((err < 1e-3).mean())


def cell_times(tag, kernel, plain, ops_call, B, bytes_per_instance, launches=5, repeats=3):
    """A full-width cell's kernel (held), its plain version once, its
    device kernels a call (one call captured in a CUDA graph) and its bound:
    the plain version's operations per instance (counted by ops_call, a call
    on few lanes: elementwise work is the same for every lane) times B, and
    the bytes each instance reads and writes. Returns the row and the plain
    call's outputs."""
    k_ms, k_all = time_ms(kernel, repeats=repeats, launches=launches, warmup=1, held=True)
    nodes = graph_nodes(kernel)
    if nodes != {"kernel": 1}:
        fail(f"{tag}: a call is not one device kernel ({nodes})")
    plain_ms, want = event_ms(plain)
    ops_lanes, ops = ops_call()
    bound_ms, bound_by = roofline(ops / ops_lanes * B, B * bytes_per_instance)
    print(f"# {tag}: kernel alone on the card {k_ms:.4f} ms (held; repeats {k_all}), one device kernel a call "
          f"({nodes}); plain {plain_ms:.3f} ms; {ops / ops_lanes:.0f} elementwise ops per instance -> bound "
          f"{bound_ms:.6f} ms ({bound_by}), kernel = {k_ms / bound_ms:.1f}x bound", flush=True)
    return dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, ops_per_instance=ops / ops_lanes), want


def ik_sizes_paths(card, kind, refs):
    """Phase 40: kernel 1 at n = 1, 9, 16, 24, 31, both families and types,
    against its plain version bit for bit (B = 8205 with a NaN-target and a
    NaN-start lane; B = 1 and strided inputs against the same plain call's
    lanes: every lane's arithmetic is its own); then the n = 31 cell through
    fused_ik_solve_batch. Its instances are built here, on every core,
    so that no build runs beside the host-timed phases before it."""
    t0 = time.perf_counter()
    late = kernel1_instances(late=True)
    paths = _build.build_fused_ik(late)
    print(f"# phase40 build: {len(paths)} kernel-1 instances in {time.perf_counter() - t0:.1f} s", flush=True)
    print_instances(late, paths, "phase40")
    max_err = {"float64": 0.0, "float32": 0.0}
    for n in SIZE_NS:
        for fam_kind in ("planar", "spatial"):
            data, x0 = (planar_instances if fam_kind == "planar" else spatial_instances)(SIZE_B, n, seed=n)
            data[5, 0] = np.nan
            x0[9, min(1, n - 1)] = np.nan
            family = (fik.planar_family if fam_kind == "planar" else fik.spatial_family)(n, LINK)
            for dtype in (torch.float64, torch.float32):
                d = torch.as_tensor(data, dtype=dtype, device="cuda")
                x = torch.as_tensor(x0, dtype=dtype, device="cuda")
                bud = (BENCH["max_iterations"], BENCH["qp_iterations"], BENCH["ls_iterations"], "armijo", "mpc", False)
                before = fik.KERNEL_LAUNCHES
                got = fik._fused_solve_cuda(family, d, x, *bud)
                one = fik._fused_solve_cuda(family, d[:1], x[:1], *bud)
                ds, xs = torch.stack([d[:33], d[:33]], 2)[:, :, 0], x[:33].T.contiguous().T
                strided = fik._fused_solve_cuda(family, ds, xs, *bud)
                torch.cuda.synchronize()
                if fik.KERNEL_LAUNCHES != before + 3:
                    fail(f"phase40 {fam_kind} n={n}: the kernel wrapper did not count its launches")
                want = fik._fused_solve_plain_batch(family, d, x, *bud)
                torch.cuda.synchronize()
                tag = f"phase40 {fam_kind} n={n} 4/2/1"
                for label, g, lanes in (("B=8205", got, SIZE_B), ("B=1", one, 1), ("B=33 strided", strided, 33)):
                    check_against_plain(f"{tag} {label}", fam_kind, data[:lanes],
                                        (g[0].T, g[1].T, None), (want[0][:lanes].T, want[1][:lanes].T, None), max_err)
    CLOCK.mark("phase 40 (bit for bit)")

    # The n = 31 cell: planar, the arm's instances and budget, float32.
    data, x0 = medium_n_planar_instances(WIDE_B, WIDE_N, seed=0)
    t32, x32 = (a.astype(np.float32) for a in (data, x0))
    reset_counts()
    x, state = mot.fused_ik_solve_batch(t32, x32, return_state=True, **ARM)
    torch.cuda.synchronize()
    got = counts()
    if got["fused_ik"] != 1 or sum(got.values()) != 1:
        fail(f"phase40 n={WIDE_N} cell: launches {got}, expected one kernel-1 launch")
    parity = cell_gate(f"phase40 fused_ik_solve_batch planar n={WIDE_N} B={WIDE_B} float32 6/3/2 (launches {got})",
                       "planar", x, data, refs["planar31"].get())
    family = fik.planar_family(WIDE_N, LINK)
    d_c, x_c = (torch.as_tensor(a, device="cuda") for a in (t32, x32))
    bud = (*ARM_ARGS, False)
    plain = lambda: fik._fused_solve_plain_batch(family, d_c, x_c, *bud)  # noqa: E731
    row, want = cell_times(f"phase40 kernel 1 planar n={WIDE_N} B={WIDE_B} float32 6/3/2 on {kind} ({card})",
                           lambda: fik._fused_solve_cuda(family, d_c, x_c, *bud), plain,
                           lambda: (64, count_ops(lambda: fik._fused_solve_plain_batch(family, d_c[:64], x_c[:64],
                                                                                       *bud))),
                           WIDE_B, (2 + WIDE_N + WIDE_N + 3) * 4)
    check_against_plain(f"phase40 n={WIDE_N} cell B={WIDE_B}", "planar", data, (x.T, state.T, None),
                        (want[0].T, want[1].T, None), max_err)
    CLOCK.mark("phase 40")
    return dict(row, launches=got["fused_ik"], parity=parity, max_err=max_err)


def spatial_chain_paths(card, kind, refs):
    """Phase 41: kernel 2's spatial chain (families.cuh SpatialChain)
    against its plain version bit for bit at n = 33 and 48, both types (B =
    2055 with a NaN lane, B = 1 and B = W + 1 against the same plain call's
    lanes); then the spatial arm through fused_spatial_ik_solve_batch."""
    max_err = {"float64": 0.0, "float32": 0.0}
    B = 2048 + 7
    for n in SPATIAL_NS:
        data, x0 = spatial_arm_instances(B, n, seed=n)
        data[5, 0] = np.nan
        family = fik.spatial_family(n, LINK)
        for dtype in (torch.float64, torch.float32):
            d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            W = blk.launch_plan(blk.slab_shape(family), 1, dtype).warps
            before = blk.BLOCKED_LAUNCHES
            runs = [(Bc, blk._blocked_solve_cuda(family, d_t[:, :Bc], x_t[:, :Bc], *ARM_ARGS))
                    for Bc in (B, 1, W + 1)]
            torch.cuda.synchronize()
            if blk.BLOCKED_LAUNCHES != before + 3:
                fail(f"phase41 spatial n={n}: the blocked kernel wrapper did not count its launches")
            want = blk._blocked_solve_plain(family, d_t, x_t, *ARM_ARGS)
            for Bc, got in runs:
                check_blocked(f"phase41 spatial n={n} (D={n + 1}) 6/3/2 B={Bc} ({W} warps/CTA)", got,
                              tuple(t[:, :Bc] for t in want), max_err, (5,) if Bc == B else ())
    CLOCK.mark("phase 41 (bit for bit)")

    data, x0 = spatial_arm_instances(WIDE_B, ARM_N, seed=0)
    t32, x32 = (a.astype(np.float32) for a in (data, x0))
    reset_counts()
    x, state = mot.fused_spatial_ik_solve_batch(t32, x32, return_state=True, **ARM)
    torch.cuda.synchronize()
    got = counts()
    if got["blocked"] != 1 or sum(got.values()) != 1:
        fail(f"phase41 spatial arm: launches {got}, expected one kernel-2 launch")
    parity = cell_gate(f"phase41 fused_spatial_ik_solve_batch spatial n={ARM_N} B={WIDE_B} float32 6/3/2 "
                       f"(launches {got})", "spatial", x, data, refs["spatial48"].get())
    family = fik.spatial_family(ARM_N, LINK)
    d_t, x_t = mot.batch_from_numpy(t32, x32, "cuda")
    plain = lambda: blk._blocked_solve_plain(family, d_t, x_t, *ARM_ARGS)  # noqa: E731
    row, want = cell_times(f"phase41 kernel 2 spatial n={ARM_N} (D=49) B={WIDE_B} float32 6/3/2 on {kind} ({card})",
                           lambda: blk._blocked_solve_cuda(family, d_t, x_t, *ARM_ARGS), plain,
                           lambda: (WIDE_B, count_ops(plain)), WIDE_B, (3 + ARM_N + ARM_N + 3) * 4)
    check_blocked(f"phase41 spatial arm B={WIDE_B}", (x.T, state.T), want, max_err)
    CLOCK.mark("phase 41")
    return dict(row, launches=got["blocked"], parity=parity, max_err=max_err)


def global_pose_family():
    """Phase 42's generated pose chain past D = 192, and its edges."""
    N, closures = POSE_GLOBAL
    edges = chain_edges(N, closures)
    return mot.family_from_problem(pg.scalar_pose_graph_builder(N, edges), 3 * len(edges))


def global_route_paths(card, kind, refs, pose_global):
    """Phase 42: kernel 2's global route against its plain version bit for
    bit at planar n = 192, 255 (float32) and 162, 200 (float64), B =
    GLOBAL_SLABS + 7 (seven warps solve two instances each) with a NaN lane,
    and on the generated pose chain N = 72 + two closures (D = 216) in both
    types; then planar n = 255 through fused_ik_solve_batch."""
    max_err = {"float64": 0.0, "float32": 0.0}
    B = blk.GLOBAL_SLABS + 7
    for n, dtype in GLOBAL_CASES:
        data, x0 = medium_n_planar_instances(B, n, seed=n)
        data[5, 0] = np.nan
        family = fik.planar_family(n, LINK)
        d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
        args = (family, d_t, x_t) + tuple(SHORT[k] for k in ("max_iterations", "qp_iterations", "ls_iterations",
                                                              "line_search", "barrier"))
        plan = blk.launch_plan(blk.slab_shape(family), B, dtype)
        before = blk.BLOCKED_LAUNCHES
        got = blk._blocked_solve_cuda(*args)
        torch.cuda.synchronize()
        if blk.BLOCKED_LAUNCHES != before + 1 or plan.storage != "global":
            fail(f"phase42 planar n={n}: not one launch on the global route ({plan})")
        check_blocked(f"phase42 planar n={n} (D={n + 1}) 2/1/1 B={B} ({plan.storage}, {plan.rows_per_lane} "
                      f"rows/lane, {plan.warp_bytes} B a slab, {plan.slabs} slabs)", got,
                      blk._blocked_solve_plain(*args), max_err, (5,))
    N, closures = POSE_GLOBAL
    bud = tuple(SHORT[k] for k in ("max_iterations", "qp_iterations", "ls_iterations", "line_search", "barrier"))
    data, x0 = chain_closure_instances(B, N, closures, seed=N)
    # A NaN start (a NaN measurement leaves the Gauss-Newton matrix finite,
    # and two iterations do not push lambda past its cap to flag the lane).
    x0[5, 4] = np.nan
    for dtype in (torch.float64, torch.float32):
        d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
        plan = blk.launch_plan(blk.slab_shape(pose_global), B, dtype)
        before = blk.GENERATED_LAUNCHES
        got = blk._blocked_solve_cuda(pose_global, d_t, x_t, *bud)
        torch.cuda.synchronize()
        if blk.GENERATED_LAUNCHES != before + 1 or plan.storage != "global":
            fail(f"phase42 generated pose N={N}: not one launch on the global route ({plan})")
        check_blocked(f"phase42 generated pose chain N={N} + {closures} (D={3 * N}) 2/1/1 B={B} ({plan.storage}, "
                      f"{plan.rows_per_lane} rows/lane, {plan.warp_bytes} B a slab)", got,
                      blk._blocked_solve_plain(pose_global, d_t, x_t, *bud), max_err, (5,))
    CLOCK.mark("phase 42 (bit for bit)")

    data, x0 = medium_n_planar_instances(WIDE_B, GLOBAL_N, seed=0)
    t32, x32 = (a.astype(np.float32) for a in (data, x0))
    reset_counts()
    x, state = mot.fused_ik_solve_batch(t32, x32, return_state=True, **ARM)
    torch.cuda.synchronize()
    got = counts()
    if got["blocked"] != 1 or sum(got.values()) != 1:
        fail(f"phase42 n={GLOBAL_N}: launches {got}, expected one kernel-2 launch")
    parity = cell_gate(f"phase42 fused_ik_solve_batch planar n={GLOBAL_N} (D=256) B={WIDE_B} float32 6/3/2, the "
                       f"global route (launches {got})", "planar", x, data, refs["planar255"].get())
    family = fik.planar_family(GLOBAL_N, LINK)
    d_t, x_t = mot.batch_from_numpy(t32, x32, "cuda")
    plan = blk.launch_plan(blk.slab_shape(family), WIDE_B, torch.float32)
    # The plain version on the first PLAIN_LANES lanes (slice 17 cut its
    # 8,192-lane call: a (256, 256, B) tensor an operation).
    lanes = 64
    d_p, x_p = d_t[:, :PLAIN_LANES].contiguous(), x_t[:, :PLAIN_LANES].contiguous()
    plain = lambda: blk._blocked_solve_plain(family, d_p, x_p, *ARM_ARGS)  # noqa: E731
    row, want = cell_times(
        f"phase42 kernel 2 planar n={GLOBAL_N} (D=256) B={WIDE_B} float32 6/3/2, {plan.slabs} slabs of "
        f"{plan.warp_bytes} B, {plan.rows_per_lane} rows/lane, on {kind} ({card}; plain on {PLAIN_LANES} lanes)",
        lambda: blk._blocked_solve_cuda(family, d_t, x_t, *ARM_ARGS), plain,
        lambda: (lanes, count_ops(lambda: blk._blocked_solve_plain(family, d_t[:, :lanes].contiguous(),
                                                                 x_t[:, :lanes].contiguous(), *ARM_ARGS))),
        WIDE_B, (2 + GLOBAL_N + GLOBAL_N + 3) * 4, launches=1, repeats=2)
    check_blocked(f"phase42 n={GLOBAL_N} cell B={WIDE_B}, its first {PLAIN_LANES} lanes",
                  (x.T[:, :PLAIN_LANES], state.T[:, :PLAIN_LANES]), want, max_err)
    row["plain_lanes"] = PLAIN_LANES
    CLOCK.mark("phase 42")
    return dict(row, launches=got["blocked"], parity=parity, max_err=max_err)


def table_ring_paths(card, kind):
    """Phase 43: kernel 7's run-time route on topologies (i)-(iii) against its
    plain version bit for bit (B = 1037 with a NaN-measurement and a
    NaN-start lane, B = 1 and W + 1 against the same plain call's lanes;
    float64, and (iii) in float32 too); then (i) and (ii) through
    solve_pose_graph_rings at full width in float32, bit for bit."""
    max_err = {"float64": 0.0, "float32": 0.0}
    iters, ls = RING_BUDGET
    ops = {}
    for name, n, closures in TABLE_CASES:
        fam, data, x0 = ring_case(n, closures, TABLE_B, seed=n)
        data[5, 4] = np.nan
        x0[9, 2] = np.nan
        k = pr.table_route(fam.closure_list)
        # (i) and (ii) in float32 at their full-width cells below (slice 17
        # cut their plain calls here; a plain call costs its operations).
        for dtype in (torch.float64,) if name in CELL_TOPOLOGIES else (torch.float64, torch.float32):
            d_t, x_t = mot.batch_from_numpy(data, x0, "cuda", dtype)
            W = pr.launch_plan(n, len(closures), 1, dtype, k).warps
            before = pr.KERNEL_LAUNCHES
            runs = [(Bc, pr._pose_ring_cuda(fam, d_t[:, :Bc].contiguous(), x_t[:, :Bc].contiguous(), iters, ls))
                    for Bc in (TABLE_B, 1, W + 1)]
            torch.cuda.synchronize()
            if pr.KERNEL_LAUNCHES != before + 3 or not k:
                fail(f"phase43 {name}: not three launches on the run-time route (k = {k})")
            out = []
            # The cells' operation counts come from this call: a lane's
            # operations do not depend on B or the type.
            count = count_ops(lambda: out.append(pr._pose_ring_plain(fam, d_t, x_t, iters, ls)))
            ops[name] = count / TABLE_B
            want = out[0]
            plan = pr.launch_plan(n, len(closures), TABLE_B, dtype, k)
            for Bc, got in runs:
                check_ring(f"phase43 {name} N={n} 6/2 B={Bc} ({plan.storage}, {W} graphs/CTA, {plan.warp_bytes} B a "
                           f"graph)", got, tuple(t[:, :Bc] for t in want), max_err, (5, 9) if Bc == TABLE_B else ())
    CLOCK.mark("phase 43 (bit for bit)")

    rows = {}
    for name, n, closures in TABLE_CASES:
        if name not in CELL_TOPOLOGIES:
            continue
        fam, data, x0 = ring_case(n, closures, RING_B, seed=0)
        meas = data.astype(np.float32).reshape(RING_B, -1, 3)
        starts = x0.astype(np.float32).reshape(RING_B, n, 3)
        reset_counts()
        x, state = pg.solve_pose_graph_rings(meas, starts, closures=closures, max_iterations=iters,
                                             ls_iterations=ls, return_state=True)
        torch.cuda.synchronize()
        got = counts()
        if got["pose_ring"] != 1 or sum(got.values()) != 1:
            fail(f"phase43 {name}: launches {got}, expected one pose-ring launch")
        f = state[:, 0].double().cpu().numpy()
        share = float(np.mean(f < 2e-3 * n))
        print(f"# phase43 solve_pose_graph_rings {name} N={n} B={RING_B} float32 6/2: launches {got}; converged "
              f"share (cost < {2e-3 * n:.3g}) {share:.6f}, cost median {np.median(f):.4e}, lanes flagged "
              f"{int((state[:, 2] != 0).sum())}, all finite {bool(torch.isfinite(x).all())}", flush=True)
        if not share >= 0.99:
            fail(f"phase43 {name}: converged share {share} is below 0.99")
        d_t = torch.as_tensor(meas.reshape(RING_B, -1), device="cuda").T.contiguous()
        x_t = torch.as_tensor(starts.reshape(RING_B, -1), device="cuda").T.contiguous()
        plain = lambda: pr._pose_ring_plain(fam, d_t, x_t, iters, ls)  # noqa: E731
        E = fam.n_edges
        row, want = cell_times(
            f"phase43 kernel 7 {name} N={n} B={RING_B} float32 6/2 on {kind} ({card})",
            lambda: pr._pose_ring_cuda(fam, d_t, x_t, iters, ls), plain, lambda: (1, ops[name]),
            RING_B, (3 * E + 3 * n + 3 * n + 3) * 4, launches=10)
        check_ring(f"phase43 {name} cell B={RING_B}", (x.reshape(RING_B, -1).T, state.T), want, max_err)
        rows[name] = dict(row, launches=got["pose_ring"], converged_share=share)
    CLOCK.mark("phase 43")
    return rows, max_err


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
    # Phase 32's traces, then phases 29-31's and 33-34's float64 CPU
    # references, in worker processes beside the card's runs; every worker
    # is stopped on the way out, failed or not.
    pool = multiprocessing.get_context("spawn").Pool(2 * len(RETRACT_NS))
    try:
        builder = RetractBuild(retract_traces(pool))
        builder.start()
        run_phases(card, kind, builder, pool)
    finally:
        pool.terminate()
        pool.join()


def run_phases(card, kind, retract_builder, pool):
    """Phases 2-43."""
    # Phases 40-42's float64 CPU references, in the worker pool.
    size_refs = size_references(pool)
    # Phase 2: build. Phase 21's generated families and phase 25's pose
    # families are emitted and built at the same time: every nvcc process of
    # both runs at once.
    t0 = time.perf_counter()
    families = generated_families()
    poses = pose_families()
    pose_global = global_pose_family()
    emitters = {name: fam.cuda_program.source for name, (fam, _, _) in families.items()}
    emitters.update(pose_emitters(poses))
    emitters[f"pose N={POSE_GLOBAL[0]} (global route)"] = pose_global.cuda_program.blocked_source
    with concurrent.futures.ThreadPoolExecutor(2) as emit_pool:
        generated = emit_pool.submit(emit_and_build, emitters)
        instances = emit_pool.submit(_build.build_fused_ik, kernel1_instances())
        lib_path = _build.build()
        gen_emit_s, gen_build_s, gen_paths = generated.result()
        ik_paths = instances.result()
    _build.load_library()
    print(f"# build: {time.perf_counter() - t0:.1f} s -> {lib_path.name} (with {len(gen_paths)} generated "
          f"families and {len(ik_paths)} kernel-1 instances)", flush=True)
    seconds = lib_path.with_suffix(".seconds")
    if seconds.exists():
        print("# build seconds per source: " + ", ".join(seconds.read_text().split("\n")).strip(", "), flush=True)
    # Phase 2: kernel 1's instances (family, n, type), one library each
    # (phase 40 builds its own).
    print_instances(kernel1_instances(), ik_paths, "phase2")
    log = lib_path.with_suffix(".log")
    if log.exists():
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spilling = sum(int(b) > 0 for b in re.findall(r"(\d+) bytes spill stores", text))
        print(f"# ptxas: {len(regs)} kernel instances, registers max {max(regs, default=0)}, "
              f"{spilling} with spill stores", flush=True)
        # Phase 8's build lines: the blocked kernels, from the same build.
        for name, nreg, spill, _, stack in ptxas_report(text):
            m = re.search(r"blocked_(sqp|sqp_global|kkt_warp|kkt)_kernelI([fd])(?:Li(\d+)E)?", name)
            if m:
                kernel, t, rows = m.groups()
                fam = re.search(r"(Planar|Spatial)Chain", name)
                label = (f"blocked_{kernel}<{'float' if t == 'f' else 'double'}" + (f", R={rows}" if rows else "")
                         + (f", {fam.group()}" if fam else "") + ">")
                print(f"# phase8 ptxas {label}: {nreg} registers, {spill} bytes spill stores, {stack} bytes "
                      f"stack frame", flush=True)
        # Phase 9: the general path's kernels, from the same build. Kernels
        # 4 and 5's register route must not spill: its cap is set by that.
        for name, nreg, spill, _, stack in ptxas_report(text):
            m = re.search(r"(ldlt_factor_reg|ldlt_solve_reg|ldlt_factor|ldlt_solve|fused_qp)_kernelI([fd])"
                          r"(?:Li(\d+)E)?(?:Li(\d+)E)?", name)
            if m:
                kernel, t, n, k = m.groups()
                dims = "" if n is None else (f", D={n}" if k is None else f", N={n}, K={k}")
                rows = re.search(r"PairRows|AnyRows", name)
                dims += f", {rows.group()}" if rows else ""
                label = f"{kernel}<{'float' if t == 'f' else 'double'}{dims}>"
                print(f"# phase9 ptxas {label}: {nreg} registers, {spill} bytes spill stores, {stack} bytes "
                      f"stack frame", flush=True)
                if kernel.endswith("_reg") and spill:
                    fail(f"phase9: {label} spills {spill} bytes; lower ldlt.REGISTER_MAX_D")
                if kernel == "fused_qp" and t == "f" and rows and rows.group() == "PairRows" and spill and (
                        n == "1" or k == "2"):
                    fail(f"phase9: {label} spills {spill} bytes; lower fused_qp.REGISTER_MAX_N")
            m = re.search(r"fused_qp_warp_kernelI([fd])", name)
            if m:
                print(f"# phase36 ptxas fused_qp_warp<{'float' if m.group(1) == 'f' else 'double'}>: {nreg} "
                      f"registers, {spill} bytes spill stores, {stack} bytes stack frame", flush=True)
        # Phase 17: the MPC kernels, from the same build.
        mpc_build_report(text)
        # Phase 13: the pose-ring kernel, from the same build.
        for name, nreg, spill, _, stack in ptxas_report(text):
            m = re.search(r"pose_ring_kernelI([fd])Li(\d+)E", name)
            if m:
                t, k = m.groups()
                print(f"# phase13 ptxas pose_ring<{'float' if t == 'f' else 'double'}, K={k}>: {nreg} "
                      f"registers, {spill} bytes spill stores, {stack} bytes stack frame", flush=True)

    print(f"# phase9 LDL^T register route up to D = {ldlt.REGISTER_MAX_D}; launch plan at B = {GENERAL_B}, "
          f"D = 3: {ldlt.ldlt_launch_plan(3, GENERAL_B)}", flush=True)

    CLOCK.mark("phases 1-2 and 9 (the build)")

    # Phase 3: kernel vs plain version on the card.
    max_err = {"float64": 0.0, "float32": 0.0}
    ik_vs_plain(max_err)
    CLOCK.mark("phase 3")

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
        family = fik.planar_family(2, LINK)
        entry = lambda: mot.fused_ik_solve_batch(t_d, x_d, link_len=LINK, **BENCH)  # noqa: E731
        kernel = lambda: fik._fused_solve_cuda(family, t_d, x_d, 4, 2, 1, "armijo", "mpc", False)  # noqa: E731
        e2e_ms, e2e_all = time_ms(entry)
        dev_ms, dev_all = time_ms(entry, held=True)
        kern_ms, kern_all = time_ms(kernel, held=True)
        # One entry-point call on card tensors is one device kernel: the
        # kernel reads and writes batch-major, and nothing is copied.
        before = fik.KERNEL_LAUNCHES
        entry()
        torch.cuda.synchronize()
        if fik.KERNEL_LAUNCHES != before + 1:
            fail(f"phase4 B={B}: a fused_ik_solve_batch call did not launch the kernel once")
        kernels_a_call(f"phase4 fused_ik_solve_batch B={B} float32 on card tensors (3 before: two copies)", entry,
                       (r"fused_ik_kernel",))
        rows[B] = dict(parity=parity, kernel_ms=kern_ms)
        print(f"# phase4 B={B} float32 on {kind} ({card}): parity {parity:.6f} (max err {err.max():.3e}), "
              f"status satisfied {satisfied:.6f}; entry point issued back to back {e2e_ms:.4f} ms/call "
              f"({B / e2e_ms * 1e3:.4e} solves/s), its device work {dev_ms:.4f} ms in 1 device "
              f"kernel a call, kernel alone on the card {kern_ms:.4f} ms ({B / kern_ms * 1e3:.4e} solves/s); "
              f"repeats: entry {e2e_all} device {dev_all} kernel {kern_all}", flush=True)
    # One instance's latency: the kernel alone at B = 1.
    t1, x1 = (torch.as_tensor(a[:1], dtype=torch.float32, device="cuda") for a in inst[8192])
    one_ms, one_all = time_ms(lambda: fik._fused_solve_cuda(
        fik.planar_family(2, LINK), t1, x1, 4, 2, 1, "armijo", "mpc", False), held=True)
    rows[1] = dict(kernel_ms=one_ms)
    print(f"# phase4 B=1 float32 on {kind} ({card}): kernel alone on the card {one_ms:.5f} ms "
          f"(held; repeats {one_all})", flush=True)
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

    CLOCK.mark("phase 4")

    blocked_rows = blocked_paths(card, kind)
    CLOCK.mark("phase 8")
    general_rows = general_paths(card, kind)
    CLOCK.mark("phase 12")
    ring_rows = pose_ring_paths(card, kind)
    CLOCK.mark("phase 16")
    mpc_rows = mpc_paths(card, kind)
    CLOCK.mark("phase 20")
    generated_build_report(families, sum(gen_emit_s[name] for name in families), gen_build_s, gen_paths)
    gen_err = {"float64": 0.0, "float32": 0.0}
    generated_rows = [generated_paths(card, kind, families, gen_err)]
    CLOCK.mark("phase 24 (and 21)")
    pose_report(poses, gen_emit_s, gen_build_s, gen_paths)
    pose_rows = pose_paths(card, kind, poses)
    CLOCK.mark("phases 27-28 (and 25)")
    cg_paths(card, pool)
    retract_err = {"float64": 0.0, "float32": 0.0}
    blocked_rows[0]["generated_retract_launches"] = retract_paths(retract_builder, retract_err)
    blocked_rows[0]["generated_retract_max_abs_err"] = max(retract_err.values())
    CLOCK.mark("phase 32")
    obstacle_launches = obstacle_path(card, kind, pool)
    CLOCK.mark("phase 33")
    implicit_launches, implicit_times = implicit_path(card, kind, pool)
    CLOCK.mark("phase 34")
    tuner_launches = tuner_path(card, kind, families, poses)
    CLOCK.mark("phase 35")
    qp6_err = {"float64": 0.0, "float32": 0.0}
    qp6_new_routes(qp6_err)
    CLOCK.mark("phase 36")
    arm_row = arm_general_path(card, kind, blocked_rows[0]["parity"])
    CLOCK.mark("phase 37")
    ls_launches = line_search_paths(card, kind)
    CLOCK.mark("phase 38")
    history_launches = history_path(card, kind)
    CLOCK.mark("phase 39")
    ik_row = ik_sizes_paths(card, kind, size_refs)
    spatial_row = spatial_chain_paths(card, kind, size_refs)
    global_row = global_route_paths(card, kind, size_refs, pose_global)
    table_rows, table_err = table_ring_paths(card, kind)

    # This slice's launches, in the rows of the kernels its paths ran.
    tuned = lambda *pairs: {f: tuner_launches[f][k] for f, k in pairs}  # noqa: E731
    slice15 = {
        "blocked_sqp": tuned(("arm_n48", "blocked")),
        "ldlt_factor": {"obstacle_ik_lifted": obstacle_launches["ldlt_factor"],
                        "implicit_ik_limit": implicit_launches["ldlt_factor"]},
        "ldlt_solve": {"obstacle_ik_lifted": obstacle_launches["ldlt_solve"],
                       "implicit_ik_limit": implicit_launches["ldlt_solve"]},
        "pose_ring": tuned(("pose_ring_n16", "pose_ring")),
        "mpc_solve": tuned(("mpc_servo_T20", "mpc")),
        "mpc_servo": tuned(("mpc_servo_T20", "mpc_servo")),
    }
    for row in blocked_rows + general_rows + ring_rows + mpc_rows:
        if row["name"] in slice15:
            row["slice15_launches"] = slice15[row["name"]]
    # Slice 16's launches (phases 37-39) in the rows of kernels 4, 5 and 6.
    for row in general_rows:
        key = {"ldlt_factor": "ldlt_factor", "ldlt_solve": "ldlt_solve", "fused_qp": "fused_qp"}[row["name"]]
        row["slice16_launches"] = {f"general cell {variant}": got.get(key, 0) for variant, got in ls_launches.items()
                                   if got.get(key, 0)}
        if row["name"] == "fused_qp":
            row["slice16_launches"]["arm n=48 general path (warp route)"] = arm_row["arm_launches"]
            row["max_abs_err"] = max(row["max_abs_err"], max(qp6_err.values()))
            row["max_abs_diff_f64"] = max(row["max_abs_diff_f64"], qp6_err["float64"])
            row["warp_route_source"] = "mini_opt_tpu_torch/csrc/fused_qp_warp.cu"
            row.update(arm_row)
        else:
            row["slice16_launches"]["history float64 B=64"] = history_launches.get(key, 0)
    general_rows[0]["implicit_backward"] = implicit_times
    # Slice 17's cells (phases 40-43) in the rows of kernels 1, 2 and 7.
    for row in blocked_rows + ring_rows:
        if row["name"] == "blocked_sqp":
            row["slice17"] = {"spatial n=48 B=8192 float32 6/3/2": spatial_row,
                              f"planar n={GLOBAL_N} global route B=8192 float32 6/3/2": global_row}
            row["spatial_source"] = "mini_opt_tpu_torch/csrc/blocked_spatial.cu"
            for r in (spatial_row, global_row):
                row["max_abs_err"] = max(row["max_abs_err"], max(r.pop("max_err").values()))
        if row["name"] == "pose_ring":
            row["slice17"] = {f"{name} B=8192 float32 6/2": r for name, r in table_rows.items()}
            row["max_abs_err"] = max(row["max_abs_err"], max(table_err.values()))
    ik_err = ik_row.pop("max_err")
    print(f"# chip_smoke.py: {time.perf_counter() - t0:.1f} s from the build's start; seconds per phase "
          f"{json.dumps(CLOCK.summary())}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_ik_sqp",
        "route": "cuda",
        "source": "mini_opt_tpu_torch/csrc/fused_ik.cu",
        "replaces": "mini_opt_tpu/ops/pallas_ik.py:323",
        "function": "_make_kernel",
        "launches": launches,
        "max_abs_err": max(max(max_err.values()), max(ik_err.values())),
        "max_abs_diff_f64": max(max_err["float64"], ik_err["float64"]),
        "ms": rows[B]["kernel_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"B={B} n=2 float32 4/2/1 mpc armijo",
        "ms_b1": rows[1]["kernel_ms"],
        "ms_b262144": rows[262144]["kernel_ms"],
        "ops_per_instance": ops_per_instance,
        "slice15_launches": tuned(("spatial_ik", "fused_ik"), ("planar_ik", "fused_ik_generated"),
                                  ("pose_graph_n4", "fused_ik_generated")),
        "slice17": {f"planar n={WIDE_N} B=8192 float32 6/3/2": ik_row},
        "card": card,
    }] + generated_rows + blocked_rows + general_rows + ring_rows + mpc_rows + pose_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
