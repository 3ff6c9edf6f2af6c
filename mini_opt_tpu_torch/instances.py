"""Seeded IK instances and the effector error that judges a solve, in numpy.

``planar_instances`` is a copy of the JAX repo's bench generator
(``bench.py::make_instances``): reachable planar targets with warm starts.
``spatial_instances`` draws targets from random joint angles of the
alternating z/y-axis chain, the JAX package's spatial test distribution.
``medium_n_planar_instances`` is a copy of the warm-start serving
distribution of the JAX repo's medium-N example
(``examples/blocked_medium_n.py:53-61``). All return float64 ``(B, rows)``
targets and ``(B, n)`` starts; a caller casts them to its working dtype.

``ring_instances`` and ``chain_closure_instances`` are copies of the JAX
repo's pose-ring bench distributions (``scripts/bench_extras.py``:
``pose_ring_bench`` :867-883 and ``pose_ring_chain_closure_bench``
:1299-1320): float64 ``(B, 3E)`` edge measurements and ``(B, 3N)`` starts.

``cartpole_mpc_instances`` and ``quadrotor_mpc_instances`` are copies of the
JAX repo's MPC fleet distributions (``scripts/bench_extras.py``:
``mpc_servo_bench`` :770-780 and ``mpc_quadrotor_bench`` :1209-1213):
float64 ``(B, nx)`` plant states.

Two problem builders for ``family_from_problem`` beside the IK ones, the
JAX package's generated-family test problems (``tests/test_fused_auto.py``):
``block_chain_problem`` (BlockResidual costs and equalities, a one-sided
bound; :251-295, with ``block_chain_instances``) and
``robust_line_fit_problem`` (four Huber-robustified line-fit samples, no
equality row and no bound; :438-455, with ``robust_line_fit_instances``).

``obstacle_ik_problem`` (with ``obstacle_ik_targets``, ``_base_problem``,
``_rows``, ``_params`` and ``_checks``) is the JAX repo's
``examples/obstacle_ik.py`` as a per-lane ``data_row ->
NonlinearInequalityProblem`` function, the data row the target and the
keep-out centre.

``circle_graph`` and ``helix_graph`` are copies of the JAX repo's large
pose-graph test graphs (``tests/test_pose_graph.py::_circle_graph`` :127,
``tests/test_pose_graph3.py::_helix_graph`` :26), which its benches
(``scripts/bench_extras.py``: ``pose_graph_bench`` :200,
``pose_graph_scale_bench`` :301, ``pose_graph3_bench`` :367) solve:
``(gt (N, d), edges (E, 2), meas (E, d), x0 (N, d))``, float64 numpy.
The helix's quaternion arithmetic is the port's ``utils/so3.py`` on CPU
float64 tensors.
"""

from __future__ import annotations

import numpy as np


def planar_instances(B, n, seed=0, link_len=0.4):
    """Reachable targets well inside the workspace; for n = 2 a closed-form
    elbow guess perturbed by +-0.3 rad, else fixed starts."""
    rng = np.random.default_rng(seed)
    L = link_len
    reach = L * n
    radius = rng.uniform(0.55, 0.95, B) * reach
    angle = rng.uniform(0.25, 1.25, B)
    tx, ty = radius * np.cos(angle), radius * np.sin(angle)
    targets = np.stack([tx, ty], axis=1)
    if n == 2:
        r2 = tx**2 + ty**2
        c1 = np.clip((r2 - 2 * L * L) / (2 * L * L), -1.0, 1.0)
        th1 = np.arccos(c1)
        th0 = np.arctan2(ty, tx) - np.arctan2(L * np.sin(th1), L + L * np.cos(th1))
        x0 = np.stack([th0, th1], axis=1) + rng.uniform(-0.3, 0.3, (B, 2))
        x0[:, 1] = np.clip(x0[:, 1], 0.05, np.pi - 0.05)
    else:
        x0 = np.full((B, n), 0.6)
        x0[:, 0] = angle - 0.3
    return targets, x0


def medium_n_planar_instances(B, n=48, seed=0, link_len=0.4):
    """A reference pose per instance (joints 1..n-1 near 0.06 rad, joint 0
    in [-0.3, 0.3]) as the warm start, and a target a small task step
    (+-0.05 per axis) from its effector."""
    rng = np.random.default_rng(seed)
    th_ref = np.clip(
        rng.uniform(0.02, 0.10, (B, n)) + rng.normal(0, 0.01, (B, n)),
        0.01, np.pi - 0.01,
    )
    th_ref[:, 0] = rng.uniform(-0.3, 0.3, B)
    targets = planar_fk(th_ref, link_len) + rng.uniform(-0.05, 0.05, (B, 2))
    return targets, th_ref


def planar_fk(th, link_len=0.4):
    """Effector ``(B, 2)`` of the planar chain of joint angles ``th (B, k)``,
    float64 numpy."""
    phi = np.cumsum(np.asarray(th, np.float64), axis=1)
    return link_len * np.stack([np.cos(phi).sum(1), np.sin(phi).sum(1)], 1)


def spatial_fk(th, link_len=0.4):
    """Effector of the alternating z/y-axis chain (links along local x) at
    joint angles ``th (B, n)``."""
    B, n = th.shape
    R = np.broadcast_to(np.eye(3), (B, 3, 3)).copy()
    p = np.zeros((B, 3))
    for a in range(n):
        c, s = np.cos(th[:, a]), np.sin(th[:, a])
        rot = np.zeros((B, 3, 3))
        if a % 2 == 0:  # about z
            rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1
        else:  # about y
            rot[:, 0, 0], rot[:, 0, 2], rot[:, 2, 0], rot[:, 2, 2], rot[:, 1, 1] = c, s, -s, c, 1
        R = R @ rot
        p = p + link_len * R[:, :, 0]
    return p


def spatial_instances(B, n, seed=0, link_len=0.4):
    """Targets reached by random joint angles; starts perturbed by
    +-0.25 rad and kept inside the [0, pi] limits of joints 1..n-1."""
    rng = np.random.default_rng(seed)
    th = np.stack(
        [rng.uniform(-1.2, 1.2, B)] + [rng.uniform(0.25, 2.6, B) for _ in range(n - 1)], 1
    )
    x0 = th + rng.uniform(-0.25, 0.25, (B, n))
    x0[:, 1:] = np.clip(x0[:, 1:], 0.05, np.pi - 0.05)
    return spatial_fk(th, link_len), x0


def ring_instances(B, n, seed=0, start_noise=0.15):
    """The canonical N-pose ring (unit steps, turn 2 pi / N per edge): the
    true measurements plus N(0, 0.02) noise, and the true poses plus
    N(0, start_noise) as starts."""
    turn = 2 * np.pi / n
    meas = np.tile([1.0, 0.0, turn], (n, 1))
    th = np.arange(n) * turn
    pts = np.zeros((n, 2))
    for i in range(1, n):
        pts[i] = pts[i - 1] + [np.cos(th[i - 1]), np.sin(th[i - 1])]
    truth = np.column_stack([pts, np.where(th > np.pi, th - 2 * np.pi, th)])
    rng = np.random.default_rng(seed)
    data = meas.ravel() + rng.normal(0, 0.02, (B, 3 * n))
    x0 = truth.ravel() + rng.normal(0, start_noise, (B, 3 * n))
    return data, x0


def chain_edges(n, closures):
    """The odometry chain (t, t+1) followed by the closures."""
    return tuple((t, t + 1) for t in range(n - 1)) + tuple(tuple(c) for c in closures)


def chain_closure_instances(B, n, closures, seed=0, step=0.5, start_noise=0.08, meas_noise=0.02):
    """A wandering chain (headings a running sum of U(-0.5, 0.5), steps of
    ``step``) with consistent measurements on the chain edges and the
    closures plus N(0, meas_noise) noise; starts are the true poses plus
    N(0, start_noise), with pose 0 set to the origin."""
    rng = np.random.default_rng(seed)
    th = np.cumsum(rng.uniform(-0.5, 0.5, (B, n)), axis=1)
    xy = np.cumsum(np.stack([np.cos(th), np.sin(th)], -1) * step, axis=1)
    poses = np.concatenate([xy, th[..., None]], -1)

    def edge_meas(pi, pj):
        c, s = np.cos(pi[..., 2]), np.sin(pi[..., 2])
        dx = pj[..., 0] - pi[..., 0]
        dy = pj[..., 1] - pi[..., 1]
        return np.stack([c * dx + s * dy, -s * dx + c * dy, pj[..., 2] - pi[..., 2]], -1)

    edges = chain_edges(n, closures)
    meas = np.stack([edge_meas(poses[:, i], poses[:, j]) for (i, j) in edges], 1)
    meas += rng.normal(scale=meas_noise, size=meas.shape)
    x0 = poses + rng.normal(scale=start_noise, size=poses.shape)
    x0[:, 0] = 0.0
    return meas.reshape(B, 3 * len(edges)), x0.reshape(B, 3 * n)


def effector_error(kind, x, targets, link_len=0.4):
    """Max-abs effector error per instance of solutions ``x (B, n)``, in
    float64; ``kind`` is "planar" or "spatial". The bench's parity counts
    instances under 1e-3."""
    x = np.asarray(x, np.float64)
    targets = np.asarray(targets, np.float64)
    p = planar_fk(x, link_len) if kind == "planar" else spatial_fk(x, link_len)
    return np.abs(p - targets).max(axis=1)


def cartpole_mpc_instances(B, seed=0):
    """Cart-pole plant states (p, v, theta, w) uniform in +-0.2, +-0.2,
    +-0.35, +-0.2."""
    rng = np.random.default_rng(seed)
    return np.column_stack(
        [
            rng.uniform(-0.2, 0.2, B),
            rng.uniform(-0.2, 0.2, B),
            rng.uniform(-0.35, 0.35, B),
            rng.uniform(-0.2, 0.2, B),
        ]
    )


def quadrotor_mpc_instances(B, seed=0):
    """Planar-quadrotor states (x, y, theta, vx, vy, omega): position
    uniform in +-0.4, heading in +-0.25, at rest."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 6))
    x0[:, 0] = rng.uniform(-0.4, 0.4, B)
    x0[:, 1] = rng.uniform(-0.4, 0.4, B)
    x0[:, 2] = rng.uniform(-0.25, 0.25, B)
    return x0


def block_chain_problem(data):
    """Four variables: an anchor cost on x0, three difference-tracking
    blocks x_{i+1} - x_i = d_i (one BlockResidual with per-block data), two
    product equalities x0 x1 = v0, x2 x3 = v1 (one BlockResidual) and
    x0 >= 0.1. data rows: [t, d0, d1, d2, v0, v1]."""
    import torch

    from .nonlinear import Problem
    from .qp import Var
    from .residual import BlockResidual, make_residual

    diffs = torch.stack([data[1], data[2], data[3]])[:, None]  # (3, 1)
    prods = torch.stack([data[4], data[5]])[:, None]  # (2, 1)
    return Problem(
        dimension=4,
        costs=(
            make_residual([0], lambda p: torch.stack([p[0] - data[0]]), 1),
            BlockResidual(
                fn=lambda p, d: torch.stack([p[1] - p[0] - d[0]]),
                indices=((0, 1), (1, 2), (2, 3)),
                dim=1,
                data=diffs,
            ),
        ),
        equality_constraints=(
            BlockResidual(
                fn=lambda p, d: torch.stack([p[0] * p[1] - d[0]]),
                indices=((0, 1), (2, 3)),
                dim=1,
                data=prods,
            ),
        ),
        inequality_constraints=(Var(0) >= 0.1,),
    )


def block_chain_instances(B, seed=5):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.6, 1.2, B)
    d = rng.uniform(-0.2, 0.2, (B, 3))
    v = rng.uniform(0.4, 1.1, (B, 2))
    data = np.concatenate([t[:, None], d, v], axis=1)
    x0 = np.column_stack([t, v[:, 0] / t, np.maximum(t + d[:, 1], 0.4), np.ones(B)])
    x0[:, 3] = v[:, 1] / x0[:, 2]
    return data, x0


LINE_FIT_TS = (0.0, 0.5, 1.0, 1.5)


def robust_line_fit_problem(data):
    """Fit y = p0 + p1 t to the samples data[k] at t = LINE_FIT_TS[k], each
    residual wrapped in a Huber loss (delta 0.5): two variables, no equality
    row, no bound."""
    import torch

    from .nonlinear import Problem
    from .residual import make_residual, robustify

    return Problem(
        dimension=2,
        costs=tuple(
            robustify(
                make_residual([0, 1], lambda p, k=k, t=t: torch.stack([p[0] + p[1] * t - data[k]]), 1),
                kind="huber",
                delta=0.5,
            )
            for k, t in enumerate(LINE_FIT_TS)
        ),
    )


def robust_line_fit_instances(B, seed=5):
    """Samples of lines y = a + b t with unit noise and starts about them."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, (B, len(LINE_FIT_TS))), rng.normal(0.0, 1.0, (B, 2))


# examples/obstacle_ik.py of the JAX repo at its full width: a 3-link arm of
# OBSTACLE_LINK links, its effector x held by an equality and y by a cost, a proximal
# cost of weight 0.05 about X_REF, and the elbow kept out of a disk of radius
# 0.15 (a nonlinear inequality, slack-lifted).
OBSTACLE_LINK = 0.4
OBSTACLE_TARGET = (0.9, 0.35)
OBSTACLE_X_REF = (0.2, 0.2, 0.2)
OBSTACLE_RADIUS = 0.15
OBSTACLE_PROX = 0.05
_OBSTACLE_CHAINS = {}


def obstacle_ik_targets(B, seed=0):
    """Targets uniform in +-0.05 about the example's (0.9, 0.35), float64
    ``(B, 2)``."""
    rng = np.random.default_rng(seed)
    return np.asarray(OBSTACLE_TARGET) + rng.uniform(-0.05, 0.05, (B, 2))


def obstacle_ik_params(kkt_solver="auto"):
    """The example's solver configuration."""
    from .nonlinear import NLSParams
    from .structs import InitialGuessMethod

    return NLSParams(
        max_iterations=60,
        max_qp_iterations=10,
        max_line_search_iterations=5,
        relative_exit_tol=0.0,
        qp_initial_guess_method=InitialGuessMethod.NAIVE,
        kkt_solver=kkt_solver,
    )


def _obstacle_chains(like):
    """(arm, elbow) chains in ``like``'s dtype and device, made once."""
    from .models.ik import make_planar_chain

    key = (like.dtype, like.device)
    if key not in _OBSTACLE_CHAINS:
        _OBSTACLE_CHAINS[key] = (
            make_planar_chain(3, OBSTACLE_LINK, dtype=like.dtype, device=like.device),
            make_planar_chain(2, OBSTACLE_LINK, dtype=like.dtype, device=like.device),
        )
    return _OBSTACLE_CHAINS[key]


def obstacle_ik_base_problem(target):
    """The example's problem of one instance (``target (2,)``) without the
    keep-out: effector x held, y pulled, the proximal cost. Its solve places
    the keep-out disk on the elbow, as ``tests/test_implicit.py:260`` does
    (the example's own first solve, without the proximal cost, is singular
    along the arm's self-motion and ends QP_INDEFINITE at a point that
    rounding decides)."""
    import torch

    from .models.ik import make_ik_problem
    from .nonlinear import Problem
    from .residual import make_residual

    base = make_ik_problem(_obstacle_chains(target)[0], target, with_joint_limits=False)
    x_ref = torch.as_tensor(OBSTACLE_X_REF, dtype=target.dtype, device=target.device)
    w = torch.full((), OBSTACLE_PROX, dtype=target.dtype, device=target.device)
    prox = make_residual((0, 1, 2), lambda p: w * (p - x_ref), 3)
    return Problem(dimension=3, costs=base.costs + (prox,), equality_constraints=base.equality_constraints)


def obstacle_ik_problem(row):
    """The example's lifted problem of one instance, ``row = (target x, y,
    keep-out centre x, y)``: a ``NonlinearInequalityProblem``."""
    import torch

    from .ineq import with_nonlinear_inequalities
    from .residual import make_residual

    elbow = _obstacle_chains(row)[1]
    r2 = torch.full((), OBSTACLE_RADIUS * OBSTACLE_RADIUS, dtype=row.dtype, device=row.device)
    centre = row[2:4]

    def keep_out(p2):
        d = elbow.effector(p2).translation[:2] - centre
        return torch.stack([d @ d - r2])

    return with_nonlinear_inequalities(obstacle_ik_base_problem(row[:2]), (make_residual((0, 1), keep_out, 1),))


def obstacle_ik_rows(targets, x_base):
    """Data rows ``(B, 4)``: each target beside the elbow of its base solve
    ``x_base (B, 3)``, the keep-out centre (tensors)."""
    import torch

    elbow = _obstacle_chains(x_base)[1]
    centres = torch.func.vmap(lambda p: elbow.effector(p).translation[:2])(x_base[:, :2])
    return torch.cat([targets, centres], 1)


def obstacle_ik_checks(x_aug, rows):
    """The example's asserts per lane, float64 numpy: (effector x within
    1e-6, effector y within 1e-2, g >= -1e-6, elbow outside the disk), each
    ``(B,)`` bool, and g ``(B,)``."""
    x = np.asarray(x_aug, np.float64)[:, :3]
    rows = np.asarray(rows, np.float64)
    eff = planar_fk(x, OBSTACLE_LINK)
    d = planar_fk(x[:, :2], OBSTACLE_LINK) - rows[:, 2:4]
    g = (d * d).sum(1) - OBSTACLE_RADIUS ** 2
    checks = (
        np.abs(eff[:, 0] - rows[:, 0]) < 1e-6,
        np.abs(eff[:, 1] - rows[:, 1]) < 1e-2,
        g >= -1e-6,
        np.linalg.norm(d, axis=1) >= OBSTACLE_RADIUS - 1e-6,
    )
    return checks, g


def circle_graph(n, seed=0, noise=0.01, loop_every=10):
    """Noisy circle odometry plus a loop closure every ``loop_every`` poses,
    ground truth in the pose-0 frame, and the dead-reckoned start."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    R = 10.0
    gt = np.stack([R * np.cos(th), R * np.sin(th), th + np.pi / 2], 1)
    c0, s0 = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    Rw = np.array([[c0, s0], [-s0, c0]])
    gt = np.concatenate(
        [(gt[:, :2] - gt[0, :2]) @ Rw.T, ((gt[:, 2:] - gt[0, 2] + np.pi) % (2 * np.pi) - np.pi)], 1)
    edges, meas = [], []

    def rel(i, j):
        dxw = gt[j, 0] - gt[i, 0]
        dyw = gt[j, 1] - gt[i, 1]
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        return [c * dxw + s * dyw, -s * dxw + c * dyw, (gt[j, 2] - gt[i, 2] + np.pi) % (2 * np.pi) - np.pi]

    for i in range(n - 1):
        edges.append([i, i + 1])
        meas.append(rel(i, i + 1))
    for i in range(0, n - loop_every, loop_every):
        edges.append([i, i + loop_every])
        meas.append(rel(i, i + loop_every))
    meas = np.asarray(meas) + rng.normal(0, noise, (len(edges), 3))
    x0 = np.zeros((n, 3))
    x0[0] = gt[0]
    for i in range(n - 1):
        c, s = np.cos(x0[i, 2]), np.sin(x0[i, 2])
        m = meas[i]
        x0[i + 1, 0] = x0[i, 0] + c * m[0] - s * m[1]
        x0[i + 1, 1] = x0[i, 1] + s * m[0] + c * m[1]
        x0[i + 1, 2] = x0[i, 2] + m[2]
    return gt, np.asarray(edges), meas, x0


def helix_graph(n, seed=0, noise=0.01, loop_every=8):
    """Ground-truth SE(3) poses (t, rotation vector) along a rising helix
    with tangent-aligned yaw and a slow roll, pose 0 the identity; odometry
    and a closure every ``loop_every`` poses, noisy; the dead-reckoned
    start."""
    import torch

    from .utils.so3 import quat_conjugate, quat_exp, quat_log, quat_multiply, quat_rotate

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    def npy(a):
        return a.numpy()

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 3 * np.pi, n)
    R_c, pitch = 5.0, 0.4
    ts = np.stack([R_c * np.cos(th), R_c * np.sin(th), pitch * th], 1)
    qs = np.stack([
        npy(quat_multiply(quat_exp(t([0.0, 0.0, th[k] + np.pi / 2])), quat_exp(t([0.2 * np.sin(th[k]), 0.0, 0.0]))))
        for k in range(n)])
    q0c = quat_conjugate(t(qs[0]))
    t0 = ts[0].copy()
    gt = np.zeros((n, 6))
    for k in range(n):
        gt[k, :3] = npy(quat_rotate(q0c, t(ts[k] - t0)))
        gt[k, 3:] = npy(quat_log(quat_multiply(q0c, t(qs[k]))))

    def rel(i, j):
        qi, qj = quat_exp(t(gt[i, 3:])), quat_exp(t(gt[j, 3:]))
        dt = quat_rotate(quat_conjugate(qi), t(gt[j, :3] - gt[i, :3]))
        dw = quat_log(quat_multiply(quat_conjugate(qi), qj))
        return np.concatenate([npy(dt), npy(dw)])

    edges, meas = [], []
    for i in range(n - 1):
        edges.append([i, i + 1])
        meas.append(rel(i, i + 1))
    for i in range(0, n - loop_every, loop_every):
        edges.append([i, i + loop_every])
        meas.append(rel(i, i + loop_every))
    meas = np.stack(meas) + rng.normal(0, noise, (len(edges), 6))
    x0 = np.zeros((n, 6))
    for k in range(n - 1):
        qk = quat_exp(t(x0[k, 3:]))
        dt, dw = meas[k, :3], meas[k, 3:]
        x0[k + 1, :3] = x0[k, :3] + npy(quat_rotate(qk, t(dt)))
        x0[k + 1, 3:] = npy(quat_log(quat_multiply(qk, quat_exp(t(dw)))))
    return gt, np.asarray(edges), meas, x0
