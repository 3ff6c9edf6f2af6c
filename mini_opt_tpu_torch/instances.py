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
    phi0 = np.cumsum(th_ref, axis=1)
    eff0 = np.stack([link_len * np.cos(phi0).sum(1), link_len * np.sin(phi0).sum(1)], 1)
    targets = eff0 + rng.uniform(-0.05, 0.05, (B, 2))
    return targets, th_ref


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


def chain_closure_instances(B, n, closures, seed=0, step=0.5, start_noise=0.08):
    """A wandering chain (headings a running sum of U(-0.5, 0.5), steps of
    ``step``) with consistent measurements on the chain edges and the
    closures plus N(0, 0.02) noise; starts are the true poses plus
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
    meas += rng.normal(scale=0.02, size=meas.shape)
    x0 = poses + rng.normal(scale=start_noise, size=poses.shape)
    x0[:, 0] = 0.0
    return meas.reshape(B, 3 * len(edges)), x0.reshape(B, 3 * n)


def effector_error(kind, x, targets, link_len=0.4):
    """Max-abs effector error per instance of solutions ``x (B, n)``, in
    float64; ``kind`` is "planar" or "spatial". The bench's parity counts
    instances under 1e-3."""
    x = np.asarray(x, np.float64)
    targets = np.asarray(targets, np.float64)
    if kind == "planar":
        phi = np.cumsum(x, axis=1)
        p = link_len * np.stack([np.cos(phi).sum(1), np.sin(phi).sum(1)], 1)
    else:
        p = spatial_fk(x, link_len)
    return np.abs(p - targets).max(axis=1)
