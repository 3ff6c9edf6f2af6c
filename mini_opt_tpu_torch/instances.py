"""Seeded IK instances and the effector error that judges a solve, in numpy.

``planar_instances`` is a copy of the JAX repo's bench generator
(``bench.py::make_instances``): reachable planar targets with warm starts.
``spatial_instances`` draws targets from random joint angles of the
alternating z/y-axis chain, the JAX package's spatial test distribution.
``medium_n_planar_instances`` is a copy of the warm-start serving
distribution of the JAX repo's medium-N example
(``examples/blocked_medium_n.py:53-61``). All return float64 ``(B, rows)``
targets and ``(B, n)`` starts; a caller casts them to its working dtype.
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
