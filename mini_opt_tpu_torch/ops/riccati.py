"""Riccati (LQR) structured solver for optimal-control KKT systems, the port
of ``mini_opt_tpu/ops/riccati.py``.

The MPC transcription (``models/mpc.py``) produces condensed interior-point
systems with the direct-multiple-shooting structure: decision vector
z = [u_0..u_{T-1}, x_1..x_T], a stage-block-diagonal Hessian and T
dynamics-defect equality block rows, row t coupling (u_t, x_t, x_{t+1}).
Instead of factoring the whole (N+K)x(N+K) saddle matrix, this backend
eliminates it by a backward Riccati recursion: T steps of (NX+NU)-sized
dense algebra. It plugs into ``ops/kkt.py`` under the solver name

    ``f"riccati:{T}:{NX}:{NU}"``

so ``qp_ip_solve`` / ``nls_solve`` use it unchanged.

Math (the JAX module's docstring has the derivation). Normalizing each
equality block row by its transition block N_t gives the dynamics
dx_{t+1} = Abar_t dx_t + Bbar_t du_t + cbar_t; the value function
lam_t = V_t dx_t + v_t then solves the two-point boundary problem:

    V_T = Q_T,  F_t = R_t + Bbar^T V_{t+1} Bbar,
    K_t = F_t^{-1} Bbar^T V_{t+1} Abar,
    V_t = Q_t + Abar^T V_{t+1} (Abar - Bbar K_t).

The V/K/F recursion depends only on the matrix, so it is the factorization;
the v/k backward sweep and the forward rollout are the per-rhs solve.

Every function is batched: ``H (B, N+K, N+K)`` and ``rhs (B, N+K)``, with
``lax.scan`` written as a Python loop over the stages. Structure is
verified, not trusted: off-pattern mass, a (near-)singular N_t or a
non-positive pivot of F_t set the lane's ``ok`` to False, the channel a
failed dense factorization uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def parse(name: str) -> Tuple[int, int, int]:
    """``"riccati:T:NX:NU"`` -> (T, NX, NU)."""
    parts = name.split(":")
    if len(parts) != 4 or parts[0] != "riccati":
        raise ValueError(f"bad riccati solver spec: {name!r}")
    T, NX, NU = (int(p) for p in parts[1:])
    if T < 1 or NX < 1 or NU < 1:
        raise ValueError(f"bad riccati solver spec: {name!r}")
    return T, NX, NU


def solver_name(horizon: int, nx: int, nu: int) -> str:
    return f"riccati:{horizon}:{nx}:{nu}"


# ---------------------------------------------------------------------------
# Small static helpers.
# ---------------------------------------------------------------------------


def _diag_blocks(M, T: int, a: int, b: int):
    """(B, T*a, T*b) -> (B, T, a, b) diagonal blocks."""
    X = M.reshape(M.shape[0], T, a, T, b)
    return torch.diagonal(X, dim1=1, dim2=3).permute(0, 3, 1, 2)


def _sub_blocks(M, T: int, a: int, b: int):
    """Blocks (t, t-1) for t = 1..T-1, shape (B, T-1, a, b)."""
    if T == 1:
        return M.new_zeros((M.shape[0], 0, a, b))
    X = M.reshape(M.shape[0], T, a, T, b)[:, 1:, :, :-1, :]
    return torch.diagonal(X, dim1=1, dim2=3).permute(0, 3, 1, 2)


def _unrolled_inv(M):
    """Unpivoted Gauss-Jordan inverse of small (..., n, n) blocks. Valid for
    the blocks this path meets (N_t near the identity, F_t positive
    definite). Returns (inv, pivots); callers fold the pivots into ``ok``."""
    n = M.shape[-1]
    rows = [M[..., i, :] for i in range(n)]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    inv_rows = [eye[i].expand(rows[i].shape) for i in range(n)]
    pivots = []
    for j in range(n):
        p = rows[j][..., j : j + 1]
        pivots.append(p[..., 0])
        rj = rows[j] / p
        ij = inv_rows[j] / p
        for i in range(n):
            if i == j:
                continue
            f = rows[i][..., j : j + 1]
            rows[i] = rows[i] - f * rj
            inv_rows[i] = inv_rows[i] - f * ij
        rows[j] = rj
        inv_rows[j] = ij
    return torch.stack(inv_rows, dim=-2), torch.stack(pivots, dim=-1)


def _structure_mask(T: int, NX: int, NU: int) -> np.ndarray:
    """Boolean mask of the allowed stagewise sparsity pattern."""
    N = T * (NU + NX)
    D = N + T * NX
    mask = np.zeros((D, D), dtype=bool)

    def u(t):
        return slice(t * NU, (t + 1) * NU)

    def x(t):  # t in [1, T]
        return slice(T * NU + (t - 1) * NX, T * NU + t * NX)

    def e(t):  # constraint block row t in [0, T)
        return slice(N + t * NX, N + (t + 1) * NX)

    for t in range(T):
        mask[u(t), u(t)] = True
        mask[x(t + 1), x(t + 1)] = True
        mask[e(t), u(t)] = True
        if t >= 1:
            mask[e(t), x(t)] = True
        mask[e(t), x(t + 1)] = True
    return mask | mask.T


def _mT(M):
    return M.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Factorize / solve (the ops.kkt backend interface).
# ---------------------------------------------------------------------------


def riccati_factorize(H, T: int, NX: int, NU: int):
    """Backward Riccati pass over the condensed ``(B, N+K, N+K)`` matrices.

    Returns ``(fact, ok)`` like every ops.kkt factorization; ``ok (B,)`` is
    False where the matrix violates the stagewise pattern, a transition
    block N_t is (near-)singular, or a reduced Hessian F_t loses positive
    definiteness."""
    dtype = H.dtype
    N = T * (NU + NX)
    K = T * NX
    if tuple(H.shape[-2:]) != (N + K, N + K):
        raise ValueError(
            f"riccati:{T}:{NX}:{NU} expects a {(N + K,)}-sized condensed system, got {tuple(H.shape)}"
        )
    Bn = H.shape[0]
    R = _diag_blocks(H[:, : T * NU, : T * NU], T, NU, NU)
    Qn = _diag_blocks(H[:, T * NU : N, T * NU : N], T, NX, NX)  # Qn[t] = Q_{t+1}
    E = H[:, N:, :N]
    Db = _diag_blocks(E[:, :, : T * NU], T, NX, NU)
    Ex = E[:, :, T * NU :]
    Nb = _diag_blocks(Ex, T, NX, NX)
    C = torch.cat([H.new_zeros((Bn, 1, NX, NX)), _sub_blocks(Ex, T, NX, NX)], dim=1)

    # Off-pattern mass -> failed factorization (structural zeros are exact
    # zeros out of the assembly, so the gate can be tight).
    mask = torch.as_tensor(_structure_mask(T, NX, NU), dtype=dtype, device=H.device)
    h_max = torch.abs(H).amax(dim=(-1, -2))
    off = torch.abs(H * (1.0 - mask)).amax(dim=(-1, -2))
    eps = torch.finfo(dtype).eps
    structure_ok = off <= 16.0 * eps * torch.clamp_min(h_max, 1.0)

    Ninv, npiv = _unrolled_inv(Nb)
    Abar = -(Ninv @ C)
    Bbar = -(Ninv @ Db)
    Qcur = torch.cat([H.new_zeros((Bn, 1, NX, NX)), Qn[:, :-1]], dim=1)

    V = Qn[:, -1]
    Finv_l, K_l, Vn_l, fpiv_l = [None] * T, [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        At, Bt = Abar[:, t], Bbar[:, t]
        VB = V @ Bt  # (B, NX, NU)
        F = R[:, t] + _mT(Bt) @ VB
        Finv, fpiv = _unrolled_inv(F)
        Kt = Finv @ (_mT(VB) @ At)
        Vt = Qcur[:, t] + _mT(At) @ (V @ At - VB @ Kt)
        Finv_l[t], K_l[t], Vn_l[t], fpiv_l[t] = Finv, Kt, V, fpiv
        V = 0.5 * (Vt + _mT(Vt))
    Finv = torch.stack(Finv_l, dim=1)
    Kg = torch.stack(K_l, dim=1)
    Vnext = torch.stack(Vn_l, dim=1)
    fpiv = torch.stack(fpiv_l, dim=1)

    def all_lane(c):
        return c.reshape(Bn, -1).all(dim=1)

    tiny = torch.finfo(dtype).tiny
    ok = (
        structure_ok
        & all_lane(torch.isfinite(Vnext))
        & all_lane(torch.isfinite(Finv))
        & all_lane(torch.isfinite(Kg))
        & all_lane(torch.abs(npiv) > tiny)
        & all_lane(fpiv > tiny)  # Gauss-Jordan pivots of a PD matrix are positive
    )
    return (Ninv, Abar, Bbar, Finv, Kg, Vnext), ok


def riccati_solve(fact, rhs, T: int, NX: int, NU: int):
    """Per-rhs sweeps: backward (v, k), forward (du, dx, w). Returns the full
    saddle solution ``[p; w] (B, N+K)`` in the layout the dense backends
    produce, so ``qp._solve_condensed`` consumes it unchanged."""
    Ninv, Abar, Bbar, Finv, Kg, Vnext = fact
    N = T * (NU + NX)
    if rhs.dim() != 2 or rhs.shape[1] != N + T * NX:
        raise ValueError(f"expected rhs (B, {N + T * NX}), got {tuple(rhs.shape)}")
    Bn = rhs.shape[0]

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    b1u = rhs[:, : T * NU].reshape(Bn, T, NU)
    b1x = rhs[:, T * NU : N].reshape(Bn, T, NX)  # rows of x_1..x_T
    b2 = rhs[:, N:].reshape(Bn, T, NX)
    cbar = mv(Ninv, b2)

    ks, vnext = [None] * T, [None] * T
    v = -b1x[:, -1]
    for t in range(T - 1, -1, -1):
        Vt1, At, Bt, cb = Vnext[:, t], Abar[:, t], Bbar[:, t], cbar[:, t]
        k = mv(Finv[:, t], b1u[:, t] - mv(_mT(Bt), mv(Vt1, cb) + v))
        ks[t], vnext[t] = k, v
        bxc = b1x[:, t - 1] if t >= 1 else torch.zeros_like(v)
        v = mv(_mT(At), mv(Vt1, mv(Bt, k) + cb) + v) - bxc

    du, dxs, ws = [], [], []
    dx = rhs.new_zeros((Bn, NX))
    for t in range(T):
        d_u = -mv(Kg[:, t], dx) + ks[t]
        dx = mv(Abar[:, t], dx) + mv(Bbar[:, t], d_u) + cbar[:, t]
        lam = mv(Vnext[:, t], dx) + vnext[t]
        du.append(d_u)
        dxs.append(dx)
        ws.append(-mv(_mT(Ninv[:, t]), lam))
    return torch.cat(
        [torch.stack(du, 1).reshape(Bn, -1), torch.stack(dxs, 1).reshape(Bn, -1), torch.stack(ws, 1).reshape(Bn, -1)],
        dim=1,
    )
