"""Block-tridiagonal (spanning-chain) preconditioner of the matrix-free CG
path, the port of ``mini_opt_tpu/ops/tree_prec.py``.

On a cycle graph the Jacobi-preconditioned Gauss-Newton system has
condition number O(N^2); solving the chain part of the Hessian exactly and
leaving CG only the loop closures (a spanning-tree preconditioner) cuts the
trips an order of magnitude. For pose graphs whose spanning tree is the
odometry chain, the tree Hessian is symmetric block-tridiagonal with small
d x d blocks (3 for SE(2), 6 for SE(3), 2 and 9 for the chordal stages):

* ``block_tridiag_factor``: block LDL^T, a sequential recurrence over the N
  blocks (a matrix continued fraction, not associative): a Python loop of
  d x d operations, once per outer Gauss-Newton iteration;
* ``block_tridiag_apply``: the M^-1 r solve as two affine recurrences
  x_i = A_i x_{i-1} + b_i (forward and backward substitution) and a
  block-diagonal scale. It runs once per CG trip, so the recurrences stay
  log-depth in batched d x d products (``_affine_scan``, the JAX package's
  ``lax.associative_scan`` odd/even recursion, combined in the same order).

Every function works on one instance and under ``torch.func.vmap`` (the
CG step runs per lane under vmap).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .kkt import ldlt_factorize


class TreeFactor(NamedTuple):
    """Factored block-tridiagonal preconditioner H_tree = L D L^T.

    Dinv: (N, d, d) inverses of the Schur diagonal blocks D_i.
    G:    (N-1, d, d) forward factors G_i = U_{i-1}^T D_{i-1}^{-1}.
    U:    (N-1, d, d) upper blocks of H_tree (block (i, i+1)).
    ok:   () bool -- every diagonal block SPD (all pivots positive).
    """

    Dinv: torch.Tensor
    G: torch.Tensor
    U: torch.Tensor
    ok: torch.Tensor


def _spd_inverse(block, eye):
    """(block^-1, SPD flag) by the unpivoted LDL^T of ops/kkt.py and two
    unit-triangular solves of the identity (the JAX package's
    ``ldlt_solve((L, d), eye)``)."""
    (L, d), ok = ldlt_factorize(block[None])
    L, d = L[0], d[0]
    w = torch.linalg.solve_triangular(L, eye, upper=False, unitriangular=True) / d[:, None]
    inv = torch.linalg.solve_triangular(L.T, w, upper=True, unitriangular=True)
    # ok guards only nonzero pivots; a preconditioner must be SPD.
    return inv, ok[0] & (d > 0).all()


def block_tridiag_factor(Hd, Hu) -> TreeFactor:
    """Block LDL^T of the symmetric block-tridiagonal matrix with diagonal
    blocks ``Hd`` (N, d, d) and upper blocks ``Hu`` (N-1, d, d): the
    recurrence D_i = Hd_i - Hu_{i-1}^T D_{i-1}^{-1} Hu_{i-1}, one block
    after another."""
    n, d, _ = Hd.shape
    eye = torch.eye(d, dtype=Hd.dtype, device=Hd.device)
    Dinv_i, ok = _spd_inverse(Hd[0], eye)
    Dinvs, Gs, oks = [Dinv_i], [], [ok]
    for i in range(1, n):
        U_prev = Hu[i - 1]
        G_i = U_prev.T @ Dinv_i
        Dinv_i, ok_i = _spd_inverse(Hd[i] - G_i @ U_prev, eye)
        Dinvs.append(Dinv_i)
        Gs.append(G_i)
        oks.append(ok_i)
    G = torch.stack(Gs) if Gs else Hd.new_zeros((0, d, d))
    return TreeFactor(Dinv=torch.stack(Dinvs), G=G, U=Hu, ok=torch.stack(oks).all())


def _combine(A1, b1, A2, b2):
    """(A1, b1) then (A2, b2): x -> A2 (A1 x + b1) + b2."""
    return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... (len(even) is len(odd) or one more)."""
    k = odd.shape[0]
    pairs = torch.stack([even[:k], odd], 1).reshape((2 * k,) + even.shape[1:])
    return torch.cat([pairs, even[k:]]) if even.shape[0] > k else pairs


def _scan(A, b):
    """Inclusive scan of ``_combine`` over the leading axis, by the JAX
    package's recursion (``lax.associative_scan``): combine adjacent
    pairs, scan those, then fill in the even positions."""
    n = A.shape[0]
    if n < 2:
        return A, b
    rA, rb = _combine(A[0:-1:2], b[0:-1:2], A[1::2], b[1::2])
    oA, ob = _scan(rA, rb)
    if n % 2 == 0:
        eA, eb = _combine(oA[:-1], ob[:-1], A[2::2], b[2::2])
    else:
        eA, eb = _combine(oA, ob, A[2::2], b[2::2])
    eA, eb = torch.cat([A[:1], eA]), torch.cat([b[:1], eb])
    return _interleave(eA, oA), _interleave(eb, ob)


def _affine_scan(A, b):
    """x_i = A_i x_{i-1} + b_i with x_{-1} = 0, in O(log N) depth.

    A: (N, d, d) with A_0 ignored (taken as 0); b: (N, d)."""
    A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
    return _scan(A, b)[1]


def block_tridiag_apply(fact: TreeFactor, r):
    """Solve H_tree x = r given the factor; r and the result are (N, d).
    Forward L y = r (y_i = r_i - G_i y_{i-1}), z = D^-1 y, backward
    L^T x = z (x_i = z_i - D_i^-1 U_i x_{i+1}, a forward scan of the
    reversed sequence)."""
    n = r.shape[0]
    if n == 1:
        return (fact.Dinv[0] @ r[0])[None]
    Af = torch.cat([torch.zeros_like(fact.G[:1]), -fact.G])
    y = _affine_scan(Af, r)
    z = torch.einsum("nij,nj->ni", fact.Dinv, y)
    DU = torch.einsum("nij,njk->nik", fact.Dinv[:-1], fact.U)
    Ab = torch.cat([torch.zeros_like(DU[:1]), -torch.flip(DU, (0,))])
    return torch.flip(_affine_scan(Ab, torch.flip(z, (0,))), (0,))


def spanning_chain_order(block_pairs, n_blocks: int, root: int = 0) -> np.ndarray:
    """Host-side DFS preorder of a spanning tree of the block graph.

    ``block_pairs`` is an (E, 2) integer array of block endpoints. Returns
    ``perm`` with ``perm[p]`` the block visited at position p: relabeling
    blocks by position makes every first-child tree edge consecutive, so the
    tridiagonal factor captures the spanning chain of any graph layout. A
    graph that already holds the consecutive chain (i, i+1) gets the
    identity. Each component starts at its lowest-index degree-1 vertex when
    it has one (``root`` wins in its component); disconnected components
    are laid out back to back."""
    pairs = {
        (min(ia, ib), max(ia, ib))
        for ia, ib in np.asarray(block_pairs, dtype=np.int64).tolist()
        if ia != ib
    }
    if all((i, i + 1) in pairs for i in range(n_blocks - 1)):
        return np.arange(n_blocks, dtype=np.int32)

    adj: list = [set() for _ in range(n_blocks)]
    for ia, ib in pairs:
        adj[ia].add(ib)
        adj[ib].add(ia)
    seen = np.zeros(n_blocks, dtype=bool)
    perm: list = []
    for r0 in [root] + [i for i in range(n_blocks) if i != root]:
        if seen[r0]:
            continue
        comp, frontier = {r0}, [r0]
        while frontier:
            u = frontier.pop()
            for v in adj[u]:
                if v not in comp:
                    comp.add(v)
                    frontier.append(v)
        leaves = sorted(v for v in comp if len(adj[v]) == 1)
        start = r0 if (not leaves or r0 in leaves) else leaves[0]
        stack = [start]
        while stack:
            u = stack.pop()
            if seen[u]:
                continue
            seen[u] = True
            perm.append(u)
            # Reverse-sorted push: the lowest-index unvisited neighbour next.
            for v in sorted(adj[u], reverse=True):
                if not seen[v]:
                    stack.append(v)
    return np.asarray(perm, dtype=np.int32)


def chain_block_hessian(residual_fn: Callable, x, idx, data, n_blocks: int, dof: int, block_map=None):
    """Block-tridiagonal part of the Gauss-Newton Hessian of one edge set
    whose rows touch exactly two ``dof``-sized, block-aligned variable
    groups: chain edges (|block_i - block_j| == 1, in ``block_map`` order
    when one is given) contribute their four blocks, every other edge its
    two diagonal blocks. ``idx`` (E, 2 dof) long, ``data`` (E, k). Returns
    (Hd (N, d, d), Hu (N-1, d, d)) in position order."""
    bi = idx[:, 0] // dof
    bj = idx[:, dof] // dof
    if block_map is not None:
        bi, bj = block_map[bi], block_map[bj]

    def one(row_idx, row_data):
        J = jacfwd(lambda v: residual_fn(v, row_data))(x[row_idx])  # (rdim, 2 dof)
        A, B = J[:, :dof], J[:, dof:]
        return A.T @ A, B.T @ B, A.T @ B

    AtA, BtB, AtB = vmap(one)(idx, data)
    zeros = torch.zeros((n_blocks, dof, dof), dtype=AtA.dtype, device=AtA.device)
    Hd = zeros.index_add(0, bi, AtA).index_add(0, bj, BtB)
    is_fwd = (bj == bi + 1)[:, None, None]
    is_rev = (bi == bj + 1)[:, None, None]
    pos_f = torch.clamp(bi, 0, n_blocks - 2)
    pos_r = torch.clamp(bj, 0, n_blocks - 2)
    none = torch.zeros_like(AtB)
    Hu = zeros[:-1].index_add(0, pos_f, torch.where(is_fwd, AtB, none))
    Hu = Hu.index_add(0, pos_r, torch.where(is_rev, AtB.transpose(1, 2), none))
    return Hd, Hu


def make_chain_tree_preconditioner(
    residual_fn: Callable,
    idx,
    data,
    n_blocks: int,
    dof: int,
    anchor_block=None,
    floor: float = 1e-12,
    order="auto",
    block_pairs=None,
    axis_name=None,
):
    """``cg_preconditioner`` factory ``(x, lam) -> apply`` over one
    two-block-per-row edge set (the SE(2) and SE(3) pose graphs and the
    chordal stages share it). ``anchor_block`` (d, d) is the gauge prior's
    J^T J on block 0; ``lam`` and ``floor`` damp every diagonal block, so
    the factor stays SPD whenever the chain is connected.

    ``order``: ``"auto"`` runs ``spanning_chain_order`` on the host over
    the edge set (``block_pairs`` (E, 2), else read from ``idx``), and a
    graph whose chain is already consecutive keeps its order; ``None``
    keeps the index order; an (N,) array is used as given. ``idx`` (E, 2
    dof) integers and ``data`` (E, k) may be numpy or tensors; they move
    to the iterate's device at the first call. ``axis_name`` (the
    distributed factory) raises: ROADMAP.md queue 1, item 9."""
    if axis_name is not None:
        raise NotImplementedError(
            "a distributed tree preconditioner (axis_name) is not ported yet (ROADMAP.md queue 1, item 9: "
            "parallel/batch.py, the rest)")
    idx_np = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx, dtype=np.int64)
    if isinstance(order, str):
        assert order == "auto", order
        bp = (np.asarray(block_pairs, dtype=np.int64) if block_pairs is not None
              else np.stack([idx_np[:, 0] // dof, idx_np[:, dof] // dof], axis=1))
        order_np = spanning_chain_order(bp, n_blocks)
        if np.array_equal(order_np, np.arange(n_blocks, dtype=np.int32)):
            order_np = None
    elif order is None:
        order_np = None
    else:
        order_np = np.asarray(order, dtype=np.int64)
        assert order_np.shape == (n_blocks,)
    if order_np is None:
        inv_np, anchor_pos = None, 0
    else:
        inv_np = np.empty(n_blocks, dtype=np.int64)
        inv_np[order_np] = np.arange(n_blocks)
        anchor_pos = int(inv_np[0])
    on_device = {}

    def consts(device, dtype):
        """idx, data, perm, iperm and the anchor block on ``device`` in
        ``dtype``, moved once (a solve captured in a CUDA graph copies
        nothing from the host)."""
        if (device, dtype) not in on_device:
            to = lambda a: None if a is None else torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)  # noqa: E731
            d = data if torch.is_tensor(data) else torch.as_tensor(np.asarray(data))
            ab = None if anchor_block is None else torch.as_tensor(anchor_block).to(device=device, dtype=dtype)
            on_device[(device, dtype)] = (to(idx_np), d.to(device=device, dtype=dtype), to(order_np), to(inv_np), ab)
        return on_device[(device, dtype)]

    def prec_fn(x, lam):
        idx_d, data_d, perm, iperm, ab = consts(x.device, x.dtype)
        Hd, Hu = chain_block_hessian(residual_fn, x, idx_d, data_d, n_blocks, dof, block_map=iperm)
        eye = torch.eye(dof, dtype=x.dtype, device=x.device)
        if ab is not None:
            Hd = torch.cat([Hd[:anchor_pos], (Hd[anchor_pos] + ab)[None], Hd[anchor_pos + 1:]])
        Hd = Hd + (lam + torch.full((), floor, dtype=x.dtype, device=x.device)) * eye
        fact = block_tridiag_factor(Hd, Hu)

        def apply(r):
            rb = r.reshape(n_blocks, dof)
            if perm is not None:
                rb = rb[perm]
            xb = block_tridiag_apply(fact, rb)
            if perm is not None:
                xb = xb[iperm]
            return xb.reshape(-1)

        return apply

    return prec_fn
