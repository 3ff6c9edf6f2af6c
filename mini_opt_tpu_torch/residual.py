"""Residual layer: user cost functions and Gauss-Newton assembly, the port
of ``mini_opt_tpu/residual.py`` (residual.py:33-304).

A residual is a pure function ``f(x_local) -> r`` of ONE instance plus a
static tuple of global parameter indices, exactly as in the JAX package; the
solver evaluates it for a whole batch under ``torch.func.vmap``. Jacobians
come from ``torch.func.jacfwd`` unless a custom ``jac`` returning
``(r, J)`` is supplied. The assembly below works on one instance's
``(n, n)`` Hessian; ``vmap`` batches it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import jacfwd, vmap


def _index(index, device):
    return torch.as_tensor(index, dtype=torch.long, device=device)


def _cached_index(obj, index, device):
    """``_index`` of a residual's static index tuple, made once per device
    and kept on the (frozen) residual: a solve evaluates it every trip, and
    on the card each conversion is a host-to-device copy."""
    if torch.is_tensor(index):
        return _index(index, device)
    cache = obj.__dict__.setdefault("_index_cache", {})
    if device not in cache:
        cache[device] = _index(index, device)
    return cache[device]


@dataclasses.dataclass(frozen=True)
class Residual:
    """One cost/constraint block: ``r = fn(x[index])`` with ``dim`` outputs.

    Attributes:
      fn: pure function mapping local params ``(P,)`` to residual ``(dim,)``.
      index: global indices of the P parameters this block touches.
      dim: residual dimension R.
      jac: optional custom linearization ``x_local -> (r, J)`` with J of
        shape ``(dim, P)``; defaults to ``torch.func.jacfwd(fn)``.
    """

    fn: Callable
    index: Tuple[int, ...]
    dim: int
    jac: Optional[Callable] = None

    def gather(self, x):
        """GatherValues analog (residual.hpp:150-163)."""
        return x[_cached_index(self, self.index, x.device)]

    def error_vector(self, x):
        """h(x) for this block (residual.hpp:175-180)."""
        return self.fn(self.gather(x))

    def error_and_jacobian(self, x):
        """(r, J) with J in local coordinates, shape (dim, P)."""
        xl = self.gather(x)
        if self.jac is not None:
            return self.jac(xl)
        r = self.fn(xl)
        J = jacfwd(self.fn)(xl)
        return r, J.reshape(self.dim, len(self.index))

    def quadratic_error(self, x):
        """0.5 * ||h(x)||^2 (residual.cc:6-11)."""
        r = self.error_vector(x)
        return 0.5 * torch.sum(r * r)


def make_residual(index: Sequence[int], fn: Callable, dim: int, jac: Optional[Callable] = None) -> Residual:
    """MakeResidual analog (residual.hpp:121-143)."""
    return Residual(fn=fn, index=tuple(int(i) for i in index), dim=int(dim), jac=jac)


@dataclasses.dataclass(frozen=True)
class BlockResidual:
    """Homogeneous residual blocks sharing one function: ``indices`` is
    (num_blocks, P), row b the global indices of block b; ``fn(x_local,
    data_row)`` is vmapped over the blocks."""

    fn: Callable
    indices: object  # (num_blocks, P): nested tuples or an integer tensor
    dim: int
    data: Optional[torch.Tensor] = None  # (num_blocks, ...) per-block payload

    def _idx(self, device):
        return _cached_index(self, self.indices, device)

    @property
    def num_blocks(self) -> int:
        if isinstance(self.indices, tuple):
            return len(self.indices)
        return self.indices.shape[0]

    def _data_rows(self, x):
        if self.data is None:
            return torch.zeros((self.num_blocks, 0), dtype=x.dtype, device=x.device)
        return self.data

    def error_vectors(self, x):
        """All residuals stacked, shape (num_blocks, dim)."""
        return vmap(self.fn)(x[self._idx(x.device)], self._data_rows(x))

    def errors_and_jacobians(self, x):
        idx = self._idx(x.device)

        def one(xloc, drow):
            r = self.fn(xloc, drow)
            J = jacfwd(lambda v: self.fn(v, drow))(xloc)
            return r, J.reshape(self.dim, idx.shape[1])

        return vmap(one)(x[idx], self._data_rows(x))  # (B, R), (B, R, P)


# ---------------------------------------------------------------------------
# Assembly into one instance's global system.
# ---------------------------------------------------------------------------


def accumulate_hessian(G, c, res: Residual, x):
    """UpdateHessian analog (residual.hpp:185-226): adds J^T J into G and
    J^T r into c. Returns (G, c, 0.5*||r||^2)."""
    r, J = res.error_and_jacobian(x)
    idx = _cached_index(res, res.index, x.device)
    P = idx.shape[0]
    JtJ = J.T @ J
    Jtr = J.T @ r
    rows = idx[:, None].expand(P, P).reshape(-1)
    cols = idx[None, :].expand(P, P).reshape(-1)
    G = G.index_put((rows, cols), JtJ.reshape(-1), accumulate=True)
    c = c.index_put((idx,), Jtr, accumulate=True)
    return G, c, 0.5 * torch.sum(r * r)


def _onehot(idx, n, dtype):
    return (torch.arange(n, device=idx.device)[None, None, :] == idx[:, :, None]).to(dtype)


def accumulate_hessian_block(G, c, block: BlockResidual, x):
    """Accumulation of all block linearizations through one-hot index maps
    (``G += O_b^T JtJ_b O_b`` summed over blocks), as the JAX package
    assembles them."""
    r, J = block.errors_and_jacobians(x)  # (B, R), (B, R, P)
    onehot = _onehot(block._idx(x.device), G.shape[-1], G.dtype)  # (B, P, N)
    JtJ = torch.einsum("brp,brq->bpq", J, J)
    Jtr = torch.einsum("brp,br->bp", J, r)
    G = G + torch.einsum("bpn,bpq,bqm->nm", onehot, JtJ, onehot)
    c = c + torch.einsum("bpn,bp->n", onehot, Jtr)
    return G, c, 0.5 * torch.sum(r * r)


def fill_jacobian_rows(A, b, res, x, row: int):
    """UpdateJacobian analog (residual.hpp:229-250): write this block's
    linearization into rows [row, row + rows) of the global (A, b). A
    BlockResidual's ``num_blocks * dim`` rows land block-major."""
    n = A.shape[-1]
    if isinstance(res, BlockResidual):
        r, J = res.errors_and_jacobians(x)
        rows = torch.einsum("brp,bpn->brn", J, _onehot(res._idx(x.device), n, A.dtype))
        k = res.num_blocks * res.dim
        A = torch.cat([A[:row], rows.reshape(k, n), A[row + k :]], dim=0)
        b = torch.cat([b[:row], r.reshape(k), b[row + k :]], dim=0)
        return A, b
    r, J = res.error_and_jacobian(x)
    idx = _index(res.index, x.device)
    block = torch.zeros((res.dim, n), dtype=A.dtype, device=A.device)
    block = block.index_put((torch.arange(res.dim, device=x.device)[:, None], idx[None, :]), J)
    A = torch.cat([A[:row], block, A[row + res.dim :]], dim=0)
    b = torch.cat([b[:row], r, b[row + res.dim :]], dim=0)
    return A, b


def constraint_rows(res) -> int:
    """Total equality rows contributed by a Residual or BlockResidual."""
    if isinstance(res, BlockResidual):
        return res.num_blocks * res.dim
    return res.dim


# ---------------------------------------------------------------------------
# Robust loss kernels (residual.py:206-304).
# ---------------------------------------------------------------------------


def _robust_rescale(r, kind: str, delta: float):
    """Rescale a residual so that plain least squares on the result equals
    the robust loss: with s = 0.5||r||^2, r~ = r * sqrt(rho(s)/s). The
    value scale and the Jacobian scale are both frozen (``detach``), so the
    assembled gradient is the exact robust gradient with a PSD model (the
    JAX package's ``stop_gradient`` pair). Kinds: huber, cauchy (delta in
    residual-norm units)."""
    eps = torch.finfo(r.dtype).eps * delta * delta
    s = 0.5 * torch.sum(r * r, dim=0)
    s_safe = torch.clamp_min(s, eps)
    one = torch.ones_like(s)
    if kind == "huber":
        a = torch.sqrt(2.0 * s_safe)  # ||r||
        small = a <= delta
        rho = torch.where(small, s, delta * a - 0.5 * delta * delta)
        ratio = torch.where(small, one, rho / s_safe)
        drho = torch.where(small, one, delta / a)
    elif kind == "cauchy":
        tiny_u_max = 2.0 * torch.finfo(r.dtype).eps
        u = 2.0 * s / (delta * delta)
        u_safe = torch.clamp_min(u, tiny_u_max)
        ratio = torch.where(u <= tiny_u_max, 1.0 - u / 2.0, torch.log1p(u_safe) / u_safe)
        drho = 1.0 / (1.0 + u)
    else:
        raise ValueError(f"unknown robust kind: {kind!r}")
    s1 = torch.sqrt(ratio)
    s2 = drho / torch.clamp_min(s1, torch.finfo(r.dtype).eps)
    return ((s1 - s2) * r).detach() + s2.detach() * r


def robustify(block, kind: str = "huber", delta: float = 1.0):
    """Wrap a Residual or BlockResidual in a robust loss kernel: the wrapped
    block's Gauss-Newton cost is ``rho(0.5 ||r||^2)`` per block. A custom
    ``jac`` on a wrapped Residual is dropped (jacfwd of the rescaled
    function is exact)."""
    if isinstance(block, Residual):
        base = block.fn
        return Residual(
            fn=lambda xl: _robust_rescale(base(xl), kind, delta),
            index=block.index, dim=block.dim, jac=None,
        )
    if isinstance(block, BlockResidual):
        base_b = block.fn
        return BlockResidual(
            fn=lambda xl, row: _robust_rescale(base_b(xl, row), kind, delta),
            indices=block.indices, dim=block.dim, data=block.data,
        )
    raise TypeError(f"robustify expects Residual or BlockResidual, got {type(block)}")
