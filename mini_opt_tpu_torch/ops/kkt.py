"""Pluggable batched linear solves for the condensed KKT system, the port
of ``mini_opt_tpu/ops/kkt.py``. Every function takes a batch: ``H (B, D, D)``
and ``rhs (B, D)``.

* ``"lu"``     -- partial-pivot LU (``torch.linalg.lu_factor_ex``), the
                  generic path and the oracle.
* ``"ldlt"``   -- unpivoted LDL^T as plain PyTorch, the JAX package's
                  column recurrence at every D. Valid for the quasi-definite
                  KKT matrices the interior point produces.
* ``"ldlt_ir"`` -- LDL^T plus one step of iterative refinement.
* ``"pallas_ldlt"`` -- the lane-batched kernels of ``ops/ldlt.py``
                  (``csrc/ldlt.cu`` on the card).
* ``"riccati:T:NX:NU"`` -- the structured backward Riccati recursion of
                  ``ops/riccati.py`` for MPC transcriptions.

``"auto"`` resolves as the JAX package resolves it off a TPU: to ``"lu"``.
``factorize`` returns ``(fact, ok)``, ``ok (B,)`` the per-lane replacement
for the reference's FailedFactorization exception (qp.cc:303-307).
"""

from __future__ import annotations

import torch

SOLVERS = ("auto", "lu", "ldlt", "ldlt_ir", "pallas_ldlt")

def is_valid_solver(name: str) -> bool:
    """Fixed names plus the parameterized ``"riccati:T:NX:NU"`` backend."""
    return name in SOLVERS or name.startswith("riccati:")


def resolve_solver(name: str) -> str:
    """``"auto"`` is ``"lu"`` here: the JAX package picks ``"ldlt"`` only on
    a TPU, whose compiler cannot lower LU inside the solver loops."""
    return "lu" if name == "auto" else name


def _tiny(H):
    return torch.finfo(H.dtype).tiny


# ---------------------------------------------------------------------------
# LU (generic path / oracle).
# ---------------------------------------------------------------------------


def _lu_factorize(H):
    LU, piv, _ = torch.linalg.lu_factor_ex(H)
    diag = torch.diagonal(LU, dim1=-2, dim2=-1)
    # Lenient, as the JAX package: interior-point Sigma terms span ~18
    # orders of magnitude, so only exactly singular or non-finite factors
    # are flagged here.
    ok = torch.isfinite(LU).all(-1).all(-1) & (diag.abs() > _tiny(H)).all(-1)
    return (LU, piv), ok


def _lu_solve(fact, rhs):
    LU, piv = fact
    return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Unpivoted LDL^T (quasi-definite KKT path).
# ---------------------------------------------------------------------------


def ldlt_factorize(H):
    """Unpivoted LDL^T: H = L diag(d) L^T with unit-lower L, per lane, by the
    JAX package's column recurrence (``c -= L[:, k] * (d_k * L[j, k])`` in
    order of k)."""
    D = H.shape[-1]
    B = H.shape[0]
    zero = torch.zeros((B, 1), dtype=H.dtype, device=H.device)
    cols, ds = [], []
    for j in range(D):
        c = H[:, :, j]
        for k in range(j):
            c = c - cols[k] * (ds[k] * cols[k][:, j])[:, None]
        dj = c[:, j]
        col = torch.cat(
            [zero.expand(B, j), torch.ones_like(zero), c[:, j + 1 :] / dj[:, None]], dim=1
        )
        cols.append(col)
        ds.append(dj)
    L = torch.stack(cols, dim=2)
    d = torch.stack(ds, dim=1)
    ok = torch.isfinite(L).all(-1).all(-1) & (d.abs() > _tiny(H)).all(-1)
    return (L, d), ok


def ldlt_solve(fact, rhs):
    L, d = fact
    w = torch.linalg.solve_triangular(L, rhs[..., None], upper=False, unitriangular=True)
    w = w / d[..., None]
    return torch.linalg.solve_triangular(
        L.transpose(-1, -2), w, upper=True, unitriangular=True
    )[..., 0]


def ldlt_ir_factorize(H):
    fact, ok = ldlt_factorize(H)
    return (fact, H), ok


def ldlt_ir_solve(fact_h, rhs):
    fact, H = fact_h
    x = ldlt_solve(fact, rhs)
    r = rhs - torch.matmul(H, x[..., None])[..., 0]
    return x + ldlt_solve(fact, r)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def kkt_factorize(H, solver: str):
    solver = resolve_solver(solver)
    if solver == "lu":
        return _lu_factorize(H)
    if solver == "ldlt":
        return ldlt_factorize(H)
    if solver == "ldlt_ir":
        return ldlt_ir_factorize(H)
    if solver == "pallas_ldlt":
        from . import ldlt

        return ldlt.factorize(H)
    if solver.startswith("riccati:"):
        from . import riccati

        return riccati.riccati_factorize(H, *riccati.parse(solver))
    raise ValueError(f"unknown kkt solver: {solver!r}")


def kkt_solve(fact, rhs, solver: str):
    solver = resolve_solver(solver)
    if solver == "lu":
        return _lu_solve(fact, rhs)
    if solver == "ldlt":
        return ldlt_solve(fact, rhs)
    if solver == "ldlt_ir":
        return ldlt_ir_solve(fact, rhs)
    if solver == "pallas_ldlt":
        from . import ldlt

        return ldlt.solve(fact, rhs)
    if solver.startswith("riccati:"):
        from . import riccati

        return riccati.riccati_solve(fact, rhs, *riccati.parse(solver))
    raise ValueError(f"unknown kkt solver: {solver!r}")
