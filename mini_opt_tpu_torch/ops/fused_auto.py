"""Compile a general-path ``Problem`` into a fused whole-solve family, the
port of ``mini_opt_tpu/ops/fused_auto.py`` (fused_auto.py:52-436).

``family_from_problem`` turns the same ``Problem`` description that drives
``nls_solve`` into a :class:`FusedFamily`, whose whole constrained SQP
solve then runs as one kernel per batch (``fused_solve_batch``).

User residuals are written for one instance, ``fn(x_local: (P,)) ->
(dim,)``. The family evaluates them on a stacked ``(P, B)`` tensor of the
batch's variables, so any residual in **scalar style** (static Python
indexing and elementwise torch operations, nothing that depends on
``x.shape`` such as ``torch.sum(x)`` or a matmul over the parameter axis)
computes every instance at once. Jacobians are taken with P
``torch.func.jvp`` calls, one one-hot basis tangent each: ``jacfwd``
column by column, as the JAX package does; custom ``Residual.jac``
callables are not consulted. The family's ``linearize`` / ``errors``
accumulate in exactly the JAX package's order, and they are the plain
version of the generated kernel: CPU tensors run them inside
``_fused_solve_plain`` (or ``_blocked_solve_plain`` past D = 32); on the
card the family's ``cuda_program`` (``ops/fused_emit.py``) traces them into
the family's own instance of kernel 1, or, past D = 32, traces each residual
group's block evaluation (``ResidualGroup``, ``_eval_one``) into its own
instance of kernel 2.

The structure (variable count, residual indices and dims, box bounds) is
read from one eager probe of the builder with zero data.
``check_family_against_problem`` validates the scalar-style contract
against the general path on sample instances.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..residual import BlockResidual, Residual
from .fused_emit import BlockCallables, FamilyProgram
from .fused_ik import FusedFamily


def _probe_structure(problem_builder, data_rows):
    """Build the problem once with zero data to read off its static
    structure (costs/equality indices and dims, dimension, box bounds)."""
    probe = problem_builder(torch.zeros((data_rows,), dtype=torch.float64))
    n = probe.dimension
    for group in (probe.costs, probe.equality_constraints):
        for r in group:
            if isinstance(r, Residual):
                continue
            if isinstance(r, BlockResidual):
                # Small homogeneous blocks unroll into per-block code; the
                # block count and index rows must be static Python.
                if not isinstance(r.indices, tuple):
                    raise TypeError(
                        "family_from_problem needs STATIC BlockResidual "
                        "indices (nested tuples); index tensors are the "
                        "sharded large-N case -- use the CG path."
                    )
                continue
            raise TypeError(
                "family_from_problem supports Residual and static-index "
                f"BlockResidual costs (got {type(r).__name__})."
            )
    lower = [None] * n
    upper = [None] * n
    for con in probe.inequality_constraints:
        a = float(con.a)
        b = float(con.b)
        if a == 0.0:
            raise ValueError("inequality with a == 0 constrains nothing")
        bound = -b / a
        v = int(con.variable)
        if a > 0.0:
            lower[v] = bound if lower[v] is None else max(lower[v], bound)
        else:
            upper[v] = bound if upper[v] is None else min(upper[v], bound)
    m_eq = sum(
        c.dim * (c.num_blocks if isinstance(c, BlockResidual) else 1)
        for c in probe.equality_constraints
    )
    return probe, n, tuple(lower), tuple(upper), m_eq


def _static_blocks(res):
    """The static (global-index-tuple, dim) list of a Residual /
    static-index BlockResidual, in _iter_blocks emission order."""
    if isinstance(res, BlockResidual):
        return [(tuple(res.indices[b]), res.dim) for b in range(res.num_blocks)]
    return [(tuple(res.index), res.dim)]


def _sparsity_patterns(probe, n):
    """The Hessian lower-triangle pattern and per-equality-row variable sets
    of the probe Problem's static block structure, in ``linearize``'s
    accumulation and emission order: G[ga][gb] for every (ga, gb) pair
    within a cost block (gb <= ga); equality rows block by block, ``dim``
    rows per block, each touching exactly the block's index set."""
    g = set()
    for cost in probe.costs:
        for idx, _dim in _static_blocks(cost):
            for ga in idx:
                for gb in idx:
                    if gb <= ga:
                        g.add((ga, gb))
    eq_rows = []
    for con in probe.equality_constraints:
        for idx, dim in _static_blocks(con):
            eq_rows.extend([frozenset(idx)] * dim)
    return frozenset(g), tuple(eq_rows)


def _basis_tangents(p, one, zero):
    """P one-hot (P, B) tangents, built by stacking."""
    return [torch.stack([one if i == a else zero for i in range(p)]) for a in range(p)]


def _eval_one(fn, dim, idx, x_regs, with_jac):
    """Evaluate one residual block ``fn(xl) -> (dim, B)``.

    Returns (rows, cols): rows[k] is output row k and cols[a][k] is
    d rows[k] / d local-param a (None without jac)."""
    p = len(idx)
    xl = torch.stack([x_regs[i] for i in idx])  # (P, B)
    if not with_jac:
        r = fn(xl)
        return [r[k] for k in range(dim)], None
    one = torch.ones_like(x_regs[0])
    zero = torch.zeros_like(x_regs[0])
    rows = None
    cols = []
    for tangent in _basis_tangents(p, one, zero):
        r, dr = torch.func.jvp(fn, (xl,), (tangent,))
        # In the variables' type: a tangent that no variable feeds can come
        # out float64 from float32 inputs (a Python float times a zero
        # tangent), and the emitted float32 program holds no float64 value.
        # A no-op otherwise.
        dr = dr.to(xl.dtype)
        if rows is None:
            rows = [r[k] for k in range(dim)]
        cols.append([dr[k] for k in range(dim)])
    return rows, cols


def _block_fn(res, b):
    """Block b of a static-index BlockResidual as ``fn(xl)``, its data row
    bound."""
    if res.data is None:
        return lambda xl: res.fn(xl, torch.zeros((0,), dtype=xl.dtype, device=xl.device))
    drow = res.data[b]
    return lambda xl: res.fn(xl, drow)


def _iter_blocks(res, x_regs, with_jac):
    """Yield (global_idx, rows, cols) per block: one for a plain Residual,
    ``num_blocks`` for a static-index BlockResidual (each with its own data
    row bound)."""
    if isinstance(res, BlockResidual):
        for b in range(res.num_blocks):
            idx = tuple(res.indices[b])
            yield idx, *_eval_one(_block_fn(res, b), res.dim, idx, x_regs, with_jac)
    else:
        yield res.index, *_eval_one(res.fn, res.dim, res.index, x_regs, with_jac)


@dataclasses.dataclass(frozen=True)
class ResidualGroup:
    """One Residual or static-index BlockResidual of a generated family's
    Problem, as the emitter's blocked target evaluates it: ``role`` "cost" or
    "eq", its ``position`` in that tuple of the Problem, ``dim`` rows a
    block, each block's global variable ``indices``, and the shape of one
    block's data row without the batch axis (None: a Residual, or a
    BlockResidual without data)."""

    role: str
    position: int
    dim: int
    indices: Tuple[Tuple[int, ...], ...]
    data_shape: Optional[Tuple[int, ...]]

    @property
    def data_len(self) -> int:
        return 0 if self.data_shape is None else int(np.prod(self.data_shape, dtype=np.int64))


def _residual_groups(probe):
    """The probe Problem's residuals as ResidualGroups, costs first, in
    ``linearize``'s order."""
    groups = []
    for role, residuals in (("cost", probe.costs), ("eq", probe.equality_constraints)):
        for pos, r in enumerate(residuals):
            if isinstance(r, BlockResidual):
                shape = None if r.data is None else tuple(int(d) for d in r.data.shape[1:])
                idx = tuple(tuple(int(i) for i in row) for row in r.indices)
                groups.append(ResidualGroup(role, pos, r.dim, idx, shape))
            else:
                groups.append(ResidualGroup(role, pos, r.dim, (tuple(int(i) for i in r.index),), None))
    return tuple(groups)


def _residual(problem, group):
    return (problem.costs if group.role == "cost" else problem.equality_constraints)[group.position]


def family_from_problem(
    problem_builder: Callable,
    data_rows: int,
    retract: Optional[Callable] = None,
) -> FusedFamily:
    """Compile ``problem_builder`` into a :class:`FusedFamily`.

    Args:
      problem_builder: ``data -> Problem`` for ONE instance, where ``data``
        is the per-instance payload of shape ``(data_rows,)``; the family
        calls it with ``(data_rows, B)`` rows, so every residual ``fn`` must
        be written in scalar style (see the module docstring). The problem's
        structure must not depend on the data values.
      data_rows: payload length per instance.
      retract: optional update applied to every line-search candidate, a
        ``list[n] -> list[n]`` callable on ``(B,)`` tensors.

    Returns a family for :func:`fused_solve_batch` whose ``cuda_program``
    emits its kernel instance on first use on the card; construct it once
    and reuse it (each family builds its own library).
    """
    probe, n, lower, upper, m_eq = _probe_structure(problem_builder, data_rows)
    g_pattern, eq_patterns = _sparsity_patterns(probe, n)

    def linearize(x_regs, data_regs):
        problem = problem_builder(torch.stack(data_regs))
        zero = torch.zeros_like(x_regs[0])
        f = zero
        G = [[zero] * (i + 1) for i in range(n)]
        c = [zero] * n
        for cost in problem.costs:
            for idx, rows, cols in _iter_blocks(cost, x_regs, with_jac=True):
                for r in rows:
                    f = f + 0.5 * r * r
                # J^T J into the global lower triangle, J^T r into the
                # gradient (residual.hpp:204-224's scatter-add as sums).
                for a, ga in enumerate(idx):
                    for b, gb in enumerate(idx):
                        if gb > ga:
                            continue
                        acc = G[ga][gb]
                        for k in range(cost.dim):
                            acc = acc + cols[a][k] * cols[b][k]
                        G[ga][gb] = acc
                    acc = c[ga]
                    for k in range(cost.dim):
                        acc = acc + cols[a][k] * rows[k]
                    c[ga] = acc
        r_eq = []
        J_eq = []
        for con in problem.equality_constraints:
            for idx, rows, cols in _iter_blocks(con, x_regs, with_jac=True):
                for k in range(con.dim):
                    r_eq.append(rows[k])
                    row = [zero] * n
                    for a, ga in enumerate(idx):
                        row[ga] = cols[a][k]
                    J_eq.append(row)
        return f, r_eq, J_eq, G, c

    def errors(x_regs, data_regs):
        problem = problem_builder(torch.stack(data_regs))
        zero = torch.zeros_like(x_regs[0])
        f = zero
        for cost in problem.costs:
            for _, rows, _ in _iter_blocks(cost, x_regs, with_jac=False):
                for r in rows:
                    f = f + 0.5 * r * r
        eq_l1 = zero
        for con in problem.equality_constraints:
            for _, rows, _ in _iter_blocks(con, x_regs, with_jac=False):
                for r in rows:
                    eq_l1 = eq_l1 + torch.abs(r)
        return f, eq_l1

    groups = _residual_groups(probe)

    def group_outputs(group, x_local, drow, payload, with_jac):
        """One block of ``group`` on its local variables and its data row
        (and, for a residual that reads the payload itself, the payload): the
        rows, then with ``with_jac`` the columns cols[a][k], a-major, by the
        same ``_eval_one`` as ``linearize`` / ``errors``."""
        res = _residual(problem_builder(torch.stack(payload)), group)
        if not isinstance(res, BlockResidual):
            fn = res.fn
        elif res.data is None:
            fn = _block_fn(res, 0)
        else:
            batch = tuple(x_local[0].shape)
            d = torch.stack(drow).reshape(group.data_shape + batch) if drow else \
                x_local[0].new_zeros(group.data_shape + batch)
            fn = lambda xl: res.fn(xl, d)  # noqa: E731
        rows, cols = _eval_one(fn, group.dim, tuple(range(len(x_local))), x_local, with_jac)
        return rows + ([] if cols is None else [v for col in cols for v in col])

    def block_data(payload):
        """Every data row of every BlockResidual with data, flattened: group
        by group, block by block, each row in C order."""
        problem = problem_builder(torch.stack(payload))
        out = []
        for group in groups:
            if group.data_shape is not None:
                data = _residual(problem, group).data
                for b in range(len(group.indices)):
                    out.extend(data[b].reshape((group.data_len,) + tuple(payload[0].shape)).unbind(0))
        return out

    return FusedFamily(
        n=n,
        data_rows=data_rows,
        m_eq=m_eq,
        linearize=linearize,
        errors=errors,
        lower=lower,
        upper=upper,
        retract=retract,
        g_pattern=g_pattern,
        eq_patterns=eq_patterns,
        cuda_program=FamilyProgram(
            n, m_eq, data_rows, lower, upper, linearize, errors, retract,
            blocks=BlockCallables(groups, group_outputs, block_data),
        ),
    )


def check_family_against_problem(
    family: FusedFamily,
    problem_builder: Callable,
    data,  # (B, data_rows) sample instances
    x,  # (B, n) sample points
    atol: float = 1e-6,
    rtol: float = 1e-6,
):
    """Eager validation of the scalar-style contract: compare the family's
    ``linearize`` / ``errors`` against the general path's per-block
    semantics on B sample instances. Raises on mismatch; returns the max
    absolute deviation otherwise. The sparsity-hint soundness check is
    sample-based, as in the JAX package: it sees only these instances."""
    from ..nonlinear import linearize_and_fill_qp

    data = torch.as_tensor(data)
    x = torch.as_tensor(x)
    B = data.shape[0]
    if B > 1024:
        raise ValueError(
            f"check_family_against_problem validates one sample of at most "
            f"1024 instances; got B={B} -- validate on a sample"
        )
    x_regs = [x[:, i] for i in range(family.n)]
    d_regs = [data[:, i] for i in range(family.data_rows)]
    f, r_eq, J_eq, G, c = family.linearize(x_regs, d_regs)
    fe, eqe = family.errors(x_regs, d_regs)

    def at(reg, b):
        return float(reg[b])

    worst = 0.0

    def cmp(a, b, what):
        nonlocal worst
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        dev = float(np.max(np.abs(a - b))) if a.size else 0.0
        worst = max(worst, dev)
        if not np.allclose(a, b, atol=atol, rtol=rtol):
            raise AssertionError(
                f"{what}: the family deviates from the general path "
                f"(max abs {dev:.3e}) -- the builder's residuals are not "
                "scalar-style (see the fused_auto docstring)"
            )

    n = family.n
    for b in range(B):
        problem = problem_builder(data[b])
        qp, errs = linearize_and_fill_qp(problem, x[b : b + 1], torch.zeros(1, dtype=x.dtype))
        ref_G = qp.G[0].numpy()
        G_b = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1):
                G_b[i, j] = at(G[i][j], b)
        cmp(G_b, np.tril(ref_G), f"G[{b}]")
        cmp([at(ci, b) for ci in c], qp.c[0].numpy(), f"c[{b}]")
        cmp([at(r, b) for r in r_eq], qp.b_eq[0].numpy(), f"r_eq[{b}]")
        A = qp.A_eq[0].numpy()
        for k in range(family.m_eq):
            cmp([at(J_eq[k][i], b) for i in range(n)], A[k], f"J_eq[{k}][{b}]")
        cmp(at(fe, b), float(errs.f[0]), f"f[{b}]")
        cmp(at(eqe, b), float(errs.equality[0]), f"eq_l1[{b}]")
        # Sparsity-hint soundness: every general-path nonzero must lie
        # inside the declared pattern (a blocked tier that reads the hints
        # would skip the cells outside it).
        if family.g_pattern is not None:
            tl = np.tril(ref_G)
            bad = [
                (int(i), int(j))
                for i, j in zip(*np.nonzero(np.abs(tl) > atol))
                if (int(i), int(j)) not in family.g_pattern
            ]
            assert not bad, (
                f"g_pattern unsound for instance {b}: general-path G has "
                f"nonzeros outside the hint at {bad[:5]}"
            )
        if family.eq_patterns is not None:
            for k in range(family.m_eq):
                bad = [
                    int(j)
                    for j in np.nonzero(np.abs(A[k]) > atol)[0]
                    if int(j) not in family.eq_patterns[k]
                ]
                assert not bad, (
                    f"eq_patterns[{k}] unsound for instance {b}: nonzero "
                    f"Jacobian columns {bad[:5]} outside the hint"
                )
    return worst


@functools.lru_cache(maxsize=None)
def _cached_family(problem_builder, data_rows, retract):
    return family_from_problem(problem_builder, data_rows, retract=retract)


def fused_nls_solve_batch(
    problem_builder: Callable,
    data,  # (B, data_rows)
    x0,  # (B, n)
    params,  # NLSParams
    retract: Optional[Callable] = None,
    device=None,
):
    """``nls_solve``'s fused-kernel twin: solve B instances of
    ``problem_builder`` with one whole-solve kernel, configured from the
    same :class:`NLSParams` the general path takes.

    Honoured knobs: ``max_iterations`` / ``max_qp_iterations`` /
    ``max_line_search_iterations`` (run as FIXED trip counts, like
    ``early_exit=False``), ``line_search_strategy`` and
    ``qp_barrier_strategy`` (COMPLEMENTARITY and PREDICTOR_CORRECTOR;
    FIXED_DECREASE raises). Tolerance knobs are ignored. The damping and
    penalty machine uses the kernel's fixed constants (lambda0 1e-3,
    penalty0 1e-2, Armijo tau 0.5); another ``armijo_search_tau`` raises.

    The family is cached on (builder, data_rows, retract) identity, so
    repeated calls reuse one kernel instance. Tensors run where they lie;
    numpy inputs go to ``device`` ("cuda" unless named).
    """
    from ..structs import BarrierStrategy, LineSearchStrategy
    from .fused_ik import fused_solve_batch

    if params.line_search_strategy == LineSearchStrategy.ARMIJO_BACKTRACK:
        if abs(params.armijo_search_tau - 0.5) > 1e-12:
            raise ValueError(
                "the fused kernel backtracks with fixed tau=0.5; got "
                f"armijo_search_tau={params.armijo_search_tau}"
            )
        line_search = "armijo"
    else:
        line_search = "polynomial"
    if params.qp_barrier_strategy == BarrierStrategy.PREDICTOR_CORRECTOR:
        barrier = "mpc"
    elif params.qp_barrier_strategy == BarrierStrategy.COMPLEMENTARITY:
        barrier = "complementarity"
    else:
        raise ValueError(
            f"unsupported barrier for the fused kernel: {params.qp_barrier_strategy!r}"
        )
    family = _cached_family(problem_builder, int(data.shape[1]), retract)
    return fused_solve_batch(
        family,
        data,
        x0,
        max_iterations=params.max_iterations,
        qp_iterations=params.max_qp_iterations,
        ls_iterations=params.max_line_search_iterations,
        line_search=line_search,
        barrier=barrier,
        device=device,
    )
