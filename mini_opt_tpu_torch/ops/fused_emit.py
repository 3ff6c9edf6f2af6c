"""The family-to-CUDA emitter: a family that ``family_from_problem``
generated from a ``Problem`` becomes its own instance of kernel 1
(``csrc/fused_sqp.cuh``, the register target, D = n + m_eq <= 32) or of
kernel 2 (``csrc/blocked_sqp.cuh``, the blocked target, D up to 256: its
shared route to 192, its global route past one CTA's slab or D = 192).

It adds no kernel. The JAX package traces a generated family's register
callables into its Pallas kernel (``pallas_ik.py::_make_kernel``); here the
same callables -- the plain ``linearize`` / ``errors`` / ``retract`` on
lists of ``(B,)`` tensors, the forward-mode ``torch.func.jvp`` tangent
arithmetic included -- are traced once per dtype with
``torch.fx.experimental.proxy_tensor.make_fx`` into a straight-line graph
of aten operations, lowered to a program of scalar statements per lane
(``Program``), and printed as one C++ statement each, in the plain
version's order, into a family struct with the interface of
``csrc/families.cuh``: ``N``, ``M``, ``ROWS``, ``NLO``, ``NHI``, the bound
lists and ``linearize`` / ``errors`` / ``retract``. The struct and the
kernel and launcher of ``csrc/fused_ik_launch.cuh`` make one ``.cu`` per
family, float and double, built by nvcc at first use into
``build/kernels/`` (``ops/_build.py::load_generated``).

Bit parity with the plain version on the card rests on three things: the
build keeps every ``a * b + c`` as two rounded operations (``--fmad=false``,
no fast math); every statement mirrors what PyTorch's CUDA kernel for that
aten operation computes (a Python scalar operand rounded to the tensor's
type, ``clamp_min`` passing NaN through, ``reciprocal`` a true
division); and a transcendental function of a value that only constants
feed is kept from nvcc's constant folding (``mo_opaque``), which would use
the host's libm. Products with a zero tangent stay in the program: ``0 *
NaN`` is NaN in the plain version too. An operation whose CUDA result the
emitter cannot mirror bit for bit -- a ``tensor / python_scalar`` (PyTorch's
CUDA kernel multiplies by the reciprocal), a sum of more than two terms (its
order on the card is not fixed), a value handed to Python, anything outside
the table below -- raises ``UnsupportedOp`` naming it; nothing falls back to
the CPU. A float32 program holds no float64 value (``fused_auto`` casts the
Jacobians).

``run_program`` runs a ``Program`` statement by statement on ``(B,)``
tensors; on the CPU it reproduces the plain callables bit for bit, which is
how the tests hold the lowering.

The blocked target traces no whole linearization. Kernel 2 runs one
instance per warp, so the family's work is split by residual block: each
residual group (a Residual, or a static-index BlockResidual whose blocks
share one function) is traced once, one block on its P local variables and
its data row, into the program of that block's rows and Jacobian columns
(``blocked_programs``); the emitted functor (``blocked_source``, with
``csrc/blocked_launch.cuh``) evaluates block l, l + 32, ... on lane l into
the slab's scratch and then sums them into f, G, c and takes r_eq and J_eq
in the plain ``linearize``'s order. Its program is O(groups) statements and
its tables O(blocks) entries; after clearing G, c and J_eq it sums into only
the cells its blocks touch, which are the family's ``g_pattern`` and
``eq_patterns``.
``run_blocked`` runs the same computation on ``(B,)`` tensors. Kernel 2
retracts one variable at a time on the lane that owns it, so the family's
retract is traced once per dtype and split into one program per variable
(``blocked_retract``); a retract whose output i reads another variable, a
block that reads a variable twice and a block data row computed from the
payload each raise ``UnsupportedOp`` by name.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Callable, Tuple

import numpy as np
import torch

from . import _build
from .blocked import MAX_GLOBAL_D

# The batch width of the traces: a prime that no per-lane size equals, so a
# tensor is per-lane when, and only when, its last dimension has this size.
_B_TRACE = 1021

# IR operations by arity: name -> C++ format. Float statements take their
# type T from the program; comparisons give bool. The table holds only the
# arithmetic that the generated families held against their plain version
# on the card use (tests/test_torch_fused_auto_tiers.py, chip_smoke.py phase
# 22): each entry is a claim that its C++ line computes what PyTorch's CUDA
# kernel computes, so any other operation is refused by name until a family
# that uses it is held on the card too. Views, copies and constant fills
# compute nothing and are lowered to the statements they rearrange.
_UNARY = {
    "neg": "(-{0})",
    "abs": "fabs({0})",
    "floor": "floor({0})",
    "sqrt": "sqrt({0})",
    "cos": "cos({0})",
    "sin": "sin({0})",
    "recip": "({T}(1) / {0})",
}
_BINARY = {
    "add": "({0} + {1})",
    "sub": "({0} - {1})",
    "mul": "({0} * {1})",
    "div": "({0} / {1})",
    # clamp_min by a scalar on CUDA: NaN passes, else fmax.
    "clamp_lo": "(({0} != {0}) ? {0} : fmax({0}, {1}))",
    "lt": "({0} < {1})",
    "le": "({0} <= {1})",
    "gt": "({0} > {1})",
    "ge": "({0} >= {1})",
    "eq": "({0} == {1})",
    "ne": "({0} != {1})",
}
_TERNARY = {"where": "({0} ? {1} : {2})"}
# Functions whose constant-fed arguments nvcc must not fold with the host's
# libm.
_TRANSCENDENTAL = {"cos", "sin"}
_BOOL_RESULT = {"lt", "le", "gt", "ge", "eq", "ne"}

_TORCH = {
    "neg": torch.neg, "abs": torch.abs, "floor": torch.floor, "sqrt": torch.sqrt, "cos": torch.cos,
    "sin": torch.sin, "recip": torch.reciprocal, "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "clamp_lo": torch.clamp_min, "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "eq": torch.eq, "ne": torch.ne, "where": torch.where,
}


# aten operations with one IR statement per element.
_ATEN_BINARY = {"aten.add.Tensor": "add", "aten.sub.Tensor": "sub", "aten.mul.Tensor": "mul"}
_ATEN_UNARY = {
    **{f"aten.{op}.default": op for op in ("neg", "abs", "floor", "sqrt", "cos", "sin")},
    "aten.reciprocal.default": "recip",
}
_ATEN_COMPARE = {f"aten.{op}.{kind}": op for op in ("lt", "le", "gt", "ge", "eq", "ne") for kind in ("Tensor", "Scalar")}
# aten operations that hand a tensor's value to Python: a program cannot
# mirror what Python then does with it.
_ATEN_TO_PYTHON = {"aten._local_scalar_dense.default", "aten.is_nonzero.default", "aten.item.default"}


class UnsupportedOp(NotImplementedError):
    """The traced family holds an operation that the emitter cannot print
    as C++ computing what PyTorch's CUDA kernel computes, bit for bit."""


@dataclasses.dataclass(frozen=True)
class Const:
    """A literal: a float already rounded to ``dtype``, or a bool."""

    value: object
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Stmt:
    """``op`` over ``args`` (statement indices or ``Const``), of ``dtype``;
    ``("in", (k,))`` reads input k."""

    op: str
    args: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Program:
    """One traced callable as straight-line scalar statements per lane."""

    dtype: torch.dtype
    stmts: Tuple[Stmt, ...]
    outputs: tuple  # statement index or Const, one per flattened output


def _round(value, dtype):
    """A Python number as PyTorch's kernels see it next to a tensor of
    ``dtype``: rounded to that type."""
    if dtype == torch.bool:
        return bool(value)
    return float(torch.tensor(float(value), dtype=dtype).item())


@dataclasses.dataclass
class _V:
    """A traced tensor during lowering: ``obj`` holds one statement index or
    Const per per-lane element; a per-lane tensor's batch axis is the last
    one, kept with length 1 so that numpy broadcasting matches torch's."""

    obj: np.ndarray
    batched: bool
    dtype: torch.dtype


class _Lowering:
    def __init__(self, gm, dtype):
        self.gm = gm
        self.dtype = dtype
        self.stmts = []
        self.env = {}

    # -- statements -------------------------------------------------------
    def emit(self, op, args, dtype, where):
        if dtype.is_floating_point and dtype != self.dtype:
            raise UnsupportedOp(
                f"a {dtype} value in the {self.dtype} program at {where} ({op}): cast the "
                "plain version's value to the program's type")
        for a in args:
            a_dtype = a.dtype if isinstance(a, Const) else self.stmts[a].dtype
            if a_dtype.is_floating_point and a_dtype != self.dtype:
                raise UnsupportedOp(f"a {a_dtype} operand in the {self.dtype} program at {where} ({op})")
        self.stmts.append(Stmt(op, tuple(args), dtype))
        return len(self.stmts) - 1

    # -- values ------------------------------------------------------------
    @staticmethod
    def _obj_shape(shape):
        shape = tuple(int(s) for s in shape)
        if shape and shape[-1] == _B_TRACE:
            return shape[:-1] + (1,), True
        if _B_TRACE in shape:
            raise UnsupportedOp(f"the batch axis is not the last one (shape {shape})")
        return shape, False

    def _meta(self, node):
        val = node.meta.get("val")
        if not torch.is_tensor(val):
            raise UnsupportedOp(f"{node.name}: {str(node.target)} gives no tensor")
        return val

    def _fill(self, node, value):
        val = self._meta(node)
        shape, batched = self._obj_shape(val.shape)
        obj = np.empty(shape, dtype=object)
        c = Const(_round(value, val.dtype), val.dtype)
        for idx in np.ndindex(shape):
            obj[idx] = c
        return _V(obj, batched, val.dtype)

    def _arg(self, a, dtype):
        """An fx argument (or a value lowered already) as a _V: a traced
        tensor, or a Python number rounded to the operation's type."""
        if isinstance(a, _V):
            return a
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (bool, int, float)):
            obj = np.empty((), dtype=object)
            obj[()] = Const(_round(a, dtype), dtype)
            return _V(obj, False, dtype)
        raise UnsupportedOp(f"an argument of type {type(a).__name__}")

    def _elementwise(self, node, op, args, compute_dtype=None):
        val = self._meta(node)
        compute_dtype = compute_dtype or val.dtype
        vs = [self._arg(a, compute_dtype) for a in args]
        objs = np.broadcast_arrays(*[v.obj for v in vs])
        shape, batched = self._obj_shape(val.shape)
        out = np.empty(objs[0].shape, dtype=object)
        res_dtype = torch.bool if op in _BOOL_RESULT else val.dtype
        for idx in np.ndindex(out.shape):
            out[idx] = self.emit(op, tuple(o[idx] for o in objs), res_dtype, node.name)
        if out.shape != shape:
            raise UnsupportedOp(f"{node.name}: {str(node.target)} broadcast to {out.shape}, not {shape}")
        return _V(out, batched, res_dtype)

    def _check(self, node, v):
        shape, batched = self._obj_shape(self._meta(node).shape)
        if v.obj.shape != shape or v.batched != batched:
            raise UnsupportedOp(f"{node.name}: {str(node.target)} moved the batch axis")
        return v

    def _dim(self, node, v, dim, rank):
        dim = dim + rank if dim < 0 else dim
        if v.batched and dim == rank - 1:
            raise UnsupportedOp(f"{node.name}: {str(node.target)} acts on the batch axis")
        return dim

    # -- the graph ---------------------------------------------------------
    def run(self):
        graph = self.gm.graph
        for n in graph.nodes:
            if n.op == "call_function" and str(n.target) in _ATEN_TO_PYTHON:
                raise UnsupportedOp(
                    f"{n.name}: {n.target} hands a traced value to Python (.item(), bool(), a branch on "
                    "values); a device program cannot mirror what Python does with it: use torch.where")
        out_node = next(n for n in graph.nodes if n.op == "output")
        needed = set()
        stack = [out_node]
        while stack:
            n = stack.pop()
            if n in needed:
                continue
            needed.add(n)
            stack.extend(n.all_input_nodes)
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        for k, n in enumerate(placeholders):
            obj = np.empty((1,), dtype=object)
            obj[0] = len(self.stmts)
            self.stmts.append(Stmt("in", (k,), self.dtype))
            self.env[n] = _V(obj, True, self.dtype)
        for n in graph.nodes:
            if n not in needed or n.op in ("placeholder", "output"):
                continue
            if n.op == "get_attr":
                t = getattr(self.gm, n.target)
                shape, batched = self._obj_shape(t.shape)
                if batched:
                    raise UnsupportedOp(f"{n.name}: a constant tensor the width of the batch")
                obj = np.empty(shape, dtype=object)
                flat = t.detach().cpu().reshape(-1).tolist()
                for i, idx in enumerate(np.ndindex(shape)):
                    obj[idx] = Const(_round(flat[i], t.dtype), t.dtype)
                self.env[n] = _V(obj, False, t.dtype)
                continue
            if n.op != "call_function":
                raise UnsupportedOp(f"{n.name}: fx node kind {n.op}")
            self.env[n] = self.lower(n)
        outs = []
        for o in out_node.args[0]:
            v = self.env[o] if isinstance(o, torch.fx.Node) else self._arg(o, self.dtype)
            if v.obj.size != 1:
                raise UnsupportedOp(f"an output of per-lane shape {v.obj.shape}, not a scalar")
            outs.append(v.obj.reshape(-1)[0])
        return Program(self.dtype, tuple(self.stmts), tuple(outs))

    def lower(self, n):
        name = str(n.target)
        args, kw = n.args, n.kwargs
        if n.target is operator.getitem:
            return self.env[args[0]][args[1]]
        view = self._view(n, name, args, kw)
        if view is not None:
            return self._check(n, view) if not isinstance(view, list) else view
        fill = {
            "aten.zeros_like.default": 0.0, "aten.ones_like.default": 1.0, "aten.zeros.default": 0.0,
            "aten.ones.default": 1.0, "aten._efficientzerotensor.default": 0.0, "aten.new_zeros.default": 0.0,
            "aten.new_ones.default": 1.0,
        }
        if name in fill:
            return self._fill(n, fill[name])
        if name in ("aten.full_like.default", "aten.full.default", "aten.new_full.default"):
            return self._fill(n, args[1] if name != "aten.new_full.default" else args[2])
        if name == "aten.scalar_tensor.default":
            return self._fill(n, args[0])
        return self._check(n, self._compute(n, name, args, kw))

    def _view(self, n, name, args, kw):
        if name in ("aten.alias.default", "aten.detach.default", "aten.clone.default",
                    "aten.lift_fresh_copy.default", "aten.contiguous.default"):
            return self.env[args[0]]
        if name == "aten._to_copy.default":
            src = self.env[args[0]]
            dtype = kw.get("dtype") or src.dtype
            if dtype == src.dtype:
                return src
            raise UnsupportedOp(f"{n.name}: {name} converts {src.dtype} to {dtype}")
        if name in ("aten.expand.default", "aten.view.default", "aten._unsafe_view.default",
                    "aten.reshape.default", "aten.squeeze.dim", "aten.squeeze.dims", "aten.squeeze.default",
                    "aten.unsqueeze.default"):
            src = self.env[args[0]]
            shape, batched = self._obj_shape(self._meta(n).shape)
            if src.batched and not batched:
                raise UnsupportedOp(f"{n.name}: {name} folds the batch axis")
            if name == "aten.expand.default":
                obj = np.broadcast_to(src.obj, shape)
            else:
                if src.obj.size != int(np.prod(shape)):
                    raise UnsupportedOp(f"{n.name}: {name} reshapes across the batch axis")
                obj = src.obj.reshape(shape)
            return _V(obj, batched, src.dtype)
        if name == "aten.select.int":
            src = self.env[args[0]]
            dim = self._dim(n, src, args[1], src.obj.ndim)
            return _V(np.take(src.obj, args[2], axis=dim), src.batched, src.dtype)
        if name == "aten.slice.Tensor":
            src = self.env[args[0]]
            dim = self._dim(n, src, args[1] if len(args) > 1 else 0, src.obj.ndim)
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            sl = (slice(None),) * dim + (slice(start, end, step),)
            return _V(src.obj[sl], src.batched, src.dtype)
        if name in ("aten.stack.default", "aten.cat.default"):
            srcs = [self.env[a] for a in args[0]]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            rank = srcs[0].obj.ndim + (1 if name == "aten.stack.default" else 0)
            if len({s.batched for s in srcs}) != 1 or len({s.dtype for s in srcs}) != 1:
                raise UnsupportedOp(f"{n.name}: {name} of per-lane and constant tensors")
            dim = self._dim(n, srcs[0], dim, rank)
            objs = [s.obj for s in srcs]
            obj = np.stack(objs, axis=dim) if name == "aten.stack.default" else np.concatenate(objs, axis=dim)
            return _V(obj, srcs[0].batched, srcs[0].dtype)
        if name == "aten.unbind.int":
            src = self.env[args[0]]
            dim = self._dim(n, src, args[1] if len(args) > 1 else 0, src.obj.ndim)
            return [_V(np.take(src.obj, i, axis=dim), src.batched, src.dtype) for i in range(src.obj.shape[dim])]
        return None

    def _compute(self, n, name, args, kw):
        if name in ("aten.add.Tensor", "aten.sub.Tensor") and kw.get("alpha", 1) != 1:
            raise UnsupportedOp(f"{n.name}: {name} with alpha = {kw['alpha']}")
        if name in _ATEN_BINARY:
            return self._elementwise(n, _ATEN_BINARY[name], args[:2])
        if name == "aten.div.Tensor":
            if not isinstance(args[1], torch.fx.Node) or self.env[args[1]].obj.ndim == 0 and not \
                    self.env[args[1]].batched and isinstance(self.env[args[1]].obj[()], Const):
                raise UnsupportedOp(
                    f"{n.name}: aten.div.Tensor by a Python scalar: PyTorch's CUDA kernel multiplies by "
                    "the reciprocal there; divide by a tensor (torch.full_like) in the family instead")
            return self._elementwise(n, "div", args[:2])
        if name in _ATEN_UNARY:
            return self._elementwise(n, _ATEN_UNARY[name], args[:1])
        if name in _ATEN_COMPARE:
            dtype = torch.result_type(*(self._meta(a) if isinstance(a, torch.fx.Node) else a for a in args[:2]))
            return self._elementwise(n, _ATEN_COMPARE[name], args[:2], compute_dtype=dtype)
        if name in ("aten.where.self", "aten.where.ScalarSelf", "aten.where.ScalarOther", "aten.where.Scalar"):
            val = self._meta(n)
            c = self.env[args[0]]
            a, b = (self._arg(x, val.dtype) for x in args[1:3])
            objs = np.broadcast_arrays(c.obj, a.obj, b.obj)
            out = np.empty(objs[0].shape, dtype=object)
            for idx in np.ndindex(out.shape):
                out[idx] = self.emit("where", tuple(o[idx] for o in objs), val.dtype, n.name)
            return _V(out, self._obj_shape(val.shape)[1], val.dtype)
        if name == "aten.clamp_min.default":
            if not isinstance(args[1], (int, float)):
                raise UnsupportedOp(f"{n.name}: {name} by a tensor bound")
            return self._elementwise(n, "clamp_lo", (self.env[args[0]], args[1]))
        if name == "aten.sum.dim_IntList":
            src = self.env[args[0]]
            rank = src.obj.ndim
            dims = sorted(self._dim(n, src, d, rank) for d in (args[1] or range(rank)))
            keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
            if kw.get("dtype") not in (None, src.dtype):
                raise UnsupportedOp(f"{n.name}: {name} with a dtype")
            moved = np.moveaxis(src.obj, dims, list(range(len(dims))))
            terms = int(np.prod([src.obj.shape[d] for d in dims]))
            if terms > 2:
                raise UnsupportedOp(
                    f"{n.name}: aten.sum of {terms} terms: the order PyTorch's kernels add them in is not "
                    "fixed; add the terms one by one in the family instead")
            flat = moved.reshape((terms,) + moved.shape[len(dims):])
            out = np.empty(flat.shape[1:], dtype=object)
            zero = Const(0.0, src.dtype)
            for idx in np.ndindex(out.shape):
                acc = zero  # PyTorch's reductions start from 0
                for t in range(terms):
                    acc = self.emit("add", (acc, flat[(t,) + idx]), src.dtype, n.name)
                out[idx] = acc
            if keep:
                out = out.reshape(tuple(1 if d in dims else s for d, s in enumerate(src.obj.shape)))
            return _V(out, src.batched, src.dtype)
        raise UnsupportedOp(f"{n.name}: {name} has no C++ form in the emitter that matches PyTorch's CUDA kernel")


def trace(fn: Callable, n_inputs: int, dtype: torch.dtype) -> Program:
    """Trace ``fn(*inputs) -> list of (B,) tensors`` on ``n_inputs`` per-lane
    tensors of ``dtype`` into a Program. The trace runs on fake tensors,
    which hold no values: Python that reads one (``.item()``, ``.tolist()``,
    ``if (x > 0).all():``) raises ``UnsupportedOp`` here, where a trace on
    real example tensors would fix the example's value into the program."""
    from torch.fx.experimental.proxy_tensor import make_fx

    base = torch.linspace(0.1, 0.9, _B_TRACE, dtype=dtype)
    example = [base + 0.05 * k for k in range(n_inputs)]
    try:
        gm = make_fx(fn, tracing_mode="fake")(*example)
    except RuntimeError as e:
        raise UnsupportedOp(f"the family could not be traced without values ({type(e).__name__}: {e}); a "
                            "device program cannot mirror Python that reads a traced value") from e
    return _Lowering(gm, dtype).run()


def run_program(prog: Program, inputs):
    """Run ``prog`` statement by statement on (B,) tensors: each statement
    is the one torch operation its C++ line computes; a literal is a full
    tensor of its value."""
    like = inputs[0]
    vals = []

    def get(a):
        if isinstance(a, Const):
            return torch.full_like(like, a.value, dtype=a.dtype)
        return vals[a]

    for s in prog.stmts:
        if s.op == "in":
            vals.append(inputs[s.args[0]])
        else:
            vals.append(_TORCH[s.op](*(get(a) for a in s.args)))
    return [get(o) for o in prog.outputs]


def _literal(c: Const, T: str):
    if c.dtype == torch.bool:
        return "true" if c.value else "false"
    v = float(c.value)
    if math.isnan(v):
        return f"{T}(NAN)"
    if math.isinf(v):
        return f"({'-' if v < 0 else ''}{T}(INFINITY))"
    text = v.hex() + ("f" if T == "float" else "")
    return f"({text})" if text.startswith("-") else text


def _live(prog: Program):
    live = [False] * len(prog.stmts)
    stack = [o for o in prog.outputs if not isinstance(o, Const)]
    while stack:
        i = stack.pop()
        if live[i]:
            continue
        live[i] = True
        stack.extend(a for a in prog.stmts[i].args if not isinstance(a, Const) and prog.stmts[i].op != "in")
    return live


def cpp_body(prog: Program, inputs, outputs, indent="    "):
    """The statements of ``prog`` as C++ lines: input k is the expression
    ``inputs[k]``, output j is assigned to ``outputs[j]`` after every
    statement ran (so an in-place retract reads its inputs first)."""
    T = "float" if prog.dtype == torch.float32 else "double"
    live = _live(prog)
    const_fed = []
    lines = []

    def ref(a):
        return _literal(a, T) if isinstance(a, Const) else f"v{a}"

    for i, s in enumerate(prog.stmts):
        const_fed.append(s.op != "in" and all(isinstance(a, Const) or const_fed[a] for a in s.args))
        if not live[i]:
            continue
        ctype = "bool" if s.dtype == torch.bool else ("float" if s.dtype == torch.float32 else "double")
        if s.op == "in":
            expr = inputs[s.args[0]]
        else:
            args = [ref(a) for a in s.args]
            if s.op in _TRANSCENDENTAL and const_fed[i]:
                args = [f"mo_opaque({a})" for a in args]
            fmt = _UNARY.get(s.op) or _BINARY.get(s.op) or _TERNARY[s.op]
            expr = fmt.format(*args, T=T)
        lines.append(f"{indent}const {ctype} v{i} = {expr};")
    for target, o in zip(outputs, prog.outputs):
        lines.append(f"{indent}{target} = {ref(o)};")
    return "\n".join(lines)


def _variable_program(prog: Program, i: int) -> Program:
    """Output i of ``prog`` as a program of its own on one input, input i:
    the statements it depends on, in order. Raises UnsupportedOp if it
    reads any other input."""
    out = prog.outputs[i]
    if isinstance(out, Const):
        return Program(prog.dtype, (), (out,))
    need, stack = set(), [out]
    while stack:
        k = stack.pop()
        if k in need:
            continue
        need.add(k)
        s = prog.stmts[k]
        if s.op == "in":
            if s.args[0] != i:
                raise UnsupportedOp(
                    f"a retract whose output {i} reads variable {s.args[0]} on the blocked target: kernel 2 "
                    "retracts each variable on the lane that owns it, by itself")
            continue
        stack.extend(a for a in s.args if not isinstance(a, Const))
    order = sorted(need)
    new = {k: j for j, k in enumerate(order)}
    stmts = tuple(
        Stmt("in", (0,), s.dtype) if s.op == "in"
        else Stmt(s.op, tuple(a if isinstance(a, Const) else new[a] for a in s.args), s.dtype)
        for s in (prog.stmts[k] for k in order))
    return Program(prog.dtype, stmts, (new[out],))


def _ternary_chain(values, fmt, default):
    """``j == 0 ? v0 : j == 1 ? v1 : ... : default`` as one constexpr
    expression."""
    expr = default
    for j in range(len(values) - 1, -1, -1):
        expr = f"j == {j} ? {fmt(values[j])} : {expr}"
    return expr


@dataclasses.dataclass(frozen=True)
class BlockCallables:
    """What the blocked target needs of a generated family beyond its
    ``linearize`` / ``errors``: the Problem's residuals as
    ``fused_auto.ResidualGroup``s, ``outputs(group, x_local, drow, payload,
    with_jac)`` (one block's rows, then its columns a-major) and
    ``data(payload)`` (every block's data row, flattened)."""

    groups: tuple
    outputs: Callable
    data: Callable


@dataclasses.dataclass(frozen=True)
class BlockedPrograms:
    """A generated family's blocked target in one dtype: per residual group,
    the program of one block's linearization (``lin``: rows, then columns
    a-major) and of its rows alone (``err``), on the block's P local
    variables, its data row and the payload; and per group and block, each
    data-row element's source: ``(k, 0.0)`` payload row k, or ``(-1, v)``
    the constant v."""

    lin: tuple
    err: tuple
    data_src: tuple


class FamilyProgram:
    """The device program of a generated family: its callables traced per
    dtype, the emitted ``.cu`` and, at first use, the built and bound
    library, for the register target (kernel 1) and the blocked target
    (kernel 2). ``family_from_problem`` makes one per family."""

    def __init__(self, n, m_eq, data_rows, lower, upper, linearize, errors, retract, blocks=None):
        self.n, self.m_eq, self.data_rows = n, m_eq, data_rows
        self.lower, self.upper = tuple(lower), tuple(upper)
        self._linearize, self._errors, self._retract = linearize, errors, retract
        self._blocks = blocks
        self._programs = {}
        self._blocked = {}
        self._blocked_retract = {}
        self._source = None
        self._blocked_source = None
        self._lib = None
        self._blocked_lib = None

    @property
    def lo(self):
        return [(i, v) for i, v in enumerate(self.lower) if v is not None]

    @property
    def hi(self):
        return [(i, v) for i, v in enumerate(self.upper) if v is not None]

    def linearize_outputs(self):
        """The C++ targets of the flattened linearize outputs, in order."""
        n, m = self.n, self.m_eq
        return (["f"] + [f"r_eq[{k}]" for k in range(m)]
                + [f"Jeq[{k}][{j}]" for k in range(m) for j in range(n)]
                + [f"G[{i}][{j}]" for i in range(n) for j in range(i + 1)]
                + [f"c[{i}]" for i in range(n)])

    def _flat_linearize(self, *ts):
        x, d = list(ts[: self.n]), list(ts[self.n:])
        f, r_eq, J_eq, G, c = self._linearize(x, d)
        return ([f] + list(r_eq) + [J_eq[k][j] for k in range(self.m_eq) for j in range(self.n)]
                + [G[i][j] for i in range(self.n) for j in range(i + 1)] + list(c))

    def _flat_errors(self, *ts):
        return list(self._errors(list(ts[: self.n]), list(ts[self.n:])))

    def _flat_retract(self, *ts):
        return list(self._retract(list(ts)))

    def programs(self, dtype):
        """{"linearize", "errors", "retract" (None for the identity)} ->
        Program in ``dtype``, traced once."""
        if dtype not in self._programs:
            k = self.n + self.data_rows
            self._programs[dtype] = {
                "linearize": trace(self._flat_linearize, k, dtype),
                "errors": trace(self._flat_errors, k, dtype),
                "retract": None if self._retract is None else trace(self._flat_retract, self.n, dtype),
            }
        return self._programs[dtype]

    def source(self):
        """The family's .cu: the GeneratedFamily struct (float and double
        members) and its plain-C launcher, emitted once."""
        if self._source is None:
            self._source = self._emit()
        return self._source

    def _emit(self):
        n, m, rows = self.n, self.m_eq, self.data_rows
        lo, hi = self.lo, self.hi
        struct = [
            f"  static constexpr int N = {n};",
            f"  static constexpr int M = {m};",
            f"  static constexpr int ROWS = {rows};",
            f"  static constexpr int NLO = {len(lo)};",
            f"  static constexpr int NHI = {len(hi)};",
            "  __host__ __device__ static constexpr int lo_var(int j) { return "
            + _ternary_chain([i for i, _ in lo], str, "0") + "; }",
            "  __host__ __device__ static constexpr double lo_val(int j) { return "
            + _ternary_chain([v for _, v in lo], lambda v: _literal(Const(float(v), torch.float64), "double"),
                             "0.0") + "; }",
            "  __host__ __device__ static constexpr int hi_var(int j) { return "
            + _ternary_chain([i for i, _ in hi], str, "0") + "; }",
            "  __host__ __device__ static constexpr double hi_val(int j) { return "
            + _ternary_chain([v for _, v in hi], lambda v: _literal(Const(float(v), torch.float64), "double"),
                             "0.0") + "; }",
        ]
        xs = [f"th[{i}]" for i in range(n)]
        ds = [f"d[{r}]" for r in range(rows)]
        for dtype, T in ((torch.float32, "float"), (torch.float64, "double")):
            progs = self.programs(dtype)
            arr = f"const {T} (&th)[N], const {T} (&d)[mo::slots(ROWS)]"
            struct += [
                "",
                f"  __device__ __forceinline__ void linearize({arr}, {T}& f, {T} (&r_eq)[mo::slots(M)],",
                f"                                            {T} (&Jeq)[mo::slots(M)][N], {T} (&G)[N][N],",
                f"                                            {T} (&c)[N]) const {{",
                cpp_body(progs["linearize"], xs + ds, self.linearize_outputs()),
                "  }",
                "",
                f"  __device__ __forceinline__ void errors({arr}, {T}& f, {T}& eq) const {{",
                cpp_body(progs["errors"], xs + ds, ["f", "eq"]),
                "  }",
                "",
                f"  __device__ __forceinline__ void retract({T} (&th)[N]) const {{",
                "" if progs["retract"] is None else cpp_body(progs["retract"], xs, xs),
                "  }",
            ]
        return _SOURCE.format(
            n=n, m=m, rows=rows, nlo=len(lo), nhi=len(hi), struct="\n".join(struct)
        )

    def library(self):
        """The family's kernel library, emitted, built and bound at first
        use and kept (a call then costs no hashing); raises with nvcc's
        stderr when the build fails."""
        if self._lib is None:
            self._lib = _build.load_generated(self.source())
        return self._lib

    # -- the blocked target (kernel 2) -------------------------------------
    def _check_blocked(self):
        """Raise UnsupportedOp for what the blocked target does not take."""
        if self._blocks is None:
            raise UnsupportedOp("the family carries no residual structure for the blocked target")
        for g in self._blocks.groups:
            for idx in g.indices:
                if len(set(idx)) != len(idx):
                    raise UnsupportedOp(
                        f"a residual block that reads a variable twice (indices {idx}) on the blocked "
                        "target: its lanes scatter one block's Hessian cells side by side")
        D = self.n + self.m_eq
        if not 1 <= D <= MAX_GLOBAL_D:
            raise UnsupportedOp(
                f"D = n + m_eq = {D} on the blocked target, which takes D = 1..{MAX_GLOBAL_D}")

    def blocked_retract(self, dtype):
        """The family's retract in ``dtype`` as one program per variable
        (input 0 the variable's value, output 0 its retraction), traced once;
        None without a retract. Kernel 2 retracts each variable on the lane
        that owns it, so output i may read input i alone: a retract that
        mixes variables raises UnsupportedOp naming the pair."""
        if self._retract is None:
            return None
        if dtype not in self._blocked_retract:
            prog = trace(self._flat_retract, self.n, dtype)
            if len(prog.outputs) != self.n:
                raise UnsupportedOp(f"a retract of {len(prog.outputs)} outputs for {self.n} variables")
            self._blocked_retract[dtype] = tuple(_variable_program(prog, i) for i in range(self.n))
        return self._blocked_retract[dtype]

    def blocked_traces(self, dtype):
        """What the blocked target traces in ``dtype``: (``blocked_programs``,
        ``blocked_retract``). Plain data, so that another process can trace
        a wide family (minutes of Python) while this one works on."""
        return self.blocked_programs(dtype), self.blocked_retract(dtype)

    def adopt_blocked_traces(self, dtype, traces):
        """Take ``blocked_traces(dtype)`` of the same family traced in another
        process: what this process would have traced itself."""
        self._check_blocked()
        self._blocked[dtype], self._blocked_retract[dtype] = traces

    def _layout(self):
        """Per group: (first slot in scr, slots a block, first block) -- the
        blocks' outputs block-major in the family's scratch, the blocks
        dealt to the lanes in one run over all groups."""
        out, slot, block = [], 0, 0
        for g in self._blocks.groups:
            P = len(g.indices[0])
            k = g.dim * (1 + P)
            out.append((slot, k, block))
            slot += k * len(g.indices)
            block += len(g.indices)
        return out

    def blocked_scratch(self):
        """Slots of kernel 2's scratch that the blocked functor takes: every
        block's linearization outputs."""
        if self._blocks is None:
            raise UnsupportedOp("the family carries no residual structure for the blocked target")
        return sum(g.dim * (1 + len(g.indices[0])) * len(g.indices) for g in self._blocks.groups)

    def blocked_programs(self, dtype):
        """The blocked target's :class:`BlockedPrograms` in ``dtype``, traced
        once: a few small programs (one block of each residual group) where
        the register target traces the whole linearization."""
        self._check_blocked()
        self.blocked_retract(dtype)
        if dtype not in self._blocked:
            bl, rows = self._blocks, self.data_rows
            lin, err = [], []
            for g in bl.groups:
                P, L = len(g.indices[0]), g.data_len

                def flat(*ts, g=g, P=P, L=L, jac=True):
                    return bl.outputs(g, list(ts[:P]), list(ts[P:P + L]), list(ts[P + L:]), jac)

                lin.append(trace(flat, P + L + rows, dtype))
                err.append(trace(functools.partial(flat, jac=False), P + L + rows, dtype))
            srcs = []
            if any(g.data_shape is not None for g in bl.groups):
                prog = trace(lambda *ts: bl.data(list(ts)), rows, dtype)
                for o in prog.outputs:
                    if isinstance(o, Const):
                        srcs.append((-1, float(o.value)))
                    elif prog.stmts[o].op == "in":
                        srcs.append((prog.stmts[o].args[0], 0.0))
                    else:
                        raise UnsupportedOp(
                            "a block's data row computed from the payload on the blocked target: "
                            "each element must be a payload row or a constant")
            data_src, it = [], iter(srcs)
            for g in bl.groups:
                data_src.append(tuple(tuple(next(it) for _ in range(g.data_len)) for _ in g.indices))
            self._blocked[dtype] = BlockedPrograms(tuple(lin), tuple(err), tuple(data_src))
        return self._blocked[dtype]

    def run_blocked(self, dtype, fn, x, d):
        """The blocked functor's computation on (B,) tensors: each block's
        program run statement by statement (``run_program``), then the
        scatter in the order of csrc/blocked_launch.cuh -- what the kernel
        computes, as ``linearize`` / ``errors`` return it."""
        bp = self.blocked_programs(dtype)
        like = x[0]
        outs = []
        for g, group in enumerate(self._blocks.groups):
            prog = (bp.lin if fn == "linearize" else bp.err)[g]
            outs.append([
                run_program(prog, [x[i] for i in idx]
                            + [d[k] if k >= 0 else torch.full_like(like, v) for k, v in bp.data_src[g][b]] + list(d))
                for b, idx in enumerate(group.indices)])
        zero = torch.zeros_like(like)
        f = zero
        for group, per in zip(self._blocks.groups, outs):
            if group.role == "cost":
                for o in per:
                    for r in o[:group.dim]:
                        f = f + 0.5 * r * r
        if fn == "errors":
            eq = zero
            for group, per in zip(self._blocks.groups, outs):
                if group.role == "eq":
                    for o in per:
                        for r in o[:group.dim]:
                            eq = eq + torch.abs(r)
            return f, eq
        n = self.n
        G = [[zero] * (i + 1) for i in range(n)]
        c = [zero] * n
        r_eq, J_eq = [], []
        for group, per in zip(self._blocks.groups, outs):
            dim = group.dim
            for idx, o in zip(group.indices, per):
                rows, cols = o[:dim], [o[dim + a * dim: dim * (a + 2)] for a in range(len(idx))]
                if group.role == "eq":
                    for k in range(dim):
                        r_eq.append(rows[k])
                        row = [zero] * n
                        for a, ga in enumerate(idx):
                            row[ga] = cols[a][k]
                        J_eq.append(row)
                    continue
                for a in range(len(idx)):
                    for a2 in range(a + 1):
                        i, j = max(idx[a], idx[a2]), min(idx[a], idx[a2])
                        acc = G[i][j]
                        for k in range(dim):
                            acc = acc + cols[a][k] * cols[a2][k]
                        G[i][j] = acc
                for a, ga in enumerate(idx):
                    acc = c[ga]
                    for k in range(dim):
                        acc = acc + cols[a][k] * rows[k]
                    c[ga] = acc
        return f, r_eq, J_eq, G, c

    def blocked_source(self):
        """The family's .cu for kernel 2: the GeneratedFamily functor of
        csrc/blocked_launch.cuh's interface (float and double members) and
        its plain-C launcher, emitted once."""
        if self._blocked_source is None:
            self._blocked_source = self._emit_blocked()
        return self._blocked_source

    def _emit_blocked(self):
        n, m, rows = self.n, self.m_eq, self.data_rows
        groups = self._blocks.groups
        layout = self._layout()
        lo = [i for i, v in enumerate(self.lower) if v is not None]
        hi = [i for i, v in enumerate(self.upper) if v is not None]
        progs = {dt: self.blocked_programs(dt) for dt in (torch.float32, torch.float64)}

        def table(ctype, name, values):
            return f"__device__ const {ctype} {name}[] = {{{', '.join(values)}}};"

        def dliteral(v):
            return _literal(Const(float(v), torch.float64), "double")

        tables = []
        if lo:
            slots = [-1] * n
            for j, i in enumerate(lo):
                slots[i] = j
            tables += [table("int", "kLoSlot", map(str, slots)),
                       table("double", "kLoVal", (dliteral(self.lower[i]) for i in lo))]
        if hi:
            slots = [-1] * n
            for j, i in enumerate(hi):
                slots[i] = j
            tables += [table("int", "kHiSlot", map(str, slots)),
                       table("double", "kHiVal", (dliteral(self.upper[i]) for i in hi))]
        for g, group in enumerate(groups):
            tables.append(table("int", f"kIx{g}", (str(i) for idx in group.indices for i in idx)))
            if group.data_len:
                src32, src64 = progs[torch.float32].data_src[g], progs[torch.float64].data_src[g]
                if [[k for k, _ in b] for b in src32] != [[k for k, _ in b] for b in src64]:
                    raise UnsupportedOp("the blocks' data rows read other payload rows in float32 and float64")
                tables += [
                    table("int", f"kDs{g}", (str(k) for b in src64 for k, _ in b)),
                    table("float", f"kDf{g}", (_literal(Const(v, torch.float32), "float")
                                               for b in src32 for _, v in b)),
                    table("double", f"kDd{g}", (_literal(Const(v, torch.float64), "double")
                                                for b in src64 for _, v in b)),
                ]

        members = []
        for dtype, T, dv in ((torch.float32, "float", "kDf"), (torch.float64, "double", "kDd")):
            bp = progs[dtype]
            for g, group in enumerate(groups):
                P, L = len(group.indices[0]), group.data_len
                xs = [f"th[ix[{a}]]" for a in range(P)]
                ds = [f"mo::gen::drow(tgt, ds[{q}], dv[{q}])" for q in range(L)]
                ps = [f"tgt[{k}]" for k in range(rows)]
                head = [f"    const int* ix = kIx{g} + b * {P};"]
                if L:
                    head += [f"    const int* ds = kDs{g} + b * {L};", f"    const {T}* dv = {dv}{g} + b * {L};"]
                for kind, prog, k_out in (("lin", bp.lin[g], group.dim * (1 + P)), ("err", bp.err[g], group.dim)):
                    body = cpp_body(prog, xs + ds + ps, [f"out[{o}]" for o in range(k_out)])
                    members += [
                        "",
                        f"  __device__ __forceinline__ static void {kind}{g}(const {T}* th, const {T}* tgt, int b, "
                        f"{T}* out) {{",
                        *(head if "ix[" in body or "ds[" in body else []),
                        body,
                        "  }",
                    ]

        def evaluate(kind):
            lines = []
            for g, group in enumerate(groups):
                base, k, first = layout[g]
                lines.append(f"    for (int b = mo::gen::first_block(lane, {first}); b < {len(group.indices)}; "
                             f"b += mo::gen::kLanes) {kind}{g}(th, tgt, b, scr + {base} + b * {k});")
            return lines

        lin = ["    for (int p = lane; p < N * (N + 1) / 2; p += mo::gen::kLanes) G[p] = T(0);",
               "    for (int p = lane; p < N; p += mo::gen::kLanes) c[p] = T(0);",
               "    for (int p = lane; p < M * N; p += mo::gen::kLanes) Jeq[p] = T(0);",
               *evaluate("lin"), "    __syncwarp();", "    f = T(0);"]
        err = [*evaluate("err"), "    __syncwarp();", "    f = T(0);", "    eq = T(0);"]
        row = 0
        for g, group in enumerate(groups):
            base, k, _ = layout[g]
            P, nb, dim = len(group.indices[0]), len(group.indices), group.dim
            if group.role == "cost":
                lin.append(f"    mo::gen::scatter_cost<T, {P}, {dim}>(lane, {nb}, kIx{g}, scr + {base}, G, c);")
                lin.append(f"    f = mo::gen::sum_squares<T, {dim}, {k}>(f, {nb}, scr + {base});")
                err.append(f"    f = mo::gen::sum_squares<T, {dim}, {k}>(f, {nb}, scr + {base});")
            else:
                lin.append(f"    mo::gen::scatter_eq<T, {P}, {dim}>(lane, {nb}, kIx{g}, scr + {base}, {row}, N, req, "
                           "Jeq);")
                err.append(f"    eq = mo::gen::sum_abs<T, {dim}, {k}>(eq, {nb}, scr + {base});")
                row += dim * nb
        lin.append("    __syncwarp();")
        err.append("    __syncwarp();")

        struct = [
            f"  static constexpr int N = {n};",
            f"  static constexpr int M = {m};",
            f"  static constexpr int ROWS = {rows};",
            f"  static constexpr int NLO = {len(lo)};",
            f"  static constexpr int NHI = {len(hi)};",
            f"  static constexpr int SCRATCH = {self.blocked_scratch()};",
            "  __host__ __device__ int nvar() const { return N; }",
            "  __host__ __device__ int nlo() const { return NLO; }",
            "  __host__ __device__ int nhi() const { return NHI; }",
            "  __host__ __device__ int scratch() const { return SCRATCH; }",
            f"  __device__ int lo_slot(int i) const {{ return {'kLoSlot[i]' if lo else '-1'}; }}",
            f"  __device__ int hi_slot(int i) const {{ return {'kHiSlot[i]' if hi else '-1'}; }}",
            f"  __device__ double lo_val(int j) const {{ return {'kLoVal[j]' if lo else '0.0'}; }}",
            f"  __device__ double hi_val(int j) const {{ return {'kHiVal[j]' if hi else '0.0'}; }}",
            *self._retract_members(),
            *members,
            "",
            "  template <typename T>",
            "  __device__ void linearize(int lane, const T* th, const T* tgt, T* scr, T* G, T* Jeq, T* c, T* req,",
            "                            T& f) const {",
            *lin,
            "  }",
            "",
            "  template <typename T>",
            "  __device__ void errors(int lane, const T* th, const T* tgt, T* scr, T& f, T& eq) const {",
            *err,
            "  }",
        ]
        return _BLOCKED_SOURCE.format(n=n, m=m, rows=rows, nlo=len(lo), nhi=len(hi), groups=len(groups),
                                      tables="\n".join(tables), struct="\n".join(struct))

    def _retract_members(self):
        """``retract(i, a)``, variable i's retraction of the value a: the
        identity without a retract, else one overload per type that runs
        variable i's program (a switch over the distinct programs when the
        variables do not all share one)."""
        if self._retract is None:
            return ["  template <typename T>", "  __device__ T retract(int, T a) const { return a; }"]
        lines = []
        for dtype, T in ((torch.float32, "float"), (torch.float64, "double")):
            progs = self.blocked_retract(dtype)
            distinct = list(dict.fromkeys(progs))
            if len(distinct) == 1:
                lines += [f"  __device__ __forceinline__ {T} retract(int, {T} a) const {{", f"    {T} out;",
                          cpp_body(distinct[0], ["a"], ["out"]), "    return out;", "  }"]
                continue
            which = ", ".join(str(distinct.index(p)) for p in progs)
            lines += [f"  __device__ __forceinline__ {T} retract(int i, {T} a) const {{",
                      f"    constexpr int kWhich[] = {{{which}}};", f"    {T} out = a;", "    switch (kWhich[i]) {"]
            for k, p in enumerate(distinct):
                lines += [f"      case {k}: {{", cpp_body(p, ["a"], ["out"], indent="        "), "      } break;"]
            lines += ["    }", "    return out;", "  }"]
        return lines

    def blocked_library(self):
        """The family's kernel-2 library, emitted, built and bound at first
        use and kept; raises UnsupportedOp for what the blocked target does
        not take, and with nvcc's stderr when the build fails."""
        if self._blocked_lib is None:
            self._blocked_lib = _build.load_generated(self.blocked_source())
        return self._blocked_lib


_SOURCE = """\
// Kernel 1's instance for one family generated from a Problem
// (ops/fused_auto.py::family_from_problem), emitted by
// ops/fused_emit.py: N = {n}, M = {m}, ROWS = {rows}, NLO = {nlo}, NHI = {nhi}.
// Each statement is one aten operation of the plain linearize / errors /
// retract traced on (B,) tensors, in the plain version's order, so that the
// kernel reproduces it bit for bit. Do not edit: it is rebuilt from the
// family at first use.
#include "fused_ik_launch.cuh"

namespace {{

// Keeps nvcc from folding a transcendental function of a constant with the
// host's libm; the plain version runs CUDA's.
__device__ __forceinline__ float mo_opaque(float v) {{
  asm("" : "+f"(v));
  return v;
}}
__device__ __forceinline__ double mo_opaque(double v) {{
  asm("" : "+d"(v));
  return v;
}}

struct GeneratedFamily {{
{struct}
}};

}}  // namespace

// dtype: 0 float, 1 double; the other arguments as mo_fused_ik_launch's.
extern "C" int mo_generated_launch(int dtype, const void* data, const void* x0, const long long* strides,
                                   void* x_out, void* state, void* hist, int B, int max_iterations,
                                   int qp_iterations, int ls_iterations, int polynomial, int mpc,
                                   void* stream) {{
  LaunchArgs a;
  if (const int rc = launch_args(data, x0, strides, x_out, state, hist, B, max_iterations, qp_iterations,
                                 ls_iterations, polynomial, mpc, stream, &a)) {{
    return rc;
  }}
  switch (dtype) {{
    case 0: return launch<float>(GeneratedFamily{{}}, a);
    case 1: return launch<double>(GeneratedFamily{{}}, a);
    default: return mo::kNoInstance;
  }}
}}

extern "C" const char* mo_generated_error_string(int rc) {{ return error_text(rc); }}
"""


_BLOCKED_SOURCE = """\
// Kernel 2's instance for one family generated from a Problem
// (ops/fused_auto.py::family_from_problem), emitted by ops/fused_emit.py's
// blocked target: N = {n}, M = {m}, ROWS = {rows}, NLO = {nlo}, NHI = {nhi},
// {groups} residual groups. Each group's block program is one aten operation
// a statement of the plain version's per-block evaluation, traced on (B,)
// tensors; the lanes evaluate the blocks side by side into the scratch, and
// the scatter (csrc/blocked_launch.cuh) sums them in the plain linearize's
// order, so that the kernel reproduces the plain version bit for bit. Do not
// edit: it is rebuilt from the family at first use.
#include "blocked_launch.cuh"

namespace {{

__device__ __forceinline__ float mo_opaque(float v) {{
  asm("" : "+f"(v));
  return v;
}}
__device__ __forceinline__ double mo_opaque(double v) {{
  asm("" : "+d"(v));
  return v;
}}

{tables}

struct GeneratedFamily {{
{struct}
}};

}}  // namespace

// dtype: 0 float, 1 double; the other arguments as mo_blocked_launch's.
extern "C" int mo_generated_blocked_launch(int dtype, const void* data, const void* x0, const long long* strides,
                                           void* x_out, void* state, int B, int warps, int max_iterations,
                                           int qp_iterations, int ls_iterations, int polynomial, int mpc,
                                           void* scratch, int slabs, long long slab_bytes, void* stream) {{
  mo::blocked::LaunchArgs a;
  if (const int rc = mo::blocked::launch_args(data, x0, strides, x_out, state, B, warps, max_iterations,
                                              qp_iterations, ls_iterations, polynomial, mpc, scratch, slabs,
                                              slab_bytes, stream, &a)) {{
    return rc;
  }}
  return mo::gen::launch_generated(GeneratedFamily{{}}, dtype, a, false);
}}

// CTAs of `warps` instances that fit one SM at once on the shared (global
// 0) or global (1) route; negative on an error.
extern "C" int mo_generated_blocked_occupancy(int dtype, int warps, int global) {{
  return mo::gen::launch_generated(GeneratedFamily{{}}, dtype, mo::blocked::occupancy_args(warps, global != 0),
                                   true);
}}

extern "C" const char* mo_generated_error_string(int rc) {{ return mo::gen::error_text(rc); }}
"""
