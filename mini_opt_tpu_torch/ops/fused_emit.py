"""The family-to-CUDA emitter, register target: a family that
``family_from_problem`` generated from a ``Problem`` becomes its own
instance of kernel 1 (``csrc/fused_sqp.cuh``).

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
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Tuple

import numpy as np
import torch

from . import _build

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


def _ternary_chain(values, fmt, default):
    """``j == 0 ? v0 : j == 1 ? v1 : ... : default`` as one constexpr
    expression."""
    expr = default
    for j in range(len(values) - 1, -1, -1):
        expr = f"j == {j} ? {fmt(values[j])} : {expr}"
    return expr


class FamilyProgram:
    """The device program of a generated family: its callables traced per
    dtype, the emitted ``.cu`` and, at first use, the built and bound
    library. ``family_from_problem`` makes one per family."""

    def __init__(self, n, m_eq, data_rows, lower, upper, linearize, errors, retract):
        self.n, self.m_eq, self.data_rows = n, m_eq, data_rows
        self.lower, self.upper = tuple(lower), tuple(upper)
        self._linearize, self._errors, self._retract = linearize, errors, retract
        self._programs = {}
        self._source = None
        self._lib = None

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
