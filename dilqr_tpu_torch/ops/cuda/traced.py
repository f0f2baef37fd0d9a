"""A user's own model and callable cost as generated CUDA C++ (counterpart of
``lane_compatible`` and ``cost_lane_compatible``,
dilqr_tpu/ops/pallas/ilqr_fused.py:357-388 and :263-283).

The JAX kernel runs a user's ``Dynamics`` and a callable cost by tracing
their Python into Mosaic; the port traces them with ``torch.fx``
(``make_fx`` in fake mode: no data, and a branch on a value raises instead
of keeping the branch the sample took) and unrolls the graph into
straight-line C++ -- one statement per component of each value -- that the
whole-solve kernel instantiates (``csrc/ilqr_user.cu`` for a model, the
``DILQR_CALLABLE_COST`` build of every kernel source for a cost).

The contract, the port's form of JAX's (a step traces on [d, 8, 128] lane
stacks with its params as a list of scalars and captures no array):

 * ``step(x [B, nx], u [B, nu], params [P])`` and its ``linearize_point``
   are traced at B = 2 with a flat params vector; a cost
   ``cost_fn(tau [n], cost_params)`` (the port calls it per point) is traced
   under ``torch.func.vmap`` over tau [2, n], with cost_params [Pc] or ();
 * indexing, slicing, unbind, stack and cat act on the last axis only, and
   so does sum; the batch axis is never indexed, reduced or mixed with
   another axis by broadcasting;
 * the elementwise operations are add, sub, mul, div, neg, pow by a
   number, sin, cos, atan2, exp, log, sqrt, rsqrt, tanh, sigmoid, abs,
   clamp by numbers, minimum, maximum, the comparisons, logical and, or and
   not, where, and constants;
 * no captured tensor has more than one element; a one-element tensor
   the function captures is read at each launch (a slot after the params),
   so one changed in place between two solves is seen by the kernel as by
   the plain loop, and a tensor the function makes (``torch.tensor(1.5)``)
   is a constant;
 * the step returns [2, nx] and the cost [2], in float32.

Anything else -- an array capture, a branch on data, an operation outside
the set, pytree params -- is refused: the caller keeps the plain loop, as
JAX keeps XLA. ``model`` and ``cost`` cache their result (the refusals
too) by the model or function object and the shapes, so a serving loop
traces once; the object is held weakly, so its traces go when it does (a
slew-rate wrapper's by the model it wraps, which outlives the wrapper made
each solve). ``TRACES`` counts the traces made. The dispatch traces only
for CUDA tensors: a solve on the CPU never traces.

The generated functions are templates over the scalar S (float in the
kernel's line search, a Dual for the jvp sweep, DualOf<Dual> for a
cost's Hessian, double and counting types in the host tests) and over the
params' type; sin and cos go through ``cos_sin_s`` as the device envs do,
so a traced copy of an env stays within an ulp of its hand-written code.
``ops`` counts the operations of one evaluation, as ``StepOps`` counts the
device envs' (a division, square root, exp or atan2 one, an FMA two, a
select or comparison none, cos_sin's FP64 operations apart), by running
the generated statements over counting scalars that mirror csrc/dual.cuh;
tests/test_torch_ilqr_traced.py holds it to a host build of the header.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# traces made (a cache miss each); the tests read it
TRACES = 0

# cos_sin's FP64 operations (csrc/dual.cuh), as STEP_OPS counts them
COS_SIN_F64 = 38


class StepOps(NamedTuple):
    """Operations of one evaluation of a step: as float (FP32, and FP64 in
    cos_sin, which evaluates in double), and on Duals as JvpJac evaluates
    it (FP32 on the values, computed once for the n columns; FP64; FP32 of
    one column's tangent). A division, square root, rsqrt, fmax or atan2
    counts one, an FMA two."""
    f32: int
    f64: int
    jvp_f32: int
    jvp_f64: int
    tangent: int


class CostOps(NamedTuple):
    """Operations of a callable cost: one float evaluation (FP32, FP64),
    one evaluation on DualOf<Dual> (all of its FP32 and FP64 operations),
    and the evaluations quad_at makes a Riccati step, n (n + 1) / 2."""
    f32: int
    f64: int
    hess_f32: int
    hess_f64: int
    hess_evals: int


class TracedModel(NamedTuple):
    n_state: int
    n_ctrl: int
    n_params: int
    source: str     # struct Model { step, step_unclamped } in namespace traced
    step: StepOps   # the step's operations
    lin: StepOps    # the linearization point's (step_unclamped)
    captured: Tuple[torch.Tensor, ...] = ()  # read after the params (launch_params)

    def ops(self, clamped: bool) -> StepOps:
        """The bound's counts under a method: the float step is the
        rollout's; the Duals are the clamped step's (AUTO_DIFF) or the
        linearization point's (ANALYTIC)."""
        d = self.step if clamped else self.lin
        return StepOps(self.step.f32, self.step.f64, d.jvp_f32, d.jvp_f64, d.tangent)


class TracedCost(NamedTuple):
    n: int
    n_params: int
    source: str     # struct Cost { cost } in namespace traced
    ops: CostOps
    captured: Tuple[torch.Tensor, ...] = ()  # read after the params (launch_params)
    unary: bool = False  # called fn(tau), not fn(tau, params)


class Refused(Exception):
    """The traced function breaks the contract."""


# ---- the per-component program ----
# A component is a reference: ("in", name, i) an input's (x, u, p, tau,
# cp), ("c", value) a constant, ("s", k, part) statement k's (part 1 the
# sine of a cos_sin). Its kind: "S" (depends on x, u or tau: a Dual in the
# jvp sweep), "K" (constants and params: the real type), "B" (a bool).

_INPUT_KIND = {"x": "S", "u": "S", "tau": "S", "p": "K", "cp": "K"}
_ARITH = ("add", "sub", "mul", "div")
_CMP = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==", "ne": "!="}


class _Prog:
    def __init__(self, params: str, n_params: int):
        self.stmts: List[Tuple[str, tuple, str, tuple]] = []  # (op, args, kind, extra)
        self._memo: Dict[tuple, tuple] = {}
        # captured tensors, read from the params input after its n_params
        self.params, self.n_params = params, n_params
        self.captured: List[torch.Tensor] = []

    def capture(self, t: torch.Tensor) -> tuple:
        """The component a captured one-element tensor reads: its slot
        after the params (a bool's as slot != 0)."""
        for j, c in enumerate(self.captured):
            if c is t:
                break
        else:
            j = len(self.captured)
            self.captured.append(t)
        ref = ("in", self.params, self.n_params + j)
        return self.emit("ne", (ref, ("c", 0.0))) if t.dtype == torch.bool else ref

    def kind(self, ref) -> str:
        if ref[0] == "in":
            return _INPUT_KIND[ref[1]]
        if ref[0] == "c":
            return "B" if isinstance(ref[1], bool) else "K"
        return self.stmts[ref[1]][2]

    def emit(self, op: str, args: tuple, extra: tuple = ()):
        key = (op, args, extra)
        k = self._memo.get(key)
        if k is None:
            kinds = [self.kind(a) for a in args]
            if op in _CMP or op in ("and", "or", "not"):
                kind = "B"
            else:
                kind = "S" if "S" in kinds else "K"
            if op not in _CMP and op not in ("and", "or", "not", "where") and "B" in kinds:
                raise Refused(f"{op} on a bool")
            k = len(self.stmts)
            self.stmts.append((op, args, kind, extra))
            self._memo[key] = k
        return ("s", k, 0)

    def live(self, outs) -> List[int]:
        """The statements the outputs need, in order."""
        seen, todo = set(), [r for r in outs if r[0] == "s"]
        while todo:
            k = todo.pop()[1]
            if k in seen:
                continue
            seen.add(k)
            todo.extend(a for a in self.stmts[k][1] if a[0] == "s")
        return sorted(seen)


class _Val:
    """A traced tensor: whether its axis 0 is the batch, and its components
    (an object array over the other axes, row-major)."""

    def __init__(self, batched: bool, comps: np.ndarray):
        self.batched, self.comps = batched, comps


def _const_val(v) -> _Val:
    a = np.empty((), dtype=object)
    a[()] = ("c", bool(v) if isinstance(v, bool) else float(v))
    return _Val(False, a)


def _inputs(name: str, n: int, batched: bool) -> _Val:
    a = np.empty((n,), dtype=object)
    for i in range(n):
        a[i] = ("in", name, i)
    return _Val(batched, a)


def _broadcast(vals: List[_Val], out_shape) -> Tuple[bool, List[np.ndarray]]:
    """The components of each operand broadcast to the output's (torch's
    broadcasting, right-aligned); the batch axis must meet only the batch
    axis or a 1."""
    batched = any(v.batched for v in vals)
    inner = tuple(out_shape[1:]) if batched else tuple(out_shape)
    rank = len(out_shape)
    out = []
    for v in vals:
        c = v.comps
        if v.batched:
            if c.ndim + 1 != rank:
                raise Refused("the batch axis broadcast against another axis")
        elif batched and c.ndim == rank:
            if c.shape[0] != 1:
                raise Refused("a tensor of the batch's size broadcast against the batch")
            c = c[0]
        out.append(np.broadcast_to(c, inner))
    return batched, out


def _map(prog: _Prog, op: str, vals: List[_Val], out_shape, extra=()) -> _Val:
    batched, cs = _broadcast(vals, out_shape)
    shape = cs[0].shape
    res = np.empty(shape, dtype=object)
    flat = [c.reshape(-1) for c in cs]
    out = res.reshape(-1)
    for i in range(out.shape[0]):
        out[i] = prog.emit(op, tuple(f[i] for f in flat), extra)
    return _Val(batched, res)


def _unary(prog: _Prog, fn, v: _Val) -> _Val:
    res = np.empty(v.comps.shape, dtype=object)
    for idx in np.ndindex(v.comps.shape):
        res[idx] = fn(v.comps[idx])
    return _Val(v.batched, res)


def _axis(v: _Val, dim: int, rank: int) -> int:
    """The component axis of torch dim ``dim``, which must be the last."""
    d = dim % rank if rank else 0
    if d != rank - 1:
        raise Refused("indexing, stacking or summing off the last axis")
    if v.batched and d == 0:
        raise Refused("indexing or summing the batch axis")
    return v.comps.ndim - 1


def _take(comps: np.ndarray, idx, axis: int) -> np.ndarray:
    """np.take that keeps an object array (a 0-d one for one index)."""
    if isinstance(idx, int):
        return np.squeeze(np.take(comps, [idx], axis=axis), axis=axis)
    return np.take(comps, idx, axis=axis)


def _rank(v: _Val) -> int:
    return v.comps.ndim + (1 if v.batched else 0)


def _number(a) -> bool:
    return isinstance(a, (int, float, bool)) and not isinstance(a, torch.Tensor)


def _lower(gm, prog: _Prog, inputs: List[_Val]) -> List[_Val]:
    """Lower the traced graph to per-component statements. Returns the
    output values."""
    import operator

    aten = torch.ops.aten
    env: Dict = {}
    ph = iter(inputs)

    def val(a):
        if isinstance(a, torch.fx.Node):
            v = env[a]
            if isinstance(v, list):
                raise Refused("a tuple used as a tensor")
            return v
        if _number(a):
            return _const_val(a)
        raise Refused(f"argument {type(a).__name__}")

    binary = {aten.add.Tensor: "add", aten.add.Scalar: "add", aten.sub.Tensor: "sub",
              aten.sub.Scalar: "sub", aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
              aten.div.Tensor: "div", aten.div.Scalar: "div", aten.atan2.default: "atan2",
              aten.maximum.default: "max", aten.minimum.default: "min",
              aten.logical_and.default: "and", aten.bitwise_and.Tensor: "and",
              aten.logical_or.default: "or", aten.bitwise_or.Tensor: "or"}
    for name, sym in _CMP.items():
        binary[getattr(aten, name).Tensor] = name
        binary[getattr(aten, name).Scalar] = name
    unary = {aten.neg.default: "neg", aten.sqrt.default: "sqrt", aten.rsqrt.default: "rsqrt",
             aten.exp.default: "exp", aten.log.default: "log", aten.tanh.default: "tanh",
             aten.sigmoid.default: "sigmoid", aten.abs.default: "abs",
             aten.sin.default: "sin", aten.cos.default: "cos",
             aten.logical_not.default: "not", aten.bitwise_not.default: "not"}
    same = (aten.clone.default, aten.alias.default, aten.detach.default,
            aten.lift_fresh_copy.default)

    def one(op, c):
        if op == "sin" or op == "cos":
            ref = prog.emit("cos_sin", (c,))
            return ("s", ref[1], 1) if op == "sin" else ref
        return prog.emit(op, (c,))

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(ph)
            continue
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor) or t.numel() > 1:
                raise Refused("a captured tensor of more than one element")
            if t.dtype not in (torch.float32, torch.float64, torch.bool, torch.int64,
                               torch.int32):
                raise Refused(f"a captured {t.dtype}")
            a = np.empty(tuple(t.shape), dtype=object)
            # a tensor the function makes (torch.tensor(1.5): lifted) is a
            # constant; one it captures is read at each launch
            made = bool(node.users) and all(
                u.target is aten.lift_fresh_copy.default for u in node.users)
            for idx in np.ndindex(a.shape):
                a[idx] = (("c", bool(t[idx]) if t.dtype == torch.bool else float(t[idx]))
                          if made else prog.capture(t))
            env[node] = _Val(False, a)
            continue
        if node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            return [val(o) for o in outs]
        if node.op != "call_function":
            raise Refused(f"a {node.op} node")
        f, args, kw = node.target, node.args, node.kwargs
        meta = node.meta.get("val")
        if isinstance(meta, torch.Tensor) and meta.dtype not in (torch.float32, torch.bool):
            raise Refused(f"a {meta.dtype} value")
        shape = tuple(meta.shape) if isinstance(meta, torch.Tensor) else None
        if f is operator.getitem:
            env[node] = env[args[0]][args[1]]
        elif f in same:
            env[node] = val(args[0])
        elif f is aten._to_copy.default:
            if kw.get("dtype", torch.float32) not in (torch.float32, None):
                raise Refused("a cast")
            env[node] = val(args[0])
        elif f is aten.scalar_tensor.default:
            env[node] = _const_val(args[0])
        elif f in binary:
            op = binary[f]
            if kw.get("alpha", 1) != 1 or kw.get("rounding_mode") is not None:
                raise Refused(f"{f} with alpha or a rounding mode")
            env[node] = _map(prog, op, [val(args[0]), val(args[1])], shape)
        elif f is aten.rsub.Scalar or f is aten.rsub.Tensor:
            if kw.get("alpha", 1) != 1:
                raise Refused("rsub with alpha")
            env[node] = _map(prog, "sub", [val(args[1]), val(args[0])], shape)
        elif f in unary:
            op = unary[f]
            env[node] = _unary(prog, lambda c, op=op: one(op, c), val(args[0]))
        elif f is aten.pow.Tensor_Scalar:
            e = args[1]
            if not _number(e):
                raise Refused("pow by a tensor")
            e = float(e)
            v = val(args[0])
            if e == 1.0:
                env[node] = v
            elif e == 2.0:
                env[node] = _unary(prog, lambda c: prog.emit("sq", (c,)), v)
            elif e == 0.5:
                env[node] = _unary(prog, lambda c: prog.emit("sqrt", (c,)), v)
            else:
                env[node] = _unary(prog, lambda c: prog.emit("pow", (c,), (e,)), v)
        elif f in (aten.clamp.default, aten.clamp_min.default, aten.clamp_max.default):
            lo = kw.get("min", args[1] if len(args) > 1 else None)
            hi = kw.get("max", args[2] if len(args) > 2 else None)
            if f is aten.clamp_max.default:
                lo, hi = None, args[1]
            if any(b is not None and not _number(b) for b in (lo, hi)):
                raise Refused("clamp by a tensor")
            v = val(args[0])
            if lo is not None and hi is not None:
                env[node] = _unary(prog, lambda c: prog.emit(
                    "clamp", (c,), (float(lo), float(hi))), v)
            elif lo is not None:
                env[node] = _unary(prog, lambda c: prog.emit("clamp_lo", (c,), (float(lo),)), v)
            elif hi is not None:
                env[node] = _unary(prog, lambda c: prog.emit("clamp_hi", (c,), (float(hi),)), v)
            else:
                env[node] = v
        elif f is aten.where.self or f is aten.where.ScalarSelf or f is aten.where.ScalarOther \
                or f is aten.where.Scalar:
            env[node] = _map(prog, "where", [val(a) for a in args[:3]], shape)
        elif f is aten.select.int:
            v = val(args[0])
            ax = _axis(v, args[1], _rank(v))
            env[node] = _Val(v.batched, _take(v.comps, args[2], ax))
        elif f is aten.slice.Tensor:
            v = val(args[0])
            dim = args[1] if len(args) > 1 else 0
            ax = _axis(v, dim, _rank(v))
            n = v.comps.shape[ax]
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            end = args[3] if len(args) > 3 and args[3] is not None else n
            step = args[4] if len(args) > 4 else 1
            idx = list(range(n))[slice(start, end, step)]
            env[node] = _Val(v.batched, _take(v.comps, idx, ax))
        elif f is aten.unbind.int:
            v = val(args[0])
            ax = _axis(v, args[1] if len(args) > 1 else 0, _rank(v))
            env[node] = [_Val(v.batched, _take(v.comps, i, ax))
                         for i in range(v.comps.shape[ax])]
        elif f in (aten.stack.default, aten.cat.default):
            vs = [val(a) for a in args[0]]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            if len({v.batched for v in vs}) != 1 or len({v.comps.ndim for v in vs}) != 1:
                raise Refused("stack or cat of batched and unbatched values")
            r = _rank(vs[0]) + (1 if f is aten.stack.default else 0)
            if dim % r != r - 1:
                raise Refused("stack or cat off the last axis")
            if f is aten.stack.default:
                comps = np.stack([v.comps for v in vs], axis=-1)
            else:
                if vs[0].batched and vs[0].comps.ndim == 0:
                    raise Refused("cat along the batch axis")
                comps = np.concatenate([v.comps for v in vs], axis=-1)
            env[node] = _Val(vs[0].batched, comps)
        elif f in (aten.sum.dim_IntList, aten.sum.default):
            v = val(args[0])
            dims = args[1] if len(args) > 1 else list(range(_rank(v)))
            if len(dims) != 1:
                raise Refused("a sum over several axes")
            keep = bool(args[2] if len(args) > 2 else kw.get("keepdim", False))
            ax = _axis(v, dims[0], _rank(v))
            moved = np.moveaxis(v.comps, ax, -1)
            res = np.empty(moved.shape[:-1], dtype=object)
            for idx in np.ndindex(res.shape):
                acc = moved[idx + (0,)]
                for j in range(1, moved.shape[-1]):
                    acc = prog.emit("add", (acc, moved[idx + (j,)]))
                res[idx] = acc
            env[node] = _Val(v.batched, res[..., None] if keep else res)
        else:
            raise Refused(f"{f} is outside the traced set")
    raise Refused("no output")


# ---- C++ ----

def _lit(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if math.isnan(v):
        return "K(NAN)"
    if math.isinf(v):
        return "K(INFINITY)" if v > 0 else "K(-INFINITY)"
    return f"K({v!r})"


def _emit_cpp(prog: _Prog, outs, params: str, ins: Dict[str, str], ret: Optional[str]):
    """The body of one generated function: params read, the live
    statements, then the outputs (``ret`` the output pointer, or None to
    return the one component)."""
    live = prog.live(outs)
    used_p = sorted({a[2] for k in live for a in prog.stmts[k][1]
                     if a[0] == "in" and a[1] == params}
                    | {r[2] for r in outs if r[0] == "in" and r[1] == params})
    lines = ["    using K = real_t<S>;"]
    for i in used_p:
        lines.append(f"    const K {params}{i} = K(ld_param({params} + {i}));")

    def name(ref):
        if ref[0] == "in":
            return f"{params}{ref[2]}" if ref[1] == params else f"{ins[ref[1]]}[{ref[2]}]"
        if ref[0] == "c":
            return _lit(ref[1])
        op = prog.stmts[ref[1]][0]
        if op == "cos_sin":
            return f"cs{ref[1]}{'s' if ref[2] else 'c'}"
        return f"{'b' if prog.stmts[ref[1]][2] == 'B' else 'v'}{ref[1]}"

    def as_s(ref):  # a K operand where an S is wanted
        return f"S({name(ref)})" if prog.kind(ref) == "K" else name(ref)

    for k in live:
        op, args, kind, extra = prog.stmts[k]
        T = {"S": "S", "K": "K", "B": "bool"}[kind]
        a = [name(r) for r in args]
        if op in _ARITH:
            expr = f"{a[0]} {dict(add='+', sub='-', mul='*', div='/')[op]} {a[1]}"
        elif op == "neg":
            expr = f"-{a[0]}"
        elif op == "sq":
            expr = f"{a[0]} * {a[0]}"
        elif op in ("sqrt", "rsqrt", "exp", "log", "tanh", "sigmoid", "abs"):
            expr = f"{op}_s({a[0]})"
        elif op == "pow":
            expr = f"pow_s({a[0]}, {extra[0]!r})"
        elif op in ("atan2", "max", "min"):
            fn = {"atan2": "atan2_s", "max": "max_s", "min": "min_s"}[op]
            expr = (f"{fn}({as_s(args[0])}, {as_s(args[1])})" if kind == "S"
                    else f"{fn}({a[0]}, {a[1]})")
        elif op in _CMP:
            expr = f"rv({a[0]}) {_CMP[op]} rv({a[1]})"
        elif op == "and":
            expr = f"{a[0]} && {a[1]}"
        elif op == "or":
            expr = f"{a[0]} || {a[1]}"
        elif op == "not":
            expr = f"!{a[0]}"
        elif op == "where":
            wrap = as_s if kind == "S" else name
            expr = f"{a[0]} ? {wrap(args[1])} : {wrap(args[2])}"
        elif op == "clamp":
            expr = f"clamp_sel({a[0]}, {_lit(extra[0])}, {_lit(extra[1])})"
        elif op == "clamp_lo":
            expr = f"clamp_lo({a[0]}, {_lit(extra[0])})"
        elif op == "clamp_hi":
            expr = f"clamp_hi({a[0]}, {_lit(extra[0])})"
        elif op == "cos_sin":
            lines.append(f"    {T} cs{k}c, cs{k}s;")
            lines.append(f"    cos_sin_s({a[0]}, &cs{k}c, &cs{k}s);")
            continue
        else:
            raise Refused(f"internal: no C++ for {op}")
        lines.append(f"    const {T} {name(('s', k, 0))} = {expr};")
    if ret is None:
        lines.append(f"    return {as_s(outs[0])};")
    else:
        for i, r in enumerate(outs):
            lines.append(f"    {ret}[{i}] = {as_s(r)};")
    return "\n".join(lines)


# ---- operation counts, by running the statements on counting scalars
# that mirror csrc/dual.cuh ----

class _Tally:
    def __init__(self):
        self.f32 = self.f64 = self.tangent = 0


class _C:
    """A real of the count: ``t``, it holds a tangent or was computed from
    one."""
    __slots__ = ("t",)

    def __init__(self, t=False):
        self.t = t


class _D:
    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d


class _Counter:
    """dual.cuh's arithmetic on _C / _D, tallying each real operation."""

    def __init__(self):
        self.n = _Tally()

    def op(self, *xs):
        t = any(x.t for x in xs)
        if t:
            self.n.tangent += 1
        else:
            self.n.f32 += 1
        return _C(t)

    def add(self, a, b):
        if isinstance(a, _D) and isinstance(b, _D):
            return _D(self.add(a.v, b.v), self.add(a.d, b.d))
        if isinstance(a, _D):
            return _D(self.add(a.v, b), a.d)
        if isinstance(b, _D):
            return _D(self.add(a, b.v), b.d)
        return self.op(a, b)

    def sub(self, a, b):
        if isinstance(a, _D) and isinstance(b, _D):
            return _D(self.sub(a.v, b.v), self.sub(a.d, b.d))
        if isinstance(a, _D):
            return _D(self.sub(a.v, b), a.d)
        if isinstance(b, _D):
            return _D(self.sub(a, b.v), self.neg(b.d))
        return self.op(a, b)

    def mul(self, a, b):
        if isinstance(a, _D) and isinstance(b, _D):
            return _D(self.mul(a.v, b.v), self.add(self.mul(a.d, b.v), self.mul(a.v, b.d)))
        if isinstance(a, _D):
            return _D(self.mul(a.v, b), self.mul(a.d, b))
        if isinstance(b, _D):
            return _D(self.mul(a, b.v), self.mul(a, b.d))
        return self.op(a, b)

    def div(self, a, b):
        if isinstance(a, _D) and isinstance(b, _D):
            q = self.div(a.v, b.v)
            return _D(q, self.div(self.sub(a.d, self.mul(q, b.d)), b.v))
        if isinstance(a, _D):
            return _D(self.div(a.v, b), self.div(a.d, b))
        if isinstance(b, _D):
            q = self.div(a, b.v)
            return _D(q, self.div(self.mul(self.neg(q), b.d), b.v))
        return self.op(a, b)

    def neg(self, a):
        return _D(self.neg(a.v), self.neg(a.d)) if isinstance(a, _D) else _C(a.t)

    def sqrt(self, a):
        if isinstance(a, _D):
            r = self.sqrt(a.v)
            return _D(r, self.div(a.d, self.mul(_C(), r)))
        return self.op(a)

    def rsqrt(self, a):
        if isinstance(a, _D):
            r = self.rsqrt(a.v)
            return _D(r, self.mul(self.mul(_C(), self.mul(self.mul(r, r), r)), a.d))
        return self.op(a)

    def atan2(self, y, x):
        if isinstance(y, _D):
            num = self.sub(self.mul(x.v, y.d), self.mul(y.v, x.d))
            den = self.add(self.mul(x.v, x.v), self.mul(y.v, y.v))
            return _D(self.atan2(y.v, x.v), self.div(num, den))
        return self.op(y, x)

    def cos_sin(self, a):
        if isinstance(a, _D):
            c, s = self.cos_sin(a.v)
            return _D(c, self.mul(self.neg(s), a.d)), _D(s, self.mul(c, a.d))
        self.n.f64 += COS_SIN_F64
        return _C(), _C()

    def exp(self, a):
        if isinstance(a, _D):
            e = self.exp(a.v)
            return _D(e, self.mul(a.d, e))
        return self.op(a)

    def log(self, a):
        if isinstance(a, _D):
            return _D(self.log(a.v), self.div(a.d, a.v))
        return self.op(a)

    def tanh(self, a):
        if isinstance(a, _D):
            t = self.tanh(a.v)
            return _D(t, self.mul(a.d, self.sub(_C(), self.mul(t, t))))
        return self.op(a)

    def sigmoid(self, a):
        if isinstance(a, _D):
            s = self.sigmoid(a.v)
            return _D(s, self.mul(a.d, self.mul(s, self.sub(_C(), s))))
        return self.div(_C(), self.add(_C(), self.exp(self.neg(a))))

    def abs(self, a):
        return _D(self.abs(a.v), a.d) if isinstance(a, _D) else self.op(a)

    def pow(self, a):
        if isinstance(a, _D):
            return _D(self.pow(a.v), self.mul(a.d, self.mul(_C(), self.pow(a.v))))
        return self.op(a)

    def max(self, a, b):
        if isinstance(a, _D):
            tie = self.mul(self.add(a.d, b.d), _C())
            return _D(self.max(a.v, b.v), tie)
        return self.op(a, b)

    min = max

    def sq(self, a):
        return self.mul(a, a)


def _promote(k, like):
    """S(k): a real k as a scalar of ``like``'s level (zero tangents)."""
    return _D(_promote(k, like.v), _promote(_C(), like.d)) if isinstance(like, _D) else k


def _count(prog: _Prog, outs, inputs: Dict[str, object]) -> _Tally:
    """Run the live statements on counting scalars: ``inputs`` maps an
    input's name to the scalar its components take (the params' a plain
    _C). Selects take their S side (a point where no clamp binds)."""
    cnt = _Counter()
    vals: Dict[tuple, object] = {}
    level = inputs.get("x", inputs.get("tau"))

    def get(ref):
        if ref[0] == "in":
            return inputs[ref[1]]
        if ref[0] == "c":
            return _C()
        return vals[(ref[1], ref[2])]

    for k in prog.live(outs):
        op, args, kind, extra = prog.stmts[k]
        a = [get(r) for r in args]
        if op == "cos_sin":
            c, s = cnt.cos_sin(a[0])
            vals[(k, 0)], vals[(k, 1)] = c, s
            continue
        if op in _CMP or op in ("and", "or", "not"):
            r = None
        elif op in ("clamp", "clamp_lo", "clamp_hi"):
            r = a[0]
        elif op == "where":
            pick = [x for x, ref in zip(a[1:], args[1:]) if prog.kind(ref) == "S"]
            r = pick[0] if pick else a[1]
        elif op in ("atan2", "max", "min") and kind == "S":
            a = [x if prog.kind(ref) == "S" else _promote(x, level) for x, ref in zip(a, args)]
            r = getattr(cnt, op)(*a)
        else:
            r = getattr(cnt, op)(*a)
        vals[(k, 0)] = r
    return cnt.n


def _dual(level: int):
    """A scalar of DualOf^level<float> whose innermost tangent is flagged."""
    x = _C()
    for i in range(level):
        x = _D(x, _promote(_C(i == 0), x) if i else _C(True))
    return x


def _step_ops(prog: _Prog, outs) -> StepOps:
    p = _C()
    flt = _count(prog, outs, {"x": _C(), "u": _C(), "p": p})
    dual = _count(prog, outs, {"x": _dual(1), "u": _dual(1), "p": p})
    return StepOps(flt.f32 + flt.tangent, flt.f64, dual.f32, dual.f64, dual.tangent)


def _cost_ops(prog: _Prog, outs, n: int) -> CostOps:
    flt = _count(prog, outs, {"tau": _C(), "cp": _C()})
    nested = _count(prog, outs, {"tau": _dual(2), "cp": _C()})
    return CostOps(flt.f32 + flt.tangent, flt.f64, nested.f32 + nested.tangent, nested.f64,
                   n * (n + 1) // 2)


# ---- tracing ----

def _trace(fn, samples):
    """make_fx of fn in fake mode, dead code removed; raises on a trace
    that fails (a branch on data, an unsupported call)."""
    global TRACES
    from torch.fx.experimental.proxy_tensor import make_fx

    TRACES += 1
    with torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*samples)
    gm.graph.eliminate_dead_code()
    return gm


def _lower_model(fn, nx: int, nu: int, P: int, device, captured: List[torch.Tensor]):
    prog = _Prog("p", P)
    prog.captured = captured
    gm = _trace(lambda x, u, p: fn(x, u, p),
                tuple(torch.zeros(*s, device=device) for s in ((2, nx), (2, nu), (P,))))
    outs = _lower(gm, prog, [_inputs("x", nx, True), _inputs("u", nu, True),
                             _inputs("p", P, False)])
    if len(outs) != 1 or not outs[0].batched or outs[0].comps.shape != (nx,):
        raise Refused(f"the step does not return [B, {nx}]")
    return prog, list(outs[0].comps)


class _Cache:
    """Traces by the object traced (a model or a cost function) and a key
    of shapes. The object is held weakly and its entries go when it does;
    one that takes no weak reference is traced at each call."""

    def __init__(self):
        self._by_id: Dict[int, tuple] = {}  # id(obj) -> (weakref to obj, {key: trace})

    def get(self, obj, key, make):
        hit = self._by_id.get(id(obj))
        if hit is None or hit[0]() is not obj:
            try:
                ref = weakref.ref(obj)
            except TypeError:
                return make()
            hit = self._by_id[id(obj)] = (ref, {})
            weakref.finalize(obj, self._by_id.pop, id(obj), None)
        if key not in hit[1]:
            hit[1][key] = make()
        return hit[1][key]

    def __len__(self) -> int:
        return len(self._by_id)


_MODELS = _Cache()
_COSTS = _Cache()


def _device(device) -> str:
    return torch.device(device if device is not None else "cpu").type


def model(dyn, nx: int, nu: int, n_params: int, device=None) -> Optional[TracedModel]:
    """The traced form of a Dynamics' step and linearize_point, or None
    where they break the contract. Cached by the model object (a slew-rate
    wrapper's by the model it wraps, ``Dynamics.wraps``) and (nx, nu,
    n_params, the device type the samples are made on)."""
    wraps = getattr(dyn, "wraps", None)
    key = (wraps is not None, nx, nu, n_params, _device(device))

    def make():
        try:
            bodies, ops, captured = [], [], []
            for fn in (dyn.step, dyn.linearize_point):
                # both functions read one list of captured slots
                prog, outs = _lower_model(fn, nx, nu, n_params, _device(device), captured)
                bodies.append(_emit_cpp(prog, outs, "p", {"x": "x", "u": "u"}, "out"))
                ops.append(_step_ops(prog, outs))
            src = MODEL_TEMPLATE.format(nx=nx, nu=nu, P=n_params + len(captured),
                                        step=bodies[0], lin=bodies[1])
            return TracedModel(nx, nu, n_params, src, ops[0], ops[1], tuple(captured))
        except Exception:  # a refusal, or a trace that fails: the plain loop
            return None

    return _MODELS.get(dyn if wraps is None else wraps, key, make)


def cost(fn, n: int, n_params: Optional[int], unary: bool = False,
         device=None) -> Optional[TracedCost]:
    """The traced form of a callable cost ``fn(tau [n], cost_params)``, or
    None where it breaks the contract. n_params: the flat params' length,
    or None for a cost without params, called fn(tau, ()) or, ``unary``,
    fn(tau). Cached by fn and (n, n_params, unary, the device type the
    samples are made on)."""
    dev = _device(device)

    def call(t, cp):
        return fn(t) if unary else fn(t, cp)

    def make():
        try:
            prog = _Prog("cp", n_params or 0)
            if n_params is None:
                gm = _trace(lambda tau: torch.func.vmap(lambda t: call(t, ()))(tau),
                            (torch.zeros(2, n, device=dev),))
                ins = [_inputs("tau", n, True)]
            else:
                gm = _trace(lambda tau, cp: torch.func.vmap(lambda t: call(t, cp))(tau),
                            (torch.zeros(2, n, device=dev), torch.zeros(n_params, device=dev)))
                ins = [_inputs("tau", n, True), _inputs("cp", n_params, False)]
            outs = _lower(gm, prog, ins)
            if len(outs) != 1 or not outs[0].batched or outs[0].comps.shape != ():
                raise Refused("the cost does not return one value a point")
            outs = [outs[0].comps[()]]
            body = _emit_cpp(prog, outs, "cp", {"tau": "tau"}, None)
            src = COST_TEMPLATE.format(n=n, P=(n_params or 0) + len(prog.captured), body=body)
            return TracedCost(n, n_params or 0, src, _cost_ops(prog, outs, n),
                              tuple(prog.captured), unary)
        except Exception:
            return None

    return _COSTS.get(fn, (n, n_params, unary, dev), make)


def launch_params(params: Optional[torch.Tensor], captured, device) -> torch.Tensor:
    """The params vector a launch reads: the flat params (None for none),
    then the values the captured tensors hold now, read at each launch."""
    parts = [] if params is None else [params.to(device=device, dtype=torch.float32).reshape(-1)]
    parts += [t.detach().to(device=device, dtype=torch.float32).reshape(1) for t in captured]
    return (torch.cat(parts) if parts else torch.empty(0, dtype=torch.float32, device=device))


MODEL_TEMPLATE = """struct Model {{
  static constexpr int NX = {nx};
  static constexpr int NU = {nu};
  static constexpr int NP = {P};

  template <class S, class P>
  DILQR_HD static void step(const S* x, const S* u, const P* p, S* out) {{
{step}
  }}

  template <class S, class P>
  DILQR_HD static void step_unclamped(const S* x, const S* u, const P* p, S* out) {{
{lin}
  }}
}};
"""

COST_TEMPLATE = """struct Cost {{
  static constexpr int N = {n};
  static constexpr int NP = {P};

  template <class S, class P>
  DILQR_HD static S cost(const S* tau, const P* cp) {{
{body}
  }}
}};
"""


def header(model: Optional[TracedModel] = None, cost: Optional[TracedCost] = None) -> str:
    """The generated header dilqr_traced.cuh: the model's and the cost's
    structs in namespace dilqr::traced."""
    parts = [s.source for s in (model, cost) if s is not None]
    return ("// Generated by dilqr_tpu_torch/ops/cuda/traced.py from a traced PyTorch model\n"
            "// or cost; straight-line code over the scalar S (csrc/dual.cuh).\n"
            "#pragma once\n\n#include \"ilqr_fused.cuh\"\n\nnamespace dilqr {\nnamespace traced {\n\n"
            + "\n".join(parts) + "\n}  // namespace traced\n}  // namespace dilqr\n")
