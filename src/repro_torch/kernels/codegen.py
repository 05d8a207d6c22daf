"""Expression trees -> CUDA source: the paper's generative programming,
aimed at the GPU.

The fused kernels evaluate a plan predicate (and aggregate values, and a
dense group index) per row inside the kernel.  The reference package
calls the expression evaluator from inside a Pallas tile closure; a CUDA
kernel cannot call Python, so this module writes the expression out as a
`__device__` functor and the kernel body (`csrc/*.cuh`) is instantiated
around it.  Every node kind of `fused._SAFE` is covered: Col, Const,
Param, Arith, Cmp, And, Or, Not, Where, Year, CodeEq, CodeIn and
CodeRange.

Typing follows torch's promotion for what the engine feeds the kernels
(int32 and float32 columns, Python-scalar constants and parameters): a
float anywhere makes a float, integer arithmetic stays int32, and `/`
is true division, so two ints divide as floats.  Constants are weak: a
float constant takes float32, never double.  Every float literal is
therefore emitted as the shortest decimal that round-trips its float32
value, with an `f` suffix — a bare `0.07` is a double in C++, and
`0.07f <= 0.07` is false, which would drop every row of a float32
column equal to the constant.  Year relies on positive operands: C's `/`
truncates where Python's `//` floors (see `year_of_days`).

Parameters become scalar members of the functor, filled from the
launch's arguments, so rebinding a parameter never changes the source and
never rebuilds the kernel.  The batched instances (the engine's bind-many
pass: one launch for B bindings, the binding in blockIdx.y) wrap the
functor in `struct Batch`, whose `at(b)` gives binding b's functor: each
column pointer moved by its binding stride (0 for a column every binding
shares) and each parameter read from a device vector at the binding's
index.  A batched instance is a library of its own.

A column may be a strided view (under the row layout, a column of a
record matrix): its element stride is baked into the load as a constant,
so a contiguous column's source is `c<k>[i]` as ever and a strided one
reads `c<k>[i * stride]` straight from the records.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import expr as E

_COL_TYPES = {"torch.int32": "int", "torch.float32": "float",
              "torch.bool": "bool"}
_POINTER = {"int": "const int*", "float": "const float*",
            "bool": "const bool*"}


def float_literal(v: float) -> str:
    """A float32 C++ literal for `v`, rounded to float32 first."""
    f = np.float32(v)
    if math.isnan(f):
        return "repro::f32_from_bits(0x7fc00000u)"
    if math.isinf(f):
        return "repro::f32_from_bits(0x7f800000u)" if f > 0 \
            else "repro::f32_from_bits(0xff800000u)"
    s = str(f)
    if not any(ch in s for ch in ".e"):
        s += ".0"
    return s + "f"


def _int_literal(v: int) -> str:
    v = int(v)
    if not -(2**31) <= v < 2**31:
        raise ValueError(f"integer constant {v} does not fit int32")
    return str(v) if v != -(2**31) else "(-2147483647 - 1)"


_KINDS = ("float", "int", "bool")


def _scalar_type(v) -> str:
    """The C kind of a kernel parameter: of a Python or numpy scalar, of a
    0-d or (B,) tensor by its dtype, or a kind name itself (the batched
    wrappers, whose parameters are device vectors)."""
    if isinstance(v, str) and v in _KINDS:
        return v
    if hasattr(v, "dtype") and hasattr(v, "is_floating_point"):   # tensor
        if v.dtype.is_floating_point:
            return "float"
        return "bool" if str(v.dtype) == "torch.bool" else "int"
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    raise TypeError(f"unsupported kernel scalar {v!r} ({type(v).__name__})")


def _promote(a: str, b: str) -> str:
    if "float" in (a, b):
        return "float"
    return "int"


def _cast(code: str, have: str, want: str) -> str:
    return code if have == want else f"({want}){code}"


class Emitter:
    """Emits C++ expressions over `x<k>` (column k at row i, loaded by
    `loads`) and `p<k>` parameter members.  `col_types` maps each column
    name (in argument order) to "int" | "float" | "bool"; `param_types`
    does the same for the parameters; `col_strides` gives a column's
    element stride where it is not 1."""

    def __init__(self, col_types: dict[str, str], param_types: dict[str, str],
                 col_strides: dict[str, int] | None = None):
        self.cols = list(col_types)
        self.col_types = dict(col_types)
        self.col_strides = dict(col_strides or {})
        self.params = list(param_types)
        self.param_types = dict(param_types)
        self.used: set[int] = set()

    def col(self, name: str) -> tuple[str, str]:
        k = self.cols.index(name)
        self.used.add(k)
        return f"x{k}", self.col_types[name]

    def loads(self) -> list[str]:
        """Statements loading every column emitted since the last call,
        each once, ahead of the expression: it then reads registers only,
        so no `&&`, `||` or `?:` puts a load behind a branch, and a kernel
        that evaluates several rows has all their loads in flight."""
        out = [f"    const {self.col_types[c]} x{k} = c{k}[{self._row(c)}];"
               for k, c in enumerate(self.cols) if k in self.used]
        self.used.clear()
        return out

    def _row(self, name: str) -> str:
        st = self.col_strides.get(name, 1)
        return "i" if st == 1 else f"i * {int(st)}LL"

    def emit(self, e) -> tuple[str, str]:
        """(C++ expression, its type) for one Expr node."""
        if isinstance(e, E.Col):
            return self.col(e.name)
        if isinstance(e, E.Const):
            v = e.value
            if isinstance(v, (bool, np.bool_)):
                return ("true" if v else "false"), "bool"
            if isinstance(v, (int, np.integer)):
                return _int_literal(v), "int"
            return float_literal(v), "float"
        if isinstance(e, E.Param):
            return f"p{self.params.index(e.name)}", self.param_types[e.name]
        if isinstance(e, E.Arith):
            (l, lt), (r, rt) = self.emit(e.lhs), self.emit(e.rhs)
            t = "float" if e.op == "/" else _promote(lt, rt)
            return f"({_cast(l, lt, t)} {e.op} {_cast(r, rt, t)})", t
        if isinstance(e, E.Cmp):
            (l, lt), (r, rt) = self.emit(e.lhs), self.emit(e.rhs)
            t = _promote(lt, rt)
            return f"({_cast(l, lt, t)} {e.op} {_cast(r, rt, t)})", "bool"
        if isinstance(e, E.And):
            return f"({self.emit(e.lhs)[0]} && {self.emit(e.rhs)[0]})", "bool"
        if isinstance(e, E.Or):
            return f"({self.emit(e.lhs)[0]} || {self.emit(e.rhs)[0]})", "bool"
        if isinstance(e, E.Not):
            return f"(!{self.emit(e.operand)[0]})", "bool"
        if isinstance(e, E.Where):
            c = self.emit(e.cond)[0]
            (t, tt), (o, ot) = self.emit(e.then), self.emit(e.other)
            ty = "bool" if tt == ot == "bool" else _promote(tt, ot)
            return (f"({c} ? {_cast(t, tt, ty)} : {_cast(o, ot, ty)})", ty)
        if isinstance(e, E.Year):
            x, xt = self.emit(e.operand)
            if xt != "int":
                raise TypeError("Year takes an integer date operand")
            return f"repro::year_of_days({x})", "int"
        if isinstance(e, E.CodeEq):
            c, _ = self.col(e.col)
            op = "!=" if e.negate else "=="
            return f"({c} {op} {_int_literal(e.code)})", "bool"
        if isinstance(e, E.CodeIn):
            c, _ = self.col(e.col)
            if not e.codes:
                return "false", "bool"
            return ("(" + " || ".join(f"{c} == {_int_literal(k)}"
                                      for k in e.codes) + ")"), "bool"
        if isinstance(e, E.CodeRange):
            c, _ = self.col(e.col)
            return (f"({c} >= {_int_literal(e.lo)} && "
                    f"{c} < {_int_literal(e.hi)})"), "bool"
        raise TypeError(f"{type(e).__name__} has no kernel form")

    def members(self) -> list[str]:
        out = [f"  {_POINTER[self.col_types[c]]} c{k};  // {c}"
               for k, c in enumerate(self.cols)]
        out += [f"  {self.param_types[p]} p{k};  // param {p}"
                for k, p in enumerate(self.params)]
        return out

    def fill(self, var: str) -> list[str]:
        """Statements filling functor `var` from the launcher's arguments:
        `cols` (device pointers), `fp` (float params as double) and `ip`
        (int and bool params as long long), positional per kind."""
        out = [f"  {var}.c{k} = ({_POINTER[self.col_types[c]]})cols[{k}];"
               for k, c in enumerate(self.cols)]
        nf = ni = 0
        for k, p in enumerate(self.params):
            t = self.param_types[p]
            if t == "float":
                out.append(f"  {var}.p{k} = (float)fp[{nf}];")
                nf += 1
            else:
                out.append(f"  {var}.p{k} = ({t})ip[{ni}];")
                ni += 1
        return out


    def batch_struct(self) -> list[str]:
        """`struct Batch` around `Src` (emitted after it): binding b's
        functor is `at(b)`, its columns `cs[k]` elements past binding 0's
        and its parameters read from `fp` / `ip` (float params as double,
        the others as long long, positional per kind, as in `fill`) at row
        b, rows `fps` / `ips` apart (0: one row for every binding)."""
        out = ["struct Batch {", "  Src s;",
               f"  long long cs[{max(len(self.cols), 1)}];",
               "  const double* fp;", "  long long fps;",
               "  const long long* ip;", "  long long ips;",
               "  __device__ __forceinline__ Src at(int b) const {",
               "    Src r = s;"]
        out += [f"    r.c{k} = s.c{k} + (long long)b * cs[{k}];"
                for k in range(len(self.cols))]
        nf = ni = 0
        for k, p in enumerate(self.params):
            t = self.param_types[p]
            if t == "float":
                out.append(f"    r.p{k} = (float)fp[(long long)b * fps + "
                           f"{nf}];")
                nf += 1
            else:
                out.append(f"    r.p{k} = ({t})ip[(long long)b * ips + "
                           f"{ni}];")
                ni += 1
        return out + ["    return r;", "  }", "};"]

    def fill_batch(self, var: str) -> list[str]:
        """Statements filling `Batch` `var` from the batched launcher's
        arguments (`_BATCH_ARGS`)."""
        out = [f"  {var}.s.c{k} = ({_POINTER[self.col_types[c]]})cols[{k}];"
               for k, c in enumerate(self.cols)]
        out += [f"  {var}.cs[{k}] = cstrides[{k}];"
                for k in range(len(self.cols))]
        return out + [f"  {var}.fp = fp;", f"  {var}.fps = fps;",
                      f"  {var}.ip = ip;", f"  {var}.ips = ips;"]


def column_types(cols: dict) -> dict[str, str]:
    """C element type of each column tensor, in argument order."""
    out = {}
    for name, t in cols.items():
        ty = _COL_TYPES.get(str(t.dtype))
        if ty is None:
            raise TypeError(f"column {name!r} has dtype {t.dtype}; the "
                            "kernels take int32, float32 or bool columns")
        out[name] = ty
    return out


def column_strides(cols: dict) -> dict[str, int]:
    """Element stride of each column tensor (a 1-D view of positive
    stride: a contiguous column, or a column of a record matrix)."""
    out = {}
    for name, t in cols.items():
        st = t.stride(0) if t.ndim == 1 else 0
        if st < 1 and t.numel() > 1:
            raise ValueError(f"column {name!r} is not a 1-D view of "
                             f"positive stride (stride {t.stride()})")
        out[name] = max(st, 1)
    return out


def emitter(cols: dict, param_names: list[str], scalars: list) -> Emitter:
    """The Emitter of a call's operands: column types and strides,
    parameter kinds."""
    return Emitter(column_types(cols), param_types(param_names, scalars),
                   column_strides(cols))


def param_types(param_names: list[str], scalars: list) -> dict[str, str]:
    return {p: _scalar_type(v) for p, v in zip(param_names, scalars)}


_KEYS: dict[int, tuple] = {}
_KEYS_MAX = 4096


def _structure(e):
    if dataclasses.is_dataclass(e):
        return (type(e).__name__,
                *(_structure(getattr(e, f.name))
                  for f in dataclasses.fields(e)))
    if isinstance(e, (tuple, list)):
        return tuple(_structure(x) for x in e)
    return type(e).__name__, repr(e)


def expr_key(e) -> tuple:
    """A key of expression `e` that differs wherever the source emitted
    for it could: the tree's own equality does not (`Const(1) ==
    Const(1.0) == Const(True)`, `Const(0.0) == Const(-0.0)`, and a NaN
    constant equals no tree), so each leaf is spelled by its type and
    repr.  Memoized by identity — a staged plan hands the same tree on
    every run — and the entry holds the tree, so its id cannot be reused
    while it is cached."""
    hit = _KEYS.get(id(e))
    if hit is not None and hit[0] is e:
        return hit[1]
    if len(_KEYS) >= _KEYS_MAX:
        _KEYS.clear()
    key = _structure(e)
    _KEYS[id(e)] = (e, key)
    return key


def operand_key(cols: dict, param_names: list[str], scalars: list) -> tuple:
    """What of a call's operands the generated source depends on: each
    column's name, dtype and stride in argument order, each parameter's
    name and kind (never its value: rebinding a parameter keeps the
    library).  For a batched instance, `cols` are one binding's views;
    the callers add the instance's kind to the key."""
    return (tuple((name, str(t.dtype), t.stride(0) if t.ndim == 1 else 0)
                  for name, t in cols.items()),
            tuple(param_names), tuple(_scalar_type(v) for v in scalars))


def split_scalars(param_names: list[str], scalars: list
                  ) -> tuple[list[float], list[int]]:
    """The launch's float and integer parameter arrays (see `fill`)."""
    fp, ip = [], []
    for v in scalars:
        if _scalar_type(v) == "float":
            fp.append(float(v))
        else:
            ip.append(int(v))
    return fp, ip


_HEADER = "// Generated by repro_torch/kernels/codegen.py from plan " \
          "expressions.\n"
_ARGS = "const void* const* cols, const double* fp, const long long* ip"
_BATCH_ARGS = ("const void* const* cols, const long long* cstrides, "
               "const double* fp, long long fps, const long long* ip, "
               "long long ips, int B")


def functor_source(em: Emitter, pred, values: list = (), radix=(),
                   n_groups: int = 1) -> str:
    """`struct Src`: the row functor the kernel bodies are instantiated
    around — `pred(i)`, `group(i)` (the clipped mixed-radix index over
    `radix`, or 0) and `values(i, v)` (each value expression as float).
    Each method loads the columns it reads first (`Emitter.loads`)."""
    em.used.clear()
    p, _ = em.emit(pred)
    pred_body = [*em.loads(), f"    return {p};"]
    vals = [f"    v[{k}] = (float){em.emit(e)[0]};"
            for k, e in enumerate(values)]
    vals = [*em.loads(), *vals]
    if radix:
        terms = " + ".join(f"(int){em.col(g)[0]} * {_int_literal(st)}"
                           for g, _d, st in radix)
        group = [*em.loads(), f"    const int g = {terms};",
                 f"    return g < 0 ? 0 : (g > {n_groups - 1} ? "
                 f"{n_groups - 1} : g);"]
    else:
        group = ["    return 0;"]
    return "\n".join([
        "struct Src {", *em.members(),
        "  __device__ __forceinline__ bool pred(long long i) const {",
        *pred_body, "  }",
        "  __device__ __forceinline__ int group(long long i) const {",
        *group, "  }",
        "  __device__ __forceinline__ void values(long long i, float* v)"
        " const {", *vals, "  }", "};"])


def compact_pred_source(pred, em: Emitter) -> str:
    """A library exporting `repro_compact_pred`: the one-pass compaction
    (`csrc/compact.cuh`) instantiated on the predicate's functor, so the
    predicate is evaluated inside the look-back scan, in the workspace
    layout described there: one memset and one launch."""
    return "\n".join([
        _HEADER + '#include "compact.cuh"', "",
        "namespace {", functor_source(em, pred), "}  // namespace", "",
        f'extern "C" int repro_compact_pred({_ARGS},',
        "                                 long long n, int* ws,"
        " long long ws_words,",
        "                                 int cap, int translate,"
        " cudaStream_t stream) {",
        "  Src s{};", *em.fill("s"),
        "  return repro::compact_into(s, n, ws, ws_words, cap, translate != 0,",
        "                             stream);",
        "}", ""])


def compact_pred_batch_source(pred, em: Emitter) -> str:
    """A library exporting `repro_compact_pred_batched`: the look-back
    scan over B bindings of the predicate (`csrc/compact.cuh`'s binding
    axis), one 2-D memset and one launch; binding b's workspace row is
    `repro_compact_row_words` words past binding a's."""
    return "\n".join([
        _HEADER + '#include "compact.cuh"', "",
        "namespace {", functor_source(em, pred), *em.batch_struct(),
        "}  // namespace", "",
        f'extern "C" int repro_compact_pred_batched({_BATCH_ARGS},',
        "    long long n, int* ws, long long ws_words, int cap,"
        " int translate,",
        "    cudaStream_t stream) {",
        "  Batch bt{};", *em.fill_batch("bt"),
        "  return repro::compact_batch_into(bt, B, n, ws, ws_words, cap,",
        "                                   translate != 0, stream);",
        "}", ""])


def selective_agg_source(pred, values: list, radix, n_groups: int,
                         em: Emitter) -> str:
    """A library exporting `repro_selective_agg`: the aggregation kernel
    (`csrc/filter_agg.cuh`) with predicate, values and the mixed-radix
    group index evaluated in-kernel, instantiated for its own number of
    groups and values (so for one of the two regimes only); a non-null
    `mask_out` receives the predicate as one byte per row (the capacity
    form)."""
    nv = len(values)
    return "\n".join([
        _HEADER + '#include "filter_agg.cuh"', "",
        "namespace {", functor_source(em, pred, values, radix, n_groups),
        "}  // namespace", "",
        f'extern "C" int repro_selective_agg({_ARGS},',
        "    long long n, int G, int nb, int* ws, int* out, int* ticket,",
        "    uint8_t* mask_out, cudaStream_t stream) {",
        "  Src s{};", *em.fill("s"),
        f"  return repro::launch_agg<Src, {nv}, {n_groups}>(",
        f"      s, n, G, {nv}, nb, ws, out, ticket, mask_out, stream);",
        "}", ""])


def selective_agg_batch_source(pred, values: list, radix, n_groups: int,
                               em: Emitter) -> str:
    """A library exporting `repro_selective_agg_batched`: the selective
    aggregation over B bindings (`csrc/filter_agg.cuh`'s binding axis,
    capacity 0), one launch with its fold in the register regime; B result
    rows `out_row` words apart and one ticket a binding."""
    nv = len(values)
    return "\n".join([
        _HEADER + '#include "filter_agg.cuh"', "",
        "namespace {", functor_source(em, pred, values, radix, n_groups),
        *em.batch_struct(), "}  // namespace", "",
        f'extern "C" int repro_selective_agg_batched({_BATCH_ARGS},',
        "    long long n, int G, int nb, int* ws, int* out, long long out_row,",
        "    int* ticket, cudaStream_t stream) {",
        "  Batch bt{};", *em.fill_batch("bt"),
        f"  return repro::launch_agg_batch<Batch, {nv}, {n_groups}>(",
        f"      bt, B, n, G, {nv}, nb, ws, out, out_row, ticket, nullptr,"
        " stream);",
        "}", ""])
