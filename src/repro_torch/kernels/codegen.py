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
index.  A batched instance is a library of its own.  The batched
aggregation adds `struct Stage` (`stage_source`), which reads the
columns every binding shares from a stage of shared memory.  The batched
compaction adds `struct Tile` (`tile_source`): the predicate split into
the top-level conjuncts that read no parameter, evaluated once a row for
every binding, and those that do, evaluated a binding at a time over a
shared-memory copy of the columns they read; the staged program
specialises away what the bindings share.

A column may be a strided view (under the row layout, a column of a
record matrix): its element stride is baked into the load as a constant,
so a contiguous column's source is `c<k>[i]` as ever and a strided one
reads `c<k>[i * stride]` straight from the records.
"""
from __future__ import annotations

import dataclasses
import functools
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

    def loads(self, staged=None, tile=None) -> list[str]:
        """Statements loading every column emitted since the last call,
        each once, ahead of the expression: it then reads registers only,
        so no `&&`, `||` or `?:` puts a load behind a branch, and a kernel
        that evaluates several rows has all their loads in flight.  A
        column in `staged` (indices; a `Stage` method) is read from the
        quad's registers, `q<k>[r]`, one in `tile` (index -> byte offset;
        a `Tile` method) from the tile's shared-memory copy at row r, the
        others from device memory."""
        out = []
        for k, c in enumerate(self.cols):
            if k not in self.used:
                continue
            ty = self.col_types[c]
            if staged is not None and k in staged:
                at = f"q{k}[r]"
            elif tile is not None and k in tile:
                at = f"reinterpret_cast<const {ty}*>(tile + {tile[k]})[r]"
            else:
                at = f"c{k}[{self._row(c)}]"
            out.append(f"    const {ty} x{k} = {at};")
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


def _bodies(em: Emitter, pred, values, radix, n_groups: int,
            staged=None) -> tuple[list[str], list[str], list[str]]:
    """The bodies of the row methods `pred`, `group` and `values`, each
    loading the columns it reads first (`Emitter.loads`, `staged` as
    there)."""
    em.used.clear()
    p, _ = em.emit(pred)
    pred_body = [*em.loads(staged), f"    return {p};"]
    vals = [f"    v[{k}] = (float){em.emit(e)[0]};"
            for k, e in enumerate(values)]
    vals = [*em.loads(staged), *vals]
    if radix:
        terms = " + ".join(f"(int){em.col(g)[0]} * {_int_literal(st)}"
                           for g, _d, st in radix)
        group = [*em.loads(staged), f"    const int g = {terms};",
                 f"    return g < 0 ? 0 : (g > {n_groups - 1} ? "
                 f"{n_groups - 1} : g);"]
    else:
        group = ["    return 0;"]
    return pred_body, group, vals


def functor_source(em: Emitter, pred, values: list = (), radix=(),
                   n_groups: int = 1) -> str:
    """`struct Src`: the row functor the kernel bodies are instantiated
    around — `pred(i)`, `group(i)` (the clipped mixed-radix index over
    `radix`, or 0) and `values(i, v)` (each value expression as float).
    Each method loads the columns it reads first (`Emitter.loads`)."""
    pred_body, group, vals = _bodies(em, pred, values, radix, n_groups)
    return "\n".join([
        "struct Src {", *em.members(),
        "  __device__ __forceinline__ bool pred(long long i) const {",
        *pred_body, "  }",
        "  __device__ __forceinline__ int group(long long i) const {",
        *group, "  }",
        "  __device__ __forceinline__ void values(long long i, float* v)"
        " const {", *vals, "  }", "};"])


# rows of one grid-stride step of a warp of the register regime, the slice
# of a column a stage holds (csrc/filter_agg.cuh: kStageRows)
SLICE_ROWS = 128
_ELEM_BYTES = {"int": 4, "float": 4, "bool": 1}
_VEC = {"int": "int4", "float": "float4", "bool": "uchar4"}


def stage_layout(em: Emitter, staged) -> list[tuple[int, int, int]]:
    """(column index, element bytes, byte offset in a stage) of each
    staged column (names, in any order), in argument order."""
    out, off = [], 0
    for k, c in enumerate(em.cols):
        if c in staged:
            size = _ELEM_BYTES[em.col_types[c]]
            out.append((k, size, off))
            off += size * SLICE_ROWS
    return out


def stage_source(em: Emitter, pred, values: list, radix, n_groups: int,
                 staged=()) -> str:
    """`struct Stage : Src`: the staged columns of the staged batched
    aggregation (`csrc/filter_agg.cuh`'s `agg_staged_kernel`): each
    `staged` column (a name; every binding shares it) has a slice of
    SLICE_ROWS rows (a warp's step) at its offset in a stage of shared
    memory; `load` takes a lane's quad of each into registers (`q<k>[4]`,
    one vector load each) and `pred_q`, `group_q`, `values_q` evaluate
    row i, slot r of the quad, from those registers and the other
    columns from device memory."""
    layout = stage_layout(em, staged)
    ks = {k for k, _s, _o in layout}
    nbytes = sum(size for _k, size, _o in layout) * SLICE_ROWS
    each = [f"    f(reinterpret_cast<const unsigned char*>(c{k}), {size}, "
            f"{off});" for k, size, off in layout]
    load = []
    for k, _size, off in layout:
        ty = em.col_types[em.cols[k]]
        vec = _VEC[ty]
        get = (lambda c: f"w.{c} != 0") if ty == "bool" else \
            (lambda c: f"w.{c}")
        load.append(f"    {{ const {vec} w = reinterpret_cast<const {vec}*>"
                    f"(stage + {off})[quad];")
        load.append("      " + " ".join(f"q{k}[{r}] = {get(c)};"
                                         for r, c in enumerate("xyzw"))
                    + " }")
    pred_body, group, vals = _bodies(em, pred, values, radix, n_groups,
                                     staged=ks)
    return "\n".join([
        "struct Stage : Src {",
        f"  static constexpr int kCols = {len(layout)};",
        f"  static constexpr int kBytes = {nbytes};",
        *[f"  {em.col_types[em.cols[k]]} q{k}[4];  // {em.cols[k]}, staged"
          for k in sorted(ks)],
        "  template <class F>",
        "  __device__ __forceinline__ void each(F&& f) const {", *each,
        "  }",
        "  __device__ __forceinline__ void load(const unsigned char* stage,"
        " int quad) {", *load, "  }",
        "  __device__ __forceinline__ bool pred_q(long long i, int r)"
        " const {", *pred_body, "  }",
        "  __device__ __forceinline__ int group_q(long long i, int r)"
        " const {", *group, "  }",
        "  __device__ __forceinline__ void values_q(long long i, int r,"
        " float* v) const {", *vals, "  }", "};"])


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


# rows of the batched predicate compaction's tile, which its shared-memory
# copy holds (csrc/compact.cuh: kCompactRows)
TILE_ROWS = 4096


def conjuncts(e) -> list:
    """The top-level conjuncts of `e`, in order (`e` itself where it is no
    conjunction)."""
    if isinstance(e, E.And):
        return conjuncts(e.lhs) + conjuncts(e.rhs)
    return [e]


def reads_param(e) -> bool:
    """Whether any node of `e` is a Param."""
    if isinstance(e, E.Param):
        return True
    if dataclasses.is_dataclass(e):
        return any(reads_param(getattr(e, f.name))
                   for f in dataclasses.fields(e))
    if isinstance(e, (tuple, list)):
        return any(reads_param(x) for x in e)
    return False


def split_predicate(pred) -> tuple:
    """(free, bound): the conjunction of the predicate's top-level
    conjuncts that read no parameter, and of those that do, each in
    order, None for an empty one (true).  free AND bound is the predicate
    on every row: a conjunct is the same C++ expression in either place.
    A predicate that is no conjunction is wholly one or the other."""
    free = [c for c in conjuncts(pred) if not reads_param(c)]
    bound = [c for c in conjuncts(pred) if reads_param(c)]
    fold = (lambda cs: None if not cs else
            functools.reduce(lambda a, b: E.And(a, b), cs))
    return fold(free), fold(bound)


def tile_layout(em: Emitter, bound) -> dict[int, int]:
    """Column index -> byte offset in the tile's shared-memory copy, for
    each column the bound conjuncts read (4-byte columns first, so every
    array stays aligned; TILE_ROWS rows each)."""
    if bound is None:
        return {}
    names = sorted(E.expr_columns(bound),
                   key=lambda c: (-_ELEM_BYTES[em.col_types[c]],
                                  em.cols.index(c)))
    out, off = {}, 0
    for c in names:
        out[em.cols.index(c)] = off
        off += _ELEM_BYTES[em.col_types[c]] * TILE_ROWS
    return out


def tile_row_bytes(em: Emitter, pred) -> int:
    """Shared-memory bytes a row of the tile's copy takes."""
    return sum(_ELEM_BYTES[em.col_types[em.cols[k]]]
               for k in tile_layout(em, split_predicate(pred)[1]))


def tile_source(em: Emitter, pred) -> str:
    """`struct Tile : Src`: the predicate split for the batched
    compaction over shared columns (`csrc/compact.cuh`'s
    `compact_tile_kernel`): `free_pred(i)`, the conjuncts that read no
    parameter, from device memory, once a row for every binding;
    `stage(tile, i, r)`, which copies row i of every column the other
    conjuncts read to row r of the tile's shared-memory copy; and
    `bound_pred(tile, r)`, those conjuncts from that copy and the
    binding's parameters."""
    free, bound = split_predicate(pred)
    layout = tile_layout(em, bound)
    em.used.clear()
    fcode = em.emit(free)[0] if free is not None else "true"
    fbody = [*em.loads(), f"    return {fcode};"]
    bcode = em.emit(bound)[0] if bound is not None else "true"
    bbody = [*em.loads(tile=layout), f"    return {bcode};"]
    stage = [f"    reinterpret_cast<{em.col_types[em.cols[k]]}*>(tile + {off})"
             f"[r] = c{k}[{em._row(em.cols[k])}];"
             for k, off in layout.items()]
    return "\n".join([
        "struct Tile : Src {",
        f"  static constexpr int kBytes = {tile_row_bytes(em, pred)};"
        "  // a row's copy",
        "  __device__ __forceinline__ bool free_pred(long long i) const {",
        *fbody, "  }",
        "  __device__ __forceinline__ void stage(unsigned char* tile,"
        " long long i, int r) const {", *stage, "  }",
        "  __device__ __forceinline__ bool bound_pred("
        "const unsigned char* tile, int r) const {", *bbody, "  }", "};"])


def compact_pred_batch_source(pred, em: Emitter) -> str:
    """A library exporting `repro_compact_pred_batched`: the look-back
    scan over B bindings of the predicate (`csrc/compact.cuh`'s binding
    axis), one 2-D memset and one launch; binding b's workspace row is
    `repro_compact_row_words` words past binding a's.  And
    `repro_compact_pred_batched_tile`, the same where every column is
    shared (`compact_tile_kernel` over `tile_source`'s split predicate:
    one tile for every binding), rows `repro_compact_tile_row_words`
    words apart."""
    return "\n".join([
        _HEADER + '#include "compact.cuh"', "",
        "namespace {", functor_source(em, pred), *em.batch_struct(),
        tile_source(em, pred),
        f"static_assert({TILE_ROWS} == repro::kCompactRows, "
        '"codegen.TILE_ROWS");',
        "}  // namespace", "",
        f'extern "C" int repro_compact_pred_batched({_BATCH_ARGS},',
        "    long long n, int* ws, long long ws_words, int cap,"
        " int translate,",
        "    cudaStream_t stream) {",
        "  Batch bt{};", *em.fill_batch("bt"),
        "  return repro::compact_batch_into(bt, B, n, ws, ws_words, cap,",
        "                                   translate != 0, stream);",
        "}", "",
        f'extern "C" int repro_compact_pred_batched_tile({_BATCH_ARGS},',
        "    long long n, int* ws, long long ws_words, int cap,"
        " int translate,",
        "    cudaStream_t stream) {",
        "  Batch bt{};", *em.fill_batch("bt"),
        "  return repro::compact_tile_into<Batch, Tile>(bt, B, n, ws,"
        " ws_words, cap,",
        "                                               translate != 0,"
        " stream);",
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
                               em: Emitter, staged=()) -> str:
    """A library exporting `repro_selective_agg_batched`: the selective
    aggregation over B bindings at capacity 0, one launch with its fold:
    in the register regime the staged kernel (`csrc/filter_agg.cuh`, a
    warp a binding, clusters of C blocks, the `staged` columns multicast
    to each cluster's shared memory; `stage_source`), else the
    shared-memory regime's binding axis; B result rows `out_row` words
    apart and one ticket a binding.  `repro_selective_agg_batched_rows`
    gives the workspace rows a binding needs,
    `repro_selective_agg_batched_info` the staged instance's clusters
    resident at once, shared memory, stages, staged columns and warps a
    block."""
    nv = len(values)
    return "\n".join([
        _HEADER + '#include "filter_agg.cuh"', "",
        "namespace {", functor_source(em, pred, values, radix, n_groups),
        *em.batch_struct(),
        stage_source(em, pred, values, radix, n_groups, staged),
        f"static_assert({SLICE_ROWS} == repro::kStageRows, "
        '"codegen.SLICE_ROWS");',
        "}  // namespace", "",
        f'extern "C" int repro_selective_agg_batched({_BATCH_ARGS},',
        "    int C, long long n, int G, int nb, int* ws, int* out,",
        "    long long out_row, int* ticket, cudaStream_t stream) {",
        "  Batch bt{};", *em.fill_batch("bt"),
        f"  return repro::launch_agg_staged<Batch, Stage, {nv}, {n_groups}>(",
        f"      bt, B, C, n, G, {nv}, nb, ws, out, out_row, ticket, stream);",
        "}", "",
        'extern "C" int repro_selective_agg_batched_rows(int nb, int* out) {',
        f"  return repro::agg_staged_rows<Batch, {nv}, {n_groups}>(nb, out);",
        "}", "",
        'extern "C" int repro_selective_agg_batched_info(int B, int C,'
        " int* out) {",
        f"  return repro::agg_staged_info<Batch, Stage, {nv}, {n_groups}>(B,"
        " C, out);",
        "}", ""])
