"""Scalar expression IR + evaluator.

Expressions are immutable, structurally hashable dataclasses — structural
hashing gives us common-subexpression elimination (§3.6 / the motivating
example's shared ``1 - S.B``) for free: the staging evaluator memoizes on
the expression node within one evaluation context.

String operations exist in two families, mirroring the paper §3.4:

  high level  : StrEq / StrIn / StrStartsWith / StrContainsWord evaluate
                against fixed-width char matrices (strcmp-style byte loops —
                the *unoptimized* representation);
  lowered     : CodeEq / CodeIn / CodeRange / WordCode evaluate against
                int32 dictionary codes.  The StringDictionary pass rewrites
                the former into the latter using the (ordered) vocabularies.

The evaluator is backend-generic: `xp` is numpy (host-side constant
work) or torch (the staged program, on CPU or CUDA tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

Expr = Union[
    "Col", "Const", "Param", "Arith", "Cmp", "And", "Or", "Not",
    "StrEq", "StrIn", "StrStartsWith", "StrContainsWord",
    "CodeEq", "CodeIn", "CodeRange", "WordCode",
]


@dataclasses.dataclass(frozen=True)
class Col:
    name: str


@dataclasses.dataclass(frozen=True)
class Const:
    value: Any  # int | float | bool


@dataclasses.dataclass(frozen=True)
class Param:
    """A named query parameter (compile-once / bind-many execution).

    Numeric params (`dtype` in int32/int64/float32/float64/bool) are *runtime*
    parameters: the staged program receives them as scalar inputs, so a new
    binding re-executes the already-jitted XLA callable without re-staging.
    `dtype == "str"` params (and any Param used as `Limit.n`) are *compile
    time*: they must be substituted into the plan before optimization (the
    string-dictionary / top-k rewrites need the concrete value) and therefore
    participate in the plan-cache key.
    """
    name: str
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Arith:
    op: str  # + - * /
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str  # < <= == != > >=
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class And:
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Or:
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Not:
    operand: Expr


@dataclasses.dataclass(frozen=True)
class Where:
    cond: Expr
    then: Expr
    other: Expr


@dataclasses.dataclass(frozen=True)
class Year:
    """Civil year from a days-since-epoch DATE column (vectorized
    Gregorian conversion, Hinnant's algorithm — pure integer ops)."""
    operand: Expr


# -- high-level string predicates (char-matrix evaluation) -------------------

@dataclasses.dataclass(frozen=True)
class StrEq:
    col: str
    value: "str | Param"   # Param here is compile-time (substituted pre-opt)
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class StrIn:
    col: str
    values: "tuple[str | Param, ...]"


@dataclasses.dataclass(frozen=True)
class StrStartsWith:
    col: str
    prefix: "str | Param"


@dataclasses.dataclass(frozen=True)
class StrContainsWord:
    col: str
    word: "str | Param"
    negate: bool = False


# -- dictionary-lowered string predicates (§3.4, Table II) --------------------

@dataclasses.dataclass(frozen=True)
class CodeEq:
    col: str
    code: int
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class CodeIn:
    col: str
    codes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CodeRange:
    col: str
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class WordCode:
    col: str
    code: int
    negate: bool = False


# -- convenience builders -----------------------------------------------------

def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Const:
    return Const(v)


_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}
_CMP = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


class EvalEnv:
    """Column resolution + string metadata + optional CSE cache.

    `get_num(name)`   -> numeric array for a column
    `get_codes(name)` -> int32 dictionary codes
    `get_chars(name)` -> uint8[n, w] char matrix (CAT) for strcmp-style ops
    `get_words(name)` -> int32[n, W] word-code matrix (TEXT)
    `get_word_chars(name)` -> uint8[n, w] char matrix of the joined text
    `encode(name, s)`, `encode_word(name, s)`, `code_range(name, prefix)`
    """

    def __init__(self, xp, cse: bool = True, params: dict | None = None):
        self.xp = xp
        self.cache: dict | None = {} if cse else None
        self.params: dict = params or {}

    # subclasses implement the column accessors above.

    def get_param(self, p: "Param"):
        """Resolve a runtime parameter to a scalar (override to thread
        params through a staged program as traced inputs)."""
        if p.name not in self.params:
            raise KeyError(f"unbound query parameter {p.name!r}")
        import numpy as np

        v = self.params[p.name]
        if p.dtype == "str":
            raise TypeError(
                f"string parameter {p.name!r} must be bound at compile time")
        return np.asarray(v, dtype=p.dtype)


def eval_expr(e: Expr, env: EvalEnv):
    if env.cache is not None and e in env.cache:
        return env.cache[e]
    v = _eval(e, env)
    if env.cache is not None:
        env.cache[e] = v
    return v


def _bytes_const(s: str, width: int, xp):
    import numpy as np

    if isinstance(s, Param):
        raise TypeError(f"string parameter {s.name!r} must be bound "
                        "(substitute_params) before execution")
    b = np.zeros(width, dtype=np.uint8)
    raw = s.encode()[:width]
    b[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return b


def _eval(e: Expr, env: EvalEnv):
    xp = env.xp
    if isinstance(e, Col):
        return env.get_num(e.name)
    if isinstance(e, Const):
        return e.value
    if isinstance(e, Param):
        return env.get_param(e)
    if isinstance(e, Arith):
        return _ARITH[e.op](eval_expr(e.lhs, env), eval_expr(e.rhs, env))
    if isinstance(e, Cmp):
        return _CMP[e.op](eval_expr(e.lhs, env), eval_expr(e.rhs, env))
    if isinstance(e, And):
        return eval_expr(e.lhs, env) & eval_expr(e.rhs, env)
    if isinstance(e, Or):
        return eval_expr(e.lhs, env) | eval_expr(e.rhs, env)
    if isinstance(e, Not):
        return ~eval_expr(e.operand, env)
    if isinstance(e, Where):
        return xp.where(eval_expr(e.cond, env),
                        eval_expr(e.then, env), eval_expr(e.other, env))
    if isinstance(e, Year):
        z = eval_expr(e.operand, env) + 719468
        era = z // 146097
        doe = z - era * 146097
        yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
        y = yoe + era * 400
        doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
        mp = (5 * doy + 2) // 153
        m = xp.where(mp < 10, mp + 3, mp - 9)
        y = y + (m <= 2)
        if hasattr(y, "astype"):          # numpy
            return y.astype("int32")
        import torch

        return y.to(torch.int32)

    # ---- char-matrix (unoptimized) string ops ------------------------------
    if isinstance(e, StrEq):
        chars = env.get_chars(e.col)
        const = _bytes_const(e.value, chars.shape[1], xp)
        eq = (chars == const[None, :]).all(axis=1)
        return ~eq if e.negate else eq
    if isinstance(e, StrIn):
        chars = env.get_chars(e.col)
        acc = None
        for v in e.values:
            const = _bytes_const(v, chars.shape[1], xp)
            eq = (chars == const[None, :]).all(axis=1)
            acc = eq if acc is None else (acc | eq)
        return acc
    if isinstance(e, StrStartsWith):
        chars = env.get_chars(e.col)
        k = len(e.prefix.encode())
        const = _bytes_const(e.prefix, k, xp)
        return (chars[:, :k] == const[None, :]).all(axis=1)
    if isinstance(e, StrContainsWord):
        # strstr: sliding-window byte comparison over the joined text —
        # deliberately the expensive path the paper attributes to strstr.
        chars = env.get_word_chars(e.col)
        pat = e.word.encode()
        k = len(pat)
        const = _bytes_const(e.word, k, xp)
        n, w = chars.shape
        hit = None
        for off in range(0, max(1, w - k + 1)):
            m = (chars[:, off:off + k] == const[None, :]).all(axis=1)
            hit = m if hit is None else (hit | m)
        return ~hit if e.negate else hit

    # ---- dictionary-lowered string ops (Table II) ---------------------------
    if isinstance(e, CodeEq):
        codes = env.get_codes(e.col)
        eq = codes == e.code
        return ~eq if e.negate else eq
    if isinstance(e, CodeIn):
        codes = env.get_codes(e.col)
        acc = None
        for c in e.codes:
            eq = codes == c
            acc = eq if acc is None else (acc | eq)
        return acc
    if isinstance(e, CodeRange):
        codes = env.get_codes(e.col)
        return (codes >= e.lo) & (codes < e.hi)
    if isinstance(e, WordCode):
        words = env.get_words(e.col)
        hit = (words == e.code).any(axis=1)
        return ~hit if e.negate else hit

    raise TypeError(f"unknown expr {type(e)}")


def expr_columns(e: Expr) -> set[str]:
    """All column names referenced by an expression."""
    out: set[str] = set()

    def rec(x):
        if isinstance(x, Col):
            out.add(x.name)
        elif isinstance(x, (Arith, Cmp, And, Or)):
            rec(x.lhs), rec(x.rhs)
        elif isinstance(x, (Not, Year)):
            rec(x.operand)
        elif isinstance(x, Where):
            rec(x.cond), rec(x.then), rec(x.other)
        elif isinstance(x, (StrEq, StrIn, StrStartsWith, StrContainsWord,
                            CodeEq, CodeIn, CodeRange, WordCode)):
            out.add(x.col)

    rec(e)
    return out


def fold_constants(e: Expr) -> Expr:
    """Partial evaluation (§3.6): fold Arith/Cmp/bool over Consts."""
    if isinstance(e, Arith):
        l, r = fold_constants(e.lhs), fold_constants(e.rhs)
        if isinstance(l, Const) and isinstance(r, Const):
            return Const(_ARITH[e.op](l.value, r.value))
        return Arith(e.op, l, r)
    if isinstance(e, Cmp):
        l, r = fold_constants(e.lhs), fold_constants(e.rhs)
        if isinstance(l, Const) and isinstance(r, Const):
            return Const(bool(_CMP[e.op](l.value, r.value)))
        return Cmp(e.op, l, r)
    if isinstance(e, And):
        l, r = fold_constants(e.lhs), fold_constants(e.rhs)
        if isinstance(l, Const):
            return r if l.value else Const(False)
        if isinstance(r, Const):
            return l if r.value else Const(False)
        return And(l, r)
    if isinstance(e, Or):
        l, r = fold_constants(e.lhs), fold_constants(e.rhs)
        if isinstance(l, Const):
            return Const(True) if l.value else r
        if isinstance(r, Const):
            return Const(True) if r.value else l
        return Or(l, r)
    if isinstance(e, Not):
        x = fold_constants(e.operand)
        if isinstance(x, Const):
            return Const(not x.value)
        return Not(x)
    if isinstance(e, Where):
        c = fold_constants(e.cond)
        t, o = fold_constants(e.then), fold_constants(e.other)
        if isinstance(c, Const):
            return t if c.value else o
        return Where(c, t, o)
    if isinstance(e, Year):
        return Year(fold_constants(e.operand))
    return e


def substitute_params(e: Expr, bindings: dict) -> Expr:
    """Replace Params named in `bindings` with Consts / literal strings.
    Params absent from `bindings` are left in place (param-residual)."""

    def val(p):
        return bindings[p.name] if isinstance(p, Param) and p.name in bindings \
            else p

    sub = lambda x: substitute_params(x, bindings)
    if isinstance(e, Param):
        return Const(bindings[e.name]) if e.name in bindings else e
    if isinstance(e, (Arith, Cmp)):
        return type(e)(e.op, sub(e.lhs), sub(e.rhs))
    if isinstance(e, (And, Or)):
        return type(e)(sub(e.lhs), sub(e.rhs))
    if isinstance(e, Not):
        return Not(sub(e.operand))
    if isinstance(e, Year):
        return Year(sub(e.operand))
    if isinstance(e, Where):
        return Where(sub(e.cond), sub(e.then), sub(e.other))
    if isinstance(e, StrEq):
        return StrEq(e.col, val(e.value), e.negate)
    if isinstance(e, StrIn):
        return StrIn(e.col, tuple(val(v) for v in e.values))
    if isinstance(e, StrStartsWith):
        return StrStartsWith(e.col, val(e.prefix))
    if isinstance(e, StrContainsWord):
        return StrContainsWord(e.col, val(e.word), e.negate)
    return e


def conjuncts(e: Expr) -> list[Expr]:
    if isinstance(e, And):
        return conjuncts(e.lhs) + conjuncts(e.rhs)
    return [e]


def conjoin(parts: list[Expr]) -> Expr:
    if not parts:
        return Const(True)
    out = parts[0]
    for p in parts[1:]:
        out = And(out, p)
    return out
