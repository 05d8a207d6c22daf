"""Kernel-fusion bridge: plan expressions as kernel tile functions.

The kernels in `repro_torch.kernels` are core-independent — they take
named 1-D columns plus parameter scalars and caller-supplied tile
functions.  This module is the only place the two layers meet: it decides
whether a Select/Agg subtree is *kernel-safe* (every expression evaluates
elementwise over 1-D numeric/code columns — no char-matrix string ops, no
word matrices, nothing 2-D) and, when it is, packages the staged frame's
columns, registers the runtime parameters as kernel scalars, and wraps the
expression in a `TileFn`.

A `TileFn` is two things at once: called, it is the plain torch evaluator
of its `Expr` (the kernels' CPU path and oracle); handed to a CUDA
wrapper, its `expr` is what `repro_torch.kernels.codegen` turns into a
`__device__` function.  Both read the same tree, so fused and unfused
execution agree on predicate semantics.
"""
from __future__ import annotations

import torch

from repro_torch.core import expr as E
from repro_torch.core import ir

# expression nodes whose evaluation is elementwise over 1-D operands (the
# char/word-matrix string ops need 2-D blocks — not kernel-representable)
_SAFE = (E.Col, E.Const, E.Param, E.Arith, E.Cmp, E.And, E.Or, E.Not,
         E.Where, E.Year, E.CodeEq, E.CodeIn, E.CodeRange)


def kernel_safe(e: E.Expr) -> bool:
    """True when every node of `e` evaluates elementwise on 1-D blocks."""
    if not isinstance(e, _SAFE):
        return False
    if isinstance(e, E.Param) and e.dtype == "str":
        return False
    if isinstance(e, (E.Arith, E.Cmp, E.And, E.Or)):
        return kernel_safe(e.lhs) and kernel_safe(e.rhs)
    if isinstance(e, (E.Not, E.Year)):
        return kernel_safe(e.operand)
    if isinstance(e, E.Where):
        return (kernel_safe(e.cond) and kernel_safe(e.then)
                and kernel_safe(e.other))
    return True


def expr_params(e: E.Expr) -> list[E.Param]:
    """Runtime Params of `e`, deduped by name, in first-visit order (the
    positional order scalars are handed to the kernel in)."""
    out: list[E.Param] = []
    seen: set[str] = set()

    def rec(x):
        if isinstance(x, E.Param):
            if x.name not in seen:
                seen.add(x.name)
                out.append(x)
        elif isinstance(x, (E.Arith, E.Cmp, E.And, E.Or)):
            rec(x.lhs), rec(x.rhs)
        elif isinstance(x, (E.Not, E.Year)):
            rec(x.operand)
        elif isinstance(x, E.Where):
            rec(x.cond), rec(x.then), rec(x.other)

    rec(e)
    return out


def elementwise_chain(p: ir.Plan) -> bool:
    """True when `p` is a Scan under (only) Projects — the frame has no
    mask, no pending predicates, and no other operator in between, so a
    fused kernel's in-kernel predicate is the frame's ONLY filter."""
    while isinstance(p, ir.Project):
        p = p.child
    return isinstance(p, ir.Scan)


class ColsEnv(E.EvalEnv):
    """`eval_expr` environment over named 1-D tensors: columns resolve to
    the caller's tensors, Params to its positional scalars."""

    def __init__(self, cols: dict, scalars: dict):
        super().__init__(torch, cse=True)
        self._cols = cols
        self._scalars = scalars

    def get_num(self, name):
        return self._cols[name]

    def get_codes(self, name):
        return self._cols[name]

    def get_param(self, p: E.Param):
        return self._scalars[p.name]


class TileFn:
    """One kernel-safe expression over named columns and positional
    scalars.  Calling it evaluates the expression with torch; the CUDA
    wrappers read `expr` and `param_names` to generate the kernel."""

    def __init__(self, e: E.Expr, param_names: list[str]):
        self.expr = e
        self.param_names = list(param_names)

    def __call__(self, cols: dict, scalars: list):
        return E.eval_expr(self.expr,
                           ColsEnv(cols, dict(zip(self.param_names, scalars))))


class GroupIndex:
    """Dense mixed-radix group index `sum(col_k * stride_k)`, clipped to
    `[0, n_groups)`; `radix` is a list of (column, domain, stride)."""

    def __init__(self, radix: list[tuple[str, int, int]], n_groups: int):
        self.radix = [(g, int(d), int(st)) for g, d, st in radix]
        self.n_groups = int(n_groups)

    def __call__(self, cols: dict, scalars: list):
        idx = None
        for g, _d, st in self.radix:
            part = cols[g].to(torch.int32) * st
            idx = part if idx is None else idx + part
        return idx.clamp(0, self.n_groups - 1)


def collect_operands(frame, exprs: list, extra_cols: list, ctx):
    """(cols, scalars, param_names) for a kernel invocation, or None when
    any referenced column is not a 1-D numeric/code binding.

    cols maps every column any expr (or `extra_cols`) reads to its staged
    tensor; scalars is the positional list of parameter values
    (registered through `ctx.param`, so re-binding never re-stages);
    param_names matches scalars positionally.
    """
    names: set[str] = set(extra_cols)
    for e in exprs:
        names |= E.expr_columns(e)
    cols = {}
    for nm in sorted(names):
        b = frame.cols.get(nm)
        if b is None or b.kind not in ("num", "codes") \
                or getattr(b.arr, "ndim", 0) != 1:
            return None
        cols[nm] = b.arr
    params: list[E.Param] = []
    seen: set[str] = set()
    for e in exprs:
        for p in expr_params(e):
            if p.name not in seen:
                seen.add(p.name)
                params.append(p)
    scalars = [ctx.param(p) for p in params]
    return cols, scalars, [p.name for p in params]

