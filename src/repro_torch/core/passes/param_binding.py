"""Parameter analysis + binding (compile-once / bind-many execution).

The paper bakes every literal into the staged program; with `Param` nodes a
plan can instead be compiled *once* and re-executed under many bindings
(Dashti et al., "Compiling Database Application Programs").  Two classes of
parameter exist:

  runtime      — numeric Params in expression positions.  They survive the
                 pass pipeline (the plan is *param-residual*: DateIndex skips
                 a bound it cannot resolve statically, FoldAndSimplify keeps
                 the node) and become scalar inputs of the staged program, so
                 re-binding is a pure re-execution of the jitted callable.
  compile-time — string-valued Params (the StringDictionary rewrite needs the
                 concrete value to look up dictionary codes) and Params used
                 as `Limit.n` (the top-k rewrite needs a static k).  These
                 must be substituted before optimization and therefore
                 participate in the plan-cache key.

`ParamBinding` is the pipeline pass realizing "resolve params from a binding
dict at optimize time"; `plan_params` is the analysis the runtime layer uses
to split a binding dict into the two classes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import ir
from repro_torch.core.expr import Param, StrContainsWord, StrEq, StrIn, \
    StrStartsWith, substitute_params
from repro_torch.core.passes.cse_dce import transform_exprs


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    dtype: str
    structural: bool   # True -> must be bound at optimize (compile) time


def _plan_exprs(p: ir.Plan):
    for node in ir.walk(p):
        if isinstance(node, ir.Select):
            yield node.pred
        elif isinstance(node, ir.Project):
            yield from node.outputs.values()
        elif isinstance(node, ir.Agg):
            for spec in node.aggs:
                if spec.expr is not None:
                    yield spec.expr


def plan_params(plan: ir.Plan) -> dict[str, ParamInfo]:
    """Every Param in the plan, classified runtime vs compile-time."""
    from repro_torch.core import expr as E

    out: dict[str, ParamInfo] = {}

    def record(p: Param, structural: bool):
        prev = out.get(p.name)
        if prev is not None and prev.dtype != p.dtype:
            raise TypeError(f"parameter {p.name!r} used with dtypes "
                            f"{prev.dtype} and {p.dtype}")
        structural = structural or p.dtype == "str" \
            or (prev.structural if prev else False)
        out[p.name] = ParamInfo(p.dtype, structural)

    def rec(e):
        if isinstance(e, Param):
            record(e, False)
        elif isinstance(e, (E.Arith, E.Cmp, E.And, E.Or)):
            rec(e.lhs), rec(e.rhs)
        elif isinstance(e, (E.Not, E.Year)):
            rec(e.operand)
        elif isinstance(e, E.Where):
            rec(e.cond), rec(e.then), rec(e.other)
        elif isinstance(e, StrEq):
            if isinstance(e.value, Param):
                record(e.value, True)
        elif isinstance(e, StrIn):
            for v in e.values:
                if isinstance(v, Param):
                    record(v, True)
        elif isinstance(e, StrStartsWith):
            if isinstance(e.prefix, Param):
                record(e.prefix, True)
        elif isinstance(e, StrContainsWord):
            if isinstance(e.word, Param):
                record(e.word, True)

    for e in _plan_exprs(plan):
        rec(e)
    for node in ir.walk(plan):
        if isinstance(node, ir.Limit) and isinstance(node.n, Param):
            record(node.n, True)
    return out


def bind_plan(plan: ir.Plan, bindings: dict) -> ir.Plan:
    """Substitute the named Params throughout the plan, in place where
    possible.  Params not named in `bindings` stay residual."""
    if not bindings:
        return plan
    transform_exprs(plan, lambda e: substitute_params(e, bindings))
    for node in ir.walk(plan):
        if isinstance(node, ir.Limit) and isinstance(node.n, Param) \
                and node.n.name in bindings:
            node.n = int(bindings[node.n.name])
    return plan


def runtime_params(plan: ir.Plan, params: Optional[dict],
                   bind_hint: str) -> tuple[dict, dict]:
    """(dtype, construction-time binding) of each runtime parameter of
    `plan`, by name.  Its compile-time parameters must be substituted
    already (`bind_hint` says where, in the error), and `params` must
    bind every runtime one."""
    spec = plan_params(plan)
    structural = sorted(n for n, i in spec.items() if i.structural)
    if structural:
        raise TypeError(f"compile-time parameters {structural} are "
                        f"unresolved; bind them via {bind_hint}")
    dtypes = {n: i.dtype for n, i in spec.items()}
    defaults = {n: (params or {})[n] for n in dtypes if n in (params or {})}
    missing = sorted(set(dtypes) - set(defaults))
    if missing:
        raise KeyError(f"no binding supplied for parameters {missing}")
    return dtypes, defaults


def check_bindings(runnable, params: Optional[dict]) -> dict:
    """The binding a run of `runnable` (its `param_spec` and
    `param_defaults`) takes for `params`: None means the construction-
    time bindings; a dict must name every runtime parameter (a partial
    dict would silently mix two requests) and no other."""
    if params is None:
        return runnable.param_defaults
    unknown = sorted(set(params) - set(runnable.param_spec))
    if unknown:
        raise KeyError(f"unknown parameters {unknown}; this plan "
                       f"takes {sorted(runnable.param_spec)}")
    missing = sorted(set(runnable.param_spec) - set(params))
    if missing:
        raise KeyError(f"no binding supplied for parameters {missing}")
    return params


def param_layout(spec: dict, n: int = 1) -> tuple[list, int]:
    """Where the runtime parameters of `spec` (name -> dtype) sit in one
    byte buffer of `n` bindings, copied to the device at once:
    [(name, dtype, byte offset)], wider dtypes first, so that each
    parameter's n values start aligned to their item, and the buffer's
    size."""
    layout, at = [], 0
    for name in sorted(spec, key=lambda k: -np.dtype(spec[k]).itemsize):
        dt = np.dtype(spec[name])
        layout.append((name, dt, at))
        at += n * dt.itemsize
    return layout, at


class ParamBinding:
    """Pipeline pass: resolve parameters from a binding dict at optimize
    time (full specialization — every named literal is baked in, exactly as
    the paper's generated code does)."""

    name = "ParamBinding"

    def __init__(self, bindings: dict):
        self.bindings = dict(bindings)

    def run(self, plan: ir.Plan, db, settings) -> ir.Plan:
        return bind_plan(plan, self.bindings)
