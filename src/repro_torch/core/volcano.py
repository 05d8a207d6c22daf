"""Interpreted, operator-at-a-time baseline engine (the "DBX" rung).

Executes the *logical* plan directly on numpy: every operator fully
materializes its (compacted) output before the next one runs, strings are
raw fixed-width char matrices compared strcmp-style, joins build generic
associative structures, aggregations group generically — no compilation, no
specialization, no query-specific knowledge.  Deliberately the world the
paper's Figure 1 puts at the productive-but-slow corner.

It is also the correctness oracle for the staged engine (independent code
path, compaction instead of masking), and — wrapped in `OracleQuery` —
the zero-compile-cost bottom rung of the execution-tier ladder
(`core/tiering.py`): a cold plan is servable the instant it exists, at
interpreter speed, while the compiled tiers build in the background.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ir
from repro_torch.core.expr import EvalEnv, eval_expr
from repro_torch.core.observations import Observations
from repro_torch.core.passes.param_binding import (check_bindings,
                                                   runtime_params)
from repro_torch.relational.loader import Database
from repro_torch.relational.schema import ColKind

_BIG = np.float32(3.0e38)


def _decode_chars(mat: np.ndarray) -> np.ndarray:
    if mat.size == 0:
        return np.zeros((mat.shape[0],), dtype="U1")
    w = mat.shape[1]
    b = np.ascontiguousarray(mat).view(f"S{w}")[:, 0]
    return np.char.decode(np.char.rstrip(b, b"\x00"), "ascii").astype(str)


class _Env(EvalEnv):
    """Columns are numpy arrays; strings resolved through char matrices."""

    def __init__(self, cols: dict[str, np.ndarray],
                 chars: dict[str, np.ndarray],
                 params: dict | None = None):
        super().__init__(np, cse=False, params=params)  # baseline: no CSE
        self.cols = cols
        self.chars = chars

    def get_num(self, name):
        return self.cols[name]

    def get_chars(self, name):
        return self.chars[name]

    def get_word_chars(self, name):
        return self.chars[name]

    def get_codes(self, name):  # pragma: no cover - volcano never lowers
        raise RuntimeError("volcano engine has no dictionary codes")

    get_words = get_codes


class Relation:
    """Materialized intermediate: numeric columns + char matrices."""

    def __init__(self, cols: dict[str, np.ndarray],
                 chars: dict[str, np.ndarray]):
        self.cols = cols
        self.chars = chars

    @property
    def nrows(self) -> int:
        src = self.cols or self.chars
        return len(next(iter(src.values())))

    def take(self, idx) -> "Relation":
        return Relation({k: v[idx] for k, v in self.cols.items()},
                        {k: v[idx] for k, v in self.chars.items()})

    def env(self, params: dict | None = None) -> _Env:
        return _Env(self.cols, self.chars, params)

    def key_for_sort(self, name: str, asc: bool) -> np.ndarray:
        if name in self.cols:
            v = self.cols[name]
            return v if asc else -v
        s = _decode_chars(self.chars[name])
        if not asc:
            raise NotImplementedError("descending string sort")
        return s


class VolcanoEngine:
    def __init__(self, db: Database):
        self.db = db

    def execute(self, plan: ir.Plan,
                params: dict | None = None) -> dict[str, np.ndarray]:
        params = dict(params or {})
        if params:
            # compile-time params (string values, Limit.n) have no runtime
            # representation even in the oracle: substitute them up front.
            # Numeric params evaluate through the expression environment.
            # (params travel as an explicit argument so one engine stays
            # reentrant across concurrent execute calls.)
            from repro_torch.core.passes.param_binding import bind_plan, plan_params

            import copy

            structural = {n: params[n]
                          for n, i in plan_params(plan).items()
                          if i.structural and n in params}
            if structural:
                plan = bind_plan(copy.deepcopy(plan), structural)
        rel = self._exec(plan, params)
        out = dict(rel.cols)
        for name, mat in rel.chars.items():
            out[name] = _decode_chars(mat)
        return out

    # ------------------------------------------------------------------
    def _exec(self, p: ir.Plan, params: dict) -> Relation:
        if isinstance(p, ir.Scan):
            t = self.db.table(p.table)
            cols, chars = {}, {}
            names = p.columns if p.columns is not None else t.schema.column_names
            for c in names:
                kind = t.schema.col(c).kind
                if kind in (ColKind.INT, ColKind.FLOAT, ColKind.DATE):
                    cols[c] = t.data[c]
                else:
                    chars[c] = t.char_matrix(c)
            return Relation(cols, chars)

        if isinstance(p, ir.Select):
            rel = self._exec(p.child, params)
            m = eval_expr(p.pred, rel.env(params))
            return rel.take(np.flatnonzero(m))

        if isinstance(p, ir.Project):
            rel = self._exec(p.child, params)
            cols = dict(rel.cols) if p.keep_input else {}
            chars = dict(rel.chars) if p.keep_input else {}
            env = rel.env(params)
            for name, e in p.outputs.items():
                from repro_torch.core.expr import Col
                if isinstance(e, Col) and e.name in rel.chars:
                    chars[name] = rel.chars[e.name]
                else:
                    cols[name] = np.asarray(eval_expr(e, env))
            return Relation(cols, chars)

        if isinstance(p, ir.Join):
            stream = self._exec(p.stream, params)
            build = self._exec(p.build, params)
            skey = stream.cols[p.stream_key]
            bkey = build.cols[p.build_key]
            if p.stream_key2 is not None:   # composite key: pack into int64
                mul = np.int64(max(int(build.cols[p.build_key2].max(initial=0)),
                                   int(stream.cols[p.stream_key2].max(initial=0))
                                   ) + 1)
                skey = skey.astype(np.int64) * mul \
                    + stream.cols[p.stream_key2].astype(np.int64)
                bkey = bkey.astype(np.int64) * mul \
                    + build.cols[p.build_key2].astype(np.int64)
            if p.kind in ("semi", "anti"):
                hit = np.isin(skey, bkey)
                if p.kind == "anti":
                    hit = ~hit
                return stream.take(np.flatnonzero(hit))
            order = np.argsort(bkey, kind="stable")
            sk = bkey[order]
            pos = np.searchsorted(sk, skey)
            pos = np.clip(pos, 0, max(len(sk) - 1, 0))
            hit = (sk[pos] == skey) if len(sk) else np.zeros(len(skey), bool)
            if p.kind == "left":
                out = stream.take(np.arange(stream.nrows))
                bidx = order[pos] if len(sk) else np.zeros(len(skey), int)
                for name, v in build.cols.items():
                    if name not in out.cols:
                        out.cols[name] = np.where(hit, v[bidx], 0)
                return out
            sel = np.flatnonzero(hit)
            bidx = order[pos[sel]]
            out = stream.take(sel)
            for name, v in build.cols.items():
                if name not in out.cols:
                    out.cols[name] = v[bidx]
            for name, v in build.chars.items():
                if name not in out.chars:
                    out.chars[name] = v[bidx]
            return out

        if isinstance(p, ir.Agg):
            rel = self._exec(p.child, params)
            env = rel.env(params)
            n = rel.nrows
            if not p.group_by:
                cols = {}
                for spec in p.aggs:
                    v = (np.asarray(eval_expr(spec.expr, env))
                         if spec.expr is not None else None)
                    cols[spec.name] = np.array([_scalar_agg(spec.fn, v, n)],
                                               dtype=np.float32
                                               if spec.fn != "count"
                                               else np.int32)
                return Relation(cols, {})
            # generic grouping via lexsort over the (decoded) key columns
            keyarrs = []
            for g in p.group_by:
                if g in rel.cols:
                    keyarrs.append(rel.cols[g])
                else:
                    keyarrs.append(_decode_chars(rel.chars[g]))
            order = np.lexsort(tuple(reversed(keyarrs)))
            skeys = [k[order] for k in keyarrs]
            if n == 0:
                newg = np.zeros(0, dtype=bool)
            else:
                newg = np.ones(n, dtype=bool)
                acc = np.zeros(n - 1, dtype=bool)
                for k in skeys:
                    acc |= k[1:] != k[:-1]
                newg[1:] = acc
            starts = np.flatnonzero(newg)
            gid = np.cumsum(newg) - 1
            ngroups = len(starts)
            out_cols, out_chars = {}, {}
            for g in p.group_by + list(p.carry):
                if g in rel.cols:
                    out_cols[g] = rel.cols[g][order][starts]
                else:
                    out_chars[g] = rel.chars[g][order][starts]
            for spec in p.aggs:
                if spec.expr is not None:
                    v = np.asarray(eval_expr(spec.expr, env))[order]
                if spec.fn == "count":
                    out_cols[spec.name] = np.bincount(
                        gid, minlength=ngroups).astype(np.int32)
                elif spec.fn == "sum":
                    out_cols[spec.name] = np.add.reduceat(v, starts).astype(
                        v.dtype) if n else np.zeros(0, np.float32)
                elif spec.fn == "avg":
                    s = np.add.reduceat(v, starts)
                    c = np.bincount(gid, minlength=ngroups)
                    out_cols[spec.name] = (s / np.maximum(c, 1)).astype(np.float32)
                elif spec.fn == "min":
                    out_cols[spec.name] = np.minimum.reduceat(v, starts)
                elif spec.fn == "max":
                    out_cols[spec.name] = np.maximum.reduceat(v, starts)
            return Relation(out_cols, out_chars)

        if isinstance(p, ir.Compact):
            # the Volcano engine materializes compacted intermediates at
            # every operator already: a planned compaction point is a no-op
            # (capacity is a staged-engine static-shape concern)
            return self._exec(p.child, params)

        if isinstance(p, ir.Exchange):
            # single-interpreter execution holds the whole frame: a shard
            # boundary is a no-op, same reasoning as Compact above
            return self._exec(p.child, params)

        if isinstance(p, ir.Sort):
            rel = self._exec(p.child, params)
            keys = [rel.key_for_sort(name, asc) for name, asc in p.keys]
            order = np.lexsort(tuple(reversed(keys)))
            return rel.take(order)

        if isinstance(p, ir.Limit):
            rel = self._exec(p.child, params)
            n = p.n
            if not isinstance(n, (int, np.integer)):   # residual Param limit
                n = int(params[n.name])
            return rel.take(np.arange(min(n, rel.nrows)))

        raise TypeError(type(p))


class OracleQuery:
    """The Volcano engine behind the `CompiledQuery` contract (a
    `tiering.Runnable`): `run`/`run_many` with identical binding
    validation, plus the staged-outputs observation surface (empty: the
    interpreter compacts by materializing, so it has no capacity points
    or overflows to report, and its record only counts runs).
    Construction performs no staging and no compilation: this is the tier
    ladder's always-ready bottom rung, built once per cold plan shape by
    the tiered PlanCache.

    The plan must have compile-time (structural) parameters already
    substituted, exactly like CompiledQuery — `PlanCache._prepare` does
    that for both."""

    tier_name = "oracle"
    # PlanCache.run_many accounting: this tier executes slot-at-a-time,
    # so power-of-two bucket padding never happens and pad slots must not
    # be counted against it.
    pads_batches = False

    def __init__(self, plan: ir.Plan, db: Database,
                 params: Optional[dict] = None):
        self.db = db
        self.plan = plan
        self.param_spec, self.param_defaults = runtime_params(
            plan, params, "PlanCache or bind_plan before OracleQuery")
        self._engine = VolcanoEngine(db)
        # the plan's facts PlanCache's compaction accounting reads: no
        # points, so the cache skips the tier (no isinstance checks)
        self.compaction_points = 0
        self.point_caps: dict[str, int] = {}
        self.translate_points: set[str] = set()
        self.observations = Observations(self.point_caps)

    def run(self, params: Optional[dict] = None) -> dict[str, np.ndarray]:
        bound = check_bindings(self, params)
        self.observations.record([], 1)
        return self._engine.execute(self.plan, bound)

    def run_many(self, bindings_list) -> list[dict[str, np.ndarray]]:
        """One interpreted execution per binding (no vmap at this tier);
        validates every binding up front so a bad one fails the call
        before any slot executes, like the batched staged program."""
        bound = [check_bindings(self, b) for b in bindings_list]
        return [self.run(b if b is not self.param_defaults else None)
                for b in bound]


def _scalar_agg(fn: str, v, n: int):
    if fn == "count":
        return n
    if n == 0:
        return 0.0
    if fn == "sum":
        return v.sum()
    if fn == "avg":
        return v.mean()
    if fn == "min":
        return v.min()
    if fn == "max":
        return v.max()
    raise ValueError(fn)
