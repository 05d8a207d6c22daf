"""Selection-vector compaction (paper §3.2, Fig 7: data-structure
specialization is where the constant factors live).

The mask-carrying dataflow of the staged engine is shape-stable — exactly
what XLA wants — but it makes every operator pay full-table cost no matter
how selective the upstream predicates were.  This pass plants
`ir.Compact(child, capacity)` points where that cost is worth cutting:

  * **where**: after selective Selects (and the masks PK-gather joins
    introduce), immediately below expensive consumers — join probes and
    gathers, aggregations, sorts — so the consumer runs over `capacity`
    rows instead of the full cardinality.  Build sides of `pk_gather` /
    `bucket_gather` joins are never compacted: those strategies index the
    build frame *positionally* (a key value is a row id), and compaction
    destroys alignment.
  * **capacity**: JAX shapes are static, so the capacity must be chosen at
    plan time.  We estimate the surviving-row count from `Table.stats` and
    predicate structure (range fractions over min/max, equality over known
    dictionary/key domains — §3.5.2 "statistics knowledge"), multiply by a
    safety margin, and round up to a power-of-two bucket so near-miss
    estimates across plans land on few distinct shapes (mirroring the
    batch buckets of `compile.bucket_size`).
  * **overflow**: estimates are estimates.  Every Compact point raises a
    runtime flag when `count > capacity`; the compile driver surfaces the
    OR of all flags as a program output and `CompiledQuery` re-executes an
    uncompacted twin plan, so compaction can never change results.

`PlanCache` folds the planted capacity vector (read off the lowered plan)
into the plan key: entries are distinct whenever their static shapes are,
so each capacity bucket is traced at most once.

Adaptive capacity feedback (PR 5).  Estimates come from three sources, in
priority order:

  1. **observed counts** — `observed[point_id]` is the true valid count a
     previous compile of the same plan shape measured at runtime (staged
     as a per-point program output).  An observed count replaces both the
     estimate AND the static 2x margin: the capacity is the pow2 bucket
     just above the measured count (measured headroom).
  2. **initial-binding estimates** — `est_params` holds the first-seen
     runtime parameter values; a Param-bounded range predicate is
     estimated against the per-column quantile sketch as if that value
     were a literal (previously: selectivity 1.0, so parameterized plans
     never compacted).
  3. **static sketches** — col-vs-col comparisons between columns of one
     base table use the measured 2-column range fraction
     (`Table.pair_frac`) instead of the textbook 0.5.

Static analysis integration (PR 6).  Column provenance and base
cardinalities come from the analysis layer (`core/analysis`): one
`analyze()` pass per plan replaces the per-column recursive walks, and
conjunctions of predicates over one base table are additionally measured
jointly on a small fixed row sample (`Table.sample_index`) — conjunct
independence overestimates the filtering power of correlated predicates
(Q12's receipt/commit/ship date chain), and the planted capacity
inherited that undershoot as overflow risk.  The measured joint fraction
only ever *raises* the estimate (`max(product, measured)`), so
capacities never shrink below what the independence model planned.

Candidate sites are numbered in walk order whether or not a point is
planted, so `point_id` survives re-planning even when decisions flip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import ir
from repro_torch.core import expr as E
from repro_torch.core.analysis import analyze
from repro_torch.relational.loader import Database
from repro_torch.relational.schema import ColKind

# minimum planned row-count win for a point to pay for the compaction
# itself (a cumsum pass + binary search plus a gather per carried column)
_RATIO_SORT = 2
_RATIO_ELEMENTWISE = 2
_MIN_CAPACITY = 64


@dataclasses.dataclass
class Card:
    """Cardinality estimate for a staged frame at one plan point."""
    phys: int        # physical row count (static, exact)
    valid: float     # estimated mask-valid rows
    masked: bool     # frame carries a (possibly selective) mask


@dataclasses.dataclass
class _Ctx:
    """Walk state: estimation inputs plus the candidate-site counter."""
    db: Database
    s: object                       # Settings
    est_params: dict                # runtime param name -> initial value
    observed: dict                  # point_id -> measured valid count
    analysis: object = None         # analysis.Analysis of the input plan
    next_site: int = 0
    next_hand: int = 0
    # live key population estimates: output column name -> estimated
    # distinct surviving values, recorded at joins (a join filters the
    # stream to the build's surviving keys) and consumed by the dense-agg
    # group-count estimate.  Join-scoped: build-subtree entries are
    # discarded (the build frame is internal to its join) and every Agg
    # clears the table (its output is re-keyed).
    key_groups: dict = dataclasses.field(default_factory=dict)

    def site_id(self) -> str:
        pid = f"c{self.next_site}"
        self.next_site += 1
        return pid

    def hand_id(self) -> str:
        pid = f"h{self.next_hand}"
        self.next_hand += 1
        return pid


def observed_bucket(count: int) -> int:
    """Capacity for a *measured* count: the pow2 bucket just above it.
    No static margin — the bucket roundup is the headroom (≥ +1 row,
    on average 50%); an estimate that still undershoots re-triggers the
    overflow feedback, costing one more retrace."""
    return _bucket(float(count), 1.0)


_TRANSLATE_MARGIN = 1.5


def translate_bucket(count: int) -> int:
    """Capacity for a measured count at a *translate* point.

    A translate overflow is worse than a gather overflow: the pk_gather
    probing `slot_of` silently drops rows past capacity, so the whole
    query re-executes on the uncompacted twin — not just one frame.  The
    floor therefore sits a margin *above* the all-time measured max (the
    feedback store never decays translate observations), instead of the
    just-above bucket that plain points get."""
    return _bucket(float(count), _TRANSLATE_MARGIN)


class Compaction:
    name = "Compaction"

    def __init__(self, est_params: Optional[dict] = None,
                 observed: Optional[dict] = None):
        self.est_params = dict(est_params or {})
        self.observed = dict(observed or {})

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        ctx = _Ctx(db, settings, self.est_params, self.observed,
                   analysis=analyze(plan, db))
        plan, _ = _walk(plan, ctx, heavy=False)
        return plan


def strip_compaction(plan: ir.Plan) -> ir.Plan:
    """Remove every Compact node (planner-inserted or hand-planted) — the
    uncompacted twin the overflow fallback compiles against."""
    kids = [strip_compaction(c) for c in ir.children(plan)]
    ir.replace_children(plan, kids)
    if isinstance(plan, ir.Compact):
        return plan.child
    return plan


# ---------------------------------------------------------------------------
# the annotated walk: bottom-up cardinalities, top-down insertions
# ---------------------------------------------------------------------------

def _walk(p: ir.Plan, ctx: _Ctx, heavy: bool,
          protect: bool = False) -> tuple[ir.Plan, Card]:
    """`heavy` marks subtrees consumed (transitively) by an operator whose
    per-row cost does not fuse away — sorts, segment reductions, generic
    join probes.  A pure elementwise+gather pipeline ending in a scalar
    aggregate fuses into a handful of XLA loops already; compacting it
    trades fused passes for an unfused cumsum and loses.

    `protect` marks subtrees whose *physical frame* flows into a
    positional (`pk_gather`/`bucket_gather`) build side: a gathering
    compact there would re-pack rows and break the key-is-row-id
    addressing (the verifier's positional-build-alignment rule).  It
    follows the frame: through Select/Project/Compact/Limit children and
    join streams; a dense Agg re-keys its output by domain index and a
    Sort permutes anyway, so protection stops below both."""
    db, s = ctx.db, ctx.s
    if isinstance(p, ir.Scan):
        n = ctx.analysis.info(p).card if ctx.analysis is not None \
            else db.table(p.table).nrows
        return p, Card(n, float(n), False)

    if isinstance(p, ir.Select):
        child, c = _walk(p.child, ctx, heavy, protect)
        p.child = child
        sel = _selectivity(p.pred, p.child, ctx)
        return p, Card(c.phys, c.valid * sel, True)

    if isinstance(p, ir.Project):
        child, c = _walk(p.child, ctx, heavy, protect)
        p.child = child
        return p, c

    if isinstance(p, ir.Compact):   # pre-existing (hand-planted) point
        child, c = _walk(p.child, ctx, heavy, protect)
        p.child = child
        if p.point_id is None:
            # assign the stable h<i> id HERE, not at compile time: the
            # same pass walks the same plan shape on every re-plan, so the
            # numbering reproduces and the feedback store's observed
            # counts (keyed by these ids) can re-plan hand-planted
            # capacities exactly like pass-planted ones
            p.point_id = ctx.hand_id()
        cap = int(p.capacity)
        if cap <= 0:                # measure-only: cardinality untouched
            return p, c
        obs = ctx.observed.get(p.point_id)
        if obs is not None:
            # measured demand overrides the hand-chosen capacity (the
            # PR-5 bug: hand points were observed but never re-planned,
            # so an undershot hand capacity overflowed forever)
            p.capacity = cap = (translate_bucket(obs) if p.translate
                                else observed_bucket(obs))
        return p, Card(min(cap, c.phys), min(c.valid, float(cap)), True)

    if isinstance(p, ir.Join):
        # a generic join is itself a heavy consumer (build argsort, stream
        # binary-search probe); the positional strategies are gathers that
        # fuse, so their streams compact only under a heavy ancestor
        sub_heavy = heavy or p.strategy == "generic"
        positional = p.strategy in ("pk_gather", "bucket_gather")
        # the join's output IS the stream's physical frame, so stream-side
        # protection is inherited; the build frame feeds this join only,
        # and must stay intact throughout when the join is positional
        stream, sc = _walk(p.stream, ctx, sub_heavy, protect)
        stream_keys = dict(ctx.key_groups)
        # the build subtree is an independent pipeline: stream-side key
        # populations don't constrain it (a fresh scan sees every key),
        # and its own entries don't outlive the join (the build frame is
        # internal — the join's output is the stream frame)
        ctx.key_groups = {}
        build, bc = _walk(p.build, ctx, sub_heavy, positional)
        ctx.key_groups = stream_keys
        # the build's match fraction must reflect its *pre-compaction*
        # cardinality: compaction shrinks phys toward valid, which would
        # inflate the fraction to ~1/margin and poison downstream estimates
        bfrac = min(bc.valid / bc.phys, 1.0) if bc.phys else 1.0
        # key-population bookkeeping for the dense-agg group estimate: an
        # inner/semi join keeps a stream row (and hence its key values)
        # only when its build match survives, so every stream-side
        # population scales by the match fraction; the stream key itself
        # is now bounded by the build's surviving key mass.
        if p.kind in ("inner", "semi"):
            for k in list(ctx.key_groups):
                ctx.key_groups[k] *= bfrac
            ctx.key_groups[p.stream_key] = min(
                bc.valid, ctx.key_groups.get(p.stream_key, float("inf")))
        elif p.kind == "anti":
            anti = max(1.0 - bfrac, 0.1)
            for k in list(ctx.key_groups):
                ctx.key_groups[k] *= anti
        if sub_heavy:
            stream, sc = _maybe_compact(stream, sc, ctx,
                                        _RATIO_ELEMENTWISE, protect)
        # positional strategies index the build by key value: never compact.
        # The generic join argsorts the build; exists_flag scatters it —
        # either way the build frame is internal to the join (the output
        # is the stream frame), so outer protection does not apply.
        if p.strategy in ("generic", "exists_flag"):
            ratio = _RATIO_SORT if p.strategy == "generic" \
                else _RATIO_ELEMENTWISE
            build, bc = _maybe_compact(build, bc, ctx, ratio)
        elif p.strategy == "pk_gather":
            # a *translated* compact re-establishes key addressing over
            # the compacted build via the CSR slot_of vector (planted only
            # under Settings.use_pallas — gated inside _maybe_compact so
            # the candidate-site numbering is preset-independent).  A
            # partitioned build stays protected: slot_of would be built
            # over the shard-local block but probed with global keys.
            build, bc = _maybe_compact(build, bc, ctx, _RATIO_ELEMENTWISE,
                                       protect=_shard_count(build) > 1,
                                       translate=True)
        p.stream, p.build = stream, build
        if p.kind == "inner":
            valid, masked = sc.valid * bfrac, sc.masked or bc.masked
        elif p.kind == "left":
            valid, masked = sc.valid, sc.masked
        elif p.kind == "semi":
            valid, masked = sc.valid * bfrac, True
        else:  # anti
            valid, masked = sc.valid * max(1.0 - bfrac, 0.1), True
        return p, Card(sc.phys, valid, masked)

    if isinstance(p, ir.Agg):
        # dense/generic aggregation segment-reduces (or sorts) per row —
        # heavy for everything below; a scalar aggregation is a terminal
        # one-pass consumer that reduces masked rows as cheaply as the
        # compaction itself would run.  The output frame is re-keyed
        # (dense: by domain index) or re-packed (generic: sorted groups),
        # so upstream protection does not extend below the Agg.
        agg_heavy = p.strategy != "scalar" and bool(p.group_by)
        child, c = _walk(p.child, ctx, heavy or agg_heavy, False)
        if agg_heavy:
            ratio = _RATIO_SORT if p.strategy == "generic" \
                else _RATIO_ELEMENTWISE
            child, c = _maybe_compact(child, c, ctx, ratio)
        p.child = child
        if p.strategy == "dense":
            D = 1
            for d in p.domains or [1]:
                D *= d
            groups = _dense_groups(p, c, float(D), ctx)
            ctx.key_groups = {}    # output re-keyed by domain index
            return p, Card(D, groups, True)
        ctx.key_groups = {}        # generic: output re-packed by group
        if p.strategy == "scalar" or not p.group_by:
            return p, Card(1, 1.0, False)
        # generic grouping keeps the physical width, groups packed in front
        return p, Card(c.phys, min(c.valid, float(c.phys)), True)

    if isinstance(p, ir.Sort):
        child, c = _walk(p.child, ctx, True, False)
        child, c = _maybe_compact(child, c, ctx, _RATIO_SORT)
        p.child = child
        return p, c

    if isinstance(p, ir.Limit):
        child, c = _walk(p.child, ctx, heavy, protect)
        p.child = child
        n = p.n if isinstance(p.n, int) else c.phys
        return p, Card(min(n, c.phys), min(c.valid, float(n)), c.masked)

    if isinstance(p, ir.Exchange):
        # all-gather along the data axis: physical height and estimated
        # valid mass both multiply by the shard count (each shard held a
        # disjoint slice).  Anything planted *below* runs per shard —
        # the per-shard capacity contract — and the consumer above this
        # node sees the gathered cardinality when weighing its own point.
        child, c = _walk(p.child, ctx, heavy, protect)
        p.child = child
        ns = _shard_count(child)
        return p, Card(c.phys * ns, c.valid * ns, c.masked)

    raise TypeError(type(p))


def _shard_count(p: ir.Plan) -> int:
    """Mesh size of a partitioned subtree (1 when unsharded)."""
    return max((s.shard.n_shards for s in ir.walk(p)
                if isinstance(s, ir.Scan) and s.shard is not None),
               default=1)


def _bucket(est_rows: float, margin: float) -> int:
    want = max(int(est_rows * margin) + 1, _MIN_CAPACITY)
    return 1 << (want - 1).bit_length()


def _maybe_compact(node: ir.Plan, card: Card, ctx: _Ctx, ratio: int,
                   protect: bool = False,
                   translate: bool = False) -> tuple[ir.Plan, Card]:
    """Plant a Compact over `node` if the planner expects the consumer to
    win at least `ratio`x in row count.  Returns the (possibly wrapped)
    node and the post-compaction cardinality.

    The candidate id is drawn unconditionally — every call site consumes
    one — so ids depend only on plan structure, never on the estimates:
    an observed count recorded under capacity A still names the same site
    after a re-plan chose capacity B (or chose not to plant at all)."""
    pid = ctx.site_id()
    s = ctx.s
    if not s.compaction or not card.masked or isinstance(node, ir.Compact):
        return node, card
    if card.phys < s.compact_min_rows:
        return node, card
    if s.compact_measure_only:
        # the overflow twin: observe the true valid count at every
        # candidate site (capacity 0 = no gather, frame unchanged), so a
        # single fallback execution hands the feedback store the exact
        # demand at every site — including those an overflowed upstream
        # point would have truncated in the compacted program.  A
        # measure-only point never re-packs rows, so `protect` is moot.
        return _wrap(node, 0, pid), card
    if protect:
        # this frame flows into a positional build side: a gathering
        # compact here would break key-is-row-id addressing
        return node, card
    if translate and not s.use_pallas:
        # key→slot translation is the kernel path's contract; without it
        # pk_gather keeps positional addressing and the build stays intact
        return node, card
    obs = ctx.observed.get(pid)
    if obs is not None:
        # measured headroom: the bucket just above the observed count
        # replaces both the static estimate and the static margin
        # (translate points get a floored margin above their all-time max)
        cap = translate_bucket(obs) if translate else observed_bucket(obs)
        est_valid = float(min(obs, cap))
    else:
        cap = _bucket(card.valid, s.compact_margin)
        est_valid = card.valid
    if cap * ratio > card.phys:
        return node, card
    return _wrap(node, cap, pid, translate), Card(cap, est_valid, True)


def _wrap(node: ir.Plan, cap: int, pid: str,
          translate: bool = False) -> ir.Plan:
    # sink below Projects so the projection's expressions also run narrow
    # (a Project is elementwise: compact-then-project == project-then-compact)
    if isinstance(node, ir.Project):
        node.child = _wrap(node.child, cap, pid, translate)
        return node
    return ir.Compact(node, cap, point_id=pid, translate=translate)


# ---------------------------------------------------------------------------
# selectivity estimation from Table.stats + predicate structure
# ---------------------------------------------------------------------------

def _selectivity(e: E.Expr, plan: ir.Plan, ctx: _Ctx) -> float:
    parts = E.conjuncts(e)
    if len(parts) > 1:
        s = _conjunction_sel(parts, plan, ctx)
    else:
        s = _sel(e, plan, ctx)
    return min(max(s, 0.0), 1.0)


def _conjunction_sel(parts: list, plan: ir.Plan, ctx: _Ctx) -> float:
    """Surviving fraction of a conjunction.

    The independence product `∏ sel(cᵢ)` overestimates the filtering
    power of correlated predicates (Q12's receiptdate/commitdate/shipdate
    chain: each range is selective, but they fire together), and planted
    capacities inherit the undershoot as overflow risk.  For groups of
    conjuncts whose columns all resolve to ONE base table, the joint
    fraction is instead *measured* on the table's fixed row sample; the
    final estimate is `max(product, measured)` — the sample only ever
    raises the estimate, so capacities never drop below what the
    independence model planned (overflow-safe direction)."""
    per = [_sel(c, plan, ctx) for c in parts]
    indep = 1.0
    for s in per:
        indep *= s
    groups: dict[int, tuple] = {}
    for i, c in enumerate(parts):
        tc = _conjunct_table(c, plan, ctx)
        if tc is None:
            continue
        table, colmap = tc
        t, idxs, cols = groups.setdefault(id(table), (table, [], {}))
        idxs.append(i)
        cols.update(colmap)
    est = 1.0
    covered: set[int] = set()
    for table, idxs, colmap in groups.values():
        if len(idxs) < 2:
            continue   # a single conjunct gains nothing over its estimate
        frac = _sample_frac(table, [parts[i] for i in idxs], colmap, ctx)
        if frac is None:
            continue
        est *= frac
        covered.update(idxs)
    if not covered:
        return indep
    for i, s in enumerate(per):
        if i not in covered:
            est *= s
    return max(indep, est)


def _conjunct_table(e, plan, ctx: _Ctx):
    """(Table, {plan name: base column}) when every column of `e`
    resolves to the same base table — the condition for a row-aligned
    joint sample evaluation."""
    cols = E.expr_columns(e)
    if not cols:
        return None
    table = None
    colmap: dict[str, str] = {}
    for name in cols:
        tc = _base_column(plan, name, ctx)
        if tc is None:
            return None
        t, cname = tc
        if table is None:
            table = t
        elif t is not table:
            return None
        colmap[name] = cname
    return table, colmap


class _SampleEnv(E.EvalEnv):
    """Predicate evaluation over one base table's fixed row sample,
    resolving plan column names through the provenance map."""

    def __init__(self, t, colmap: dict[str, str], params: dict):
        super().__init__(np, cse=False, params=params)
        self._t = t
        self._colmap = colmap
        self._idx = t.sample_index()

    def _arr(self, name: str):
        return self._t.data[self._colmap[name]][self._idx]

    def get_num(self, name: str):
        return self._arr(name)

    def get_codes(self, name: str):
        return self._arr(name)

    def get_words(self, name: str):
        return self._arr(name)

    def get_chars(self, name: str):
        return self._t.char_matrix(self._colmap[name])[self._idx]

    def get_word_chars(self, name: str):
        return self._t.char_matrix(self._colmap[name])[self._idx]


def _sample_frac(t, exprs: list, colmap: dict[str, str],
                 ctx: _Ctx) -> Optional[float]:
    """Measured fraction of `t`'s row sample satisfying ALL of `exprs`
    (None when any conjunct is un-evaluable — unbound Params, string
    params — estimation falls back to the independence product)."""
    env = _SampleEnv(t, colmap, ctx.est_params)
    try:
        mask = None
        for e in exprs:
            v = np.asarray(E.eval_expr(e, env))
            if v.dtype != np.bool_ or v.ndim != 1:
                return None
            mask = v if mask is None else (mask & v)
    except Exception:
        return None
    if mask is None or mask.shape[0] == 0:
        return None
    return float(np.count_nonzero(mask)) / mask.shape[0]


def _sel(e, plan, ctx: _Ctx) -> float:
    if isinstance(e, E.And):
        return _sel(e.lhs, plan, ctx) * _sel(e.rhs, plan, ctx)
    if isinstance(e, E.Or):
        a, b = _sel(e.lhs, plan, ctx), _sel(e.rhs, plan, ctx)
        return a + b - a * b
    if isinstance(e, E.Not):
        return 1.0 - _sel(e.operand, plan, ctx)
    if isinstance(e, E.Const):
        return 1.0 if e.value else 0.0

    if isinstance(e, E.Cmp):
        lhs, rhs, op = e.lhs, e.rhs, e.op
        if isinstance(rhs, E.Col) and not isinstance(lhs, E.Col):
            lhs, rhs = rhs, lhs
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if isinstance(lhs, E.Col) and isinstance(rhs, E.Const):
            return _range_sel(op, lhs.name, float(rhs.value), plan, ctx,
                              quantile=False)
        if isinstance(lhs, E.Col) and isinstance(rhs, E.Param) \
                and rhs.name in ctx.est_params:
            # initial-binding estimate: the first-seen runtime value,
            # against the quantile sketch (the value is representative,
            # not exact — later bindings are covered by the overflow
            # feedback, so a distribution-aware guess beats 1.0)
            return _range_sel(op, lhs.name, float(ctx.est_params[rhs.name]),
                              plan, ctx, quantile=True)
        if isinstance(lhs, E.Col) and isinstance(rhs, E.Col):
            pair = _pair_sel(op, lhs.name, rhs.name, plan, ctx)
            if pair is not None:
                return pair    # measured 2-column range fraction
            if op in ("<", "<=", ">", ">="):
                return _cross_sel(op, lhs.name, rhs.name, plan, ctx)
        return 1.0         # unbound Param / computed lhs: no knowledge

    if isinstance(e, E.CodeEq):
        nd = _n_distinct(e.col, plan, ctx)
        s = 1.0 / nd if nd else 0.1
        return 1.0 - s if e.negate else s
    if isinstance(e, E.CodeIn):
        nd = _n_distinct(e.col, plan, ctx)
        return min(len(e.codes) / nd, 1.0) if nd else 0.3
    if isinstance(e, E.CodeRange):
        nd = _n_distinct(e.col, plan, ctx)
        return min(max((e.hi - e.lo) / nd, 0.0), 1.0) if nd else 0.3
    if isinstance(e, (E.WordCode, E.StrContainsWord)):
        # word membership: no positional statistics; stay conservative
        s = 0.5
        return 1.0 - s if e.negate else s

    # un-lowered string predicates (string_dict off): same dictionary
    # statistics, evaluated against the char matrices at runtime
    if isinstance(e, E.StrEq):
        nd = _n_distinct(e.col, plan, ctx)
        s = 1.0 / nd if nd and not isinstance(e.value, E.Param) else 1.0
        return 1.0 - s if e.negate else s
    if isinstance(e, E.StrIn):
        nd = _n_distinct(e.col, plan, ctx)
        if nd and not any(isinstance(v, E.Param) for v in e.values):
            return min(len(e.values) / nd, 1.0)
        return 1.0
    if isinstance(e, E.StrStartsWith):
        tc = _base_column(plan, e.col, ctx)
        if tc is not None and not isinstance(e.prefix, E.Param):
            t, name = tc
            if name in t.vocabs:
                lo, hi = t.code_range(name, e.prefix)
                return (hi - lo) / max(len(t.vocabs[name]), 1)
        return 1.0

    return 1.0             # Where / arithmetic / unknown: assume nothing


def _range_sel(op: str, name: str, v: float, plan: ir.Plan, ctx: _Ctx,
               quantile: bool = False) -> float:
    tc = _base_column(plan, name, ctx)
    if tc is None:
        return 1.0
    t, cname = tc
    st = t.stats.get(cname)
    if st is None:
        return 1.0
    lo, hi = float(st.min), float(st.max)
    span = hi - lo
    if op == "==":
        if st.n_distinct:
            return 1.0 / st.n_distinct
        return 1.0 / max(span, 1.0)
    if op == "!=":
        return 1.0
    if span <= 0:
        return 1.0
    if quantile and t.schema.col(cname).kind in (ColKind.INT, ColKind.FLOAT,
                                                 ColKind.DATE):
        # equi-depth quantile CDF: error bounded by one knot interval,
        # robust to skew (the min/max interpolation below is not)
        frac_le = t.cdf(cname, v)
        return frac_le if op in ("<", "<=") else 1.0 - frac_le
    # clamp per leaf: the And/Or/Not combiners assume [0, 1], and a bound
    # outside the stats range would otherwise go negative / above one
    if op in ("<", "<="):
        return min(max((v - lo) / span, 0.0), 1.0)
    return min(max((hi - v) / span, 0.0), 1.0)     # > / >=


def _pair_sel(op: str, a: str, b: str, plan: ir.Plan, ctx: _Ctx
              ) -> Optional[float]:
    """Measured fraction for `a op b` when both columns resolve to the
    SAME base table (row-aligned compare is only meaningful there)."""
    if op not in ("<", "<=", ">", ">=", "==", "!="):
        return None
    ta, tb = _base_column(plan, a, ctx), _base_column(plan, b, ctx)
    if ta is None or tb is None or ta[0] is not tb[0]:
        return None
    return ta[0].pair_frac(ta[1], op, tb[1])


def _cross_sel(op: str, a: str, b: str, plan: ir.Plan, ctx: _Ctx) -> float:
    """Cross-table column inequality `a op b`: independence estimate from
    the two marginal quantile sketches, replacing the textbook flat 0.5.

    P(a <= b) = E_b[cdf_a(b)]; the knots of b's sketch are equi-depth, so
    the plain mean of cdf_a over them IS that expectation up to one knot
    interval of error.  Both integration directions are evaluated and the
    result is clamped BY the textbook 0.5 (`min`): the measured fractions
    can only tighten a downstream capacity, never loosen it past the
    default — an undershoot re-plans through the overflow feedback, an
    overshoot would waste capacity silently forever."""
    ta, tb = _base_column(plan, a, ctx), _base_column(plan, b, ctx)
    if ta is None or tb is None:
        return 0.5
    numeric = (ColKind.INT, ColKind.FLOAT, ColKind.DATE)
    for t, cname in (ta, tb):
        if t.schema.col(cname).kind not in numeric:
            return 0.5
    (t_a, ca), (t_b, cb) = ta, tb
    le_ab = float(np.mean([t_a.cdf(ca, float(v))
                           for v in t_b.quantile_sketch(cb)]))  # P(a <= b)
    le_ba = float(np.mean([t_b.cdf(cb, float(v))
                           for v in t_a.quantile_sketch(ca)]))  # P(b <= a)
    if op in ("<", "<="):
        est = min(le_ab, 1.0 - le_ba)
    else:
        est = min(1.0 - le_ab, le_ba)
    return min(max(est, 0.01), 0.5)


def _dense_groups(p: ir.Agg, c: Card, D: float, ctx: _Ctx) -> float:
    """Expected occupied groups of a dense aggregation — tighter than
    `min(valid rows, domain)` (the ROADMAP residual behind q3's top-k:
    that bound left the dense agg's output too wide to compact before
    the Sort).

    Two refinements over the naive bound:

      * the *live key population* d: the static domain (parent row
        count for key columns) is capped per group column by the base
        table's measured distinct count and by the join-filtered key
        population recorded in `ctx.key_groups` — a group key only
        reaches the agg if its join survivors did;
      * *collision mass*: n valid rows thrown at d live keys occupy
        `d * (1 - (1 - 1/d)^n)` expected groups (balls in bins) — far
        below min(n, d) when rows per group vary, exact in expectation
        under the independence the rest of this planner already assumes.

    Both only ever tighten, and the planted capacity keeps the usual
    `compact_margin` + pow2-bucket headroom above the estimate; an
    undershoot degrades to the overflow-twin fallback plus re-plan, never
    to a wrong result."""
    n = c.valid
    naive = min(D, n)
    if n <= 0 or not p.group_by:
        return naive
    d = 1.0
    domains = p.domains or [0] * len(p.group_by)
    for name, dom in zip(p.group_by, domains):
        per = float(dom) if dom else D
        nd = _n_distinct(name, p, ctx)
        if nd:
            per = min(per, float(nd))
        kg = ctx.key_groups.get(name)
        if kg is not None:
            per = min(per, kg)
        d *= max(per, 1.0)
    if d <= 1.0:
        return min(naive, 1.0)
    # numerically stable (1 - 1/d)^n for large d, n
    groups = d * -math.expm1(n * math.log1p(-1.0 / d))
    return min(naive, groups)


def _n_distinct(name: str, plan: ir.Plan, ctx: _Ctx) -> Optional[int]:
    tc = _base_column(plan, name, ctx)
    if tc is None:
        return None
    t, cname = tc
    st = t.stats.get(cname)
    return st.n_distinct if st is not None and st.n_distinct else None


def _base_column(p: ir.Plan, name: str, ctx: _Ctx):
    """(Table, column) provenance of a (possibly renamed) base column,
    answered by the analysis layer's schema inference (one bottom-up pass
    shared by every estimate in this plan)."""
    ci = ctx.analysis.col(p, name) if ctx.analysis is not None else None
    if ci is None or ci.table is None:
        return None
    return ctx.db.table(ci.table), ci.col
