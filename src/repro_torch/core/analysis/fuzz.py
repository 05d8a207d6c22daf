"""Plan fuzzer: seeded random TPC-H plans through every preset rung.

Generates schema-valid plans by construction (columns drawn from the
live table schemas, join keys from declared FKs, constants from load-time
stats), then checks two properties on each:

  * **verifier-clean** — `optimize()` with `verify_passes` on must accept
    the plan at every preset rung: the generator and the verifier agree
    on what a well-formed plan is, and no pass miscompiles it into an
    ill-formed one.
  * **oracle equivalence** — compiled execution (the port's
    `CompiledQuery`, on the card unless a device is named) must match the
    port's interpreted Volcano engine row-for-row (sort-insensitive,
    float tolerance), so the pass pipeline and the staged operators
    preserve semantics on plan shapes nobody hand-wrote.

The generator deliberately covers the shapes the passes specialize on:
FK join chains (pk_gather), the composite lineitem->partsupp join
(bucket_gather / uint32 packing), semi/anti joins (exists_flag), date
range predicates (DateIndex), CAT predicates and group keys
(StringDictionary / dense lowering), selective conjunctions (Compaction),
group-key Sorts with Limit (top-k rewrite).

CLI:  python -m repro_torch.core.analysis.fuzz --n 200 [--device cpu]
writes BENCH_torch_fuzz.json and exits nonzero on any violation or drift.
It runs on the card unless `--device` names another device, and the
`opt-shard` rung plans over `CLI_SHARDS` virtual slots of that device
(`core/mesh.py`), as the reference's CI plans over 8 virtual XLA devices.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core import ir
from repro_torch.relational.loader import Database
from repro_torch.relational.schema import ColKind

# stream table -> (stream fk col, build table, build pk col); chains are
# discovered dynamically: an inner join exposes the parent's own FKs.
FK_JOINS: dict[str, list[tuple[str, str, str]]] = {
    "lineitem": [
        ("l_orderkey", "orders", "o_orderkey"),
        ("l_partkey", "part", "p_partkey"),
        ("l_suppkey", "supplier", "s_suppkey"),
    ],
    "orders": [("o_custkey", "customer", "c_custkey")],
    "customer": [("c_nationkey", "nation", "n_nationkey")],
    "partsupp": [
        ("ps_partkey", "part", "p_partkey"),
        ("ps_suppkey", "supplier", "s_suppkey"),
    ],
    "supplier": [("s_nationkey", "nation", "n_nationkey")],
    "part": [],
    "nation": [],
    "region": [],
}

BASE_TABLES = [
    "lineitem",
    "lineitem",
    "orders",
    "orders",
    "partsupp",
    "customer",
    "supplier",
]

# virtual device slots the CLI's opt-shard rung plans over
CLI_SHARDS = 4

# lineitem col-vs-col date compares (the correlated-conjunct shapes the
# compaction clamp measures)
_DATE_PAIRS = [
    ("l_shipdate", "l_commitdate"),
    ("l_commitdate", "l_receiptdate"),
    ("l_shipdate", "l_receiptdate"),
]


def _is_key(schema, name: str) -> bool:
    return name in schema.primary_key or schema.fk_for(name) is not None


def _pred_for(
    rng: np.random.Generator, db: Database, table: str, name: str
) -> Optional[E.Expr]:
    """One random predicate over a single column, bounds from stats."""
    t = db.table(table)
    kind = t.schema.col(name).kind
    st = t.stats.get(name)
    if kind in (ColKind.FLOAT, ColKind.INT, ColKind.DATE):
        if st is None or st.max <= st.min:
            return None
        lo = float(rng.uniform(st.min, st.max))
        hi = float(rng.uniform(lo, st.max))
        if kind != ColKind.FLOAT:
            lo, hi = float(int(lo)), float(int(hi) + 1)
        def mk(v):
            return E.lit(int(v)) if kind != ColKind.FLOAT else E.lit(v)

        form = rng.integers(3)
        if form == 0:
            return E.Cmp("<", E.col(name), mk(hi))
        if form == 1:
            return E.Cmp(">=", E.col(name), mk(lo))
        return E.And(
            E.Cmp(">=", E.col(name), mk(lo)), E.Cmp("<", E.col(name), mk(hi))
        )
    if kind == ColKind.CAT:
        vocab = t.vocabs.get(name)
        if vocab is None or len(vocab) == 0:
            return None
        if len(vocab) > 1 and rng.integers(2):
            k = int(rng.integers(1, min(3, len(vocab)) + 1))
            picks = rng.choice(len(vocab), size=k, replace=False)
            return E.StrIn(name, tuple(str(vocab[i]) for i in sorted(picks)))
        v = str(vocab[rng.integers(len(vocab))])
        return E.StrEq(name, v, negate=bool(len(vocab) > 1 and rng.integers(4) == 0))
    return None  # TEXT: word predicates need curated words; skip


def _random_conjunction(rng, db, table: str, n: int) -> Optional[E.Expr]:
    schema = db.table(table).schema
    cands = [
        c.name
        for c in schema.columns
        if c.kind != ColKind.TEXT and not _is_key(schema, c.name)
    ]
    parts: list[E.Expr] = []
    if table == "lineitem" and rng.integers(3) == 0:
        a, b = _DATE_PAIRS[rng.integers(len(_DATE_PAIRS))]
        parts.append(E.Cmp("<", E.col(a), E.col(b)))
    while len(parts) < n and cands:
        name = cands.pop(int(rng.integers(len(cands))))
        p = _pred_for(rng, db, table, name)
        if p is not None:
            parts.append(p)
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = E.And(out, p)
    return out


def random_plan(rng: np.random.Generator, db: Database) -> ir.Plan:
    """One schema-valid random plan (deterministic in `rng`'s state)."""
    base = BASE_TABLES[rng.integers(len(BASE_TABLES))]
    plan: ir.Plan = ir.Scan(base)
    # columns available on the stream frame, per source table
    avail_tables = [base]

    pred = _random_conjunction(rng, db, base, int(rng.integers(1, 4)))
    if pred is not None:
        plan = ir.Select(plan, pred)

    # composite lineitem->partsupp join (bucket_gather / uint32 pack paths)
    if base == "lineitem" and rng.integers(3) == 0:
        plan = ir.Join(
            plan,
            ir.Scan("partsupp"),
            "l_partkey",
            "ps_partkey",
            stream_key2="l_suppkey",
            build_key2="ps_suppkey",
        )
        avail_tables.append("partsupp")

    # FK join chain: each inner join exposes the parent's own FKs
    fks = list(FK_JOINS[base])
    for _ in range(int(rng.integers(3))):
        if not fks:
            break
        skey, btable, bkey = fks.pop(int(rng.integers(len(fks))))
        if btable in avail_tables:
            continue
        build: ir.Plan = ir.Scan(btable)
        if rng.integers(2):
            bpred = _random_conjunction(rng, db, btable, int(rng.integers(1, 3)))
            if bpred is not None:
                build = ir.Select(build, bpred)
        kind = ["inner", "inner", "inner", "semi", "anti"][rng.integers(5)]
        plan = ir.Join(plan, build, skey, bkey, kind=kind)
        if kind == "inner":
            avail_tables.append(btable)
            fks.extend(FK_JOINS[btable])

    def cols_of(kinds) -> list[tuple[str, str]]:
        out = []
        for tn in avail_tables:
            for c in db.table(tn).schema.columns:
                if c.kind in kinds:
                    out.append((tn, c.name))
        return out

    if rng.integers(3):  # 2/3 of plans aggregate
        floats = cols_of((ColKind.FLOAT,))
        cats = cols_of((ColKind.CAT,))
        grouped = bool(cats) and rng.integers(4) > 0
        aggs: list[ir.AggSpec] = []
        fns = ["sum", "avg", "min", "max"] if grouped else ["sum"]
        for i in range(int(rng.integers(1, 4))):
            if not floats or rng.integers(4) == 0:
                aggs.append(ir.AggSpec(f"a{i}", "count"))
            else:
                _, fname = floats[rng.integers(len(floats))]
                aggs.append(
                    ir.AggSpec(f"a{i}", fns[rng.integers(len(fns))], E.col(fname))
                )
        if not grouped:
            return ir.Agg(plan, [], aggs)
        nkeys = int(rng.integers(1, min(2, len(cats)) + 1))
        picks = rng.choice(len(cats), size=nkeys, replace=False)
        keys = [cats[i][1] for i in picks]
        plan = ir.Agg(plan, keys, aggs)
        plan = ir.Sort(plan, [(k, True) for k in keys])
        if rng.integers(5) < 2:
            # group keys are unique above the Agg -> deterministic top-k
            plan = ir.Limit(plan, int(rng.integers(1, 21)))
        return plan

    # non-aggregating plan: cap the output with a narrowing Project
    scalars = cols_of((ColKind.INT, ColKind.FLOAT, ColKind.DATE, ColKind.CAT))
    n = int(rng.integers(2, min(5, len(scalars)) + 1))
    picks = rng.choice(len(scalars), size=n, replace=False)
    rename = rng.integers(3) == 0
    outputs = {}
    for j, i in enumerate(picks):
        _, cname = scalars[i]
        outputs[f"x{j}" if rename else cname] = E.col(cname)
    return ir.Project(plan, outputs, keep_input=False)


# ---------------------------------------------------------------------------
# oracle-equivalence checking (mirrors tests/test_queries.py's canon)
# ---------------------------------------------------------------------------


def _canon(res: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    names = sorted(res)
    keys = []
    for k in names:
        v = np.asarray(res[k])
        keys.append(np.round(v.astype(np.float64), 2) if v.dtype.kind == "f" else v)
    order = np.lexsort(tuple(reversed(keys)))
    return {k: np.asarray(res[k])[order] for k in names}


def results_match(a: dict, b: dict) -> Optional[str]:
    """None when equivalent, else a one-line description of the drift."""
    if set(a) != set(b):
        return f"columns differ: {sorted(a)} vs {sorted(b)}"
    if not a:
        return None
    na = {len(np.asarray(v)) for v in a.values()}
    nb = {len(np.asarray(v)) for v in b.values()}
    if na != nb:
        return f"row counts differ: {na} vs {nb}"
    ca, cb = _canon(a), _canon(b)
    for k in ca:
        va, vb = ca[k], cb[k]
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            if not np.allclose(
                va.astype(np.float64),
                vb.astype(np.float64),
                rtol=2e-3,
                atol=1e-2,
                equal_nan=True,
            ):
                return f"column {k}: values drift"
        elif not np.array_equal(va, vb):
            return f"column {k}: values differ"
    return None


@dataclasses.dataclass
class FuzzReport:
    n_plans: int = 0
    n_optimized: int = 0
    n_compiled: int = 0
    failures: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def run_fuzz(
    db: Database,
    n: int,
    presets: Optional[list[str]] = None,
    seed0: int = 0,
    compile_presets: Optional[list[str]] = None,
    compile_every: int = 1,
    verbose: bool = False,
    device=None,
) -> FuzzReport:
    """Fuzz `n` seeded plans.

    Every plan runs through `optimize()` (verifier on) at each rung in
    `presets`, planned for `device`; every `compile_every`-th plan
    additionally compiles on `device` (None: the card) at each rung in
    `compile_presets` and is compared against the Volcano oracle.
    """
    # imported here, not at module top: analysis/__init__ must stay
    # importable from the passes alone
    from repro_torch.core.compile import CompiledQuery, resolve_device
    from repro_torch.core.passes.pipeline import LADDER, preset
    from repro_torch.core.volcano import VolcanoEngine

    device = resolve_device(device)

    # the opt-pallas and opt-shard rungs ride along by default: same plans,
    # same oracle, exercising the fused kernel paths (their plain versions
    # on the CPU) and the Exchange-planting pass + its verifier rules.
    # opt-shard stays out of compile_presets, as in the reference: the
    # optimize rung is where the sharding invariants live.
    presets = (presets if presets is not None
               else list(LADDER) + ["opt-pallas", "opt-shard"])
    compile_presets = (
        compile_presets if compile_presets is not None
        else ["naive", "opt", "opt-pallas"]
    )
    oracle = VolcanoEngine(db)
    rep = FuzzReport()
    for i in range(n):
        seed = seed0 + i
        rng = np.random.default_rng(seed)
        plan = random_plan(rng, db)
        rep.n_plans += 1
        for pname in presets:
            try:
                from repro_torch.core.passes.pipeline import optimize

                optimize(copy.deepcopy(plan), db, preset(pname),
                         device=device)
                rep.n_optimized += 1
            except Exception as err:
                rep.failures.append(
                    {
                        "seed": seed,
                        "preset": pname,
                        "stage": "optimize",
                        "error": f"{type(err).__name__}: {err}",
                        "plan": ir.plan_repr(plan),
                    }
                )
        if compile_every <= 0 or i % compile_every:
            continue
        try:
            want = oracle.execute(copy.deepcopy(plan))
        except Exception as err:
            rep.failures.append(
                {
                    "seed": seed,
                    "preset": "volcano",
                    "stage": "oracle",
                    "error": f"{type(err).__name__}: {err}",
                    "plan": ir.plan_repr(plan),
                }
            )
            continue
        for pname in compile_presets:
            try:
                got = CompiledQuery(copy.deepcopy(plan), db, preset(pname),
                                    device=device).run()
                drift = results_match(got, want)
                rep.n_compiled += 1
            except Exception as err:
                drift = f"{type(err).__name__}: {err}"
            if drift is not None:
                rep.failures.append(
                    {
                        "seed": seed,
                        "preset": pname,
                        "stage": "execute",
                        "error": drift,
                        "plan": ir.plan_repr(plan),
                    }
                )
        if verbose and (i + 1) % 25 == 0:
            print(f"  fuzz: {i + 1}/{n} plans, {len(rep.failures)} failures")
    return rep


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument(
        "--compile-every",
        type=int,
        default=1,
        help="compile+execute every k-th plan (0 = never)",
    )
    ap.add_argument("--device", default=None,
                    help="device to compile on (default: the card)")
    ap.add_argument("--out", default="BENCH_torch_fuzz.json")
    args = ap.parse_args(argv)

    from repro_torch.core import mesh
    from repro_torch.core.compile import resolve_device

    device = resolve_device(args.device)
    db = Database.tpch(sf=args.sf, seed=0)
    mesh.virtual_devices(device, CLI_SHARDS)
    t0 = time.time()
    try:
        rep = run_fuzz(db, args.n, seed0=args.seed,
                       compile_every=args.compile_every, verbose=True,
                       device=device)
    finally:
        mesh.virtual_devices(device, 1)
    wall = time.time() - t0
    out = {
        "n_plans": rep.n_plans,
        "n_optimized": rep.n_optimized,
        "n_compiled": rep.n_compiled,
        "wall_s": round(wall, 2),
        "device": str(device),
        "failures": rep.failures[:20],
        "n_failures": len(rep.failures),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(
        f"fuzz: {rep.n_plans} plans, {rep.n_optimized} optimizes, "
        f"{rep.n_compiled} compiles, {len(rep.failures)} failures "
        f"({wall:.1f}s) -> {args.out}"
    )
    for fail in rep.failures[:5]:
        print(
            f"  seed={fail['seed']} preset={fail['preset']} "
            f"[{fail['stage']}] {fail['error']}"
        )
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
