#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # TPC-H SF 1, seed 0, on CUDA device 0

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. print the card's name and power limit (nvidia-smi);
  2. generate TPC-H at SF 1 and run q1, q3, q6 and q12 at `opt` and
     `opt-pallas` on the CPU — the port's own reference answers — while
     recording the operands the opt-pallas plans hand to each kernel;
  3. build every kernel library (one nvcc per source, all at once);
  4. hold each kernel against its plain torch version on the card, at the
     recorded SF 1 shapes and at edge cases (1 and 37 rows, no valid row,
     overflow past the capacity, translate), and time kernel, plain
     version and, where one exists, a single PyTorch call computing the
     same function;
  5. reset the launch counters, run the four queries at both presets on
     the card through `CompiledQuery(...).run()`, compare every answer
     with the CPU answer, and require every kernel to have launched under
     opt-pallas (and none under opt); then time each query;
  6. print one `{"kernels": [...]}` line, and last the result line.

Tolerances: integer outputs (row ids, counts, slots) must match exactly.
Float sums may differ in summation order (the kernels add in shared
memory and then per block in a fixed order; the plain versions add with
`index_add_`), so they are held to rtol 1e-3, atol 1e-3; query answers to
the repo's `assert_same` rule (rtol 2e-3, atol 1e-2).

`--rehearse` runs the same phases on the CPU (plain versions only, no
build, no launch checks) at `--sf`, to test the script without a card;
it prints no result line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
SLICE = ["q1", "q3", "q6", "q12"]
PRESETS = ["opt", "opt-pallas"]
SORT_INSENSITIVE = {"q3"}
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)
REPLACES = {
    "compact": "src/repro/kernels/compact.py:98",
    "compact_pred": "src/repro/kernels/compact.py:158",
    "filter_agg": "src/repro/kernels/filter_agg.py:58",
    "selective_filter_agg": "src/repro/kernels/filter_agg.py:156",
}
SOURCES = {
    "compact": "src/repro_torch/kernels/csrc/compact.cuh",
    "compact_pred": "src/repro_torch/kernels/csrc/compact.cuh",
    "filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
    "selective_filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
}


def log(*a):
    print(*a, flush=True)


class CheckFailed(Exception):
    pass


def check(cond, what) -> None:
    """A check of the run (kept under `python -O`, unlike assert)."""
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

def assert_same(a: dict, b: dict, sort_insensitive: bool, what: str):
    """The repo's answer comparison: same columns and rows, exact on ints,
    rtol 2e-3 / atol 1e-2 on floats, rows sorted first when the query's
    order may differ under float ties."""
    import numpy as np

    check(set(a) == set(b), f"{what}: columns differ")

    def canon(res):
        names = sorted(res)
        if not sort_insensitive:
            return {k: res[k] for k in names}
        keys = [np.round(res[k].astype(np.float64), 2)
                if res[k].dtype.kind == "f" else res[k] for k in names]
        order = np.lexsort(tuple(reversed(keys)))
        return {k: res[k][order] for k in names}

    ca, cb = canon(a), canon(b)
    for k in ca:
        va, vb = ca[k], cb[k]
        check(len(va) == len(vb), f"{what}.{k}: {len(va)} vs {len(vb)} rows")
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            check(np.isfinite(va.astype(np.float64)).all(), f"{what}.{k}")
            np.testing.assert_allclose(
                va.astype(np.float64), vb.astype(np.float64),
                rtol=2e-3, atol=1e-2, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# phase 2: CPU answers + the operands each kernel sees
# ---------------------------------------------------------------------------

def cpu_answers(db):
    """Run the slice on the CPU; record every kernel entry point's
    arguments under opt-pallas as (query, entry, args, kwargs)."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.relational.queries import QUERIES

    calls = []
    names = ["filter_agg_query", "compact_query", "compact_pred_query",
             "selective_agg_query"]
    saved = {n: getattr(kops, n) for n in names}
    current = [None]

    def recorder(name, fn):
        def g(*a, **k):
            calls.append((current[0], name, a, k))
            return fn(*a, **k)
        return g

    answers = {}
    for n in names:
        setattr(kops, n, recorder(n, saved[n]))
    try:
        for q in SLICE:
            for p in PRESETS:
                current[0] = q if p == "opt-pallas" else None
                t0 = time.perf_counter()
                cq = CompiledQuery(QUERIES[q](), db, preset(p), device="cpu")
                answers[q, p] = cq.run()
                check(cq.n_overflows == 0, (q, p))
                log(f"cpu {q} {p}: {time.perf_counter() - t0:.2f} s")
    finally:
        for n in names:
            setattr(kops, n, saved[n])
    return answers, [c for c in calls if c[0] is not None]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def to(dev, x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to(dev, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to(dev, v) for v in x)
    return x


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    between CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def max_err(got, want, what: str) -> float:
    """Max |got - want| over matching outputs; ints must be equal, floats
    within KERNEL_TOL."""
    import torch

    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach(), w.detach()
        check(g.shape == w.shape, f"{what}[{k}]: {g.shape} vs {w.shape}")
        if g.numel() == 0:
            continue
        if g.dtype.is_floating_point:
            check(torch.isfinite(g).all(), f"{what}[{k}] not finite")
            check(torch.allclose(g, w, **KERNEL_TOL),
                  f"{what}[{k}]: max err {(g - w).abs().max().item()}")
        else:
            check(torch.equal(g, w), f"{what}[{k}] differs")
        err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(records, dev, timed: bool):
    """One entry per kernel: max error over every check, times and bound
    at the SF 1 shape of the slice (the largest recorded call)."""
    import torch

    from repro_torch.kernels import compact as kc
    from repro_torch.kernels import filter_agg as kf

    out = {}

    def note(name, err, shape_bytes, n, timers):
        e = out.setdefault(name, {"max_abs_err": 0.0, "n": -1})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if timers is not None and n > e["n"]:
            e["n"] = n
            e["bytes"] = shape_bytes
            e.update({k: (time_ms(f) if (f is not None and timed) else None)
                      for k, f in timers.items()})

    for q, entry, a, k in records:
        a, k = to(dev, a), to(dev, k)
        if entry == "filter_agg_query":
            mask, gidx, vals, G = a
            gidx = gidx.to(torch.int32)
            vals = [v.to(torch.float32) for v in vals]
            got = kf.filter_agg(mask, gidx, vals, G)
            want = kf.filter_agg_plain(mask, gidx, vals, G)
            err = max_err(got, want, f"filter_agg {q}")
            A = len(vals)
            vm = torch.where(mask[:, None], torch.stack(vals, 1), 0.0)
            lib_out = torch.zeros((G, A), device=mask.device)
            note("filter_agg", err,
                 nbytes(mask, gidx, *vals) + 4 * G * (A + 1),
                 mask.shape[0], {
                     "ms": lambda: kf.filter_agg(mask, gidx, vals, G),
                     "plain_ms": lambda: kf.filter_agg_plain(mask, gidx,
                                                             vals, G),
                     "library_ms": lambda: lib_out.index_add_(0, gidx, vm)})
        elif entry == "compact_query":
            mask, cap = a
            tr = k.get("translate", False)
            got = kc.compact(mask, cap, translate=tr)
            want = kc.compact_plain(mask, cap, tr)
            err = max_err(got, want, f"compact {q}")
            n = mask.shape[0]
            note("compact", err,
                 nbytes(mask) + 4 * cap + 4 + (4 * n if tr else 0), n, {
                     "ms": lambda: kc.compact(mask, cap, translate=tr),
                     "plain_ms": lambda: kc.compact_plain(mask, cap, tr),
                     "library_ms": lambda: torch.nonzero(mask)})
        elif entry == "compact_pred_query":
            cols, scalars, pred_fn, cap = a
            tr = k.get("translate", False)
            got = kc.compact_pred(cols, scalars, pred_fn, cap, translate=tr)
            want = kc.compact_pred_plain(cols, scalars, pred_fn, cap, tr)
            err = max_err(got, want, f"compact_pred {q}")
            n = next(iter(cols.values())).shape[0]
            note("compact_pred", err,
                 nbytes(*cols.values()) + 4 * cap + 4 + (4 * n if tr else 0),
                 n, {
                     "ms": lambda: kc.compact_pred(cols, scalars, pred_fn,
                                                   cap, translate=tr),
                     "plain_ms": lambda: kc.compact_pred_plain(
                         cols, scalars, pred_fn, cap, tr),
                     "library_ms": None})
        elif entry == "selective_agg_query":
            cols, scalars, pred_fn, value_fns, gidx_fn, G = a
            got = kf.selective_filter_agg(cols, scalars, pred_fn, value_fns,
                                          gidx_fn, G)
            want = kf.selective_filter_agg_plain(cols, scalars, pred_fn,
                                                 value_fns, gidx_fn, G)
            err = max_err(got, want, f"selective_filter_agg {q}")
            n = next(iter(cols.values())).shape[0]
            A = len(value_fns)
            note("selective_filter_agg", err,
                 nbytes(*cols.values()) + 4 * G * (A + 1) + 4, n, {
                     "ms": lambda: kf.selective_filter_agg(
                         cols, scalars, pred_fn, value_fns, gidx_fn, G),
                     "plain_ms": lambda: kf.selective_filter_agg_plain(
                         cols, scalars, pred_fn, value_fns, gidx_fn, G),
                     "library_ms": None})
    return out


def edge_checks(records, dev):
    """The kernels at the edges: 1 and 37 rows, no valid row, every row
    valid past the capacity, translate; predicates and values from the
    slice's own plans.  Returns the max error per kernel."""
    import torch

    from repro_torch.kernels import compact as kc
    from repro_torch.kernels import filter_agg as kf

    errs = {}
    g = torch.Generator().manual_seed(0)
    preds = {e: a for _q, e, a, _k in records
             if e in ("compact_pred_query", "selective_agg_query")}
    for n in (1, 37, 5000):
        for p in (0.0, 0.3, 1.0):
            mask = (torch.rand(n, generator=g) < p).to(dev)
            for cap in (1, 8, 4096):
                for tr in (False, True):
                    e = max_err(kc.compact(mask, cap, translate=tr),
                                kc.compact_plain(mask, cap, tr),
                                f"compact edge n={n} cap={cap}")
                    errs["compact"] = max(errs.get("compact", 0.0), e)
            for G in (1, 7, 130):
                gidx = torch.randint(0, G, (n,), generator=g,
                                     dtype=torch.int32).to(dev)
                vals = [torch.randn(n, generator=g).to(dev)
                        for _ in range(3)]
                e = max_err(kf.filter_agg(mask, gidx, vals, G),
                            kf.filter_agg_plain(mask, gidx, vals, G),
                            f"filter_agg edge n={n} G={G}")
                errs["filter_agg"] = max(errs.get("filter_agg", 0.0), e)
        if "compact_pred_query" in preds:
            cols, scalars, pred_fn, _cap = to(dev, preds["compact_pred_query"])
            sub = {k: v[:n].contiguous() for k, v in cols.items()}
            for cap in (1, 8, 4096):
                for tr in (False, True):
                    e = max_err(
                        kc.compact_pred(sub, scalars, pred_fn, cap,
                                        translate=tr),
                        kc.compact_pred_plain(sub, scalars, pred_fn, cap, tr),
                        f"compact_pred edge n={n} cap={cap}")
                    errs["compact_pred"] = max(errs.get("compact_pred", 0.0),
                                               e)
        if "selective_agg_query" in preds:
            cols, scalars, pred_fn, vfns, gfn, G = to(
                dev, preds["selective_agg_query"])
            sub = {k: v[:n].contiguous() for k, v in cols.items()}
            e = max_err(
                kf.selective_filter_agg(sub, scalars, pred_fn, vfns, gfn, G),
                kf.selective_filter_agg_plain(sub, scalars, pred_fn, vfns,
                                              gfn, G),
                f"selective edge n={n}")
            errs["selective_filter_agg"] = max(
                errs.get("selective_filter_agg", 0.0), e)
    return errs


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU; prints no result")
    args = ap.parse_args()

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.kernels import build
    from repro_torch.kernels import compact as kc
    from repro_torch.kernels import filter_agg as kf
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    dev = torch.device("cpu" if args.rehearse else "cuda")
    t_start = time.perf_counter()
    if not args.rehearse:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    # -- phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    db = Database.tpch(sf=args.sf, seed=args.seed)
    log(f"tpch sf={args.sf} seed={args.seed}: lineitem "
        f"{db.table('lineitem').nrows} rows, {time.perf_counter() - t0:.1f} s")
    answers, records = cpu_answers(db)
    seen = {(q, e) for q, e, _a, _k in records}
    for q, e in [("q1", "filter_agg_query"), ("q3", "compact_query"),
                 ("q6", "selective_agg_query"), ("q12", "compact_pred_query"),
                 ("q12", "filter_agg_query")]:
        check((q, e) in seen, f"{q} did not reach {e}")

    # -- phase 3 ------------------------------------------------------------
    if not args.rehearse:
        t0 = time.perf_counter()
        sources = build.static_sources()
        for _q, e, a, _k in records:
            a = to(dev, a)
            if e == "compact_pred_query":
                sources.append(kc.pred_source(a[0], a[1], a[2]))
            elif e == "selective_agg_query":
                sources.append(kf.selective_source(*a))
        for p in build.build_all(sources):
            ptx = [ln for ln in p.with_suffix(".log").read_text().splitlines()
                   if "registers" in ln or "spill" in ln]
            log(f"built {p.name}: " + " | ".join(s.strip() for s in ptx))
        log(f"build: {len(sources)} libraries, "
            f"{time.perf_counter() - t0:.1f} s")

    # -- phase 4 ------------------------------------------------------------
    t0 = time.perf_counter()
    checks = kernel_checks(records, dev, timed=not args.rehearse)
    for name, err in edge_checks(records, dev).items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # -- phase 5 ------------------------------------------------------------
    counters = {"compact": (kc.launches, "compact"),
                "compact_pred": (kc.launches, "compact_pred"),
                "filter_agg": (kf.launches, "filter_agg"),
                "selective_filter_agg": (kf.launches, "selective_filter_agg")}
    for d, k in counters.values():
        d[k] = 0
    compiled = {}
    for p in PRESETS:
        for q in SLICE:
            before = {name: d[k] for name, (d, k) in counters.items()}
            cq = CompiledQuery(QUERIES[q](), db, preset(p),
                               device=None if not args.rehearse else "cpu")
            got = cq.run()
            check(cq.n_overflows == 0, (q, p))
            assert_same(got, answers[q, p], q in SORT_INSENSITIVE,
                        f"{q} {p}")
            compiled[q, p] = cq
            delta = {name: d[k] - before[name]
                     for name, (d, k) in counters.items() if d[k] > before[name]}
            log(f"{q} {p}: matches the CPU answer; launches "
                f"{json.dumps(delta)}")
        if p == "opt" and not args.rehearse:
            check(all(d[k] == 0 for d, k in counters.values()),
                  "a kernel launched under opt")
    launched = {name: d[k] for name, (d, k) in counters.items()}
    log(f"main path launches: {json.dumps(launched)}")
    if not args.rehearse:
        missing = [k for k, v in launched.items() if v == 0]
        check(not missing, f"never launched on the main path: {missing}")

    for (q, p), cq in compiled.items():
        sync = torch.cuda.synchronize if not args.rehearse else (lambda: None)
        times = []
        for _ in range(6):
            sync()
            t = time.perf_counter()
            cq.run()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        log(f"query {q} {p}: median {statistics.median(times[1:]):.3f} ms "
            f"(min {min(times[1:]):.3f}) over {len(times) - 1} runs, "
            f"inputs {cq.input_nbytes()} B")

    # -- phase 6 ------------------------------------------------------------
    rows = []
    for name in ["compact", "compact_pred", "filter_agg",
                 "selective_filter_agg"]:
        c = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launched[name],
            "max_abs_err": c["max_abs_err"], "ms": c.get("ms"),
            "plain_ms": c.get("plain_ms"),
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": c.get("library_ms"),
            "rows": c["n"], "bytes": c["bytes"]})
    log(json.dumps({"kernels": rows}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if args.rehearse:
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
