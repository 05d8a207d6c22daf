#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # TPC-H SF 1, seed 0, on CUDA device 0

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. print the card's name and power limit (nvidia-smi);
  2. generate TPC-H at SF 1 and run all 15 queries at `opt` and
     `opt-pallas` on the CPU — the port's own reference answers — and the
     row layout of q1, q6, q12 and q19 at `opt-pallas`, while recording
     the operands the opt-pallas plans hand to each kernel (those of q1,
     q3, q6 and q12 feed phases 4 and 4b), and the batched instances'
     operands of a two-binding `run_many` of each parameterized plan at
     opt-pallas (phase 4c);
  3. build every kernel library, every generated instance phase 5 reaches
     among them and the batched instances of the bind-many pass (one nvcc
     per source, all at once);
  4. hold each kernel against its plain torch version on the card, at the
     recorded SF 1 shapes and at edge cases (1 and 37 rows, no valid row,
     overflow past the capacity, translate), and compaction under many
     tiles (2^22 + 37 rows at densities 0, 0.5 and 1, capacity below and
     above the count, with and without translate, each call 20 times, for
     a race in the look-back scan), for the mask and for a predicate
     evaluated inside the scan; filter_agg called twice at each recorded
     shape, whose sums must be bit-identical (register regime); the
     selective kernel at q6's shape twice, bit-identical, and 20 calls
     back to back at 1, 37 and 908,340 rows (the fold's ticket reset),
     each against the plain version; a NaN in a row the mask drops and
     an infinity in a kept row through filter_agg and the generated
     selective kernel, at G = 3 and 9, bit for bit against the plain
     version and the oracle; the shapes one launch cannot take (17 sums
     beside l_returnflag through the engine at opt-pallas, against the
     CPU answer; a dense G = 4096, A = 14 call, against the plain
     version); time kernel, plain version and, where one exists, a
     single PyTorch call computing the same function, and require one
     kernel a call (compact_pred with its memset, the selective form at
     capacity 0);
  4c. the batched instances (the bind-many pass: `run_many` under
     `torch.func.vmap`, each engine op's vmap rule one launch for B
     bindings): each recorded call widened to B = 1, 7 and 64 bindings,
     against its batched plain version (integers exact, floats within
     KERNEL_TOL), every slot b bit for bit the scalar kernel's output on
     binding b's operands, one launch a call (with its memset for the
     compactions; counted in the host's runtime calls, and on the device
     in up to three profiler windows); at B = 64 each timed (kernel,
     plain version, the one PyTorch call of the same function where
     there is one, device profile, host clock) beside a bound
     that counts a shared operand once and a batched one and every output
     B times; the batched compaction over 2^22 + 37 rows, B = 8, 20 calls
     against one plain answer;
  4b. the kernel library's surface (`repro_torch.kernels`), whose
     gather_join, masked_topk and capacity form of selective_filter_agg
     the engine never calls: reset their launch counters, drive each entry
     point once at SF 1 shapes (customer and lineitem keys into random
     tables, l_extendedprice under q3's shipdate mask, q6's operands with
     a compaction capacity, the matrix filter_agg at q1's operands,
     compact_translate at q3's), read the counters, then hold every
     output and edge case against the plain versions — among them a
     predicate with a float32 subnormal literal, which a build that
     flushed subnormals to zero would get wrong, and top-k over 40,000
     rows of special values (+-0, +-NaN with payloads, +-inf, subnormals,
     -3e38; all rows masked, all equal, k > n) at k = 1, 10 and 1,024,
     which must give the plain version's ids and bit patterns, and
     gather_join at C = 1, 2, 3 and 5 with fk a view at an odd offset
     and NaN and infinity in the table, in both of its ways to read the
     table, bit for bit — and time them, gather_join at 10,000 x 3 also
     with each way forced;
  5. reset the launch counters and run the engine's ladder on the card
     through `CompiledQuery(...).run()`: all 15 queries at `opt` and
     `opt-pallas`, each against its CPU answer; at `naive`, `template`,
     `tpch` and `strdict`, each against the CPU answer at `opt`; the row
     layout of q1, q6, q12 and q19 at `naive`, `opt` and `opt-pallas`.
     Require every engine kernel to have launched, none outside
     opt-pallas, every opt-pallas run to launch exactly what the
     reference's plan calls at SF 1 (`LAUNCHES_SF1`: q4 filter_agg 1, q7
     compact 1, q9full filter_agg 1, ...; tests/test_torch_sf1_launches.py
     counts them in the reference), and no overflow at opt or opt-pallas.
     Time every query and rung (median and minimum of 5 runs after one
     warm-up, `run()` and the device program alone), freeing each query
     before the next;
  7. reset the launch counters and drive the serving path on the card at
     opt-pallas through its entry points (`PlanCache.execute`,
     `execute_many`, `execute_tiered`, `QueryServer.serve_batch`,
     `run_chaos`): (a) the six parameterized queries, default then
     alternative bindings, each against a CPU plan cache's answer at
     opt, one staging a shape, no library built by the rebind, the
     launches `LAUNCHES_SF1_PARAM` requires, cold (staging, `compile()`
     and first run) and warm times, and a specialized binding's own
     build; (b) the batched pass, its launch counters set to 0 before
     and read after: 64 bindings of each of the six plans as one
     `run_many`, one execution each, launching exactly
     `LAUNCHES_SF1_PARAM[q]` (not 64 times it), every batched instance
     launched, the pass's peak device memory; every slot against `run`
     and the CPU; at 1, 2, 3, 4, 16 and 64 bindings the executions
     `run_many` takes (one scalar walk a binding below
     `compile.BATCH_MIN`, else passes), then `execute_many`, the entry's
     `run_many`, one batched pass (`run_batched`) and n `run`s, ms a
     binding (least of 3); a planted
     64-row point that one slot of 64 overflows: one overflow, the twin
     run once, every slot equal to the CPU; (c) a hand-planted 64-row compaction point
     that overflows: the twin's answer, the true count observed, one
     re-plan that stages once and then no overflow; (d) a tiered cache:
     request 1 from the oracle, then the promoted opt-pallas tier, equal
     answers; (e) a query server over 48 mixed requests: all resolved,
     its statistics balanced, one staging a shape; (f) the chaos
     harness: every future resolved, balanced, retried faults served,
     no drift from the port's Volcano; (g) warm state saved and loaded;
     (h) the peak device memory of the phase, and that closing every
     cache and server gives its memory back.  Require every engine
     kernel to have launched;
  8. the sharded path: all 15 queries at opt and opt-pallas on a 2-shard
     data mesh and at opt-pallas on a 4-shard one (`Settings.shards`;
     the shards sit on as many CUDA devices when the machine has them,
     else on virtual slots of cuda:0, and the phase prints which), each
     run twice against phase 5's unsharded card answer, every shard's
     output bit for bit the same, no overflow, the Exchange count of the
     port's CPU plan, at opt-pallas each engine call a launch of its
     kernel and none at opt; at opt-pallas, the largest call of each
     (query, entry point) in a query's first run, on one shard's card
     tensors, held against the plain version with phase 4's tolerances
     (the per-shard shapes: padded blocks, the sharded scan's mask,
     per-shard capacities); the median of 3 `run()`s beside phase 5's
     unsharded median (a record only: one card cannot gain from shards);
  9. the port's plan fuzzer (`repro_torch.core.analysis.fuzz.run_fuzz`)
     on the card at sf 0.05: 24 seeded plans through every `optimize()`
     rung (opt-shard over 4 virtual slots), `naive` and `opt` compiled
     against the port's Volcano, the first 4 also at opt-pallas; no
     failure;
  10. the language-model serving path (no kernel of the port's: the
     reference computes it in plain JAX): (a) Qwen1.5-0.5B at full width
     (24 layers, d_model 1,024, vocab 151,936, bf16 compute), weights
     from `torch.Generator().manual_seed(0)` on the CPU copied to the
     card, through `ServeEngine` with the serving launcher's defaults
     (8 requests, 4 slots, max_len 128, 12 new tokens): every step's
     card logits against a batch-1 bf16 replay of the same tokens
     through `decode_step` on the CPU (LM_BF16_REL), then from a second
     run the median and minimum decode tick with 4 live slots, tok/s,
     the ms of a 128-token prefill at batch 1 and the peak device
     memory, printed beside the card's name and power limit; (b) the
     same model in float32, each request at slots=4 against it alone at
     slots=1 on the same token stream (LM_F32_REL); (c) all ten
     families at smoke width on the card and the CPU with the same
     weights: prefill, 6 decode steps at a (B,) position vector and a
     2-slot engine over 3 requests, logits and caches within
     LM_SMOKE_TOL, the engine's tokens equal.  Prints an
     `{"lm_serving": ...}` line;
  11. the training path (no kernel of the port's: the reference computes
     it in plain JAX), TF32 off: (a) Qwen1.5-0.5B at full width in
     float32, weights from `torch.Generator().manual_seed(0)` on the CPU,
     one loss and gradient at batch 2 x 64 from the pipeline on the card
     and on the CPU from the same masters (loss TRAIN_LOSS_RTOL, global
     norm TRAIN_NORM_RTOL, every leaf TRAIN_LEAF_REL of its largest
     |grad|); (b) the training launcher's run at full width in bf16 (30
     steps of 8 x 64, `AdamConfig(warmup=10)`, async checkpoints every 20
     into a temporary directory, removed after) through `TrainDriver`,
     with a failure injected once at step 25: one recovery, finite
     losses, the replayed steps 20 to 24 within TRAIN_REPLAY_RTOL of
     their first pass, step 0's loss within TRAIN_BF16_LOSS_REL of a
     float32 forward of the same weights and batch; the step's median
     and minimum ms over steps 2 to 19, tok/s, one step's device ms and
     kernels (profiler), peak device memory, the checkpoint's snapshot,
     write and restore seconds and the step's bound
     (`launch/roofline.py`: 6 N D over 989 TFLOP/s, Adam's 28 bytes and
     the bf16 copy's 6 a parameter over 3.35 TB/s); (c) the ten families
     at smoke width, float32, card against CPU with the same weights:
     loss and gradients, then two `train_step`s (the second with
     accum=2 and compression on), params, m, v and ef within rtol 1e-4,
     atol 1e-5 (`repro_torch.train.compare`, with the exceptions it
     derives).  Prints an
     `{"lm_training": ...}` line;
  12. the model-sharding layer (no kernel of the port's), TF32 off,
     weights from `torch.Generator().manual_seed(0)`: (a) Qwen1.5-0.5B at
     full width in float32 as DTensors on a (data=2, model=2) mesh of 4
     virtual slots of cuda:0 (`launch.mesh.world(4, "local")`) against
     the unsharded card run of the same weights: `forward_train` logits
     on 8 x 64 within MESH_LOGIT_REL of the largest |logit|, a 128-token
     prefill at batch 2 and 8 greedy decode steps with equal tokens, one
     loss and gradient and one `train_step` on the training launcher's
     8 x 64 (phase 11 (a)'s limits), and each slot's bytes of parameters
     and Adam state equal to its spec's share; (b) Granite-3.0-1B-A400M at
     full width in float32 on the same mesh, through the MoE's
     `local_map`: `forward_train` on 2 x 64 against each data shard's
     row alone (the MoE routes a shard's tokens alone, its capacity from
     their count) and a batch-1 prefill and 4 decode steps (the
     replicated-token fallback) against unsharded;
     (c) the dry run (`launch/dryrun.py`) of Qwen's three shapes and
     Granite's train_4k at the pod mesh and DeepSeek-V2-236B's decode_32k
     at both meshes, over fake worlds of 256 and 512 ranks: per device
     flops, bytes, collective bytes and memory, the three roofline terms
     (a prediction for a mesh of H100s), useful flops and seconds; (d)
     the phase's peak device memory and seconds.  Prints a
     `{"model_mesh": ...}` line;
  6. print one `{"kernels": [...]}` line (`launches` from phase 5,
     `serving_launches` from phase 7, `sharded_launches` from phase 8's
     opt-pallas runs, `sharded_rows` and `sharded_max_abs_err` from its
     kernel checks; the batched instances' rows their `launches` from
     phase 7 (b)'s batched pass and their times from phase 4c), and last
     the result line.

Every timed kernel shape is also profiled over 10 calls
(`torch.profiler`): `device_ms` (device time of its kernels and memsets
per call) and `kernels_per_call` stand beside the event-timed `ms`, and
for the four engine kernels `host_ms` (host clock around 100 calls with
no synchronisation inside, per call: the wrapper's own cost).

Tolerances: integer outputs (row ids, counts, slots), gathers and top-k
values must match exactly (top-k values bit for bit).
Float sums may differ in summation order (the kernels add per thread,
warp and block in a fixed order, or with shared-memory atomics above the
register regime; the plain versions add with `index_add_`), so they are
held to rtol 1e-3, atol 1e-3, except where a check says bit for bit;
query answers to the repo's `assert_same` rule (rtol 2e-3, atol 1e-2).

`--rehearse` runs the same phases on the CPU (plain versions only, no
build, no launch checks) at `--sf`, to test the script without a card;
phases 10, 11 and 12 (a) and (b) there run the smoke widths only (Qwen
at 2 layers, in bf16 for phase 10 (a)); it prints no result line.  On the card the script runs at SF 1, seed 0
only, the size its launch table holds.
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
# the queries whose kernel operands phase 4 holds against the plain
# versions; phase 5 runs every query of the port
SLICE = ["q1", "q3", "q6", "q12"]
PRESETS = ["opt", "opt-pallas"]
# the rest of the ladder, each held against the CPU answer at opt
LOWER_RUNGS = ["naive", "template", "tpch", "strdict"]
# the row layout where the generated kernels read strided columns
ROW_QUERIES = ["q1", "q6", "q12", "q19"]
ROW_RUNGS = ["naive", "opt", "opt-pallas"]
# kernel launches of each query at opt-pallas, TPC-H SF 1, seed 0: the
# reference's kernel entry calls while its plan is traced, one launch a
# call at these shapes; the row layout of ROW_QUERIES launches the same
# (tests/test_torch_sf1_launches.py holds the reference to this table)
LAUNCHES_SF1 = {
    "q1": {"filter_agg": 1},
    "q3": {"compact": 2, "compact_pred": 1},
    "q4": {"filter_agg": 1},
    "q5": {"compact": 1, "filter_agg": 1},
    "q6": {"selective_filter_agg": 1},
    "q7": {"compact": 1},
    "q9": {"filter_agg": 1},
    "q9full": {"filter_agg": 1},
    "q10": {"compact": 1},
    "q12": {"compact_pred": 1, "filter_agg": 1},
    "q13": {"filter_agg": 1},
    "q14": {"filter_agg": 1},
    "q17": {"compact_pred": 1, "filter_agg": 1},
    "q18": {},
    "q19": {"filter_agg": 1},
}
# kernel launches of one execution of each parameterized plan
# (`PARAM_QUERIES`) at opt-pallas, TPC-H SF 1, seed 0, its capacities
# planned for the default bindings: the reference's kernel entry calls
# while its plan is traced under the default and the alternative bindings
# alike (one program serves both; tests/test_torch_sf1_launches.py holds
# the reference to this table)
LAUNCHES_SF1_PARAM = {
    "q1": {"selective_filter_agg": 1},
    "q3": {"compact": 2, "compact_pred": 1},
    "q6": {"selective_filter_agg": 1},
    "q12": {"compact_pred": 1, "filter_agg": 1},
    "q14": {"filter_agg": 1},
    "q19": {"filter_agg": 1},
}
RUNS = 5                         # timed runs of each query, after a warm-up
SORT_INSENSITIVE = {"q3", "q10", "q18"}
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)
REPLACES = {
    "compact": "src/repro/kernels/compact.py:98",
    "compact_pred": "src/repro/kernels/compact.py:158",
    "filter_agg": "src/repro/kernels/filter_agg.py:58",
    "selective_filter_agg": "src/repro/kernels/filter_agg.py:156",
    "gather_join": "src/repro/kernels/gather_join.py:36",
    "masked_topk": "src/repro/kernels/topk.py:38",
    "selective_filter_agg_capacity": "src/repro/kernels/filter_agg.py:156",
}
SOURCES = {
    "compact": "src/repro_torch/kernels/csrc/compact.cuh",
    "compact_pred": "src/repro_torch/kernels/csrc/compact.cuh",
    "filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
    "selective_filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
    "gather_join": "src/repro_torch/kernels/csrc/gather_join.cu",
    "masked_topk": "src/repro_torch/kernels/csrc/topk.cu",
    "selective_filter_agg_capacity":
        "src/repro_torch/kernels/csrc/filter_agg.cuh",
}
ENGINE_KERNELS = ["compact", "compact_pred", "filter_agg",
                  "selective_filter_agg"]
LIBRARY_KERNELS = ["gather_join", "masked_topk",
                   "selective_filter_agg_capacity"]
SUBNORMAL = 1.1754944e-39        # a float32 subnormal: 2**-126 / 10
PROFILED = ("device_ms", "kernels_per_call", "memsets_per_call",
            "device_kernels")
# engine kernels that must be one launch a call: memsets beside it
ONE_KERNEL = {"compact_pred": 1, "selective_filter_agg": 0}


def log(*a):
    print(*a, flush=True)


def kmod(name: str):
    """A kernel module of the port.  Imported by its full name: the
    package exports functions under the names `compact`, `filter_agg`
    and `gather_join`."""
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


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

# the engine's kernel entry points in `repro_torch.kernels.ops`
ENTRY_POINTS = ["filter_agg_query", "compact_query", "compact_pred_query",
                "selective_agg_query"]


def cpu_answers(db, queries):
    """Run every query at opt and opt-pallas on the CPU, and the row
    layout at opt-pallas for ROW_QUERIES; record every kernel entry
    point's arguments under opt-pallas as (query, entry, args, kwargs),
    the row layout's with the query named `<q>/row`."""
    import dataclasses

    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, preset

    calls = []
    names = ENTRY_POINTS
    saved = {n: getattr(kops, n) for n in names}
    current = [None]

    def recorder(name, fn):
        def g(*a, **k):
            calls.append((current[0], name, a, k))
            return fn(*a, **k)
        return g

    answers = {}
    runs = [(q, p, "column") for q in queries for p in PRESETS] \
        + [(q, "opt-pallas", "row") for q in ROW_QUERIES]
    for n in names:
        setattr(kops, n, recorder(n, saved[n]))
    try:
        for q, p, layout in runs:
            current[0] = None if p != "opt-pallas" else \
                q if layout == "column" else f"{q}/row"
            t0 = time.perf_counter()
            cq = CompiledQuery(queries[q](), db, dataclasses.replace(
                preset(p), layout=layout), device="cpu")
            got = cq.run()
            check(cq.n_overflows == 0, (q, p, layout))
            if layout == "column":
                answers[q, p] = got
            else:
                assert_same(got, answers[q, p], q in SORT_INSENSITIVE,
                            f"cpu {q} {p} row")
            log(f"cpu {q} {p} {layout}: {time.perf_counter() - t0:.2f} s")
    finally:
        for n in names:
            setattr(kops, n, saved[n])
    return answers, [c for c in calls if c[0] is not None]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def to(dev, x, copy: bool = False):
    """`x` with every tensor in it on `dev` (copied even there when
    `copy`)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=copy)
    if isinstance(x, dict):
        return {k: to(dev, v, copy) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to(dev, v, copy) for v in x)
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


def host_ms(fn, calls: int = 100) -> float:
    """The host's time per call of `fn`: `time.perf_counter` around
    `calls` back-to-back calls with no synchronisation inside, after a
    warm-up (the launches queue on the device meanwhile)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e3


# seconds between a profiler window's own warm-up call and the calls it
# counts (profile_call)
PROFILE_SETTLE_S = 0.02


def profile_call(fn, calls: int = 10, times: bool = False) -> dict:
    """Device time and device operations per call of `fn` over `calls`
    calls under torch.profiler, after a warm-up: `device_ms` sums the
    device time of its kernels and memsets; `kernels_per_call` counts
    kernel launches, `memsets_per_call` memsets; `device_kernels` gives
    each one's device ms per call; `api_*_per_call` count the host's
    runtime calls; with `times`, `launch_us` and `kernel_us` give when
    each launch call was made and each kernel began, in µs from the
    first counted launch call.  The window makes one call of its own
    before the counted ones: late in a run on an H100 the profiler lost
    the first device operation of a window, and that call takes its
    place.  The counted calls run inside a `record_function` range;
    device events count from PROFILE_SETTLE_S / 2 before it (the card's
    clock as the profiler reads it was seen 0.5 ms off the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        with record_function("profile_call.counted"):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    span = next(e.time_range for e in events
                if e.name == "profile_call.counted")
    api = [e for e in events if e.device_type == cpu
           and span.start <= e.time_range.start <= span.end
           and e.name.startswith(("cudaLaunch", "cudaMemset"))]
    dev = [e for e in events if e.device_type == cuda
           and e.time_range.start >= span.start - PROFILE_SETTLE_S * 5e5
           and e.name != "profile_call.counted"]   # the range's own mark
    memsets = [e for e in dev if e.name.startswith("Memset")]
    kernels = [e for e in dev
               if not e.name.startswith(("Memset", "Memcpy"))]
    by_name: dict = {}
    for e in dev:                 # names that share 60 characters add up
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.self_device_time_total / 1e3 / calls)
    launches = sorted(e.time_range.start for e in api
                      if e.name.startswith("cudaLaunch"))
    t0 = launches[0] if launches else span.start
    return {"device_ms": sum(e.self_device_time_total for e in dev)
            / 1e3 / calls,
            "kernels_per_call": len(kernels) / calls,
            "memsets_per_call": len(memsets) / calls,
            "device_kernels": by_name,
            # the host's runtime calls, which the tracer records as they
            # are made (a device event can be lost, these are not)
            "api_launches_per_call": len(launches) / calls,
            "api_memsets_per_call": (len(api) - len(launches)) / calls,
            **({"launch_us": [round(t - t0, 1) for t in launches],
                "kernel_us": sorted(round(e.time_range.start - t0, 1)
                                    for e in kernels)} if times else {})}


def max_err(got, want, what: str, exact: bool = False) -> float:
    """Max |got - want| over matching outputs; ints (and floats when
    `exact`) must be equal, other floats within KERNEL_TOL."""
    import torch

    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} outputs")
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach(), w.detach()
        check(g.shape == w.shape, f"{what}[{k}]: {g.shape} vs {w.shape}")
        check(g.dtype == w.dtype, f"{what}[{k}]: {g.dtype} vs {w.dtype}")
        if g.numel() == 0:
            continue
        if g.dtype.is_floating_point and not exact:
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

    kc, kf = kmod("compact"), kmod("filter_agg")

    out = {}

    def note(name, err, shape_bytes, n, timers):
        e = out.setdefault(name, {"max_abs_err": 0.0, "n": -1})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if timers is not None and n > e["n"]:
            e["n"] = n
            e["bytes"] = shape_bytes
            e.update({k: (time_ms(f) if (f is not None and timed) else None)
                      for k, f in timers.items()})
            if timed:
                e["host_ms"] = host_ms(timers["ms"])
                e.update(one_kernel_a_call(name, timers["ms"],
                                           ONE_KERNEL[name])
                         if name in ONE_KERNEL else profile_call(timers["ms"]))
                log(f"{name} at {n} rows: {e['ms']} ms, host "
                    f"{e['host_ms']} ms, device "
                    f"{json.dumps(e['device_kernels'])}")

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
            # the main path's shapes aggregate in registers: a second
            # call must give the same sums bit for bit
            again = kf.filter_agg(mask, gidx, vals, G)
            check(torch.equal(got[0], again[0])
                  and torch.equal(got[1], again[1]),
                  f"filter_agg {q}: two calls differ")
            log(f"filter_agg {q} (G={G}, A={A}, {mask.shape[0]} rows): "
                "two calls bit-identical")
            # a count-only call (A = 0) has no index_add_ counterpart
            vm = torch.where(mask[:, None], torch.stack(vals, 1), 0.0) \
                if A else None
            lib_out = torch.zeros((G, A), device=mask.device)
            note("filter_agg", err,
                 nbytes(mask, gidx, *vals) + 4 * G * (A + 1),
                 mask.shape[0], {
                     "ms": lambda: kf.filter_agg(mask, gidx, vals, G),
                     "plain_ms": lambda: kf.filter_agg_plain(mask, gidx,
                                                             vals, G),
                     "library_ms": (lambda: lib_out.index_add_(0, gidx, vm))
                     if A else None})
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
            again = kf.selective_filter_agg(cols, scalars, pred_fn,
                                            value_fns, gidx_fn, G)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"selective_filter_agg {q}: two calls differ")
            n = next(iter(cols.values())).shape[0]
            A = len(value_fns)
            log(f"selective_filter_agg {q} (G={G}, A={A}, {n} rows): two "
                "calls bit-identical")
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

    kc, kf = kmod("compact"), kmod("filter_agg")

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


# a NaN in a row the mask drops (row 4), an infinity in a kept row of
# group 1 (row 2): the oracle keeps each out of every other group's sum
NF_MASK = [1, 0, 1, 1, 0, 1, 1, 1]
NF_GIDX = [0, 1, 1, 0, 0, 2, 2, 1]
NF_SUMS = [[6.0, 8.0], [float("inf"), 20.0], [22.0, 24.0]]


def nonfinite_cases(dev):
    """(label, G, columns, predicate, values, group index): the eight rows
    after `pad` NaN rows that the mask drops, for G = 3 (register regime)
    and G = 9 (shared-memory regime)."""
    import torch

    from repro_torch.core.expr import Cmp, Col, Const
    from repro_torch.core.operators.fused import GroupIndex, TileFn

    cases = []
    for pad in (0, 4093):
        vals = torch.arange(16, dtype=torch.float32).reshape(8, 2)
        vals[4, 1], vals[2, 0] = float("nan"), float("inf")
        vals = torch.cat([torch.full((pad, 2), float("nan")), vals])
        cols = {"m": torch.tensor([0] * pad + NF_MASK, dtype=torch.int32),
                "g": torch.tensor([0] * pad + NF_GIDX, dtype=torch.int32),
                "v0": vals[:, 0].contiguous(), "v1": vals[:, 1].contiguous()}
        cols = {k: v.to(dev) for k, v in cols.items()}
        for G in (3, 9):
            cases.append((f"pad {pad}, G={G}", G, cols,
                          TileFn(Cmp("==", Col("m"), Const(1)), []),
                          [TileFn(Col("v0"), []), TileFn(Col("v1"), [])],
                          GroupIndex([("g", G, 1)], G)))
    return cases


def nonfinite_checks(dev) -> None:
    """filter_agg and the generated selective kernel on the non-finite
    rows: sums bit for bit equal to the plain version on the same device
    and to the oracle's, counts exact."""
    import torch

    kf = kmod("filter_agg")
    want3 = torch.tensor(NF_SUMS, dtype=torch.float32)
    for label, G, cols, pred, vfns, gfn in nonfinite_cases(dev):
        mask = cols["m"] == 1
        vals = [cols["v0"], cols["v1"]]
        want = torch.zeros((G, 2), dtype=torch.float32)
        want[:3] = want3
        for what, got, plain in [
                ("filter_agg", kf.filter_agg(mask, cols["g"], vals, G),
                 kf.filter_agg_plain(mask, cols["g"], vals, G)),
                ("selective_filter_agg",
                 kf.selective_filter_agg(cols, [], pred, vfns, gfn, G),
                 kf.selective_filter_agg_plain(cols, [], pred, vfns, gfn,
                                               G))]:
            bits = got[0].view(torch.int32)
            check(torch.equal(bits, plain[0].view(torch.int32))
                  and torch.equal(bits.cpu(), want.view(torch.int32))
                  and torch.equal(got[1], plain[1]),
                  f"{what} non-finite {label}: sums differ")
    log("non-finite rows: filter_agg and the selective kernel equal the "
        "plain version and the oracle bit for bit (G = 3 and 9)")


def tile_predicate():
    """(predicate, its parameter names) of the many-tile compact_pred
    check: `x < t` over one float32 column, so t sets the density."""
    from repro_torch.core.expr import Cmp, Col, Param
    from repro_torch.core.operators.fused import TileFn

    return TileFn(Cmp("<", Col("x"), Param("t", "float32")), ["t"])


def many_tile_checks(dev) -> dict:
    """The look-back scan under many tiles: 2^22 + 37 rows (1,025 tiles of
    4,096; 2^16 + 37 in a CPU rehearsal) at densities 0, 0.5 and 1,
    capacity below and above the count, with and without translate, each
    call repeated 20 times against one plain answer, for the mask
    (`compact`) and for a predicate evaluated inside the scan
    (`compact_pred`, `x < t` over uniform x in [0, 1)).  Returns the max
    error per kernel (0: every repeat exact)."""
    import torch

    kc = kmod("compact")
    g = torch.Generator().manual_seed(1)
    n = (1 << 22) + 37 if dev.type == "cuda" else (1 << 16) + 37
    reps = 20 if dev.type == "cuda" else 1
    pred = tile_predicate()
    x = {"x": torch.rand(n, generator=g).to(dev)}
    errs = {"compact": 0.0, "compact_pred": 0.0}
    for p in (0.0, 0.5, 1.0):
        mask = (torch.rand(n, generator=g) < p).to(dev)
        cases = [("compact", mask, lambda cap, tr: kc.compact(
                      mask, cap, translate=tr),
                  lambda cap, tr: kc.compact_plain(mask, cap, tr)),
                 ("compact_pred", x["x"] < p, lambda cap, tr: kc.compact_pred(
                      x, [p], pred, cap, translate=tr),
                  lambda cap, tr: kc.compact_pred_plain(x, [p], pred, cap,
                                                        tr))]
        for name, m, kernel, plain in cases:
            count = int(m.sum())
            for cap in (max(count // 3, 1), count + 5):
                for tr in (False, True):
                    want = plain(cap, tr)
                    for r in range(reps):
                        errs[name] = max(errs[name], max_err(
                            kernel(cap, tr), want, f"{name} many tiles "
                            f"p={p} cap={cap} tr={tr} #{r}"))
    log(f"compaction and predicate compaction under "
        f"{-(-n // kc.TILE_ROWS)} tiles: every repeat equal to the plain "
        "version")
    return errs


def selective_repeat_checks(records, dev) -> float:
    """The selective kernel's fold, 20 calls back to back at 1, 37 and all
    of q6's rows (908,340 at SF 1), each against the plain version and
    bit-identical to the first: the last block of each launch sets the
    stream's ticket back to 0 for the next.  Returns the max error."""
    import torch

    kf = kmod("filter_agg")
    cols, sc, pred, vfns, gfn, G = next(
        to(dev, a) for q, e, a, _k in records
        if (q, e) == ("q6", "selective_agg_query"))
    n6 = next(iter(cols.values())).shape[0]
    err = 0.0
    for n in (1, 37, n6):
        sub = {k: v[:n].contiguous() for k, v in cols.items()}
        want = kf.selective_filter_agg_plain(sub, sc, pred, vfns, gfn, G)
        calls = [kf.selective_filter_agg(sub, sc, pred, vfns, gfn, G)
                 for _ in range(20)]
        for k, got in enumerate(calls):
            err = max(err, max_err(got, want, f"selective q6 {n} rows #{k}"))
            check(all(torch.equal(a, b) for a, b in zip(got, calls[0])),
                  f"selective q6 {n} rows: call {k} differs from call 0")
    log(f"selective kernel at 1, 37 and {n6} rows: 20 calls back to back, "
        "each equal to the plain version, all bit-identical")
    return err


def wide_agg_plan():
    """17 sums beside one group key: more value columns than one
    aggregation launch takes (16)."""
    from repro_torch.core import ir
    from repro_torch.core.expr import col

    return ir.Agg(ir.Scan("lineitem"), ["l_returnflag"],
                  [ir.AggSpec(f"s{k}", "sum", col("l_quantity"))
                   for k in range(17)])


def repair_checks(db, dev) -> float:
    """The shapes one aggregation launch cannot take, which the wrappers
    split by value columns: the 17-sum plan through the engine at
    opt-pallas against the port's CPU answer (G = 3, A = 17: two
    launches), and a dense G = 4096, A = 14 call (4096 x 15 x 4 B
    exceed one block's shared memory: two launches) against the plain
    version.  Returns the max error of the direct call."""
    import torch

    from repro_torch.core import CompiledQuery, preset

    kf = kmod("filter_agg")
    want = CompiledQuery(wide_agg_plan(), db, preset("opt-pallas"),
                         device="cpu").run()
    before = kf.launches["filter_agg"]
    got = CompiledQuery(wide_agg_plan(), db, preset("opt-pallas"),
                        device=None if dev.type == "cuda" else "cpu").run()
    assert_same(got, want, False, "17 sums by l_returnflag")
    if dev.type == "cuda":
        check(kf.launches["filter_agg"] == before + 2,
              "17 sums: not two launches")
    g = torch.Generator().manual_seed(4)
    n, G, A = 1 << 20, 4096, 14
    mask = (torch.rand(n, generator=g) < 0.7).to(dev)
    gidx = torch.randint(-1, G + 1, (n,), generator=g,
                         dtype=torch.int32).to(dev)
    vals = [torch.randn(n, generator=g).to(dev) for _ in range(A)]
    before = kf.launches["filter_agg"]
    err = max_err(kf.filter_agg(mask, gidx, vals, G),
                  kf.filter_agg_plain(mask, gidx, vals, G),
                  "filter_agg G=4096 A=14")
    if dev.type == "cuda":
        check(kf.launches["filter_agg"] == before + 2,
              "G=4096 A=14: not two launches")
    log("17 sums by l_returnflag (engine, opt-pallas) and G=4096 x A=14: "
        "equal to the CPU answer and the plain version, two launches each")
    return err


def one_kernel_a_call(name: str, fn, memsets: int) -> dict:
    """`profile_call(fn)` of a window in which every call was one kernel
    and `memsets` memsets, or fail.  A window that lost events shows
    fewer, never more, so a second and third window are taken before a
    shortfall fails."""
    for _ in range(3):
        p = profile_call(fn)
        check(p["kernels_per_call"] <= 1 and p["memsets_per_call"] <= memsets,
              f"{name}: {p['kernels_per_call']} kernels, "
              f"{p['memsets_per_call']} memsets a call")
        if p["kernels_per_call"] == 1 and p["memsets_per_call"] == memsets:
            log(f"{name}: one kernel and {memsets} memsets a call")
            return p
    check(False, f"{name}: {p['kernels_per_call']} kernels a call")


# ---------------------------------------------------------------------------
# phase 4c: the batched instances (the bind-many pass)
# ---------------------------------------------------------------------------

# name -> (kernel module, packed batched form its custom op's vmap rule
# calls, the public batched form, its batched plain version, the scalar
# kernel of one binding, the scalar form's launch counter)
BATCHED = {
    "compact_batched": ("compact", "compact_batched_packed",
                        "compact_batched", "compact_batched_plain",
                        "compact"),
    "compact_pred_batched": ("compact", "compact_pred_batched_packed",
                             "compact_pred_batched",
                             "compact_pred_batched_plain", "compact_pred"),
    "filter_agg_batched": ("filter_agg", "filter_agg_batched_packed",
                           "filter_agg_batched", "filter_agg_batched_plain",
                           "filter_agg"),
    "selective_filter_agg_batched": (
        "filter_agg", "selective_filter_agg_batched_packed",
        "selective_filter_agg_batched", "selective_filter_agg_batched_plain",
        "selective_filter_agg"),
}
# the batched pass's launches, by the scalar kernel they count against in
# LAUNCHES_SF1_PARAM
BATCHED_OF = {name: spec[4] for name, spec in BATCHED.items()}
# memsets beside the one kernel of a batched call
BATCHED_MEMSETS = {"compact_batched": 1, "compact_pred_batched": 1,
                   "filter_agg_batched": 0, "selective_filter_agg_batched": 0}
BATCH_SIZES = (1, 7, 64)         # phase 4c's bindings a call
BATCH_TIMED = 64                 # and the timed one
RUN_MANY_SIZES = (1, 2, 3, 4, 16, 64)  # phase 7 (b)'s bindings a call


def batched_records(db):
    """Every batched kernel call of a two-binding batched pass
    (`run_batched` of the default and the alternative bindings) of each
    parameterized plan at
    opt-pallas on the CPU, as (query, name, args, kwargs): the SF 1
    operands with the pattern of batched (two rows) and shared operands
    that vmap gives the engine's custom operators."""
    from repro_torch.core import PlanCache, preset
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)

    calls, current = [], [None]
    saved = {}
    for name, (mod, packed, *_r) in BATCHED.items():
        m = kmod(mod)
        real = saved[name] = getattr(m, packed)

        def rec(*a, _real=real, _name=name, **k):
            calls.append((current[0], _name, a, k))
            return _real(*a, **k)
        setattr(m, packed, rec)
    cache = PlanCache(db, device="cpu")
    try:
        for q in sorted(PARAM_QUERIES):
            current[0] = q
            b = param_bindings(PARAM_QUERIES, PARAM_ALT_BINDINGS, q)
            cq, _rt = cache.get(PARAM_QUERIES[q][0](), preset("opt-pallas"),
                                b["default"])
            cq.run_batched([{k: v[k] for k in cq.param_spec}
                            for v in (b["default"], b["alt"])])
    finally:
        for name, (mod, packed, *_r) in BATCHED.items():
            setattr(kmod(mod), packed, saved[name])
        cache.close()
    return calls


def widen(x, B: int):
    """`x` with every batched operand (two bindings in front) cycled to B
    bindings; shared operands stay one copy.  An operand is batched when
    it has one dimension more than one binding's: columns, masks and
    group indexes are 1-D a binding, parameter vectors too."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.ndim == 2:
            return x[torch.arange(B, device=x.device) % x.shape[0]] \
                .contiguous()
        return x
    if isinstance(x, dict):
        return {k: widen(v, B) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(widen(v, B) for v in x)
    return x


def _binding_args(name: str, a, b: int):
    """The scalar kernel's arguments for binding b of a batched call."""
    kc = kmod("compact")
    one = (lambda t: kc.binding(t, b, 1))
    if name == "compact_batched":
        mask, cap, tr = a
        return (one(mask), cap), {"translate": tr}
    if name == "filter_agg_batched":
        mask, gidx, vals, G = a
        return (one(mask), one(gidx), [one(v) for v in vals], G), {}
    cols, fp, ip, kinds, pred, *rest = a
    cols = {k: one(v) for k, v in cols.items()}
    sc = kc.binding_scalars(fp, ip, kinds, b)
    if name == "compact_pred_batched":
        cap, tr = rest
        return (cols, sc, pred, cap), {"translate": tr}
    return (cols, sc, pred, *rest), {}


def _batched_bytes(name: str, a, out) -> int:
    """The bytes a batched call must move: every operand read once (a
    shared one once for all bindings, a batched one B times: its B rows)
    and every output written once."""
    import torch

    def walk(x):
        if isinstance(x, torch.Tensor):
            return nbytes(x)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0

    return walk(a) + walk(out)


def batched_library_call(name: str, a):
    """One PyTorch call that computes a batched instance's function on
    its operands, its inputs prepared outside it, or None: for the
    compaction `torch.nonzero` of the (B, n) masks (every binding's ids
    in order, as (binding, row) pairs), for the aggregation one
    `index_add_` of the masked values into a (B x G, A) table at index
    b x G + gidx (the scalar row's `index_add_`, every binding at once).
    The generated instances' predicates are no one call."""
    import torch

    if name == "compact_batched":
        mask = a[0]
        return lambda: torch.nonzero(mask)
    if name != "filter_agg_batched" or not a[2]:
        return None
    mask, gidx, vals, G = a
    B = batch_of(a)
    rows = (lambda t: t.expand(B, -1) if t.ndim == 1 else t)
    vm = torch.where(rows(mask)[..., None],
                     torch.stack([rows(v) for v in vals], -1), 0.0) \
        .reshape(-1, len(vals))
    at = (rows(gidx) + G * torch.arange(B, dtype=torch.int32,
                                        device=gidx.device)[:, None]) \
        .reshape(-1)
    out = torch.zeros((B * G, len(vals)), device=mask.device)
    return lambda: out.index_add_(0, at, vm)


def batch_of(a) -> int:
    """B of a batched call's arguments: the leading extent of its first
    batched (2-D) operand."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.shape[0] if a.ndim == 2 else 0
    if isinstance(a, dict):
        a = list(a.values())
    if isinstance(a, (list, tuple)):
        return max([batch_of(x) for x in a] + [0])
    return 0


def batched_checks(brecords, dev, timed: bool) -> dict:
    """Each batched instance at the recorded SF 1 operands, widened to B =
    1, 7 and 64 bindings: against its batched plain version (ints exact,
    floats within KERNEL_TOL), slot b bit for bit the scalar kernel's
    output on binding b, one kernel a call (with its one memset for the
    compactions); at B = 64 the largest call of each is timed (kernel,
    plain version, `batched_library_call`, device profile, host clock)
    beside its bound.  Returns one entry per batched instance."""
    import torch

    out: dict = {}
    for q, name, a, k in brecords:
        mod, _packed, public, plain, scalar = BATCHED[name]
        m = kmod(mod)
        a = to(dev, a)
        for B in BATCH_SIZES:
            wa = widen(a, B)
            got = getattr(m, public)(*wa, **k)
            want = getattr(m, plain)(*wa, **k)
            e = out.setdefault(name, {"max_abs_err": 0.0, "n": -1,
                                      "calls": 0})
            e["max_abs_err"] = max(e["max_abs_err"], max_err(
                got, want, f"{name} {q} B={B}"))
            e["calls"] += 1
            if dev.type == "cuda":
                for b in range(B):
                    sa, sk = _binding_args(name, wa, b)
                    one = getattr(m, scalar)(*sa, **sk)
                    check(all(torch.equal(g[b], w)
                              for g, w in zip(got, one)),
                          f"{name} {q} B={B}: slot {b} differs from the "
                          "scalar kernel's output bit for bit")
            n = next(t for t in (wa[0].values() if isinstance(wa[0], dict)
                                 else [wa[0]])).shape[-1]
            if B != BATCH_TIMED or n <= e["n"]:
                continue
            e.update(n=n, B=B, query=q, bytes=_batched_bytes(name, wa, got))
            if not timed:
                continue
            fn = (lambda wa=wa, f=getattr(m, public): f(*wa, **k))
            lib = batched_library_call(name, wa)
            e.update(ms=time_ms(fn),
                     plain_ms=time_ms(lambda wa=wa, f=getattr(m, plain):
                                      f(*wa, **k), reps=3, inner=1),
                     library_ms=time_ms(lib, reps=3, inner=1)
                     if lib is not None else None,
                     host_ms=host_ms(fn),
                     **one_launch_a_call(name, fn, BATCHED_MEMSETS[name]))
            del lib
            log(f"{name} {q} at B={B} x {n} rows: {e['ms']} ms "
                f"({e['ms'] / B} a binding), device {e['device_ms']} ms, "
                f"host {e['host_ms']} ms, bound "
                f"{e['bytes'] / HBM_BYTES_PER_S * 1e3} ms")
    missing = sorted(set(BATCHED) - set(out))
    check(not missing, f"no recorded call of {missing}")
    log(f"batched instances at B = {', '.join(map(str, BATCH_SIZES))}: "
        "equal to the batched plain versions"
        + (", every slot the scalar kernel's bit for bit"
           if dev.type == "cuda" else ""))
    return out


def batched_race_checks(dev) -> float:
    """The batched look-back scan under many tiles a binding: 2^22 + 37
    rows (2^16 + 37 in a CPU rehearsal), B = 8 masks at densities 0 to 1,
    capacity a third of the densest count, with translate, 20 calls each
    against one plain answer.  Returns the max error."""
    import torch

    kc = kmod("compact")
    g = torch.Generator().manual_seed(2)
    n = (1 << 22) + 37 if dev.type == "cuda" else (1 << 16) + 37
    reps = 20 if dev.type == "cuda" else 1
    dens = torch.linspace(0.0, 1.0, 8)[:, None]
    mask = (torch.rand(8, n, generator=g) < dens).to(dev)
    cap = max(n // 3, 1)
    want = kc.compact_batched_plain(mask, cap, True)
    err = 0.0
    for r in range(reps):
        err = max(err, max_err(kc.compact_batched(mask, cap, translate=True),
                               want, f"compact_batched many tiles #{r}"))
    log(f"batched compaction, 8 bindings of {n} rows "
        f"({-(-n // kc.TILE_ROWS)} tiles each): {reps} calls equal to the "
        "plain version")
    return err


def one_launch_a_call(name: str, fn, memsets: int) -> dict:
    """`profile_call(fn)` of calls that each made one kernel launch and
    `memsets` memsets, counted in the host's runtime calls, or fail.  On
    the device a window must record some kernel and no more kernels or
    memsets than that; a window that recorded fewer than every call's is
    taken again, up to three windows, and logs when each launch was made
    and each recorded kernel began.  If every window lost events, the
    last one's device time stands as recorded, flagged
    `device_events_lost`."""
    for _ in range(3):
        p = profile_call(fn, times=True)
        times = {k: p.pop(k) for k in ("launch_us", "kernel_us")}
        check(p["api_launches_per_call"] == 1
              and p["api_memsets_per_call"] == memsets,
              f"{name}: {p['api_launches_per_call']} launches, "
              f"{p['api_memsets_per_call']} memsets a call")
        check(0 < p["kernels_per_call"] <= 1
              and p["memsets_per_call"] <= memsets,
              f"{name}: {p['kernels_per_call']} kernels, "
              f"{p['memsets_per_call']} memsets a call on the device")
        p["device_events_lost"] = (p["kernels_per_call"] < 1
                                   or p["memsets_per_call"] < memsets)
        if not p["device_events_lost"]:
            log(f"{name}: one kernel and {memsets} memsets a call")
            return p
        log(f"{name}: the profiler recorded {p['kernels_per_call']} "
            f"kernels and {p['memsets_per_call']} memsets a call; launch "
            f"calls at {times['launch_us']} µs, kernels began at "
            f"{times['kernel_us']} µs")
    log(f"{name}: one launch a call; device time as recorded, with events "
        "lost")
    return p


# ---------------------------------------------------------------------------
# phase 4b: the kernel library's surface
# ---------------------------------------------------------------------------

def subnormal_operands(db, dev):
    """(cols, predicate, values) of the subnormal edge check:
    `l_discount < 1.1754944e-39f` over lineitem, summing l_extendedprice.
    TPC-H discounts of 0.00 satisfy it; a flush to zero would drop them."""
    import torch

    from repro_torch.core.expr import Cmp, Col, Const
    from repro_torch.core.operators.fused import TileFn

    li = db.table("lineitem")
    cols = {c: torch.from_numpy(li.col(c)).to(dev)
            for c in ("l_discount", "l_extendedprice")}
    return (cols, TileFn(Cmp("<", Col("l_discount"), Const(SUBNORMAL)), []),
            [TileFn(Col("l_extendedprice"), [])])


# float32 bit patterns the order must place: +-0, +-NaN (with payloads,
# quiet and signalling), +-inf, +-subnormals, -3e38 and its neighbours
SPECIAL_BITS = [0x00000000, 0x80000000, 0x7fc00000, 0xffc00000, 0x7fc00001,
                0xffc00005, 0x7f800001, 0xff800001, 0x7f800000, 0xff800000,
                0x00000001, 0x80000001, 0x007fffff, 0x807fffff, 0xff61b1e6,
                0xff61b1e5, 0xff61b1e7]


def special_topk_cases(rng, dev_t):
    """(vals, mask, k, label): 40,000 rows (ten 4,096-row tiles), a third
    of them special values scattered among repeated ordinary ones, at
    k = 1, 10 and 1,024, with a random mask, every row masked, every
    value equal; and k > n."""
    import numpy as np

    n = 40_000
    vals = rng.choice(np.float32([-2.5, 0.5, 1.0, 3e38, -1.0]), n)
    at = rng.random(n) < 0.35
    vals[at] = rng.choice(np.array(SPECIAL_BITS, np.uint32),
                          int(at.sum())).view(np.float32)
    mask = rng.random(n) < 0.8
    cases = []
    for k in (1, 10, 1024):
        cases += [(dev_t(vals), dev_t(mask), k, f"scattered, k={k}"),
                  (dev_t(vals), dev_t(np.zeros(n, bool)), k,
                   f"all masked, k={k}"),
                  (dev_t(np.full(n, np.float32(0.5))), dev_t(mask), k,
                   f"all equal, k={k}")]
    cases.append((dev_t(vals[:700]), dev_t(mask[:700]), 1024,
                  "k > n (700 rows, k=1024)"))
    return cases


def same_bits(got, want, what: str) -> float:
    """Top-k outputs equal bit for bit (NaN payloads included)."""
    import torch

    check(torch.equal(got[1], want[1]), f"{what}: ids differ")
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
          f"{what}: value bits differ")
    return 0.0


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def library_phase(db, records, dev, subnormal, timed: bool):
    """Drive `repro_torch.kernels` once at SF 1 shapes between a reset and
    a read of the library kernels' launch counters, then hold every output
    and edge case against the plain versions and time each shape.
    Returns ({library kernel: entry}, {engine kernel: max error})."""
    import numpy as np
    import torch

    import repro_torch.kernels as lib
    from repro_torch.relational.schema import days

    kc, kf = kmod("compact"), kmod("filter_agg")
    kg, kt = kmod("gather_join"), kmod("topk")
    rng = np.random.default_rng(0)
    li = db.table("lineitem")

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(k, c):
        return dev_t(rng.normal(size=(k, c)).astype(np.float32))

    # -- inputs ------------------------------------------------------------
    gathers = {
        "c_nationkey into 25x3": (
            dev_t(db.table("customer").col("c_nationkey")), table(25, 3)),
        "l_suppkey into supplier x 3": (
            dev_t(li.col("l_suppkey")), table(db.table("supplier").nrows, 3)),
        "l_partkey into part x 2": (
            dev_t(li.col("l_partkey")), table(db.table("part").nrows, 2)),
    }
    price = dev_t(li.col("l_extendedprice"))
    q3_mask = dev_t(li.col("l_shipdate") > days("1995-03-15"))
    n_perm = 60_000
    topks = {f"l_extendedprice under q3's mask, k={k}": (price, q3_mask, k)
             for k in (1, 10, 100)}
    topks["distinct 60,000, k=10"] = (
        dev_t(rng.permutation(n_perm).astype(np.float32)),
        dev_t(rng.random(n_perm) < 0.5), 10)
    rec = {}
    for q, e, a, _k in records:     # the largest call of each (query, entry)
        a = to(dev, a)
        n = a[0].shape[0] if isinstance(a[0], torch.Tensor) \
            else next(iter(a[0].values())).shape[0]
        if (q, e) not in rec or n > rec[q, e][0]:
            rec[q, e] = (n, a)
    cols, scalars, pred, vfns, gfn, G = rec["q6", "selective_agg_query"][1]
    total = int(kf.selective_filter_agg_plain(cols, scalars, pred, vfns, gfn,
                                              G)[2])
    check(total > 1, f"q6 selects {total} rows")
    sels = {f"q6, capacity {cap}{', translate' if tr else ''}": (cap, tr)
            for cap in (pow2_at_least(total), total // 2)
            for tr in (False, True)}
    mask1, gidx1, vals1, G1 = rec["q1", "filter_agg_query"][1]
    gidx1, vals1 = gidx1.to(torch.int32), [v.to(torch.float32) for v in vals1]
    mask3, cap3 = rec["q3", "compact_query"][1]

    # -- the surface, once, between reset and read of the counters ---------
    counters = {"gather_join": kg.launches, "masked_topk": kt.launches,
                "selective_filter_agg_capacity": kf.launches}
    for name, d in counters.items():
        d[name] = 0
    got_g = {s: lib.gather_join(fk, t) for s, (fk, t) in gathers.items()}
    got_t = {s: lib.masked_topk(v, m, k) for s, (v, m, k) in topks.items()}
    got_s = {s: lib.selective_filter_agg(cols, scalars, pred, vfns, gfn,
                                         len(vfns), G, cap, tr)
             for s, (cap, tr) in sels.items()}
    got_fa = lib.filter_agg(mask1, gidx1, torch.stack(vals1, 1), G1)
    got_ct = lib.compact_translate(mask3, cap3)
    launched = {name: d[name] for name, d in counters.items()}
    log(f"library surface launches: {json.dumps(launched)}")

    # -- outputs against the plain versions --------------------------------
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for s, (fk, t) in gathers.items():
        note("gather_join", max_err([got_g[s]], [kg.gather_join_plain(fk, t)],
                                    f"gather_join {s}", exact=True))
    for s, (v, m, k) in topks.items():
        note("masked_topk", max_err(got_t[s], kt.masked_topk_plain(v, m, k),
                                    f"masked_topk {s}", exact=True))
    base = kf.selective_filter_agg(cols, scalars, pred, vfns, gfn, G)
    for s, (cap, tr) in sels.items():
        want = kf.selective_filter_agg_plain(cols, scalars, pred, vfns, gfn,
                                             G, cap, tr)
        note("selective_filter_agg_capacity", max_err(
            got_s[s], (want[0], *want[2:]), f"selective {s}"))
        max_err(got_s[s][:1], base[:1], f"selective {s} vs capacity 0")
        log(f"selective {s}: count {int(got_s[s][1])}, sums bitwise equal "
            f"to the capacity-0 form: {torch.equal(got_s[s][0], base[0])}")
    note("filter_agg", max_err(
        [got_fa], [kf.filter_agg_plain(mask1, gidx1, vals1, G1)[0]],
        "filter_agg matrix q1"))
    note("compact", max_err(got_ct, kc.compact_plain(mask3, cap3, True),
                            "compact_translate q3"))

    # -- the subnormal literal ---------------------------------------------
    s_cols, s_pred, s_vals = subnormal
    s_true = int(s_pred(s_cols, []).sum())
    check(s_true > 0, "no row satisfies the subnormal predicate")
    cap = pow2_at_least(s_true)
    note("compact_pred", max_err(
        kc.compact_pred(s_cols, [], s_pred, cap, translate=True),
        kc.compact_pred_plain(s_cols, [], s_pred, cap, True),
        "compact_pred subnormal"))
    want = kf.selective_filter_agg_plain(s_cols, [], s_pred, s_vals, None, 1,
                                         cap, True)
    note("selective_filter_agg", max_err(
        kf.selective_filter_agg(s_cols, [], s_pred, s_vals, None, 1),
        want[:3], "selective subnormal"))
    note("selective_filter_agg_capacity", max_err(
        kf.selective_filter_agg(s_cols, [], s_pred, s_vals, None, 1,
                                capacity=cap, translate=True),
        want, "selective capacity subnormal"))
    log(f"subnormal literal: {s_true} rows kept by kernel and plain version")

    # -- edges -------------------------------------------------------------
    smem_rows = 227 * 1024 // 4        # one block's shared memory, C = 1
    for t in (gathers["c_nationkey into 25x3"][1],
              gathers["l_partkey into part x 2"][1],
              table(smem_rows, 1), table(smem_rows + 1, 1)):
        k = t.shape[0]
        for fk in ([-1], [k], rng.integers(0, k, 1),
                   rng.integers(-2, k + 2, 37), rng.integers(-2, k + 2, 5000)):
            fk = dev_t(np.asarray(fk, np.int32))
            note("gather_join", max_err(
                [lib.gather_join(fk, t)], [kg.gather_join_plain(fk, t)],
                f"gather_join edge K={k} n={fk.shape[0]}", exact=True))
    for c in (1, 2, 3, 5):
        k, n = 1000, 4 * 5000 + 3
        fk = dev_t(rng.integers(-2, k + 2, n + 1).astype(np.int32))[1:]
        t = rng.normal(size=(k, c)).astype(np.float32)
        t[1, 0], t[2, c - 1] = np.nan, np.inf
        t = dev_t(t)
        check(torch.equal(lib.gather_join(fk, t).view(torch.int32),
                          kg.gather_join_plain(fk, t).view(torch.int32)),
              f"gather_join C={c}, fk at an odd offset: differs")
    log("gather_join at C = 1, 2, 3, 5, fk a view at an odd offset, NaN "
        "and infinity in the table: bit for bit")
    ties = dev_t(np.full(3 * 4096 + 1, 7.0, np.float32))
    odd = dev_t(rng.choice(np.float32([-np.inf, 1.0, -3.0e38, 2.0]), 10_000))
    few = dev_t(rng.permutation(1000) < 5)
    for v, m, k, what in [
            (price[:1000], few, 100, "fewer valid rows than k"),
            (price[:5000], torch.zeros_like(q3_mask[:5000]), 10,
             "no valid row"),
            (price[:37], q3_mask[:37], 100, "k > n"),
            (price[:1], q3_mask[:1], 1, "n = 1"),
            (price, q3_mask, 1024, "q3, k = 1024"),
            (ties, torch.ones_like(ties, dtype=torch.bool), 1024,
             "equal values across blocks"),
            (odd, dev_t(rng.random(10_000) < 0.8), 1024,
             "-inf and -3e38 among the values")]:
        note("masked_topk", max_err(lib.masked_topk(v, m, k),
                                    kt.masked_topk_plain(v, m, k),
                                    f"masked_topk edge {what}", exact=True))
    for v, m, k, what in special_topk_cases(rng, dev_t):
        note("masked_topk", same_bits(lib.masked_topk(v, m, k),
                                      kt.masked_topk_plain(v, m, k),
                                      f"masked_topk special {what}"))
    log("masked_topk special values: ids and bit patterns equal to the "
        "plain version at k = 1, 10, 1024")
    for n in (1, 37, 5000):
        sub = {c: v[:n].contiguous() for c, v in cols.items()}
        for cap in (1, 8, 4096):
            for tr in (False, True):
                want = kf.selective_filter_agg_plain(sub, scalars, pred, vfns,
                                                     gfn, G, cap, tr)
                note("selective_filter_agg_capacity", max_err(
                    lib.selective_filter_agg(sub, scalars, pred, vfns, gfn,
                                             len(vfns), G, cap, tr),
                    (want[0], *want[2:]), f"selective edge n={n} cap={cap}"))

    # -- times ---------------------------------------------------------------
    def timing(label, n, nbytes_, kernel, plain, library):
        row = {"shape": label, "rows": n, "bytes": nbytes_,
               "bound_ms": nbytes_ / HBM_BYTES_PER_S * 1e3}
        row.update({k: (time_ms(f) if timed and f is not None else None)
                    for k, f in (("ms", kernel), ("plain_ms", plain),
                                 ("library_ms", library))})
        if timed:
            row.update(profile_call(kernel))
        return row

    timed_rows = {name: [] for name in LIBRARY_KERNELS}
    for s, (fk, t) in gathers.items():
        n, (k, c) = fk.shape[0], t.shape
        timed_rows["gather_join"].append(timing(
            s, n, 4 * n + 4 * k * c + 4 * n * c,
            lambda: lib.gather_join(fk, t),
            lambda: kg.gather_join_plain(fk, t),
            lambda: torch.index_select(t, 0, fk)))
    for s, (v, m, k) in topks.items():
        pre = torch.where(m, v, kt.NEG)
        timed_rows["masked_topk"].append(timing(
            s, v.shape[0], 5 * v.shape[0],
            lambda: lib.masked_topk(v, m, k),
            lambda: kt.masked_topk_plain(v, m, k),
            lambda: torch.topk(pre, k)))
    n6 = next(iter(cols.values())).shape[0]
    for s, (cap, tr) in sels.items():
        timed_rows["selective_filter_agg_capacity"].append(timing(
            s, n6, nbytes(*cols.values()) + 4 * cap + (4 * n6 if tr else 0),
            lambda: lib.selective_filter_agg(cols, scalars, pred, vfns, gfn,
                                             len(vfns), G, cap, tr),
            lambda: kf.selective_filter_agg_plain(cols, scalars, pred, vfns,
                                                  gfn, G, cap, tr),
            None))
    main_shape = {"gather_join": 1, "masked_topk": 1,
                  "selective_filter_agg_capacity": 0}
    out = {}
    for name in LIBRARY_KERNELS:
        for r in timed_rows[name]:
            log(f"{name} {r['shape']}: {json.dumps(r)}")
        main = timed_rows[name][main_shape[name]]
        out[name] = {"max_abs_err": errs[name], "launches": launched[name],
                     "n": main["rows"], "bytes": main["bytes"],
                     "ms": main["ms"], "plain_ms": main["plain_ms"],
                     "library_ms": main["library_ms"],
                     "shape": main["shape"], "timed": timed_rows[name]}
        out[name].update({k: main[k] for k in PROFILED if k in main})
    return out, {k: v for k, v in errs.items() if k in ENGINE_KERNELS}


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(db, queries, answers, counters, args):
    """Every query through `CompiledQuery(...).run()` on the card: at opt
    and opt-pallas against its CPU answer at the same preset, at the lower
    rungs against the CPU answer at opt, and the row layout of
    ROW_QUERIES at ROW_RUNGS likewise.  Checks each run's launches (none
    outside opt-pallas; at opt-pallas exactly LAUNCHES_SF1's) and times
    it: median and minimum of RUNS runs after one warm-up, each `run()`
    (the answer
    decoded on the host) and the device program alone (`execute` and a
    synchronisation).  Each query is freed before the next is built.
    Returns the launches of the whole phase, the card's answers at
    PRESETS (column layout) and their median `run()` ms by (query,
    preset)."""
    import dataclasses

    import torch
    from repro_torch.core import CompiledQuery, preset

    cuda = not args.rehearse
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    configs = [(q, p, "column") for p in PRESETS + LOWER_RUNGS
               for q in queries] \
        + [(q, p, "row") for p in ROW_RUNGS for q in ROW_QUERIES]
    per_rung: dict = {}
    card: dict = {}
    medians: dict = {}
    for q, p, layout in configs:
        t_cfg = time.perf_counter()
        before = {name: d[k] for name, (d, k) in counters.items()}
        cq = CompiledQuery(queries[q](), db,
                           dataclasses.replace(preset(p), layout=layout),
                           device="cpu" if args.rehearse else None)
        got = cq.run()
        want = answers[q, p if p in PRESETS else "opt"]
        what = f"{q} {p}" + (" row" if layout == "row" else "")
        assert_same(got, want, q in SORT_INSENSITIVE, what)
        if p in PRESETS and layout == "column":
            card[q, p] = got
        delta = {name: d[k] - before[name]
                 for name, (d, k) in counters.items() if d[k] > before[name]}
        if cuda and p != "opt-pallas":
            check(not delta, f"{what}: a kernel launched ({delta})")
        if cuda and p == "opt-pallas":
            check(delta == LAUNCHES_SF1[q],
                  f"{what}: launches {delta}, the reference's "
                  f"{LAUNCHES_SF1[q]}")

        def timed(fn):
            fn()
            out = []
            for _ in range(RUNS):
                sync()
                t = time.perf_counter()
                fn()
                sync()
                out.append((time.perf_counter() - t) * 1e3)
            return out

        if cuda:            # a rehearsal checks answers only
            run_ms = timed(cq.run)
            medians[q, p, layout] = statistics.median(run_ms)
            inputs = cq.bind()
            exec_ms = timed(lambda: cq.execute(inputs))
            del inputs
            log(f"query {what}: median {statistics.median(run_ms):.3f} ms "
                f"(min {min(run_ms):.3f}) over {len(run_ms)} runs, device "
                f"program median {statistics.median(exec_ms):.3f} ms "
                f"(min {min(exec_ms):.3f}), overflows {cq.n_overflows}, "
                f"launches {json.dumps(delta)}, inputs "
                f"{cq.input_nbytes()} B, {time.perf_counter() - t_cfg:.1f} s")
        check(cq.n_overflows == 0 or p not in PRESETS,
              f"{what}: {cq.n_overflows} overflows")
        key = p + (" row" if layout == "row" else "")
        per_rung[key] = per_rung.get(key, 0.0) + time.perf_counter() - t_cfg
        del cq
    log("phase 5 seconds by rung: " + json.dumps(
        {k: round(v, 1) for k, v in per_rung.items()}))
    return ({name: d[k] for name, (d, k) in counters.items()}, card,
            {(q, p): ms for (q, p, layout), ms in medians.items()
             if layout == "column"})


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------

def param_bindings(pq, alt, q) -> dict:
    """A parameterized query's two bindings: its defaults (the literal
    query's values) and the alternative overlay."""
    return {"default": dict(pq[q][1]), "alt": dict(pq[q][1], **alt[q])}


def param_answers(db):
    """Every parameterized query under both bindings through a CPU plan
    cache at opt: the serving phase's reference answers."""
    from repro_torch.core import PlanCache, preset
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)

    cache = PlanCache(db, device="cpu")
    out = {}
    for q in sorted(PARAM_QUERIES):
        for name, b in param_bindings(PARAM_QUERIES, PARAM_ALT_BINDINGS,
                                      q).items():
            out[q, name] = cache.execute(PARAM_QUERIES[q][0](),
                                         preset("opt"), b)
    cache.close()
    return out


def overflow_plan():
    """count and sum over `l_quantity < 26` (about half of lineitem)
    squeezed through a hand-planted 64-row compaction point."""
    from repro_torch.core.expr import Cmp, col, lit
    from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select

    sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(26.0)))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def param_overflow_plan():
    """count and sum over `l_quantity < qmax` squeezed through a
    hand-planted 64-row compaction point: a binding's qmax decides
    whether its slot overflows."""
    from repro_torch.core.expr import Cmp, Param, col
    from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select

    sel = Select(Scan("lineitem"),
                 Cmp("<", col("l_quantity"), Param("qmax", "float32")))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def serving_path(db, answers, counters, bcounters, args) -> dict:
    """The runtime and serving layer on the card at opt-pallas: (a) a plan
    cache over the six parameterized queries, default then alternative
    bindings, (b) the batched pass (run_many of 64 bindings a plan, its
    launches read around it) and execute_many, run_many and run at 1, 4,
    16 and 64 bindings, a planted overflow in one slot, (c) a forced
    overflow and its feedback re-plan, (d) the tiered cache, (e) the
    query server, (f) the chaos harness, (g) warm state saved and loaded,
    (h) device memory.  Logs a line of numbers a step; returns the
    batched pass's launches by batched instance."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.core import CompiledQuery, PlanCache, preset
    from repro_torch.core import compile as compile_mod
    from repro_torch.core.passes.compaction import observed_bucket
    from repro_torch.kernels import build
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)
    from repro_torch.serve.chaos import run_chaos
    from repro_torch.serve.query_server import QueryServer

    cuda = not args.rehearse
    device = "cpu" if args.rehearse else None
    S = preset("opt-pallas")
    shapes = sorted(PARAM_QUERIES)
    binds = {q: param_bindings(PARAM_QUERIES, PARAM_ALT_BINDINGS, q)
             for q in shapes}
    plan = {q: PARAM_QUERIES[q][0] for q in shapes}
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    report: dict = {}

    def launched(before):
        return {n: d[k] - before[n] for n, (d, k) in counters.items()
                if d[k] > before[n]}

    def snapshot():
        return {n: d[k] for n, (d, k) in counters.items()}

    def ms_since(t):
        return (time.perf_counter() - t) * 1e3

    # -- (a) the plan cache: one staging per shape, no build on rebind ----
    cache = PlanCache(db, device=device)
    for q in shapes:
        s0, libs0 = compile_mod.STAGINGS, len(build._LIBS)
        t = time.perf_counter()
        cq, _rt = cache.get(plan[q](), S, binds[q]["default"])
        stage_ms = ms_since(t)
        t = time.perf_counter()
        cq.compile()
        compile_ms = ms_since(t)
        libs_built = len(build._LIBS) - libs0
        before = snapshot()
        t = time.perf_counter()
        got = cache.execute(plan[q](), S, binds[q]["default"])
        first_ms = ms_since(t)
        delta = {"default": launched(before)}
        assert_same(got, answers[q, "default"], q in SORT_INSENSITIVE,
                    f"serve {q} default")
        libs1 = len(build._LIBS)
        before = snapshot()
        t = time.perf_counter()
        got = cache.execute(plan[q](), S, binds[q]["alt"])
        alt_ms = ms_since(t)
        delta["alt"] = launched(before)
        assert_same(got, answers[q, "alt"], q in SORT_INSENSITIVE,
                    f"serve {q} alt")
        check(compile_mod.STAGINGS - s0 == 1,
              f"{q}: {compile_mod.STAGINGS - s0} stagings for two bindings")
        check(len(build._LIBS) == libs1, f"{q}: the rebind built a library")
        check(cq.n_overflows == 0, f"{q}: {cq.n_overflows} overflows")
        if cuda:
            for name, d in delta.items():
                check(d == LAUNCHES_SF1_PARAM[q],
                      f"serve {q} {name}: launches {d}, the reference's "
                      f"{LAUNCHES_SF1_PARAM[q]}")
        del cq
        cache.execute(plan[q](), S, binds[q]["default"])
        warm = []
        for _ in range(RUNS):
            t = time.perf_counter()
            cache.execute(plan[q](), S, binds[q]["default"])
            warm.append(ms_since(t))
        report[q] = {"stage_ms": stage_ms, "compile_ms": compile_ms,
                     "libraries_built": libs_built, "first_run_ms": first_ms,
                     "cold_ms": stage_ms + compile_ms + first_ms,
                     "alt_ms": alt_ms,
                     "warm_median_ms": statistics.median(warm),
                     "warm_min_ms": min(warm), "launches": delta}
        log(f"serve {q}: " + json.dumps(report[q]))
    # a specialized binding is new source: it pays nvcc again
    libs0 = len(build._LIBS)
    t = time.perf_counter()
    got = cache.execute(plan["q6"](), S, binds["q6"]["alt"],
                        mode="specialize")
    report["q6 specialize"] = {"cold_ms": ms_since(t),
                               "libraries_built": len(build._LIBS) - libs0}
    assert_same(got, answers["q6", "alt"], False, "serve q6 specialize")
    if cuda:
        check(report["q6 specialize"]["libraries_built"] == 1,
              "a specialized binding of q6 built no library")
    log("serve q6 specialize: " + json.dumps(report["q6 specialize"]))
    log(f"plan cache: {cache.stats}")

    # -- (b) the batched pass: run_many of 64 bindings a plan ---------------
    # each plan's 64 bindings (default and alternative in turn) as one
    # batched pass, the launch counters set to 0 before the six passes and
    # read after them: every call site one launch for all 64 bindings
    def least_ms(fn, reps=3):
        best = None
        for _ in range(reps):
            t = time.perf_counter()
            got = fn()
            ms = ms_since(t)
            best = ms if best is None else min(best, ms)
        return best, got

    big = max(RUN_MANY_SIZES)
    entries, passes = {}, {}
    if cuda:
        peak_a = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for d, k in bcounters.values():
        d[k] = 0
    for q in shapes:
        cq, _rt = cache.get(plan[q](), S, binds[q]["default"])
        rts = [{k: b[k] for k in cq.param_spec}
               for b in (binds[q]["default"], binds[q]["alt"])]
        before, bbefore = snapshot(), {n: d[k] for n, (d, k)
                                       in bcounters.items()}
        e0, o0 = cq.n_executions, cq.n_overflows
        passes[q] = cq.run_many([rts[i % 2] for i in range(big)])
        got = launched(before)
        for name, (d, k) in bcounters.items():
            if d[k] > bbefore[name]:
                base = BATCHED_OF[name]
                got[base] = got.get(base, 0) + d[k] - bbefore[name]
        check(cq.n_executions - e0 == 1,
              f"run_many {q} x{big}: {cq.n_executions - e0} executions")
        check(cq.n_overflows == o0, f"run_many {q} x{big}: an overflow")
        if cuda:
            check(got == LAUNCHES_SF1_PARAM[q],
                  f"run_many {q} x{big}: launches {got}, one pass of the "
                  f"reference's {LAUNCHES_SF1_PARAM[q]}")
        log(f"run_many {q} x{big}: one execution, launches {got}")
        entries[q] = (cq, rts)
    batched_launched = {n: d[k] for n, (d, k) in bcounters.items()}
    log(f"batched pass launches: {json.dumps(batched_launched)}")
    if cuda:
        report["batched_pass_peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"batched pass ({big} bindings of each plan): peak device "
            f"memory {report['batched_pass_peak_bytes']} bytes")
    if cuda:
        idle = [n for n, v in batched_launched.items() if v == 0]
        check(not idle, f"never launched in the batched pass: {idle}")
    report["batched_launches"] = batched_launched

    # every slot against `run` of its binding (and the CPU's answer), then
    # at each of RUN_MANY_SIZES the executions run_many takes, and ms a
    # binding: the cache's execute_many (keying every binding, then one
    # run_many), the entry's own run_many, one batched pass whatever the
    # number, and n `run` calls, each the least of 3
    for q in shapes:
        cq, rts = entries[q]
        singles = [cq.run(r) for r in rts]
        for i, g in enumerate(passes[q]):
            assert_same(g, singles[i % 2], False, f"run_many {q} {big}[{i}]")
            assert_same(g, answers[q, ("default", "alt")[i % 2]],
                        q in SORT_INSENSITIVE,
                        f"run_many {q} {big}[{i}] against the CPU")
        for n in RUN_MANY_SIZES:
            bl = [(binds[q]["default"], binds[q]["alt"])[i % 2]
                  for i in range(n)]
            rl = [rts[i % 2] for i in range(n)]
            e0 = cq.n_executions
            cq.run_many(rl)
            walks = n < compile_mod.BATCH_MIN
            want_e = n if walks else -(-n // compile_mod.BATCH_MAX)
            check(cq.n_executions - e0 == want_e,
                  f"run_many {q} x{n}: {cq.n_executions - e0} executions, "
                  f"not {want_e}")
            many_ms, many = least_ms(
                lambda: cache.execute_many(plan[q](), S, bl))
            rmany_ms, rmany = least_ms(lambda: cq.run_many(rl))
            pass_ms, one_pass = least_ms(lambda: cq.run_batched(rl))
            runs_ms, _ = least_ms(lambda: [cq.run(r) for r in rl])
            for i, (g, r, p1) in enumerate(zip(many, rmany, one_pass)):
                assert_same(g, singles[i % 2], False,
                            f"execute_many {q} {n}[{i}]")
                assert_same(r, singles[i % 2], False,
                            f"run_many {q} {n}[{i}]")
                assert_same(p1, singles[i % 2], False,
                            f"run_batched {q} {n}[{i}]")
            report[f"{q} execute_many {n}"] = {
                "ms_per_binding": many_ms / n,
                "run_many_ms_per_binding": rmany_ms / n,
                "run_many_takes": "walks" if walks else "passes",
                "pass_ms_per_binding": pass_ms / n,
                "run_ms_per_binding": runs_ms / n}
            log(f"execute_many {q} x{n}: {many_ms / n:.3f} ms a binding, "
                f"run_many {rmany_ms / n:.3f} ("
                + ("scalar walks" if walks else "batched") + "), one pass "
                f"{pass_ms / n:.3f}, {n} runs {runs_ms / n:.3f} ms a "
                "binding (least of 3)")
    del entries, passes

    # a hand-planted 64-row point that one slot of 64 overflows: that slot
    # alone re-runs, through the twin, in one batched pass of its own
    qplan = param_overflow_plan()
    lo = {"qmax": 1.0}                 # l_quantity < 1: no row
    hi = {"qmax": 26.0}                # about half of lineitem
    cq = CompiledQuery(qplan, db, S, params=lo, device=device)
    bl = [hi if i == 17 else lo for i in range(big)]
    got = cq.run_many(bl)
    ref_q = CompiledQuery(param_overflow_plan(), db, preset("opt"),
                          params=lo, device="cpu")
    want = {name: ref_q.run(b) for name, b in (("lo", lo), ("hi", hi))}
    check(cq.n_overflows == 1 and cq.n_executions == 1,
          f"planted overflow: {cq.n_overflows} overflows, "
          f"{cq.n_executions} executions")
    check(cq._fallback is not None and cq._fallback.n_executions == 1,
          "planted overflow: the twin did not run once")
    for i, g in enumerate(got):
        assert_same(g, want["hi" if i == 17 else "lo"], False,
                    f"planted overflow [{i}]")
    check(int(want["hi"]["c"][0]) > 64,
          "planted overflow: the large slot fits")
    log(f"planted overflow in slot 17 of {big}: one overflow, the twin ran "
        f"once, {int(want['hi']['c'][0])} rows there, every slot equal to "
        "the CPU")
    del cq, ref_q

    # -- (c) a forced overflow and the feedback re-plan ---------------------
    s_over = dataclasses.replace(S, compact_replan_after=1)
    want = CompiledQuery(overflow_plan(), db, preset("opt"),
                         device="cpu").run()
    ocache = PlanCache(db, device=device)
    cq0, _ = ocache.get(overflow_plan(), s_over)
    got = ocache.execute(overflow_plan(), s_over)
    assert_same(got, want, False, "overflow: the twin's answer")
    true = int(want["c"][0])
    check(cq0.n_overflows == 1 and true > 64, "overflow: no overflow")
    check(cq0.observed_max.get("h0") == true,
          f"overflow: observed {cq0.observed_max}, true count {true}")
    check(ocache.stats.replans == 1, f"overflow: {ocache.stats}")
    del cq0
    s0 = compile_mod.STAGINGS
    got = ocache.execute(overflow_plan(), s_over)
    cq1, _ = ocache.get(overflow_plan(), s_over)
    check(compile_mod.STAGINGS - s0 == 1, "overflow: the re-plan staged "
          f"{compile_mod.STAGINGS - s0} times")
    check(cq1.n_overflows == 0 and cq1.point_caps["h0"]
          == observed_bucket(true), f"overflow: after the re-plan "
          f"{cq1.point_caps}, {cq1.n_overflows} overflows")
    assert_same(got, want, False, "overflow: the re-planned answer")
    report["overflow"] = {"true_count": true, "capacity": cq1.point_caps}
    log(f"forced overflow: {json.dumps(report['overflow'])}, {ocache.stats}")
    del cq1
    ocache.close()

    # -- (d) the tiered cache: oracle first, then the card ------------------
    tcache = PlanCache(db, tiered=True, device=device)
    for q in ("q6", "q12"):
        b = binds[q]["default"]
        t = time.perf_counter()
        res1, tier1 = tcache.execute_tiered(plan[q](), S, b)
        oracle_ms = ms_since(t)
        check(tier1 == "oracle", f"tiered {q}: request 1 served by {tier1}")
        t = time.perf_counter()
        check(tcache.await_promotion(plan[q](), S, b, timeout=600),
              f"tiered {q}: promotion failed")
        wait_ms = ms_since(t)
        t = time.perf_counter()
        res2, tier2 = tcache.execute_tiered(plan[q](), S, b)
        promoted_ms = ms_since(t)
        check(tier2 == "opt-pallas", f"tiered {q}: then served by {tier2}")
        assert_same(res1, res2, False, f"tiered {q}: oracle vs opt-pallas")
        assert_same(res2, answers[q, "default"], False, f"tiered {q}")
        report[f"{q} tiered"] = {"oracle_ms": oracle_ms,
                                 "promotion_wait_ms": wait_ms,
                                 "promoted_ms": promoted_ms}
        log(f"tiered {q}: " + json.dumps(report[f"{q} tiered"]))
    tcache.close()

    # -- (e) the query server -----------------------------------------------
    reqs = [(q, name) for _ in range(4) for q in shapes
            for name in ("default", "alt")]
    s0 = compile_mod.STAGINGS
    srv = QueryServer(db, S, window_s=3600.0, device=device)
    t = time.perf_counter()
    results = srv.serve_batch([(plan[q](), binds[q][name])
                               for q, name in reqs])
    serve_ms = ms_since(t)
    srv.close()
    st = srv.stats
    for (q, name), got in zip(reqs, results):
        assert_same(got, answers[q, name], q in SORT_INSENSITIVE,
                    f"server {q} {name}")
    check(st.completed == len(reqs) and st.errors == 0
          and st.outstanding() == 0, f"server: {st}")
    check(compile_mod.STAGINGS - s0 == len(shapes),
          f"server: {compile_mod.STAGINGS - s0} stagings for "
          f"{len(shapes)} shapes")
    report["server"] = {"requests": len(reqs), "ms": serve_ms,
                        "batches": st.batches, "coalesced": st.coalesced,
                        "p50_ms": st.latency.p50() * 1e3,
                        "p99_ms": st.latency.p99() * 1e3}
    log("server: " + json.dumps(report["server"]))
    del srv, results

    # -- (f) chaos -------------------------------------------------------------
    t = time.perf_counter()
    rep = run_chaos(db, S, seed=0, n_requests=48, device=device)
    for k in ("all_resolved", "balanced", "retried_ok"):
        check(rep[k], f"chaos: not {k}: {rep}")
    check(rep["oracle_drift"] == 0, f"chaos: drift {rep['oracle_drift']}")
    report["chaos"] = {"injected": rep["injected"],
                       "outcomes": rep["outcomes"], "ms": ms_since(t)}
    log("chaos: " + json.dumps(report["chaos"]))

    # -- (g) warm state ------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="warm-state-")
    try:
        path = f"{tmp}/warm.json"
        n = cache.save(path)
        fresh = PlanCache(db, device=device)
        check(n == len(shapes) + 1 and fresh.load(path) == n,
              f"warm state: {n} records saved")
        check(all(fresh.is_warm(plan[q](), S, binds[q]["default"])
                  for q in shapes), "warm state: a shape is not warm")
        for base, fb in cache._feedback.items():
            got = fresh._feedback[base]
            check((got.observed, got.overrides) == (fb.observed,
                                                    fb.overrides),
                  "warm state: a record changed on the way")
        fresh.close()
    finally:
        shutil.rmtree(tmp)
    cache.close()

    # -- (h) device memory ---------------------------------------------------
    if cuda:
        import gc

        gc.collect()
        torch.cuda.synchronize()
        report["memory"] = {
            "before_bytes": mem_before,
            "peak_bytes": max(peak_a, torch.cuda.max_memory_allocated()),
            "after_close_bytes": torch.cuda.memory_allocated()}
        log("serving memory: " + json.dumps(report["memory"]))
        check(report["memory"]["after_close_bytes"]
              <= mem_before + (64 << 20),
              "closing the caches and servers left device memory held")
    return batched_launched


# ---------------------------------------------------------------------------
# phase 8: the sharded path
# ---------------------------------------------------------------------------

# (preset, shards) of the sharded runs
SHARDED_CONFIGS = [("opt", 2), ("opt-pallas", 2), ("opt-pallas", 4)]
SHARDED_RUNS = 3                 # timed runs of each sharded query
# each kernel module's launch counter against its engine entry point's
# count in `ops.calls`
CALL_OF = {"compact": "compact", "compact_pred": "compact_pred",
           "filter_agg": "filter_agg",
           "selective_filter_agg": "selective_agg"}


def place_shards(n: int, cuda: bool) -> str:
    """Make n mesh slots visible: n CUDA devices when the machine has
    them, else n virtual slots on cuda:0 (on the CPU in a rehearsal).
    Returns which."""
    import torch
    from repro_torch.core import mesh

    if not cuda:
        mesh.virtual_devices("cpu", n)
        return f"{n} virtual slots on the cpu"
    have = torch.cuda.device_count()
    if have >= n:
        mesh.virtual_devices("cuda:0", 1)
        return f"the first {n} of {have} CUDA devices"
    mesh.virtual_devices("cuda:0", n)
    return f"{n} virtual slots on cuda:0 ({have} CUDA device(s) visible)"


def cpu_exchanges(db, queries) -> dict:
    """The Exchange count of every query's plan at SHARDED_CONFIGS: the
    port's `optimize()` planning for the CPU over as many virtual
    slots."""
    import dataclasses

    from repro_torch.core import ir, mesh, optimize, preset

    out = {}
    try:
        for p, n in SHARDED_CONFIGS:
            mesh.virtual_devices("cpu", n)
            for q in queries:
                plan = optimize(queries[q](), db, dataclasses.replace(
                    preset(p), shards=n), device="cpu")
                out[q, p, n] = sum(isinstance(x, ir.Exchange)
                                   for x in ir.walk(plan))
    finally:
        mesh.virtual_devices("cpu", 1)
    return out


def shards_identical(shards, what: str) -> None:
    """Every shard's columns, mask and counts bit for bit shard 0's."""
    import torch

    out0, mask0, counts0 = shards[0]
    for rank, (out, mask, counts) in enumerate(shards[1:], 1):
        check(set(out) == set(out0), f"{what}: shard {rank}'s columns")
        for k, v in out0.items():
            check(torch.equal(out[k].to(v.device), v),
                  f"{what}: shard {rank} differs in {k}")
        check(torch.equal(mask.to(mask0.device), mask0),
              f"{what}: shard {rank}'s mask differs")
        for pid, c in counts0.items():
            check(pid in counts, f"{what}: shard {rank} lacks point {pid}")


def entry_rows(a) -> int:
    """The rows of an entry point's call (its first argument's)."""
    first = a[0]
    return (first if not isinstance(first, dict)
            else next(iter(first.values()))).shape[0]


def sharded_path(db, queries, card, unsharded_ms, counters, args):
    """Every query at SHARDED_CONFIGS through `CompiledQuery(...).run()`
    on a data mesh of the card: n_shards as asked, the Exchange count of
    the CPU's plan, two runs each equal to phase 5's unsharded card
    answer, every shard's output bit for bit the same, no overflow, at
    opt-pallas every engine call a launch of its kernel (none at opt),
    and the median of SHARDED_RUNS `run()`s beside phase 5's unsharded
    median.  At opt-pallas the first run of each query records, from
    every shard's thread, the largest call of each entry point with a
    copy of its card tensors; after the query's launches are read each
    is held against its plain version (`kernel_checks`, untimed).
    Returns the launches of the phase's opt-pallas runs and the checks
    per kernel (max error, the largest per-shard rows)."""
    import dataclasses
    import threading

    import torch

    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, ir, mesh, preset

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    exchanges = cpu_exchanges(db, queries)
    launched = {name: 0 for name in counters}
    called = {name: 0 for name in counters}
    checks: dict = {}
    largest: dict = {}          # entry -> (rows, args, kwargs)
    recording = [False]
    lock = threading.Lock()
    saved = {e: getattr(kops, e) for e in ENTRY_POINTS}

    def recorder(entry, fn):
        def g(*a, **k):
            if recording[0]:
                rows = entry_rows(a)
                with lock:
                    if rows > largest.get(entry, (-1,))[0]:
                        largest[entry] = (rows, to(dev, a, copy=True),
                                          to(dev, k, copy=True))
            return fn(*a, **k)
        return g

    for e in ENTRY_POINTS:
        setattr(kops, e, recorder(e, saved[e]))
    try:
        for p, n in SHARDED_CONFIGS:
            log(f"phase 8 {p} x{n}: " + place_shards(n, cuda))
            for q in queries:
                t_cfg = time.perf_counter()
                what = f"{q} {p} x{n}"
                before = {name: d[k] for name, (d, k) in counters.items()}
                calls0 = dict(kops.calls)
                cq = CompiledQuery(queries[q](), db, dataclasses.replace(
                    preset(p), shards=n),
                    device="cpu" if args.rehearse else None)
                check(cq.n_shards == n, f"{what}: {cq.n_shards} shards")
                n_ex = sum(isinstance(x, ir.Exchange)
                           for x in ir.walk(cq.plan))
                check(n_ex == exchanges[q, p, n],
                      f"{what}: {n_ex} exchanges, the CPU plan's "
                      f"{exchanges[q, p, n]}")
                for i in range(2):  # the second merges the shard counts
                    recording[0] = i == 0 and p == "opt-pallas"
                    assert_same(cq.run(), card[q, p], q in SORT_INSENSITIVE,
                                what)
                    recording[0] = False
                shards_identical(cq.execute_shards(cq.bind()), what)
                check(cq.n_overflows == 0,
                      f"{what}: {cq.n_overflows} overflows")
                ms = []
                for _ in range(SHARDED_RUNS):
                    sync()
                    t = time.perf_counter()
                    cq.run()
                    sync()
                    ms.append((time.perf_counter() - t) * 1e3)
                delta = {name: d[k] - before[name]
                         for name, (d, k) in counters.items()}
                calls = {name: kops.calls[e] - calls0[e]
                         for name, e in CALL_OF.items()}
                if cuda and p == "opt-pallas":
                    check(delta == calls, f"{what}: launches {delta} for "
                          f"the engine's calls {calls}")
                elif cuda:
                    check(not any(delta.values()),
                          f"{what}: a kernel launched ({delta})")
                if p == "opt-pallas":
                    for name, v in delta.items():
                        launched[name] += v
                        called[name] += calls[name]
                    # after the launches are read: these calls launch too
                    got = kernel_checks(
                        [(what, e, a, k) for e, (_r, a, k) in largest.items()],
                        dev, timed=False)
                    largest.clear()
                    for name, c in got.items():
                        e = checks.setdefault(name, {"max_abs_err": 0.0,
                                                     "rows": 0})
                        e["max_abs_err"] = max(e["max_abs_err"],
                                               c["max_abs_err"])
                        e["rows"] = max(e["rows"], c["n"])
                obs = {pid: v.tolist() for pid, v in cq.observed_shard.items()}
                flat = unsharded_ms.get((q, p))
                log(f"sharded {what}: median {statistics.median(ms):.3f} ms "
                    f"(min {min(ms):.3f}) over {len(ms)} runs, unsharded "
                    + (f"{flat:.3f} ms" if flat is not None else "not timed")
                    + f" (phase 5), exchanges {n_ex}, per-shard counts "
                    f"{json.dumps(obs)}, launches "
                    f"{json.dumps({k: v for k, v in delta.items() if v})}, "
                    f"{time.perf_counter() - t_cfg:.1f} s")
                del cq
    finally:
        for e in ENTRY_POINTS:
            setattr(kops, e, saved[e])
        mesh.virtual_devices("cpu" if args.rehearse else "cuda:0", 1)
    unchecked = [k for k, v in called.items() if v and k not in checks]
    check(not unchecked, f"phase 8: no per-shard check of {unchecked}")
    for name, c in checks.items():
        log(f"phase 8 {name}: per-shard calls up to {c['rows']} rows, max "
            f"err {c['max_abs_err']} against the plain version")
    return launched, checks


# ---------------------------------------------------------------------------
# phase 9: the port's plan fuzzer on the card
# ---------------------------------------------------------------------------

FUZZ_SF = 0.05
FUZZ_PLANS = 24                  # naive and opt compiled for each
FUZZ_KERNEL_PLANS = 4            # opt-pallas compiled: an nvcc a predicate
FUZZ_SHARDS = 4                  # virtual slots the opt-shard rung plans over


def fuzz_phase(args) -> None:
    """`run_fuzz` on the card: FUZZ_PLANS seeded plans through every
    `optimize()` rung (the ladder, opt-pallas and opt-shard over
    FUZZ_SHARDS slots) with `naive` and `opt` compiled against the port's
    Volcano, and the first FUZZ_KERNEL_PLANS of them compiled at
    opt-pallas.  Any failure fails the run."""
    from repro_torch.core import mesh
    from repro_torch.core.analysis.fuzz import run_fuzz
    from repro_torch.relational import Database

    cuda = not args.rehearse
    device = "cuda" if cuda else "cpu"
    t0 = time.perf_counter()
    db = Database.tpch(sf=FUZZ_SF, seed=0)
    try:
        log("phase 9 opt-shard: " + place_shards(FUZZ_SHARDS, cuda))
        rep = run_fuzz(db, FUZZ_PLANS, compile_presets=["naive", "opt"],
                       device=device)
        t1 = time.perf_counter()
        kern = run_fuzz(db, FUZZ_KERNEL_PLANS, presets=[],
                        compile_presets=["opt-pallas"], device=device)
    finally:
        mesh.virtual_devices("cuda:0" if cuda else "cpu", 1)
    failures = rep.failures + kern.failures
    log(f"fuzz sf={FUZZ_SF}: {rep.n_plans} plans, {rep.n_optimized} "
        f"optimizes, {rep.n_compiled + kern.n_compiled} compiles "
        f"({kern.n_compiled} at opt-pallas), {len(failures)} failures; "
        f"naive/opt {t1 - t0:.1f} s, opt-pallas "
        f"{time.perf_counter() - t1:.1f} s")
    for f in failures[:5]:
        log(f"  fuzz failure: seed={f['seed']} preset={f['preset']} "
            f"[{f['stage']}] {f['error']}")
    check(not failures, f"the fuzzer found {len(failures)} failures")
    check(kern.n_compiled == FUZZ_KERNEL_PLANS,
          f"{kern.n_compiled} opt-pallas compiles")


# ---------------------------------------------------------------------------
# phase 10: the language-model serving path
# ---------------------------------------------------------------------------

LM_ARCH = "qwen1_5_0_5b"         # the default of the serving launcher
LM_PREFILL = 128                 # tokens of the timed prefill, batch 1
LM_PREFILL_RUNS = 5
# a step's largest |card - CPU| logit over its largest |CPU| logit, both
# in bf16 on the same token stream: 24 layers of bf16 products rounded in
# different orders (cuBLAS against the CPU's) drift by a few bf16 ulps
# (2^-8 each) of the hidden state, far under 5 %
LM_BF16_REL = 5e-2
# the same measure for a request at slots=4 against it alone at slots=1,
# float32 on the card: only the products' order differs (batch 4 and 1)
LM_F32_REL = 1e-4
# card against CPU at smoke widths, float32: the CPU tests' tolerance of
# the port against the reference
LM_SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)


def rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want|, got finite."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    return float((got - want).abs().max() / want.abs().max())


def lm_requests(cfg, record: bool):
    from repro_torch.launch import serve as launch

    reqs = launch.make_requests(cfg, 8, 12)
    for r in reqs:
        r.logits = [] if record else None
    return reqs


def lm_full_width(args, card: str) -> dict:
    """(a) Qwen1.5-0.5B at full width in bf16 on the card: the launcher's
    defaults (8 requests, 4 slots, max_len 128, 12 new tokens), every
    step's card logits against a batch-1 bf16 replay through
    `decode_step` on the CPU, then the tick, tok/s, prefill and memory
    numbers from a second, unrecorded run; (b) the same model in float32,
    each request at slots=4 against it alone at slots=1 on the same
    stream.  A rehearsal runs the smoke width (2 layers) on the CPU."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import (Ctx, cast_params, decode_step,
                                    init_cache, init_params, prefill)
    from repro_torch.serve.batcher import Request, ServeEngine

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = get_config(LM_ARCH) if cuda else dataclasses.replace(
        smoke_config(LM_ARCH), dtype="bfloat16")
    ctx = Ctx()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "card": card}
    t0 = time.perf_counter()
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out["params"] = sum(p.numel() for p in masters.parameters())
    out["init_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- (a) bf16, recorded, then timed ------------------------------------
    eng = ServeEngine(masters, cfg, ctx, slots=4, max_len=128, device=dev)
    reqs = lm_requests(cfg, record=True)
    launch.drain(eng, reqs)
    check(all(r.done and len(r.out) == 13 for r in reqs),
          "phase 10: a request was not served in full")
    timed = lm_requests(cfg, record=False)
    res = launch.drain(ServeEngine(eng.params, cfg, ctx, slots=4,
                                   max_len=128, device=dev), timed)
    decode = [ms for live, admitted, ms in res["ticks"]
              if live == 4 and admitted == 0]
    check(decode, "phase 10: no decode tick with 4 live slots")
    out.update(tokens=res["tokens"], ticks=len(res["ticks"]),
               seconds=res["seconds"],
               tok_per_s=res["tokens"] / res["seconds"],
               decode_ticks=len(decode),
               tick_ms_median=statistics.median(decode),
               tick_ms_min=min(decode),
               same_tokens_as_recorded=[r.out for r in timed]
               == [r.out for r in reqs])
    check(out["same_tokens_as_recorded"],
          "phase 10 (a): the timed run served other tokens than the "
          "checked run")
    toks = torch.randint(0, cfg.vocab, (1, LM_PREFILL),
                         generator=torch.Generator().manual_seed(1))
    ms = []
    for i in range(LM_PREFILL_RUNS + 1):
        t = time.perf_counter()
        logits, _ = prefill(eng.params, {"tokens": toks}, cfg, ctx)
        logits.float().cpu()
        if i:
            ms.append((time.perf_counter() - t) * 1e3)
    out.update(prefill_ms_median=statistics.median(ms),
               prefill_ms_min=min(ms))
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # where a tick's time goes: one 4-slot decode step and the
        # prefill under torch.profiler (device ms and kernels a call)
        cache = init_cache(cfg, 4, 128, device=dev)
        step = torch.tensor([3, 40, 77, 126])
        for name, fn in (
                ("decode", lambda: decode_step(eng.params, step % cfg.vocab,
                                               cache, step, cfg, ctx)),
                ("prefill", lambda: prefill(eng.params, {"tokens": toks},
                                            cfg, ctx))):
            prof = profile_call(fn, calls=3)
            top = sorted(prof["device_kernels"].items(), key=lambda kv: -kv[1])
            out[f"{name}_device_ms"] = prof["device_ms"]
            out[f"{name}_kernels"] = prof["kernels_per_call"]
            out[f"{name}_top_kernels"] = dict(top[:5])

    t0 = time.perf_counter()
    host = cast_params(masters, cfg, "cpu")
    worst = 0.0
    for r in reqs:
        cache = init_cache(cfg, 1, 128, device="cpu")
        stream = [int(t) for t in r.prompt] + r.out[:-1]
        for i, tok in enumerate(stream):
            logits, cache = decode_step(host, torch.tensor([tok]), cache, i,
                                        cfg, ctx)
            k = i - (len(r.prompt) - 1)
            if k >= 0:
                e = rel_err(r.logits[k], logits[0])
                check(e <= LM_BF16_REL, f"phase 10 (a) request {r.rid} "
                      f"step {k}: card against CPU {e:.3g} > {LM_BF16_REL}")
                worst = max(worst, e)
    out.update(bf16_rel_err=worst, replay_s=time.perf_counter() - t0)
    del eng, host

    # -- (b) float32: slots=4 against alone ---------------------------------
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = cast_params(masters, cfg32, dev)
    reqs = lm_requests(cfg32, record=True)
    launch.drain(ServeEngine(f32, cfg32, ctx, slots=4, max_len=128,
                             device=dev), reqs)
    worst = 0.0
    for r in reqs:
        alone = Request(r.rid, r.prompt, r.max_new, force=r.out, logits=[])
        launch.drain(ServeEngine(f32, cfg32, ctx, slots=1, max_len=128,
                                 device=dev), [alone])
        check(len(alone.logits) == len(r.logits), "phase 10 (b) lengths")
        for k, (a, b) in enumerate(zip(r.logits, alone.logits)):
            e = rel_err(a, b)
            check(e <= LM_F32_REL, f"phase 10 (b) request {r.rid} step {k}:"
                  f" slots=4 against alone {e:.3g} > {LM_F32_REL}")
            worst = max(worst, e)
    out.update(f32_slot_rel_err=worst, f32_s=time.perf_counter() - t0)
    del f32, masters
    if cuda:
        torch.cuda.empty_cache()
    return out


def lm_families(args) -> dict:
    """(c) Each family's smoke config on the card and on the CPU with the
    same weights (seed 0): `prefill` at batch 2 and sequence 8 (with the
    family's frames or patches), 6 `decode_step`s at a (B,) position
    vector from a zero cache, a 2-slot engine over 3 requests.  Logits and
    caches within LM_SMOKE_TOL, the engine's tokens equal.  Returns each
    family's largest absolute logit difference."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import (Ctx, cast_params, decode_step,
                                    init_cache, init_params, prefill)
    from repro_torch.serve.batcher import Request, ServeEngine

    dev = torch.device("cpu" if args.rehearse else "cuda")
    ctx = Ctx()

    def same(got, want, what):
        if isinstance(got, (tuple, list)):
            for g, w in zip(got, want):
                same(g, w, what)
        elif isinstance(got, dict):
            for k in want:
                same(got[k], want[k], f"{what}.{k}")
        else:
            torch.testing.assert_close(got.cpu(), want, msg=what,
                                       **LM_SMOKE_TOL)

    errs = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = cast_params(host, cfg, dev)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 8))}
        if cfg.encoder_layers:
            batch["frames"] = rng.normal(size=(2, 4, cfg.d_model)).astype(
                np.float32)
        if cfg.n_patches:
            batch["patch_embeds"] = rng.normal(
                size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        got, got_c = prefill(card, batch, cfg, ctx)
        want, want_c = prefill(host, batch, cfg, ctx)
        same(got, want, f"{arch} prefill logits")
        same(got_c, want_c, f"{arch} prefill cache")
        err = float((got.cpu() - want).abs().max())
        s_enc = 8 if cfg.encoder_layers else 0
        c_card = init_cache(cfg, 2, 16, s_enc, dev)
        c_host = init_cache(cfg, 2, 16, s_enc, "cpu")
        for t in range(6):
            tok = rng.integers(0, cfg.vocab, 2)
            pos = torch.tensor([t, t + 3])
            got, c_card = decode_step(card, tok, c_card, pos, cfg, ctx)
            want, c_host = decode_step(host, tok, c_host, pos, cfg, ctx)
            same(got, want, f"{arch} decode {t} logits")
            same(c_card, c_host, f"{arch} decode {t} cache")
            err = max(err, float((got.cpu() - want).abs().max()))
        prompts = [rng.integers(0, cfg.vocab, 3 + i) for i in range(3)]
        outs = []
        for params, d in ((card, dev), (host, "cpu")):
            eng = ServeEngine(params, cfg, ctx, slots=2, max_len=32, device=d)
            reqs = [Request(i, p, 4) for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            outs.append([r.out for r in reqs])
        check(outs[0] == outs[1], f"{arch}: engine tokens {outs[0]} on the "
              f"card against {outs[1]} on the CPU")
        errs[arch] = err
    return errs


def lm_phase(args, card: str) -> dict:
    t0 = time.perf_counter()
    res = lm_full_width(args, card)
    t1 = time.perf_counter()
    res["family_max_abs_err"] = lm_families(args)
    res["families_s"] = time.perf_counter() - t1
    log(f"phase 10 (a) {res['arch']} ({res['params']:,} parameters, "
        f"{res['layers']} layers, d_model {res['d_model']}, bf16) on "
        f"{card}: decode tick with 4 live slots median "
        f"{res['tick_ms_median']:.3f} ms, min {res['tick_ms_min']:.3f} ms "
        f"({res['decode_ticks']} ticks); {res['tokens']} tokens in "
        f"{res['ticks']} ticks, {res['tok_per_s']:.1f} tok/s; prefill of "
        f"{LM_PREFILL} tokens at batch 1 median "
        f"{res['prefill_ms_median']:.3f} ms, min {res['prefill_ms_min']:.3f}"
        f" ms; peak device memory "
        + (f"{res['peak_gib']:.3f} GiB" if "peak_gib" in res
           else "not measured") + "; logits "
        f"against the CPU's bf16 replay within {res['bf16_rel_err']:.3g} "
        f"(limit {LM_BF16_REL}); weights {res['init_s']:.1f} s, replay "
        f"{res['replay_s']:.1f} s")
    if "decode_device_ms" in res:
        log(f"phase 10 (a) profile on {card}: a 4-slot decode step "
            f"{res['decode_device_ms']:.3f} device ms in "
            f"{res['decode_kernels']:.0f} kernels (busy "
            f"{res['decode_device_ms'] / res['tick_ms_median']:.1%} of the "
            f"median tick); the {LM_PREFILL}-token prefill "
            f"{res['prefill_device_ms']:.3f} device ms in "
            f"{res['prefill_kernels']:.0f} kernels")
    log(f"phase 10 (b) float32 on {card}: slots=4 against alone within "
        f"{res['f32_slot_rel_err']:.3g} (limit {LM_F32_REL}), "
        f"{res['f32_s']:.1f} s")
    log(f"phase 10 (c) ten families at smoke width on {card}: card against "
        f"CPU max abs logit err {max(res['family_max_abs_err'].values()):.3g}"
        f", engine tokens equal, {res['families_s']:.1f} s")
    log(json.dumps({"lm_serving": res}))
    log(f"phase 10 (LM serving path): {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 11: the training path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1_5_0_5b"      # the default of the training launcher
TRAIN_FAIL_AT = 25               # (b): the step whose first try raises
TRAIN_GRAD_BATCH = 2             # (a): batch 2 x the launcher's sequence 64
# (a) card against CPU, float32 (TF32 off), same masters and batch: the
# loss, the global gradient norm, each leaf against its largest |grad|
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
TRAIN_LEAF_REL = 1e-3
# (b) a replayed step's loss against its first pass (restored state, the
# same batch; the card's scatter-adds order their sums freely), and step
# 0's bf16 loss against a float32 forward of the same weights and batch
TRAIN_REPLAY_RTOL = 1e-3
TRAIN_BF16_LOSS_REL = 1e-2
# (c) card against CPU at smoke widths, float32: the CPU tests' tolerances
# of the port against the reference (tests/test_torch_train.py), with
# the exceptions `repro_torch.train.compare` derives (Adam's undetermined
# directions, int8 roundings on a boundary)
# the step's bound: model_flops over the bf16 peak; for memory, Adam's 28
# bytes a parameter (reads p, g, m, v; writes p, m, v; float32) and the
# bf16 copy's reads in the forward, the recompute and the backward (6)
TRAIN_OPT_BYTES, TRAIN_WEIGHT_BYTES = 28, 6


# a kernel's kind by its name (the profiler's, cut to 60 characters)
KERNEL_KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                ("copy", ("Memcpy", "Memset", "copy")),
                ("index", ("index", "scatter", "gather", "embedding")),
                ("reduce", ("reduce", "softmax", "norm")),
                ("elementwise", ("elementwise",)))


def kernel_kinds(device_kernels: dict) -> dict:
    """Device ms a call summed by kind of kernel (KERNEL_KINDS, first
    match; "other" for the rest)."""
    out: dict = {}
    for name, ms in device_kernels.items():
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(s in name for s in keys)), "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def train_full_grads(args, card: str) -> dict:
    """(a) Qwen1.5-0.5B at full width in float32: one loss and gradient
    at batch 2 x 64 from the pipeline, on the card (TF32 off) and on the
    CPU from the same masters (seed 0)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import Ctx, cast_params, init_params
    from repro_torch.train.optimizer import global_norm
    from repro_torch.models.tree import leaves
    from repro_torch.train.train_step import value_and_grad

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH) if cuda
                              else smoke_config(TRAIN_ARCH), dtype="float32")
    ctx = Ctx()
    t0 = time.perf_counter()
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {"params": sum(p.numel() for p in masters.parameters()),
           "init_s": time.perf_counter() - t0}
    batch = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_GRAD_BATCH,
                          seq_len=64).batch_at(0)
    card_m = cast_params(masters, cfg, dev)
    t0 = time.perf_counter()
    loss_c, grads_c = value_and_grad(card_m, batch, cfg, ctx)
    loss_c = float(loss_c)
    out["card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, grads_h = value_and_grad(masters, batch, cfg, ctx)
    out["cpu_s"] = time.perf_counter() - t0
    loss_h = float(loss_h)
    norm_c, norm_h = float(global_norm(grads_c)), float(global_norm(grads_h))
    out.update(loss_card=loss_c, loss_cpu=loss_h, grad_norm_card=norm_c,
               grad_norm_cpu=norm_h)
    check(abs(loss_c - loss_h) <= TRAIN_LOSS_RTOL * abs(loss_h),
          f"phase 11 (a): loss {loss_c} on the card, {loss_h} on the CPU")
    check(abs(norm_c - norm_h) <= TRAIN_NORM_RTOL * norm_h,
          f"phase 11 (a): grad norm {norm_c} on the card, {norm_h} on the "
          "CPU")
    worst = 0.0
    for g, w in zip(leaves(grads_c), leaves(grads_h), strict=True):
        g = g.cpu()
        check(bool(g.isfinite().all()), "phase 11 (a): non-finite gradient")
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        check(err <= TRAIN_LEAF_REL * scale, f"phase 11 (a): a gradient "
              f"leaf off by {err:.3g} at scale {scale:.3g}")
        worst = max(worst, err / scale)
    out["leaf_rel_err"] = worst
    del card_m, grads_c
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_launcher_run(args, card: str) -> dict:
    """(b) the launcher's run at full width in bf16 (30 steps, batch 8,
    sequence 64, `AdamConfig(warmup=10)`, async checkpoints every 20 into
    a temporary directory) through `TrainDriver`, with a failure injected
    once at step TRAIN_FAIL_AT; then one step under the profiler, a
    restore of the checkpoint, and the step's bound."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.checkpoint import latest_step, restore
    from repro_torch.launch import roofline
    from repro_torch.launch import train as launch
    from repro_torch.models import Ctx
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import AdamConfig, adam_update
    from repro_torch.train.train_step import loss_fn, value_and_grad

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    largs = launch.parse_args([])
    fired = []

    def fail_hook(step):
        if step == TRAIN_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError("phase 11: injected failure")

    tmp = tempfile.mkdtemp(prefix="train-ckpt-")
    try:
        t0 = time.perf_counter()
        cfg, drv = launch.make_driver(largs, dev, tmp, fail_hook)
        out = {"arch": cfg.name, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab,
               "dtype": cfg.dtype, "card": card,
               "steps": largs.steps, "batch": largs.batch, "seq": largs.seq,
               "params": sum(p.numel() for p in drv.state.params.parameters()),
               "init_s": time.perf_counter() - t0}
        # step 0's batch through a float32 forward of the same weights
        batch0 = drv.pipeline.batch_at(0)
        with torch.no_grad():
            loss32 = float(loss_fn(drv.state.params, batch0,
                                   dataclasses.replace(cfg, dtype="float32"),
                                   Ctx()))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        drv.run(largs.steps)
        out["run_s"] = time.perf_counter() - t0
        if cuda:
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log_ = drv.metrics_log
        check(drv.recoveries == 1 and fired == [TRAIN_FAIL_AT],
              f"phase 11 (b): {drv.recoveries} recoveries")
        check(all(math.isfinite(m["loss"]) for m in log_),
              "phase 11 (b): a non-finite loss")
        ck = 20
        check(latest_step(tmp) == ck, f"phase 11 (b): latest checkpoint "
              f"{latest_step(tmp)}")
        first = {m["step"]: m["loss"] for m in log_[:TRAIN_FAIL_AT]}
        replay = {m["step"]: m["loss"] for m in log_[TRAIN_FAIL_AT:]}
        check(sorted(first) == list(range(TRAIN_FAIL_AT))
              and sorted(replay) == list(range(ck, largs.steps)),
              "phase 11 (b): the steps run are not 0..24 then 20..29")
        worst = 0.0
        for s in range(ck, TRAIN_FAIL_AT):
            e = abs(replay[s] - first[s]) / abs(first[s])
            check(e <= TRAIN_REPLAY_RTOL, f"phase 11 (b): step {s} replayed "
                  f"{replay[s]} against {first[s]}")
            worst = max(worst, e)
        e0 = abs(first[0] - loss32) / abs(loss32)
        check(e0 <= TRAIN_BF16_LOSS_REL, f"phase 11 (b): step 0's {cfg.dtype}"
              f" loss {first[0]} against float32 {loss32}")
        steady = [m["dt"] * 1e3 for m in log_[2:ck]]
        tokens = largs.batch * largs.seq
        out.update(
            losses=[m["loss"] for m in log_], replay_rel_err=worst,
            loss_step0=first[0], loss_step0_f32=loss32,
            step0_rel_err=e0, recoveries=drv.recoveries,
            stragglers=len(drv.straggler.slow_steps),
            step_ms_median=statistics.median(steady),
            step_ms_min=min(steady),
            tok_per_s=tokens / (statistics.median(steady) / 1e3),
            ckpt_snapshot_s=drv.ckpt.snapshot_s,
            ckpt_write_s=drv.ckpt.write_s,
            ckpt_bytes=sum(f.stat().st_size
                           for f in Path(tmp).rglob("*") if f.is_file()))
        t0 = time.perf_counter()
        back = restore(tmp, ck, drv.state, device=dev)
        float(back.opt.step)                  # waits for the copies
        out["ckpt_restore_s"] = time.perf_counter() - t0
        del back
        if cuda:
            batch = drv.pipeline.batch_at(largs.steps)
            prof = profile_call(lambda: drv.step_fn(drv.state, batch),
                                calls=2)
            out.update(step_device_ms=prof["device_ms"],
                       step_kernels=prof["kernels_per_call"],
                       step_busy=prof["device_ms"] / out["step_ms_median"],
                       step_device_ms_by_kind=kernel_kinds(
                           prof["device_kernels"]))
            # the optimizer's share: Adam alone on this step's gradients
            _, grads = value_and_grad(drv.state.params, batch, cfg, Ctx())
            st = drv.state
            prof = profile_call(lambda: adam_update(
                grads, st.opt, st.params, AdamConfig(warmup=10)), calls=2)
            out.update(adam_device_ms=prof["device_ms"],
                       adam_kernels=prof["kernels_per_call"],
                       adam_host_ms=host_ms(lambda: adam_update(
                           grads, st.opt, st.params, AdamConfig(warmup=10)),
                           calls=5))
            del grads, st
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shape = ShapeConfig("train_launcher", "train", largs.seq, largs.batch)
    flops = roofline.model_flops(cfg, shape)
    mem = (TRAIN_OPT_BYTES + TRAIN_WEIGHT_BYTES) * out["params"]
    out.update(model_flops=flops, bound_compute_ms=flops / roofline.PEAK_FLOPS
               * 1e3, bound_bytes=mem,
               bound_memory_ms=mem / roofline.HBM_BW * 1e3)
    out["bound_ms"] = max(out["bound_compute_ms"], out["bound_memory_ms"])
    out["bound_by"] = ("operations" if out["bound_compute_ms"]
                       >= out["bound_memory_ms"] else "bytes")
    del drv
    if cuda:
        torch.cuda.empty_cache()
    return out


def accum_grad_scale(params, batch, cfg, ctx) -> list:
    """Each leaf's largest |gradient| of an accum=2 step on `batch` (its
    two rows), as the step's compression sees it (error feedback 0)."""
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.models.tree import leaves

    halves = [leaves(value_and_grad(params, {k: v[i:i + 1]
                                             for k, v in batch.items()},
                                    cfg, ctx)[1]) for i in range(2)]
    return [float(((a + b) / 2).abs().max()) for a, b in zip(*halves)]


def train_families(args) -> dict:
    """(c) Each family's smoke config on the card and on the CPU with the
    same weights (seed 0), float32: the loss and gradients at batch 2 x
    16, then two `train_step`s (the second with accum=2 and compression
    on, from the first's state), compared by `compare_states` (the
    second with the CPU's gradient scale).  Returns each family's largest
    gradient error (over its leaf's scale), its elements rounded apart
    and its params of undetermined Adam direction."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import Ctx, cast_params, init_params
    from repro_torch.train.compare import compare_grads, compare_states
    from repro_torch.train.grad_compression import ef_init
    from repro_torch.train.optimizer import AdamConfig
    from repro_torch.train.train_step import (make_train_state, train_step,
                                              value_and_grad)

    dev = torch.device("cpu" if args.rehearse else "cuda")
    ctx = Ctx()
    opt_cfg = AdamConfig(warmup=1)
    res = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = cast_params(host, cfg, dev)
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(2):
            b = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(
                np.int32), "targets": rng.integers(0, cfg.vocab, (2, 16))
                .astype(np.int32)}
            if cfg.encoder_layers:
                b["frames"] = rng.normal(size=(2, 4, cfg.d_model)).astype(
                    np.float32)
            if cfg.n_patches:
                b["patch_embeds"] = rng.normal(
                    size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
            batches.append(b)
        loss_c, grads_c = value_and_grad(card, batches[0], cfg, ctx)
        loss_h, grads_h = value_and_grad(host, batches[0], cfg, ctx)
        check(abs(float(loss_c) - float(loss_h))
              <= TRAIN_LOSS_RTOL * abs(float(loss_h)),
              f"phase 11 (c) {arch}: loss")
        err = compare_grads(grads_c, grads_h, f"phase 11 (c) {arch}")
        states = []
        for params in (card, host):
            st, _ = train_step(make_train_state(params), batches[0], cfg,
                               ctx, opt_cfg)
            first = st
            st = st._replace(ef=ef_init(st.params))
            st, _ = train_step(st, batches[1], cfg, ctx, opt_cfg, accum=2)
            states.append((first, st))
        first = compare_states(states[0][0], states[1][0], opt_cfg,
                               what=f"phase 11 (c) {arch} step 1")
        second = compare_states(
            states[0][1], states[1][1], opt_cfg, before=first,
            grad_scale=accum_grad_scale(states[1][0].params, batches[1],
                                        cfg, ctx),
            what=f"phase 11 (c) {arch} step 2")
        res[arch] = {"grad_rel_err": err,
                     "int8_boundary": second["int8_apart"],
                     "params_loose": int(sum(m.sum()
                                             for m in second["loose"]))}
    return res


def train_phase(args, card: str) -> dict:
    import torch

    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        a = train_full_grads(args, card)
        log(f"phase 11 (a) {TRAIN_ARCH} ({a['params']:,} parameters) "
            f"float32 on {card}: loss {a['loss_card']:.6f} against the "
            f"CPU's {a['loss_cpu']:.6f}, grad norm {a['grad_norm_card']:.6f}"
            f" against {a['grad_norm_cpu']:.6f}, leaves within "
            f"{a['leaf_rel_err']:.3g} of their largest |grad| (limit "
            f"{TRAIN_LEAF_REL}); card {a['card_s']:.1f} s, CPU "
            f"{a['cpu_s']:.1f} s, {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        b = train_launcher_run(args, card)
        log(f"phase 11 (b) {b['arch']} {b['dtype']} on {card}: "
            f"{b['steps']} steps of {b['batch']} x {b['seq']}, step median "
            f"{b['step_ms_median']:.3f} ms, min {b['step_ms_min']:.3f} ms "
            f"(steps 2 to 19), {b['tok_per_s']:.1f} tok/s; "
            + (f"one step {b['step_device_ms']:.3f} device ms in "
               f"{b['step_kernels']:.0f} kernels (busy {b['step_busy']:.1%} "
               "of the median step; "
               + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                   b["step_device_ms_by_kind"].items(), key=lambda kv: -kv[1]))
               + f" ms), Adam alone {b['adam_device_ms']:.3f} device ms in "
               f"{b['adam_kernels']:.0f} kernels, {b['adam_host_ms']:.3f} ms "
               f"of host; peak {b['peak_gib']:.3f} GiB; "
               if "peak_gib" in b else "device not measured; ")
            + f"checkpoint {b['ckpt_bytes'] / 1e9:.3f} GB: snapshot "
            f"{b['ckpt_snapshot_s']:.3f} s, write {b['ckpt_write_s']:.3f} s,"
            f" restore {b['ckpt_restore_s']:.3f} s; recoveries "
            f"{b['recoveries']}, replayed steps within "
            f"{b['replay_rel_err']:.3g}, step 0 against float32 "
            f"{b['step0_rel_err']:.3g}; bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}: compute {b['bound_compute_ms']:.3f}, memory "
            f"{b['bound_memory_ms']:.3f}); {time.perf_counter() - t1:.1f} s")
        t2 = time.perf_counter()
        fam = train_families(args)
        log(f"phase 11 (c) ten families at smoke width on {card}: card "
            f"against CPU, gradients within "
            f"{max(r['grad_rel_err'] for r in fam.values()):.3g} of their "
            f"scale, int8 boundary roundings "
            f"{sum(r['int8_boundary'] for r in fam.values())}, params of "
            f"undetermined Adam direction "
            f"{sum(r['params_loose'] for r in fam.values())}, "
            f"{time.perf_counter() - t2:.1f} s")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    res = {"full_grads": a, "launcher": b, "families": fam}
    log(json.dumps({"lm_training": res}))
    log(f"phase 11 (training path): {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 12: the model-sharding layer
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 2)              # ("data", "model"), virtual slots of cuda:0
MESH_DENSE, MESH_MOE = "qwen1_5_0_5b", "granite_moe_1b_a400m"
MESH_LOGIT_REL = 1e-4            # logits: of the largest |logit|
MESH_FWD = (8, 64)               # (a) forward_train batch x sequence
MESH_MOE_FWD = (2, 64)           # (b)
MESH_PROMPT, MESH_STEPS = 128, 8  # (a) prefill, then greedy decode steps
MESH_MOE_PROMPT, MESH_MOE_STEPS = 16, 4  # (b) at batch 1
# (c) the dry run's cells: (arch, shape, multi-pod)
DRYRUN_CELLS = [("qwen1_5_0_5b", "train_4k", False),
                ("qwen1_5_0_5b", "prefill_32k", False),
                ("qwen1_5_0_5b", "decode_32k", False),
                ("granite_moe_1b_a400m", "train_4k", False),
                ("deepseek_v2_236b", "decode_32k", False),
                ("deepseek_v2_236b", "decode_32k", True)]


def mesh_greedy(model, tokens, steps: int, ctx) -> tuple:
    """A prefill of `tokens`, then `steps` greedy decode steps from its
    caches grown to fit them: the tokens (steps + 1, B) and the last
    logits, whole on the host."""
    import torch
    from repro_torch.models import decode_step, pad_cache, prefill
    from repro_torch.models.sharding import gather

    logits, cache = prefill(model, {"tokens": tokens}, model.cfg, ctx)
    cache = pad_cache(cache, tokens.shape[1] + steps)
    out = [gather(logits).argmax(-1).cpu()]
    for i in range(steps):
        logits, cache = decode_step(model, out[-1], cache,
                                    tokens.shape[1] + i, model.cfg, ctx)
        out.append(gather(logits).argmax(-1).cpu())
    return torch.stack(out), gather(logits).float().cpu()


def logit_err(got, want, what: str) -> float:
    """max |got - want| over the largest |want|, held to MESH_LOGIT_REL."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape and bool(got.isfinite().all()),
          f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = float((got - want).abs().max()) / float(want.abs().max())
    check(err <= MESH_LOGIT_REL, f"{what}: logits off by {err:.3g} of the "
          f"largest (limit {MESH_LOGIT_REL})")
    return err


def slot_bytes(tree) -> dict:
    """Each slot's bytes of the DTensor leaves of `tree`, each leaf's
    share held to its spec's: its whole bytes over the mesh sizes of the
    axes that shard it (`param_specs` shards only what they divide)."""
    import math

    from repro_torch.models.tree import leaves
    from torch.distributed.tensor import DTensor, Shard

    per: dict = {}
    for t in leaves(tree):
        if not isinstance(t, DTensor):
            continue
        sizes = dict(zip(t.device_mesh.mesh_dim_names, t.device_mesh.shape))
        split = math.prod(n for (_a, n), pl in zip(sizes.items(),
                                                    t.placements)
                          if isinstance(pl, Shard))
        whole = t.numel() * t.element_size()
        local = t.to_local()
        shards = getattr(local, "_local_tensors", {0: local})
        for r, x in shards.items():
            got = x.numel() * x.element_size()
            check(got * split == whole, f"phase 12: a slot holds {got} "
                  f"bytes of a {whole}-byte leaf split {split} ways")
            per[r] = per.get(r, 0) + got
    return per


def mesh_dense(args, card: str) -> dict:
    """(a) Qwen1.5-0.5B at full width, float32, on the (2, 2) mesh of 4
    virtual slots against the unsharded card run of the same weights."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_ctx, make_mesh, world
    from repro_torch.models import LM, Ctx, cast_params, forward_train, init_params
    from repro_torch.models.sharding import distribute, gather
    from repro_torch.models.tree import leaves
    from repro_torch.train.optimizer import AdamConfig, global_norm
    from repro_torch.train.train_step import (make_train_state, train_step,
                                              value_and_grad)

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = dataclasses.replace(get_config(MESH_DENSE) if cuda
                              else smoke_config(MESH_DENSE), dtype="float32")
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = cast_params(masters, cfg, dev)
    del masters
    out = {"arch": cfg.name, "params": sum(p.numel()
                                           for p in model.parameters())}
    b, s = MESH_FWD
    fwd = TokenPipeline(vocab=cfg.vocab, batch=b, seq_len=s).batch_at(1)
    step = TokenPipeline(vocab=cfg.vocab, batch=launch.parse_args([]).batch,
                         seq_len=launch.parse_args([]).seq).batch_at(0)
    prompt = torch.from_numpy(TokenPipeline(
        vocab=cfg.vocab, batch=MESH_SHAPE[0],
        seq_len=MESH_PROMPT).batch_at(2)["tokens"]).long()
    t0 = time.perf_counter()
    with torch.no_grad():
        want_logits = forward_train(model, {"tokens": fwd["tokens"]}, cfg,
                                    Ctx()).cpu()
    want_toks, _ = mesh_greedy(model, prompt.to(dev), MESH_STEPS, Ctx())
    loss1, grads1 = value_and_grad(model, step, cfg, Ctx())
    grads1 = [g.cpu() for g in leaves(grads1)]
    st1, m1 = train_step(make_train_state(model), step, cfg, Ctx(),
                         AdamConfig())
    loss1, norm1 = float(loss1), float(m1["grad_norm"])
    del st1
    out["unsharded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with world(4, "local"):
        ctx = make_ctx(make_mesh(MESH_SHAPE, ("data", "model"), dev.type))
        sharded = LM(cfg, distribute(model.tree(), ctx))
        with torch.no_grad():
            got = gather(forward_train(sharded, {"tokens": fwd["tokens"]},
                                       cfg, ctx))
        out["forward_rel_err"] = logit_err(got, want_logits,
                                           "phase 12 (a) forward_train")
        toks, _ = mesh_greedy(sharded, prompt.to(dev), MESH_STEPS, ctx)
        check(torch.equal(toks, want_toks), "phase 12 (a): sharded prefill "
              "and decode tokens differ from the unsharded card's")
        loss2, grads2 = value_and_grad(sharded, step, cfg, ctx)
        loss2 = float(gather(loss2))
        worst = 0.0
        for g, w in zip(leaves(grads2), grads1, strict=True):
            g = gather(g).cpu()
            check(bool(g.isfinite().all()), "phase 12 (a): non-finite grad")
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            check(err <= TRAIN_LEAF_REL * scale, f"phase 12 (a): a gradient"
                  f" leaf off by {err:.3g} at scale {scale:.3g}")
            worst = max(worst, err / max(scale, 1e-30))
        del grads2
        st2, m2 = train_step(make_train_state(sharded), step, cfg, ctx,
                             AdamConfig())
        norm2 = float(gather(m2["grad_norm"]))
        check(abs(loss2 - loss1) <= TRAIN_LOSS_RTOL * abs(loss1),
              f"phase 12 (a): loss {loss2} sharded, {loss1} unsharded")
        check(abs(float(gather(m2["loss"])) - loss1)
              <= TRAIN_LOSS_RTOL * abs(loss1), "phase 12 (a): the step's loss")
        check(abs(norm2 - norm1) <= TRAIN_NORM_RTOL * norm1,
              f"phase 12 (a): grad norm {norm2} sharded, {norm1} unsharded")
        per = slot_bytes(st2.params)
        opt = slot_bytes((st2.opt.m, st2.opt.v))
        del st2, sharded
    out.update(sharded_s=time.perf_counter() - t0, loss=loss1,
               loss_sharded=loss2, grad_norm=norm1, grad_norm_sharded=norm2,
               leaf_rel_err=worst, tokens=int(want_toks.numel()),
               slot_param_bytes=per, slot_adam_bytes=opt)
    return out


def mesh_moe(args, card: str) -> dict:
    """(b) Granite-3.0-1B-A400M at full width, float32, on the same mesh,
    through the MoE's `local_map` branch: forward_train on 2 x 64 (against
    each data shard's row run alone) and a batch-1 prefill and decode
    (the replicated-token fallback)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_ctx, make_mesh, world
    from repro_torch.models import LM, Ctx, cast_params, forward_train, init_params
    from repro_torch.models.sharding import distribute, gather

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = dataclasses.replace(get_config(MESH_MOE) if cuda
                              else smoke_config(MESH_MOE), dtype="float32")
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = cast_params(masters, cfg, dev)
    del masters
    out = {"arch": cfg.name, "params": sum(p.numel()
                                           for p in model.parameters())}
    b, s = MESH_MOE_FWD
    fwd = TokenPipeline(vocab=cfg.vocab, batch=b, seq_len=s).batch_at(3)
    prompt = torch.from_numpy(TokenPipeline(
        vocab=cfg.vocab, batch=1, seq_len=MESH_MOE_PROMPT).batch_at(4)[
            "tokens"]).long().to(dev)
    t0 = time.perf_counter()
    # the MoE routes each data shard's tokens alone (its capacity from
    # their count, as the reference's shard_map does), so the unsharded
    # run takes each shard's rows alone too
    rows = torch.from_numpy(fwd["tokens"]).chunk(MESH_SHAPE[0])
    with torch.no_grad():
        want = torch.cat([forward_train(model, {"tokens": r}, cfg,
                                        Ctx()).cpu() for r in rows])
    want_toks, want_last = mesh_greedy(model, prompt, MESH_MOE_STEPS, Ctx())
    out["unsharded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with world(4, "local"):
        ctx = make_ctx(make_mesh(MESH_SHAPE, ("data", "model"), dev.type))
        sharded = LM(cfg, distribute(model.tree(), ctx))
        with torch.no_grad():
            got = gather(forward_train(sharded, {"tokens": fwd["tokens"]},
                                       cfg, ctx))
        out["forward_rel_err"] = logit_err(got, want,
                                           "phase 12 (b) forward_train")
        toks, last = mesh_greedy(sharded, prompt, MESH_MOE_STEPS, ctx)
        check(torch.equal(toks, want_toks), "phase 12 (b): batch-1 decode "
              "tokens differ from the unsharded card's")
        out["decode_rel_err"] = logit_err(last, want_last,
                                          "phase 12 (b) batch-1 decode_step")
        del sharded
    out.update(sharded_s=time.perf_counter() - t0,
               tokens=int(want_toks.numel()))
    return out


def mesh_dryrun() -> list:
    """(c) the dry run's cells over fake worlds of 256 and 512 ranks."""
    from repro_torch.launch import dryrun

    rows = []
    for arch, shape, multi in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, multi_pod=multi)
        keep = ("arch", "shape", "mesh", "chips", "flops_per_dev",
                "bytes_per_dev", "collective_bytes_per_dev", "compute_s",
                "memory_s", "collective_s", "bottleneck",
                "useful_flops_ratio")
        row = {k: r[k] for k in keep}
        row.update(collectives=r["collectives"], memory=r["memory"],
                   seconds=time.perf_counter() - t0)
        check(row["flops_per_dev"] > 0 and row["bytes_per_dev"] > 0,
              f"phase 12 (c): {arch} {shape}: nothing counted")
        rows.append(row)
        log(f"phase 12 (c) dry run {arch} {shape} {row['mesh']} "
            f"(prediction for H100s): flops/dev {row['flops_per_dev']:.4g}, "
            f"bytes/dev {row['bytes_per_dev']:.4g}, collective bytes/dev "
            f"{row['collective_bytes_per_dev']:.4g}, argument bytes/dev "
            f"{row['memory']['argument_bytes']:.4g}, peak live bytes/dev "
            f"{row['memory']['peak_live_bytes']:.4g}; compute "
            f"{row['compute_s']:.4g} s, memory {row['memory_s']:.4g} s, "
            f"collective {row['collective_s']:.4g} s ({row['bottleneck']}), "
            f"useful flops {row['useful_flops_ratio']:.3f}; "
            f"{row['seconds']:.1f} s")
    return rows


def mesh_phase(args, card: str) -> dict:
    import torch

    t0 = time.perf_counter()
    cuda = not args.rehearse
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        a = mesh_dense(args, card)
        log(f"phase 12 (a) {a['arch']} ({a['params']:,} parameters) float32 "
            f"on a {MESH_SHAPE} mesh of 4 virtual slots of {card}: logits "
            f"within {a['forward_rel_err']:.3g} of the largest, "
            f"{a['tokens']} prefill and decode tokens equal, loss "
            f"{a['loss_sharded']:.6f} against {a['loss']:.6f}, grad norm "
            f"{a['grad_norm_sharded']:.6f} against {a['grad_norm']:.6f}, "
            f"leaves within {a['leaf_rel_err']:.3g}; slot bytes: params "
            f"{a['slot_param_bytes']}, Adam {a['slot_adam_bytes']}; "
            f"unsharded {a['unsharded_s']:.1f} s, sharded "
            f"{a['sharded_s']:.1f} s")
        b = mesh_moe(args, card)
        log(f"phase 12 (b) {b['arch']} ({b['params']:,} parameters) float32 "
            f"on the same mesh: logits within {b['forward_rel_err']:.3g}, "
            f"batch-1 decode within {b['decode_rel_err']:.3g} and "
            f"{b['tokens']} tokens equal; unsharded {b['unsharded_s']:.1f} "
            f"s, sharded {b['sharded_s']:.1f} s")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    c = mesh_dryrun()
    res = {"dense": a, "moe": b, "dryrun": c,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if cuda else None),
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"model_mesh": res}))
    log(f"phase 12 (model-sharding layer): peak "
        + (f"{res['peak_gib']:.3f} GiB" if cuda else "not measured")
        + f", {res['seconds']:.1f} s")
    return res


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
    if not args.rehearse and (args.sf, args.seed) != (1.0, 0):
        print("chip_smoke: the card runs TPC-H SF 1, seed 0 (LAUNCHES_SF1)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.relational import Database

    kc, kf = kmod("compact"), kmod("filter_agg")
    from repro_torch.relational.queries import QUERIES

    dev = torch.device("cpu" if args.rehearse else "cuda")
    t_start = time.perf_counter()
    card_name = "the CPU (rehearsal)"
    if not args.rehearse:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(card)
        card_name = card
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    # -- phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    db = Database.tpch(sf=args.sf, seed=args.seed)
    log(f"tpch sf={args.sf} seed={args.seed}: lineitem "
        f"{db.table('lineitem').nrows} rows, {time.perf_counter() - t0:.1f} s")
    answers, all_records = cpu_answers(db, QUERIES)
    served = param_answers(db)
    brecords = batched_records(db)
    records = [r for r in all_records if r[0] in SLICE]
    seen = {(q, e) for q, e, _a, _k in records}
    for q, e in [("q1", "filter_agg_query"), ("q3", "compact_query"),
                 ("q6", "selective_agg_query"), ("q12", "compact_pred_query"),
                 ("q12", "filter_agg_query")]:
        check((q, e) in seen, f"{q} did not reach {e}")
    subnormal = subnormal_operands(db, dev)
    log(f"phase 2 (data and CPU answers): {time.perf_counter() - t0:.1f} s")

    # -- phase 3 ------------------------------------------------------------
    if not args.rehearse:
        t0 = time.perf_counter()
        sources = build.static_sources()
        # every generated kernel phase 5 reaches, the row layout's strided
        # instances too: sources from the CPU operands (a column's dtype
        # and stride are all the source depends on)
        for _q, e, a, _k in all_records:
            if e == "compact_pred_query":
                sources.append(kc.pred_source(a[0], a[1], a[2]))
            elif e == "selective_agg_query":
                sources.append(kf.selective_source(*a))
        s_cols, s_pred, s_vals = subnormal
        sources += [kc.pred_source(s_cols, [], s_pred),
                    kf.selective_source(s_cols, [], s_pred, s_vals, None, 1)]
        sources += [kf.selective_source(cols, [], pred, vfns, gfn, G)
                    for _l, G, cols, pred, vfns, gfn in nonfinite_cases(dev)]
        sources.append(kc.pred_source({"x": torch.zeros(1, device=dev)},
                                      [0.5], tile_predicate()))
        # the batched instances the bind-many pass reaches (one binding's
        # views: a column's dtype and stride are all the source needs)
        for _q, name, a, _k in brecords:
            if name in ("compact_pred_batched",
                        "selective_filter_agg_batched"):
                cols, _fp, _ip, kinds, pred, *rest = a
                views = {k: v[0] if v.ndim == 2 else v
                         for k, v in cols.items()}
                sources.append(
                    kc.pred_batch_source(views, kinds, pred)
                    if name == "compact_pred_batched"
                    else kf.selective_batch_source(views, kinds, pred,
                                                   *rest))
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
    for name, err in many_tile_checks(dev).items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    checks["selective_filter_agg"]["max_abs_err"] = max(
        checks["selective_filter_agg"]["max_abs_err"],
        selective_repeat_checks(records, dev))
    checks["filter_agg"]["max_abs_err"] = max(
        checks["filter_agg"]["max_abs_err"], repair_checks(db, dev))
    nonfinite_checks(dev)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # -- phase 4c -----------------------------------------------------------
    t0 = time.perf_counter()
    bchecks = batched_checks(brecords, dev, timed=not args.rehearse)
    bchecks["compact_batched"]["max_abs_err"] = max(
        bchecks["compact_batched"]["max_abs_err"], batched_race_checks(dev))
    del brecords
    log(f"batched instances: {time.perf_counter() - t0:.1f} s")

    # -- phase 4b -----------------------------------------------------------
    t0 = time.perf_counter()
    library, errs = library_phase(db, records, dev, subnormal,
                                  timed=not args.rehearse)
    for name, err in errs.items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    if not args.rehearse:
        idle = [k for k, v in library.items() if v["launches"] == 0]
        check(not idle, f"never launched on the library surface: {idle}")
    log(f"library surface: {time.perf_counter() - t0:.1f} s")

    # -- phase 5 ------------------------------------------------------------
    t0 = time.perf_counter()
    counters = {"compact": (kc.launches, "compact"),
                "compact_pred": (kc.launches, "compact_pred"),
                "filter_agg": (kf.launches, "filter_agg"),
                "selective_filter_agg": (kf.launches, "selective_filter_agg")}
    for d, k in counters.values():
        d[k] = 0
    launched, card, unsharded_ms = main_path(db, QUERIES, answers, counters,
                                             args)
    log(f"main path launches: {json.dumps(launched)}")
    if not args.rehearse:
        missing = [k for k, v in launched.items() if v == 0]
        check(not missing, f"never launched on the main path: {missing}")
    log(f"phase 5 (main path): {time.perf_counter() - t0:.1f} s")

    # -- phase 7 ------------------------------------------------------------
    t0 = time.perf_counter()
    for d, k in counters.values():
        d[k] = 0
    bcounters = {name: (kmod(spec[0]).launches, name)
                 for name, spec in BATCHED.items()}
    batched_launched = serving_path(db, served, counters, bcounters, args)
    serving_launched = {name: d[k] for name, (d, k) in counters.items()}
    log(f"serving path launches: {json.dumps(serving_launched)}")
    if not args.rehearse:
        missing = [k for k, v in serving_launched.items() if v == 0]
        check(not missing, f"never launched on the serving path: {missing}")
    log(f"phase 7 (serving path): {time.perf_counter() - t0:.1f} s")

    # -- phase 8 ------------------------------------------------------------
    t0 = time.perf_counter()
    sharded_launched, sharded_checks = sharded_path(
        db, QUERIES, card, unsharded_ms, counters, args)
    for name, c in sharded_checks.items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"],
                                          c["max_abs_err"])
    log(f"sharded path launches (opt-pallas): "
        f"{json.dumps(sharded_launched)}")
    if not args.rehearse:
        check(any(sharded_launched.values()),
              "no kernel launched on the sharded path")
    log(f"phase 8 (sharded path): {time.perf_counter() - t0:.1f} s")

    # -- phase 9 ------------------------------------------------------------
    t0 = time.perf_counter()
    fuzz_phase(args)
    log(f"phase 9 (fuzzer): {time.perf_counter() - t0:.1f} s")

    # -- phase 10 -----------------------------------------------------------
    lm_phase(args, card_name)

    # -- phase 11 -----------------------------------------------------------
    train_phase(args, card_name)

    # -- phase 12 -----------------------------------------------------------
    mesh_phase(args, card_name)

    # -- phase 6 ------------------------------------------------------------
    rows = []
    for name in ENGINE_KERNELS + LIBRARY_KERNELS:
        c = checks[name] if name in checks else library[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launched[name] if name in launched
            else c["launches"],
            "serving_launches": serving_launched.get(name),
            "sharded_launches": sharded_launched.get(name),
            "sharded_rows": sharded_checks.get(name, {}).get("rows"),
            "sharded_max_abs_err": sharded_checks.get(name, {}).get(
                "max_abs_err"),
            "max_abs_err": c["max_abs_err"], "ms": c.get("ms"),
            "device_ms": c.get("device_ms"),
            "kernels_per_call": c.get("kernels_per_call"),
            "memsets_per_call": c.get("memsets_per_call"),
            "host_ms": c.get("host_ms"),
            "plain_ms": c.get("plain_ms"),
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": c.get("library_ms"),
            "rows": c["n"], "bytes": c["bytes"],
            "path": "engine" if name in ENGINE_KERNELS
            else f"library surface ({c['shape']})"})
    for name in BATCHED:
        c = bchecks[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": SOURCES[BATCHED_OF[name]],
            "replaces": REPLACES[BATCHED_OF[name]] + " (vmapped)",
            "launches": batched_launched[name],
            "max_abs_err": c["max_abs_err"], "ms": c.get("ms"),
            "device_ms": c.get("device_ms"),
            "kernels_per_call": c.get("kernels_per_call"),
            "memsets_per_call": c.get("memsets_per_call"),
            "host_ms": c.get("host_ms"), "plain_ms": c.get("plain_ms"),
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": c.get("library_ms"),
            "rows": c["n"],
            "bindings": c["B"], "bytes": c["bytes"],
            "device_events_lost": c.get("device_events_lost"),
            "path": f"engine, batched pass ({c['query']}'s call)"})
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
