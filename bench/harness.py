"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Set-up: the data from the seed (`tpchgen`), handed to the program
(`Database.from_arrays`), the cell's plans staged by its client, then the
traffic itself for the mix's `warmup_s`.  The window follows without a
pause: the same loop goes on sending, and the requests due in the window
are the ones measured.  Once the window has closed, every answer due in
it is awaited (`DRAIN_S` past the close at most), the device's peak is
read, the program is closed and freed, and the reference recomputes the
answers of a sample of the window's bindings, drawn from the seed.

With `trace`, the last `TRACE_S` seconds of the window run under the
profiler with the engine's entry points wrapped (`bench/trace.py`); such
a run reports the per-layer metrics, the others the end-to-end ones.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import queue
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import compare, manifest, reference, tpchgen
from bench.trace import REQUEST, Tracer

TRACE_S = 3.0           # the traced stretch, at the end of the window
DRAIN_S = 60.0          # how long an answer may come after the close
CHECK_STREAM = 2        # the seed's stream that draws the checked sample
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}   # top-level module names

BUILD_DIR = manifest.ROOT / "src" / "repro_torch" / "kernels" / "_build"


class Failed(RuntimeError):
    """The run cannot give a result."""


@dataclasses.dataclass
class Request:
    query: str
    params: dict | None
    due: float
    sent: float = math.nan
    done: float = math.nan
    answer: dict | None = None
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.answer is not None and self.error is None


@dataclasses.dataclass
class Run:
    """What a run recorded; the metric readers read it."""
    t_open: float
    t_close: float
    requests: list
    setup: dict
    counters: dict
    trace: object = None

    def due(self) -> list:
        return [r for r in self.requests
                if self.t_open <= r.due < self.t_close]

    def completed(self) -> list:
        return [r for r in self.requests
                if r.ok and self.t_open <= r.done <= self.t_close]


def libraries() -> int:
    """Kernel libraries the program has built in this checkout."""
    return len(list(BUILD_DIR.glob("*.so"))) if BUILD_DIR.is_dir() else 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Events:
    """Things to do once the host clock passes their time, in order."""

    def __init__(self, items: list):
        self.items = sorted(items, key=lambda x: x[0])

    def tick(self, now: float) -> None:
        while self.items and self.items[0][0] <= now:
            self.items.pop(0)[1]()

    def next_at(self) -> float:
        return self.items[0][0] if self.items else math.inf


class Loop:
    """Sends a traffic mix's requests through a client until `t_stop`."""

    def __init__(self, client, traffic: dict, generator, seed: int,
                 tracer):
        self.client, self.traffic, self.gen = client, traffic, generator
        self.seed = seed
        self.requests: list = []
        self.source = generator.Requests(traffic, seed, 0)
        self.answered: queue.SimpleQueue = queue.SimpleQueue()
        self.tracer = tracer

    def _send(self, due: float) -> None:
        q, params = self.source.next()
        r = Request(q, params, due)
        self.requests.append(r)

        def done(answer, error):
            r.done = time.monotonic()
            r.answer, r.error = answer, error
            self.answered.put(r)

        r.sent = time.monotonic()
        if self.tracer is not None and self.tracer.active:
            with torch.profiler.record_function(REQUEST + q):
                self.client.submit(q, params, done)
        else:
            self.client.submit(q, params, done)

    def run(self, t_begin: float, t_stop: float, events: Events) -> None:
        kind = self.traffic["loop"]
        if kind == "stream":
            now = time.monotonic()
            while now < t_stop:
                events.tick(now)
                self._send(now)
                now = time.monotonic()
        elif kind == "closed":
            for _ in range(int(self.traffic["outstanding"])):
                self._send(time.monotonic())
            while True:
                now = time.monotonic()
                events.tick(now)
                if now >= t_stop:
                    break
                try:
                    self.answered.get(timeout=max(
                        0.0, min(events.next_at(), t_stop) - now))
                except queue.Empty:
                    continue
                self._send(time.monotonic())
        elif kind == "open":
            for offset in self.gen.arrivals(self.traffic, self.seed, 0):
                due = t_begin + offset
                if due >= t_stop:
                    break
                while True:
                    now = time.monotonic()
                    events.tick(now)
                    wake = min(due, events.next_at())
                    if now >= due:
                        break
                    time.sleep(max(0.0, wake - now))
                self._send(due)
        else:
            raise ValueError(f"unknown loop {kind!r}")
        events.tick(time.monotonic())

    def drain(self, deadline: float) -> None:
        """Wait until every request sent has answered, or `deadline`."""
        while any(math.isnan(r.done) for r in self.requests):
            if time.monotonic() >= deadline:
                return
            time.sleep(0.01)


def _freeze(params: dict | None) -> tuple:
    return tuple(sorted((params or {}).items()))


def check(run: Run, arrays: dict, limits: dict, check_max: int, seed: int,
          device) -> dict:
    """The numbers the run is judged by, each `(value, limit)`."""
    due = run.due()
    missing = [r for r in due if not r.ok]
    groups: dict = {}
    for r in due:
        if r.ok:
            groups.setdefault((r.query, _freeze(r.params)), []).append(r)
    keys = sorted(groups)
    rng = np.random.default_rng([int(seed), CHECK_STREAM])
    rng.shuffle(keys)
    slowest = {}
    for key, rs in groups.items():
        worst = max(r.done - r.due for r in rs)
        if key[0] not in slowest or worst > slowest[key[0]][0]:
            slowest[key[0]] = (worst, key)
    chosen = list(dict.fromkeys([k for _t, k in slowest.values()] + keys))
    chosen = chosen[:max(check_max, len(slowest))]
    ref = reference.Reference(arrays, device)
    wrong, gap, checked, first = len(missing), 0.0, 0, None
    if missing:
        first = f"{missing[0].query}: {missing[0].error!r}"
    for key in chosen:
        q, params = key[0], dict(key[1]) or None
        want = ref.answer(q, params)
        for r in groups[key]:
            why, g = compare.judge(r.answer, want, reference.SORT[q],
                                   reference.FLOAT_COLUMNS[q],
                                   reference.limit(q, params))
            checked += 1
            gap = max(gap, g)
            if why is not None:
                wrong += 1
                first = first or f"{q} {params}: {why}"
    if first:
        log(f"check: first wrong answer: {first}")
    log(f"check: {checked} answers of {len(chosen)} bindings compared, of "
        f"{len(due)} requests due in the window")
    return {"answers_wrong": (wrong, limits["answers_wrong"]),
            "float_gap": (gap, limits["float_gap"])}


def _json_number(v: float) -> float:
    return sys.float_info.max if math.isinf(v) else float(v)


def set_up(cell, seed: int, dev: torch.device, scale: float | None,
           t_start: float) -> tuple:
    """The data, the program over it and the cell's plans staged:
    (arrays, client, seconds of each step)."""
    setup: dict = {"start_s": time.monotonic() - t_start}
    t = time.monotonic()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    setup["cuda_init_s"] = time.monotonic() - t
    t = time.monotonic()
    arrays = tpchgen.generate(scale if scale is not None
                              else cell.config["scale_factor"], seed)
    setup["generate_s"] = time.monotonic() - t

    from repro_torch.relational import Database

    t = time.monotonic()
    db = Database.from_arrays(arrays)
    setup["load_s"] = time.monotonic() - t
    libs0 = libraries()
    client = cell.client.Client(cell.config, db, cell.traffic,
                                cell.generator, dev)
    t = time.monotonic()
    client.stage()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["stage_s"] = time.monotonic() - t
    setup["libraries_built"] = libraries() - libs0
    return arrays, client, setup


def measure(cell, client, traffic: dict, seed: int, seconds: float,
            dev: torch.device, tracer=None) -> tuple:
    """The mix's warm-up, then its window: (the Loop, its Run, the device's
    peak before the window, the window's peak)."""
    loop = Loop(client, traffic, cell.generator, seed, tracer)
    marks: dict = {"peak_setup": 0}

    def open_window():
        marks["counters"] = client.counters()
        if dev.type == "cuda":
            marks["peak_setup"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)

    t_begin = time.monotonic()
    t_open = t_begin + float(traffic.get("warmup_s", 0.0))
    t_close = t_open + seconds
    events = [(t_open, open_window)]
    if tracer is not None:
        events.append((max(t_open, t_close - TRACE_S),
                       lambda: tracer.start(time.monotonic())))
    loop.run(t_begin, t_close, Events(events))
    if tracer is not None:
        tracer.stop()
    counters = {k: v - marks["counters"].get(k, 0)
                for k, v in client.counters().items()}
    loop.drain(t_close + DRAIN_S)
    peak_window = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    run = Run(t_open, t_close, loop.requests, {}, counters)
    return loop, run, marks["peak_setup"], peak_window


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_start: float, device: str = "cuda", scale: float | None = None,
            root: Path = manifest.ROOT) -> dict:
    """One run; returns the result line's object.  `scale` replaces the
    configuration's scale factor (CPU tests only)."""
    cell = manifest.load(workload, root, root / "bench")
    dev = torch.device(device)
    arrays, client, setup = set_up(cell, seed, dev, scale, t_start)
    tracer = Tracer(dev) if trace else None
    if tracer is not None:
        tracer.warm()
        tracer.install()
    libs0 = libraries()
    loop, run, peak_setup, peak_window = measure(
        cell, client, cell.traffic, seed, seconds, dev, tracer)
    setup["warmup_s"] = float(cell.traffic.get("warmup_s", 0.0))
    setup["setup_s"] = run.t_open - t_start
    setup["libraries_built"] += libraries() - libs0
    setup["host_cpus"] = len(os.sched_getaffinity(0))
    run.setup = setup
    summary = tracer.summary() if tracer is not None else None
    if tracer is not None:
        tracer.uninstall()
    run.trace = summary
    client.close()
    del client, loop.client
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log("setup: " + ", ".join(
        f"{k} {v}" for k, v in setup.items()) + " (the device copy of the "
        "columns is inside stage_s)")
    due = run.due()
    failed = sum(1 for r in due if not r.ok)
    lag = [r.sent - r.due for r in due]
    log(f"window: {seconds} s, {len(due)} requests due, "
        f"{len(run.completed())} answered inside it, {failed} failed, "
        f"sender late by {max(lag, default=0.0)} s at most; device peak "
        f"memory of the window {peak_window} B (reported), of the set-up "
        f"{peak_setup} B")
    slices = [0] * max(1, math.ceil(seconds / 2))
    for r in run.completed():
        slices[min(len(slices) - 1, int((r.done - run.t_open) // 2))] += 1
    log("answered a second, by 2 s of the window: " + " ".join(
        f"{n / min(2.0, seconds - 2 * i):g}" for i, n in enumerate(slices)))
    log("counters over the window: " + json.dumps(run.counters))
    if summary is not None:
        log(f"trace: {summary.window_s} s traced, device busy "
            f"{summary.busy_s} s, {summary.kernels} kernels; the wrapper "
            f"counted {summary.engine_calls} engine calls and the trace "
            f"holds {summary.engine_launches} engine kernel launches" + (
                " (fewer: the bytes are reckoned for as many calls)"
                if 0 < summary.engine_launches < summary.engine_calls
                else ""))

    checks = check(run, arrays, cell.config["limits"],
                   int(cell.config.get("check_max_bindings", 400)), seed,
                   dev)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": _json_number(v), "unit": m.unit}
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        raise Failed(f"modules loaded that the benchmark must not load: "
                     f"{loaded}")
    correct = all(v <= lim for v, lim in checks.values())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    result = {"correct": correct, "attempted": len(due), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(peak_window)}}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": _json_number(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"{k} {v} limit {lim}")
    return result
