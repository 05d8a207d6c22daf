"""The benchmark's arithmetic on what a run recorded: rates, tails and
shares.  Every rate is all the work of the window over all its time, and
every tail is the tail of all the requests due in it."""
from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The `q`-th percentile (0 to 100) of all `values`, linear between
    the two nearest ranks; an infinite value (a request that failed)
    counts as beyond every other."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_ms(run) -> list:
    """Due time to answer, in ms, of every request due in the window; a
    request that failed or never answered is infinite."""
    return [(r.done - r.due) * 1e3 if r.ok else math.inf for r in run.due()]


def completed_per_s(run) -> float:
    """Requests answered inside the window, over its seconds."""
    return len(run.completed()) / (run.t_close - run.t_open)


def idle_pct(trace) -> float | None:
    """The share of the traced stretch in which no device operation ran."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def roofline_pct(trace) -> float | None:
    """The engine calls' least time at the HBM peak over their device
    time, for the calls the profiler linked kernels to; nothing where it
    linked none."""
    if trace is None or trace.engine_device_s <= 0:
        return None
    return 100.0 * trace.engine_bound_s / trace.engine_device_s


def per_batch(run) -> float | None:
    """Requests a dispatched group carried over the window."""
    batches = run.counters.get("batches", 0)
    if batches <= 0:
        return None
    return run.counters["completed"] / batches
