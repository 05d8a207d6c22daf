"""The program's own host spans in the traced stretch.

The port names the parts of its query path with `record_function` spans
while a profiler records (`repro_torch.core.spans`): `repro.walk`,
`repro.op.<Node>`, `repro.counts`, `repro.result.copy`,
`repro.result.decode`, `repro.rerun`.  They land in the same trace as
the device's operations, on its clock.  `reduce` reads them from the
trace's events:

  spans         name -> [count, seconds, self seconds] of every `repro.`
                span nested in a request span (`bench.request.<query>`)
                that lies wholly inside the stretch; a span's self
                seconds are its seconds less those of the `repro.` spans
                directly inside it
  requests      the number of those request spans
  idle_by_span  name -> the seconds of the stretch in which no device
                operation ran and that span was the host's innermost
                `repro.` span open, "none" where none was; they add up
                to the stretch's idle time, `window_s - busy_s`

`install` wraps `Tracer.summary` so that the `Summary` it returns
carries the three as attributes of the same names; the readers of the
span metrics call it when they are loaded, before the run.  The
`Summary`'s own fields are computed as before.  A program that emits no
such span (one older than the spans) gives empty `spans` and
`idle_by_span` with "none" alone, and the readers then read nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import json
import sys

from bench import trace

PREFIX = "repro."
NONE = "none"


@dataclasses.dataclass
class Spans:
    spans: dict
    requests: int
    idle_by_span: dict
    device_named: int       # device operations the trace names `repro.`


def _idle(events, window_us: float) -> list:
    """The stretch's idle intervals: the complement of the device's busy
    ones, as `Tracer.summary` reckons them."""
    device = [e for e in events
              if trace._is_device(e) and not trace._is_annotation(e)]
    busy = trace._union([[max(e.time_range.start, 0.0),
                          min(e.time_range.end, window_us)] for e in device
                         if e.time_range.end > 0
                         and e.time_range.start < window_us])
    edges = [[0.0, 0.0]] + busy + [[window_us, window_us]]
    return [(b, c) for (_a, b), (c, _d) in zip(edges, edges[1:]) if c > b]


def _innermost(program: list, window_us: float) -> list:
    """The stretch cut where a `repro.` span opens or closes:
    [(start, end, the innermost span open there or NONE)]."""
    points = sorted({0.0, window_us}
                    | {min(max(t, 0.0), window_us) for e in program
                       for t in (e.time_range.start, e.time_range.end)})
    opening = sorted(program, key=lambda e: e.time_range.start)
    out, open_, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(opening) and opening[i].time_range.start <= a:
            open_.append(opening[i])
            i += 1
        open_ = [e for e in open_ if e.time_range.end > a]
        inner = max(open_, key=lambda e: (e.time_range.start,
                                          -e.time_range.end), default=None)
        out.append((a, b, NONE if inner is None else inner.name))
    return out


def _nested(program: list, requests: list) -> list:
    """The program spans inside a request span of their thread (a
    thread's request spans follow one another)."""
    by_thread: dict = {}
    for r in sorted(requests, key=lambda r: r.time_range.start):
        starts, ends = by_thread.setdefault(r.thread, ([], []))
        starts.append(r.time_range.start)
        ends.append(r.time_range.end)
    out = []
    for e in program:
        starts, ends = by_thread.get(e.thread, ((), ()))
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= ends[i]:
            out.append(e)
    return out


def _totals(spans: list) -> dict:
    """name -> [count, seconds, self seconds]."""
    out: dict = {}
    child_us: dict = {}
    stack: dict = {}                     # thread -> the spans open
    for e in sorted(spans, key=lambda e: (e.time_range.start,
                                          -e.time_range.end)):
        st = stack.setdefault(e.thread, [])
        while st and (st[-1].time_range.end < e.time_range.end
                      or st[-1].time_range.end <= e.time_range.start):
            st.pop()
        if st:
            child_us[id(st[-1])] = child_us.get(id(st[-1]), 0.0) \
                + e.time_range.end - e.time_range.start
        st.append(e)
    for e in spans:
        us = e.time_range.end - e.time_range.start
        t = out.setdefault(e.name, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += us * 1e-6
        t[2] += (us - child_us.get(id(e), 0.0)) * 1e-6
    return out


def reduce(events, window_us: float) -> Spans:
    """The program spans of a trace whose stretch is [0, window_us] on
    the profiler's clock, in microseconds."""
    host = [e for e in events if not trace._is_device(e)]
    program = [e for e in host if e.name.startswith(PREFIX)]
    requests = [e for e in host if e.name.startswith(trace.REQUEST)
                and e.time_range.start >= 0
                and e.time_range.end <= window_us]
    idle_by: dict = {}
    cuts = _innermost(program, window_us)
    j = 0
    for a, b in _idle(events, window_us):
        while j < len(cuts) and cuts[j][1] <= a:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < b:
            lo, hi = max(a, cuts[k][0]), min(b, cuts[k][1])
            if hi > lo:
                idle_by[cuts[k][2]] = idle_by.get(cuts[k][2], 0.0) \
                    + (hi - lo) * 1e-6
            k += 1
    named = sum(1 for e in events if trace._is_device(e)
                and not trace._is_annotation(e)
                and e.name.startswith(PREFIX))
    return Spans(_totals(_nested(program, requests)), len(requests),
                 idle_by, named)


def install() -> None:
    """Wrap `Tracer.summary` once (see the module's docstring); the
    wrapper's `__wrapped__` is the summary it wraps."""
    summary = trace.Tracer.summary
    if hasattr(summary, "__wrapped__"):
        return

    @functools.wraps(summary)
    def with_spans(self):
        prof = self._prof
        s = summary(self)
        got = reduce(prof.events(), (self.t1 - self.t0) * 1e6)
        s.spans, s.requests = got.spans, got.requests
        s.idle_by_span = got.idle_by_span
        print(f"spans: {got.requests} requests wholly in the stretch; "
              f"device operations named {PREFIX}*: {got.device_named}; "
              f"idle seconds by innermost program span "
              f"{json.dumps(dict(sorted(got.idle_by_span.items())))}; "
              f"[count, seconds, self seconds] by span "
              f"{json.dumps(dict(sorted(got.spans.items())))}",
              file=sys.stderr, flush=True)
        return s

    trace.Tracer.summary = with_spans


def host_ms(summary, *names: str) -> float | None:
    """Milliseconds a request in the spans `names`; nothing where the
    trace holds none of them."""
    spans = getattr(summary, "spans", None)
    if not spans or not any(n in spans for n in names) \
            or not summary.requests:
        return None
    return 1e3 * sum(spans[n][1] for n in names if n in spans) \
        / summary.requests


def idle_pct(summary, match) -> float | None:
    """The share of the stretch idle while the host's innermost program
    span was one that `match(name)` accepts; nothing where the trace
    holds no program span at all."""
    spans = getattr(summary, "spans", None)
    if not spans or summary.window_s <= 0:
        return None
    return 100.0 * sum(s for n, s in summary.idle_by_span.items()
                       if match(n)) / summary.window_s
