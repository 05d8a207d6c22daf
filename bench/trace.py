"""The traced run: `torch.profiler` over a stretch of the window, the
engine entry points wrapped to record the bytes each call must move, and
the reduction of the trace to what the per-layer readers read.

The profiler records the host spans of the thread that sends the traffic
(`bench.request.<query>` around each request it sends; the server's own
threads are not recorded) and every operation on the device.  The four
engine entry points of `repro_torch.kernels.ops`, which the engine's
operators reach through the module's attribute at call time, are wrapped
to count each call and the bytes it must move.  The engine's kernels are
the port's hand-written ones (in its `repro::` CUDA namespace; the
library-only kernels, never called by the engine, live elsewhere), so
their device time is read from the trace by name.  Each engine call
launches at least one of them: where the trace holds fewer launches than
the wrapper counted calls, the profiler lost some, and the bytes are
reckoned for as many calls as it saw.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from bench import roofline

REQUEST = "bench.request."
ENGINE_KERNELS = "repro::"     # the namespace of the port's hand kernels


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_annotation(e) -> bool:
    """A host span's stretch on the device timeline, not an operation."""
    return getattr(e, "is_user_annotation", False) \
        or e.name.startswith("bench.")


def _is_kernel(e) -> bool:
    return not e.name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Summary:
    """What the trace says, in seconds."""
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list        # [[name, seconds]], the ten that took most
    idle_gaps: list         # [[what the host did, seconds]], the ten longest
    engine_calls: int       # calls the wrapper counted in the stretch
    engine_launches: int    # the engine's kernels the trace holds
    engine_bound_s: float   # the calls' least time at the HBM peak
    engine_device_s: float  # the engine kernels' device time
    t0: float               # the window's start and end on the host clock
    t1: float


class Tracer:
    """Profiles one stretch of the window; `summary` reduces it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._recording = False
        self._calls: list = []              # bytes of each call
        self._saved: dict = {}
        self.t0 = self.t1 = 0.0

    @property
    def active(self) -> bool:
        """Is the profiler recording now?"""
        return self._recording

    def warm(self) -> None:
        """Start the profiler once in set-up, so that the window's start
        does not pay for initialising it."""
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def install(self) -> None:
        """Wrap the four engine entry points."""
        from repro_torch.kernels import ops

        for name, nbytes in roofline.ENTRY_POINTS.items():
            fn = getattr(ops, name)
            self._saved[name] = fn
            setattr(ops, name, self._wrap(fn, nbytes))

    def uninstall(self) -> None:
        from repro_torch.kernels import ops

        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        self._saved.clear()

    def _wrap(self, fn, nbytes):
        def call(*args, **kwargs):
            if self.active:
                self._calls.append(nbytes(*args, **kwargs))
            return fn(*args, **kwargs)
        return call

    def start(self, now: float) -> None:
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self._recording = True
        self.t0 = now

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.monotonic()
        self._recording = False
        self._prof.stop()

    def summary(self) -> Summary:
        events = list(self._prof.events())
        self._prof = None
        window_us = (self.t1 - self.t0) * 1e6
        device = [e for e in events
                  if _is_device(e) and not _is_annotation(e)]
        busy = _union([[max(e.time_range.start, 0.0),
                        min(e.time_range.end, window_us)] for e in device
                       if e.time_range.end > 0
                       and e.time_range.start < window_us])
        busy_us = sum(b - a for a, b in busy)
        by_name: dict = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        edges = [[0.0, 0.0]] + busy + [[window_us, window_us]]
        for (_a, b), (c, _d) in zip(edges, edges[1:]):
            if c > b:
                gaps.append((c - b, b, c))
        gaps = sorted(gaps, reverse=True)[:10]
        host = [e for e in events if not _is_device(e)
                and not e.name.startswith("cuda")]
        idle = [[self._doing(host, (b + c) / 2), length * 1e-6]
                for length, b, c in gaps]
        engine = [e for e in device if ENGINE_KERNELS in e.name]
        calls = len(self._calls)
        nbytes = sum(self._calls)
        if 0 < len(engine) < calls:
            nbytes = nbytes * len(engine) / calls
        return Summary(window_us * 1e-6, busy_us * 1e-6,
                       sum(1 for e in device if _is_kernel(e)),
                       [[n[:120], s] for n, s in top], idle, calls,
                       len(engine), roofline.bound_s(nbytes),
                       sum(e.time_range.end - e.time_range.start
                           for e in engine) * 1e-6, self.t0, self.t1)

    @staticmethod
    def _doing(host: list, t_us: float) -> str:
        """The innermost host span running at `t_us`, with the benchmark's
        request span around it where there is one."""
        inner, request = None, None
        for e in host:
            if e.time_range.start <= t_us <= e.time_range.end:
                if e.name.startswith(REQUEST):
                    request = e.name[len(REQUEST):]
                if inner is None or e.time_range.start > \
                        inner.time_range.start:
                    inner = e
        name = "no host span" if inner is None else inner.name
        return name if request is None else f"{request}: {name}"[:120]
