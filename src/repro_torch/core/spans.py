"""Named host spans of the query path, recorded by `torch.profiler`.

`span(name)` is a context manager.  While a profiler records, it is
`torch.profiler.record_function(name)`: the span lands in the profiler's
trace on the same timeline as the device's operations, so a stretch in
which the device sat idle can be put down to the span the host was in.
Otherwise it is one shared null context, and the only cost is the test
of the profiler's own flag (a module attribute read, well under a
microsecond), so the spans stay in the query path for good.  There is no
switch, buffer or clock here: the profiler is the recorder.

The names (`repro.` and then the layer):

  repro.replay           a replay of the walk captured as CUDA graphs,
                         or of a full batched pass captured as one
                         (`core/graphs.py`), around its `repro.walk`
  repro.walk             the staged walk's enqueue (`CompiledQuery._walk`),
                         or its replay's
  repro.op.<Node>        one operator's staging, nested as the plan is
  repro.counts           the one blocking read of the compaction counts
  repro.result.copy      the answer's device-to-host copy
  repro.result.decode    the host decode of codes, chars and words
  repro.rerun            an overflowed binding's re-run through the twin
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` while a profiler records, else a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
