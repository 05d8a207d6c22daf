"""CUDA graph replay of the staged walk: the scalar walk cut at the
engine's entry points, and a full batched pass as one graph.

`run()`'s staged walk enqueues about ninety PyTorch operations a query
(gathers, scatters, `index_add_`, compares, sorts) around one or two
calls of the engine's hand kernels, and on an H100 the host's dispatch of
those operations, not the device, sets the pace.  Every shape in the walk
is fixed at staging (a compaction point has a static capacity) and
nothing in it reads the device, so its work can be captured once and
replayed.

The scalar walk is captured as segments: CUDA graphs cut at every call of one
of the four engine entry points of `kernels/ops.py` (`filter_agg_query`,
`compact_query`, `compact_pred_query`, `selective_agg_query`).  Their
kernels are not captured: the entry points stay eager calls on every
run, made through the `ops` module's attribute (where a profiler's
wrapper counts them) with the binding's parameters as host scalars,
which the generated kernels take by value.  The work between them is
replayed, and with it the one hand kernel that takes no runtime
parameter: the large-domain aggregation (`ops.dense_agg_query`), which
the operator calls directly, so that it runs inside a segment and is
captured there.  A replay launches it without calling its entry point
(`ops.calls` counts the capture's call only).

Capture (`capture`, from `CompiledQuery.compile`): the runtime
parameters reach the walk as 0-d views of one device buffer
(`ParamBuffer`), at each parameter's dtype (`StageCtx.param` hands a
tensor through, as in the bind-many pass).  The walk runs once on a side stream with a `Recorder`
as its engine hook (`StageCtx.kernel`), capturing into one private
memory pool.  At each entry-point call the recorder ends the segment,
replays it once so that the call reads real inputs, makes the call
eagerly, and records it as a `CallNode`: the entry point's name, the
operator span it ran under, its arguments with each parameter tensor
replaced by a `ParamRef`, and its outputs copied to tensors of fixed
address (`Outputs`), which the walk goes on with.  Then the next segment
begins.

Replay (`WalkGraph.replay`): one host-to-device copy of the binding's
parameters from a pinned buffer, segment 0, then for each call node the
entry point again with the binding's host scalars, its outputs copied
into the fixed tensors, and the next segment.  The walk's outputs are
the same tensors every replay, so one replay's result must be on the
host before the next begins (`CompiledQuery` holds a lock for that).

A batched pass (`CompiledQuery.execute_many`, the staged walk under
`torch.func.vmap`) needs no cuts: its parameters are device tensors from
the first operation to the last, and the entry points' vmap rules launch
the batched kernels with them as device vectors, on the current stream.
Nothing in a pass reads a value back to the host, and every shape in it
is fixed by the number of bindings, so a pass of N bindings is one pure
function of one parameter buffer.  `capture_pass` captures it whole, as
one graph (`PassGraph`), lazily on the query's first pass of
`compile.BATCH_MAX` bindings: the parameters as (N,) views of one
`ParamBuffer`, the kind `bind_many` fills a pass, one eager warm pass
over those views, then the pass on a side stream into a private pool.
The pool lives as long as the query, so a pass is captured only where
the device's free memory holds it twice (the graph's, and an eager pass
beside it); where it does not, the query stays on the eager pass, as
where a capture raised.  The kernel launches recorded into the graph
are kept (`PassGraph.launches`).  A replay writes the N bindings into
the buffer's pinned host side, copies it over in one copy and replays
the graph; the entry points are not called (their counters do not move)
and the pass's outputs are the same tensors every replay, under a lock
of their own (`CompiledQuery._pass_lock`).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.passes.param_binding import param_layout
from repro_torch.core.spans import span

log = logging.getLogger(__name__)

# captures that raised in this process (of a walk or of a pass); each
# such plan stays on the eager walk or pass, and each distinct reason is
# logged once
FAILURES = 0
_REASONS: set = set()
_FAIL_LOCK = threading.Lock()
# what `CUDAGraph.capture_end` warns of a capture in which nothing ran
_EMPTY = "CUDA Graph is empty"


@dataclasses.dataclass(frozen=True)
class ParamRef:
    """A runtime parameter's place among an entry point's arguments."""
    name: str


def template(obj, params: dict):
    """`obj` with every tensor that `params` (id -> parameter name) names
    replaced by its `ParamRef`, lists, tuples and dicts rebuilt, and
    everything else (other tensors, functions, literals) kept as it is."""
    if isinstance(obj, torch.Tensor):
        name = params.get(id(obj))
        return obj if name is None else ParamRef(name)
    if isinstance(obj, (list, tuple)):
        return type(obj)(template(x, params) for x in obj)
    if isinstance(obj, dict):
        return {k: template(v, params) for k, v in obj.items()}
    return obj


def fill(tmpl, values: dict):
    """`template`'s inverse under one binding: each `ParamRef` replaced by
    its host scalar in `values`."""
    if isinstance(tmpl, ParamRef):
        return values[tmpl.name]
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(fill(x, values) for x in tmpl)
    if isinstance(tmpl, dict):
        return {k: fill(v, values) for k, v in tmpl.items()}
    return tmpl


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _rebuild(obj, kept):
    if isinstance(obj, torch.Tensor):
        return next(kept)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(x, kept) for x in obj)
    return obj


class Outputs:
    """An entry point's outputs at fixed addresses.  Each allocation
    behind them (a view's contiguous base, else the output itself) is
    copied once into a tensor of its own, and `static` holds the outputs
    as views of those copies at the same offsets; `refresh(res)` copies a
    later call's allocations in, one copy each."""

    def __init__(self, res):
        self._copies: list = []     # (copy, output index, from its base)
        kept, by_base = [], {}
        for i, t in enumerate(_tensors(res)):
            base = t._base
            if base is None or not base.is_contiguous():
                s = torch.empty_like(t, memory_format=torch.contiguous_format)
                s.copy_(t)
                self._copies.append((s, i, False))
                kept.append(s)
                continue
            s = by_base.get(base.data_ptr())
            if s is None:
                s = by_base[base.data_ptr()] = torch.empty_like(base)
                s.copy_(base)
                self._copies.append((s, i, True))
            kept.append(s.as_strided(
                t.shape, t.stride(),
                t.storage_offset() - base.storage_offset()))
        self.static = _rebuild(res, iter(kept))

    def refresh(self, res) -> None:
        flat = _tensors(res)
        for s, i, whole in self._copies:
            s.copy_(flat[i]._base if whole else flat[i])


@dataclasses.dataclass
class CallNode:
    """One engine entry-point call of the captured walk."""
    name: str           # the entry point, an attribute of `kernels.ops`
    span: str           # the operator span it ran under
    args: tuple         # `template`s of its arguments
    kwargs: dict
    outputs: Optional[Outputs] = None

    def call(self, host: dict):
        """The entry point under the binding whose host scalars are
        `host`, through the module's attribute."""
        from repro_torch.kernels import ops

        return getattr(ops, self.name)(*fill(self.args, host),
                                       **fill(self.kwargs, host))


class Recorder:
    """The engine hook of the capture walk (`StageCtx.engine`): each call
    ends the segment being captured (`end`, which replays it), is made
    eagerly under the binding `host`, is recorded, and the next segment
    begins (`begin`).  `params` maps each parameter's name to the tensor
    the walk reads it from."""

    def __init__(self, params: dict, host: dict, begin: Callable,
                 end: Callable):
        self.params = {id(t): name for name, t in params.items()}
        self.host = host
        self.begin, self.end = begin, end
        self.calls: list[CallNode] = []

    def __call__(self, op_span: str, name: str, args: tuple, kwargs: dict):
        self.end()
        node = CallNode(name, op_span, template(args, self.params),
                        template(kwargs, self.params))
        node.outputs = Outputs(node.call(self.host))
        self.calls.append(node)
        self.begin()
        return node.outputs.static


class _Segments:
    """The CUDA graphs of one capture, in one private memory pool.  A
    segment in which nothing ran (an entry point at the walk's start, or
    two back to back) is None in `graphs` and never replayed.  Every
    graph is held (`held`) as long as the others: each holds a reference
    to the pool, and a pool whose references all went is not taken again
    by the allocator (its internal assert), so an empty first segment
    freed early would fail the next segment's capture."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.held: list = []
        self._open = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = g

    def end(self, replay: bool = True) -> None:
        g = self._open
        # (the filter is the process's for the moment this takes: set-up)
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            g.capture_end()
        self._open = None
        self.held.append(g)
        if any(_EMPTY in str(w.message) for w in said):
            g = None
        self.graphs.append(g)
        if replay and g is not None:
            g.replay()

    def abort(self) -> None:
        """End a capture that raised (`_abort`)."""
        g, self._open = self._open, None
        if g is not None:
            _abort(g, self.pool)


def _abort(graph, pool) -> None:
    """End a capture that raised, on its stream, so that the stream
    leaves capture mode, and end the allocator's routing to its pool
    `pool`: a void capture's `capture_end` raises before it ends that
    routing, and while the allocator counts a capture underway it gives
    no cached memory back (`torch.cuda.empty_cache`, or on running out)."""
    try:
        graph.capture_end()
    except Exception:           # noqa: BLE001 - the capture is void
        try:
            torch._C._cuda_endAllocateToPool(torch.cuda.current_device(),
                                             pool)
        except Exception:       # noqa: BLE001 - no routing was left
            pass


class ParamBuffer:
    """The runtime parameters of `n` bindings in one byte buffer, laid
    out by `param_layout(spec, n)`: on the host (page-locked where
    `pinned`, for a copy that does not hold the host) and on the device,
    where each parameter's (n,) vector is a view (`views`, by name) at a
    fixed address.  `CompiledQuery.bind_many` fills one a pass; a
    captured walk or pass keeps one, pinned."""

    def __init__(self, spec: dict, n: int, device, pinned: bool = False):
        layout, size = param_layout(spec, n)
        self.host = torch.empty(size, dtype=torch.uint8)
        on_host = torch.device(device).type == "cpu"
        self.pinned = pinned and size > 0 and not on_host
        if self.pinned:
            self.host = self.host.pin_memory()
        self.dev = self.host if on_host \
            else torch.empty(size, dtype=torch.uint8, device=device)
        raw = self.host.numpy()
        self.slots: dict = {}               # name -> (dtype, host view)
        self.views: dict = {}               # name -> (n,) device view
        for name, dt, at in layout:
            end = at + n * dt.itemsize
            self.slots[name] = (dt, raw[at:end].view(dt))
            self.views[name] = self.dev[at:end].view(getattr(torch, dt.name))

    def inputs(self) -> dict:
        """The views as a walk's `param/<name>` inputs."""
        return {f"param/{name}": v for name, v in self.views.items()}

    def write(self, merged: list[dict]) -> None:
        """Write the bindings into the host buffer."""
        for name, (dt, slot) in self.slots.items():
            slot[:] = np.asarray([m[name] for m in merged], dtype=dt)

    def send(self) -> None:
        """Copy the host buffer to the device in one copy, ordered on the
        current stream; a pinned host buffer must hold still until it
        ran."""
        if self.slots and self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=self.pinned)


class WalkGraph:
    """A captured walk: `segments` (one more than `calls`; None where
    nothing ran), the call nodes between them, the walk's outputs, and
    the parameters' buffer of one binding, where the walk reads each
    parameter as a 0-d view (`params`)."""

    def __init__(self, spec: dict, device):
        self.buf = ParamBuffer(spec, 1, device, pinned=True)
        self.params = {n: v.reshape(()) for n, v in self.buf.views.items()}
        self.segments: list = []
        self._held: list = []               # every graph, empty ones too
        self.calls: list[CallNode] = []
        self.out = self.mask = self.counts = None

    def bind(self, merged: dict) -> dict:
        """Write a binding into the buffer; its host scalars, as
        `CompiledQuery.bind` and `StageCtx.param` make them."""
        host = {}
        for n, (dt, slot) in self.buf.slots.items():
            v = np.asarray(merged[n], dtype=dt)
            slot[0] = v
            host[n] = v.item()
        return host

    def replay(self, merged: dict):
        """The walk under the binding `merged`: (columns, mask, counts),
        the same tensors every replay, on the device."""
        host = self.bind(merged)
        with span("repro.replay"), span("repro.walk"):
            self.buf.send()
            if self.segments[0] is not None:
                self.segments[0].replay()
            for node, seg in zip(self.calls, self.segments[1:]):
                with span(node.span):
                    node.outputs.refresh(node.call(host))
                if seg is not None:
                    seg.replay()
        return self.out, self.mask, self.counts


def capture(cq) -> WalkGraph:
    """Capture the unsharded CUDA query `cq`'s staged walk under its
    construction-time bindings (the module's docstring).  Raises where
    the walk cannot be captured; the device is left idle."""
    dev = cq.device
    g = WalkGraph(cq.param_spec, dev)
    host = g.bind(cq.param_defaults)
    g.buf.send()
    inputs = {**cq.resident,
              **{f"param/{n}": t for n, t in g.params.items()}}
    segs = _Segments()
    rec = Recorder(g.params, host, segs.begin, segs.end)
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            segs.begin()
            try:
                g.out, g.mask, g.counts = cq._walk(inputs, dev, engine=rec)
                segs.end(replay=False)
            except BaseException:
                segs.abort()
                raise
    finally:
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
    g.segments, g._held, g.calls = segs.graphs, segs.held, rec.calls
    return g


class PassGraph:
    """A batched pass of `n` bindings captured as one CUDA graph: the
    parameters' buffer of `n` bindings, where the pass reads each
    parameter's (n,) vector as a view (`params`, keyed by its input
    name, as `bind_many`'s), the graph, the pass's outputs, and the
    kernel launches recorded into the graph (`launches`, by each kernel
    module's counter name; what its counters moved by while the pass
    was captured, exact where no other thread launched meanwhile)."""

    def __init__(self, spec: dict, n: int, device):
        self.buf = ParamBuffer(spec, n, device, pinned=True)
        self.params = self.buf.inputs()
        self.graph = None
        self.out = self.mask = self.counts = None
        self.launches: dict = {}

    def replay(self, merged: list[dict]):
        """The pass under the bindings `merged`: (columns, mask, counts),
        the same tensors every replay, on the device."""
        self.buf.write(merged)
        with span("repro.replay"), span("repro.walk"):
            self.buf.send()
            self.graph.replay()
        return self.out, self.mask, self.counts


def _launch_counts() -> dict:
    """Every kernel module's launch counters, by counter name (the
    package's own names shadow its modules: import from each module)."""
    from repro_torch.kernels.compact import launches as compact
    from repro_torch.kernels.dense_agg import launches as dense_agg
    from repro_torch.kernels.filter_agg import launches as filter_agg

    return {**compact, **filter_agg, **dense_agg}


def pass_need(before: dict, after: dict) -> int:
    """An upper bound on the device memory a pass needed above what was
    allocated before it, from the allocator's statistics
    (`torch.cuda.memory_stats`) before and after it: the least of the
    allocator's peak since its last reset (which an earlier, larger
    allocation can hold above the pass's own) and the bytes allocated
    while it ran (which count a reused buffer each time), less what was
    allocated before it where that applies."""
    return min(after["allocated_bytes.all.peak"]
               - before["allocated_bytes.all.current"],
               after["allocated_bytes.all.allocated"]
               - before["allocated_bytes.all.allocated"])


def capture_pass(cq, merged: list[dict]) -> PassGraph:
    """Capture the unsharded CUDA query `cq`'s batched pass of the
    bindings `merged` (the module's docstring): one eager warm pass over
    the parameter views, then the pass on a side stream into a private
    pool, in thread-local mode (a cold query may stage on another thread
    meanwhile).  The pool keeps what the pass allocates for as long as
    the query lives, so the pass is captured only where the device's
    free memory holds it twice, the graph's and an eager pass's beside
    it, its need bounded by the warm pass (`pass_need`).  Raises where
    the pass cannot be captured or has no room; the device is left
    idle."""
    dev = cq.device
    g = PassGraph(cq.param_spec, len(merged), dev)
    g.buf.write(merged)
    g.buf.send()
    before = torch.cuda.memory_stats(dev)
    cq.execute_many(g.params)
    need = pass_need(before, torch.cuda.memory_stats(dev))
    free, _total = torch.cuda.mem_get_info(dev)
    if free < 2 * need:
        raise RuntimeError(f"no room for the pass's graph: the pass needs "
                           f"up to {need} B, twice that is more than the "
                           f"device's {free} B free")
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    pool = torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                launched = _launch_counts()
                g.out, g.mask, g.counts = cq.execute_many(g.params)
                g.launches = {k: v - launched[k]
                              for k, v in _launch_counts().items()
                              if v != launched[k]}
            except BaseException:
                _abort(graph, pool)
                raise
            graph.capture_end()
    finally:
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
    g.graph = graph
    return g


def failed(err: BaseException) -> None:
    """Count a capture that raised, and log its reason the first time."""
    global FAILURES
    first = str(err).splitlines()[:1]
    reason = f"{type(err).__name__}: {first[0] if first else ''}"
    with _FAIL_LOCK:
        FAILURES += 1
        new = reason not in _REASONS
        _REASONS.add(reason)
    if new:
        log.warning("CUDA graph capture of a staged walk or pass failed; "
                    "the plan stays eager there: %s", reason, exc_info=err)
