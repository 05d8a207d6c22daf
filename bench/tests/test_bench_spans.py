"""The program's spans in the traced run (`bench/spans.py`) on the CPU:
the reduction of a trace's events to `spans`, `requests` and
`idle_by_span` on a timeline built by hand; the same on a short traced
run of the embedded client, where `idle_by_span` adds up to the
stretch's idle time and the `Summary`'s own fields and the readers that
were there before read what they read without the wrapper; and the new
readers, which read nothing where the program emits no span."""
import time
import types

import pytest
import torch

from bench import harness, manifest, spans, trace
from bench.gen import tpch_requests as gen
from bench.tests import runs

NEW = ("walk_host_ms.adhoc", "result_host_ms.adhoc",
       "idle_in_walk_pct.adhoc", "idle_in_result_pct.adhoc")
OLD = ("kernels_per_query.adhoc", "engine_kernels_roofline.adhoc",
       "device_idle_pct.adhoc")


def _event(name, a, b, device=False, annotation=False, thread=1):
    kind = torch.autograd.DeviceType.CUDA if device \
        else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, thread=thread, device_type=kind,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=float(a), end=float(b)))


# a stretch of 120 us: one request wholly inside it, its walk with two
# operators, the count read and the decode; two kernels, and the walk's
# span on the device timeline, which is no operation; a walk outside any
# request, and a request the stretch's end cuts
TIMELINE = [
    _event("bench.request.q1", 0, 100),
    _event("repro.walk", 10, 50),
    _event("repro.op.Agg", 12, 45),
    _event("repro.op.Scan", 15, 20),
    _event("repro.counts", 55, 70),
    _event("repro.result.decode", 75, 90),
    _event("repro.walk", 102, 110),
    _event("bench.request.q3", 101, 130),
    _event("kernel_a", 20, 30, device=True),
    _event("kernel_b", 60, 68, device=True),
    _event("repro.walk", 10, 50, device=True, annotation=True),
]


def test_spans_and_idle_by_span_on_a_timeline_by_hand():
    got = spans.reduce(TIMELINE, 120.0)
    assert got.requests == 1 and got.device_named == 0
    want = {"repro.walk": [1, 40, 7], "repro.op.Agg": [1, 33, 28],
            "repro.op.Scan": [1, 5, 5], "repro.counts": [1, 15, 15],
            "repro.result.decode": [1, 15, 15]}
    assert got.spans == {k: [n, pytest.approx(s * 1e-6),
                             pytest.approx(o * 1e-6)]
                         for k, (n, s, o) in want.items()}
    # idle: [0, 20], [30, 60], [68, 120]
    idle = {"none": 10 + 5 + 5 + 22, "repro.walk": 2 + 5 + 8,
            "repro.op.Agg": 3 + 15, "repro.op.Scan": 5,
            "repro.counts": 5 + 2, "repro.result.decode": 15}
    assert got.idle_by_span == {k: pytest.approx(v * 1e-6)
                                for k, v in idle.items()}
    assert sum(got.idle_by_span.values()) == pytest.approx(102e-6)


def _traced(pdb, program_spans: bool, n: int = 20):
    """A short traced run of the embedded client on the CPU: its Summary
    with the wrapper and without it, from one trace."""
    from repro_torch.core import spans as program

    spans.install()
    cell = manifest.load("adhoc-power")
    client = cell.client.Client(cell.config, pdb, cell.traffic, gen,
                                torch.device("cpu"))
    client.stage()
    source = gen.Requests(cell.traffic, 5, 0)
    tracer = trace.Tracer(torch.device("cpu"))
    saved = program._profiler
    if not program_spans:       # as the program before the spans
        program._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        tracer.start(time.monotonic())
        for _ in range(n):
            q, params = source.next()
            with torch.profiler.record_function(trace.REQUEST + q):
                client.submit(q, params, lambda answer, error: None)
        tracer.stop()
    finally:
        program._profiler = saved
        client.close()
    prof = tracer._prof
    got = tracer.summary()
    tracer._prof = prof
    plain = trace.Tracer.summary.__wrapped__(tracer)
    return got, plain


def _run(summary):
    return harness.Run(0.0, 1.0, [], {}, {}, summary)


@pytest.fixture(scope="module")
def pdb():
    from repro_torch.relational import Database

    from bench import tpchgen

    return Database.from_arrays(tpchgen.generate(0.01, 3))


def test_a_short_traced_run_on_the_cpu(pdb):
    got, plain = _traced(pdb, True)
    assert got.requests == 20
    assert got.spans["repro.walk"][0] == 20
    assert got.spans["repro.result.decode"][0] >= 20
    assert any(k.startswith("repro.op.") for k in got.spans)
    for count, seconds, own in got.spans.values():
        assert count > 0 and 0 <= own <= seconds
    assert sum(got.idle_by_span.values()) == pytest.approx(
        got.window_s - got.busy_s)
    assert not hasattr(plain, "spans")
    layer = {m.name: m for m in manifest.load("adhoc-power").per_layer}
    for f in trace.Summary.__dataclass_fields__:
        assert getattr(got, f) == getattr(plain, f), f
    for name in OLD:
        assert layer[name].read(_run(got)) == layer[name].read(_run(plain))
    for name in NEW:
        assert layer[name].read(_run(got)) is not None, name
        assert layer[name].read(_run(plain)) is None, name
    walk = layer["walk_host_ms.adhoc"].read(_run(got))
    result = layer["result_host_ms.adhoc"].read(_run(got))
    assert walk + result <= 1e3 * got.window_s / got.requests
    idle = layer["device_idle_pct.adhoc"].read(_run(got))
    assert layer["idle_in_walk_pct.adhoc"].read(_run(got)) \
        + layer["idle_in_result_pct.adhoc"].read(_run(got)) <= idle + 1e-9


def test_the_new_readers_read_nothing_without_the_programs_spans(pdb):
    got, _plain = _traced(pdb, False, n=5)
    assert got.spans == {} and got.requests == 5
    assert set(got.idle_by_span) == {"none"}
    layer = {m.name: m for m in manifest.load("adhoc-power").per_layer}
    for name in NEW:
        assert layer[name].read(_run(got)) is None, name
        assert layer[name].read(_run(None)) is None, name
    assert layer["device_idle_pct.adhoc"].read(_run(got)) == \
        pytest.approx(100.0)


def test_a_traced_cpu_run_reports_the_span_metrics():
    r = runs.run_python(
        "import json, time\n"
        "from bench import harness\n"
        "r = harness.execute('adhoc-power', 2147483659, 0.5, True, "
        "t_start=time.monotonic(), device='cpu', scale=0.01)\n"
        "print(json.dumps(r['metrics']))\n")
    assert set(NEW) <= set(r)
    assert r["idle_in_walk_pct.adhoc"]["value"] \
        + r["idle_in_result_pct.adhoc"]["value"] \
        <= r["device_idle_pct.adhoc"]["value"] + 1e-9
