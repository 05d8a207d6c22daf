"""CUDA graph replay of the scalar staged walk (`core/graphs.py`) where it
runs on the CPU, at sf 0.01, seed 0: a query on the CPU never captures
and its answers are unchanged by `compile()`; the recording of the
engine's entry-point calls and the substitution of the parameters, which
are plain Python; the fixed-address outputs; and the walk with its
parameters as 0-d tensors and a recorder at its entry points (as a
capture runs it), which gives the answers of the walk with host
scalars, bit for bit.  The card's capture and replay are held to the
eager walk in `test_torch_graph_cuda.py`."""
import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, graphs, preset
from repro_torch.core.operators import fused as fu
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.relational import Database
from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                            PARAM_QUERIES, QUERIES)

# the engine entry points each plan's walk calls at opt-pallas, with the
# span of the operator that calls it
CALLS = {
    "q1": [("selective_agg_query", "repro.op.Agg")],
    "q3": [("compact_query", "repro.op.Compact")] * 2,
    "q6": [("selective_agg_query", "repro.op.Agg")],
    "q12": [("compact_pred_query", "repro.op.Compact"),
            ("filter_agg_query", "repro.op.Agg")],
    "q14": [("filter_agg_query", "repro.op.Agg")],
    "q19": [("filter_agg_query", "repro.op.Agg")],
}


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _param_query(pdb, qname):
    build, defaults = PARAM_QUERIES[qname]
    plan = build()
    spec = plan_params(plan)
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    return CompiledQuery(plan, pdb, preset("opt-pallas"), params=runtime,
                         device="cpu"), runtime


@pytest.mark.parametrize("rung", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q9full", "q12",
                                   "q13", "q19"])
def test_a_query_on_the_cpu_never_captures(pdb, qname, rung):
    cq = CompiledQuery(QUERIES[qname](), pdb, preset(rung), device="cpu")
    want = cq.run()
    cq.compile()
    got = [cq.run(), cq.run_many([None])[0]]
    assert cq.graph_segments == 0 and cq.n_replays == 0
    assert cq.capture_error is None and cq.n_executions == 3
    for g in got:
        _bits(g, want)


def test_template_and_fill_put_each_parameter_in_its_place():
    p, q, col = torch.tensor(3), torch.tensor(2.5), torch.arange(4)
    fn = object()
    args = ({"a": col, "b": col + 1}, [p, q], fn, 7)
    kwargs = {"translate": True, "scalars": (q,)}
    names = {id(p): "p", id(q): "q"}
    t_args, t_kw = graphs.template(args, names), \
        graphs.template(kwargs, names)
    assert t_args[1] == [graphs.ParamRef("p"), graphs.ParamRef("q")]
    assert t_args[0]["a"] is col and t_args[2] is fn and t_args[3] == 7
    assert t_kw == {"translate": True, "scalars": (graphs.ParamRef("q"),)}
    got = graphs.fill(t_args, {"p": 11, "q": -0.5})
    assert got[1] == [11, -0.5] and type(got[1]) is list
    assert got[0]["a"] is col and got[0]["b"] is t_args[0]["b"]
    assert got[2] is fn and got[3] == 7
    assert graphs.fill(t_kw, {"p": 0, "q": 4.0}) == {"translate": True,
                                                     "scalars": (4.0,)}


def test_outputs_keep_each_allocation_once_at_a_fixed_address():
    ws = torch.arange(12, dtype=torch.int32)
    alone = torch.tensor([1.5, 2.5])
    res = (ws[4:8], ws[3], alone, None)
    out = graphs.Outputs(res)
    idx, count, own, none = out.static
    assert none is None and len(out._copies) == 2
    assert idx.untyped_storage().data_ptr() \
        == count.untyped_storage().data_ptr() \
        != ws.untyped_storage().data_ptr()
    assert own.data_ptr() != alone.data_ptr()
    for s, r in zip(out.static[:3], res):
        assert torch.equal(s, r)
    ws2, alone2 = ws * 10, alone - 1
    out.refresh((ws2[4:8], ws2[3], alone2, None))
    assert torch.equal(idx, ws2[4:8]) and int(count) == 30
    assert torch.equal(own, alone2)


def _recorded_walk(cq, binding: dict):
    """The walk as a capture runs it: each parameter a 0-d tensor, and a
    recorder at the entry points (its segments no-ops).  (answers, the
    recorder, the segment events)."""
    params = {n: torch.tensor(np.asarray(binding[n], dtype=dt))
              for n, dt in cq.param_spec.items()}
    host = {n: np.asarray(binding[n], dtype=dt).item()
            for n, dt in cq.param_spec.items()}
    events = []
    rec = graphs.Recorder(params, host, lambda: events.append("begin"),
                          lambda: events.append("end"))
    inputs = {**cq.resident, **{f"param/{n}": t for n, t in params.items()}}
    run = cq._walk(inputs, cq.device, engine=rec)
    got = cq._settle([binding], [run])[0]
    return got, rec, events


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_the_recorded_walk_gives_the_answers_of_host_scalars(pdb, qname):
    cq, runtime = _param_query(pdb, qname)
    for binding in (runtime, dict(runtime, **PARAM_ALT_BINDINGS[qname])):
        got, rec, events = _recorded_walk(cq, binding)
        _bits(got, cq.run(binding))
        assert [(c.name, c.span) for c in rec.calls] == CALLS[qname]
        assert events == ["end", "begin"] * len(CALLS[qname])
        for node in rec.calls:
            # every predicate parameter reaches the call as its ParamRef
            pred = next((a for a in node.args if isinstance(a, fu.TileFn)),
                        None)
            if pred is not None:
                refs = [a for a in node.args if isinstance(a, list)
                        and a and isinstance(a[0], graphs.ParamRef)]
                assert refs == [[graphs.ParamRef(n)
                                 for n in pred.param_names]]


def test_a_walk_without_a_recorder_calls_the_module_attribute(pdb,
                                                              monkeypatch):
    """The operators reach the entry points through `kernels.ops` at call
    time, where a profiler's wrapper counts them."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.selective_agg_query

    def counted(*args, **kwargs):
        seen.append(len(args))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "selective_agg_query", counted)
    cq = CompiledQuery(QUERIES["q6"](), pdb, preset("opt-pallas"),
                       device="cpu")
    cq.run()
    assert seen == [6]
