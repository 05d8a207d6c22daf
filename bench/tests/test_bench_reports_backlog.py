"""The `reports-backlog` cell on the CPU: the real cell (384 requests
outstanding through the port's `QueryServer`) runs through the harness
at a small scale and comes out correct, and not correct with a float
altered where the answer is decoded; its two readers on runs made by
hand; and the end-to-end metrics the cell reports."""
import types

import pytest

from bench import harness, manifest
from bench.tests.runs import ROOT, run_python
from bench.tests.test_bench_faults import SCALED

CELL = "reports-backlog"
# a window of 3 s: on a busy CPU one batched pass of the plain kernels
# can outlast a shorter one, and then no request falls due inside it
RUN = ("import json, time\n"
       "from pathlib import Path\n"
       "from bench import harness\n"
       "r = harness.execute({cell!r}, 11, 3.0, False, t_start="
       "time.monotonic(), device='cpu', scale=0.01, root=Path({root!r}))\n"
       "print(json.dumps(r))\n")


def _layer(name):
    return {m.name: m for m in manifest.load(CELL).per_layer}[name]


def test_the_cell_reports_the_rate_and_set_up_and_no_tail():
    cell = manifest.load(CELL)
    assert [m.name for m in cell.end_to_end] == ["queries_per_s", "setup_s"]
    assert {m.name for m in cell.per_layer} == {
        "requests_per_pass.reports", "submit_host_ms.reports"}
    assert cell.chips == 1 and cell.config["client"] == "server"
    assert cell.traffic["loop"] == "closed" \
        and cell.traffic["outstanding"] == 384


@pytest.mark.parametrize("fault", [None, "answer-altered"])
def test_the_cell_on_the_cpu(fault):
    r = run_python((SCALED if fault else "")
                   + RUN.format(cell=CELL, root=str(ROOT)))
    assert r["attempted"] > 0 and r["failed"] == 0
    if fault is None:
        assert r["correct"] is True
        assert set(r["metrics"]) == {"queries_per_s", "setup_s"}
    else:
        assert r["correct"] is False
        assert r["checks"]["float_gap"]["value"] \
            > r["checks"]["float_gap"]["limit"]


@pytest.mark.parametrize("counters,want", [
    ({"completed": 1280, "batches": 25}, 51.2),
    ({"completed": 7, "batches": 7}, 1.0),
    ({"completed": 0, "batches": 0}, None),
    ({}, None)])
def test_requests_per_pass(counters, want):
    got = _layer("requests_per_pass.reports").read(
        harness.Run(0.0, 20.0, [], {}, counters))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("spans,requests,want", [
    ({"repro.serve.submit": [400, 0.02, 0.02]}, 400, 0.05),
    ({"repro.serve.submit": [3, 0.0009, 0.0009],
      "repro.walk": [1, 0.004, 0.001]}, 4, 0.225),
    ({"repro.walk": [12, 0.04, 0.01]}, 12, None),   # an older server
    ({}, 0, None)])
def test_submit_host_ms(spans, requests, want):
    trace = types.SimpleNamespace(spans=spans, requests=requests,
                                  idle_by_span={}, window_s=3.0)
    got = _layer("submit_host_ms.reports").read(
        harness.Run(0.0, 20.0, [], {}, {}, trace))
    assert got == (None if want is None else pytest.approx(want))
    untraced = harness.Run(0.0, 20.0, [], {}, {}, None)
    assert _layer("submit_host_ms.reports").read(untraced) is None
