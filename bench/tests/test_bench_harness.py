"""The harness's parts on the CPU: the traffic generator against TPC-H
clause 2.4's ranges, its seeding and its arrivals; the arithmetic of the
metrics; the byte rule of the roofline under vmap; the loader's finding
of configurations, traffic and metrics by name; and the command's exits
where it cannot give a result."""
import datetime as dt
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, manifest, roofline, stats, trace
from bench.gen import tpch_requests as gen
from bench.tests import runs

ROOT = manifest.ROOT
EPOCH = dt.date(1970, 1, 1)


def _date(days: int) -> dt.date:
    return EPOCH + dt.timedelta(days=int(days))


def _requests(traffic, seed: int, n: int) -> list:
    src = gen.Requests(runs.traffic(traffic) if isinstance(traffic, str)
                       else traffic, seed, 0)
    return [src.next() for _ in range(n)]


def test_parameters_lie_in_the_specifications_ranges():
    seen: dict = {}
    for q, p in _requests(runs.reports_mix(loop="closed", outstanding=1), 5,
                          6000):
        seen.setdefault(q, []).append(p)
        if q == "q1":
            delta = (dt.date(1998, 12, 1) - _date(p["shipdate_hi"])).days
            assert 60 <= delta <= 120
        elif q == "q3":
            d = _date(p["cutoff"])
            assert (d.year, d.month) == (1995, 3)
            assert (p["segment"], p["topn"]) == ("BUILDING", 10)
        elif q == "q6":
            lo, hi = _date(p["date_lo"]), _date(p["date_hi"])
            assert 1993 <= lo.year <= 1997 and (lo.month, lo.day) == (1, 1)
            assert hi == dt.date(lo.year + 1, 1, 1)
            disc = round(p["disc_lo"] + 0.01, 2)
            assert 0.02 <= disc <= 0.09
            assert p["disc_hi"] == round(disc + 0.01, 2)
            assert p["qty_max"] in (24, 25)
        elif q == "q12":
            lo, hi = _date(p["receipt_lo"]), _date(p["receipt_hi"])
            assert 1993 <= lo.year <= 1997 and (lo.month, lo.day) == (1, 1)
            assert hi == dt.date(lo.year + 1, 1, 1)
            assert (p["mode1"], p["mode2"]) == ("MAIL", "SHIP")
        elif q == "q14":
            lo, hi = _date(p["ship_lo"]), _date(p["ship_hi"])
            assert 1993 <= lo.year <= 1997 and lo.day == 1
            assert hi == dt.date(lo.year + lo.month // 12,
                                 lo.month % 12 + 1, 1)
        elif q == "q19":
            for k, (a, b) in enumerate(((1, 10), (10, 20), (20, 30)), 1):
                assert a <= p[f"qty{k}_lo"] <= b
                assert p[f"qty{k}_hi"] == p[f"qty{k}_lo"] + 10
            assert (p["brand1"], p["brand2"], p["brand3"]) == \
                ("Brand#12", "Brand#23", "Brand#34")
    # every template, and every value of the small domains, is drawn
    assert set(seen) == {"q1", "q3", "q6", "q12", "q14", "q19"}
    assert {_date(p["cutoff"]).day for p in seen["q3"]} == set(range(1, 32))
    assert {round(p["disc_lo"] + 0.01, 2) for p in seen["q6"]} == \
        {round(0.01 * k, 2) for k in range(2, 10)}
    assert {_date(p["ship_lo"]).month for p in seen["q14"]} == \
        set(range(1, 13))


def test_the_same_seed_gives_the_same_requests():
    assert _requests("power", 2**31 + 9, 300) == \
        _requests("power", 2**31 + 9, 300)
    assert _requests("power", 1, 300) != _requests("power", 2, 300)


def test_the_stream_sends_rounds_of_every_plan():
    t = runs.traffic("power")
    got = [q for q, _p in _requests("power", 4, 15 * 20)]
    for r in range(20):
        assert sorted(got[15 * r:15 * (r + 1)]) == sorted(t["rounds_of"])
    assert got[:15] != got[15:30]
    params = dict(_requests("power", 4, 15))
    assert params["q4"] is None and params["q1"] is not None


def test_poisson_arrivals_keep_their_rate():
    t = runs.reports_mix(loop="open", rate_per_s=200.0)
    it = gen.arrivals(t, 3, 0)
    times = [next(it) for _ in range(20000)]
    gaps = np.diff([0.0] + times)
    assert np.mean(gaps) == pytest.approx(1 / 200, rel=0.03)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, rel=0.05)
    again = gen.arrivals(t, 3, 0)
    assert [next(again) for _ in range(100)] == times[:100]


def test_percentile_is_over_every_sample():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(
        np.percentile(xs, 95))
    assert stats.percentile(xs + [math.inf] * 3, 95) == pytest.approx(
        np.percentile(xs + [1e9] * 3, 95))
    assert stats.percentile([1.0] * 90 + [math.inf] * 10, 95) == math.inf


def _run(reqs, t_open=0.0, t_close=10.0, **kw):
    return harness.Run(t_open, t_close, reqs, kw.get("setup", {}),
                       kw.get("counters", {}), kw.get("trace"))


def test_rates_and_tails_take_the_whole_window():
    R = harness.Request
    reqs = [R("q1", None, due=k / 10, sent=k / 10, done=k / 10 + 0.01,
              answer={}) for k in range(-10, 100)]
    reqs.append(R("q3", None, due=5.0, sent=5.0, error=RuntimeError()))
    run = _run(reqs)
    assert len(run.due()) == 101
    assert stats.completed_per_s(run) == pytest.approx(10.0)
    assert stats.percentile(stats.latencies_ms(run), 95) == \
        pytest.approx(10.0)
    assert stats.latencies_ms(run).count(math.inf) == 1


def test_idle_share_and_roofline_from_a_trace():
    assert trace._union([[0, 2], [1, 3], [5, 6]]) == [[0, 3], [5, 6]]
    tr = trace.Summary(window_s=2.0, busy_s=0.5, kernels=10, device_ops=[],
                       idle_gaps=[], engine_calls=4, engine_launches=4,
                       engine_bound_s=0.1,
                       engine_device_s=0.4, t0=0.0, t1=2.0)
    assert stats.idle_pct(tr) == pytest.approx(75.0)
    assert stats.roofline_pct(tr) == pytest.approx(25.0)
    assert stats.idle_pct(None) is None and stats.roofline_pct(None) is None
    empty = dict(tr.__dict__, engine_device_s=0.0)
    assert stats.roofline_pct(trace.Summary(**empty)) is None


def test_requests_per_batch_from_the_servers_counters():
    run = _run([], counters={"completed": 300, "batches": 120})
    assert stats.per_batch(run) == pytest.approx(2.5)
    assert stats.per_batch(_run([], counters={})) is None


def test_the_byte_rule_under_vmap():
    """A batched operand counts once a binding, a shared one once, every
    output once a binding."""
    B, n, G, A = 5, 1000, 3, 2
    mask = torch.ones(B, n, dtype=torch.bool)
    gidx = torch.zeros(n, dtype=torch.int64)
    vals = [torch.ones(n) for _ in range(A)]
    scalar = roofline.filter_agg_query(mask[0], gidx, vals, G)
    assert scalar == n + 4 * n + 4 * n * A + 4 * G * (A + 1)
    got = []
    torch.func.vmap(lambda m: got.append(
        roofline.filter_agg_query(m, gidx, vals, G)) or m.sum())(mask)
    assert got == [B * n + 4 * n + 4 * n * A + B * 4 * G * (A + 1)]
    cols = {"a": torch.ones(B, n), "b": torch.ones(n, dtype=torch.int32)}
    got = []
    torch.func.vmap(lambda a: got.append(roofline.compact_pred_query(
        {"a": a, "b": cols["b"]}, [], None, 64, translate=True))
        or a.sum())(cols["a"])
    assert got == [B * 4 * n + 4 * n + B * (4 * 64 + 4 + 4 * n)]


def test_new_files_are_found_by_name_without_an_edit(tmp_path):
    root = runs.checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    conf = dict(runs.server_config(), name="tpch-sf1-wide",
                server={"budget": 2048})
    (root / "bench/configs/tpch-sf1-wide.json").write_text(json.dumps(conf))
    mix = runs.reports_mix(loop="closed", outstanding=768)
    (root / "bench/traffic/wide-backlog.json").write_text(json.dumps(mix))
    (root / "bench/metrics/answered.wide.py").write_text(
        "def read(run):\n    return float(len(run.completed()))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tpch-sf1-wide", "source": "test",
                         "file": "bench/configs/tpch-sf1-wide.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "wide", "config": "tpch-sf1-wide",
                           "traffic": "wide-backlog", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "answered.wide", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "server and plan cache",
                           "moves": "queries_per_s"})
    for e in m["end_to_end"]:
        if e["name"] == "queries_per_s":
            e["workloads"].append("wide")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load("wide", root, root / "bench")
    assert cell.config["server"] == {"budget": 2048}
    assert cell.client.Client.asynchronous
    assert cell.traffic["outstanding"] == 768
    assert {x.name for x in cell.end_to_end} == {"queries_per_s", "setup_s"}
    layer = {x.name: x for x in cell.per_layer}
    assert "answered.wide" in layer and "stage_s" not in layer
    run = _run([harness.Request("q1", None, 1.0, 1.0, 2.0, answer={})])
    assert layer["answered.wide"].read(run) == 1.0
    # a metric without a list of cells joins every cell that reports the
    # end-to-end metric it moves, the cells that were there before too
    assert "answered.wide" in {x.name for x in manifest.load(
        "adhoc-power", root, root / "bench").per_layer}
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("outstanding,batched", [(1, False), (8, True)])
def test_the_server_warms_only_what_its_traffic_reaches(outstanding,
                                                        batched):
    """A lone request outstanding never fills a window: set-up warms the
    scalar walk alone.  A traffic that can fill one warms a window of as
    many requests as it keeps in flight, through the batched pass."""
    from repro_torch.relational import Database

    from bench import tpchgen
    from bench.clients import server

    traffic = runs.reports_mix(loop="closed", outstanding=outstanding)
    db = Database.from_arrays(tpchgen.generate(0.01, 3))
    client = server.Client(runs.server_config(), db, traffic, gen,
                           torch.device("cpu"))
    try:
        client.stage()
        got = client.counters()
    finally:
        client.close()
    assert got["submitted"] == 6 * (1 + (outstanding if batched else 0))
    assert got["completed"] == got["submitted"] and got["errors"] == 0
    assert (got["coalesced"] > 0) == batched


def _command(root, cell="adhoc-power"):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=600)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    out = _command(runs.checkout(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _command(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"queries_per_s", "query_p95_ms", "setup_s"}

