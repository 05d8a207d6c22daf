"""walk_replay_pct.adhoc on a synthetic `summary.spans`, as
`bench/spans.py` gives it (name -> [count, seconds, self seconds]): the
share of the `repro.walk` spans that a `repro.replay` span holds, and
nothing where the trace has no walk or no replay at all."""
import types

import pytest

from bench import harness, manifest


def _read(spans):
    trace = types.SimpleNamespace(spans=spans, requests=10,
                                  idle_by_span={}, window_s=3.0)
    layer = {m.name: m for m in manifest.load("adhoc-power").per_layer}
    return layer["walk_replay_pct.adhoc"].read(
        harness.Run(0.0, 1.0, [], {}, {}, trace))


@pytest.mark.parametrize("walks,replays,want", [
    (10, 10, 100.0), (40, 39, 97.5), (8, 2, 25.0)])
def test_the_share_of_walks_replayed(walks, replays, want):
    spans = {"repro.walk": [walks, 0.004, 0.001],
             "repro.replay": [replays, 0.0045, 0.0005],
             "repro.op.Agg": [replays, 0.002, 0.002]}
    assert _read(spans) == pytest.approx(want)


@pytest.mark.parametrize("spans", [
    {},
    {"repro.replay": [3, 0.001, 0.001]},
    {"repro.walk": [12, 0.04, 0.01], "repro.op.Join": [12, 0.03, 0.03]},
])
def test_nothing_without_walks_or_replays(spans):
    assert _read(spans) is None


def test_nothing_from_an_untraced_run():
    layer = {m.name: m for m in manifest.load("adhoc-power").per_layer}
    run = harness.Run(0.0, 1.0, [], {}, {}, None)
    assert layer["walk_replay_pct.adhoc"].read(run) is None
