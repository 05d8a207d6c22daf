"""Execution tiers and warm-state persistence in the port, on the CPU at
sf 0.01, seed 0:

  * the ladder (`repro_torch.core.tiering`) answers as the reference's
    for the same settings: target, each rung's settings, demotion and
    promotion paths;
  * `OracleQuery` stands in for `CompiledQuery` (the Runnable contract);
  * the tiered cache serves a cold shape from the oracle with no staging,
    promotes in the background (staging AND building the target's
    kernels before the swap), dedups the promotion, keeps a failure
    sticky (served by the oracle on the CPU, raised on the card), and its
    answers equal the reference's Volcano
    (`test_queries.assert_same`);
  * warm state round-trips, writes the reference's records for the same
    requests, and a corrupt or foreign file is a cold start;
  * `enable_compilation_cache` points the kernel build directory;
  * the tiered server serves cold, promotes, persists and prewarms, and
    `close()` leaves no promoter thread.
"""
import dataclasses
import json
import os
import threading

import pytest

from repro.core import tiering as ref_tiering
from repro_torch.core import compile as compile_mod
from repro_torch.core import enable_compilation_cache, preset, tiering
from repro_torch.core.passes.pipeline import degrade
from repro_torch.core.tiering import (COMPILED, INTERPRET, OPT_PALLAS, ORACLE,
                                      Runnable, TierLadder)
from repro_torch.core.volcano import OracleQuery
from repro_torch.kernels import build
from test_torch_plan_cache import (assert_matches, one_thread,  # noqa: F401
                                   pdb, sides)

OPT = preset("opt")


def settings_dict(settings) -> dict:
    """`Settings` by field name, without `topk_limit`: the port has no
    top-k rewrite, so its `Settings` lacks that one field."""
    d = dataclasses.asdict(settings)
    d.pop("topk_limit", None)
    return d


SETTINGS = {"opt": {}, "opt-pallas": {"use_pallas": True},
            "volcano": {"engine": "volcano"}}


@pytest.mark.parametrize("variant", sorted(SETTINGS))
def test_ladder_answers_as_the_reference(sides, variant):
    ref, port = sides
    ladders = [TierLadder(dataclasses.replace(port.preset("opt"),
                                              **SETTINGS[variant])),
               ref_tiering.TierLadder(dataclasses.replace(
                   ref.preset("opt"), **SETTINGS[variant]))]

    def answers(lad):
        out = {"target": lad.target.name,
               "tiers": [t.name for t in lad.tiers()]}
        for t in lad.tiers():
            out[t.name] = settings_dict(lad.settings_for(t))
            out[f"{t.name} demote"] = [lad.demote(t, n).name
                                       for n in (1, 2, 5)]
            out[f"{t.name} path"] = [p.name for p in lad.promotion_path(t)]
            out[f"{t.name} through"] = [
                p.name for p in lad.promotion_path(t, through=True)]
        return out

    assert answers(ladders[0]) == answers(ladders[1])
    if ladders[0].target is not ORACLE:
        assert ladders[0].settings_for(INTERPRET) == degrade(ladders[0].base)
    with pytest.raises(KeyError):
        tiering.tier("warp-speed")


def test_oracle_query_satisfies_runnable(pdb, sides):
    _ref, port = sides
    d, alt = port.defaults("q6"), port.alt_bindings("q6")
    oq = OracleQuery(port.plan("q6"), pdb, params=d)
    assert isinstance(oq, Runnable) and oq.tier_name == "oracle"
    cq = port.query(port.plan("q6"), pdb, OPT, params=d)
    assert isinstance(cq, Runnable) and cq.tier_name == "compiled"
    assert_matches(oq.run(d), cq.run(d))
    for a, b in zip(oq.run_many([d, alt]), cq.run_many([d, alt])):
        assert_matches(a, b)
    with pytest.raises(KeyError):
        oq.run(dict(d, bogus=1))
    with pytest.raises(KeyError):
        cq.run(dict(d, bogus=1))


# ---------------------------------------------------------------------------
# the tiered cache
# ---------------------------------------------------------------------------

def _cold(cache, port, settings, hook):
    d = port.defaults("q6")
    key, prepared, runtime, owned = cache._prepare(port.plan("q6"), settings,
                                                   d, "residual")
    return cache._get_tiered_prepared(key, prepared, runtime, owned,
                                      settings, compile_hook=hook)


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
def test_cold_serve_is_oracle_then_promotes_with_zero_drift(sides, pname):
    ref, port = sides
    settings = preset(pname)
    cache = port.cache(port.db, tiered=True)
    try:
        gate = threading.Event()
        before = compile_mod.STAGINGS
        run, runtime, tier1 = _cold(cache, port, settings,
                                    lambda k: gate.wait(60))
        assert tier1 == "oracle" and isinstance(run, OracleQuery)
        assert compile_mod.STAGINGS == before
        assert cache.stats.tier_hits == {"oracle": 1}
        res1 = run.run(runtime)
        gate.set()
        d = port.defaults("q6")
        assert cache.await_promotion(port.plan("q6"), settings, d,
                                     timeout=120)
        res2, tier2 = cache.execute_tiered(port.plan("q6"), settings, d)
        assert tier2 == TierLadder(settings).target.name
        want = ref.oracle.execute(ref.plan("q6"), ref.defaults("q6"))
        assert_matches(res1, want)
        assert_matches(res2, want)
        assert cache.stats.promotions == 1
        assert cache.stats.promote_failures == 0
        cq, _ = cache.get(port.plan("q6"), settings, d)
        # the promoter built the kernels before the swap
        assert cq.tier_name == tier2 and cq.compile_time is not None
    finally:
        cache.close()


def test_promotion_is_deduplicated(sides):
    _ref, port = sides
    cache = port.cache(port.db, tiered=True)
    try:
        d = port.defaults("q6")
        for _ in range(8):
            cache.get_tiered(port.plan("q6"), OPT, d)
        assert cache.await_promotion(port.plan("q6"), OPT, d, timeout=120)
        assert cache.stats.compiles == 1 and cache.stats.misses == 1
        assert cache.stats.hits == 7
    finally:
        cache.close()


def test_promote_through_builds_the_interpret_rung(sides):
    _ref, port = sides
    cache = port.cache(port.db, tiered=True, promote_through=True)
    try:
        d = port.defaults("q6")
        gate = threading.Event()
        names = []

        def hook(key):
            assert gate.wait(60)
            with cache._lock:
                st = cache._ladders.get(key)
                names.append(sorted(st.ready) if st else None)

        _cold(cache, port, OPT, hook)
        gate.set()
        assert cache.await_promotion(port.plan("q6"), OPT, d, timeout=240)
        assert names == [["oracle"], ["interpret", "oracle"]]
        assert cache.stats.promotions == 2 and cache.stats.compiles == 2
    finally:
        cache.close()


def test_promotion_failure_falls_back_sticky(sides):
    _ref, port = sides
    cache = port.cache(port.db, tiered=True)
    try:
        calls = []

        def boom(k):
            calls.append(k)
            raise RuntimeError("injected compile fault")

        assert _cold(cache, port, OPT, boom)[2] == "oracle"
        assert not cache.await_promotion(port.plan("q6"), OPT,
                                         port.defaults("q6"), timeout=60)
        for _ in range(3):
            assert _cold(cache, port, OPT, boom)[2] == "oracle"
        assert len(calls) == 1 and cache.stats.promote_failures == 1
    finally:
        cache.close()



def test_promotion_failure_on_the_card_raises(sides, monkeypatch):
    """The port's one departure from the reference's ladder: a cache on
    the card never answers from the host oracle once the target tier has
    failed to build.  The fault is injected through `compile_hook`,
    before any device work, so the card's branch runs here with the
    cache's device set to CUDA."""
    import torch

    from repro_torch.core.plan_cache import PromotionFailed

    _ref, port = sides
    cache = port.cache(port.db, tiered=True)
    monkeypatch.setattr(cache, "device", torch.device("cuda"))
    try:
        gate = threading.Event()

        def boom(k):
            assert gate.wait(60)
            raise RuntimeError("injected compile fault")

        # the cold window: the oracle serves while the promotion runs
        assert _cold(cache, port, OPT, boom)[2] == "oracle"
        gate.set()
        assert not cache.await_promotion(port.plan("q6"), OPT,
                                         port.defaults("q6"), timeout=60)
        for _ in range(2):
            with pytest.raises(PromotionFailed) as err:
                _cold(cache, port, OPT, boom)
            assert "injected compile fault" in str(err.value.__cause__)
        assert cache.stats.promote_failures == 1
        assert cache.stats.tier_hits == {"oracle": 1}
    finally:
        cache.close()

def test_oracle_target_ladder_degenerates(sides):
    _ref, port = sides
    cache = port.cache(port.db, tiered=True)
    try:
        volcano = dataclasses.replace(OPT, engine="volcano")
        d = port.defaults("q6")
        assert cache.get_tiered(port.plan("q6"), volcano, d)[2] == "oracle"
        assert not cache.await_promotion(port.plan("q6"), volcano, d,
                                         timeout=5)
        assert cache.stats.promotions == 0
    finally:
        cache.close()


def test_close_joins_the_promoter_and_stays_usable(sides):
    _ref, port = sides
    cache = port.cache(port.db, tiered=True)
    d = port.defaults("q6")
    cache.get_tiered(port.plan("q6"), OPT, d)
    pool = cache._promoter
    cache.close()
    cache.close()
    assert all(not t.is_alive() for t in pool._threads)
    assert len(cache) == 0 and not cache._ladders
    assert cache.get_tiered(port.plan("q6"), OPT, d)[2] in ("oracle",
                                                            "compiled")
    cache.close()


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _saved(side, path) -> dict:
    cache = side.cache(side.db)
    cache.execute(side.plan("q3"), side.preset("opt"), side.defaults("q3"))
    cache.execute(side.plan("q6"), side.preset("opt"), side.defaults("q6"))
    assert cache.save(path) == 2
    with open(path) as f:
        payload = json.load(f)
    names = [f.name for f in dataclasses.fields(side.preset("opt"))]
    for r in payload["feedback"]:
        r["settings"] = settings_dict(side.preset("opt").__class__(
            **dict(zip(names, r["settings"]))))
    return payload


def test_warm_state_file_is_the_reference_s(sides, tmp_path):
    """The same requests save the same records in both packages (the
    plans' reprs, settings by name, first-seen bindings, observed
    counts), under the same content fingerprint of the same data."""
    ref, port = sides
    got = _saved(port, str(tmp_path / "port.json"))
    want = _saved(ref, str(tmp_path / "ref.json"))
    assert got == want


def test_warm_state_round_trip(sides, tmp_path):
    _ref, port = sides
    path = str(tmp_path / "warm.json")
    cache = port.cache(port.db)
    d = port.defaults("q3")
    cache.execute(port.plan("q3"), OPT, d)
    base = cache.key_for(port.plan("q3"), OPT, d)[:-1]
    fb = cache._feedback[base]
    fb.overrides = {pid: 2 * c for pid, c in fb.observed.items()}
    fb.replans = 2
    assert fb.overrides and cache.save(path) == 1

    fresh = port.cache(port.db)
    assert fresh.load(path) == 1 and fresh.stats.restored == 1
    assert fresh.is_warm(port.plan("q3"), OPT, d)
    rec = fresh._feedback[fresh.key_for(port.plan("q3"), OPT, d)[:-1]]
    assert rec.overrides == fb.overrides and rec.replans == 2
    assert fresh.load(path) == 0          # live records beat the disk
    # the restored overrides drive the first staging's capacities
    cq, _ = fresh.get(port.plan("q3"), OPT, d)
    old, _ = cache.get(port.plan("q3"), OPT, d)
    assert cq.point_caps != old.point_caps


def test_corrupt_or_mismatched_warm_state_is_cold_start(sides, tmp_path):
    _ref, port = sides
    cache = port.cache(port.db)
    assert cache.load(str(tmp_path / "nope.json")) == 0
    f = tmp_path / "warm.json"
    for text in ('{"version": 1, "db": "x", "feedback": [{',
                 '{"version": 99, "db": "x", "feedback": []}',
                 '{"version": 1, "db": "other", "feedback": []}'):
        f.write_text(text)
        assert cache.load(str(f)) == 0
    assert cache.stats.restored == 0


def test_save_is_atomic_and_versioned(sides, tmp_path):
    _ref, port = sides
    payload = _saved(port, str(tmp_path / "warm.json"))
    assert payload["version"] == 1
    assert payload["db"] == port.db.content_fingerprint()
    assert all(r["warm"] for r in payload["feedback"])
    assert not [p for p in os.listdir(str(tmp_path))
                if p.startswith(".warm-state-")]


def test_enable_compilation_cache_points_the_build_dir(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    target = tmp_path / "kernels"
    assert enable_compilation_cache(str(target)) is True
    assert target.is_dir() and build.BUILD_DIR == target
    assert build.library_path("x", "// x\n").parent == target


# ---------------------------------------------------------------------------
# the tiered server
# ---------------------------------------------------------------------------

def test_server_ladder_parity(sides):
    _ref, port = sides
    with port.server(port.db, OPT) as srv:
        assert srv._degraded_settings == degrade(OPT)
        assert srv.ladder.target is COMPILED
    with port.server(port.db, preset("opt-pallas")) as srv:
        assert srv.ladder.target is OPT_PALLAS


def test_tiered_server_serves_cold_then_promotes(sides, tmp_path):
    ref, port = sides
    path = str(tmp_path / "server-warm.json")
    d = port.defaults("q6")
    want = ref.oracle.execute(ref.plan("q6"), ref.defaults("q6"))
    gate = threading.Event()
    srv = port.server(port.db, OPT, tiered=True, warm_state_path=path,
                      compile_hook=lambda k: gate.wait(60))
    try:
        assert_matches(srv.submit(port.plan("q6"), d).result(timeout=120),
                       want)
        assert srv.stats.tier_served.get("oracle", 0) >= 1
        gate.set()
        assert srv.cache.await_promotion(port.plan("q6"), OPT, d,
                                         timeout=120)
        assert_matches(srv.submit(port.plan("q6"), d).result(timeout=120),
                       want)
        assert srv.stats.tier_served.get("compiled", 0) >= 1
    finally:
        gate.set()
        srv.close()
    assert os.path.exists(path)

    srv2 = port.server(port.db, OPT, tiered=True, warm_state_path=path)
    try:
        assert srv2.cache.stats.restored >= 1
        assert srv2.prewarm([(port.plan("q6"), d)]) == 1
        assert srv2.cache.await_promotion(port.plan("q6"), OPT, d,
                                          timeout=120)
        assert_matches(srv2.submit(port.plan("q6"), d).result(timeout=120),
                       want)
        assert srv2.stats.tier_served == {"compiled": 1}
    finally:
        srv2.close()
