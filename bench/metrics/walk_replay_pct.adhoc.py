"""walk_replay_pct.adhoc: the share of the staged walks in the traced
stretch that replayed the walk captured as CUDA graphs: 100 times the
program's `repro.replay` spans over its `repro.walk` spans, among the
requests wholly inside the stretch (profiler trace).  Nothing where the
trace holds no `repro.walk` span, or no `repro.replay` span at all (a
program that does not replay)."""
from bench import spans

spans.install()


def read(run):
    got = getattr(run.trace, "spans", None) or {}
    walks = got.get("repro.walk", [0])[0]
    replays = got.get("repro.replay", [0])[0]
    if not walks or not replays:
        return None
    return 100.0 * replays / walks
