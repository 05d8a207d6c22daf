"""Warm-state persistence: a restarted server answers request 1 warm.

Two kinds of state make a long-running engine fast, and both evaporate on
restart without this module:

  * the **compaction feedback store** (PlanCache._Feedback, docs §6) —
    per-plan-shape observed counts and capacity overrides that took
    `compact_replan_after` overflows to converge.  Losing it means the
    first post-restart requests re-pay the overflow → re-plan → retrace
    convergence (and its fallback executions).
  * the **plan-cache warm metadata** — which plan shapes had compiled
    entries (and at which capacities/tier) when the process exited.  The
    staged programs themselves are not saved; the kernel libraries they
    launch are, by `nvcc`, into the build directory, which
    `enable_compilation_cache` points at a directory that outlives the
    process, and the warm hints let a tiered cache/server recognize
    known-hot shapes at request 1.

Format (JSON, one file, written atomically via tmp + os.replace):

    {"version": 1,
     "db": "<Database.content_fingerprint()>",
     "feedback": [{"plan": repr, "settings": [...], "mesh": n,
                   "est_params": {...}, "observed": {pid: max},
                   "overrides": {pid: count} | null,
                   "replans": n, "shrinks": n, "warm": bool}, ...]}

Keyed by the *content* fingerprint, not the process-local monotonic
`Database.fingerprint`: the monotonic counter exists to make in-memory
keys collision-free across reloads, which is exactly wrong on disk.  At
load time each record's base is re-rooted onto the live database's
process fingerprint, so the in-memory keying discipline is untouched.

Failure policy: a corrupt, truncated, version-skewed, or
wrong-database file is a COLD START, never a crash — `load_warm_state`
returns 0 and the engine behaves like a fresh process.
"""
from __future__ import annotations

import json
import os
import tempfile

FORMAT_VERSION = 1


def _py(v):
    """JSON-safe scalar: numpy ints/floats carry .item(); tuples of
    binding values (rare) become lists."""
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_py(x) for x in v]
    return v


def _settings_key(raw) -> tuple:
    """Round-trip a persisted settings astuple back into the exact tuple
    `dataclasses.astuple(Settings)` produces (JSON turns tuples into
    lists; nothing else in Settings needs conversion)."""
    return tuple(tuple(v) if isinstance(v, list) else v for v in raw)


def save_warm_state(cache, path: str) -> int:
    """Serialize `cache`'s feedback store + warm metadata to `path`
    (atomic).  Returns the number of feedback records written."""
    records = []
    with cache._lock:
        warm_bases = {k[:-1] for k in cache._entries}
        for base, fb in cache._feedback.items():
            plan_repr, settings_t, _fp, mesh = base
            records.append({
                "plan": plan_repr,
                "settings": list(settings_t),
                "mesh": mesh,
                "est_params": {k: _py(v) for k, v in fb.est_params.items()},
                "observed": {k: int(v) for k, v in fb.observed.items()},
                "overrides": None if fb.overrides is None
                else {k: int(v) for k, v in fb.overrides.items()},
                "replans": fb.replans,
                "shrinks": fb.shrinks,
                "warm": base in warm_bases,
            })
    payload = {"version": FORMAT_VERSION,
               "db": cache.db.content_fingerprint(),
               "feedback": records}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".warm-state-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(records)


def load_warm_state(cache, path: str) -> int:
    """Restore feedback records (and warm hints) saved by
    `save_warm_state` into `cache`, re-rooting each base onto the live
    database's process fingerprint.  Returns the number of records
    restored; 0 — cold start — for a missing, corrupt, version-skewed,
    or different-database file.  Existing in-memory feedback for a base
    is never overwritten (live observations beat stale disk)."""
    from repro_torch.core.plan_cache import _Feedback

    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) \
                or payload.get("version") != FORMAT_VERSION:
            return 0
        if payload.get("db") != cache.db.content_fingerprint():
            return 0
        records = payload["feedback"]
        restored = 0
        with cache._lock:
            for r in records:
                base = (r["plan"], _settings_key(r["settings"]),
                        cache.db.fingerprint, r["mesh"])
                if base in cache._feedback:
                    continue
                cache._feedback[base] = _Feedback(
                    est_params=dict(r["est_params"]),
                    observed={k: int(v) for k, v in r["observed"].items()},
                    overrides=None if r["overrides"] is None
                    else {k: int(v) for k, v in r["overrides"].items()},
                    replans=int(r.get("replans", 0)),
                    shrinks=int(r.get("shrinks", 0)))
                if r.get("warm"):
                    cache._warm_hints.add(base)
                restored += 1
            cache.stats.restored += restored
        return restored
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        # ValueError covers json.JSONDecodeError; any malformed record
        # shape lands in KeyError/TypeError.  Corrupt file = cold start.
        return 0


def enable_compilation_cache(cache_dir: str) -> bool:
    """Point the kernel build directory (`kernels.build.BUILD_DIR`) at
    `cache_dir`, the counterpart of the reference's XLA cache: a library
    is named by a hash of its source, headers and flags, so a restarted
    process that stages the same plans loads its `nvcc` builds from there
    instead of building again.  Libraries already loaded stay loaded.
    Returns True."""
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(cache_dir)
    path.mkdir(parents=True, exist_ok=True)
    build.BUILD_DIR = path
    return True
