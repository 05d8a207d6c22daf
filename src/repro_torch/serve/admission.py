"""Admission control, typed serving errors, and serving telemetry.

The overload-hardening layer of `QueryServer` (docs/architecture.md §10):

  * `AdmissionController` — a bounded pending-request budget with
    per-tenant fairness.  Requests carry an optional `tenant` and
    `priority`; a request past the budget (or past its tenant's fair
    share) is rejected with a typed `Overloaded` error *at submit time*
    instead of queueing unboundedly.  Priority > 0 requests bypass the
    tenant cap and may dip into a reserved headroom above the budget, so
    a latency-critical tenant still gets through a burst of bulk traffic.
  * typed errors — `Overloaded` (admission rejection), `DeadlineExceeded`
    (a request's deadline passed before its group executed), and
    `TransientError` (the retryable fault class: the server's bounded
    retry-with-backoff only replays a group whose failure is transient,
    mirroring `runtime/fault_tolerance.py`'s restore-and-replay idiom).
  * `RateEMA` — exponentially weighted arrival-interval tracker (the
    `StragglerStats` idiom pointed at arrivals instead of step times);
    drives the adaptive coalescing window.
  * `LatencyHistogram` — log2-bucketed latency histogram with p50/p99
    readout, embedded in `ServerStats`.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional


class Overloaded(RuntimeError):
    """Admission rejected the request: the server's pending budget (or
    this tenant's fair share of it) is exhausted."""

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 reason: str = "budget"):
        super().__init__(message)
        self.tenant = tenant
        self.reason = reason        # 'budget' | 'fairness'


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its group executed."""


class TransientError(RuntimeError):
    """A fault the server may retry: the failed group is replayed once
    (with backoff) against the same compiled entry — restore-and-replay,
    like `TrainDriver`'s checkpoint recovery, but the 'checkpoint' is the
    window's request list, which execution never mutates."""


@dataclasses.dataclass
class RateEMA:
    """EMA of inter-arrival times (`StragglerStats.observe` pointed at
    arrivals): `interval()` is the smoothed gap between requests, from
    which the server derives its coalescing-window length."""
    alpha: float = 0.1
    ema: float = 0.0
    count: int = 0
    last: Optional[float] = None

    def observe(self, now: float) -> None:
        if self.last is None:
            self.last = now
            return
        dt = max(now - self.last, 1e-9)
        self.last = now
        self.ema = dt if self.count == 0 \
            else (1.0 - self.alpha) * self.ema + self.alpha * dt
        self.count += 1

    def interval(self) -> Optional[float]:
        return self.ema if self.count else None

    def rate(self) -> float:
        """Smoothed arrivals per second (0.0 until two arrivals seen)."""
        return 1.0 / self.ema if self.count else 0.0


@dataclasses.dataclass
class LatencyHistogram:
    """Log2-bucketed latency histogram: bucket i covers
    [2^i, 2^(i+1)) microseconds, so p50/p99 readouts carry at most one
    octave of quantization error — plenty for an overload dashboard, and
    O(1) memory regardless of traffic."""
    counts: list = dataclasses.field(default_factory=lambda: [0] * 32)
    count: int = 0
    total_s: float = 0.0

    def observe(self, seconds: float) -> None:
        us = max(seconds * 1e6, 1.0)
        i = min(int(math.log2(us)), len(self.counts) - 1)
        self.counts[i] += 1
        self.count += 1
        self.total_s += seconds

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (geometric bucket midpoint)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return (2.0 ** (i + 0.5)) * 1e-6
        return (2.0 ** len(self.counts)) * 1e-6

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    def mean(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class AdmissionController:
    """Bounded pending budget with per-tenant fairness and priorities.

    Contract (docs §10):

      * at most `budget` requests may be pending (admitted, future not yet
        resolved) at once; request `budget + 1` is rejected with
        `Overloaded(reason='budget')`;
      * a named tenant may hold at most `ceil(tenant_frac * budget)`
        pending slots, so one bulk tenant cannot starve the others even
        below the global budget — excess is rejected with
        `Overloaded(reason='fairness')`.  Anonymous requests
        (`tenant=None`) are exempt from the per-tenant cap and bounded
        only by the global budget;
      * `priority > 0` requests bypass the tenant cap and may use a
        reserved `headroom` above the budget (default budget/4), so
        latency-critical traffic is the last to be shed.

    Thread-safe: `admit`/`release` take an internal lock (releases run on
    future done-callbacks, i.e. arbitrary threads).
    """

    def __init__(self, budget: int = 256, tenant_frac: float = 0.5,
                 headroom: Optional[int] = None):
        if budget < 1:
            raise ValueError(f"budget must be >= 1 (got {budget})")
        self.budget = budget
        self.tenant_cap = max(1, math.ceil(tenant_frac * budget))
        self.headroom = budget // 4 if headroom is None else headroom
        self._lock = threading.Lock()
        self._pending = 0
        self._per_tenant: dict[Optional[str], int] = {}

    def admit(self, tenant: Optional[str] = None, priority: int = 0) -> int:
        """Claim one pending slot (returns the pre-admission pending
        count) or raise `Overloaded`.  Callers MUST pair every successful
        admit with exactly one `release` — the server wires it to the
        request future's done-callback, which fires on every resolution
        path (result, error, rejection at close)."""
        with self._lock:
            limit = self.budget + (self.headroom if priority > 0 else 0)
            if self._pending >= limit:
                raise Overloaded(
                    f"pending budget exhausted ({self._pending} >= {limit})",
                    tenant=tenant, reason="budget")
            if tenant is not None and priority <= 0 and \
                    self._per_tenant.get(tenant, 0) >= self.tenant_cap:
                raise Overloaded(
                    f"tenant {tenant!r} at its fair share "
                    f"({self.tenant_cap} of {self.budget})",
                    tenant=tenant, reason="fairness")
            before = self._pending
            self._pending += 1
            self._per_tenant[tenant] = self._per_tenant.get(tenant, 0) + 1
            return before

    def release(self, tenant: Optional[str] = None) -> None:
        with self._lock:
            self._pending = max(self._pending - 1, 0)
            n = self._per_tenant.get(tenant, 0) - 1
            if n <= 0:
                self._per_tenant.pop(tenant, None)
            else:
                self._per_tenant[tenant] = n

    def load(self) -> float:
        """Current pending fraction of the budget (>= 1.0 = saturated).
        The degradation ladder keys its rungs off this value."""
        with self._lock:
            return self._pending / self.budget

    def pending(self) -> int:
        with self._lock:
            return self._pending
