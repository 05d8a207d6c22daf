"""The benchmark's general request generator for TPC-H traffic.

A traffic file (`bench/traffic/<name>.json`, `"kind": "tpch_requests"`)
is data that this module reads:

- `loop`: how requests arrive.  `"stream"`: one client, closed loop, the
  next request when the last one has answered.  `"closed"`: `outstanding`
  requests always in flight, a new one on each answer.  `"open"`: Poisson
  arrivals at `rate_per_s`, whatever the answers do.
- the request sequence: `rounds_of` (a list of query names: rounds of all
  of them, each round in an order drawn from the seed) or `mix` (query
  name -> weight: each request's query drawn by weight).
- `params`: query name -> {parameter: spec}, the substitution parameters
  drawn for each request of that query.  A query without an entry runs
  its literal plan.  A parameter whose name starts with `_` is drawn but
  not sent (a value the others derive from).
- `warmup_s`: seconds of the same traffic before the window opens.

Parameter specs, drawn in the order given:

- a plain number or string: that value;
- `{"int": [lo, hi]}`: a whole number, uniform, both ends included;
- `{"choice": [...]}`: one of the values, uniform;
- `{"date": "YYYY-MM-DD", "minus_days": [lo, hi]}`: the date less a
  uniform number of days;
- `{"ymd": [[y0, y1], [m0, m1], [d0, d1]]}`: a date of uniform year, month
  and day (the day capped at the month's last);
- `{"shift": name, "years": y, "months": m}`: a date drawn before, moved
  by whole years and months;
- `{"add": [name, x], "round": k}`: a number drawn before, plus `x`,
  rounded to `k` decimals.

Dates are int days since 1970-01-01.  The same seed gives the same
requests; `stream` picks one of the seed's independent streams (the
window's traffic, the warm-up's).
"""
from __future__ import annotations

import calendar
import datetime as dt

import numpy as np

_EPOCH = dt.date(1970, 1, 1)


def _days(d: dt.date) -> int:
    return (d - _EPOCH).days


def _date(days: int) -> dt.date:
    return _EPOCH + dt.timedelta(days=int(days))


def _ymd(y: int, m: int, d: int) -> int:
    return _days(dt.date(y, m, min(d, calendar.monthrange(y, m)[1])))


def _shift(days: int, years: int = 0, months: int = 0) -> int:
    d = _date(days)
    k = d.year * 12 + d.month - 1 + years * 12 + months
    return _ymd(k // 12, k % 12 + 1, d.day)


def draw_param(spec, drawn: dict, rng: np.random.Generator):
    """One parameter's value under `spec`, given the ones `drawn` before."""
    if not isinstance(spec, dict):
        return spec
    if "int" in spec:
        lo, hi = spec["int"]
        return int(rng.integers(lo, hi + 1))
    if "choice" in spec:
        values = spec["choice"]
        return values[int(rng.integers(len(values)))]
    if "date" in spec:
        lo, hi = spec["minus_days"]
        base = _days(dt.date.fromisoformat(spec["date"]))
        return base - int(rng.integers(lo, hi + 1))
    if "ymd" in spec:
        (y0, y1), (m0, m1), (d0, d1) = spec["ymd"]
        return _ymd(int(rng.integers(y0, y1 + 1)),
                    int(rng.integers(m0, m1 + 1)),
                    int(rng.integers(d0, d1 + 1)))
    if "shift" in spec:
        return _shift(drawn[spec["shift"]], spec.get("years", 0),
                      spec.get("months", 0))
    if "add" in spec:
        name, x = spec["add"]
        v = drawn[name] + x
        return round(v, spec["round"]) if "round" in spec else v
    raise ValueError(f"unknown parameter spec {spec!r}")


def draw_params(specs: dict, rng: np.random.Generator) -> dict:
    """Every parameter of one request, without the hidden `_` ones."""
    drawn: dict = {}
    for name, spec in specs.items():
        drawn[name] = draw_param(spec, drawn, rng)
    return {k: v for k, v in drawn.items() if not k.startswith("_")}


class Requests:
    """The seed's endless request sequence of one traffic mix:
    `next()` gives (query name, bindings or None)."""

    def __init__(self, traffic: dict, seed: int, stream: int):
        self.rng = np.random.default_rng([int(seed), int(stream)])
        self.params = traffic.get("params", {})
        self.rounds_of = traffic.get("rounds_of")
        if self.rounds_of is None:
            mix = traffic["mix"]
            self.names = list(mix)
            w = np.array([mix[n] for n in self.names], dtype=np.float64)
            self.weights = w / w.sum()
        self._round: list = []

    def _query(self) -> str:
        if self.rounds_of is not None:
            if not self._round:
                order = self.rng.permutation(len(self.rounds_of))
                self._round = [self.rounds_of[i] for i in order[::-1]]
            return self._round.pop()
        return self.names[int(self.rng.choice(len(self.names),
                                               p=self.weights))]

    def next(self) -> tuple[str, dict | None]:
        q = self._query()
        specs = self.params.get(q)
        return q, (draw_params(specs, self.rng) if specs is not None
                   else None)


def queries(traffic: dict) -> list[str]:
    """The query names the mix can send."""
    return list(traffic["rounds_of"] if "rounds_of" in traffic
                else traffic["mix"])


def structural(traffic: dict, query: str) -> dict:
    """The bindings of `query` that every request gives alike (its
    constants): they key the plan the program stages."""
    return {k: v for k, v in traffic.get("params", {}).get(query, {}).items()
            if not isinstance(v, dict) and not k.startswith("_")}


def arrivals(traffic: dict, seed: int, stream: int):
    """Offsets in seconds of the open loop's requests from its start:
    Poisson at `rate_per_s`, drawn from the seed."""
    rng = np.random.default_rng([int(seed), int(stream), 1])
    rate = float(traffic["rate_per_s"])
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        yield t
