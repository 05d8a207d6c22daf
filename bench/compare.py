"""How the benchmark judges an answer against the plain reference.

Two numbers are compared, each beside its limit (the configuration's
`limits`):

- `answers_wrong`: answers that never came, failed, or disagree with the
  reference in anything exact: the columns, the number of rows, a group's
  keys, an integer or a string, a row the query's limit should not have
  let in, or the order.  Limit 0.
- `float_gap`: the widest relative gap of a floating-point value from the
  reference's, `|got - want| / scale`, where `scale` is the larger of the
  reference's `|want|` and a thousandth of the column's largest `|want|`
  (so a value near zero in a column of large ones is held to the
  column's size).

Rows are matched by their exact columns.  An answer's rows have to be in
its ORDER BY on its own values.  At a limit's cut, a row whose float sort
key lies within `TIE` of the last kept row's may stand in for it: float32
sums may order a near-tie differently from float64 ones.
"""
from __future__ import annotations

import numpy as np

# two float sort keys this close (relatively) may come in either order:
# the program's float32 sums lie within about 2e-6 of the float64
# reference's (PERF.md), so closer keys may swap
TIE = 1e-5


def _exact_key(row: int, cols: dict, exact: list) -> tuple:
    return tuple(cols[c][row].item() for c in exact)


def _sort_key(row: int, cols: dict, spec: list) -> list:
    return [cols[c][row] for c, _asc in spec]


def _may_precede(a: list, b: list, spec: list, floats: set,
                 tol: float) -> bool:
    """May a row with sort key `a` come before one with `b`?  Float keys
    that differ by at most `tol` of their size may come in either order."""
    for (c, asc), x, y in zip(spec, a, b):
        if x == y:
            continue
        if c in floats and abs(float(x) - float(y)) <= tol * max(
                abs(float(x)), abs(float(y))):
            return True
        return (x < y) if asc else (x > y)
    return True


def judge(got: dict, want: dict, spec: list, floats: set,
          limit: int | None) -> tuple[str | None, float]:
    """(what is wrong or None, widest float gap) of answer `got` against
    the reference's uncut answer `want`, under the query's ORDER BY `spec`
    and row `limit`."""
    if set(got) != set(want):
        return f"columns {sorted(got)} against {sorted(want)}", 0.0
    n_want = len(next(iter(want.values()))) if want else 0
    n_keep = n_want if limit is None else min(limit, n_want)
    n_got = len(next(iter(got.values()))) if got else 0
    if n_got != n_keep:
        return f"{n_got} rows against {n_keep}", 0.0
    exact = sorted(c for c in want if c not in floats)
    fcols = sorted(c for c in want if c in floats)
    last = _sort_key(n_keep - 1, want, spec) if n_keep else None
    # the rows a right answer can hold: the kept ones, and those past the
    # cut that tie with the last kept one
    n_idx = n_keep
    while n_idx < n_want and _may_precede(
            _sort_key(n_idx, want, spec), last, spec, floats, TIE):
        n_idx += 1
    index: dict = {}
    for r in range(n_idx):
        index.setdefault(_exact_key(r, want, exact), r)
    scale = {c: max(float(np.abs(want[c][:n_keep]).max(initial=0.0)) * 1e-3,
                    1e-300) for c in fcols}
    gap, seen = 0.0, set()
    for r in range(n_got):
        key = _exact_key(r, got, exact)
        w = index.get(key)
        if w is None or key in seen:
            return f"row {r} {key} is not the reference's", gap
        seen.add(key)
        for c in fcols:
            g, x = float(got[c][r]), float(want[c][w])
            d = abs(g - x) / max(abs(x), scale[c])
            gap = max(gap, d if np.isfinite(d) else float("inf"))
    # the answer's own order holds exactly on its own values
    for r in range(1, n_got):
        if not _may_precede(_sort_key(r - 1, got, spec),
                            _sort_key(r, got, spec), spec, floats, 0.0):
            return f"rows {r - 1} and {r} out of order", gap
    return None, gap
