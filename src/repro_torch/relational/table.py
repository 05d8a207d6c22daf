"""Columnar table storage (host-side numpy) + per-column statistics.

Physical representation (this is the *record-of-arrays* / column layout of
paper §3.3 — the row-layout AoS variant used by the layout experiment is
built at staging time by `repro_torch.core.operators.scan` under
`Settings(layout="row")`: per-dtype-group record matrices behind an
optimization barrier):

  INT/DATE  -> int32[n]
  FLOAT     -> float32[n]
  CAT       -> int32[n] dictionary codes + `vocab` (np.ndarray of str).
               The dictionary is *ordered* (codes sorted lexicographically)
               so range operations lower to code-range compares (§3.4).
  TEXT      -> int32[n, max_words] word codes (-1 padding) + word `vocab`.

`char_matrix()` materializes the un-dictionary-encoded representation
(fixed width uint8 bytes) used by engine configurations where the
StringDictionary optimization is disabled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.relational.schema import ColKind, TableSchema


@dataclasses.dataclass
class ColumnStats:
    min: float = 0.0
    max: float = 0.0
    n_distinct: int = 0
    # For DATE columns: sorted unique years present.
    years: Optional[np.ndarray] = None


@dataclasses.dataclass
class Table:
    schema: TableSchema
    nrows: int
    # Column name -> physical array (codes for CAT, word matrix for TEXT).
    data: dict[str, np.ndarray]
    # CAT column name -> vocabulary (sorted, so codes are order-preserving).
    vocabs: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # TEXT column name -> word vocabulary.
    word_vocabs: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    stats: dict[str, ColumnStats] = dataclasses.field(default_factory=dict)
    _char_cache: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # lazy selectivity sketches (built on first use by the Compaction pass):
    # per-column equi-depth quantiles and measured 2-column range fractions.
    _quantile_cache: dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    _pair_cache: dict[tuple, float] = dataclasses.field(default_factory=dict)
    _sample_cache: Optional[np.ndarray] = None
    # analysis-layer base ColInfo per column, validated against the stats
    # values on every hit (tests mutate `stats` in place): name ->
    # (stats signature, ColInfo).  Populated by analysis/schema.py.
    _colinfo_cache: dict[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.schema.name

    def col(self, name: str) -> np.ndarray:
        return self.data[name]

    def compute_stats(self) -> None:
        for cdef in self.schema.columns:
            arr = self.data[cdef.name]
            st = ColumnStats()
            if cdef.kind in (ColKind.INT, ColKind.FLOAT, ColKind.DATE):
                if arr.size:
                    st.min = float(arr.min())
                    st.max = float(arr.max())
                if cdef.kind in (ColKind.INT, ColKind.DATE) and arr.size:
                    # exact distinct count (one np.unique at load time):
                    # feeds the compaction planner's group-count estimate
                    # for dense aggregations over key columns, where the
                    # static domain bound (parent row count) can be far
                    # above the live key population
                    st.n_distinct = int(np.unique(arr).size)
                if cdef.kind == ColKind.DATE and arr.size:
                    yrs = arr.astype("datetime64[D]").astype("datetime64[Y]")
                    st.years = np.unique(yrs).astype(np.int64) + 1970
            if cdef.kind == ColKind.CAT:
                st.n_distinct = len(self.vocabs[cdef.name])
                if arr.size:
                    st.min, st.max = float(arr.min()), float(arr.max())
            if cdef.kind == ColKind.TEXT:
                st.n_distinct = len(self.word_vocabs[cdef.name])
            self.stats[cdef.name] = st

    # -- selectivity sketches (§3.5.2 statistics knowledge, extended) -------
    QUANTILES = 129   # equi-depth knots: CDF error bounded by 1/(k-1)

    def quantile_sketch(self, name: str) -> np.ndarray:
        """Equi-depth quantile knots of a numeric column (sorted, length
        QUANTILES).  One pass at first use, cached; `cdf` interpolates on
        it, so any value bound — including one only known at bind time —
        gets a distribution-aware range estimate instead of the min/max
        linear interpolation."""
        q = self._quantile_cache.get(name)
        if q is None:
            arr = self.data[name]
            if arr.size == 0:
                q = np.zeros(2, dtype=np.float64)
            else:
                knots = np.linspace(0.0, 1.0, self.QUANTILES)
                q = np.quantile(arr.astype(np.float64), knots)
            self._quantile_cache[name] = q
        return q

    def cdf(self, name: str, v: float) -> float:
        """Estimated fraction of rows with column value <= v."""
        q = self.quantile_sketch(name)
        k = len(q) - 1
        if v < q[0]:
            return 0.0
        if v >= q[-1]:
            return 1.0
        i = int(np.searchsorted(q, v, side="right")) - 1
        i = min(max(i, 0), k - 1)
        span = q[i + 1] - q[i]
        frac = (v - q[i]) / span if span > 0 else 1.0
        return (i + min(max(frac, 0.0), 1.0)) / k

    def pair_frac(self, a: str, op: str, b: str) -> float:
        """Measured fraction of rows satisfying `a op b` for two columns
        of THIS table (row-aligned compare, one vectorized pass, cached).
        The 2-column range sketch behind col-vs-col selectivity — replaces
        the textbook 0.5 with the observed fraction."""
        key = (a, op, b)
        got = self._pair_cache.get(key)
        if got is None:
            x, y = self.data[a], self.data[b]
            if x.size == 0:
                got = 0.5
            else:
                cmp = {"<": np.less, "<=": np.less_equal,
                       ">": np.greater, ">=": np.greater_equal,
                       "==": np.equal, "!=": np.not_equal}[op]
                got = float(np.count_nonzero(cmp(x, y))) / x.size
            self._pair_cache[key] = got
        return got

    SAMPLE_ROWS = 2048

    def sample_index(self) -> np.ndarray:
        """Sorted row sample (≤ SAMPLE_ROWS rows) for joint-predicate
        selectivity measurement (compaction's conjunction clamp).  Fixed
        seed: capacity planning must be deterministic across processes and
        across the plan cache's capacity-signature runs."""
        if self._sample_cache is None:
            if self.nrows <= self.SAMPLE_ROWS:
                idx = np.arange(self.nrows)
            else:
                rng = np.random.default_rng(0x5EED)
                idx = rng.choice(self.nrows, self.SAMPLE_ROWS, replace=False)
                idx.sort()
            self._sample_cache = idx
        return self._sample_cache

    # -- un-optimized (no string dictionary) physical representation -------
    def char_matrix(self, name: str) -> np.ndarray:
        """uint8[n, width] fixed-width byte matrix for a CAT column."""
        if name in self._char_cache:
            return self._char_cache[name]
        cdef = self.schema.col(name)
        if cdef.kind == ColKind.CAT:
            vocab = self.vocabs[name]
            width = cdef.char_width
            lut = np.zeros((len(vocab), width), dtype=np.uint8)
            for i, s in enumerate(vocab):
                b = str(s).encode()[:width]
                lut[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            mat = lut[self.data[name]]
        elif cdef.kind == ColKind.TEXT:
            # Join words with single spaces into a char matrix.
            vocab = self.word_vocabs[name]
            wlens = np.array([len(str(s)) for s in vocab] + [0])
            codes = self.data[name]
            safe = np.where(codes < 0, len(vocab), codes)
            width = int((wlens[safe].sum(axis=1) + codes.shape[1]).max()) if codes.size else 1
            mat = np.zeros((self.nrows, width), dtype=np.uint8)
            strs = [" ".join(str(vocab[c]) for c in row if c >= 0) for row in codes]
            for i, s in enumerate(strs):
                b = s.encode()[:width]
                mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        else:
            raise TypeError(f"char_matrix on non-string column {name}")
        self._char_cache[name] = mat
        return mat

    def encode_const(self, name: str, value: str) -> int:
        """Dictionary code for a constant string (−1 if absent)."""
        vocab = self.vocabs[name]
        idx = np.searchsorted(vocab, value)
        if idx < len(vocab) and vocab[idx] == value:
            return int(idx)
        return -1

    def encode_word(self, name: str, word: str) -> int:
        vocab = self.word_vocabs[name]
        idx = np.searchsorted(vocab, word)
        if idx < len(vocab) and vocab[idx] == word:
            return int(idx)
        return -1

    def code_range(self, name: str, prefix: str) -> tuple[int, int]:
        """[lo, hi) code range of vocab entries starting with `prefix`.

        This is the ordered-dictionary lowering of startsWith (§3.4): the
        vocabulary is sorted, so a prefix corresponds to a code interval.
        """
        vocab = self.vocabs[name]
        lo = int(np.searchsorted(vocab, prefix, side="left"))
        hi = int(np.searchsorted(vocab, prefix + "\x7f", side="left"))
        return lo, hi

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.data.values()))


def pad_words(rows: list[list[int]], max_words: int) -> np.ndarray:
    out = np.full((len(rows), max_words), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        r = r[:max_words]
        out[i, : len(r)] = r
    return out
