"""The benchmark's plain reference: the port's 15 TPC-H plans, written once
more as straightforward PyTorch over the generated arrays.

One function a query.  The six with a parameterized form (q1, q3, q6, q12,
q14, q19) take their bindings, under the names the program's templates
use; a binding left out takes the literal query's value.  Each returns
`{column: numpy array}` in the order the query's ORDER BY gives, under the
column names the program's answers carry, and `SORT[q]` names the order.

The semantics are those of the port's plans (`repro_torch/relational/
queries.py`), which depart from TPC-H where the plans do: q9 without the
supply cost, q18's HAVING at 212, q7 and q9 with the year offset `y_off`
beside the year.  Columns are stored as the generator makes them (int32,
float32, dictionary codes); a predicate compares a float column in its
stored precision with the constant rounded to it, as a typed parameter
does; everything an answer sums or divides is computed in `fdt`.

`Reference(arrays, device)` is the reference itself (float64).  With
`fdt=torch.bfloat16` it is the control: the same queries with every float
column, constant and sum in bfloat16, the nearest precision below the
configuration's float32, which the comparison has to refuse.

Nothing here imports the program or reads what the program derived: the
only input is the generator's arrays and vocabularies.
"""
from __future__ import annotations

import numpy as np
import torch


def days(date_str: str) -> int:
    """'YYYY-MM-DD' as int days since 1970-01-01."""
    return int(np.datetime64(date_str, "D").astype(np.int64))


# Jan 1 of 1900 .. 2100 in days, to read a date's year by a search
_YEAR0 = 1900
_YEAR_STARTS = np.array([days(f"{y}-01-01") for y in range(_YEAR0, 2101)],
                        dtype=np.int64)

# (column, ascending) of each answer's ORDER BY
SORT = {
    "q1": [("l_returnflag", True), ("l_linestatus", True)],
    "q3": [("revenue", False), ("o_orderdate", True)],
    "q4": [("o_orderpriority", True)],
    "q5": [("revenue", False)],
    "q6": [],
    "q7": [("supp_nation", True), ("cust_nation", True), ("l_year", True)],
    "q9": [("n_name", True), ("o_year", False)],
    "q9full": [("n_name", True), ("o_year", False)],
    "q10": [("revenue", False)],
    "q12": [("l_shipmode", True)],
    "q13": [("custdist", False), ("c_count", False)],
    "q14": [],
    "q17": [],
    "q18": [("o_totalprice", False), ("o_orderdate", True)],
    "q19": [],
}

# the row limit of the queries that have one (q3's is its `topn`)
LIMIT = {"q3": "topn", "q10": 20, "q18": 100}

# the literal queries' values of the six templates' parameters
DEFAULTS = {
    "q1": {"shipdate_hi": days("1998-09-02")},
    "q3": {"cutoff": days("1995-03-15"), "segment": "BUILDING", "topn": 10},
    "q6": {"date_lo": days("1994-01-01"), "date_hi": days("1995-01-01"),
           "disc_lo": 0.05, "disc_hi": 0.07, "qty_max": 24.0},
    "q12": {"mode1": "MAIL", "mode2": "SHIP",
            "receipt_lo": days("1994-01-01"),
            "receipt_hi": days("1995-01-01")},
    "q14": {"ship_lo": days("1995-09-01"), "ship_hi": days("1995-10-01"),
            "promo_prefix": "PROMO"},
    "q19": {"brand1": "Brand#12", "qty1_lo": 1.0, "qty1_hi": 11.0,
            "brand2": "Brand#23", "qty2_lo": 10.0, "qty2_hi": 20.0,
            "brand3": "Brand#34", "qty3_lo": 20.0, "qty3_hi": 30.0},
}

# the answer columns that hold floating-point values (compared by gap);
# every other column is compared exactly
FLOAT_COLUMNS = {
    "q1": {"sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
           "avg_qty", "avg_price", "avg_disc"},
    "q3": {"revenue"}, "q4": set(), "q5": {"revenue"}, "q6": {"revenue"},
    "q7": {"revenue"}, "q9": {"sum_profit"}, "q9full": {"sum_profit"},
    "q10": {"c_acctbal", "revenue"},
    "q12": {"high_line_count", "low_line_count"}, "q13": set(),
    "q14": {"promo_revenue"}, "q17": {"avg_yearly"},
    "q18": {"o_totalprice", "sum_qty"}, "q19": {"revenue"},
}


def bind(q: str, params: dict | None) -> dict:
    """The template's literal values, overridden by `params`."""
    bound = dict(DEFAULTS.get(q, {}))
    bound.update(params or {})
    return bound


def limit(q: str, params: dict | None = None) -> int | None:
    """The number of rows query `q` returns at most, or None."""
    n = LIMIT.get(q)
    return int(bind(q, params)[n]) if isinstance(n, str) else n


class Table:
    """One table's columns on the device, converted on first use."""

    def __init__(self, parts: dict, ref: "Reference"):
        self._cols = parts["columns"]
        self.vocabs = parts.get("vocabs", {})
        self.word_vocabs = parts.get("word_vocabs", {})
        self._ref = ref
        self._cache: dict = {}

    def _get(self, key, make):
        got = self._cache.get(key)
        if got is None:
            got = self._cache[key] = make()
        return got

    def i(self, c: str) -> torch.Tensor:
        """An integer, date or code column as int64."""
        return self._get(("i", c), lambda: torch.as_tensor(
            self._cols[c]).to(self._ref.device, torch.int64))

    def f(self, c: str) -> torch.Tensor:
        """A float column in the arithmetic precision."""
        return self._get(("f", c), lambda: torch.as_tensor(
            self._cols[c]).to(self._ref.device, self._ref.fdt))

    def p(self, c: str) -> torch.Tensor:
        """A float column in the precision its predicates compare in."""
        return self._get(("p", c), lambda: torch.as_tensor(
            self._cols[c]).to(self._ref.device, self._ref.pdt))

    def code(self, c: str, value: str) -> int:
        """The dictionary code of `value` in column `c`, or -1."""
        v = self.vocabs[c]
        at = int(np.searchsorted(v, value))
        return at if at < len(v) and v[at] == value else -1

    def eq(self, c: str, value: str) -> torch.Tensor:
        return self.i(c) == self.code(c, value)

    def isin(self, c: str, values) -> torch.Tensor:
        codes = torch.tensor([self.code(c, v) for v in values],
                             device=self._ref.device)
        return torch.isin(self.i(c), codes)

    def startswith(self, c: str, prefix: str) -> torch.Tensor:
        codes = [k for k, s in enumerate(self.vocabs[c])
                 if str(s).startswith(prefix)]
        return torch.isin(self.i(c), torch.tensor(codes, dtype=torch.int64,
                                                   device=self._ref.device))

    def has_word(self, c: str, word: str) -> torch.Tensor:
        words = self._get(("w", c), lambda: torch.as_tensor(
            self._cols[c]).to(self._ref.device, torch.int64))
        v = self.word_vocabs[c]
        at = int(np.searchsorted(v, word))
        if at >= len(v) or v[at] != word:
            return torch.zeros(words.shape[0], dtype=torch.bool,
                               device=words.device)
        return (words == at).any(dim=1)

    def decode(self, c: str, codes: torch.Tensor) -> np.ndarray:
        return self.vocabs[c][codes.cpu().numpy()]


class Reference:
    """The 15 queries over one generated database, on `device`."""

    def __init__(self, arrays: dict, device="cpu", fdt=torch.float64):
        self.device = torch.device(device)
        self.fdt = fdt
        # a predicate on a float column compares in the column's stored
        # float32 (the program's typed parameters round to it too); the
        # control stores and compares in its own lower precision
        self.pdt = torch.float32 if fdt == torch.float64 else fdt
        self.tables = {name: Table(parts, self) for name, parts in
                       arrays.items()}
        self._year_starts = torch.as_tensor(_YEAR_STARTS, device=self.device)

    def t(self, name: str) -> Table:
        return self.tables[name]

    def const(self, v: float) -> torch.Tensor:
        """A float constant of a predicate, in the predicate precision."""
        return torch.tensor(v, dtype=self.pdt, device=self.device)

    def year(self, d: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self._year_starts, d, right=True) - 1 \
            + _YEAR0

    def answer(self, q: str, params: dict | None = None) -> dict:
        """Every row of query `q` under `params` (the template's bindings;
        missing ones take the literal query's values), in ORDER BY order
        and not cut at the query's limit (`limit` gives it)."""
        return getattr(self, q)(bind(q, params))

    # -- helpers ---------------------------------------------------------------
    def _revenue(self, L, m):
        return L.f("l_extendedprice")[m] * (1 - L.f("l_discount")[m])

    def _group(self, keys: list, values: dict):
        """Group rows by non-negative int64 key columns: (each key's value
        per group, {name: sum per group}, rows per group)."""
        combined, radices = keys[0], []
        for k in keys[1:]:
            r = int(k.max()) + 1 if k.numel() else 1
            combined = combined * r + k
            radices.append(r)
        uniq, inv = torch.unique(combined, return_inverse=True)
        g = uniq.shape[0]
        sums = {name: torch.zeros(g, dtype=v.dtype, device=v.device)
                .index_add_(0, inv, v) for name, v in values.items()}
        out = []
        for r in reversed(radices):
            out.append(uniq % r)
            uniq = uniq // r
        out.append(uniq)
        return out[::-1], sums, torch.bincount(inv, minlength=g)

    def _frame(self, q: str, cols: dict) -> dict:
        """Host arrays in the query's ORDER BY."""
        out = {}
        for k, v in cols.items():
            if isinstance(v, torch.Tensor):
                v = (v.to(torch.float64) if k in FLOAT_COLUMNS[q] else v) \
                    .cpu().numpy()
            out[k] = v
        spec = SORT[q]
        if spec:
            keys = []
            for c, asc in reversed(spec):
                v = out[c]
                if v.dtype.kind in "US":
                    v = np.unique(v, return_inverse=True)[1]
                keys.append(v if asc else -v.astype(np.float64))
            order = np.lexsort(keys)
            out = {k: v[order] for k, v in out.items()}
        return out

    # -- the queries -----------------------------------------------------------
    def q1(self, p):
        L = self.t("lineitem")
        m = L.i("l_shipdate") <= p["shipdate_hi"]
        qty, price = L.f("l_quantity")[m], L.f("l_extendedprice")[m]
        disc, tax = L.f("l_discount")[m], L.f("l_tax")[m]
        disc_price = price * (1 - disc)
        (rf, ls), s, n = self._group(
            [L.i("l_returnflag")[m], L.i("l_linestatus")[m]],
            {"sum_qty": qty, "sum_base_price": price,
             "sum_disc_price": disc_price,
             "sum_charge": disc_price * (1 + tax), "disc": disc})
        nf = n.to(self.fdt)
        return self._frame("q1", {
            "l_returnflag": L.decode("l_returnflag", rf),
            "l_linestatus": L.decode("l_linestatus", ls),
            "sum_qty": s["sum_qty"], "sum_base_price": s["sum_base_price"],
            "sum_disc_price": s["sum_disc_price"],
            "sum_charge": s["sum_charge"], "avg_qty": s["sum_qty"] / nf,
            "avg_price": s["sum_base_price"] / nf,
            "avg_disc": s["disc"] / nf, "count_order": n})

    def q3(self, p):
        L, O, C = self.t("lineitem"), self.t("orders"), self.t("customer")
        cutoff = p["cutoff"]
        ok = (O.i("o_orderdate") < cutoff) \
            & C.eq("c_mktsegment", p["segment"])[O.i("o_custkey")]
        lo = L.i("l_orderkey")
        m = (L.i("l_shipdate") > cutoff) & ok[lo]
        (key,), s, _n = self._group([lo[m]], {"revenue": self._revenue(L, m)})
        return self._frame("q3", {
            "l_orderkey": key, "o_orderdate": O.i("o_orderdate")[key],
            "o_shippriority": O.i("o_shippriority")[key],
            "revenue": s["revenue"]})

    def q4(self, p):
        L, O = self.t("lineitem"), self.t("orders")
        late = torch.zeros(O.i("o_orderkey").shape[0], dtype=torch.bool,
                           device=self.device)
        lm = L.i("l_commitdate") < L.i("l_receiptdate")
        late[L.i("l_orderkey")[lm]] = True
        od = O.i("o_orderdate")
        m = (od >= days("1993-07-01")) & (od < days("1993-10-01")) & late
        (pr,), _s, n = self._group([O.i("o_orderpriority")[m]], {})
        return self._frame("q4", {
            "o_orderpriority": O.decode("o_orderpriority", pr),
            "order_count": n})

    def q5(self, p):
        L, O, C = self.t("lineitem"), self.t("orders"), self.t("customer")
        S, N, R = self.t("supplier"), self.t("nation"), self.t("region")
        od = O.i("o_orderdate")
        o_ok = (od >= days("1994-01-01")) & (od < days("1995-01-01"))
        lo = L.i("l_orderkey")
        c_nat = C.i("c_nationkey")[O.i("o_custkey")[lo]]
        s_nat = S.i("s_nationkey")[L.i("l_suppkey")]
        asia = R.eq("r_name", "ASIA")[N.i("n_regionkey")]
        m = o_ok[lo] & (c_nat == s_nat) & asia[s_nat]
        (nat,), s, _n = self._group([s_nat[m]],
                                    {"revenue": self._revenue(L, m)})
        return self._frame("q5", {"n_name": N.decode("n_name",
                                                     N.i("n_name")[nat]),
                                  "revenue": s["revenue"]})

    def q6(self, p):
        L = self.t("lineitem")
        sd, disc = L.i("l_shipdate"), L.p("l_discount")
        m = (sd >= p["date_lo"]) & (sd < p["date_hi"]) \
            & (disc >= self.const(p["disc_lo"])) \
            & (disc <= self.const(p["disc_hi"])) \
            & (L.p("l_quantity") < self.const(p["qty_max"]))
        rev = (L.f("l_extendedprice")[m] * L.f("l_discount")[m]).sum()
        return self._frame("q6", {"revenue": rev.reshape(1)})

    def q7(self, p):
        L, O, C = self.t("lineitem"), self.t("orders"), self.t("customer")
        S, N = self.t("supplier"), self.t("nation")
        sd = L.i("l_shipdate")
        s_nat = S.i("s_nationkey")[L.i("l_suppkey")]
        c_nat = C.i("c_nationkey")[O.i("o_custkey")[L.i("l_orderkey")]]
        fr, de = N.code("n_name", "FRANCE"), N.code("n_name", "GERMANY")
        s_name, c_name = N.i("n_name")[s_nat], N.i("n_name")[c_nat]
        m = (sd >= days("1995-01-01")) & (sd < days("1997-01-01")) \
            & (((s_name == fr) & (c_name == de))
               | ((s_name == de) & (c_name == fr)))
        y_off = self.year(sd[m]) - 1992
        (sn, cn, yo), s, _n = self._group(
            [s_name[m], c_name[m], y_off], {"revenue": self._revenue(L, m)})
        return self._frame("q7", {
            "supp_nation": N.decode("n_name", sn),
            "cust_nation": N.decode("n_name", cn), "y_off": yo,
            "revenue": s["revenue"], "l_year": yo + 1992})

    def _q9(self, q, profit_of):
        L, O, S = self.t("lineitem"), self.t("orders"), self.t("supplier")
        P, N = self.t("part"), self.t("nation")
        m = P.has_word("p_name", "green")[L.i("l_partkey")]
        nat = S.i("s_nationkey")[L.i("l_suppkey")[m]]
        y_off = self.year(O.i("o_orderdate")[L.i("l_orderkey")[m]]) - 1992
        (nk, yo), s, _n = self._group([N.i("n_name")[nat], y_off],
                                      {"sum_profit": profit_of(m)})
        return self._frame(q, {"n_name": N.decode("n_name", nk),
                               "y_off": yo, "sum_profit": s["sum_profit"],
                               "o_year": yo + 1992})

    def q9(self, p):
        return self._q9("q9", lambda m: self._revenue(self.t("lineitem"), m))

    def q9full(self, p):
        L, PS = self.t("lineitem"), self.t("partsupp")

        def profit(m):
            # the composite key (partkey, suppkey) through a sorted search
            width = int(max(PS.i("ps_suppkey").max(),
                            L.i("l_suppkey").max())) + 1
            ps_key = PS.i("ps_partkey") * width + PS.i("ps_suppkey")
            order = torch.argsort(ps_key)
            l_key = L.i("l_partkey")[m] * width + L.i("l_suppkey")[m]
            at = torch.searchsorted(ps_key[order], l_key)
            at = order[at.clamp(max=ps_key.shape[0] - 1)]
            hit = ps_key[at] == l_key
            cost = torch.where(hit, PS.f("ps_supplycost")[at], 0.0)
            return self._revenue(L, m) - cost * L.f("l_quantity")[m]

        return self._q9("q9full", profit)

    def q10(self, p):
        L, O, C, N = (self.t("lineitem"), self.t("orders"),
                      self.t("customer"), self.t("nation"))
        od = O.i("o_orderdate")
        o_ok = (od >= days("1993-10-01")) & (od < days("1994-01-01"))
        lo = L.i("l_orderkey")
        m = L.eq("l_returnflag", "R") & o_ok[lo]
        cust = O.i("o_custkey")[lo[m]]
        (ck,), s, _n = self._group([cust], {"revenue": self._revenue(L, m)})
        return self._frame("q10", {
            "c_custkey": ck, "c_acctbal": C.f("c_acctbal")[ck],
            "n_name": N.decode("n_name",
                               N.i("n_name")[C.i("c_nationkey")[ck]]),
            "revenue": s["revenue"]})

    def q12(self, p):
        L, O = self.t("lineitem"), self.t("orders")
        rd, cd, sd = (L.i("l_receiptdate"), L.i("l_commitdate"),
                      L.i("l_shipdate"))
        m = L.isin("l_shipmode", (p["mode1"], p["mode2"])) & (cd < rd) \
            & (sd < cd) & (rd >= p["receipt_lo"]) & (rd < p["receipt_hi"])
        urgent = O.isin("o_orderpriority", ("1-URGENT", "2-HIGH"))[
            L.i("l_orderkey")[m]].to(self.fdt)
        (mode,), s, _n = self._group([L.i("l_shipmode")[m]], {
            "high_line_count": urgent, "low_line_count": 1 - urgent})
        return self._frame("q12", {
            "l_shipmode": L.decode("l_shipmode", mode),
            "high_line_count": s["high_line_count"],
            "low_line_count": s["low_line_count"]})

    def q13(self, p):
        O, C = self.t("orders"), self.t("customer")
        keep = ~(O.has_word("o_comment", "special")
                 & O.has_word("o_comment", "requests"))
        per_cust = torch.bincount(O.i("o_custkey")[keep],
                                  minlength=C.i("c_custkey").shape[0])
        c_count = per_cust[C.i("c_custkey")]
        (cc,), _s, n = self._group([c_count], {})
        return self._frame("q13", {"c_count": cc, "custdist": n})

    def q14(self, p):
        L, P = self.t("lineitem"), self.t("part")
        sd = L.i("l_shipdate")
        m = (sd >= p["ship_lo"]) & (sd < p["ship_hi"])
        rev = self._revenue(L, m)
        promo = P.startswith("p_type", p["promo_prefix"])[L.i("l_partkey")[m]]
        share = 100 * torch.where(promo, rev, 0).sum() / rev.sum()
        return self._frame("q14", {"promo_revenue": share.reshape(1)})

    def q17(self, p):
        L, P = self.t("lineitem"), self.t("part")
        lp = L.i("l_partkey")
        n_part = P.i("p_partkey").shape[0]
        qty = L.f("l_quantity")
        avg = torch.zeros(n_part, dtype=self.fdt, device=self.device) \
            .index_add_(0, lp, qty) / torch.bincount(lp, minlength=n_part)
        part_ok = P.eq("p_brand", "Brand#23") & P.eq("p_container", "MED BOX")
        m = part_ok[lp] & (qty < 0.2 * avg[lp])
        total = L.f("l_extendedprice")[m].sum()
        return self._frame("q17", {"avg_yearly": (total / 7.0).reshape(1)})

    def q18(self, p):
        L, O, C = self.t("lineitem"), self.t("orders"), self.t("customer")
        n_ord = O.i("o_orderkey").shape[0]
        sum_qty = torch.zeros(n_ord, dtype=self.fdt, device=self.device) \
            .index_add_(0, L.i("l_orderkey"), L.f("l_quantity"))
        ok = torch.nonzero(sum_qty > 212.0).flatten()
        ck = O.i("o_custkey")[ok]
        return self._frame("q18", {
            "c_name": C.decode("c_name", C.i("c_name")[ck]), "c_custkey": ck,
            "o_orderkey": ok, "o_orderdate": O.i("o_orderdate")[ok],
            "o_totalprice": O.f("o_totalprice")[ok],
            "sum_qty": sum_qty[ok]})

    def q19(self, p):
        L, P = self.t("lineitem"), self.t("part")
        lp = L.i("l_partkey")
        qty = L.p("l_quantity")
        size = P.i("p_size")[lp]
        base = L.isin("l_shipmode", ("AIR", "REG AIR")) \
            & L.eq("l_shipinstruct", "DELIVER IN PERSON")
        m = torch.zeros_like(base)
        for k, (size_hi, boxes) in enumerate((
                (5, ("SM CASE", "SM BOX", "SM PACK", "SM PKG")),
                (10, ("MED BAG", "MED BOX", "MED PKG", "MED PACK")),
                (15, ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))), start=1):
            part_ok = P.eq("p_brand", p[f"brand{k}"]) \
                & P.isin("p_container", boxes)
            m |= part_ok[lp] & (qty >= self.const(p[f"qty{k}_lo"])) \
                & (qty <= self.const(p[f"qty{k}_hi"])) \
                & (size >= 1) & (size <= size_hi)
        m &= base
        return self._frame("q19", {"revenue": self._revenue(L, m).sum()
                                   .reshape(1)})
