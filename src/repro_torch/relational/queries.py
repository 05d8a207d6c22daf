"""TPC-H query plans (the physical plans LegoBase receives, Fig 4/Fig 8).

Each builder returns a *fresh* logical plan (passes mutate plans in place).
Join orientation follows the paper's partitioned execution: the fact side
streams and dimension/parent sides build.  Group-bys on keys functionally
determining other attributes use carry columns (Q3, Q10, Q18), matching the
paper's single-key aggregation maps.

15 TPC-H query plans are implemented (incl. two Q9 variants) — chosen to cover every
optimization in §3 (the remaining queries exercise no additional engine
feature: correlated sub-queries are rewritten the same way Q17/Q18 are).
"""
from __future__ import annotations

from repro_torch.core.expr import (And, Arith, Cmp, Not, Or, Param,
                             StrContainsWord, StrEq, StrIn, StrStartsWith,
                             Where, Year, col, lit)
from repro_torch.core.ir import Agg, AggSpec, Join, Limit, Plan, Project, Scan, Select, Sort
from repro_torch.relational.schema import days


def _between(c: str, lo, hi) -> And:
    return And(Cmp(">=", col(c), lit(lo)), Cmp("<=", col(c), lit(hi)))


def _date_in(c: str, lo: str, hi: str) -> And:
    """lo <= c < hi over date strings."""
    return And(Cmp(">=", col(c), lit(days(lo))), Cmp("<", col(c), lit(days(hi))))


def _revenue() -> Arith:
    return Arith("*", col("l_extendedprice"),
                 Arith("-", lit(1.0), col("l_discount")))


# ---------------------------------------------------------------------------

def q1() -> Plan:
    disc_price = _revenue()
    charge = Arith("*", disc_price, Arith("+", lit(1.0), col("l_tax")))
    sel = Select(Scan("lineitem"),
                 Cmp("<=", col("l_shipdate"), lit(days("1998-09-02"))))
    agg = Agg(sel, ["l_returnflag", "l_linestatus"], [
        AggSpec("sum_qty", "sum", col("l_quantity")),
        AggSpec("sum_base_price", "sum", col("l_extendedprice")),
        AggSpec("sum_disc_price", "sum", disc_price),
        AggSpec("sum_charge", "sum", charge),
        AggSpec("avg_qty", "avg", col("l_quantity")),
        AggSpec("avg_price", "avg", col("l_extendedprice")),
        AggSpec("avg_disc", "avg", col("l_discount")),
        AggSpec("count_order", "count"),
    ])
    return Sort(agg, [("l_returnflag", True), ("l_linestatus", True)])


def q3() -> Plan:
    li = Select(Scan("lineitem"),
                Cmp(">", col("l_shipdate"), lit(days("1995-03-15"))))
    orders = Select(Scan("orders"),
                    Cmp("<", col("o_orderdate"), lit(days("1995-03-15"))))
    cust = Select(Scan("customer"), StrEq("c_mktsegment", "BUILDING"))
    j1 = Join(li, orders, "l_orderkey", "o_orderkey")
    j2 = Join(j1, cust, "o_custkey", "c_custkey")
    agg = Agg(j2, ["l_orderkey"],
              [AggSpec("revenue", "sum", _revenue())],
              carry=["o_orderdate", "o_shippriority"])
    srt = Sort(agg, [("revenue", False), ("o_orderdate", True)])
    return Limit(srt, 10)


def q4() -> Plan:
    orders = Select(Scan("orders"),
                    _date_in("o_orderdate", "1993-07-01", "1993-10-01"))
    li = Select(Scan("lineitem"),
                Cmp("<", col("l_commitdate"), col("l_receiptdate")))
    semi = Join(orders, li, "o_orderkey", "l_orderkey", kind="semi")
    agg = Agg(semi, ["o_orderpriority"], [AggSpec("order_count", "count")])
    return Sort(agg, [("o_orderpriority", True)])


def q5() -> Plan:
    orders = Select(Scan("orders"),
                    _date_in("o_orderdate", "1994-01-01", "1995-01-01"))
    region = Select(Scan("region"), StrEq("r_name", "ASIA"))
    j1 = Join(Scan("lineitem"), orders, "l_orderkey", "o_orderkey")
    j2 = Join(j1, Scan("customer"), "o_custkey", "c_custkey")
    j3 = Join(j2, Scan("supplier"), "l_suppkey", "s_suppkey")
    j4 = Join(j3, Scan("nation"), "s_nationkey", "n_nationkey")
    j5 = Join(j4, region, "n_regionkey", "r_regionkey")
    sel = Select(j5, Cmp("==", col("c_nationkey"), col("s_nationkey")))
    agg = Agg(sel, ["n_name"], [AggSpec("revenue", "sum", _revenue())])
    return Sort(agg, [("revenue", False)])


def q6() -> Plan:
    pred = And(And(_date_in("l_shipdate", "1994-01-01", "1995-01-01"),
                   _between("l_discount", 0.05, 0.07)),
               Cmp("<", col("l_quantity"), lit(24.0)))
    sel = Select(Scan("lineitem"), pred)
    return Agg(sel, [], [AggSpec("revenue", "sum",
                                 Arith("*", col("l_extendedprice"),
                                       col("l_discount")))])


def q7() -> Plan:
    n1 = Project(Scan("nation"),
                 {"supp_nation": col("n_name"), "n1_key": col("n_nationkey")},
                 keep_input=False)
    n2 = Project(Scan("nation"),
                 {"cust_nation": col("n_name"), "n2_key": col("n_nationkey")},
                 keep_input=False)
    li = Select(Scan("lineitem"),
                _date_in("l_shipdate", "1995-01-01", "1997-01-01"))
    j1 = Join(li, Scan("orders"), "l_orderkey", "o_orderkey")
    j2 = Join(j1, Scan("customer"), "o_custkey", "c_custkey")
    j3 = Join(j2, Scan("supplier"), "l_suppkey", "s_suppkey")
    j4 = Join(j3, n1, "s_nationkey", "n1_key")
    j5 = Join(j4, n2, "c_nationkey", "n2_key")
    pair = Or(And(StrEq("supp_nation", "FRANCE"), StrEq("cust_nation", "GERMANY")),
              And(StrEq("supp_nation", "GERMANY"), StrEq("cust_nation", "FRANCE")))
    sel = Select(j5, pair)
    # group key offset to the data's year range (1992..1998): the dense
    # aggregation array is sized by the key domain (paper §3.2.2 worst-case
    # preallocation) — domain 8 instead of 2000.
    proj = Project(sel, {"y_off": Arith("-", Year(col("l_shipdate")),
                                        lit(1992))})
    agg = Agg(proj, ["supp_nation", "cust_nation", "y_off"],
              [AggSpec("revenue", "sum", _revenue())],
              domain_hints={"y_off": 8})
    post = Project(agg, {"l_year": Arith("+", col("y_off"), lit(1992))})
    return Sort(post, [("supp_nation", True), ("cust_nation", True),
                       ("l_year", True)])


def q9() -> Plan:
    """Q9 (product-type profit), simplified: the ps_supplycost term (a
    composite-key partsupp join) is dropped — profit = revenue.  Exercises
    the word-tokenizing dictionary on p_name ('green'), Year() grouping,
    and a 4-way gather chain."""
    part = Select(Scan("part"), StrContainsWord("p_name", "green"))
    j1 = Join(Scan("lineitem"), part, "l_partkey", "p_partkey")
    j2 = Join(j1, Scan("supplier"), "l_suppkey", "s_suppkey")
    j3 = Join(j2, Scan("nation"), "s_nationkey", "n_nationkey")
    j4 = Join(j3, Scan("orders"), "l_orderkey", "o_orderkey")
    proj = Project(j4, {"y_off": Arith("-", Year(col("o_orderdate")),
                                       lit(1992))})
    agg = Agg(proj, ["n_name", "y_off"],
              [AggSpec("sum_profit", "sum", _revenue())],
              domain_hints={"y_off": 8})
    post = Project(agg, {"o_year": Arith("+", col("y_off"), lit(1992))})
    return Sort(post, [("n_name", True), ("o_year", False)])


def q9_full() -> Plan:
    """Q9 with the ps_supplycost term: the lineitem→partsupp join is on the
    composite primary key (l_partkey, l_suppkey) = (ps_partkey, ps_suppkey),
    exercising the §3.2.1 composite-PK 2-D partitioned array
    (Join.strategy='bucket_gather')."""
    part = Select(Scan("part"), StrContainsWord("p_name", "green"))
    j1 = Join(Scan("lineitem"), part, "l_partkey", "p_partkey")
    j2 = Join(j1, Scan("supplier"), "l_suppkey", "s_suppkey")
    j3 = Join(j2, Scan("nation"), "s_nationkey", "n_nationkey")
    j4 = Join(j3, Scan("orders"), "l_orderkey", "o_orderkey")
    j5 = Join(j4, Scan("partsupp"), "l_partkey", "ps_partkey",
              stream_key2="l_suppkey", build_key2="ps_suppkey")
    profit = Arith("-", _revenue(),
                   Arith("*", col("ps_supplycost"), col("l_quantity")))
    proj = Project(j5, {"y_off": Arith("-", Year(col("o_orderdate")),
                                       lit(1992))})
    agg = Agg(proj, ["n_name", "y_off"],
              [AggSpec("sum_profit", "sum", profit)],
              domain_hints={"y_off": 8})
    post = Project(agg, {"o_year": Arith("+", col("y_off"), lit(1992))})
    return Sort(post, [("n_name", True), ("o_year", False)])


def q10() -> Plan:
    li = Select(Scan("lineitem"), StrEq("l_returnflag", "R"))
    orders = Select(Scan("orders"),
                    _date_in("o_orderdate", "1993-10-01", "1994-01-01"))
    j1 = Join(li, orders, "l_orderkey", "o_orderkey")
    j2 = Join(j1, Scan("customer"), "o_custkey", "c_custkey")
    j3 = Join(j2, Scan("nation"), "c_nationkey", "n_nationkey")
    agg = Agg(j3, ["c_custkey"], [AggSpec("revenue", "sum", _revenue())],
              carry=["c_acctbal", "n_name"])
    srt = Sort(agg, [("revenue", False)])
    return Limit(srt, 20)


def q12() -> Plan:
    pred = And(And(StrIn("l_shipmode", ("MAIL", "SHIP")),
                   Cmp("<", col("l_commitdate"), col("l_receiptdate"))),
               And(Cmp("<", col("l_shipdate"), col("l_commitdate")),
                   _date_in("l_receiptdate", "1994-01-01", "1995-01-01")))
    li = Select(Scan("lineitem"), pred)
    j = Join(li, Scan("orders"), "l_orderkey", "o_orderkey")
    urgent = StrIn("o_orderpriority", ("1-URGENT", "2-HIGH"))
    agg = Agg(j, ["l_shipmode"], [
        AggSpec("high_line_count", "sum", Where(urgent, lit(1.0), lit(0.0))),
        AggSpec("low_line_count", "sum", Where(urgent, lit(0.0), lit(1.0))),
    ])
    return Sort(agg, [("l_shipmode", True)])


def q13() -> Plan:
    orders = Select(Scan("orders"),
                    Not(And(StrContainsWord("o_comment", "special"),
                            StrContainsWord("o_comment", "requests"))))
    per_cust = Agg(orders, ["o_custkey"], [AggSpec("c_count", "count")])
    j = Join(Scan("customer"), per_cust, "c_custkey", "o_custkey", kind="left")
    agg = Agg(j, ["c_count"], [AggSpec("custdist", "count")],
              domain_hints={"c_count": 64})
    return Sort(agg, [("custdist", False), ("c_count", False)])


def q14() -> Plan:
    li = Select(Scan("lineitem"),
                _date_in("l_shipdate", "1995-09-01", "1995-10-01"))
    j = Join(li, Scan("part"), "l_partkey", "p_partkey")
    rev = _revenue()
    agg = Agg(j, [], [
        AggSpec("promo", "sum",
                Where(StrStartsWith("p_type", "PROMO"), rev, lit(0.0))),
        AggSpec("total", "sum", rev),
    ])
    return Project(agg, {"promo_revenue":
                         Arith("/", Arith("*", lit(100.0), col("promo")),
                               col("total"))}, keep_input=False)


def q17() -> Plan:
    per_part = Agg(Scan("lineitem"), ["l_partkey"],
                   [AggSpec("avg_qty", "avg", col("l_quantity"))])
    part = Select(Scan("part"), And(StrEq("p_brand", "Brand#23"),
                                    StrEq("p_container", "MED BOX")))
    j1 = Join(Scan("lineitem"), part, "l_partkey", "p_partkey")
    j2 = Join(j1, per_part, "l_partkey", "l_partkey")
    sel = Select(j2, Cmp("<", col("l_quantity"),
                         Arith("*", lit(0.2), col("avg_qty"))))
    agg = Agg(sel, [], [AggSpec("total", "sum", col("l_extendedprice"))])
    return Project(agg, {"avg_yearly": Arith("/", col("total"), lit(7.0))},
                   keep_input=False)


def q18() -> Plan:
    # HAVING sum(l_quantity) > 212: threshold adapted to the synthetic
    # generator's 1–7 lines/order so the result is non-trivial (TPC-H's 300
    # is near the max possible 350 here).
    big = Select(Agg(Scan("lineitem"), ["l_orderkey"],
                     [AggSpec("sum_qty", "sum", col("l_quantity"))]),
                 Cmp(">", col("sum_qty"), lit(212.0)))
    j1 = Join(Scan("orders"), big, "o_orderkey", "l_orderkey")
    j2 = Join(j1, Scan("customer"), "o_custkey", "c_custkey")
    proj = Project(j2, {"c_name": col("c_name"), "c_custkey": col("c_custkey"),
                        "o_orderkey": col("o_orderkey"),
                        "o_orderdate": col("o_orderdate"),
                        "o_totalprice": col("o_totalprice"),
                        "sum_qty": col("sum_qty")}, keep_input=False)
    srt = Sort(proj, [("o_totalprice", False), ("o_orderdate", True)])
    return Limit(srt, 100)


def q19() -> Plan:
    li = Select(Scan("lineitem"),
                And(StrIn("l_shipmode", ("AIR", "REG AIR")),
                    StrEq("l_shipinstruct", "DELIVER IN PERSON")))
    j = Join(li, Scan("part"), "l_partkey", "p_partkey")
    c1 = And(And(StrEq("p_brand", "Brand#12"),
                 StrIn("p_container", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"))),
             And(_between("l_quantity", 1.0, 11.0), _between("p_size", 1, 5)))
    c2 = And(And(StrEq("p_brand", "Brand#23"),
                 StrIn("p_container", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"))),
             And(_between("l_quantity", 10.0, 20.0), _between("p_size", 1, 10)))
    c3 = And(And(StrEq("p_brand", "Brand#34"),
                 StrIn("p_container", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))),
             And(_between("l_quantity", 20.0, 30.0), _between("p_size", 1, 15)))
    sel = Select(j, Or(Or(c1, c2), c3))
    return Agg(sel, [], [AggSpec("revenue", "sum", _revenue())])


QUERIES: dict[str, object] = {
    "q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7, "q9": q9,
    "q9full": q9_full, "q10": q10, "q12": q12, "q13": q13, "q14": q14,
    "q17": q17, "q18": q18, "q19": q19,
}


# ---------------------------------------------------------------------------
# Parameterized variants (compile-once / bind-many, the runtime layer's
# workload).  Numeric Params are runtime-bound scalar inputs of the staged
# program; the string segment and the Limit count are compile-time params
# (part of the plan-cache key).  Each default binding reproduces the literal
# query above exactly.
# ---------------------------------------------------------------------------

def q1_param() -> Plan:
    plan = q1()
    sel = plan.child.child          # Sort -> Agg -> Select
    sel.pred = Cmp("<=", col("l_shipdate"), Param("shipdate_hi", "int32"))
    return plan


Q1_DEFAULTS = {"shipdate_hi": days("1998-09-02")}


def q3_param() -> Plan:
    cutoff = Param("cutoff", "int32")
    li = Select(Scan("lineitem"), Cmp(">", col("l_shipdate"), cutoff))
    orders = Select(Scan("orders"), Cmp("<", col("o_orderdate"), cutoff))
    cust = Select(Scan("customer"),
                  StrEq("c_mktsegment", Param("segment", "str")))
    j1 = Join(li, orders, "l_orderkey", "o_orderkey")
    j2 = Join(j1, cust, "o_custkey", "c_custkey")
    agg = Agg(j2, ["l_orderkey"],
              [AggSpec("revenue", "sum", _revenue())],
              carry=["o_orderdate", "o_shippriority"])
    srt = Sort(agg, [("revenue", False), ("o_orderdate", True)])
    return Limit(srt, Param("topn", "int32"))


Q3_DEFAULTS = {"cutoff": days("1995-03-15"), "segment": "BUILDING",
               "topn": 10}


def q6_param() -> Plan:
    pred = And(And(And(Cmp(">=", col("l_shipdate"), Param("date_lo", "int32")),
                       Cmp("<", col("l_shipdate"), Param("date_hi", "int32"))),
               And(Cmp(">=", col("l_discount"), Param("disc_lo", "float32")),
                   Cmp("<=", col("l_discount"), Param("disc_hi", "float32")))),
               Cmp("<", col("l_quantity"), Param("qty_max", "float32")))
    sel = Select(Scan("lineitem"), pred)
    return Agg(sel, [], [AggSpec("revenue", "sum",
                                 Arith("*", col("l_extendedprice"),
                                       col("l_discount")))])


Q6_DEFAULTS = {"date_lo": days("1994-01-01"), "date_hi": days("1995-01-01"),
               "disc_lo": 0.05, "disc_hi": 0.07, "qty_max": 24.0}


def q12_param() -> Plan:
    """Shipmode strings are compile-time params (the StrIn rewrite needs
    dictionary codes); the receipt-date window is runtime-bound."""
    pred = And(And(StrIn("l_shipmode", (Param("mode1", "str"),
                                        Param("mode2", "str"))),
                   Cmp("<", col("l_commitdate"), col("l_receiptdate"))),
               And(Cmp("<", col("l_shipdate"), col("l_commitdate")),
                   And(Cmp(">=", col("l_receiptdate"),
                           Param("receipt_lo", "int32")),
                       Cmp("<", col("l_receiptdate"),
                           Param("receipt_hi", "int32")))))
    li = Select(Scan("lineitem"), pred)
    j = Join(li, Scan("orders"), "l_orderkey", "o_orderkey")
    urgent = StrIn("o_orderpriority", ("1-URGENT", "2-HIGH"))
    agg = Agg(j, ["l_shipmode"], [
        AggSpec("high_line_count", "sum", Where(urgent, lit(1.0), lit(0.0))),
        AggSpec("low_line_count", "sum", Where(urgent, lit(0.0), lit(1.0))),
    ])
    return Sort(agg, [("l_shipmode", True)])


Q12_DEFAULTS = {"mode1": "MAIL", "mode2": "SHIP",
                "receipt_lo": days("1994-01-01"),
                "receipt_hi": days("1995-01-01")}


def q14_param() -> Plan:
    """Date range over the lineitem/part join as runtime params; the
    promo prefix is compile-time (StrStartsWith needs the concrete
    prefix for the dictionary-range rewrite)."""
    li = Select(Scan("lineitem"),
                And(Cmp(">=", col("l_shipdate"), Param("ship_lo", "int32")),
                    Cmp("<", col("l_shipdate"), Param("ship_hi", "int32"))))
    j = Join(li, Scan("part"), "l_partkey", "p_partkey")
    rev = _revenue()
    agg = Agg(j, [], [
        AggSpec("promo", "sum",
                Where(StrStartsWith("p_type", Param("promo_prefix", "str")),
                      rev, lit(0.0))),
        AggSpec("total", "sum", rev),
    ])
    return Project(agg, {"promo_revenue":
                         Arith("/", Arith("*", lit(100.0), col("promo")),
                               col("total"))}, keep_input=False)


Q14_DEFAULTS = {"ship_lo": days("1995-09-01"), "ship_hi": days("1995-10-01"),
                "promo_prefix": "PROMO"}


def q19_param() -> Plan:
    """Disjunctive predicate: per-branch quantity windows are runtime
    params, the three brands compile-time string params."""
    li = Select(Scan("lineitem"),
                And(StrIn("l_shipmode", ("AIR", "REG AIR")),
                    StrEq("l_shipinstruct", "DELIVER IN PERSON")))
    j = Join(li, Scan("part"), "l_partkey", "p_partkey")

    def qty(lo, hi):
        return And(Cmp(">=", col("l_quantity"), Param(lo, "float32")),
                   Cmp("<=", col("l_quantity"), Param(hi, "float32")))

    c1 = And(And(StrEq("p_brand", Param("brand1", "str")),
                 StrIn("p_container", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"))),
             And(qty("qty1_lo", "qty1_hi"), _between("p_size", 1, 5)))
    c2 = And(And(StrEq("p_brand", Param("brand2", "str")),
                 StrIn("p_container", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"))),
             And(qty("qty2_lo", "qty2_hi"), _between("p_size", 1, 10)))
    c3 = And(And(StrEq("p_brand", Param("brand3", "str")),
                 StrIn("p_container", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))),
             And(qty("qty3_lo", "qty3_hi"), _between("p_size", 1, 15)))
    sel = Select(j, Or(Or(c1, c2), c3))
    return Agg(sel, [], [AggSpec("revenue", "sum", _revenue())])


Q19_DEFAULTS = {"brand1": "Brand#12", "qty1_lo": 1.0, "qty1_hi": 11.0,
                "brand2": "Brand#23", "qty2_lo": 10.0, "qty2_hi": 20.0,
                "brand3": "Brand#34", "qty3_lo": 20.0, "qty3_hi": 30.0}


# name -> (plan builder, default bindings matching the literal query)
PARAM_QUERIES: dict[str, tuple] = {
    "q1": (q1_param, Q1_DEFAULTS),
    "q3": (q3_param, Q3_DEFAULTS),
    "q6": (q6_param, Q6_DEFAULTS),
    "q12": (q12_param, Q12_DEFAULTS),
    "q14": (q14_param, Q14_DEFAULTS),
    "q19": (q19_param, Q19_DEFAULTS),
}

# alternative runtime bindings (overlay on the defaults) used by the cache
# tests and bench_plan_cache to exercise the re-bind path with a different,
# non-empty result.  Only *runtime* params are overridden: the same plan
# key (and therefore the same staged program / batch group) must serve
# both the default and the alternative bindings.
PARAM_ALT_BINDINGS: dict[str, dict] = {
    "q1": {"shipdate_hi": days("1997-06-30")},
    "q3": {"cutoff": days("1995-06-15")},
    "q6": {"date_lo": days("1995-01-01"), "date_hi": days("1996-01-01"),
           "qty_max": 30.0},
    "q12": {"receipt_lo": days("1995-01-01"),
            "receipt_hi": days("1996-01-01")},
    "q14": {"ship_lo": days("1994-03-01"), "ship_hi": days("1994-06-01")},
    "q19": {"qty1_lo": 2.0, "qty1_hi": 14.0, "qty2_lo": 8.0,
            "qty2_hi": 24.0, "qty3_lo": 16.0, "qty3_hi": 34.0},
}
