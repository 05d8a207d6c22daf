"""Relational schema metadata.

Column kinds:
  INT     — int32 scalar column (keys, quantities, sizes)
  FLOAT   — float32 scalar column (prices, discounts)
  DATE    — int32 days-since-1970 (TPC-H dates parse into this)
  CAT     — categorical string: stored as int32 dictionary codes with a
            small vocabulary (e.g. L_SHIPMODE).  The *unoptimized* engine
            configurations materialize a fixed-width uint8 char matrix and
            do strcmp-style byte comparisons; the StringDictionary pass
            keeps the int codes (paper §3.4).
  TEXT    — multi-word string: stored as an (nrows, max_words) int32 word-
            code matrix (word-tokenizing dictionary, paper §3.4 / Q13).

Primary/foreign keys are declared at schema definition time — the paper's
partitioning optimization (§3.2.1) is driven from exactly this annotation.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ColKind(enum.Enum):
    INT = "int"
    FLOAT = "float"
    DATE = "date"
    CAT = "cat"
    TEXT = "text"


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    kind: ColKind
    # For CAT columns: declared max width of the char representation.
    char_width: int = 0
    # For TEXT columns: max number of words per row.
    max_words: int = 0


@dataclasses.dataclass(frozen=True)
class ForeignKey:
    column: str
    ref_table: str
    ref_column: str


@dataclasses.dataclass
class TableSchema:
    name: str
    columns: list[ColumnDef]
    primary_key: tuple[str, ...] = ()
    foreign_keys: tuple[ForeignKey, ...] = ()

    def __post_init__(self) -> None:
        self._by_name = {c.name: c for c in self.columns}

    def col(self, name: str) -> ColumnDef:
        return self._by_name[name]

    def has_col(self, name: str) -> bool:
        return name in self._by_name

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def fk_for(self, column: str) -> Optional[ForeignKey]:
        for fk in self.foreign_keys:
            if fk.column == column:
                return fk
        return None


def days(date_str: str) -> int:
    """Parse 'YYYY-MM-DD' into int days since 1970-01-01 (host-side)."""
    import numpy as np

    return int(np.datetime64(date_str, "D").astype(np.int64))


# ---------------------------------------------------------------------------
# TPC-H schema (the attribute subset exercised by our query plans, plus a
# few extras so column pruning has something to prune).
# ---------------------------------------------------------------------------

def _c(name: str, kind: ColKind, **kw) -> ColumnDef:
    return ColumnDef(name, kind, **kw)


TPCH_SCHEMAS: dict[str, TableSchema] = {}


def _register(schema: TableSchema) -> TableSchema:
    TPCH_SCHEMAS[schema.name] = schema
    return schema


REGION = _register(TableSchema(
    "region",
    [
        _c("r_regionkey", ColKind.INT),
        _c("r_name", ColKind.CAT, char_width=16),
    ],
    primary_key=("r_regionkey",),
))

NATION = _register(TableSchema(
    "nation",
    [
        _c("n_nationkey", ColKind.INT),
        _c("n_name", ColKind.CAT, char_width=16),
        _c("n_regionkey", ColKind.INT),
    ],
    primary_key=("n_nationkey",),
    foreign_keys=(ForeignKey("n_regionkey", "region", "r_regionkey"),),
))

SUPPLIER = _register(TableSchema(
    "supplier",
    [
        _c("s_suppkey", ColKind.INT),
        _c("s_name", ColKind.CAT, char_width=20),
        _c("s_nationkey", ColKind.INT),
        _c("s_acctbal", ColKind.FLOAT),
        _c("s_comment", ColKind.TEXT, max_words=8),
    ],
    primary_key=("s_suppkey",),
    foreign_keys=(ForeignKey("s_nationkey", "nation", "n_nationkey"),),
))

CUSTOMER = _register(TableSchema(
    "customer",
    [
        _c("c_custkey", ColKind.INT),
        _c("c_name", ColKind.CAT, char_width=20),
        _c("c_nationkey", ColKind.INT),
        _c("c_acctbal", ColKind.FLOAT),
        _c("c_mktsegment", ColKind.CAT, char_width=12),
        _c("c_phone", ColKind.CAT, char_width=16),
        _c("c_comment", ColKind.TEXT, max_words=8),
    ],
    primary_key=("c_custkey",),
    foreign_keys=(ForeignKey("c_nationkey", "nation", "n_nationkey"),),
))

PART = _register(TableSchema(
    "part",
    [
        _c("p_partkey", ColKind.INT),
        _c("p_name", ColKind.TEXT, max_words=5),
        _c("p_mfgr", ColKind.CAT, char_width=16),
        _c("p_brand", ColKind.CAT, char_width=12),
        _c("p_type", ColKind.CAT, char_width=28),
        _c("p_size", ColKind.INT),
        _c("p_container", ColKind.CAT, char_width=12),
        _c("p_retailprice", ColKind.FLOAT),
    ],
    primary_key=("p_partkey",),
))

PARTSUPP = _register(TableSchema(
    "partsupp",
    [
        _c("ps_partkey", ColKind.INT),
        _c("ps_suppkey", ColKind.INT),
        _c("ps_availqty", ColKind.INT),
        _c("ps_supplycost", ColKind.FLOAT),
    ],
    primary_key=("ps_partkey", "ps_suppkey"),
    foreign_keys=(
        ForeignKey("ps_partkey", "part", "p_partkey"),
        ForeignKey("ps_suppkey", "supplier", "s_suppkey"),
    ),
))

ORDERS = _register(TableSchema(
    "orders",
    [
        _c("o_orderkey", ColKind.INT),
        _c("o_custkey", ColKind.INT),
        _c("o_orderstatus", ColKind.CAT, char_width=4),
        _c("o_totalprice", ColKind.FLOAT),
        _c("o_orderdate", ColKind.DATE),
        _c("o_orderpriority", ColKind.CAT, char_width=16),
        _c("o_shippriority", ColKind.INT),
        _c("o_comment", ColKind.TEXT, max_words=8),
    ],
    primary_key=("o_orderkey",),
    foreign_keys=(ForeignKey("o_custkey", "customer", "c_custkey"),),
))

LINEITEM = _register(TableSchema(
    "lineitem",
    [
        _c("l_orderkey", ColKind.INT),
        _c("l_partkey", ColKind.INT),
        _c("l_suppkey", ColKind.INT),
        _c("l_linenumber", ColKind.INT),
        _c("l_quantity", ColKind.FLOAT),
        _c("l_extendedprice", ColKind.FLOAT),
        _c("l_discount", ColKind.FLOAT),
        _c("l_tax", ColKind.FLOAT),
        _c("l_returnflag", ColKind.CAT, char_width=4),
        _c("l_linestatus", ColKind.CAT, char_width=4),
        _c("l_shipdate", ColKind.DATE),
        _c("l_commitdate", ColKind.DATE),
        _c("l_receiptdate", ColKind.DATE),
        _c("l_shipinstruct", ColKind.CAT, char_width=20),
        _c("l_shipmode", ColKind.CAT, char_width=12),
    ],
    # Composite primary key — per the paper (§3.2.1) no dense PK array is
    # built for lineitem; it is instead partitioned on its foreign keys.
    primary_key=("l_orderkey", "l_linenumber"),
    foreign_keys=(
        ForeignKey("l_orderkey", "orders", "o_orderkey"),
        ForeignKey("l_partkey", "part", "p_partkey"),
        ForeignKey("l_suppkey", "supplier", "s_suppkey"),
    ),
))
