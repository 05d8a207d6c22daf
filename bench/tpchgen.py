"""The benchmark's TPC-H data generator: a frozen copy of the port's numpy
generator (`repro_torch/relational/tpch.py`), kept here so that the data a
cell runs on does not move when the program's generator does.

It draws the same arrays as the port's at the same scale factor and seed,
bit for bit (`bench/tests/test_bench_reference.py` holds the two
together), and returns plain arrays: the benchmark hands them to the
program (`Database.from_arrays`) and to the plain reference alike.
Primary keys are dense 0-based ranges, dates are int32 days since
1970-01-01, categorical columns are codes into a sorted vocabulary and
text columns word codes (-1 padding) into a word vocabulary.
"""
from __future__ import annotations

import numpy as np


def days(date_str: str) -> int:
    """'YYYY-MM-DD' as int days since 1970-01-01."""
    return int(np.datetime64(date_str, "D").astype(np.int64))


def _table(columns: dict, vocabs: dict | None = None,
           word_vocabs: dict | None = None) -> dict:
    return {"columns": columns, "vocabs": vocabs or {},
            "word_vocabs": word_vocabs or {}}


EPOCH = np.datetime64("1970-01-01", "D")
DATE_LO = int(np.datetime64("1992-01-01", "D").astype(np.int64))
DATE_HI = int(np.datetime64("1998-08-02", "D").astype(np.int64))

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
    "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
    "UNITED STATES",
]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW"]
ORDERSTATUS = ["F", "O", "P"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hotpink", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
COMMENT_WORDS = [
    "about", "above", "accounts", "across", "after", "again", "against",
    "along", "among", "asymptotes", "attainments", "blithely", "bold",
    "braids", "carefully", "courts", "daringly", "decoys", "deposits",
    "dolphins", "dugouts", "engage", "epitaphs", "escapades", "even",
    "excuses", "express", "final", "fluffily", "foxes", "frays", "furious",
    "furiously", "gifts", "grouches", "hockey", "ideas", "instructions",
    "ironic", "packages", "pending", "pinto", "platelets", "players",
    "quickly", "quietly", "realms", "regular", "requests", "ruthlessly",
    "sauternes", "sentiments", "silent", "sleepy", "slyly", "special",
    "theodolites", "thinly", "unusual", "waters",
]


def _cat(domain: list[str], raw_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ordered-dictionary encode: vocab is sorted, codes order-preserving."""
    vocab = np.array(sorted(domain))
    rank = np.empty(len(domain), dtype=np.int32)
    for i, s in enumerate(domain):
        rank[i] = np.searchsorted(vocab, s)
    return rank[raw_idx].astype(np.int32), vocab


def _text(rng, n: int, words: list[str], n_words: int, max_words: int,
          inject: list[str] | None = None, inject_p: float = 0.0,
          ) -> tuple[np.ndarray, np.ndarray]:
    vocab = np.array(sorted(set(words) | set(inject or [])))
    codes = rng.integers(0, len(vocab), size=(n, max_words)).astype(np.int32)
    lens = rng.integers(max(1, n_words - 2), n_words + 1, size=n)
    mask = np.arange(max_words)[None, :] >= lens[:, None]
    codes[mask] = -1
    if inject:
        # Inject a fixed phrase (e.g. "special requests") into a fraction of
        # rows so Q13-style predicates are selective but non-trivial.
        picks = rng.random(n) < inject_p
        idx = np.searchsorted(vocab, inject)
        for j, code in enumerate(idx):
            codes[picks, j] = code
    return codes, vocab


def generate(sf: float = 0.01, seed: int = 0) -> dict[str, dict]:
    """Every TPC-H table at scale factor `sf` from `seed`, as
    `{table: {"columns": {col: array}, "vocabs": {...}, "word_vocabs":
    {...}}}` (the form `Database.from_arrays` takes)."""
    rng = np.random.default_rng(seed)
    n_supp = max(20, int(10_000 * sf))
    n_cust = max(30, int(150_000 * sf))
    n_part = max(40, int(200_000 * sf))
    n_ord = max(60, int(1_500_000 * sf))

    tables: dict[str, dict] = {}

    # -- region / nation ----------------------------------------------------
    r_codes, r_vocab = _cat(REGIONS, np.arange(5))
    tables["region"] = _table({
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": r_codes,
    }, vocabs={"r_name": r_vocab})

    n_codes, n_vocab = _cat(NATIONS, np.arange(25))
    tables["nation"] = _table({
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": n_codes,
        "n_regionkey": np.array(NATION_REGION, dtype=np.int32),
    }, vocabs={"n_name": n_vocab})

    # -- supplier -----------------------------------------------------------
    s_names = [f"Supplier#{i:09d}" for i in range(n_supp)]
    s_name_codes, s_name_vocab = _cat(s_names, np.arange(n_supp))
    s_comment, s_cvocab = _text(rng, n_supp, COMMENT_WORDS, 6, 8,
                                inject=["customer", "complaints"], inject_p=0.01)
    tables["supplier"] = _table({
        "s_suppkey": np.arange(n_supp, dtype=np.int32),
        "s_name": s_name_codes,
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
        "s_acctbal": (rng.uniform(-999.99, 9999.99, n_supp)).astype(np.float32),
        "s_comment": s_comment,
    }, vocabs={"s_name": s_name_vocab}, word_vocabs={"s_comment": s_cvocab})

    # -- customer -----------------------------------------------------------
    c_names = [f"Customer#{i:09d}" for i in range(n_cust)]
    c_name_codes, c_name_vocab = _cat(c_names, np.arange(n_cust))
    seg_codes, seg_vocab = _cat(SEGMENTS, rng.integers(0, 5, n_cust))
    phones = [f"{cc:02d}-{rng.integers(100,999)}-{rng.integers(100,999)}"
              for cc in rng.integers(10, 35, n_cust)]
    ph_codes, ph_vocab = _cat(phones, np.arange(n_cust))
    c_comment, c_cvocab = _text(rng, n_cust, COMMENT_WORDS, 6, 8)
    tables["customer"] = _table({
        "c_custkey": np.arange(n_cust, dtype=np.int32),
        "c_name": c_name_codes,
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int32),
        "c_acctbal": rng.uniform(-999.99, 9999.99, n_cust).astype(np.float32),
        "c_mktsegment": seg_codes,
        "c_phone": ph_codes,
        "c_comment": c_comment,
    }, vocabs={"c_name": c_name_vocab, "c_mktsegment": seg_vocab,
               "c_phone": ph_vocab},
       word_vocabs={"c_comment": c_cvocab})

    # -- part ---------------------------------------------------------------
    types = [f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2 for c in TYPE_SYL3]
    containers = [f"{a} {b}" for a in CONTAINER_1 for b in CONTAINER_2]
    brands = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
    mfgrs = [f"Manufacturer#{m}" for m in range(1, 6)]
    p_name, p_nvocab = _text(rng, n_part, P_WORDS, 5, 5)
    ty_codes, ty_vocab = _cat(types, rng.integers(0, len(types), n_part))
    ct_codes, ct_vocab = _cat(containers, rng.integers(0, len(containers), n_part))
    br_codes, br_vocab = _cat(brands, rng.integers(0, len(brands), n_part))
    mf_codes, mf_vocab = _cat(mfgrs, rng.integers(0, len(mfgrs), n_part))
    tables["part"] = _table({
        "p_partkey": np.arange(n_part, dtype=np.int32),
        "p_name": p_name,
        "p_mfgr": mf_codes,
        "p_brand": br_codes,
        "p_type": ty_codes,
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": ct_codes,
        "p_retailprice": (900 + (np.arange(n_part) % 200) * 1.0
                          + rng.uniform(0, 100, n_part)).astype(np.float32),
    }, vocabs={"p_mfgr": mf_vocab, "p_brand": br_vocab, "p_type": ty_vocab,
               "p_container": ct_vocab},
       word_vocabs={"p_name": p_nvocab})

    # -- partsupp -----------------------------------------------------------
    n_ps = 4 * n_part
    ps_part = np.repeat(np.arange(n_part, dtype=np.int32), 4)
    ps_supp = ((ps_part + (np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)))
               % n_supp).astype(np.int32)
    tables["partsupp"] = _table({
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int32),
        "ps_supplycost": rng.uniform(1.0, 1000.0, n_ps).astype(np.float32),
    })

    # -- orders -------------------------------------------------------------
    o_date = rng.integers(DATE_LO, DATE_HI + 1, n_ord).astype(np.int32)
    op_codes, op_vocab = _cat(PRIORITIES, rng.integers(0, 5, n_ord))
    os_codes, os_vocab = _cat(ORDERSTATUS, rng.integers(0, 3, n_ord))
    o_comment, o_cvocab = _text(rng, n_ord, COMMENT_WORDS, 6, 8,
                                inject=["special", "requests"], inject_p=0.25)
    tables["orders"] = _table({
        "o_orderkey": np.arange(n_ord, dtype=np.int32),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int32),
        "o_orderstatus": os_codes,
        "o_totalprice": rng.uniform(850.0, 560_000.0, n_ord).astype(np.float32),
        "o_orderdate": o_date,
        "o_orderpriority": op_codes,
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_comment": o_comment,
    }, vocabs={"o_orderstatus": os_vocab, "o_orderpriority": op_vocab},
       word_vocabs={"o_comment": o_cvocab})

    # -- lineitem -----------------------------------------------------------
    lines_per_order = rng.integers(1, 8, n_ord)
    l_ord = np.repeat(np.arange(n_ord, dtype=np.int32), lines_per_order)
    n_li = int(l_ord.shape[0])
    l_lineno = (np.arange(n_li, dtype=np.int32)
                - np.repeat(np.cumsum(lines_per_order) - lines_per_order,
                            lines_per_order).astype(np.int32)) + 1
    l_part = rng.integers(0, n_part, n_li).astype(np.int32)
    l_supp = ((l_part + rng.integers(0, 4, n_li) * (n_supp // 4 + 1))
              % n_supp).astype(np.int32)
    qty = rng.integers(1, 51, n_li).astype(np.float32)
    retail = tables["part"]["columns"]["p_retailprice"][l_part]
    eprice = (qty * retail * rng.uniform(0.9, 1.1, n_li)).astype(np.float32)
    odate = o_date[l_ord]
    shipd = (odate + rng.integers(1, 122, n_li)).astype(np.int32)
    commd = (odate + rng.integers(30, 91, n_li)).astype(np.int32)
    recd = (shipd + rng.integers(1, 31, n_li)).astype(np.int32)
    rf_codes, rf_vocab = _cat(RETURNFLAGS, rng.integers(0, 3, n_li))
    ls_codes, ls_vocab = _cat(LINESTATUS, (shipd > days("1995-06-17")).astype(np.int64))
    si_codes, si_vocab = _cat(SHIPINSTRUCT, rng.integers(0, 4, n_li))
    sm_codes, sm_vocab = _cat(SHIPMODES, rng.integers(0, 7, n_li))
    tables["lineitem"] = _table({
        "l_orderkey": l_ord,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": l_lineno,
        "l_quantity": qty,
        "l_extendedprice": eprice,
        "l_discount": (rng.integers(0, 11, n_li) / 100.0).astype(np.float32),
        "l_tax": (rng.integers(0, 9, n_li) / 100.0).astype(np.float32),
        "l_returnflag": rf_codes,
        "l_linestatus": ls_codes,
        "l_shipdate": shipd,
        "l_commitdate": commd,
        "l_receiptdate": recd,
        "l_shipinstruct": si_codes,
        "l_shipmode": sm_codes,
    }, vocabs={"l_returnflag": rf_vocab, "l_linestatus": ls_vocab,
               "l_shipinstruct": si_vocab, "l_shipmode": sm_vocab})

    return tables
