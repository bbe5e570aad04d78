"""TPC-H data generator (vectorized numpy, spec-conformant distributions).

Role of the reference's dbgen wrapper
(reference: src/benchmarklib/tpch/tpch_db_generator.cpp, which wraps the
vendored third_party/tpch-dbgen C tool). This is an independent, from-scratch
implementation of the TPC-H 2.x specification's data distributions —
schemas and column types match the reference exactly (the hana tuples at
tpch_db_generator.cpp:20-41): int32 keys, float32 money, dates as strings
(the reference's "dates are not supported" deviation, tpch_queries.cpp).

Not bit-identical to the official dbgen RNG streams; correctness testing
runs our engine and the sqlite oracle on the SAME generated data (exactly
the reference's own oracle strategy, src/test/tpc/tpch_test.cpp).

String columns are produced pre-dictionary-encoded ((codes, sorted pool))
wherever the value pool is known, so SF>=1 generation avoids np.unique over
hundreds of millions of strings.

The numpy generators are a copy of hyrise_tpu/tpch/dbgen.py, pinned by
tests/test_torch_storage.py; only `_make_table` differs: it uploads to the
device it is given, without capacity padding. It sets the same `unique`
and `val_range` column metadata.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

# ---------------------------------------------------------------------------
# Static pools (TPC-H spec, section 4.2.2 / appendix)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [  # (name, regionkey) — spec's 25 nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

SHIP_MODE = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

TYPE_SYLL_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

CONTAINER_SYLL_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYLL_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# spec's 92 P_NAME words (colours) — includes green/forest used by Q9/Q20
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

# vocabulary for pseudo-text comments (spec grammar simplified to a word
# sample; the query-relevant patterns are injected explicitly below)
COMMENT_WORDS = [
    "furiously", "slyly", "carefully", "blithely", "quickly", "fluffily",
    "final", "ironic", "pending", "regular", "express", "special", "bold",
    "even", "silent", "unusual", "brave", "quiet", "daring", "busy",
    "requests", "deposits", "accounts", "packages", "instructions", "ideas",
    "foxes", "dependencies", "pinto", "beans", "theodolites", "platelets",
    "asymptotes", "courts", "dolphins", "multipliers", "sauternes", "warhorses",
    "sleep", "wake", "haggle", "nag", "cajole", "detect", "integrate",
    "about", "above", "according", "across", "after", "against", "along",
]

EPOCH = np.datetime64("1992-01-01")
DATE_END = np.datetime64("1999-01-01")  # exclusive
N_DAYS = int((DATE_END - EPOCH).astype(int))  # 2557
CURRENT_DATE_OFFSET = int((np.datetime64("1995-06-17") - EPOCH).astype(int))

_DATE_POOL: Optional[np.ndarray] = None


def date_pool() -> np.ndarray:
    """All dates 1992-01-01..1998-12-31 as sorted 'YYYY-MM-DD' strings —
    chronological order == lexicographic order, so dictionary codes are day
    offsets from EPOCH."""
    global _DATE_POOL
    if _DATE_POOL is None:
        days = EPOCH + np.arange(N_DAYS)
        _DATE_POOL = days.astype("datetime64[D]").astype(str)
    return _DATE_POOL


# A string column already encoded as (codes into a SORTED pool, pool).
EncodedStr = Tuple[np.ndarray, np.ndarray]
ColSpec = Tuple[str, DataType, Union[np.ndarray, EncodedStr]]


def _encode_pool(codes: np.ndarray, pool: List[str]) -> EncodedStr:
    """Re-sort an arbitrary pool and remap codes (dictionaries must be
    sorted for order-preserving compares)."""
    arr = np.asarray(pool, dtype=str)
    sorted_pool, inverse = np.unique(arr, return_inverse=True)
    return inverse.astype(np.int32)[codes], sorted_pool


def _zero_pad_pool(prefix: str, n: int, width: int = 9) -> np.ndarray:
    nums = np.char.zfill(np.arange(1, n + 1).astype(str), width)
    return np.char.add(prefix, nums)


def _random_phrases(rng, n_rows: int, pool_size: int, words_min=4, words_max=8,
                    inject: Optional[Tuple[str, float]] = None) -> EncodedStr:
    """Random comment strings drawn from a phrase pool of pool_size entries.

    inject=(pattern_with_space, fraction): a fraction of ROWS gets a phrase
    containing the pattern words in order (for LIKE-dependent queries)."""
    phrases = []
    for _ in range(pool_size):
        k = int(rng.integers(words_min, words_max + 1))
        ws = rng.choice(COMMENT_WORDS, size=k)
        phrases.append(" ".join(ws))
    n_inject = 0
    if inject is not None:
        pattern, frac = inject
        n_inject = max(int(pool_size * frac * 4), 1)
        for _ in range(n_inject):
            k = int(rng.integers(1, 4))
            ws1 = " ".join(rng.choice(COMMENT_WORDS, size=k))
            ws2 = " ".join(rng.choice(COMMENT_WORDS, size=k))
            mid = pattern.replace(" ", rng.choice([" ", " quickly ", " even "]))
            phrases.append(f"{ws1} {mid} {ws2}")
    codes = rng.integers(0, pool_size, size=n_rows).astype(np.int32)
    if inject is not None:
        _, frac = inject
        hit = rng.random(n_rows) < frac
        codes[hit] = (pool_size + rng.integers(0, n_inject, size=int(hit.sum()))
                      ).astype(np.int32)
    return _encode_pool(codes, phrases)


def _money(rng, n, lo_cents, hi_cents) -> np.ndarray:
    return (rng.integers(lo_cents, hi_cents + 1, size=n) / 100.0).astype(np.float32)


def _phones(rng, nationkeys: np.ndarray) -> EncodedStr:
    n = len(nationkeys)
    cc = (nationkeys + 10).astype(str)
    a = rng.integers(100, 1000, size=n).astype(str)
    b = rng.integers(100, 1000, size=n).astype(str)
    c = rng.integers(1000, 10000, size=n).astype(str)
    strs = np.char.add(np.char.add(np.char.add(np.char.add(
        np.char.add(np.char.add(cc, "-"), a), "-"), b), "-"), c)
    pool, inverse = np.unique(strs, return_inverse=True)
    return inverse.astype(np.int32), pool


def _addresses(rng, n) -> EncodedStr:
    # random alnum v-strings; pool-based for speed
    pool_size = min(max(n, 16), 65536)
    alpha = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,."))
    lens = rng.integers(10, 40, size=pool_size)
    pool = ["".join(rng.choice(alpha, size=int(l))) for l in lens]
    codes = rng.integers(0, pool_size, size=n).astype(np.int32)
    return _encode_pool(codes, pool)


# ---------------------------------------------------------------------------
# table constructors


# Single-column primary keys (TPC-H spec 1.4.2): they select the lookup join
# (ops/join.py). partsupp's key is composite, so none of its columns counts.
PRIMARY_KEYS = {"r_regionkey", "n_nationkey", "s_suppkey", "c_custkey",
                "p_partkey", "o_orderkey"}


def _make_table(name: str, specs: List[ColSpec], n: int, device) -> Table:
    """Upload one generated table to `device`, unpadded (capacity = n).
    Integer columns carry their (min, max) as `val_range`, primary keys the
    `unique` flag."""
    cols = []
    for col_name, dt, payload in specs:
        if dt is DataType.STRING:
            codes, pool = payload
            data = torch.as_tensor(np.ascontiguousarray(codes, dtype=np.int32),
                                   device=device)
            cols.append(Column(col_name, DataType.STRING, data, None, pool))
        else:
            data = torch.as_tensor(
                np.ascontiguousarray(payload, dtype=dt.numpy_dtype),
                device=device)
            val_range = None
            if dt.is_integral and n:
                val_range = (int(payload.min()), int(payload.max()))
            cols.append(Column(col_name, dt, data,
                               unique=col_name in PRIMARY_KEYS,
                               val_range=val_range))
    return Table(cols, n, name=name)


def gen_region(rng) -> List[ColSpec]:
    comments = [" ".join(rng.choice(COMMENT_WORDS, size=6)) for _ in range(5)]
    return [
        ("r_regionkey", DataType.INT32, np.arange(5, dtype=np.int32)),
        ("r_name", DataType.STRING, _encode_pool(np.arange(5), REGIONS)),
        ("r_comment", DataType.STRING, _encode_pool(np.arange(5), comments)),
    ], 5


def gen_nation(rng) -> List[ColSpec]:
    names = [n for n, _ in NATIONS]
    region = np.array([r for _, r in NATIONS], dtype=np.int32)
    comments = [" ".join(rng.choice(COMMENT_WORDS, size=6)) for _ in range(25)]
    return [
        ("n_nationkey", DataType.INT32, np.arange(25, dtype=np.int32)),
        ("n_name", DataType.STRING, _encode_pool(np.arange(25), names)),
        ("n_regionkey", DataType.INT32, region),
        ("n_comment", DataType.STRING, _encode_pool(np.arange(25), comments)),
    ], 25


def gen_supplier(rng, sf: float) -> Tuple[List[ColSpec], int]:
    S = max(int(10000 * sf), 1)
    nationkey = rng.integers(0, 25, size=S).astype(np.int32)
    name_pool = _zero_pad_pool("Supplier#", S)
    # ~5 per 10000 suppliers complain (spec: Customer...Complaints for Q16)
    comments = _random_phrases(rng, S, pool_size=min(S, 4096),
                               inject=("Customer Complaints", 0.0005))
    return [
        ("s_suppkey", DataType.INT32, np.arange(1, S + 1, dtype=np.int32)),
        ("s_name", DataType.STRING, (np.arange(S, dtype=np.int32), name_pool)),
        ("s_address", DataType.STRING, _addresses(rng, S)),
        ("s_nationkey", DataType.INT32, nationkey),
        ("s_phone", DataType.STRING, _phones(rng, nationkey)),
        ("s_acctbal", DataType.FLOAT32, _money(rng, S, -99999, 999999)),
        ("s_comment", DataType.STRING, comments),
    ], S


def gen_customer(rng, sf: float) -> Tuple[List[ColSpec], int]:
    C = max(int(150000 * sf), 3)
    nationkey = rng.integers(0, 25, size=C).astype(np.int32)
    name_pool = _zero_pad_pool("Customer#", C)
    seg_codes = rng.integers(0, 5, size=C).astype(np.int32)
    return [
        ("c_custkey", DataType.INT32, np.arange(1, C + 1, dtype=np.int32)),
        ("c_name", DataType.STRING, (np.arange(C, dtype=np.int32), name_pool)),
        ("c_address", DataType.STRING, _addresses(rng, C)),
        ("c_nationkey", DataType.INT32, nationkey),
        ("c_phone", DataType.STRING, _phones(rng, nationkey)),
        ("c_acctbal", DataType.FLOAT32, _money(rng, C, -99999, 999999)),
        ("c_mktsegment", DataType.STRING, _encode_pool(seg_codes, SEGMENTS)),
        ("c_comment", DataType.STRING,
         _random_phrases(rng, C, pool_size=min(C, 4096))),
    ], C


def gen_part(rng, sf: float) -> Tuple[List[ColSpec], int, np.ndarray]:
    P = max(int(200000 * sf), 8)
    partkey = np.arange(1, P + 1, dtype=np.int32)
    # p_name: 5 of the 92 words. Build a pool of word-combination phrases and
    # sample: pool must include 'forest%'-prefixed and '%green%' names.
    pool_size = min(max(P, 64), 32768)
    name_pool = []
    widx = rng.integers(0, len(P_NAME_WORDS), size=(pool_size, 5))
    for row in widx:
        name_pool.append(" ".join(P_NAME_WORDS[i] for i in row))
    name_codes = rng.integers(0, pool_size, size=P).astype(np.int32)
    mfgr = rng.integers(1, 6, size=P).astype(np.int32)
    brand = mfgr * 10 + rng.integers(1, 6, size=P).astype(np.int32)
    mfgr_pool = [f"Manufacturer#{i}" for i in range(1, 6)]
    brand_pool = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
    brand_codes = ((mfgr - 1) * 5 + (brand % 10) - 1).astype(np.int32)
    type_pool = [f"{a} {b} {c}" for a in TYPE_SYLL_1 for b in TYPE_SYLL_2
                 for c in TYPE_SYLL_3]
    type_codes = rng.integers(0, len(type_pool), size=P).astype(np.int32)
    cont_pool = [f"{a} {b}" for a in CONTAINER_SYLL_1 for b in CONTAINER_SYLL_2]
    cont_codes = rng.integers(0, len(cont_pool), size=P).astype(np.int32)
    pk = partkey.astype(np.int64)
    retail = ((90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0
              ).astype(np.float32)
    specs = [
        ("p_partkey", DataType.INT32, partkey),
        ("p_name", DataType.STRING, _encode_pool(name_codes, name_pool)),
        ("p_mfgr", DataType.STRING, _encode_pool(mfgr - 1, mfgr_pool)),
        ("p_brand", DataType.STRING, _encode_pool(brand_codes, brand_pool)),
        ("p_type", DataType.STRING, _encode_pool(type_codes, type_pool)),
        ("p_size", DataType.INT32, rng.integers(1, 51, size=P).astype(np.int32)),
        ("p_container", DataType.STRING, _encode_pool(cont_codes, cont_pool)),
        ("p_retailprice", DataType.FLOAT32, retail),
        ("p_comment", DataType.STRING,
         _random_phrases(rng, P, pool_size=min(P, 4096), words_min=2, words_max=5)),
    ]
    return specs, P, retail


def _ps_suppkey(partkey: np.ndarray, i: np.ndarray, S: int) -> np.ndarray:
    """Spec 4.2.3 partsupp supplier formula."""
    pk = partkey.astype(np.int64)
    return (((pk + i * (S // 4 + (pk - 1) // S)) % S) + 1).astype(np.int32)


def gen_partsupp(rng, P: int, S: int) -> Tuple[List[ColSpec], int]:
    n = P * 4
    partkey = np.repeat(np.arange(1, P + 1, dtype=np.int32), 4)
    i = np.tile(np.arange(4, dtype=np.int64), P)
    suppkey = _ps_suppkey(partkey, i, S)
    return [
        ("ps_partkey", DataType.INT32, partkey),
        ("ps_suppkey", DataType.INT32, suppkey),
        ("ps_availqty", DataType.INT32,
         rng.integers(1, 10000, size=n).astype(np.int32)),
        ("ps_supplycost", DataType.FLOAT32, _money(rng, n, 100, 100000)),
        ("ps_comment", DataType.STRING,
         _random_phrases(rng, n, pool_size=4096)),
    ], n


def _valid_custkeys(rng, n: int, C: int) -> np.ndarray:
    """Custkeys never divisible by 3 (spec: one third of customers have no
    orders — the basis of Q13/Q22)."""
    n_valid = C - C // 3
    j = rng.integers(0, n_valid, size=n).astype(np.int64)
    k = 3 * (j // 2) + 1 + (j % 2)
    return k.astype(np.int32)


def gen_orders_lineitem(rng, sf: float, C: int, P: int, S: int,
                        part_retail: np.ndarray):
    O = max(int(1500000 * sf), 10)
    idx = np.arange(O, dtype=np.int64)
    orderkey = ((idx // 8) * 32 + idx % 8 + 1).astype(np.int32)  # sparse keys
    custkey = _valid_custkeys(rng, O, C)
    orderdate_off = rng.integers(0, N_DAYS - 151, size=O).astype(np.int32)

    # lineitems: 1..7 per order
    counts = rng.integers(1, 8, size=O).astype(np.int32)
    L = int(counts.sum())
    l_orderkey = np.repeat(orderkey, counts)
    l_order_row = np.repeat(np.arange(O, dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    l_linenumber = (np.arange(L, dtype=np.int64) - offsets[l_order_row] + 1
                    ).astype(np.int32)
    l_partkey = rng.integers(1, P + 1, size=L).astype(np.int32)
    l_suppkey = _ps_suppkey(l_partkey, rng.integers(0, 4, size=L), S)
    qty = rng.integers(1, 51, size=L).astype(np.int32)
    eprice = (qty * part_retail[l_partkey - 1]).astype(np.float32)
    discount = (rng.integers(0, 11, size=L) / 100.0).astype(np.float32)
    tax = (rng.integers(0, 9, size=L) / 100.0).astype(np.float32)

    o_date_l = orderdate_off[l_order_row]
    shipdate = o_date_l + rng.integers(1, 122, size=L).astype(np.int32)
    commitdate = o_date_l + rng.integers(30, 91, size=L).astype(np.int32)
    receiptdate = shipdate + rng.integers(1, 31, size=L).astype(np.int32)
    shipdate = np.minimum(shipdate, N_DAYS - 1)
    commitdate = np.minimum(commitdate, N_DAYS - 1)
    receiptdate = np.minimum(receiptdate, N_DAYS - 1)

    returned = receiptdate <= CURRENT_DATE_OFFSET
    rf_draw = rng.random(L) < 0.5
    returnflag_code = np.where(returned, np.where(rf_draw, 2, 0), 1)  # R/A/N
    rf_pool = np.array(["A", "N", "R"])
    linestatus_is_o = shipdate > CURRENT_DATE_OFFSET
    ls_pool = np.array(["F", "O"])

    # order status: F if all F, O if all O, else P
    o_ls_sum = np.bincount(l_order_row, weights=linestatus_is_o.astype(np.int64),
                           minlength=O)
    o_status_code = np.where(o_ls_sum == 0, 0,
                             np.where(o_ls_sum == counts, 1, 2))  # F/O/P
    status_pool = np.array(["F", "O", "P"])

    # o_totalprice = sum(eprice*(1+tax)*(1-discount))
    line_total = eprice.astype(np.float64) * (1 + tax) * (1 - discount)
    o_total = np.bincount(l_order_row, weights=line_total, minlength=O)
    o_totalprice = o_total.astype(np.float32)

    clerk_n = max(int(1000 * sf), 1)
    clerk_pool = _zero_pad_pool("Clerk#", clerk_n)
    clerk_codes = rng.integers(0, clerk_n, size=O).astype(np.int32)

    o_comments = _random_phrases(rng, O, pool_size=4096,
                                 inject=("special requests", 0.01))

    si_codes = rng.integers(0, len(SHIP_INSTRUCT), size=L).astype(np.int32)
    sm_codes = rng.integers(0, len(SHIP_MODE), size=L).astype(np.int32)

    dp = date_pool()
    orders_specs = [
        ("o_orderkey", DataType.INT32, orderkey),
        ("o_custkey", DataType.INT32, custkey),
        ("o_orderstatus", DataType.STRING,
         (o_status_code.astype(np.int32), status_pool)),
        ("o_totalprice", DataType.FLOAT32, o_totalprice),
        ("o_orderdate", DataType.STRING, (orderdate_off, dp)),
        ("o_orderpriority", DataType.STRING,
         _encode_pool(rng.integers(0, 5, size=O).astype(np.int32), PRIORITIES)),
        ("o_clerk", DataType.STRING, (clerk_codes, clerk_pool)),
        ("o_shippriority", DataType.INT32, np.zeros(O, dtype=np.int32)),
        ("o_comment", DataType.STRING, o_comments),
    ]
    lineitem_specs = [
        ("l_orderkey", DataType.INT32, l_orderkey),
        ("l_partkey", DataType.INT32, l_partkey),
        ("l_suppkey", DataType.INT32, l_suppkey),
        ("l_linenumber", DataType.INT32, l_linenumber),
        ("l_quantity", DataType.FLOAT32, qty.astype(np.float32)),
        ("l_extendedprice", DataType.FLOAT32, eprice),
        ("l_discount", DataType.FLOAT32, discount),
        ("l_tax", DataType.FLOAT32, tax),
        ("l_returnflag", DataType.STRING,
         (returnflag_code.astype(np.int32), rf_pool)),
        ("l_linestatus", DataType.STRING,
         (linestatus_is_o.astype(np.int32), ls_pool)),
        ("l_shipdate", DataType.STRING, (shipdate, dp)),
        ("l_commitdate", DataType.STRING, (commitdate, dp)),
        ("l_receiptdate", DataType.STRING, (receiptdate, dp)),
        ("l_shipinstruct", DataType.STRING, _encode_pool(si_codes, SHIP_INSTRUCT)),
        ("l_shipmode", DataType.STRING, _encode_pool(sm_codes, SHIP_MODE)),
        ("l_comment", DataType.STRING, _random_phrases(rng, L, pool_size=4096)),
    ]
    return orders_specs, O, lineitem_specs, L


def generate_specs(scale_factor: float, seed: int = 19940607
                   ) -> Dict[str, Tuple[List[ColSpec], int]]:
    """All 8 TPC-H tables as host numpy column specs and row counts, drawn
    from one np.random.default_rng(seed) stream in the JAX package's order,
    so both packages generate identical values."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Tuple[List[ColSpec], int]] = {}
    out["region"] = gen_region(rng)
    out["nation"] = gen_nation(rng)
    specs, S = gen_supplier(rng, scale_factor)
    out["supplier"] = (specs, S)
    specs, C = gen_customer(rng, scale_factor)
    out["customer"] = (specs, C)
    specs, P, retail = gen_part(rng, scale_factor)
    out["part"] = (specs, P)
    out["partsupp"] = gen_partsupp(rng, P, S)
    o_specs, O, l_specs, L = gen_orders_lineitem(rng, scale_factor, C, P, S,
                                                 retail)
    out["orders"] = (o_specs, O)
    out["lineitem"] = (l_specs, L)
    return out


def generate_tables(scale_factor: float, seed: int = 19940607, *,
                    device) -> Dict[str, Table]:
    """Generate all 8 TPC-H tables and upload them to `device`."""
    return {name: _make_table(name, specs, n, device)
            for name, (specs, n) in generate_specs(scale_factor, seed).items()}
