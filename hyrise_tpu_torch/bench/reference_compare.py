"""Float aggregates against a sequential-order oracle, and every other cell
exactly against sqlite, for the 22 TPC-H queries.

Port of scripts/reference_compare.py. The reference Hyrise accumulates an
aggregate sequentially in row order (aggregate.cpp:437-541, C++ doubles)
over values computed in column precision (float32 columns); the port
reduces in other orders (in tiles, in shards, in blocks). For each query
this tool

1. runs it through one execution form of the port (`--via`; default
   `compiled`, the JAX script's form), on the card unless the caller asks
   for the CPU;
2. folds every float aggregate cell again, sequentially in float64 over
   float32 addends in dbgen row order. The addends come from an addend
   query per query against the sqlite oracle (utils/sqlite_oracle.py):
   float32 values are exact in float64, so the operand columns fetched
   through sqlite and combined in numpy float32 give the engine's column-
   precision products bit for bit;
3. compares every other cell (keys, strings, counts, raw column values)
   exactly with sqlite's full answer, and reports each float aggregate
   cell's distance from the fold in ULPs and relative to it.

Order: the sequential order is the fact table's dbgen row order (ORDER BY
<fact>.rowid), the documented stand-in for the reference's hash-join
iteration order.

    python -m hyrise_tpu_torch.bench.reference_compare [--sf 1] [--queries 1,3,6]
        [--via compiled|plans|sql|sql-compiled|blocked|segmented|compiled-blocked|
               compiled-segmented] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Iterable

import numpy as np

F32 = np.float32


def left_fold_sum(values32) -> float:
    """Strict sequential float64 accumulation (C++ `for (v : xs) acc += v`):
    np.add.accumulate on float64 adds element by element, unlike np.sum's
    pairwise blocks."""
    a = np.asarray(values32, dtype=np.float64)
    if a.size == 0:
        return 0.0
    return float(np.add.accumulate(a)[-1])


def ulp_distance(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return float(abs(a - b) / np.spacing(max(abs(a), abs(b), 1e-300)))


def rel_distance(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return float(abs(a - b) / max(abs(a), abs(b)))


def vol(ops):
    """l_extendedprice * (1 - l_discount) in column (float32) precision."""
    return F32(ops["ep"]) * (F32(1) - F32(ops["disc"]))


# Per-query specs.
#   key:     output column indices that identify a row (the group key)
#   addends: (sql, n_group_cols, [operand names]): the sql returns the group
#            columns, then the operands, in the fact table's rowid order
#   folds:   {output column index: cell}, a cell one of ("sum", expr),
#            ("avg", expr), ("ratio", numerator, denominator, scale),
#            ("sumdiv", expr, divisor)
# A query without addends has no float aggregate: every cell is compared
# exactly (ints, strings, raw float column values).

_IN7 = "('13','31','23','29','30','18','17')"

SPECS = {
    1: dict(
        key=(0, 1),
        addends=("SELECT l_returnflag, l_linestatus, l_quantity,"
                 " l_extendedprice, l_discount, l_tax FROM lineitem"
                 " WHERE l_shipdate <= '1998-12-01' ORDER BY rowid",
                 2, ["qty", "ep", "disc", "tax"]),
        folds={
            2: ("sum", lambda o: F32(o["qty"])),
            3: ("sum", lambda o: F32(o["ep"])),
            4: ("sum", vol),
            5: ("sum", lambda o: vol(o) * (F32(1) + F32(o["tax"]))),
            6: ("avg", lambda o: F32(o["qty"])),
            7: ("avg", lambda o: F32(o["ep"])),
            8: ("avg", lambda o: F32(o["disc"])),
        }),
    2: dict(key=(3, 1)),  # p_partkey, s_name
    3: dict(
        key=(0,),
        addends=("SELECT l_orderkey, l_extendedprice, l_discount"
                 " FROM customer, orders, lineitem"
                 " WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey"
                 " AND l_orderkey = o_orderkey"
                 " AND o_orderdate < '1995-03-15'"
                 " AND l_shipdate > '1995-03-15' ORDER BY lineitem.rowid",
                 1, ["ep", "disc"]),
        folds={1: ("sum", vol)}),
    4: dict(key=(0,)),
    5: dict(
        key=(0,),
        addends=("SELECT n_name, l_extendedprice, l_discount"
                 " FROM customer, orders, lineitem, supplier, nation, region"
                 " WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey"
                 " AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey"
                 " AND s_nationkey = n_nationkey"
                 " AND n_regionkey = r_regionkey AND r_name = 'AMERICA'"
                 " AND o_orderdate >= '1994-01-01'"
                 " AND o_orderdate < '1995-01-01' ORDER BY lineitem.rowid",
                 1, ["ep", "disc"]),
        folds={1: ("sum", vol)}),
    6: dict(
        key=(),
        addends=("SELECT l_extendedprice, l_discount FROM lineitem"
                 " WHERE l_shipdate >= '1994-01-01'"
                 " AND l_shipdate < '1995-01-01'"
                 " AND l_discount BETWEEN .06 - 0.01 AND .06 + 0.01001"
                 " AND l_quantity < 24 ORDER BY rowid",
                 0, ["ep", "disc"]),
        folds={0: ("sum", lambda o: F32(o["ep"]) * F32(o["disc"]))}),
    7: dict(
        key=(0, 1, 2),
        addends=("SELECT n1.n_name, n2.n_name, SUBSTR(l_shipdate, 1, 4),"
                 " l_extendedprice, l_discount"
                 " FROM supplier, lineitem, orders, customer,"
                 " nation n1, nation n2"
                 " WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey"
                 " AND c_custkey = o_custkey"
                 " AND s_nationkey = n1.n_nationkey"
                 " AND c_nationkey = n2.n_nationkey"
                 " AND ((n1.n_name = 'IRAN' AND n2.n_name = 'IRAQ') OR"
                 "      (n1.n_name = 'IRAQ' AND n2.n_name = 'IRAN'))"
                 " AND l_shipdate BETWEEN '1995-01-01' AND '1996-12-31'"
                 " ORDER BY lineitem.rowid",
                 3, ["ep", "disc"]),
        folds={3: ("sum", vol)}),
    8: dict(
        key=(0,),
        addends=("SELECT SUBSTR(o_orderdate, 1, 4), n2.n_name,"
                 " l_extendedprice, l_discount"
                 " FROM part, supplier, lineitem, orders, customer,"
                 " nation n1, nation n2, region"
                 " WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey"
                 " AND l_orderkey = o_orderkey AND o_custkey = c_custkey"
                 " AND c_nationkey = n1.n_nationkey"
                 " AND n1.n_regionkey = r_regionkey AND r_name = 'AMERICA'"
                 " AND s_nationkey = n2.n_nationkey"
                 " AND o_orderdate between '1995-01-01' AND '1996-12-31'"
                 " AND p_type = 'ECONOMY ANODIZED STEEL'"
                 " ORDER BY lineitem.rowid",
                 1, ["nation", "ep", "disc"]),
        folds={1: ("ratio",
                   lambda o: np.where(o["nation"] == "BRAZIL", vol(o), F32(0)),
                   vol, 1.0)}),
    9: dict(
        key=(0, 1),
        addends=("SELECT n_name, SUBSTR(o_orderdate, 1, 4),"
                 " l_extendedprice, l_discount, ps_supplycost, l_quantity"
                 " FROM supplier, lineitem, partsupp, orders, nation, part"
                 " WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey"
                 " AND ps_partkey = l_partkey AND p_partkey = l_partkey"
                 " AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey"
                 " AND p_name like '%green%' ORDER BY lineitem.rowid",
                 2, ["ep", "disc", "sc", "qty"]),
        folds={2: ("sum",
                   lambda o: vol(o) - F32(o["sc"]) * F32(o["qty"]))}),
    10: dict(
        key=(0,),
        addends=("SELECT c_custkey, l_extendedprice, l_discount"
                 " FROM customer, orders, lineitem"
                 " WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey"
                 " AND o_orderdate >= '1993-10-01'"
                 " AND o_orderdate < '1994-01-01' AND l_returnflag = 'R'"
                 " ORDER BY lineitem.rowid",
                 1, ["ep", "disc"]),
        folds={2: ("sum", vol)}),
    11: dict(
        key=(0,),
        addends=("SELECT ps_partkey, ps_supplycost, ps_availqty"
                 " FROM partsupp, supplier, nation"
                 " WHERE ps_suppkey = s_suppkey"
                 " AND s_nationkey = n_nationkey AND n_name = 'GERMANY'"
                 " ORDER BY partsupp.rowid",
                 1, ["sc", "aq"]),
        folds={1: ("sum", lambda o: F32(o["sc"]) * F32(o["aq"]))}),
    12: dict(key=(0,)),
    13: dict(key=(0,)),
    14: dict(
        key=(),
        addends=("SELECT p_type, l_extendedprice, l_discount"
                 " FROM lineitem, part WHERE l_partkey = p_partkey"
                 " AND l_shipdate >= '1995-09-01'"
                 " AND l_shipdate < '1995-10-01' ORDER BY lineitem.rowid",
                 0, ["ptype", "ep", "disc"]),
        folds={0: ("ratio",
                   lambda o: np.where(
                       np.char.startswith(o["ptype"].astype(str), "PROMO"),
                       vol(o), F32(0)),
                   vol, 100.0)}),
    15: dict(
        key=(0,),
        addends=("SELECT l_suppkey, l_extendedprice, l_discount"
                 " FROM lineitem WHERE l_shipdate >= '1993-05-13'"
                 " AND l_shipdate < '1993-08-13' ORDER BY rowid",
                 1, ["ep", "disc"]),
        folds={4: ("sum", vol)}),
    16: dict(key=(0, 1, 2)),
    17: dict(
        key=(),
        addends=("SELECT l.l_extendedprice FROM lineitem l, part"
                 " WHERE p_partkey = l.l_partkey AND p_brand = 'Brand#23'"
                 " AND p_container = 'MED BOX'"
                 " AND l.l_quantity < (SELECT 0.2 * avg(l2.l_quantity)"
                 "   FROM lineitem l2 WHERE l2.l_partkey = l.l_partkey)"
                 " ORDER BY l.rowid",
                 0, ["ep"]),
        folds={0: ("sumdiv", lambda o: F32(o["ep"]), 7.0)}),
    18: dict(
        key=(2,),
        addends=("SELECT l_orderkey, l_quantity FROM lineitem"
                 " WHERE l_orderkey in (SELECT l_orderkey FROM lineitem"
                 "   GROUP BY l_orderkey having SUM(l_quantity) > 300)"
                 " ORDER BY rowid",
                 1, ["qty"]),
        folds={5: ("sum", lambda o: F32(o["qty"]))}),
    19: dict(
        key=(),
        addends=("SELECT l_extendedprice, l_discount FROM lineitem, part"
                 " WHERE p_partkey = l_partkey AND (("
                 " p_brand = 'Brand#12' AND p_container in"
                 " ('SM CASE','SM BOX','SM PACK','SM PKG')"
                 " AND l_quantity >= 1 AND l_quantity <= 1 + 10"
                 " AND p_size between 1 AND 5"
                 " AND l_shipmode in ('AIR', 'AIR REG')"
                 " AND l_shipinstruct = 'DELIVER IN PERSON')"
                 " or (p_brand = 'Brand#23' AND p_container in"
                 " ('MED BAG','MED BOX','MED PKG','MED PACK')"
                 " AND l_quantity >= 10 AND l_quantity <= 10 + 10"
                 " AND p_size between 1 AND 10"
                 " AND l_shipmode in ('AIR', 'AIR REG')"
                 " AND l_shipinstruct = 'DELIVER IN PERSON')"
                 " or (p_brand = 'Brand#34' AND p_container in"
                 " ('LG CASE','LG BOX','LG PACK','LG PKG')"
                 " AND l_quantity >= 20 AND l_quantity <= 20 + 10"
                 " AND p_size between 1 AND 15"
                 " AND l_shipmode in ('AIR', 'AIR REG')"
                 " AND l_shipinstruct = 'DELIVER IN PERSON'))"
                 " ORDER BY lineitem.rowid",
                 0, ["ep", "disc"]),
        folds={0: ("sum", vol)}),
    20: dict(key=(0,)),
    21: dict(key=(0,)),
    22: dict(
        key=(0,),
        addends=("SELECT SUBSTR(c_phone,1,2) AS cc, c_acctbal FROM customer"
                 f" WHERE SUBSTR(c_phone,1,2) IN {_IN7}"
                 " AND c_acctbal > (SELECT AVG(c_acctbal) FROM customer"
                 "   WHERE c_acctbal > 0.00"
                 f"   AND SUBSTR(c_phone,1,2) IN {_IN7})"
                 " AND NOT EXISTS (SELECT * FROM orders"
                 "   WHERE o_custkey = c_custkey) ORDER BY customer.rowid",
                 1, ["bal"]),
        folds={2: ("sum", lambda o: F32(o["bal"]))}),
}


def fold_cell(cell, ops, count):
    kind = cell[0]
    if kind == "sum":
        return left_fold_sum(cell[1](ops))
    if kind == "avg":
        return left_fold_sum(cell[1](ops)) / count
    if kind == "sumdiv":
        return left_fold_sum(cell[1](ops)) / cell[2]
    if kind == "ratio":
        num = left_fold_sum(cell[1](ops))
        den = left_fold_sum(cell[2](ops))
        return cell[3] * num / den
    raise ValueError(kind)


def norm_key(v):
    if isinstance(v, (np.integer, int, bool)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return str(v)


def compare_query(qid, engine_rows, oracle, spec):
    """The verdict on one query's rows: the exact cells against sqlite's
    answer (`int_exact`), the float aggregate cells against the sequential
    fold (`max_ulp`, `max_rel`, per output column `per_cell_max_ulp`)."""
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL

    key_idx = spec["key"]
    folds = spec.get("folds", {})
    res = {"rows": len(engine_rows)}

    sq_rows = oracle.query(TPCH_SQL[qid])
    res["oracle_rows"] = len(sq_rows)
    sq_by_key = {tuple(norm_key(r[i]) for i in key_idx): r for r in sq_rows}
    exact_bad = 0
    checked = 0
    for row in engine_rows:
        ref = sq_by_key.get(tuple(norm_key(row[i]) for i in key_idx))
        if ref is None:
            exact_bad += 1
            continue
        for ci, (a, b) in enumerate(zip(row, ref)):
            if ci in folds:
                continue
            checked += 1
            if isinstance(a, float) or isinstance(b, float):
                ok = float(a) == float(b)
            else:
                ok = norm_key(a) == norm_key(b)
            exact_bad += 0 if ok else 1
    res["exact_cells"] = checked
    res["exact_mismatches"] = exact_bad
    res["row_count_match"] = len(engine_rows) == len(sq_rows)
    res["int_exact"] = exact_bad == 0 and res["row_count_match"]

    res["float_cells"] = 0
    res["max_ulp"] = 0.0
    res["max_rel"] = 0.0
    if not folds:
        return res
    sql, ngk, names = spec["addends"]
    groups = {}
    for r in oracle.query(sql):
        groups.setdefault(tuple(norm_key(v) for v in r[:ngk]), []).append(r[ngk:])
    per_cell = {}
    missing_groups = 0
    for row in engine_rows:
        g = groups.get(tuple(norm_key(row[i]) for i in key_idx))
        if g is None:
            missing_groups += 1
            continue
        ops = {}
        for name, col in zip(names, zip(*g)):
            arr = np.asarray(col)
            ops[name] = arr if arr.dtype == object or arr.dtype.kind in "US" \
                else arr.astype(np.float64)
        for ci, cell in folds.items():
            want = fold_cell(cell, ops, len(g))
            ulp = ulp_distance(float(row[ci]), want)
            res["float_cells"] += 1
            res["max_ulp"] = max(res["max_ulp"], ulp)
            res["max_rel"] = max(res["max_rel"], rel_distance(float(row[ci]), want))
            per_cell[str(ci)] = max(per_cell.get(str(ci), 0.0), ulp)
    res["per_cell_max_ulp"] = per_cell
    if missing_groups:
        res["missing_groups"] = missing_groups
    return res


# the oracle's indexes: the addend queries' joins and correlated subqueries
# (idx_l_pq covers Q17's, which takes minutes at SF 0.1 without it)
ORACLE_INDEXES = (
    "CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
    "CREATE INDEX idx_l_pq ON lineitem(l_partkey, l_quantity)",
    "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
    "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)",
    "CREATE INDEX idx_ps_sk ON partsupp(ps_suppkey)",
)


def make_oracle(tables):
    """The sqlite oracle over `tables` (loaded from their host copies) with
    ORACLE_INDEXES."""
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    oracle = SqliteOracle(tables)
    for ddl in ORACLE_INDEXES:
        oracle.conn.execute(ddl)
    return oracle


def compare(cat, oracle, qids: Iterable[int], via: str = "compiled",
            log=None) -> dict:
    """Run each query over `cat` through `via` and hold it against `oracle`
    (over the same tables): {"queries": {"qN": verdict}, "summary": {...}}."""
    from hyrise_tpu_torch.bench.tpch_bench import make_queries

    queries = {}
    for qid in qids:
        run, = make_queries(cat, [qid], via).values()
        t0 = time.perf_counter()
        engine_rows = run().rows()
        engine_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = compare_query(qid, engine_rows, oracle, SPECS[qid])
        res["engine_s"] = engine_s
        res["oracle_s"] = time.perf_counter() - t0
        queries[f"q{qid}"] = res
        if log is not None:
            log(f"q{qid}: rows={res['rows']} int_exact={res['int_exact']} "
                f"float_cells={res['float_cells']} max_ulp={res['max_ulp']:.1f} "
                f"max_rel={res['max_rel']:.3e} (engine {engine_s:.2f} s, oracle "
                f"{res['oracle_s']:.2f} s)")
    return {"queries": queries, "summary": summarize(queries)}


def summarize(queries: dict) -> dict:
    return {"queries": len(queries),
            "all_int_exact": all(q["int_exact"] for q in queries.values()),
            "max_ulp": max((q["max_ulp"] for q in queries.values()), default=0.0),
            "max_rel": max((q.get("max_rel", 0.0) for q in queries.values()), default=0.0)}


def main(argv=None) -> dict:
    from hyrise_tpu_torch.bench.runner import devices
    from hyrise_tpu_torch.bench.tpch_bench import (VIAS, default_out, load_catalog,
                                                   make_parent, resolve_device)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--queries", default=None, help="comma-separated ids (default: all 22)")
    ap.add_argument("--via", choices=VIAS, default="compiled")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("reference_comparison.json"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    qids = [int(q) for q in args.queries.split(",")] if args.queries else sorted(SPECS)
    t0 = time.perf_counter()
    cat = load_catalog(args.sf, device)
    print(f"generated SF{args.sf} on {device} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    oracle = make_oracle({name: cat.get_table(name) for name in cat.table_names()})
    print(f"sqlite load and indexes: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    result = compare(cat, oracle, qids, args.via,
                     log=lambda line: print(line, file=sys.stderr))
    oracle.close()

    report = {"sf": args.sf, "via": args.via,
              "devices": devices() if device.type == "cuda" else ["cpu"], "queries": {}}
    try:  # merge: a partial re-run never shrinks the report
        with open(args.out) as f:
            prev = json.load(f)
        if (prev.get("sf"), prev.get("via")) == (args.sf, args.via):
            report["queries"].update(prev.get("queries", {}))
    except (OSError, ValueError):
        pass
    report["queries"].update(result["queries"])
    report["summary"] = summarize(report["queries"])
    make_parent(args.out)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["summary"]))
    return report


if __name__ == "__main__":
    main()
