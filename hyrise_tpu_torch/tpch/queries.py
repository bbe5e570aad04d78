"""The 22 TPC-H queries as physical operator plans, with their SQL oracle
texts.

Port of hyrise_tpu/tpch/queries.py, plan for plan: the same operator DAGs
and column names (reference: src/benchmarklib/tpch/tpch_queries.cpp, with
the documented Hyrise deviations: dates as strings, no EXTRACT -> SUBSTR,
hardcoded literals, Q6 discount bound +0.01001 for float32 compatibility).

Correlated and scalar subqueries are decorrelated the standard way:
- EXISTS / IN        -> semi join          (Q4, Q18, Q20)
- NOT EXISTS/NOT IN  -> anti join          (Q16, Q21, Q22)
- scalar subquery    -> host-materialized scalar literal (Q11, Q22)
- correlated agg     -> group-by + join on the correlation key (Q2, Q17,
                        Q20, Q21)

SQL texts use SUBSTR(x, 1, n) (1-based, proper prefix) on both engines,
unlike the reference's SUBSTR(x, 0, 4) quirk.
"""

from __future__ import annotations

from typing import Callable, Dict

from hyrise_tpu_torch.expression.ast import (Case, avg_, col, count_,
                                             count_distinct, lit, max_, min_,
                                             sum_)
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.misc import Alias
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, JoinMode, SortMode

INNER = JoinMode.INNER
DESC = SortMode.DESCENDING


def _scalar(plan: AbstractOperator, context=None):
    """Execute a one-row/one-column subplan and pull the scalar to host."""
    t = execute_plan(plan, context)
    if t.num_rows != 1:
        raise ValueError(f"scalar subplan returned {t.num_rows} rows")
    return t.columns[0].decode(1)[0]


def _g(cat, name):
    return GetTable(name, cat)


# ---------------------------------------------------------------------------
# Q1

SQL_1 = """SELECT l_returnflag, l_linestatus, SUM(l_quantity) as sum_qty,
 SUM(l_extendedprice) as sum_base_price,
 SUM(l_extendedprice*(1-l_discount)) as sum_disc_price,
 SUM(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge,
 AVG(l_quantity) as avg_qty, AVG(l_extendedprice) as avg_price,
 AVG(l_discount) as avg_disc, COUNT(*) as count_order
 FROM lineitem WHERE l_shipdate <= '1998-12-01'
 GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""


def q1(cat):
    scan = TableScan(_g(cat, "lineitem"), col("l_shipdate") <= lit("1998-12-01"))
    disc_price = col("l_extendedprice") * (lit(1) - col("l_discount"))
    charge = disc_price * (lit(1) + col("l_tax"))
    agg = Aggregate(scan, ["l_returnflag", "l_linestatus"], [
        ("sum_qty", sum_(col("l_quantity"))),
        ("sum_base_price", sum_(col("l_extendedprice"))),
        ("sum_disc_price", sum_(disc_price)),
        ("sum_charge", sum_(charge)),
        ("avg_qty", avg_(col("l_quantity"))),
        ("avg_price", avg_(col("l_extendedprice"))),
        ("avg_disc", avg_(col("l_discount"))),
        ("count_order", count_()),
    ])
    return Sort(agg, ["l_returnflag", "l_linestatus"])


# ---------------------------------------------------------------------------
# Q2

SQL_2 = """SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
 s_phone, s_comment FROM part, partsupp, supplier, nation, region
 WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey AND p_size = 15
 AND p_type like '%BRASS' AND s_nationkey = n_nationkey
 AND n_regionkey = r_regionkey AND r_name = 'EUROPE'
 AND ps_supplycost = (SELECT min(ps_supplycost) FROM supplier, partsupp,
   nation, region WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
   AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
   AND r_name = 'EUROPE')
 ORDER BY s_acctbal DESC, n_name, s_name, p_partkey"""


def q2(cat):
    region = TableScan(_g(cat, "region"), col("r_name") == lit("EUROPE"))
    nation = Join(_g(cat, "nation"), region, INNER, ("n_regionkey", "r_regionkey"))
    supp = Join(_g(cat, "supplier"), nation, INNER, ("s_nationkey", "n_nationkey"))
    ps_eu = Join(_g(cat, "partsupp"), supp, INNER, ("ps_suppkey", "s_suppkey"))
    min_cost = Aggregate(ps_eu, ["ps_partkey"],
                         [("min_cost", min_(col("ps_supplycost")))])
    part = TableScan(_g(cat, "part"),
                     (col("p_size") == lit(15)) & col("p_type").like("%BRASS"))
    j1 = Join(part, ps_eu, INNER, ("p_partkey", "ps_partkey"))
    j2 = Join(j1, min_cost, INNER, ("p_partkey", "ps_partkey"))
    flt = TableScan(j2, col("ps_supplycost") == col("min_cost"))
    proj = Projection(flt, ["s_acctbal", "s_name", "n_name", "p_partkey",
                            "p_mfgr", "s_address", "s_phone", "s_comment"])
    return Sort(proj, [("s_acctbal", DESC), "n_name", "s_name", "p_partkey"])


# ---------------------------------------------------------------------------
# Q3

SQL_3 = """SELECT l_orderkey, SUM(l_extendedprice*(1-l_discount)) as revenue,
 o_orderdate, o_shippriority FROM customer, orders, lineitem
 WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
 AND l_orderkey = o_orderkey AND o_orderdate < '1995-03-15'
 AND l_shipdate > '1995-03-15'
 GROUP BY l_orderkey, o_orderdate, o_shippriority
 ORDER BY revenue DESC, o_orderdate"""


def q3(cat):
    cust = TableScan(_g(cat, "customer"), col("c_mktsegment") == lit("BUILDING"))
    orders = TableScan(_g(cat, "orders"), col("o_orderdate") < lit("1995-03-15"))
    li = TableScan(_g(cat, "lineitem"), col("l_shipdate") > lit("1995-03-15"))
    j1 = Join(orders, cust, INNER, ("o_custkey", "c_custkey"))
    j2 = Join(li, j1, INNER, ("l_orderkey", "o_orderkey"))
    agg = Aggregate(j2, ["l_orderkey", "o_orderdate", "o_shippriority"], [
        ("revenue", sum_(col("l_extendedprice") * (lit(1) - col("l_discount")))),
    ])
    proj = Projection(agg, ["l_orderkey", "revenue", "o_orderdate",
                            "o_shippriority"])
    return Sort(proj, [("revenue", DESC), "o_orderdate"])


# ---------------------------------------------------------------------------
# Q4

SQL_4 = """SELECT o_orderpriority, count(*) as order_count FROM orders
 WHERE o_orderdate >= '1996-07-01' AND o_orderdate < '1996-10-01'
 AND exists (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
   AND l_commitdate < l_receiptdate)
 GROUP BY o_orderpriority ORDER BY o_orderpriority"""


def q4(cat):
    orders = TableScan(_g(cat, "orders"),
                       (col("o_orderdate") >= lit("1996-07-01"))
                       & (col("o_orderdate") < lit("1996-10-01")))
    late = TableScan(_g(cat, "lineitem"),
                     col("l_commitdate") < col("l_receiptdate"))
    semi = Join(orders, late, JoinMode.SEMI, ("o_orderkey", "l_orderkey"))
    agg = Aggregate(semi, ["o_orderpriority"], [("order_count", count_())])
    return Sort(agg, ["o_orderpriority"])


# ---------------------------------------------------------------------------
# Q5

SQL_5 = """SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) as revenue
 FROM customer, orders, lineitem, supplier, nation, region
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
 AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
 AND r_name = 'AMERICA' AND o_orderdate >= '1994-01-01'
 AND o_orderdate < '1995-01-01' GROUP BY n_name ORDER BY revenue DESC"""


def q5(cat):
    region = TableScan(_g(cat, "region"), col("r_name") == lit("AMERICA"))
    nation = Join(_g(cat, "nation"), region, INNER, ("n_regionkey", "r_regionkey"))
    supp = Join(_g(cat, "supplier"), nation, INNER, ("s_nationkey", "n_nationkey"))
    orders = TableScan(_g(cat, "orders"),
                       (col("o_orderdate") >= lit("1994-01-01"))
                       & (col("o_orderdate") < lit("1995-01-01")))
    li = Join(_g(cat, "lineitem"), orders, INNER, ("l_orderkey", "o_orderkey"))
    j = Join(li, supp, INNER, ("l_suppkey", "s_suppkey"))
    # c_custkey = o_custkey AND c_nationkey = s_nationkey: join on custkey,
    # then filter nation equality.
    j2 = Join(j, _g(cat, "customer"), INNER, ("o_custkey", "c_custkey"))
    flt = TableScan(j2, col("c_nationkey") == col("s_nationkey"))
    agg = Aggregate(flt, ["n_name"], [
        ("revenue", sum_(col("l_extendedprice") * (lit(1) - col("l_discount")))),
    ])
    return Sort(agg, [("revenue", DESC)])


# ---------------------------------------------------------------------------
# Q6

SQL_6 = """SELECT sum(l_extendedprice*l_discount) AS revenue FROM lineitem
 WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
 AND l_discount BETWEEN .06 - 0.01 AND .06 + 0.01001 AND l_quantity < 24"""


def q6(cat):
    scan = TableScan(_g(cat, "lineitem"),
                     (col("l_shipdate") >= lit("1994-01-01"))
                     & (col("l_shipdate") < lit("1995-01-01"))
                     & col("l_discount").between(0.06 - 0.01, 0.06 + 0.01001)
                     & (col("l_quantity") < lit(24)))
    return Aggregate(scan, [], [
        ("revenue", sum_(col("l_extendedprice") * col("l_discount")))])


# ---------------------------------------------------------------------------
# Q7

SQL_7 = """SELECT supp_nation, cust_nation, l_year, SUM(volume) as revenue
 FROM (SELECT n1.n_name as supp_nation, n2.n_name as cust_nation,
   SUBSTR(l_shipdate, 1, 4) as l_year,
   l_extendedprice * (1 - l_discount) as volume
   FROM supplier, lineitem, orders, customer, nation n1, nation n2
   WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
   AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
   AND c_nationkey = n2.n_nationkey
   AND ((n1.n_name = 'IRAN' AND n2.n_name = 'IRAQ') OR
        (n1.n_name = 'IRAQ' AND n2.n_name = 'IRAN'))
   AND l_shipdate BETWEEN '1995-01-01' AND '1996-12-31') as shipping
 GROUP BY supp_nation, cust_nation, l_year
 ORDER BY supp_nation, cust_nation, l_year"""


def q7(cat):
    n1 = Alias(_g(cat, "nation"), ["n1_nationkey", "supp_nation"],
               ["n_nationkey", "n_name"])
    n2 = Alias(_g(cat, "nation"), ["n2_nationkey", "cust_nation"],
               ["n_nationkey", "n_name"])
    supp = Join(_g(cat, "supplier"), n1, INNER, ("s_nationkey", "n1_nationkey"))
    cust = Join(_g(cat, "customer"), n2, INNER, ("c_nationkey", "n2_nationkey"))
    li = TableScan(_g(cat, "lineitem"),
                   col("l_shipdate").between("1995-01-01", "1996-12-31"))
    j1 = Join(li, supp, INNER, ("l_suppkey", "s_suppkey"))
    j2 = Join(j1, _g(cat, "orders"), INNER, ("l_orderkey", "o_orderkey"))
    j3 = Join(j2, cust, INNER, ("o_custkey", "c_custkey"))
    flt = TableScan(j3, ((col("supp_nation") == lit("IRAN"))
                         & (col("cust_nation") == lit("IRAQ")))
                    | ((col("supp_nation") == lit("IRAQ"))
                       & (col("cust_nation") == lit("IRAN"))))
    proj = Projection(flt, [
        "supp_nation", "cust_nation",
        ("l_year", col("l_shipdate").substr(1, 4)),
        ("volume", col("l_extendedprice") * (lit(1) - col("l_discount"))),
    ])
    agg = Aggregate(proj, ["supp_nation", "cust_nation", "l_year"],
                    [("revenue", sum_(col("volume")))])
    return Sort(agg, ["supp_nation", "cust_nation", "l_year"])


# ---------------------------------------------------------------------------
# Q8

SQL_8 = """SELECT o_year,
 SUM(case when nation = 'BRAZIL' then volume else 0 end) / SUM(volume) as mkt_share
 FROM (SELECT SUBSTR(o_orderdate, 1, 4) as o_year,
   l_extendedprice * (1-l_discount) as volume, n2.n_name as nation
   FROM part, supplier, lineitem, orders, customer, nation n1, nation n2, region
   WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
   AND l_orderkey = o_orderkey AND o_custkey = c_custkey
   AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
   AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey
   AND o_orderdate between '1995-01-01' AND '1996-12-31'
   AND p_type = 'ECONOMY ANODIZED STEEL') as all_nations
 GROUP BY o_year ORDER BY o_year"""


def q8(cat):
    region = TableScan(_g(cat, "region"), col("r_name") == lit("AMERICA"))
    n1 = Alias(_g(cat, "nation"), ["n1_nationkey", "n1_regionkey"],
               ["n_nationkey", "n_regionkey"])
    n1r = Join(n1, region, INNER, ("n1_regionkey", "r_regionkey"))
    n2 = Alias(_g(cat, "nation"), ["n2_nationkey", "nation"],
               ["n_nationkey", "n_name"])
    part = TableScan(_g(cat, "part"),
                     col("p_type") == lit("ECONOMY ANODIZED STEEL"))
    li = Join(_g(cat, "lineitem"), part, INNER, ("l_partkey", "p_partkey"))
    supp = Join(_g(cat, "supplier"), n2, INNER, ("s_nationkey", "n2_nationkey"))
    j1 = Join(li, supp, INNER, ("l_suppkey", "s_suppkey"))
    orders = TableScan(_g(cat, "orders"),
                       col("o_orderdate").between("1995-01-01", "1996-12-31"))
    j2 = Join(j1, orders, INNER, ("l_orderkey", "o_orderkey"))
    cust = Join(_g(cat, "customer"), n1r, INNER, ("c_nationkey", "n1_nationkey"))
    j3 = Join(j2, cust, INNER, ("o_custkey", "c_custkey"))
    proj = Projection(j3, [
        ("o_year", col("o_orderdate").substr(1, 4)),
        ("volume", col("l_extendedprice") * (lit(1) - col("l_discount"))),
        "nation",
    ])
    agg = Aggregate(proj, ["o_year"], [
        ("brazil_volume", sum_(Case([(col("nation") == lit("BRAZIL"),
                                      col("volume"))], lit(0.0)))),
        ("total_volume", sum_(col("volume"))),
    ])
    proj2 = Projection(agg, [
        "o_year", ("mkt_share", col("brazil_volume") / col("total_volume"))])
    return Sort(proj2, ["o_year"])


# ---------------------------------------------------------------------------
# Q9

SQL_9 = """SELECT nation, o_year, SUM(amount) as sum_profit FROM
 (SELECT n_name as nation, SUBSTR(o_orderdate, 1, 4) as o_year,
   l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
   FROM supplier, lineitem, partsupp, orders, nation, part
   WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
   AND ps_partkey = l_partkey AND p_partkey = l_partkey
   AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
   AND p_name like '%green%') as profit
 GROUP BY nation, o_year ORDER BY nation, o_year DESC"""


def q9(cat):
    part = TableScan(_g(cat, "part"), col("p_name").like("%green%"))
    li = Join(_g(cat, "lineitem"), part, INNER, ("l_partkey", "p_partkey"))
    # partsupp joined on composite (partkey, suppkey): packed-key equi join
    ps = _g(cat, "partsupp")
    ps_keyed = Projection(ps, [
        ("ps_key", col("ps_partkey").cast(DataType.INT64) * lit(1 << 20)
         + col("ps_suppkey").cast(DataType.INT64)),
        "ps_partkey", "ps_suppkey", "ps_supplycost",
    ])
    li_keyed = Projection(li, [
        ("l_key", col("l_partkey").cast(DataType.INT64) * lit(1 << 20)
         + col("l_suppkey").cast(DataType.INT64)),
        "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
        "l_extendedprice", "l_discount",
    ])
    j1 = Join(li_keyed, ps_keyed, INNER, ("l_key", "ps_key"))
    supp = Join(_g(cat, "supplier"), _g(cat, "nation"), INNER,
                ("s_nationkey", "n_nationkey"))
    j2 = Join(j1, supp, INNER, ("l_suppkey", "s_suppkey"))
    j3 = Join(j2, _g(cat, "orders"), INNER, ("l_orderkey", "o_orderkey"))
    proj = Projection(j3, [
        ("nation", col("n_name")),
        ("o_year", col("o_orderdate").substr(1, 4)),
        ("amount", col("l_extendedprice") * (lit(1) - col("l_discount"))
         - col("ps_supplycost") * col("l_quantity")),
    ])
    agg = Aggregate(proj, ["nation", "o_year"],
                    [("sum_profit", sum_(col("amount")))])
    return Sort(agg, ["nation", ("o_year", DESC)])


# ---------------------------------------------------------------------------
# Q10

SQL_10 = """SELECT c_custkey, c_name,
 SUM(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal, n_name,
 c_address, c_phone, c_comment FROM customer, orders, lineitem, nation
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND o_orderdate >= '1993-10-01' AND o_orderdate < '1994-01-01'
 AND l_returnflag = 'R' AND c_nationkey = n_nationkey
 GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
 ORDER BY revenue DESC"""


def q10(cat):
    orders = TableScan(_g(cat, "orders"),
                       (col("o_orderdate") >= lit("1993-10-01"))
                       & (col("o_orderdate") < lit("1994-01-01")))
    li = TableScan(_g(cat, "lineitem"), col("l_returnflag") == lit("R"))
    j1 = Join(li, orders, INNER, ("l_orderkey", "o_orderkey"))
    cust = Join(_g(cat, "customer"), _g(cat, "nation"), INNER,
                ("c_nationkey", "n_nationkey"))
    j2 = Join(j1, cust, INNER, ("o_custkey", "c_custkey"))
    agg = Aggregate(j2, ["c_custkey", "c_name", "c_acctbal", "c_phone",
                         "n_name", "c_address", "c_comment"], [
        ("revenue", sum_(col("l_extendedprice") * (lit(1) - col("l_discount")))),
    ])
    proj = Projection(agg, ["c_custkey", "c_name", "revenue", "c_acctbal",
                            "n_name", "c_address", "c_phone", "c_comment"])
    return Sort(proj, [("revenue", DESC)])


# ---------------------------------------------------------------------------
# Q11

SQL_11 = """SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) as value
 FROM partsupp, supplier, nation WHERE ps_suppkey = s_suppkey
 AND s_nationkey = n_nationkey AND n_name = 'GERMANY'
 GROUP BY ps_partkey having SUM(ps_supplycost * ps_availqty) > (
   SELECT SUM(ps_supplycost * ps_availqty) * 0.0001 FROM partsupp, supplier,
   nation WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
   AND n_name = 'GERMANY') ORDER BY value DESC"""


def q11(cat):
    nation = TableScan(_g(cat, "nation"), col("n_name") == lit("GERMANY"))
    supp = Join(_g(cat, "supplier"), nation, INNER, ("s_nationkey", "n_nationkey"))
    ps = Join(_g(cat, "partsupp"), supp, INNER, ("ps_suppkey", "s_suppkey"))
    total = _scalar(Aggregate(
        ps, [], [("t", sum_(col("ps_supplycost") * col("ps_availqty")))]))
    agg = Aggregate(ps, ["ps_partkey"], [
        ("value", sum_(col("ps_supplycost") * col("ps_availqty")))])
    # SUM over zero rows is NULL: `value > NULL` is UNKNOWN, so the HAVING
    # keeps nothing (can happen at tiny scale factors with no GERMANY
    # suppliers) — +inf as the threshold reproduces the empty result
    threshold = float("inf") if total is None else float(total) * 0.0001
    flt = TableScan(agg, col("value") > lit(threshold))
    return Sort(flt, [("value", DESC)])


# ---------------------------------------------------------------------------
# Q12

SQL_12 = """SELECT l_shipmode,
 SUM(case when o_orderpriority ='1-URGENT' or o_orderpriority ='2-HIGH'
   then 1 else 0 end) as high_line_count,
 SUM(case when o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH'
   then 1 else 0 end) as low_line_count FROM orders, lineitem
 WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL','SHIP')
 AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
 AND l_receiptdate >= '1994-01-01' AND l_receiptdate < '1995-01-01'
 GROUP BY l_shipmode ORDER BY l_shipmode"""


def q12(cat):
    li = TableScan(_g(cat, "lineitem"),
                   col("l_shipmode").isin(["MAIL", "SHIP"])
                   & (col("l_commitdate") < col("l_receiptdate"))
                   & (col("l_shipdate") < col("l_commitdate"))
                   & (col("l_receiptdate") >= lit("1994-01-01"))
                   & (col("l_receiptdate") < lit("1995-01-01")))
    j = Join(li, _g(cat, "orders"), INNER, ("l_orderkey", "o_orderkey"))
    high = Case([((col("o_orderpriority") == lit("1-URGENT"))
                  | (col("o_orderpriority") == lit("2-HIGH")), lit(1))], lit(0))
    low = Case([((col("o_orderpriority") != lit("1-URGENT"))
                 & (col("o_orderpriority") != lit("2-HIGH")), lit(1))], lit(0))
    agg = Aggregate(j, ["l_shipmode"], [
        ("high_line_count", sum_(high)), ("low_line_count", sum_(low))])
    return Sort(agg, ["l_shipmode"])


# ---------------------------------------------------------------------------
# Q13

SQL_13 = """SELECT c_count, count(*) as custdist FROM
 (SELECT c_custkey, count(o_orderkey) AS c_count FROM customer
  left outer join orders on c_custkey = o_custkey
  AND o_comment not like '%special%request%'
  GROUP BY c_custkey) as c_orders
 GROUP BY c_count ORDER BY custdist DESC, c_count DESC"""


def q13(cat):
    # Aggregate orders by o_custkey BEFORE the left join (aggregate
    # pushdown): COUNT(o_orderkey) over the join equals the per-custkey
    # order count, with no-order customers surfacing as a NULL count
    # coalesced to 0. Shrinks the join build from |orders| to |customers|.
    orders = TableScan(_g(cat, "orders"),
                       col("o_comment").not_like("%special%request%"))
    cnt = Aggregate(orders, ["o_custkey"], [("c_count0", count_())])
    j = Join(_g(cat, "customer"), cnt, JoinMode.LEFT,
             ("c_custkey", "o_custkey"))
    per_cust = Projection(j, [
        ("c_count", Case([(col("c_count0").is_null(), lit(0))],
                         col("c_count0")))])
    agg = Aggregate(per_cust, ["c_count"], [("custdist", count_())])
    return Sort(agg, [("custdist", DESC), ("c_count", DESC)])


# ---------------------------------------------------------------------------
# Q14

SQL_14 = """SELECT 100.00 *
 SUM(case when p_type like 'PROMO%' then l_extendedprice*(1-l_discount)
   else 0 end) / SUM(l_extendedprice * (1 - l_discount)) as promo_revenue
 FROM lineitem, part WHERE l_partkey = p_partkey
 AND l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'"""


def q14(cat):
    li = TableScan(_g(cat, "lineitem"),
                   (col("l_shipdate") >= lit("1995-09-01"))
                   & (col("l_shipdate") < lit("1995-10-01")))
    j = Join(li, _g(cat, "part"), INNER, ("l_partkey", "p_partkey"))
    promo = Case([(col("p_type").like("PROMO%"),
                   col("l_extendedprice") * (lit(1) - col("l_discount")))],
                 lit(0.0))
    agg = Aggregate(j, [], [
        ("promo", sum_(promo)),
        ("total", sum_(col("l_extendedprice") * (lit(1) - col("l_discount")))),
    ])
    return Projection(agg, [
        ("promo_revenue", lit(100.0) * col("promo") / col("total"))])


# ---------------------------------------------------------------------------
# Q15

SQL_15 = """SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
 FROM supplier, (SELECT l_suppkey AS supplier_no,
   SUM(l_extendedprice * (1 - l_discount)) AS total_revenue FROM lineitem
   WHERE l_shipdate >= '1993-05-13' AND l_shipdate < '1993-08-13'
   GROUP BY l_suppkey) AS revenue
 WHERE s_suppkey = supplier_no AND total_revenue =
   (SELECT max(SUM_REV) FROM (SELECT SUM(l_extendedprice * (1 - l_discount))
    AS SUM_REV FROM lineitem WHERE l_shipdate >= '1993-05-13'
    AND l_shipdate < '1993-08-13' GROUP BY l_suppkey))
 ORDER BY s_suppkey"""


def q15(cat):
    # The revenue view is a SHARED subplan (the reference's CREATE VIEW):
    # its max is joined back on total_revenue equality instead of being
    # pulled to the host, so the whole query stays one DAG. The view runs
    # once (an operator caches its output), so the sum and its max are the
    # same bits.
    li = TableScan(_g(cat, "lineitem"),
                   (col("l_shipdate") >= lit("1993-05-13"))
                   & (col("l_shipdate") < lit("1993-08-13")))
    revenue = Aggregate(li, ["l_suppkey"], [
        ("total_revenue", sum_(col("l_extendedprice")
                               * (lit(1) - col("l_discount"))))])
    mx = Aggregate(revenue, [], [("m", max_(col("total_revenue")))])
    best = Join(revenue, mx, INNER, ("total_revenue", "m"))
    j = Join(_g(cat, "supplier"), best, INNER, ("s_suppkey", "l_suppkey"))
    proj = Projection(j, ["s_suppkey", "s_name", "s_address", "s_phone",
                          "total_revenue"])
    return Sort(proj, ["s_suppkey"])


# ---------------------------------------------------------------------------
# Q16

SQL_16 = """SELECT p_brand, p_type, p_size,
 count(distinct ps_suppkey) as supplier_cnt FROM partsupp, part
 WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
 AND p_type not like 'MEDIUM POLISHED%'
 AND p_size in (49, 14, 23, 45, 19, 3, 36, 9)
 AND ps_suppkey not in (SELECT s_suppkey FROM supplier
   WHERE s_comment like '%Customer%Complaints%')
 GROUP BY p_brand, p_type, p_size
 ORDER BY supplier_cnt DESC, p_brand, p_type, p_size"""


def q16(cat):
    part = TableScan(_g(cat, "part"),
                     (col("p_brand") != lit("Brand#45"))
                     & col("p_type").not_like("MEDIUM POLISHED%")
                     & col("p_size").isin([49, 14, 23, 45, 19, 3, 36, 9]))
    complainers = TableScan(_g(cat, "supplier"),
                            col("s_comment").like("%Customer%Complaints%"))
    ps = Join(_g(cat, "partsupp"), complainers, JoinMode.ANTI,
              ("ps_suppkey", "s_suppkey"))
    j = Join(ps, part, INNER, ("ps_partkey", "p_partkey"))
    agg = Aggregate(j, ["p_brand", "p_type", "p_size"], [
        ("supplier_cnt", count_distinct(col("ps_suppkey")))])
    return Sort(agg, [("supplier_cnt", DESC), "p_brand", "p_type", "p_size"])


# ---------------------------------------------------------------------------
# Q17

SQL_17 = """SELECT SUM(l_extendedprice) / 7.0 as avg_yearly FROM lineitem,
 part WHERE p_partkey = l_partkey AND p_brand = 'Brand#23'
 AND p_container = 'MED BOX' AND l_quantity < (SELECT 0.2 * avg(l_quantity)
 FROM lineitem WHERE l_partkey = p_partkey)"""


def q17(cat):
    # The correlated AVG is only consulted for partkeys that survive the
    # brand/container filter (~1/1000 of part), so the avg subplan
    # semi-joins lineitem down to those parts FIRST instead of averaging
    # all 200k partkeys.
    part = TableScan(_g(cat, "part"),
                     (col("p_brand") == lit("Brand#23"))
                     & (col("p_container") == lit("MED BOX")))
    li_parts = Join(_g(cat, "lineitem"), part, JoinMode.SEMI,
                    ("l_partkey", "p_partkey"))
    avg_qty = Aggregate(li_parts, ["l_partkey"],
                        [("avg_q", avg_(col("l_quantity")))])
    avg_qty_renamed = Alias(avg_qty, ["avg_partkey", "avg_q"],
                            ["l_partkey", "avg_q"])
    j1 = Join(_g(cat, "lineitem"), part, INNER, ("l_partkey", "p_partkey"))
    j2 = Join(j1, avg_qty_renamed, INNER, ("l_partkey", "avg_partkey"))
    flt = TableScan(j2, col("l_quantity") < lit(0.2) * col("avg_q"))
    agg = Aggregate(flt, [], [("s", sum_(col("l_extendedprice")))])
    return Projection(agg, [("avg_yearly", col("s") / lit(7.0))])


# ---------------------------------------------------------------------------
# Q18

SQL_18 = """SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
 SUM(l_quantity) FROM customer, orders, lineitem
 WHERE o_orderkey in (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
   having SUM(l_quantity) > 300)
 AND c_custkey = o_custkey AND o_orderkey = l_orderkey
 GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
 ORDER BY o_totalprice DESC, o_orderdate"""


def q18(cat):
    per_order = Aggregate(_g(cat, "lineitem"), ["l_orderkey"],
                          [("qty", sum_(col("l_quantity")))])
    big = TableScan(per_order, col("qty") > lit(300))
    orders = Join(_g(cat, "orders"), big, JoinMode.SEMI,
                  ("o_orderkey", "l_orderkey"))
    j1 = Join(orders, _g(cat, "customer"), INNER, ("o_custkey", "c_custkey"))
    j2 = Join(_g(cat, "lineitem"), j1, INNER, ("l_orderkey", "o_orderkey"))
    agg = Aggregate(j2, ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                         "o_totalprice"], [("sum_qty", sum_(col("l_quantity")))])
    return Sort(agg, [("o_totalprice", DESC), "o_orderdate"])


# ---------------------------------------------------------------------------
# Q19

SQL_19 = """SELECT SUM(l_extendedprice * (1 - l_discount)) as revenue
 FROM lineitem, part WHERE p_partkey = l_partkey AND ((
 p_brand = 'Brand#12' AND p_container in ('SM CASE','SM BOX','SM PACK','SM PKG')
 AND l_quantity >= 1 AND l_quantity <= 1 + 10 AND p_size between 1 AND 5
 AND l_shipmode in ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON')
 or (p_brand = 'Brand#23' AND p_container in ('MED BAG','MED BOX','MED PKG','MED PACK')
 AND l_quantity >= 10 AND l_quantity <= 10 + 10 AND p_size between 1 AND 10
 AND l_shipmode in ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON')
 or (p_brand = 'Brand#34' AND p_container in ('LG CASE','LG BOX','LG PACK','LG PKG')
 AND l_quantity >= 20 AND l_quantity <= 20 + 10 AND p_size between 1 AND 15
 AND l_shipmode in ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON'))"""


def q19(cat):
    li = TableScan(_g(cat, "lineitem"),
                   col("l_shipmode").isin(["AIR", "AIR REG"])
                   & (col("l_shipinstruct") == lit("DELIVER IN PERSON")))
    j = Join(li, _g(cat, "part"), INNER, ("l_partkey", "p_partkey"))
    b1 = ((col("p_brand") == lit("Brand#12"))
          & col("p_container").isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
          & (col("l_quantity") >= lit(1)) & (col("l_quantity") <= lit(11))
          & col("p_size").between(1, 5))
    b2 = ((col("p_brand") == lit("Brand#23"))
          & col("p_container").isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
          & (col("l_quantity") >= lit(10)) & (col("l_quantity") <= lit(20))
          & col("p_size").between(1, 10))
    b3 = ((col("p_brand") == lit("Brand#34"))
          & col("p_container").isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
          & (col("l_quantity") >= lit(20)) & (col("l_quantity") <= lit(30))
          & col("p_size").between(1, 15))
    flt = TableScan(j, b1 | b2 | b3)
    return Aggregate(flt, [], [
        ("revenue", sum_(col("l_extendedprice") * (lit(1) - col("l_discount"))))])


# ---------------------------------------------------------------------------
# Q20

SQL_20 = """SELECT s_name, s_address FROM supplier, nation
 WHERE s_suppkey in (SELECT ps_suppkey FROM partsupp
   WHERE ps_partkey in (SELECT p_partkey FROM part WHERE p_name like 'forest%')
   AND ps_availqty > (SELECT 0.5 * SUM(l_quantity) FROM lineitem
     WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
     AND l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'))
 AND s_nationkey = n_nationkey AND n_name = 'CANADA' ORDER BY s_name"""


def q20(cat):
    forest = TableScan(_g(cat, "part"), col("p_name").like("forest%"))
    ps = Join(_g(cat, "partsupp"), forest, JoinMode.SEMI,
              ("ps_partkey", "p_partkey"))
    li94 = TableScan(_g(cat, "lineitem"),
                     (col("l_shipdate") >= lit("1994-01-01"))
                     & (col("l_shipdate") < lit("1995-01-01")))
    li_keyed = Projection(li94, [
        ("lk", col("l_partkey").cast(DataType.INT64) * lit(1 << 20)
         + col("l_suppkey").cast(DataType.INT64)),
        "l_quantity",
    ])
    qty = Aggregate(li_keyed, ["lk"], [("half_qty", sum_(col("l_quantity")))])
    ps_keyed = Projection(ps, [
        ("pk", col("ps_partkey").cast(DataType.INT64) * lit(1 << 20)
         + col("ps_suppkey").cast(DataType.INT64)),
        "ps_suppkey", "ps_availqty",
    ])
    j = Join(ps_keyed, qty, INNER, ("pk", "lk"))
    good = TableScan(j, col("ps_availqty") > lit(0.5) * col("half_qty"))
    nation = TableScan(_g(cat, "nation"), col("n_name") == lit("CANADA"))
    supp = Join(_g(cat, "supplier"), nation, INNER,
                ("s_nationkey", "n_nationkey"))
    sel = Join(supp, good, JoinMode.SEMI, ("s_suppkey", "ps_suppkey"))
    proj = Projection(sel, ["s_name", "s_address"])
    return Sort(proj, ["s_name"])


# ---------------------------------------------------------------------------
# Q21

SQL_21 = """SELECT s_name, count(*) as numwait FROM supplier, lineitem l1,
 orders, nation WHERE s_suppkey = l1.l_suppkey
 AND o_orderkey = l1.l_orderkey AND o_orderstatus = 'F'
 AND l1.l_receiptdate > l1.l_commitdate AND exists
 (SELECT * FROM lineitem l2 WHERE l2.l_orderkey = l1.l_orderkey
  AND l2.l_suppkey <> l1.l_suppkey) AND not exists
 (SELECT * FROM lineitem l3 WHERE l3.l_orderkey = l1.l_orderkey
  AND l3.l_suppkey <> l1.l_suppkey AND l3.l_receiptdate > l3.l_commitdate)
 AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
 GROUP BY s_name ORDER BY numwait DESC, s_name"""


def q21(cat):
    # exists(other supp on the order) == the order has >= 2 distinct
    # suppliers == MIN(l_suppkey) != MAX(l_suppkey); not exists(other LATE
    # supp) == the only late supplier is l1's own (l1 itself is late, so
    # its supplier is always among the late set) == MIN == MAX over late
    # lineitems. MIN/MAX state the predicate without COUNT DISTINCT.
    all_supp = Aggregate(_g(cat, "lineitem"), ["l_orderkey"],
                         [("mn_supp", min_(col("l_suppkey"))),
                          ("mx_supp", max_(col("l_suppkey")))])
    all_supp = Alias(all_supp, ["ok_all", "mn_supp", "mx_supp"],
                     ["l_orderkey", "mn_supp", "mx_supp"])
    late_li = TableScan(_g(cat, "lineitem"),
                        col("l_receiptdate") > col("l_commitdate"))
    late_supp = Aggregate(late_li, ["l_orderkey"],
                          [("mn_late", min_(col("l_suppkey"))),
                           ("mx_late", max_(col("l_suppkey")))])
    late_supp = Alias(late_supp, ["ok_late", "mn_late", "mx_late"],
                      ["l_orderkey", "mn_late", "mx_late"])

    nation = TableScan(_g(cat, "nation"), col("n_name") == lit("SAUDI ARABIA"))
    supp = Join(_g(cat, "supplier"), nation, INNER,
                ("s_nationkey", "n_nationkey"))
    l1 = TableScan(_g(cat, "lineitem"),
                   col("l_receiptdate") > col("l_commitdate"))
    l1 = Join(l1, supp, INNER, ("l_suppkey", "s_suppkey"))
    ordf = TableScan(_g(cat, "orders"), col("o_orderstatus") == lit("F"))
    l1 = Join(l1, ordf, INNER, ("l_orderkey", "o_orderkey"))
    l1 = Join(l1, all_supp, INNER, ("l_orderkey", "ok_all"))
    l1 = Join(l1, late_supp, INNER, ("l_orderkey", "ok_late"))
    flt = TableScan(l1, (col("mn_supp") != col("mx_supp"))
                    & (col("mn_late") == col("mx_late")))
    agg = Aggregate(flt, ["s_name"], [("numwait", count_())])
    return Sort(agg, [("numwait", DESC), "s_name"])


# ---------------------------------------------------------------------------
# Q22

SQL_22 = """SELECT cntrycode, COUNT(*) AS numcust, SUM(c_acctbal) AS totacctbal
 FROM (SELECT SUBSTR(c_phone,1,2) AS cntrycode, c_acctbal FROM customer
   WHERE SUBSTR(c_phone,1,2) IN ('13','31','23','29','30','18','17')
   AND c_acctbal > (SELECT AVG(c_acctbal) FROM customer
     WHERE c_acctbal > 0.00
     AND SUBSTR(c_phone,1,2) IN ('13','31','23','29','30','18','17'))
   AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey)
 ) AS custsale GROUP BY cntrycode ORDER BY cntrycode"""


def q22(cat):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    in_codes = TableScan(_g(cat, "customer"),
                         col("c_phone").substr(1, 2).isin(codes))
    pos = TableScan(in_codes, col("c_acctbal") > lit(0.0))
    avg_bal = _scalar(Aggregate(pos, [], [("a", avg_(col("c_acctbal")))]))
    rich = TableScan(in_codes, col("c_acctbal") > lit(float(avg_bal)))
    no_orders = Join(rich, _g(cat, "orders"), JoinMode.ANTI,
                     ("c_custkey", "o_custkey"))
    proj = Projection(no_orders, [
        ("cntrycode", col("c_phone").substr(1, 2)), "c_acctbal"])
    agg = Aggregate(proj, ["cntrycode"], [
        ("numcust", count_()), ("totacctbal", sum_(col("c_acctbal")))])
    return Sort(agg, ["cntrycode"])


# ---------------------------------------------------------------------------

TPCH_SQL: Dict[int, str] = {
    1: SQL_1, 2: SQL_2, 3: SQL_3, 4: SQL_4, 5: SQL_5, 6: SQL_6, 7: SQL_7,
    8: SQL_8, 9: SQL_9, 10: SQL_10, 11: SQL_11, 12: SQL_12, 13: SQL_13,
    14: SQL_14, 15: SQL_15, 16: SQL_16, 17: SQL_17, 18: SQL_18, 19: SQL_19,
    20: SQL_20, 21: SQL_21, 22: SQL_22,
}

TPCH_PLANS: Dict[int, Callable] = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9, 10: q10,
    11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22,
}


def run_query(qid: int, catalog: Catalog) -> Table:
    if qid not in TPCH_PLANS:
        raise NotImplementedError(f"TPC-H has no Q{qid}; the plans are Q1 to Q22")
    return execute_plan(TPCH_PLANS[qid](catalog))
