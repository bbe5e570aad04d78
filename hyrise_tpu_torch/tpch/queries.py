"""TPC-H Q1 and Q6 as physical operator plans, with their SQL oracle texts.

Port of the first two plans of hyrise_tpu/tpch/queries.py (reference:
src/benchmarklib/tpch/tpch_queries.cpp, with the documented Hyrise
deviations: dates as strings, Q6 discount bound +0.01001 for float32).
The other 20 plans need joins and come with the join slice.
"""

from __future__ import annotations

from typing import Callable, Dict

from hyrise_tpu_torch.expression.ast import avg_, col, count_, lit, sum_
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table

SQL_1 = """SELECT l_returnflag, l_linestatus, SUM(l_quantity) as sum_qty,
 SUM(l_extendedprice) as sum_base_price,
 SUM(l_extendedprice*(1-l_discount)) as sum_disc_price,
 SUM(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge,
 AVG(l_quantity) as avg_qty, AVG(l_extendedprice) as avg_price,
 AVG(l_discount) as avg_disc, COUNT(*) as count_order
 FROM lineitem WHERE l_shipdate <= '1998-12-01'
 GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""


def q1(cat: Catalog):
    scan = TableScan(GetTable("lineitem", cat),
                     col("l_shipdate") <= lit("1998-12-01"))
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


SQL_6 = """SELECT sum(l_extendedprice*l_discount) AS revenue FROM lineitem
 WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
 AND l_discount BETWEEN .06 - 0.01 AND .06 + 0.01001 AND l_quantity < 24"""


def q6(cat: Catalog):
    scan = TableScan(GetTable("lineitem", cat),
                     (col("l_shipdate") >= lit("1994-01-01"))
                     & (col("l_shipdate") < lit("1995-01-01"))
                     & col("l_discount").between(0.06 - 0.01, 0.06 + 0.01001)
                     & (col("l_quantity") < lit(24)))
    return Aggregate(scan, [], [
        ("revenue", sum_(col("l_extendedprice") * col("l_discount")))])


TPCH_SQL: Dict[int, str] = {1: SQL_1, 6: SQL_6}

TPCH_PLANS: Dict[int, Callable] = {1: q1, 6: q6}


def run_query(qid: int, catalog: Catalog) -> Table:
    if qid not in TPCH_PLANS:
        raise NotImplementedError(
            f"TPC-H Q{qid} is not ported yet; the port runs Q1 and Q6")
    return execute_plan(TPCH_PLANS[qid](catalog))
