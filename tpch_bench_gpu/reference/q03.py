"""TPC-H Q3: shipping priority."""

from tpch_bench_gpu.reference.common import (Answer, floats, group, group_sum, ints, key_map,
                                             probe)

ORDER_BY = [(1, "desc"), (2, "asc")]


def answer(d, acc):
    cust_ok = d.eq("c_mktsegment", "BUILDING")
    cust_row = key_map(d["c_custkey"])
    order_ok = d.cmp("o_orderdate", "<", "1995-03-15") & \
        cust_ok[probe(cust_row, d["o_custkey"])]
    order_row = key_map(d["o_orderkey"], order_ok)
    o = probe(order_row, d["l_orderkey"])
    m = (o >= 0) & d.cmp("l_shipdate", ">", "1995-03-15")
    o = o[m]
    volume = d["l_extendedprice"][m] * (1 - d["l_discount"][m])
    inv, n, first = group(d["l_orderkey"][m])
    revenue = group_sum(volume, inv, n, acc)
    of = o[first]
    return Answer([ints(d["l_orderkey"][m][first]), floats(revenue),
                   d.decode("o_orderdate", d["o_orderdate"][of]), ints(d["o_shippriority"][of])],
                  ["int", "float", "str", "int"])
