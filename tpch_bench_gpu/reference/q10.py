"""TPC-H Q10: returned item reporting."""

from tpch_bench_gpu.reference.common import (Answer, floats, group, group_sum, ints, key_map,
                                             probe)

ORDER_BY = [(2, "desc")]


def answer(d, acc):
    order_ok = d.cmp("o_orderdate", ">=", "1993-10-01") & d.cmp("o_orderdate", "<", "1994-01-01")
    o = probe(key_map(d["o_orderkey"], order_ok), d["l_orderkey"])
    m = (o >= 0) & d.eq("l_returnflag", "R")
    c = probe(key_map(d["c_custkey"]), d["o_custkey"][o[m]])
    volume = d["l_extendedprice"][m] * (1 - d["l_discount"][m])
    inv, n, first = group(d["c_custkey"][c])
    cf = c[first]
    nation = d["n_name"][probe(key_map(d["n_nationkey"]), d["c_nationkey"][cf])]
    return Answer([ints(d["c_custkey"][cf]), d.decode("c_name", d["c_name"][cf]),
                   floats(group_sum(volume, inv, n, acc)), floats(d["c_acctbal"][cf]),
                   d.decode("n_name", nation), d.decode("c_address", d["c_address"][cf]),
                   d.decode("c_phone", d["c_phone"][cf]),
                   d.decode("c_comment", d["c_comment"][cf])],
                  ["int", "str", "float", "float", "str", "str", "str", "str"])
