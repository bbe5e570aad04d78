"""TPC-H Q15: top supplier."""

from tpch_bench_gpu.reference.common import (Answer, floats, group, group_sum, ints, key_map,
                                             probe)

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    m = d.cmp("l_shipdate", ">=", "1993-05-13") & d.cmp("l_shipdate", "<", "1993-08-13")
    volume = d["l_extendedprice"][m] * (1 - d["l_discount"][m])
    supp = d["l_suppkey"][m]
    inv, n, first = group(supp)
    revenue = group_sum(volume, inv, n, acc)
    top = revenue == revenue.max()
    s = probe(key_map(d["s_suppkey"]), supp[first][top])
    return Answer([ints(d["s_suppkey"][s]), d.decode("s_name", d["s_name"][s]),
                   d.decode("s_address", d["s_address"][s]), d.decode("s_phone", d["s_phone"][s]),
                   floats(revenue[top])],
                  ["int", "str", "str", "str", "float"])
