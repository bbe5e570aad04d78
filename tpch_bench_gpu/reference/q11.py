"""TPC-H Q11: important stock identification."""

from tpch_bench_gpu.reference.common import (Answer, floats, group, group_sum, ints, key_map,
                                             probe)

ORDER_BY = [(1, "desc")]


def answer(d, acc):
    s = probe(key_map(d["s_suppkey"]), d["ps_suppkey"])
    germany = d.eq("n_name", "GERMANY")[probe(key_map(d["n_nationkey"]), d["s_nationkey"][s])]
    value = (d["ps_supplycost"] * d["ps_availqty"].float())[germany]
    threshold = value.to(acc).sum() * 0.0001
    part = d["ps_partkey"][germany]
    inv, n, first = group(part)
    sums = group_sum(value, inv, n, acc)
    keep = sums > threshold
    return Answer([ints(part[first][keep]), floats(sums[keep])], ["int", "float"])
