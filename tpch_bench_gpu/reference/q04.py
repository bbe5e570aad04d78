"""TPC-H Q4: order priority checking."""

import torch

from tpch_bench_gpu.reference.common import Answer, group, group_count, ints, key_map, probe

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    d.order_codes("l_commitdate", "l_receiptdate")
    late = d["l_commitdate"] < d["l_receiptdate"]
    order_row = key_map(d["o_orderkey"])
    has_late = torch.zeros(len(d["o_orderkey"]), dtype=torch.bool, device=d.device)
    o = probe(order_row, d["l_orderkey"][late])
    has_late[o[o >= 0]] = True
    m = d.cmp("o_orderdate", ">=", "1996-07-01") & d.cmp("o_orderdate", "<", "1996-10-01") & \
        has_late
    prio = d["o_orderpriority"][m]
    inv, n, first = group(prio)
    return Answer([d.decode("o_orderpriority", prio[first]), ints(group_count(inv, n))],
                  ["str", "int"])
