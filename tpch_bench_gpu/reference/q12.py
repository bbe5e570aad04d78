"""TPC-H Q12: shipping modes and order priority."""

import torch

from tpch_bench_gpu.reference.common import Answer, group, group_sum, ints, key_map, probe

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    d.order_codes("l_shipdate", "l_commitdate", "l_receiptdate")
    m = d.isin("l_shipmode", ["MAIL", "SHIP"]) & \
        (d["l_commitdate"] < d["l_receiptdate"]) & (d["l_shipdate"] < d["l_commitdate"]) & \
        d.cmp("l_receiptdate", ">=", "1994-01-01") & d.cmp("l_receiptdate", "<", "1995-01-01")
    o = probe(key_map(d["o_orderkey"]), d["l_orderkey"][m])
    high = d.isin("o_orderpriority", ["1-URGENT", "2-HIGH"])[o]
    mode = d["l_shipmode"][m]
    inv, n, first = group(mode)
    one = torch.ones_like(high, dtype=torch.int64)
    return Answer([d.decode("l_shipmode", mode[first]),
                   ints(group_sum(one * high, inv, n, torch.int64)),
                   ints(group_sum(one * ~high, inv, n, torch.int64))],
                  ["str", "int", "int"])
