"""TPC-H Q13: customer distribution."""

import torch

from tpch_bench_gpu.reference.common import Answer, group, group_count, ints

ORDER_BY = [(1, "desc"), (0, "desc")]


def answer(d, acc):
    ok = ~d.like("o_comment", "%special%request%")
    cust = d["c_custkey"].long()
    # count(o_orderkey) of each customer's matching orders; 0 for none
    per_key = torch.bincount(d["o_custkey"][ok].long(), minlength=int(cust.max()) + 1)
    c_count = per_key[cust]
    inv, n, first = group(c_count)
    return Answer([ints(c_count[first]), ints(group_count(inv, n))], ["int", "int"])
