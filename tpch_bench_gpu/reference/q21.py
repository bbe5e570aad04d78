"""TPC-H Q21: suppliers who kept orders waiting."""

import torch

from tpch_bench_gpu.reference.common import Answer, group, group_count, key_map, probe

ORDER_BY = [(1, "desc"), (0, "asc")]


def answer(d, acc):
    d.order_codes("l_commitdate", "l_receiptdate")
    order_row = key_map(d["o_orderkey"])
    o = probe(order_row, d["l_orderkey"])
    late = d["l_receiptdate"] > d["l_commitdate"]
    n_orders = len(d["o_orderkey"])
    # distinct suppliers of each order, over all its lines and over its late lines
    _, _, pair = group(o, d["l_suppkey"])
    suppliers = torch.bincount(o[pair], minlength=n_orders)
    _, _, late_pair = group(o[late], d["l_suppkey"][late])
    late_suppliers = torch.bincount(o[late][late_pair], minlength=n_orders)
    # l1 is late, so EXISTS another supplier <=> two or more suppliers, and
    # NOT EXISTS another late supplier <=> l1's is the order's only late one
    s = probe(key_map(d["s_suppkey"]), d["l_suppkey"])
    saudi = d.eq("n_name", "SAUDI ARABIA")[probe(key_map(d["n_nationkey"]), d["s_nationkey"][s])]
    m = late & d.eq("o_orderstatus", "F")[o] & (suppliers[o] >= 2) & \
        (late_suppliers[o] == 1) & saudi
    name = d["s_name"][s[m]]
    inv, n, first = group(name)
    return Answer([d.decode("s_name", name[first]), group_count(inv, n).cpu().numpy()],
                  ["str", "int"])
