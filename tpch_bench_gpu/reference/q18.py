"""TPC-H Q18: large volume customer."""

import torch

from tpch_bench_gpu.reference.common import Answer, floats, ints, key_map, probe

ORDER_BY = [(4, "desc"), (3, "asc")]


def answer(d, acc):
    order_row = key_map(d["o_orderkey"])
    o = probe(order_row, d["l_orderkey"])
    qty = torch.zeros(len(d["o_orderkey"]), dtype=acc, device=d.device).index_add_(
        0, o, d["l_quantity"].to(acc))
    big = torch.nonzero(qty > 300).squeeze(1)
    c = probe(key_map(d["c_custkey"]), d["o_custkey"][big])
    return Answer([d.decode("c_name", d["c_name"][c]), ints(d["c_custkey"][c]),
                   ints(d["o_orderkey"][big]), d.decode("o_orderdate", d["o_orderdate"][big]),
                   floats(d["o_totalprice"][big]), floats(qty[big])],
                  ["str", "int", "int", "str", "float", "float"])
