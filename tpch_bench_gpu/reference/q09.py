"""TPC-H Q9: product type profit measure."""

import torch

from tpch_bench_gpu.reference.common import Answer, floats, group, group_sum, key_map, probe

ORDER_BY = [(0, "asc"), (1, "desc")]


def answer(d, acc):
    green = d.like("p_name", "%green%")
    p = probe(key_map(d["p_partkey"]), d["l_partkey"])
    m = green[p]
    part, supp = d["l_partkey"][m].long(), d["l_suppkey"][m].long()
    # partsupp's row of each (partkey, suppkey)
    width = int(max(d["ps_suppkey"].max(), d["l_suppkey"].max())) + 1
    ps_key = d["ps_partkey"].long() * width + d["ps_suppkey"].long()
    order = torch.argsort(ps_key)
    sorted_key = ps_key[order]
    want = part * width + supp
    at = torch.searchsorted(sorted_key, want).clamp(max=len(sorted_key) - 1)
    found = sorted_key[at] == want
    ps = order[at][found]
    sel = torch.nonzero(m).squeeze(1)[found]
    amount = d["l_extendedprice"][sel] * (1 - d["l_discount"][sel]) - \
        d["ps_supplycost"][ps] * d["l_quantity"][sel]
    s = probe(key_map(d["s_suppkey"]), d["l_suppkey"][sel])
    nation = d["n_name"][probe(key_map(d["n_nationkey"]), d["s_nationkey"][s])]
    o = probe(key_map(d["o_orderkey"]), d["l_orderkey"][sel])
    year, year_pool = d.substr("o_orderdate", 1, 4)
    year = year[o]
    inv, n, first = group(nation, year)
    return Answer([d.decode("n_name", nation[first]),
                   year_pool[year[first].cpu().numpy()].astype(object),
                   floats(group_sum(amount, inv, n, acc))],
                  ["str", "str", "float"])
