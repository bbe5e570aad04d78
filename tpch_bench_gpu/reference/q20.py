"""TPC-H Q20: potential part promotion."""

import torch

from tpch_bench_gpu.reference.common import Answer, key_map, probe

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    forest = d.like("p_name", "forest%")
    ps_ok = forest[probe(key_map(d["p_partkey"]), d["ps_partkey"])]
    width = int(max(d["ps_suppkey"].max(), d["l_suppkey"].max())) + 1
    ps_key = d["ps_partkey"].long() * width + d["ps_suppkey"].long()
    m = d.cmp("l_shipdate", ">=", "1994-01-01") & d.cmp("l_shipdate", "<", "1995-01-01")
    l_key = d["l_partkey"][m].long() * width + d["l_suppkey"][m].long()
    # SUM(l_quantity) of each partsupp row's lineitems; NULL (no row) fails the test
    order = torch.argsort(ps_key)
    sorted_key = ps_key[order]
    at = torch.searchsorted(sorted_key, l_key).clamp(max=len(sorted_key) - 1)
    found = sorted_key[at] == l_key
    rows = order[at][found]
    total = torch.zeros(len(ps_key), dtype=acc, device=d.device).index_add_(
        0, rows, d["l_quantity"][m][found].to(acc))
    seen = torch.zeros(len(ps_key), dtype=torch.bool, device=d.device)
    seen[rows] = True
    ps_ok &= seen & (d["ps_availqty"].to(acc) > 0.5 * total)
    supp_ok = torch.isin(d["s_suppkey"], d["ps_suppkey"][ps_ok])
    canada = d.eq("n_name", "CANADA")[probe(key_map(d["n_nationkey"]), d["s_nationkey"])]
    s = torch.nonzero(supp_ok & canada).squeeze(1)
    return Answer([d.decode("s_name", d["s_name"][s]), d.decode("s_address", d["s_address"][s])],
                  ["str", "str"])
