"""TPC-H Q8: national market share."""

import torch

from tpch_bench_gpu.reference.common import Answer, floats, group, group_sum, key_map, probe

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    nation_row = key_map(d["n_nationkey"])
    america = set(d["r_regionkey"][d.eq("r_name", "AMERICA")].tolist())
    nation_in_america = torch.tensor([int(r) in america for r in d["n_regionkey"].tolist()],
                                     device=d.device)
    part_ok = d.eq("p_type", "ECONOMY ANODIZED STEEL")
    order_ok = d.cmp("o_orderdate", ">=", "1995-01-01") & d.cmp("o_orderdate", "<=", "1996-12-31")
    p = probe(key_map(d["p_partkey"]), d["l_partkey"])
    o = probe(key_map(d["o_orderkey"], order_ok), d["l_orderkey"])
    m = part_ok[p] & (o >= 0)
    o = o[m]
    c = probe(key_map(d["c_custkey"]), d["o_custkey"][o])
    keep = nation_in_america[probe(nation_row, d["c_nationkey"][c])]
    s = probe(key_map(d["s_suppkey"]), d["l_suppkey"][m][keep])
    n2 = probe(nation_row, d["s_nationkey"][s])
    volume = (d["l_extendedprice"][m] * (1 - d["l_discount"][m]))[keep]
    brazil = d.eq("n_name", "BRAZIL")[n2]
    # CASE WHEN ... THEN volume ELSE 0 END is float32, as volume is
    brazil_volume = torch.where(brazil, volume, torch.zeros_like(volume))
    year, year_pool = d.substr("o_orderdate", 1, 4)
    year = year[o][keep]
    inv, n, first = group(year)
    share = group_sum(brazil_volume, inv, n, acc) / group_sum(volume, inv, n, acc)
    return Answer([year_pool[year[first].cpu().numpy()].astype(object), floats(share)],
                  ["str", "float"])
