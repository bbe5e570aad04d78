"""TPC-H Q5: local supplier volume."""

import torch

from tpch_bench_gpu.reference.common import Answer, floats, group, group_sum, key_map, probe

ORDER_BY = [(1, "desc")]


def answer(d, acc):
    america = set(d["r_regionkey"][d.eq("r_name", "AMERICA")].tolist())
    nation_ok = torch.tensor([int(r) in america for r in d["n_regionkey"].tolist()],
                             device=d.device)
    nation_row = key_map(d["n_nationkey"])
    order_ok = d.cmp("o_orderdate", ">=", "1994-01-01") & d.cmp("o_orderdate", "<", "1995-01-01")
    o = probe(key_map(d["o_orderkey"], order_ok), d["l_orderkey"])
    m = o >= 0
    c = probe(key_map(d["c_custkey"]), d["o_custkey"][o[m]])
    s = probe(key_map(d["s_suppkey"]), d["l_suppkey"][m])
    c_nat, s_nat = d["c_nationkey"][c], d["s_nationkey"][s]
    n = probe(nation_row, s_nat)
    keep = (c_nat == s_nat) & nation_ok[n]
    volume = (d["l_extendedprice"][m] * (1 - d["l_discount"][m]))[keep]
    name = d["n_name"][n[keep]]
    inv, k, first = group(name)
    return Answer([d.decode("n_name", name[first]), floats(group_sum(volume, inv, k, acc))],
                  ["str", "float"])
