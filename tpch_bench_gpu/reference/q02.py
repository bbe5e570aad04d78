"""TPC-H Q2: minimum cost supplier."""

import torch

from tpch_bench_gpu.reference.common import Answer, floats, ints, key_map, probe

ORDER_BY = [(0, "desc"), (2, "asc"), (1, "asc"), (3, "asc")]


def answer(d, acc):
    region_ok = d.eq("r_name", "EUROPE")
    europe = set(ints(d["r_regionkey"][region_ok]).tolist())
    nation_ok = torch.tensor([int(r) in europe for r in ints(d["n_regionkey"])],
                             device=d.device)
    nation_row = key_map(d["n_nationkey"])
    supp_row = key_map(d["s_suppkey"])
    ps_supp = probe(supp_row, d["ps_suppkey"])
    ps_nation = probe(nation_row, d["s_nationkey"][ps_supp])
    ps_eu = nation_ok[ps_nation]
    # the correlated subquery: the least European supply cost of each part
    part_key = d["ps_partkey"].long()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=d.device)
    min_cost = torch.full((int(part_key.max()) + 1,), float("inf"), dtype=torch.float32,
                          device=d.device)
    min_cost.scatter_reduce_(0, part_key[ps_eu], d["ps_supplycost"][ps_eu], reduce="amin")
    part_row = key_map(d["p_partkey"])
    ps_part = probe(part_row, d["ps_partkey"])
    part_ok = (d["p_size"] == 15) & d.like("p_type", "%BRASS")
    rows = ps_eu & part_ok[ps_part] & (d["ps_supplycost"] == min_cost[part_key]) & \
        (min_cost[part_key] != inf)
    s, p = ps_supp[rows], ps_part[rows]
    nat = ps_nation[rows]
    return Answer([floats(d["s_acctbal"][s]), d.decode("s_name", d["s_name"][s]),
                   d.decode("n_name", d["n_name"][nat]), ints(d["p_partkey"][p]),
                   d.decode("p_mfgr", d["p_mfgr"][p]), d.decode("s_address", d["s_address"][s]),
                   d.decode("s_phone", d["s_phone"][s]), d.decode("s_comment", d["s_comment"][s])],
                  ["float", "str", "str", "int", "str", "str", "str", "str"])
