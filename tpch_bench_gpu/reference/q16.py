"""TPC-H Q16: parts/supplier relationship."""

import torch

from tpch_bench_gpu.reference.common import Answer, group, group_count, ints, key_map, probe

ORDER_BY = [(3, "desc"), (0, "asc"), (1, "asc"), (2, "asc")]


def answer(d, acc):
    part_ok = ~d.eq("p_brand", "Brand#45") & ~d.like("p_type", "MEDIUM POLISHED%") & \
        torch.isin(d["p_size"], torch.tensor([49, 14, 23, 45, 19, 3, 36, 9], dtype=torch.int32,
                                             device=d.device))
    complaints = d["s_suppkey"][d.like("s_comment", "%Customer%Complaints%")]
    p = probe(key_map(d["p_partkey"]), d["ps_partkey"])
    m = part_ok[p] & ~torch.isin(d["ps_suppkey"], complaints)
    p, supp = p[m], d["ps_suppkey"][m]
    brand, ptype, size = d["p_brand"][p], d["p_type"][p], d["p_size"][p]
    # count(distinct ps_suppkey): one row per (group, supplier) first
    _, _, pair_first = group(brand, ptype, size, supp)
    brand, ptype, size = brand[pair_first], ptype[pair_first], size[pair_first]
    inv, n, first = group(brand, ptype, size)
    return Answer([d.decode("p_brand", brand[first]), d.decode("p_type", ptype[first]),
                   ints(size[first]), ints(group_count(inv, n))],
                  ["str", "str", "int", "int"])
