"""TPC-H Q19: discounted revenue."""

import numpy as np
import torch

from tpch_bench_gpu.reference.common import Answer, key_map, probe

ORDER_BY = []


def answer(d, acc):
    p = probe(key_map(d["p_partkey"]), d["l_partkey"])
    qty, size = d["l_quantity"], d["p_size"][p]
    common = d.isin("l_shipmode", ["AIR", "AIR REG"]) & \
        d.eq("l_shipinstruct", "DELIVER IN PERSON")
    m = torch.zeros_like(common)
    for brand, containers, q_lo, size_hi in (
            ("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 1, 5),
            ("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"], 10, 10),
            ("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"], 20, 15)):
        m |= d.eq("p_brand", brand)[p] & d.isin("p_container", containers)[p] & \
            (qty >= q_lo) & (qty <= q_lo + 10) & (size >= 1) & (size <= size_hi) & common
    if not bool(m.any()):
        return Answer([np.array([np.nan])], ["float"])
    revenue = (d["l_extendedprice"][m] * (1 - d["l_discount"][m])).to(acc).sum()
    return Answer([np.array([float(revenue)])], ["float"])
