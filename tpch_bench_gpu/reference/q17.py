"""TPC-H Q17: small-quantity-order revenue."""

import numpy as np
import torch

from tpch_bench_gpu.reference.common import Answer, key_map, probe

ORDER_BY = []


def answer(d, acc):
    part = d["l_partkey"].long()
    size = int(part.max()) + 1
    total = torch.zeros(size, dtype=acc, device=d.device).index_add_(
        0, part, d["l_quantity"].to(acc))
    count = torch.bincount(part, minlength=size).to(acc)
    threshold = 0.2 * (total / count)  # 0.2 * AVG(l_quantity) of the row's part
    p = probe(key_map(d["p_partkey"]), d["l_partkey"])
    part_ok = d.eq("p_brand", "Brand#23") & d.eq("p_container", "MED BOX")
    m = part_ok[p] & (d["l_quantity"].to(acc) < threshold[part])
    if not bool(m.any()):
        return Answer([np.array([np.nan])], ["float"])
    return Answer([np.array([float(d["l_extendedprice"][m].to(acc).sum() / 7.0)])], ["float"])
