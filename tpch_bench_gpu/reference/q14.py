"""TPC-H Q14: promotion effect."""

import numpy as np
import torch

from tpch_bench_gpu.reference.common import Answer, key_map, probe

ORDER_BY = []


def answer(d, acc):
    m = d.cmp("l_shipdate", ">=", "1995-09-01") & d.cmp("l_shipdate", "<", "1995-10-01")
    if not bool(m.any()):
        return Answer([np.array([np.nan])], ["float"])
    p = probe(key_map(d["p_partkey"]), d["l_partkey"][m])
    promo = d.like("p_type", "PROMO%")[p]
    volume = d["l_extendedprice"][m] * (1 - d["l_discount"][m])
    promo_volume = torch.where(promo, volume, torch.zeros_like(volume))
    share = 100.00 * promo_volume.to(acc).sum() / volume.to(acc).sum()
    return Answer([np.array([float(share)])], ["float"])
