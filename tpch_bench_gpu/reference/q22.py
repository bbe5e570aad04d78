"""TPC-H Q22: global sales opportunity."""

import numpy as np
import torch

from tpch_bench_gpu.reference.common import Answer, floats, group, group_count, group_sum

ORDER_BY = [(0, "asc")]


def answer(d, acc):
    code, code_pool = d.substr("c_phone", 1, 2)
    listed = torch.from_numpy(np.isin(code_pool, ["13", "31", "23", "29", "30", "18", "17"])
                              ).to(d.device)[code]
    bal = d["c_acctbal"].to(acc)  # compared with float64 values: in float64
    positive = listed & (d["c_acctbal"].double() > 0.00)
    average = bal[positive].sum() / positive.sum().to(acc)
    has_orders = torch.isin(d["c_custkey"], d["o_custkey"])
    m = listed & (bal > average) & ~has_orders
    c = code[m]
    inv, n, first = group(c)
    return Answer([code_pool[c[first].cpu().numpy()].astype(object),
                   group_count(inv, n).cpu().numpy(),
                   floats(group_sum(d["c_acctbal"][m], inv, n, acc))],
                  ["str", "int", "float"])
