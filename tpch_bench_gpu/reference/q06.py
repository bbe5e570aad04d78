"""TPC-H Q6: forecasting revenue change."""

import numpy as np

from tpch_bench_gpu.reference.common import Answer

ORDER_BY = []


def answer(d, acc):
    disc = d["l_discount"].double()  # compared with float literals: in float64
    m = d.cmp("l_shipdate", ">=", "1994-01-01") & d.cmp("l_shipdate", "<", "1995-01-01") & \
        (disc >= .06 - 0.01) & (disc <= .06 + 0.01001) & (d["l_quantity"] < 24)
    if not bool(m.any()):
        return Answer([np.array([np.nan])], ["float"])
    revenue = (d["l_extendedprice"][m] * d["l_discount"][m]).to(acc).sum()
    return Answer([np.array([float(revenue)])], ["float"])
