"""TPC-H Q1: pricing summary report."""

from tpch_bench_gpu.reference.common import Answer, floats, group, group_count, group_sum, ints

ORDER_BY = [(0, "asc"), (1, "asc")]


def answer(d, acc):
    m = d.cmp("l_shipdate", "<=", "1998-12-01")
    rf, ls = d["l_returnflag"][m], d["l_linestatus"][m]
    qty, price = d["l_quantity"][m], d["l_extendedprice"][m]
    disc, tax = d["l_discount"][m], d["l_tax"][m]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    inv, n, first = group(rf, ls)
    count = group_count(inv, n)
    sums = [group_sum(v, inv, n, acc) for v in (qty, price, disc_price, charge)]
    avgs = [group_sum(v, inv, n, acc) / count.to(acc) for v in (qty, price, disc)]
    return Answer([d.decode("l_returnflag", rf[first]), d.decode("l_linestatus", ls[first]),
                   *[floats(s) for s in sums], *[floats(a) for a in avgs], ints(count)],
                  ["str", "str"] + ["float"] * 7 + ["int"])
