"""TPC-H Q7: volume shipping."""

from tpch_bench_gpu.reference.common import Answer, floats, group, group_sum, key_map, probe

ORDER_BY = [(0, "asc"), (1, "asc"), (2, "asc")]


def answer(d, acc):
    nation_row = key_map(d["n_nationkey"])
    m = d.cmp("l_shipdate", ">=", "1995-01-01") & d.cmp("l_shipdate", "<=", "1996-12-31")
    s = probe(key_map(d["s_suppkey"]), d["l_suppkey"][m])
    o = probe(key_map(d["o_orderkey"]), d["l_orderkey"][m])
    c = probe(key_map(d["c_custkey"]), d["o_custkey"][o])
    n1 = probe(nation_row, d["s_nationkey"][s])
    n2 = probe(nation_row, d["c_nationkey"][c])
    iran, iraq = d.eq("n_name", "IRAN"), d.eq("n_name", "IRAQ")
    keep = (iran[n1] & iraq[n2]) | (iraq[n1] & iran[n2])
    year, year_pool = d.substr("l_shipdate", 1, 4)
    year = year[m][keep]
    volume = (d["l_extendedprice"][m] * (1 - d["l_discount"][m]))[keep]
    supp_nation, cust_nation = d["n_name"][n1[keep]], d["n_name"][n2[keep]]
    inv, n, first = group(supp_nation, cust_nation, year)
    return Answer([d.decode("n_name", supp_nation[first]), d.decode("n_name", cust_nation[first]),
                   year_pool[year[first].cpu().numpy()].astype(object),
                   floats(group_sum(volume, inv, n, acc))],
                  ["str", "str", "str", "float"])
