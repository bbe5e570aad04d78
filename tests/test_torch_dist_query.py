"""The port's hand-written distributed pipelines
(hyrise_tpu_torch/parallel/dist_query.py) against the JAX package's, after
tests/test_dist_query.py and tests/test_dist_aggregate.py.

Both packages partition the same numpy-seeded TPC-H at SF 0.01 (or the same
pandas frame) over 8 shards: the JAX side on the 8-device CPU mesh, the
port on an in-process mesh of 8 CPU shards, where each shard runs the
kernels' plain versions (K1 for dist_q6, K3 for dist_q1, K7 and K9 for the
sums by key). Floats are held to 1e-6 relative, ints exactly."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.parallel.dist_query import (dist_aggregate_sum_by_key as jax_sum_by_key,
                                            dist_q1 as jax_q1, dist_q3_step as jax_q3,
                                            dist_q6 as jax_q6)
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.parallel.partition import hash_partition as jax_hash_partition
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu_torch.kernels.q6 import q6_compute
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.parallel.dist_query import (dist_aggregate_sum_by_key, dist_q1,
                                                  dist_q3_step, dist_q6)
from hyrise_tpu_torch.parallel.exchange import dist_filter_aggregate
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.parallel.partition import hash_partition
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)

N = 8
_state = {}


def _env():
    if not _state:
        tables = generate_tables(0.01, device="cpu")
        cat = Catalog(device="cpu")
        for name, t in tables.items():
            cat.add_table(name, t)
        _state.update(jax=jax_generate_tables(0.01), port=tables, cat=cat,
                      jmesh=jax_make_mesh(N), mesh=make_mesh(N, device="cpu"))
    return _state


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def _date_code(t, column, date, side="left"):
    return int(np.searchsorted(t.column(column).dictionary, date, side=side))


def test_dist_q6_equals_jax_and_single_node():
    e = _env()
    li = e["port"]["lineitem"]
    lo, hi = _date_code(li, "l_shipdate", "1994-01-01"), _date_code(li, "l_shipdate", "1995-01-01")
    got = dist_q6(e["mesh"], hash_partition(li, "l_orderkey", e["mesh"]), lo, hi)
    assert got.dtype == torch.float64
    want = float(jax_q6(e["jmesh"], jax_hash_partition(e["jax"]["lineitem"], "l_orderkey",
                                                       e["jmesh"]), lo, hi))
    single = execute_plan(TPCH_PLANS[6](e["cat"])).rows()[0][0]
    assert _rel(float(got), want) < 1e-6 and _rel(float(got), single) < 1e-6
    # the same through dist_filter_aggregate over K1's plain version
    st = hash_partition(li, "l_orderkey", e["mesh"])
    cols = [[t.column(c).data for t in st.shards]
            for c in ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")]
    live = [torch.ones(t.num_rows, dtype=torch.bool) for t in st.shards]
    fused = dist_filter_aggregate(e["mesh"], lambda *a: q6_compute(*a, lo, hi))(*cols, live)
    assert float(fused) == float(got)


def test_dist_q1_equals_jax_cell_for_cell():
    e = _env()
    li = e["port"]["lineitem"]
    hi = _date_code(li, "l_shipdate", "1998-12-01", side="right") - 1
    got = dist_q1(e["mesh"], hash_partition(li, "l_orderkey", e["mesh"]), hi)
    want = jax_q1(e["jmesh"], jax_hash_partition(e["jax"]["lineitem"], "l_orderkey", e["jmesh"]),
                  hi)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # and the single-node plan's groups
    single = execute_plan(TPCH_PLANS[1](e["cat"]))
    n_ls = len(li.column("l_linestatus").dictionary)
    for row in single.rows():
        cell = li.column("l_returnflag").code_for(row[0]) * n_ls + \
            li.column("l_linestatus").code_for(row[1])
        assert int(got[0][cell]) == row[9]
        assert _rel(float(got[3][cell]), row[4]) < 1e-6


def test_dist_q3_step_equals_jax():
    e = _env()
    j, p, jm, m = e["jax"], e["port"], e["jmesh"], e["mesh"]
    seg = p["customer"].column("c_mktsegment").code_for("BUILDING")
    date = _date_code(p["orders"], "o_orderdate", "1995-03-15")
    for exchange in ("all_to_all", "ring"):
        revenue, matches = dist_q3_step(
            m, hash_partition(p["customer"], "c_custkey", m),
            hash_partition(p["orders"], "o_custkey", m),
            hash_partition(p["lineitem"], "l_partkey", m), seg, date, exchange=exchange)
        want_rev, want_matches = jax_q3(
            jm, N, jax_hash_partition(j["customer"], "c_custkey", jm),
            jax_hash_partition(j["orders"], "o_custkey", jm),
            jax_hash_partition(j["lineitem"], "l_partkey", jm), seg, date)
        assert int(matches) == int(want_matches)
        assert _rel(float(revenue), float(want_rev)) < 1e-6
    single = execute_plan(TPCH_PLANS[3](e["cat"]))
    assert _rel(float(revenue), sum(r[1] for r in single.rows())) < 1e-6


def _sum_by_key_both(df):
    jt = JaxTable.from_pandas("t", df)
    jst = jax_hash_partition(jt, "k", jax_make_mesh(N))
    masks = (jnp.arange(jst.shard_capacity, dtype=jnp.int32)[None, :] < jst.counts[:, None])
    g_keys, g_sums, g_valid = jax_sum_by_key(jax_make_mesh(N), N)(
        jst.column("k").data, jst.column("v").data.astype(jnp.float64), masks)
    valid = np.asarray(g_valid)
    want = [(np.asarray(g_keys)[s][valid[s]], np.asarray(g_sums)[s][valid[s]])
            for s in range(N)]
    pt = Table.from_arrays("t", [TableColumnDefinition("k", DataType.INT32),
                                 TableColumnDefinition("v", DataType.FLOAT32)],
                           [df["k"].to_numpy(), df["v"].to_numpy()], device="cpu")
    mesh = make_mesh(N, device="cpu")
    st = hash_partition(pt, "k", mesh)
    got = dist_aggregate_sum_by_key(mesh)(
        [t.column("k").data for t in st.shards],
        [t.column("v").data.to(torch.float64) for t in st.shards],
        [torch.ones(t.num_rows, dtype=torch.bool) for t in st.shards])
    return got, want


@pytest.mark.parametrize("shape", ["uniform", "skewed", "q18_inner"])
def test_dist_aggregate_sum_by_key_equals_jax(shape):
    rng = np.random.default_rng({"uniform": 0, "skewed": 1, "q18_inner": 2}[shape])
    if shape == "uniform":
        df = pd.DataFrame({"k": rng.integers(1, 500, 5000).astype(np.int32),
                           "v": rng.random(5000).astype(np.float32)})
    elif shape == "skewed":  # 80% of the rows on key 7
        k = np.where(rng.random(8000) < 0.8, 7, rng.integers(1, 1000, 8000)).astype(np.int32)
        df = pd.DataFrame({"k": k, "v": np.ones(8000, dtype=np.float32)})
    else:  # Q18's inner sum of l_quantity by l_orderkey
        li = _env()["port"]["lineitem"]
        df = pd.DataFrame({"k": li.column("l_orderkey").data.numpy().astype(np.int32),
                           "v": li.column("l_quantity").data.numpy()})
    got, want = _sum_by_key_both(df)
    exp = df.groupby("k")["v"].sum()
    seen = {}
    for s, ((keys, sums), (wk, ws)) in enumerate(zip(got, want)):
        # each shard owns the keys that hash to it, in key order, as the JAX shard
        np.testing.assert_array_equal(keys.numpy(), wk)
        np.testing.assert_allclose(sums.numpy(), ws, rtol=1e-6)
        for k, v in zip(keys.tolist(), sums.tolist()):
            assert k not in seen, "key owned by two shards"
            seen[k] = v
    assert set(seen) == {int(k) for k in exp.index}
    for k, v in exp.items():
        assert _rel(seen[int(k)], float(v)) < 1e-5
