"""The port's mesh, partitioning and exchanges (hyrise_tpu_torch/parallel/
mesh.py, partition.py, exchange.py) against the JAX package on the CPU.

The JAX side runs on the 8-device CPU mesh of tests/conftest.py; the
port's in-process mesh holds 8 shards on the CPU. The same numpy inputs
(TPC-H from both generators with one seed, or arrays from one rng) go
through both: every shard must hold exactly the JAX shard's live rows, in
order, with the same table-global metadata; the all_to_all and ring
exchanges must deliver the JAX exchange's live rows; the two distributed
join steps must agree with each other and with pandas."""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from hyrise_tpu.parallel.exchange import (repartition_by_key as jax_repartition,
                                          ring_repartition_by_key as jax_ring)
from hyrise_tpu.parallel.mesh import SHARD_AXIS as JAX_AXIS, make_mesh as jax_make_mesh
from hyrise_tpu.parallel.partition import hash_partition as jax_hash_partition
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu_torch import native
from hyrise_tpu_torch.parallel import exchange
from hyrise_tpu_torch.parallel.exchange import (broadcast_join_inner, dist_join_aggregate_step,
                                                partition_hash, repartition_by_key,
                                                ring_join_aggregate_step, ring_repartition_by_key)
from hyrise_tpu_torch.parallel.mesh import Mesh, make_mesh
from hyrise_tpu_torch.parallel.partition import ShardedColumn, hash_partition
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)

N = 8
SF = 0.01
_state = {}


def _tpch():
    if not _state:
        _state["jax"] = jax_generate_tables(SF)
        _state["port"] = generate_tables(SF, device="cpu")
    return _state["jax"], _state["port"]


def test_make_mesh_on_the_cpu():
    mesh = make_mesh(N, device="cpu")
    assert mesh.n_shards == N and mesh.local_shards == list(range(N))
    assert mesh.devices == [torch.device("cpu")] * N and mesh.group is None
    assert make_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert make_mesh(2).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_mesh(2)


def test_sharded_column_mirrors_every_column_field():
    """tests/test_dist_compiler.py::test_sharded_column_metadata_parity for
    the port: every public field of Column exists on ShardedColumn."""
    public = {s.lstrip("_") for s in Column.__slots__}
    fields = {f.name for f in dataclasses.fields(ShardedColumn)}
    assert public <= fields, sorted(public - fields)


@pytest.mark.parametrize("name,key", [("lineitem", "l_orderkey"), ("orders", "o_orderkey"),
                                      ("customer", "c_custkey"), ("part", "p_partkey"),
                                      ("partsupp", "ps_partkey"), ("lineitem", "l_partkey")])
def test_hash_partition_equals_the_jax_shards(name, key):
    jt, pt = (tables[name] for tables in _tpch())
    jst = jax_hash_partition(jt, key, jax_make_mesh(N))
    st = hash_partition(pt, key, make_mesh(N, device="cpu"))
    counts = np.asarray(jst.counts)
    np.testing.assert_array_equal(st.counts, counts)
    assert st.num_rows == pt.num_rows and st.n_shards == N
    for c in pt.columns:
        jc, sc = jst.column(c.name), st.column(c.name)
        data = np.asarray(jc.data)
        for s in range(N):
            np.testing.assert_array_equal(sc.data[s].numpy(), data[s, :counts[s]])
            assert sc.capacity[s] == counts[s]
        # table-global metadata on every shard, as the JAX ShardedColumn keeps
        assert sc.unique == jc.unique and sc.val_range == jc.val_range
        assert (sc.dictionary is None) == (jc.dictionary is None)
        if sc.dictionary is not None:
            np.testing.assert_array_equal(sc.dictionary, jc.dictionary)
            assert all(t.column(c.name).dictionary is c.dictionary for t in st.shards)
    # each shard holds exactly the rows its hash names
    for s, t in enumerate(st.shards):
        assert (partition_hash(t.column(key).data, N) == s).all()


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_partition_hash_equals_the_native_placement(n_shards):
    info = np.iinfo(np.int64)
    keys = np.concatenate([
        np.array([0, 1, -1, info.min, info.max, info.min + 1, info.max - 1], dtype=np.int64),
        np.random.default_rng(n_shards).integers(info.min, info.max, 100_000, dtype=np.int64)])
    got = partition_hash(torch.from_numpy(keys), n_shards)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), native.hash_partition(keys, n_shards))
    np.testing.assert_array_equal(partition_hash(torch.from_numpy(keys[:50].astype(np.int32)),
                                                 n_shards).numpy(),
                                  native.hash_partition(keys[:50].astype(np.int32), n_shards))


def _exchange_inputs(seed, cap=64):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 200, size=(N, cap)).astype(np.int64)
    val = (rng.random((N, cap)) * 100).astype(np.float32)
    aux = rng.integers(0, 1 << 30, size=(N, cap)).astype(np.int32)
    valid = rng.random((N, cap)) < 0.8
    valid[3] = False  # one shard sends nothing
    return key, val, aux, valid


def _jax_repartition(fn, key, val, aux, valid):
    def local(k, v, a, m):
        k, v, a, m = (x.reshape(x.shape[-1]) for x in (k, v, a, m))
        recv, recv_key, recv_valid = fn((v, a), k, m, N)
        return recv[0], recv[1], recv_key, recv_valid

    spec = P(JAX_AXIS)
    prog = shard_map(local, mesh=jax_make_mesh(N), in_specs=(spec,) * 4,
                     out_specs=(spec,) * 4, check_vma=False)
    out = [np.asarray(x).reshape(N, -1) for x in jax.jit(prog)(key, val, aux, valid)]
    return [(v[m], a[m], k[m]) for v, a, k, m in zip(*out)]


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("form", ["all_to_all", "ring"])
def test_repartition_delivers_the_jax_live_rows(seed, form):
    key, val, aux, valid = _exchange_inputs(seed)
    want = _jax_repartition(jax_repartition if form == "all_to_all" else jax_ring,
                            key, val, aux, valid)
    mesh = make_mesh(N, device="cpu")
    args = ([(torch.from_numpy(val[s]), torch.from_numpy(aux[s])) for s in range(N)],
            [torch.from_numpy(key[s]) for s in range(N)],
            [torch.from_numpy(valid[s]) for s in range(N)])
    got = repartition_by_key(mesh, *args) if form == "all_to_all" else \
        ring_repartition_by_key(mesh, *args)
    for s, (((v, a), k), (wv, wa, wk)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(k.numpy(), wk)
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(a.numpy(), wa)
        assert (partition_hash(k, N) == s).all()


def test_repartition_with_a_target_override_and_no_rows():
    mesh = make_mesh(4, device="cpu")
    keys = [torch.arange(10, dtype=torch.int64) + 10 * s for s in range(4)]
    target = [torch.full((10,), 2, dtype=torch.int64) for _ in range(4)]
    valid = [torch.ones(10, dtype=torch.bool) for _ in range(4)]
    out = repartition_by_key(mesh, [() for _ in range(4)], keys, valid, target=target)
    assert [k.shape[0] for _, k in out] == [0, 0, 40, 0]
    assert out[2][1].tolist() == list(range(40))
    empty = repartition_by_key(mesh, [() for _ in range(4)], [k[:0] for k in keys],
                               [v[:0] for v in valid], exchange="ring")
    assert all(k.shape[0] == 0 for _, k in empty)
    with pytest.raises(ValueError):
        exchange.check_exchange("broadcast")


def _join_inputs():
    rng = np.random.default_rng(7)
    n_orders, n_li = 800, 3000
    orders = pd.DataFrame({"o_orderkey": np.arange(1, n_orders + 1, dtype=np.int32)})
    li = pd.DataFrame({
        "l_orderkey": rng.integers(1, n_orders * 2, size=n_li).astype(np.int32),
        "l_price": rng.random(n_li).astype(np.float32) * 1000,
        "l_discount": (rng.integers(0, 11, size=n_li) / 100).astype(np.float32)})
    return orders, li


def _port_table(name, df):
    kinds = {np.dtype(np.int32): DataType.INT32, np.dtype(np.int64): DataType.INT64,
             np.dtype(np.float32): DataType.FLOAT32, np.dtype(np.float64): DataType.FLOAT64}
    defs = [TableColumnDefinition(c, kinds[df[c].dtype]) for c in df.columns]
    return Table.from_arrays(name, defs, [df[c].to_numpy() for c in df.columns], device="cpu")


def test_dist_join_aggregate_steps_agree_with_each_other_and_pandas():
    orders, li = _join_inputs()
    mesh = make_mesh(N, device="cpu")
    so = hash_partition(_port_table("orders", orders), "o_orderkey", mesh)
    sl = hash_partition(_port_table("lineitem", li), "l_orderkey", mesh)

    def args(st_l, st_o):
        return ([t.column("l_orderkey").data for t in st_l.shards],
                [t.column("l_price").data for t in st_l.shards],
                [t.column("l_discount").data for t in st_l.shards],
                [torch.ones(t.num_rows, dtype=torch.bool) for t in st_l.shards],
                [t.column("o_orderkey").data for t in st_o.shards],
                [torch.ones(t.num_rows, dtype=torch.bool) for t in st_o.shards])

    merged = li.merge(orders, left_on="l_orderkey", right_on="o_orderkey")
    expected = float((merged["l_price"].astype(np.float64)
                      * (1 - merged["l_discount"].astype(np.float64))).sum())
    results = [dist_join_aggregate_step(mesh)(*args(sl, so)),
               dist_join_aggregate_step(mesh, exchange="ring")(*args(sl, so)),
               ring_join_aggregate_step(mesh)(*args(sl, so))]
    for revenue, matches in results:
        assert int(matches) == len(merged)
        assert abs(float(revenue) - expected) / expected < 1e-9
    assert float(results[0][0]) == float(results[1][0])


def test_collectives_in_one_process():
    mesh = Mesh([torch.device("cpu")] * 3)
    vals = [torch.tensor([1.0, 2.0]) * (s + 1) for s in range(3)]
    assert all(torch.equal(t, torch.tensor([6.0, 12.0])) for t in exchange.psum(mesh, vals))
    gathered = exchange.all_gather(mesh, [[torch.arange(s)] for s in range(3)])
    assert all(g[0].tolist() == [0, 0, 1] for g in gathered)
    got = exchange.ppermute(mesh, [[torch.tensor([s])] for s in range(3)], [(0, 1), (1, 2)])
    assert got[0] is None and got[1][0].tolist() == [0] and got[2][0].tolist() == [1]
    assert exchange.all_max(mesh, [3, 9, 2]) == 9


def test_broadcast_join_inner_pairs_each_probe_row_with_the_whole_build_side():
    mesh = make_mesh(4, device="cpu")
    rng = np.random.default_rng(3)
    lk = [torch.from_numpy(rng.integers(0, 30, 50)) for _ in range(4)]
    lv = [torch.from_numpy(rng.random(50) < 0.9) for _ in range(4)]
    rk = [torch.from_numpy(rng.integers(0, 30, n)) for n in (0, 7, 20, 13)]  # one shard empty
    rv = [None, torch.from_numpy(rng.random(7) < 0.5), None, None]
    whole_k = torch.cat(rk).numpy()
    whole_v = np.concatenate([np.ones(len(k), bool) if v is None else v.numpy()
                              for k, v in zip(rk, rv)])
    for s, (probe, build) in enumerate(broadcast_join_inner(mesh, lk, lv, rk, rv)):
        want = sorted((i, j) for i in range(50) for j in range(len(whole_k))
                      if lv[s][i] and whole_v[j] and lk[s][i] == whole_k[j])
        assert sorted(zip(probe.tolist(), build.tolist())) == want
