"""Hand-written distributed TPC-H pipelines over hash-partitioned tables.

Port of hyrise_tpu/parallel/dist_query.py. Each shard runs the port's
kernels on its own rows and the collectives of parallel/exchange.py
combine them:

- `dist_q6`: K1 (`q6_scan`) on every shard, psum.
- `dist_q1`: the returnflag x linestatus cells of every shard through one
  K3 launch (`segment_reduce_cells_many`), psum over the cells.
- `dist_aggregate_sum_by_key`: two-phase SUM by a high-cardinality key;
  each phase sorts and runs K7's segment sums (`_local_sum_by_key`), with
  an all_to_all of the partials between them, so a hot key sends at most
  one partial per shard.
- `dist_q3_step`: customer join orders (co-partitioned) join lineitem
  (shuffled by l_orderkey), revenue summed, psum.

Every function takes ShardedTables or per-shard lists and returns the
combined answer on this process's first shard device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hyrise_tpu_torch.kernels.group_reduce import segment_reduce_cells_many
from hyrise_tpu_torch.kernels.prims import compact_indices
from hyrise_tpu_torch.kernels.q6 import q6_scan
from hyrise_tpu_torch.kernels.segment_reduce import segment_reduce_sorted
from hyrise_tpu_torch.parallel.exchange import (local_join_inner, psum,
                                                repartition_by_key)
from hyrise_tpu_torch.parallel.mesh import Mesh
from hyrise_tpu_torch.parallel.partition import ShardedTable


def dist_q6(mesh: Mesh, lineitem: ShardedTable, date_lo: int, date_hi: int) -> torch.Tensor:
    """Distributed TPC-H Q6: K1 over every shard, psum (float64)."""
    partials = []
    for t in lineitem.shards:
        live = torch.ones(t.num_rows, dtype=torch.bool, device=t.device)
        partials.append(q6_scan(t.column("l_shipdate").data, t.column("l_discount").data,
                                t.column("l_quantity").data, t.column("l_extendedprice").data,
                                live, date_lo, date_hi))
    return psum(mesh, partials)[0]


def dist_q1(mesh: Mesh, lineitem: ShardedTable, date_hi_code: int):
    """Distributed TPC-H Q1: per shard, the rows with l_shipdate <=
    date_hi_code reduced into returnflag x linestatus cells by one K3
    launch, then psum. Returns dense per-cell tensors (n_rf * n_ls): counts, sum_qty,
    sum_base, sum_disc_price, sum_charge, sum_disc."""
    n_ls = len(lineitem.shards[0].column("l_linestatus").dictionary)
    cells = len(lineitem.shards[0].column("l_returnflag").dictionary) * n_ls
    partials: List[Tuple[torch.Tensor, ...]] = []
    for t in lineitem.shards:
        mask = t.column("l_shipdate").data <= date_hi_code
        cell = torch.where(mask, t.column("l_returnflag").data * n_ls
                           + t.column("l_linestatus").data, cells).to(torch.int32)
        f64 = {name: t.column(name).data.to(torch.float64)
               for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
        disc_price = f64["l_extendedprice"] * (1.0 - f64["l_discount"])
        charge = disc_price * (1.0 + f64["l_tax"])
        counts, sums = segment_reduce_cells_many(cell, cells, [
            (v, None, "sum") for v in (f64["l_quantity"], f64["l_extendedprice"],
                                       disc_price, charge, f64["l_discount"])])
        partials.append((counts, *(s for s, _ in sums)))
    return tuple(psum(mesh, [p[k] for p in partials])[0] for k in range(6))


def _local_sum_by_key(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor):
    """One shard's SUM by key: the valid rows sorted by key (stable), the
    group starts compacted (K9), the sums over the sorted segments (K7,
    through the permutation). Returns (keys, sums), one entry per group, in
    key order."""
    rows = compact_indices(valid)
    k = keys.index_select(0, rows)
    sorted_k, perm = torch.sort(k, stable=True)
    n = sorted_k.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = sorted_k[1:] != sorted_k[:-1]
    first = compact_indices(new)
    starts = torch.cat([first, torch.tensor([n], dtype=torch.int64, device=keys.device)])
    sums, _ = segment_reduce_sorted(values, starts, "sum", rows=rows.index_select(0, perm))
    return sorted_k.index_select(0, first), sums


def dist_aggregate_sum_by_key(mesh: Mesh, exchange: str = "all_to_all"):
    """Two-phase distributed SUM by a high-cardinality key: local partials,
    an all_to_all of the partials by key hash, the final combine. Returns
    fn(keys, values, valid) over per-shard lists -> per local shard (keys,
    sums) of the keys that shard owns by hash."""

    def run(keys, values, valid):
        partials = [_local_sum_by_key(k, v, m) for k, v, m in zip(keys, values, valid)]
        recv = repartition_by_key(
            mesh, [(s,) for _, s in partials], [k for k, _ in partials],
            [torch.ones(k.shape[0], dtype=torch.bool, device=k.device) for k, _ in partials],
            exchange=exchange)
        return [_local_sum_by_key(k, s, torch.ones(k.shape[0], dtype=torch.bool,
                                                   device=k.device))
                for (s,), k in recv]

    return run


def dist_q3_step(mesh: Mesh, customer: ShardedTable, orders: ShardedTable,
                 lineitem: ShardedTable, segment_code: int, date_lo_code: int,
                 exchange: str = "all_to_all"):
    """Distributed Q3 core: customer (c_mktsegment = segment) join orders
    (o_orderdate < date) join lineitem (l_shipdate > date) ->
    SUM(revenue). Partitioning contract: customer by c_custkey, orders by
    o_custkey (co-partitioned with customer), lineitem by anything: the
    surviving orders and lineitem are both shuffled by orderkey. Returns
    (revenue float64, matches int64)."""
    o_keys, o_live, l_cols, l_keys, l_valid = [], [], [], [], []
    for c, o, li in zip(customer.shards, orders.shards, lineitem.shards):
        c_valid = c.column("c_mktsegment").data == segment_code
        o_valid = o.column("o_orderdate").data < date_lo_code
        o_idx, _ = local_join_inner(o.column("o_custkey").data, o_valid,
                                    c.column("c_custkey").data, c_valid)
        sel = o.column("o_orderkey").data.index_select(0, o_idx)
        o_keys.append(sel)
        o_live.append(torch.ones(sel.shape[0], dtype=torch.bool, device=sel.device))
        l_cols.append((li.column("l_extendedprice").data, li.column("l_discount").data))
        l_keys.append(li.column("l_orderkey").data)
        l_valid.append(li.column("l_shipdate").data > date_lo_code)
    o_recv = repartition_by_key(mesh, [() for _ in o_keys], o_keys, o_live, exchange=exchange)
    l_recv = repartition_by_key(mesh, l_cols, l_keys, l_valid, exchange=exchange)
    revs, matches = [], []
    for (_, ok), ((price, disc), lk) in zip(o_recv, l_recv):
        li_idx, _ = local_join_inner(lk, None, ok, None)
        revs.append((price.index_select(0, li_idx).to(torch.float64)
                     * (1.0 - disc.index_select(0, li_idx).to(torch.float64))).sum())
        matches.append(torch.tensor(li_idx.shape[0], dtype=torch.int64, device=lk.device))
    return psum(mesh, revs)[0], psum(mesh, matches)[0]
