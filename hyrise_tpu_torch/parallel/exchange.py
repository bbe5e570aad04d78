"""Collective exchanges between shards.

Port of hyrise_tpu/parallel/exchange.py (the reference has no distributed
backend, SURVEY.md section 2.3). The JAX functions run inside `shard_map`
on `[n_shards, cap]` arrays; here every function takes, for each argument,
the list of this process's per-shard tensors (Mesh.local_shards order) and
returns such a list.

The collectives:

- `all_to_all`, `psum`, `all_gather`, `ppermute`. In one process they
  regroup the lists, with `.to(device)` where shards sit on different
  cards. Over a process group they call `all_to_all_single` with the
  exchanged split sizes, `all_reduce`, `all_gather` and
  `batch_isend_irecv`. Sizes are exact: the send counts go first as one
  `[n_shards]` int64 tensor, then each column with its splits; there is no
  capacity padding. bool tensors travel as uint8.
- `psum` folds the partials in shard order in one process, and in the
  group backend's own order across ranks: floats agree within the 1e-6
  relative policy (ARCHITECTURE.md, "Float policy across execution forms").

On them: `partition_hash` (equal to native.hash_partition), the send
buckets, `repartition_by_key` and its ring form, the local and broadcast
joins, and the distributed steps of the JAX file. The ring form is an
explicit `exchange="ring"` argument where the JAX file reads
HYRISE_TPU_RING_EXCHANGE.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.native import HASH_MULT
from hyrise_tpu_torch.parallel.mesh import Mesh

EXCHANGES = ("all_to_all", "ring")
_MULT_I64 = HASH_MULT - (1 << 64)   # the multiplier's bits as an int64
_LOW_63 = (1 << 63) - 1


def partition_hash(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int32 shard of each key; equals native.hash_partition. torch has no
    uint64 arithmetic on CUDA: the int64 product wraps to the same low 64
    bits as the unsigned one, and masking the sign after the arithmetic
    shift makes it the logical shift."""
    h = key.to(torch.int64) * _MULT_I64
    return (((h >> 1) & _LOW_63) % n_shards).to(torch.int32)


def check_exchange(exchange: str) -> None:
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, got {exchange!r}")


# ---------------------------------------------------------------------------
# collectives


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bool) if like.dtype == torch.bool else t


def all_to_all(mesh: Mesh, sends):
    """sends[i][d]: the columns (a list of equally long tensors, the same
    dtypes everywhere) that local shard i sends to shard d. Returns
    recv[j][s]: the columns local shard j received from shard s."""
    n = mesh.n_shards
    if mesh.group is None:
        return [[[x.to(mesh.devices[j]) for x in sends[s][j]] for s in range(n)]
                for j in range(n)]
    import torch.distributed as dist

    (mine,) = sends
    dev = mesh.devices[0]
    counts = torch.tensor([cols[0].shape[0] for cols in mine], dtype=torch.int64, device=dev)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=mesh.group)
    in_split, out_split = counts.tolist(), recv_counts.tolist()
    received = []
    for c, like in enumerate(mine[0]):
        x = torch.cat([_wire(cols[c]) for cols in mine])
        out = torch.empty(sum(out_split), dtype=x.dtype, device=dev)
        dist.all_to_all_single(out, x, output_split_sizes=out_split,
                               input_split_sizes=in_split, group=mesh.group)
        received.append(_unwire(out, like).split(out_split))
    return [[[col[s] for col in received] for s in range(n)]]


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over all shards of each local shard's tensor (equal shapes),
    on every local shard's device."""
    if mesh.group is None:
        total = values[0]
        for v in values[1:]:
            total = total + v.to(total.device)
        return [total.to(dev) for dev in mesh.devices]
    import torch.distributed as dist

    total = values[0].clone()
    dist.all_reduce(total, group=mesh.group)
    return [total]


def all_max(mesh: Mesh, values: Sequence[int]) -> int:
    """The largest of every shard's host integer (one all_reduce over a
    group): decisions that must agree on every rank read it."""
    if mesh.group is None:
        return max(values)
    import torch.distributed as dist

    t = torch.tensor([max(values)], dtype=torch.int64, device=mesh.devices[0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def all_gather(mesh: Mesh, values):
    """values[i]: the columns (equally long tensors) of local shard i, the
    same number and dtypes on every shard. Returns, on every local shard's
    device, each column's concatenation over all shards in shard order
    (lengths may differ between shards)."""
    if mesh.group is None:
        home = mesh.devices[0]
        whole = [torch.cat([v[c].to(home) for v in values]) for c in range(len(values[0]))]
        return [[x.to(dev) for x in whole] for dev in mesh.devices]
    import torch.distributed as dist

    (mine,) = values
    dev = mesh.devices[0]
    n = mesh.n_shards
    size = torch.tensor([mine[0].shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=mesh.group)
    sizes = [int(s.item()) for s in sizes]
    longest = max(sizes)
    out = []
    for like in mine:
        x = _wire(like)
        padded = torch.zeros(longest, dtype=x.dtype, device=dev)
        padded[:x.shape[0]] = x
        parts = [torch.empty_like(padded) for _ in range(n)]
        dist.all_gather(parts, padded, group=mesh.group)
        out.append(_unwire(torch.cat([p[:k] for p, k in zip(parts, sizes)]), like))
    return [out]


def ppermute(mesh: Mesh, values, perm: Sequence[Tuple[int, int]]):
    """values[i]: the columns of local shard i. Each (src, dst) pair of
    `perm` sends shard src's columns to shard dst. Returns, per local
    shard (in one process: per shard), the columns it received, or None."""
    if mesh.group is None:
        out = [None] * mesh.n_shards
        for src, dst in perm:
            out[dst] = [x.to(mesh.devices[dst]) for x in values[src]]
        return out
    import torch.distributed as dist

    (mine,) = values
    me = mesh.local_shards[0]
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    if dst == me and src == me:
        return [list(mine)]
    dev = mesh.devices[0]

    def exchange(send, recv):
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, dst, group=mesh.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src, group=mesh.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    size = torch.tensor([mine[0].shape[0]], dtype=torch.int64, device=dev)
    got_size = torch.empty_like(size) if src is not None else None
    exchange(size if dst is not None else None, got_size)
    k = int(got_size.item()) if src is not None else 0
    got = []
    for like in mine:
        x = _wire(like).contiguous()
        buf = torch.empty(k, dtype=x.dtype, device=dev) if src is not None else None
        exchange(x if dst is not None else None, buf)
        got.append(None if buf is None else _unwire(buf, like))
    return [got if src is not None else None]


# ---------------------------------------------------------------------------
# send buckets and the repartition


def bucket_order(target: torch.Tensor, n_shards: int):
    """(row order grouped by destination, stable, without the rows whose
    target is n_shards or more; rows per destination as host ints)."""
    tgt = torch.clamp(target.to(torch.int64), max=n_shards)
    counts = torch.bincount(tgt, minlength=n_shards + 1)[:n_shards].tolist()
    order = torch.sort(tgt, stable=True).indices[:sum(counts)]
    return order, counts


def _send_buckets(arrays, key, valid, n_shards: int, target=None):
    """One shard's rows clustered by destination: (buckets[d] = the arrays
    and the key of the rows for shard d, rows per destination). Rows not
    `valid` are dropped. With `key` None, `target` places the rows and only
    the arrays are sent. Shared by every shuffle and both exchanges."""
    if target is None:
        target = partition_hash(key, n_shards)
    target = torch.where(valid, target.to(torch.int64), n_shards)
    order, counts = bucket_order(target, n_shards)
    cols = [a.index_select(0, order) for a in (*arrays, *([] if key is None else [key]))]
    split = [c.split(counts) for c in cols]
    return [[s[d] for s in split] for d in range(n_shards)], counts


def ring_hops(mesh: Mesh, buckets):
    """The ring form, hop by hop: yields (k, got) for k = 0 .. n-1, where
    got[j] is the bucket local shard j received in hop k, from the shard k
    behind it (hop 0: its own bucket, no communication; hop k is one
    ppermute that sends each shard's bucket for the shard k ahead)."""
    n = mesh.n_shards
    local = mesh.local_shards
    yield 0, [buckets[j][me] for j, me in enumerate(local)]
    for k in range(1, n):
        perm = [(i, (i + k) % n) for i in range(n)]
        yield k, ppermute(mesh, [buckets[j][(me + k) % n] for j, me in enumerate(local)], perm)


def exchange_buckets(mesh: Mesh, buckets, exchange: str = "all_to_all"):
    """buckets[i][d]: local shard i's columns for shard d. Returns recv[j][s]:
    what local shard j got from shard s, through one all_to_all or the
    ring's n-1 ppermute hops (the same result)."""
    check_exchange(exchange)
    n = mesh.n_shards
    if exchange == "all_to_all" or n == 1:
        return all_to_all(mesh, buckets)
    recv = [[None] * n for _ in mesh.local_shards]
    for k, got in ring_hops(mesh, buckets):
        for j, me in enumerate(mesh.local_shards):
            recv[j][(me - k) % n] = got[j]
    return recv


def repartition_by_key(mesh: Mesh, arrays, key, valid, target=None,
                       exchange: str = "all_to_all"):
    """Shuffle each local shard's valid rows to the shard owning
    hash(key), or `target` where given (skew-aware routing). arrays[i]: a
    tuple of columns of local shard i; key[i], valid[i] (bool), target[i]
    its rows' keys, validity and optional destinations. Returns, per local
    shard, (received columns, received keys): the rows from shard 0 first,
    each source's rows in their order."""
    n = mesh.n_shards
    buckets = []
    for i in range(len(mesh.local_shards)):
        b, _ = _send_buckets(arrays[i], key[i], valid[i], n,
                             None if target is None else target[i])
        buckets.append(b)
    recv = exchange_buckets(mesh, buckets, exchange)
    out = []
    for j, parts in enumerate(recv):
        cols = [torch.cat([p[c] for p in parts]) for c in range(len(parts[0]))]
        out.append((tuple(cols[:-1]), cols[-1]))
    return out


def ring_repartition_by_key(mesh: Mesh, arrays, key, valid, target=None):
    """repartition_by_key as the ring of ppermute hops: the same result."""
    return repartition_by_key(mesh, arrays, key, valid, target, exchange="ring")


# ---------------------------------------------------------------------------
# local joins


def local_join_inner(lk: torch.Tensor, l_valid: Optional[torch.Tensor], rk: torch.Tensor,
                     r_valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probe rows, build rows) of every pair lk[i] == rk[j] with both
    valid, through the port's Join operator (INNER: its sorted-range path,
    K5, or its lookup path, K4/K8, where the build keys are unique), in its
    order: probe-major, the build rows of a probe row by (key, row)."""
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.ops.get_table import TableWrapper
    from hyrise_tpu_torch.ops.join import Join
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    from hyrise_tpu_torch.types import DataType, JoinMode

    def side(keys, valid, row_name):
        dt = next(d for d in DataType if d is not DataType.STRING and d.torch_dtype == keys.dtype)
        rows = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
        return TableWrapper(Table([Column("key", dt, keys, valid),
                                   Column(row_name, DataType.INT64, rows)], keys.shape[0]))

    out = execute_plan(Join(side(lk, l_valid, "probe_row"), side(rk, r_valid, "build_row"),
                            JoinMode.INNER, ("key", "key")))
    if out.live is not None:
        from hyrise_tpu_torch.ops.materialize import ensure_prefix
        out = ensure_prefix(out)
    return out.column("probe_row").data, out.column("build_row").data


def broadcast_join_inner(mesh: Mesh, lk, l_valid, rk_local, r_valid_local):
    """Broadcast join: every shard gets the whole build side (all_gather)
    and joins its own probe rows locally, with no exchange of the probe
    side (the distributed form of the reference's build-side swap,
    join_hash.cpp:55-76). Per local shard: (probe rows, rows of the
    gathered build side)."""
    cols = [[k, torch.ones(k.shape[0], dtype=torch.bool, device=k.device) if v is None else v]
            for k, v in zip(rk_local, r_valid_local)]
    return [local_join_inner(lk[i], l_valid[i], rk, rv)
            for i, (rk, rv) in enumerate(all_gather(mesh, cols))]


# ---------------------------------------------------------------------------
# distributed pipelines


def dist_filter_aggregate(mesh: Mesh, compute_local: Callable):
    """compute_local(*one shard's arrays) -> a tensor or a tuple of tensors
    of partials; returns fn(*per-shard lists) -> their psum over all shards
    (distributed Q1 / Q6)."""

    def run(*args):
        partials = [compute_local(*(a[i] for a in args)) for i in range(len(mesh.local_shards))]
        if isinstance(partials[0], torch.Tensor):
            return psum(mesh, partials)[0]
        return tuple(psum(mesh, [p[k] for p in partials])[0] for k in range(len(partials[0])))

    return run


def _revenue(price: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
    return (price.to(torch.float64) * (1.0 - disc.to(torch.float64))).sum()


def dist_join_aggregate_step(mesh: Mesh, exchange: str = "all_to_all"):
    """The distributed step lineitem (sharded anyhow) join orders (sharded by
    o_orderkey) -> SUM(l_extendedprice * (1 - l_discount)): shuffle lineitem
    by l_orderkey, join each shard locally, sum, psum. Returns fn(l_orderkey,
    l_price, l_discount, l_valid, o_orderkey, o_valid) over per-shard lists
    -> (revenue float64, matches int64)."""

    def step(l_ok, l_price, l_disc, l_valid, o_ok, o_valid):
        recv = repartition_by_key(mesh, [(p, d) for p, d in zip(l_price, l_disc)], l_ok,
                                  l_valid, exchange=exchange)
        revs, matches = [], []
        for i, ((price, disc), key) in enumerate(recv):
            li, _ = local_join_inner(key, None, o_ok[i], o_valid[i])
            revs.append(_revenue(price.index_select(0, li), disc.index_select(0, li)))
            matches.append(torch.tensor(li.shape[0], dtype=torch.int64, device=key.device))
        return psum(mesh, revs)[0], psum(mesh, matches)[0]

    return step


def ring_join_aggregate_step(mesh: Mesh):
    """dist_join_aggregate_step with the shuffle overlapped by the probe:
    orders' keys are sorted once per shard, then each hop of the ring
    delivers one source shard's lineitem rows, which are probed and reduced
    at once (the JAX form's overlap schedule; eager torch runs the hops in
    order). One partial per source shard, folded in hop order, then psum."""
    from hyrise_tpu_torch.kernels.prims import ranks_lo_hi

    def step(l_ok, l_price, l_disc, l_valid, o_ok, o_valid):
        n = mesh.n_shards
        local = mesh.local_shards
        builds, buckets = [], []
        for i in range(len(local)):
            keys = o_ok[i].to(torch.int64)
            keys = keys if o_valid[i] is None else keys[o_valid[i]]
            builds.append(torch.sort(keys).values)
            b, _ = _send_buckets((l_price[i], l_disc[i]), l_ok[i], l_valid[i], n)
            buckets.append(b)
        rev = [torch.zeros((), dtype=torch.float64, device=d) for d in mesh.devices]
        matches = [torch.zeros((), dtype=torch.int64, device=d) for d in mesh.devices]
        for _, got in ring_hops(mesh, buckets):
            for j, (price, disc, key) in enumerate(got):
                lo, hi = ranks_lo_hi(builds[j], key.to(torch.int64))
                m = (hi - lo).to(torch.int64)
                rev[j] = rev[j] + (price.to(torch.float64) * (1.0 - disc.to(torch.float64))
                                   * m).sum()
                matches[j] = matches[j] + m.sum()
        return psum(mesh, rev)[0], psum(mesh, matches)[0]

    return step
