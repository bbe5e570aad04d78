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

Capacity forms (ROADMAP B1), for plan/compiler.py's capacity mode, where a
CUDA graph fixes every size and nothing may read the device: `shuffle_cap`
and `gather_cap` move columns at their capacities, and every count stays on
the device. In one process a shuffle concatenates the shards' columns and
targets and compacts each destination's rows out of them with one K9c call
(oracle_compact; dead rows target `n_shards`), so destination j gets shard
0's rows first, each source's in order: the eager order. Over a process
group each rank compacts its rows for every destination into an
`[n_shards, width]` send buffer (the JAX package's `[n_shards, cap]`), sends
it with equal splits and the counts as a tensor (all_to_all_single, or the
ring's fixed-size hops), and compacts the received dead rows away (K9c);
`all_gather` moves fixed-size buffers. The widths are oracle capacities,
which every rank learns alike (parallel/dist_compiler.py), so no size is
exchanged on the host.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.native import HASH_MULT
from hyrise_tpu_torch.parallel.mesh import Mesh
from hyrise_tpu_torch.plan.compiler import oracle_compact, tracing

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
    each source's rows in their order. In capacity mode, per local shard
    (received columns, received keys, their count on the device), the
    columns at the site's capacity (shuffle_cap)."""
    n = mesh.n_shards
    if tracing():
        tgt = [torch.where(valid[i], (partition_hash(key[i], n) if target is None
                                      else target[i]).to(torch.int64), n)
               for i in range(len(mesh.local_shards))]
        got = shuffle_cap(mesh, [[*arrays[i], key[i]] for i in range(len(tgt))], tgt,
                          "exchange.repartition", exchange)
        return [(tuple(cols[:-1]), cols[-1], count) for cols, count in got]
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
# capacity forms


def _row_offsets(width: int, counts: torch.Tensor) -> torch.Tensor:
    """The live mask of len(counts) buckets of `width` rows, each holding
    counts[s] rows first."""
    pos = torch.arange(width, device=counts.device).repeat(counts.shape[0])
    return pos < counts.repeat_interleave(width)


def _send_buffer(arrays, target: torch.Tensor, n: int, label: str, estimate: int):
    """One rank's rows by destination at one width: (each array as
    [n_shards * width], rows per destination on the device). Destination
    d's rows are compacted (K9c) at its own site; the width is the largest
    site's capacity, which every rank has alike."""
    picks, counts = [], []
    for d in range(n):
        idx, count = oracle_compact(target == d, label, estimate)
        picks.append(idx)
        counts.append(count)
    width = max(p.shape[0] for p in picks)
    order = torch.cat([torch.nn.functional.pad(p, (0, width - p.shape[0])) for p in picks])
    return [a.index_select(0, order) for a in arrays], torch.stack(counts), width


def _exchange_cap(mesh: Mesh, arrays, counts: torch.Tensor, width: int, exchange: str):
    """The send buffer through the group: (what every source sent this rank,
    as [n_shards * width] in source order, the source's counts). all_to_all
    takes equal splits; the ring sends hop k's bucket to the shard k ahead
    and receives from the shard k behind, all at `width` rows."""
    import torch.distributed as dist

    n, me = mesh.n_shards, mesh.local_shards[0]
    if exchange == "all_to_all":
        got_counts = torch.empty_like(counts)
        dist.all_to_all_single(got_counts, counts, group=mesh.group)
        out = []
        for a in arrays:
            x = _wire(a)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x, group=mesh.group)
            out.append(_unwire(y, a))
        return out, got_counts

    def bucket(t, d):
        return t.reshape(n, -1)[d]

    got = [[None] * n for _ in range(len(arrays) + 1)]
    tensors = [*arrays, counts]
    for k in range(n):
        src = (me - k) % n
        for i, t in enumerate(tensors):
            send = _wire(bucket(t, (me + k) % n)).contiguous()
            if k == 0:
                got[i][src] = send
                continue
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, (me + k) % n, group=mesh.group),
                   dist.P2POp(dist.irecv, recv, src, group=mesh.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            got[i][src] = recv
    out = [_unwire(torch.cat(parts), a) for parts, a in zip(got, arrays)]
    return out, torch.cat(got[-1])


def shuffle_cap(mesh: Mesh, arrays, target, label: str, exchange: str = "all_to_all",
                estimate: Optional[int] = None):
    """Capacity form of the shuffle. arrays[i]: equally long columns of
    local shard i (any capacity), target[i]: each row's destination
    (n_shards or more: not sent). Returns per local shard (the columns it
    received at the site's capacity, their count on the device): the rows
    of shard 0 first, each source's in order. `estimate` sizes a first
    run's sites (default: the largest shard's length)."""
    check_exchange(exchange)
    n = mesh.n_shards
    if estimate is None:
        estimate = max(int(t.shape[0]) for t in target)
    if mesh.group is None:
        whole = [torch.cat([a[c] for a in arrays]) for c in range(len(arrays[0]))]
        tgt = torch.cat(list(target))
        out = []
        for j in range(n):
            idx, count = oracle_compact(tgt == j, label, estimate)
            out.append(([c.index_select(0, idx) for c in whole], count))
        return out
    (cols,), (tgt,) = arrays, target
    sent, counts, width = _send_buffer(cols, tgt, n, label + ".send", max(estimate // n, 1))
    got, got_counts = _exchange_cap(mesh, sent, counts, width, exchange)
    idx, count = oracle_compact(_row_offsets(width, got_counts), label, estimate)
    return [([c.index_select(0, idx) for c in got], count)]


def gather_cap(mesh: Mesh, arrays) -> List[List[torch.Tensor]]:
    """Capacity form of all_gather: arrays[i], the columns of local shard i
    (one length on every shard: over a group a capacity every rank has
    alike). Returns, on every local shard's device, each column's
    concatenation over all shards in shard order, dead rows included."""
    if mesh.group is None:
        return all_gather(mesh, arrays)
    import torch.distributed as dist

    (mine,) = arrays
    out = []
    for like in mine:
        x = _wire(like).contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.n_shards)]
        dist.all_gather(parts, x, group=mesh.group)
        out.append(_unwire(torch.cat(parts), like))
    return [out]


# ---------------------------------------------------------------------------
# local joins


def local_join_inner(lk: torch.Tensor, l_valid: Optional[torch.Tensor], rk: torch.Tensor,
                     r_valid: Optional[torch.Tensor]):
    """(probe rows, build rows) of every pair lk[i] == rk[j] with both
    valid, through the port's Join operator (INNER: its sorted-range path,
    K5, or its lookup path, K4/K8, where the build keys are unique), in its
    order: probe-major, the build rows of a probe row by (key, row). In
    capacity mode (probe rows, build rows, the pairs' count on the device),
    the rows at the Join's capacity: K5c writes the pairs (the JAX form's
    `out_cap`)."""
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
    pairs = out.column("probe_row").data, out.column("build_row").data
    return (*pairs, out.num_rows) if tracing() else pairs


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
    -> (revenue float64, matches int64). In capacity mode the shuffle and
    the join keep their counts on the device, and the rows past them count
    for nothing."""

    def step(l_ok, l_price, l_disc, l_valid, o_ok, o_valid):
        recv = repartition_by_key(mesh, [(p, d) for p, d in zip(l_price, l_disc)], l_ok,
                                  l_valid, exchange=exchange)
        revs, matches = [], []
        for i, got in enumerate(recv):
            (price, disc), key = got[:2]
            if not tracing():
                li, _ = local_join_inner(key, None, o_ok[i], o_valid[i])
                revs.append(_revenue(price.index_select(0, li), disc.index_select(0, li)))
                matches.append(torch.tensor(li.shape[0], dtype=torch.int64, device=key.device))
                continue
            live = torch.arange(key.shape[0], device=key.device) < got[2]
            li, _, n = local_join_inner(key, live, o_ok[i], o_valid[i])
            paired = torch.arange(li.shape[0], device=li.device) < n
            revs.append(_revenue(price.index_select(0, li),
                                 torch.where(paired, disc.index_select(0, li), 1.0)))
            matches.append(n.to(torch.int64))
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
