"""Distributed execution of any operator plan over sharded tables.

Port of hyrise_tpu/parallel/dist_compiler.py. The JAX file compiles a plan
into one `shard_map` program. Here two forms share one executor:
`DistributedQuery` runs it eagerly, with exact sizes read on the host, and
`DistributedCompiledQuery` (the JAX name) runs it in plan/compiler.py's
capacity mode, every shard and exchange in one CUDA graph on the card. The
design is the JAX package's placement-typed execution
(dist_compiler.py:11-42). Every intermediate carries a Placement:

- REPLICATED: every shard holds the whole table. This process keeps one
  copy on its first shard's device and runs an operator over it once.
- SHARDED(key): each row lives on exactly one shard; with `key` a column
  name, on shard partition_hash(row[key]) % n_shards.

Each shard runs the port's own single-card operators on its rows
(`_run_local`), and placement rules insert the exchanges:

- TableScan, Validate and Alias keep the placement, and a Projection where
  it forwards the key column unchanged (the JAX rule keeps it for any
  column of the key's name, ROADMAP C25).
- Equi joins are decided once per join and kept: co-partitioned (local),
  broadcast of a small build side (all_gather), a shuffle of the sides not
  placed by the join key (all_to_all or the ppermute ring), with hot probe
  keys spread round-robin and their build rows on every shard
  (parallel/skew.py), or JoinMPSM's value-range clustering. NOT IN
  (ANTI_NULL_AS_TRUE) decides on its whole build side, so that side is
  always gathered (ROADMAP C26). Both sides replicated, or a join no rule
  distributes, run replicated.
- Aggregates grouped by the partition key run per shard; decomposable ones
  (SUM, COUNT, MIN, MAX, AVG) run two-phase: per-shard partials, a gather,
  the combine; anything else gathers its input.
- A Sort consumed only by Limits sorts per shard, and each Limit gathers K
  rows a shard (distributed top K). Every other operator (Sort, Limit, set
  operations, non-equi joins) gathers its inputs and runs replicated.

Both forms keep the per-shard rows of every operator's output (`op_rows`)
and of every exchange site (`exchange_stats()`, with the JAX labels); in
capacity mode those counts stay on the device until the run's one host
read. The exchange helpers below branch on plan/compiler.py's `tracing()`:
eagerly they move exact row sets, in capacity mode the capacity forms of
parallel/exchange.py move buffers at their capacities and compact the live
rows with K9c (oracle_compact), one site per exchange and shard.

Decisions that depend on sizes or distributions read only global
quantities (catalog metadata, or a count or sample reduced over every
shard first), so every rank of a process group takes the same branch and
the collectives meet. Where the JAX code reads a traced capacity, this
reads bucket_capacity of the largest shard's rows; the compiled form takes
its decisions from one eager run and only reads them in capacity mode.

Dictionaries: shards rewrite dictionaries on their own (SUBSTR, LIKE), so
the parts of a gathered or received table may hold equal dictionaries in
different objects: they are merged by content (`concat_tables`). Over a
process group each rank decodes received codes with its own dictionaries,
which every rank derives alike from the same table-global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.expression.ast import AggregateExpr, ColumnRef
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper, _capacity_source
from hyrise_tpu_torch.ops.join import Join, JoinMPSM, _key_space, _keys_in
from hyrise_tpu_torch.ops.materialize import ensure_prefix, filter_table, gather_table
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.parallel.exchange import (_send_buckets, all_gather, all_max,
                                                check_exchange, exchange_buckets, gather_cap,
                                                partition_hash, shuffle_cap)
from hyrise_tpu_torch.parallel.mesh import Mesh
from hyrise_tpu_torch.parallel.partition import ShardedTable, hash_partition
from hyrise_tpu_torch.plan.blocked import PlanNotCompilable, _walk
from hyrise_tpu_torch.plan.compiler import (CompiledQuery, active, device_constant,
                                            oracle_compact, tracing)
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import (EXISTENCE_MODES, AggregateFunction, DataType,
                                    JoinMode, PredicateCondition)


@dataclasses.dataclass(frozen=True)
class Placement:
    replicated: bool
    key: Optional[str] = None  # the column the rows are hash-partitioned by


REPLICATED = Placement(True)


def bucket_capacity(n: int) -> int:
    """The JAX package's capacity of n rows: the smallest power of two >= n
    and >= 1024 (hyrise_tpu/types.py)."""
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


# ---------------------------------------------------------------------------
# sharded catalog


class ShardedCatalog:
    """name -> ShardedTable (hash-partitioned) or Table (replicated, kept on
    the mesh's first device). The entries are copies: `source` is the
    Catalog they were taken from, at its `version` (None where the caller
    placed tables itself)."""

    def __init__(self, mesh: Mesh, source=None):
        self.mesh = mesh
        self.entries: Dict[str, object] = {}
        self.source = source
        self.version = None if source is None else source.version

    def is_current(self, catalog) -> bool:
        """Whether the entries are copies of `catalog` as it is now: no
        table was written, added or dropped since they were taken."""
        return self.source is catalog and self.version == catalog.version

    def add_sharded(self, name: str, table: Table, key: str) -> ShardedTable:
        st = hash_partition(table, key, self.mesh)
        st.name = name
        self.entries[name] = st
        return st

    def add_replicated(self, name: str, table: Table) -> Table:
        table = _on(table, self.mesh.home)
        self.entries[name] = table
        return table

    def get(self, name: str):
        return self.entries[name]

    def table_names(self) -> List[str]:
        return sorted(self.entries)


# TPC-H partitioning contract: the big tables by their primary join key,
# the small dimensions replicated
TPCH_PARTITION_KEYS = {
    "lineitem": "l_orderkey",
    "orders": "o_orderkey",
    "customer": "c_custkey",
    "part": "p_partkey",
    "partsupp": "ps_partkey",
}


def shard_tpch(catalog, mesh: Mesh) -> ShardedCatalog:
    sc = ShardedCatalog(mesh, source=catalog)
    for name in catalog.table_names():
        t = catalog.get_table(name)
        key = TPCH_PARTITION_KEYS.get(name)
        if key is not None:
            sc.add_sharded(name, t, key)
        else:
            sc.add_replicated(name, t)
    return sc


# ---------------------------------------------------------------------------
# tables across shards


def _unindexed(t: Table) -> Table:
    """`t` without its indexes (a shard has none), so that eagerly an
    IndexScan or a JoinIndex over a replicated source scans or sorts as over
    a shard, and as over the JAX package's traced tables. In capacity mode
    neither reads an index."""
    if not t.indexes:
        return t
    out = Table(t.columns, t.num_rows, name=t.name, live=t.live)
    out.encoding_spec, out.block_stats = t.encoding_spec, t.block_stats
    return out


def _on(t: Table, device: torch.device) -> Table:
    """`t` with its columns on `device` (itself if they are there)."""
    if t.device == device:
        return t
    cols = [Column(c.name, c.dtype, c.data.to(device),
                   c.validity.to(device) if c.has_validity else None, c.dictionary,
                   unique=c.unique, val_range=c.val_range) for c in t.columns]
    return Table(cols, t.num_rows, name=t.name,
                 live=None if t.live is None else t.live.to(device))


@dataclasses.dataclass
class _Template:
    """What a column of a table built from received tensors keeps: its
    name, type, dictionary and value range, and whether a validity travels
    with it."""

    name: str
    dtype: DataType
    dictionary: Optional[np.ndarray]
    val_range: Optional[tuple]
    validity: bool


def _merged_dictionary(cols) -> Optional[np.ndarray]:
    """The dictionary the parts of a column share, or, where their contents
    differ, the merged one (sorted, as every dictionary)."""
    d = cols[0].dictionary
    if cols[0].dtype is not DataType.STRING or all(
            c.dictionary is d or np.array_equal(c.dictionary, d) for c in cols):
        return d
    return np.unique(np.concatenate([c.dictionary for c in cols]))


def _recoded(c: Column, dictionary: Optional[np.ndarray]) -> torch.Tensor:
    """c's data with its codes in `dictionary`, a superset of c's (itself
    where the two are equal). The recoding table is a device_constant: one
    upload a query in capacity mode. Codes out of c's range (dead rows) map
    anywhere in range."""
    if dictionary is c.dictionary or dictionary is None or np.array_equal(dictionary,
                                                                          c.dictionary):
        return c.data
    if len(c.dictionary) == 0:  # only NULL or dead rows
        return torch.zeros_like(c.data)
    lut = device_constant(np.searchsorted(dictionary, c.dictionary).astype(np.int32),
                          torch.int32, c.device)
    return lut[c.data.to(torch.int64).clamp(0, len(c.dictionary) - 1)]


def _templates(parts: List[Table], always_validity: bool) -> List[_Template]:
    """Per column of equal-schema `parts`: the merged dictionary, the union
    of the value ranges, and whether any part has a validity."""
    out = []
    for i, c0 in enumerate(parts[0].columns):
        cs = [p.columns[i] for p in parts]
        ranges = [c.val_range for c in cs]
        val_range = None if any(r is None for r in ranges) else \
            (min(r[0] for r in ranges), max(r[1] for r in ranges))
        out.append(_Template(c0.name, c0.dtype, _merged_dictionary(cs), val_range,
                             always_validity or any(c.has_validity for c in cs)))
    return out


def concat_tables(parts: List[Table], name: str = "") -> Table:
    """The live rows of `parts` (equal schemas, one device), in order, as
    one prefix table. String columns whose dictionaries differ in content
    are rewritten into the merged dictionary; equal ones (the same object,
    or equal entries) are kept. A column keeps `val_range` (the union of
    the parts'); `unique` is dropped: rows of different parts may repeat a
    value."""
    parts = [ensure_prefix(p) for p in parts]
    if len(parts) == 1:
        t = parts[0]
        return Table([Column(c.name, c.dtype, c.data, c.validity if c.has_validity else None,
                             c.dictionary, val_range=c.val_range) for c in t.columns],
                     t.num_rows, name=name or t.name)
    tpl = _templates(parts, False)
    sent = [_columns_of(p, tpl, cut=True) for p in parts]
    return _table_from(tpl, [torch.cat([s[i] for s in sent]) for i in range(len(sent[0]))],
                       sum(p.num_rows for p in parts), name or parts[0].name)


def _columns_of(t: Table, tpl: List[_Template], cut: bool = False) -> List[torch.Tensor]:
    """The tensors a table sends, laid out by `tpl`: each column's data in
    its template's dictionary, then its validity where the template carries
    one (all True where the table has none); the first num_rows rows where
    `cut`, else the whole capacity."""
    out = []
    n = t.num_rows if cut else t.capacity
    for c, k in zip(t.columns, tpl):
        out.append(_recoded(c, k.dictionary)[:n])
        if k.validity:
            out.append(c.validity[:n] if c.has_validity else
                       torch.ones(n, dtype=torch.bool, device=t.device))
    return out


def _table_from(tpl: List[_Template], tensors, num_rows, name: str,
                indices: Optional[torch.Tensor] = None) -> Table:
    """A prefix table of `num_rows` rows of the `tensors` (_columns_of's
    layout), or of their rows at `indices`, gathered when first read; there
    a tensor may be a thunk that makes it."""
    it = iter(tensors)
    cols = []
    for k in tpl:
        data = next(it)
        validity = next(it) if k.validity else None
        if indices is None:
            cols.append(Column(k.name, k.dtype, data, validity, k.dictionary,
                               val_range=k.val_range))
            continue

        def taken(x):
            return None if x is None else \
                (lambda: (x() if callable(x) else x).index_select(0, indices))

        cols.append(Column(k.name, k.dtype, taken(data), taken(validity), k.dictionary,
                           device=indices.device, capacity=indices.shape[0],
                           val_range=k.val_range))
    return Table(cols, num_rows, name=name)


def _received(tpl: List[_Template], tensors, grouped: bool, name: str) -> Table:
    """An eager exchange's received tensors as a prefix table; over a
    process group (where every column travels with a validity) an all-valid
    validity is dropped."""
    t = _table_from(tpl, tensors, tensors[0].shape[0], name)
    if not grouped:
        return t
    return Table([Column(c.name, c.dtype, c.data, None, c.dictionary, val_range=c.val_range)
                  if c.has_validity and bool(c.validity.all()) else c for c in t.columns],
                 t.num_rows, name=name)


def _record(sites, label: str, counts) -> None:
    """An exchange site's rows a local shard: host ints, or in capacity mode
    device counts, which the compiled form reads with its other counts."""
    if sites is not None:
        sites.append((label, list(counts)))


def _capacity_concat(parts: List[Table], label: str, name: str,
                     mesh: Optional[Mesh] = None) -> Table:
    """Capacity mode's concat_tables: one compaction (K9c) of the parts'
    live masks at their capacities, concatenated in part order, at the site
    `label`: the live rows in order, counted on the device. A column is
    concatenated and gathered when first read; with a process group's
    `mesh`, this rank's one part is all-gathered first, every column."""
    tpl = _templates(parts, mesh is not None and mesh.group is not None)
    if mesh is not None and mesh.group is not None:
        (whole,) = gather_cap(mesh, [_columns_of(parts[0], tpl) + [parts[0].live_mask()]])
        idx, n = oracle_compact(whole[-1], label)
        return _table_from(tpl, whole[:-1], n, name, idx)
    idx, n = oracle_compact(torch.cat([p.live_mask() for p in parts]), label)
    tensors = []
    for i, k in enumerate(tpl):
        cols = [p.columns[i] for p in parts]
        tensors.append(lambda cols=cols, k=k: torch.cat([_recoded(c, k.dictionary)
                                                         for c in cols]))
        if k.validity:
            tensors.append(lambda cols=cols: torch.cat([
                c.validity if c.has_validity else
                torch.ones(c.capacity, dtype=torch.bool, device=c.device) for c in cols]))
    return _table_from(tpl, tensors, n, name, idx)


def gather_replicated(mesh: Mesh, shards: List[Table], sites=None) -> Table:
    """Every shard's live rows, in shard order, as one table on this
    process's first device (all_gather over a process group)."""
    if tracing():
        out = _capacity_concat(shards, "exchange.gather", shards[0].name, mesh)
        _record(sites, "exchange.gather", [out.num_rows] * len(shards))
        return out
    shards = [ensure_prefix(t) for t in shards]
    if mesh.group is None:
        out = concat_tables([_on(t, mesh.home) for t in shards])
    else:
        tpl = _templates(shards[:1], True)
        (got,) = all_gather(mesh, [_columns_of(shards[0], tpl, cut=True)])
        out = _received(tpl, got, True, shards[0].name)
    _record(sites, "exchange.gather", [out.num_rows] * len(shards))
    return out


def repartition_sharded(mesh: Mesh, shards: List[Table], keys: List[torch.Tensor],
                        label: str = "exchange.repartition", live=None, target=None,
                        exchange: str = "all_to_all", sites=None) -> List[Table]:
    """Shuffle every shard's rows to the shard owning hash(key), or
    `target` where given (skew-aware routing); `live` (per shard) narrows
    the rows sent. keys[i] is the promoted join key aligned with shard i's
    rows. Equal keys end on one shard; each shard gets the rows of shard 0
    first, each source's rows in their order. In capacity mode the rows
    move at the shards' capacities (exchange.shuffle_cap)."""
    n = mesh.n_shards
    grouped = mesh.group is not None
    lives = [t.live_mask() if live is None else live[i] for i, t in enumerate(shards)]
    targets = [partition_hash(keys[i], n) if target is None else target[i]
               for i in range(len(shards))]
    if tracing():
        # one code space: in one process the shards' rows are concatenated
        tpl = _templates(shards, grouped)
        got = shuffle_cap(mesh, [_columns_of(t, tpl) for t in shards],
                          [torch.where(v, x.to(torch.int64), n) for v, x in zip(lives, targets)],
                          label, exchange, estimate=max(t.capacity for t in shards))
        out = [_table_from(tpl, cols, count, t.name) for (cols, count), t in zip(got, shards)]
        _record(sites, label, [t.num_rows for t in out])
        return out
    tpls = [_templates([t], grouped) for t in shards]
    buckets = [_send_buckets(_columns_of(t, tpl), None, v, n, x)[0]
               for t, tpl, v, x in zip(shards, tpls, lives, targets)]
    recv = exchange_buckets(mesh, buckets, exchange)
    out = []
    for j, parts in enumerate(recv):
        got = tpls * n if grouped else tpls
        out.append(concat_tables([_received(tpl, p, grouped, shards[j].name)
                                  for tpl, p in zip(got, parts)], shards[j].name))
    _record(sites, label, [t.num_rows for t in out])
    return out


def _compacted(t: Table, keep: torch.Tensor, label: str, estimate: int) -> Table:
    """The rows of `t` where `keep` holds, as a prefix table: filter_table
    eagerly, one compaction at the site `label` in capacity mode."""
    if not tracing():
        return filter_table(t, keep)
    idx, n = oracle_compact(keep & t.live_mask(), label, max(estimate, 1))
    return gather_table(t, idx, preserve_unique=True, num_rows=n)


def localize_by_key(mesh: Mesh, t: Table, keys: torch.Tensor, label: str = "exchange.localize",
                    target=None, keep_also=None, sites=None) -> List[Table]:
    """Replicated -> sharded by key: each shard keeps the rows whose key
    hashes to it (or whose `target` names it), with no communication; rows
    in `keep_also` stay on every shard (hot build keys)."""
    n = mesh.n_shards
    tgt = partition_hash(keys, n) if target is None else target
    out = []
    for me, dev in zip(mesh.local_shards, mesh.devices):
        keep = tgt == me
        if keep_also is not None:
            keep = keep | keep_also
        out.append(_on(_compacted(t, keep, label, t.capacity // n), dev))
    _record(sites, label, [x.num_rows for x in out])
    return out


def _is_hot(keys: torch.Tensor, hot: np.ndarray) -> torch.Tensor:
    return torch.isin(keys, device_constant(hot, keys.dtype, keys.device))


def _skew_spread_target(keys: torch.Tensor, live: torch.Tensor, hot: np.ndarray,
                        n_shards: int, offset: Optional[int]) -> torch.Tensor:
    """Targets with the hot rows spread round-robin, starting at `offset`
    (the shard's index, so sharded inputs spread evenly overall; None for a
    replicated input, whose targets every shard must compute alike), the
    rest by hash."""
    is_hot = _is_hot(keys, hot) & live
    rr = torch.cumsum(is_hot.to(torch.int64), 0) - 1 + (offset or 0)
    return torch.where(is_hot, rr % n_shards, partition_hash(keys, n_shards).to(torch.int64))


def repartition_build_skew(mesh: Mesh, shards: List[Table], keys: List[torch.Tensor],
                           hot: np.ndarray, label: str = "", exchange: str = "all_to_all",
                           sites=None) -> List[Table]:
    """Build-side shuffle with the hot keys on every shard: the other rows
    take the hash route, the hot rows are gathered to every shard, so the
    shard any hot probe row lands on holds its matches."""
    lives = [t.live_mask() for t in shards]
    is_hot = [_is_hot(k, hot) & v for k, v in zip(keys, lives)]
    nonhot = repartition_sharded(mesh, shards, keys, label + ".nonhot",
                                 live=[v & ~h for v, h in zip(lives, is_hot)],
                                 exchange=exchange, sites=sites)
    hot_rows = [_compacted(t, h, label + ".hot", t.capacity // 8)
                for t, h in zip(shards, is_hot)]
    _record(sites, label + ".hot", [t.num_rows for t in hot_rows])
    hot_all = gather_replicated(mesh, hot_rows, sites)
    if tracing():
        out = [_capacity_concat([a, hot_all], label + ".merge", a.name) for a in nonhot]
    else:
        out = [concat_tables([a, _on(hot_all, a.device)], a.name) for a in nonhot]
    _record(sites, label + ".merge", [t.num_rows for t in out])
    return out


def _padded(t: Table, rows: Optional[int]) -> Table:
    """`t` (a base shard, prefix layout) at `rows` positions, zeros past its
    own; itself where `rows` is None or its capacity."""
    if rows is None or rows == t.capacity:
        return t

    def pad(x):
        return torch.cat([x, torch.zeros(rows - x.shape[0], dtype=x.dtype, device=x.device)])

    return Table([Column(c.name, c.dtype, pad(c.data),
                         pad(c.validity) if c.has_validity else None, c.dictionary,
                         unique=c.unique, val_range=c.val_range) for c in t.columns],
                 t.num_rows, name=t.name)


def _first_rows(t: Table, k: int) -> Table:
    """A prefix table cut to the capacity bucket of its first k rows (the
    JAX package's _slice_prefix): the rows a Limit keeps, at a size the
    host knows."""
    cap = bucket_capacity(max(k, 1))
    if t.live is not None or cap >= t.capacity:
        return t
    return Table([c.block(0, cap) for c in t.columns], t.num_rows, name=t.name)


# ---------------------------------------------------------------------------
# the distributed query


_DECOMPOSABLE = {AggregateFunction.SUM, AggregateFunction.COUNT, AggregateFunction.MIN,
                 AggregateFunction.MAX, AggregateFunction.AVG}

# placement survives these: rows are filtered, no row changes shard and no
# column changes (a Projection keeps it only where it forwards the key
# column unchanged: _projected_key)
_ROW_PRESERVING = ("TableScan", "Validate")

# modes that emit only probe-side rows (pairs and unmatched probe rows), so
# the build side may be replicated; OUTER also emits unmatched build rows
_PROBE_PRESERVING = (JoinMode.INNER, JoinMode.LEFT, JoinMode.RIGHT, *EXISTENCE_MODES)

# writes, imports, exports and prints run single-node. An IndexScan gathers
# its input and scans it (the gathered table has no index), and a JoinIndex
# is a join: both run as in the JAX package, whose traced tables carry no
# index (_unindexed)
_UNDISTRIBUTABLE = ("Insert", "Delete", "Update", "ImportCsv", "ImportBinary", "ExportCsv",
                    "ExportBinary", "Print")

BROADCAST_MAX_ROWS = 1 << 16

_NO_HOT = np.empty(0, dtype=np.int64)

_EXCHANGE_LABELS = ("exchange.", "shuffle", "localize", "gather", "mpsm")


class DistributedQuery:
    """Execute an operator plan over a ShardedCatalog.

        dq = DistributedQuery(TPCH_PLANS[3](cat), shard_cat)
        table = dq.run()           # the answer, on the mesh's first device
        dq.exchange_stats()        # rows through every exchange site

    The plan's GetTable leaves are read from `shard_cat` by name. Join
    decisions, hot keys and MPSM splitters are taken on the first run and
    kept. Over a process group every rank builds the same plan and calls
    run() (and exchange_stats(), one all_gather) alike. `exchange`:
    "all_to_all" or "ring" (the JAX package's HYRISE_TPU_RING_EXCHANGE).
    """

    def __init__(self, root: AbstractOperator, shard_cat: ShardedCatalog,
                 exchange: str = "all_to_all"):
        check_exchange(exchange)
        self.mesh = shard_cat.mesh
        self.n_shards = self.mesh.n_shards
        self.shard_cat = shard_cat
        self.root = root
        self.exchange = exchange
        self.ops = _walk(root)
        for op in self.ops:
            if op.name in _UNDISTRIBUTABLE:
                raise PlanNotCompilable(op.name)
        self._sources: List[object] = []
        self._op_source: Dict[int, object] = {}
        self._src_placement: Dict[int, Placement] = {}
        for op in self.ops:
            if isinstance(op, GetTable):
                if op.table_name not in shard_cat.entries:
                    raise PlanNotCompilable("no sharded copy of " + op.table_name)
                src = shard_cat.get(op.table_name)
            elif isinstance(op, TableWrapper):
                src = op.table
            else:
                continue
            self._op_source[id(op)] = src
            if isinstance(src, ShardedTable):
                pkey = src.partition_key
                # a string key hashes its codes, which are dictionary
                # dependent: never claim co-partitioning for it
                if pkey is not None and src.shards[0].column(pkey).dtype is DataType.STRING:
                    pkey = None
                self._src_placement[id(src)] = Placement(False, pkey)
            else:
                if src.mvcc is not None:
                    raise PlanNotCompilable("MVCC table " + src.name)
                self._src_placement[id(src)] = REPLICATED
            if all(s is not src for s in self._sources):
                self._sources.append(src)
        if not self._sources:
            raise PlanNotCompilable("no base tables")
        self._consumers: Dict[int, List[AbstractOperator]] = {}
        for o in self.ops:
            for i in o.inputs:
                self._consumers.setdefault(id(i), []).append(o)
        self._decisions: Dict[int, str] = {}
        self._hot_keys: Dict[int, np.ndarray] = {}
        self._splitters: Dict[int, np.ndarray] = {}
        self._local_sorted: set = set()
        self._sites: List[Tuple[str, List[int]]] = []
        # the rows of every operator's output on the last run, one entry per
        # local shard; None for a replicated output
        self.op_rows: Dict[int, Optional[List[int]]] = {}

    # -- the run --------------------------------------------------------------

    def run(self) -> Table:
        self._sites = []
        self.op_rows = {}
        self._local_sorted = set()
        out = self._execute({})
        t, p = out[id(self.root)]
        result = t if p.replicated else gather_replicated(self.mesh, t, self._sites)
        return ensure_prefix(result)

    def _execute(self, out: Dict[int, tuple], keep: frozenset = frozenset()) -> Dict[int, tuple]:
        """Every operator not in `out` yet, inputs first. An output is
        dropped once its last consumer ran, unless its operator is the root
        or in `keep`."""
        remaining = {k: len(v) for k, v in self._consumers.items()}
        for op in self.ops:
            if id(op) not in out:
                out[id(op)] = self._exec_op(op, out)
                t, p = out[id(op)]
                self.op_rows[id(op)] = None if p.replicated else [x.num_rows for x in t]
            for i in op.inputs:
                remaining[id(i)] -= 1
                if remaining[id(i)] == 0 and i is not self.root and id(i) not in keep:
                    out.pop(id(i), None)
        return out

    def _run_local(self, op: AbstractOperator, tables: List[Table]) -> Table:
        """op's own single-card code over `tables` as its inputs."""
        saved = [inp._output for inp in op.inputs]
        for inp, t in zip(op.inputs, tables):
            inp._output = t
        try:
            return op._on_execute(None)
        finally:
            for inp, s in zip(op.inputs, saved):
                inp._output = s

    def _map(self, op: AbstractOperator, ins):
        """op over each shard's inputs (a replicated input as it is, on the
        shard's device); once, replicated, when every input is."""
        if all(p.replicated for _, p in ins):
            return self._run_local(op, [t for t, _ in ins])
        return [self._run_local(op, [_on(t, dev) if p.replicated else t[i] for t, p in ins])
                for i, dev in enumerate(self.mesh.devices)]

    def _gathered(self, t, p: Placement) -> Table:
        return t if p.replicated else gather_replicated(self.mesh, t, self._sites)

    def _source(self, op, src):
        if tracing():
            # capacity mode: a table of no positions reads as one dead row;
            # over a process group every rank's shard has the largest
            # shard's capacity, so every rank sizes its sites alike
            if isinstance(src, ShardedTable):
                width = int(src.counts.max()) if self.mesh.group is not None else None
                return ([_capacity_source(_padded(t, width)) for t in src.shards],
                        self._src_placement[id(src)])
            return _capacity_source(src), REPLICATED
        if isinstance(src, ShardedTable):
            return list(src.shards), self._src_placement[id(src)]
        return _on(_unindexed(src), self.mesh.home), REPLICATED

    def _exec_op(self, op, out):
        src = self._op_source.get(id(op))
        if src is not None:
            return self._source(op, src)
        ins = [out[id(i)] for i in op.inputs]

        if op.name in _ROW_PRESERVING:
            (_, p), = ins
            res = self._map(op, ins)
            return res, self._preserved(p, res)

        if op.name == "Projection":
            (_, p), = ins
            res = self._map(op, ins)
            if p.replicated or p.key is None:
                return res, p
            return res, Placement(False, self._projected_key(op, p.key))

        if op.name == "Alias":
            (t, p), = ins
            res = self._map(op, ins)
            key = p.key
            if not p.replicated and key is not None:
                if op.sources is not None:
                    key = op.names[op.sources.index(key)] if key in op.sources else None
                else:
                    key = op.names[t[0].column_names.index(key)]
            return res, (p if p.replicated else Placement(False, key))

        if isinstance(op, Join):
            return self._exec_join(op, ins)

        if isinstance(op, Aggregate):
            return self._exec_aggregate(op, ins[0])

        if op.name == "FusedFilterAggregate":
            # expanded again, so the aggregate strategies (per shard,
            # two-phase) apply instead of a gather of the base table
            t, p = ins[0]
            if op.predicate is not None:
                t = self._map(TableScan(TableWrapper(None), op.predicate), [(t, p)])
                p = self._preserved(p, t)
            agg = Aggregate(TableWrapper(None), op.groupby, op.aggregates)
            return self._exec_aggregate(agg, (t, p))

        # distributed top K (reference sort.cpp:180-210 per shard): a Sort
        # consumed only by Limits sorts per shard; each Limit gathers K rows a
        # shard and sorts those again
        if op.name == "Sort":
            t, p = ins[0]
            consumers = self._consumers.get(id(op), [])
            if not p.replicated and consumers and all(c.name == "Limit" for c in consumers):
                res = self._map(op, ins)
                self._local_sorted.add(id(op))
                return res, self._preserved(p, res)

        if op.name == "Limit" and id(op.inputs[0]) in self._local_sorted:
            t, p = ins[0]
            if not p.replicated:
                local = self._map(op, ins)
                if tracing():  # K rows a shard travel, not the shard's capacity
                    local = [_first_rows(x, op.n) for x in local]
                top = gather_replicated(self.mesh, local, self._sites)
                return self._run_local(op, [self._run_local(op.inputs[0], [top])]), REPLICATED

        # everything else: replicate the inputs, run the operator once
        return self._run_local(op, [self._gathered(t, p) for t, p in ins]), REPLICATED

    @staticmethod
    def _projected_key(op, key: str) -> Optional[str]:
        """The name under which a Projection forwards the partition key
        column unchanged (a bare name or a ColumnRef; the first output of
        that name, which Table.column resolves), or None: a computed column
        named like the key holds other values (ROADMAP C25)."""
        names = []
        for spec in op.outputs:
            if isinstance(spec, str):
                name, source = spec, spec
            else:
                name, expr = spec if isinstance(spec, tuple) else (repr(spec), spec)
                source = expr.name if isinstance(expr, ColumnRef) else None
            if source == key and name not in names:
                return name
            names.append(name)
        return None

    @staticmethod
    def _preserved(p: Placement, res) -> Placement:
        if p.replicated or p.key is None:
            return p
        return p if res[0].has_column(p.key) else Placement(False, None)

    # -- joins ----------------------------------------------------------------

    def _lineage_source(self, op, col: str):
        """(base source, its column) that a join input's key column comes
        from through TableScan / Validate / Alias, or None: skew detection
        reads the source's whole key distribution."""
        while True:
            src = self._op_source.get(id(op))
            if src is not None:
                names = src.column_names
                return (src, col) if col in names else None
            if op.name in ("TableScan", "Validate"):
                op = op.inputs[0]
                continue
            if op.name == "Alias" and op.sources is not None:
                if col not in op.names:
                    return None
                col = op.sources[op.names.index(col)]
                op = op.inputs[0]
                continue
            return None

    @staticmethod
    def _source_dtype(src, col: str) -> DataType:
        t = src.shards[0] if isinstance(src, ShardedTable) else src
        return t.column(col).dtype

    def _source_keys(self, src, col: str) -> torch.Tensor:
        """Every row's key of a base source (all shards', gathered)."""
        if isinstance(src, ShardedTable):
            return all_gather(self.mesh, [[t.column(col).data] for t in src.shards])[0][0]
        t = ensure_prefix(src)
        return t.column(col).data[:t.num_rows]

    def _detect_hot_keys(self, op: Join, pi: int) -> np.ndarray:
        """Hot keys of the probe side's source distribution: heavy hitters
        that would overload one shard after a shuffle by hash(key)."""
        from hyrise_tpu_torch.parallel.skew import detect_hot_keys, detect_hot_keys_sharded

        cols = (op.left_col, op.right_col)
        lin = self._lineage_source(op.inputs[pi], cols[pi])
        if lin is None or not self._source_dtype(*lin).is_integral:
            return _NO_HOT  # the promoted key space is not the raw values
        b_lin = self._lineage_source(op.inputs[1 - pi], cols[1 - pi])
        if b_lin is None or not self._source_dtype(*b_lin).is_integral:
            return _NO_HOT
        src, scol = lin
        if isinstance(src, ShardedTable):
            return detect_hot_keys_sharded(src, scol).astype(np.int64)
        return detect_hot_keys(src, scol, self.n_shards).astype(np.int64)

    def _capacity(self, t) -> int:
        """The JAX package's capacity of a sharded intermediate: the bucket
        of the largest shard's rows (a global quantity)."""
        return bucket_capacity(all_max(self.mesh, [x.num_rows for x in t]))

    def _join_decision(self, op: Join, ins) -> str:
        d = self._decisions.get(id(op))
        if d is not None:
            return d
        if tracing():
            raise RuntimeError(f"{op.name}({op.left_col}={op.right_col}): no decision was "
                               "pinned before capacity mode")
        (_, lp), (_, rp) = ins
        mode, cond = op.mode, op.cond
        if lp.replicated and rp.replicated:
            d = "replicated"
        elif cond is not PredicateCondition.EQUALS or \
                mode not in (*_PROBE_PRESERVING, JoinMode.OUTER):
            d = "gather"
        elif mode is JoinMode.ANTI_NULL_AS_TRUE:
            # NOT IN decides on the whole build side (a NULL in it rejects
            # every row, a NULL probe key is kept only if it is empty): the
            # build side is gathered whatever its size, never split by key
            # (the JAX rule splits it, ROADMAP C26)
            d = "replicated" if lp.replicated else "broadcast"
        else:
            pi = 1 if mode is JoinMode.RIGHT else 0
            pp = ins[pi][1]
            bt, bp = ins[1 - pi]
            pcol = (op.left_col, op.right_col)[pi]
            bcol = (op.left_col, op.right_col)[1 - pi]
            if not pp.replicated and pp.key == pcol and not bp.replicated and bp.key == bcol:
                d = "copart"
            elif mode is not JoinMode.OUTER and pp.replicated and \
                    (bp.replicated or self._capacity(bt) * self.n_shards <= BROADCAST_MAX_ROWS):
                d = "replicated"
            elif mode is not JoinMode.OUTER and \
                    (bp.replicated or self._capacity(bt) * self.n_shards <= BROADCAST_MAX_ROWS):
                d = "broadcast"
            else:
                d = "shuffle"
        if d in ("shuffle", "broadcast") and isinstance(op, JoinMPSM) and \
                mode in _PROBE_PRESERVING and mode is not JoinMode.ANTI_NULL_AS_TRUE:
            # JoinMPSM (reference join_mpsm.cpp): value-range clustering by
            # quantile splitters of the probe key's distribution
            spl = self._mpsm_splitters(op, 1 if op.mode is JoinMode.RIGHT else 0)
            if spl is not None:
                self._splitters[id(op)] = spl
                d = "mpsm"
        self._decisions[id(op)] = d
        return d

    def join_decisions(self) -> List[str]:
        """The decision of every join, in plan order: `Join(l=r) decision`."""
        return [f"{op.name}({op.left_col}={op.right_col}) {self._decisions[id(op)]}"
                for op in self.ops if id(op) in self._decisions]

    def _mpsm_splitters(self, op: Join, pi: int) -> Optional[np.ndarray]:
        """n_shards - 1 quantile splitters of the probe key's source
        distribution (the value-cluster bounds of the reference's
        radix_cluster_sort_numa), or None where it cannot be read."""
        cached = self._splitters.get(id(op))
        if cached is not None:
            return cached
        lin = self._lineage_source(op.inputs[pi], (op.left_col, op.right_col)[pi])
        if lin is None or not self._source_dtype(*lin).is_integral:
            return None
        keys = self._source_keys(*lin).cpu().numpy()
        if keys.size == 0:
            return None
        qs = np.quantile(keys.astype(np.int64), np.linspace(0, 1, self.n_shards + 1)[1:-1])
        return qs.astype(np.int64)

    def _promoted(self, lt, rt, op: Join):
        """Both sides' join keys in one key space (ops/join.py's), per shard
        (or the one replicated table's)."""
        first = (lambda t: t if isinstance(t, Table) else t[0])
        space = _key_space(first(lt).column(op.left_col), first(rt).column(op.right_col))

        def keys(t, col, remap):
            if isinstance(t, Table):
                return _keys_in(t.column(col), remap, space.dtype)
            return [_keys_in(x.column(col), remap, space.dtype) for x in t]

        return (keys(lt, op.left_col, space.probe_remap),
                keys(rt, op.right_col, space.build_remap))

    def _exec_join(self, op: Join, ins):
        (lt, lp), (rt, rp) = ins
        mode = op.mode
        decision = self._join_decision(op, ins)
        if decision in ("replicated", "gather"):
            return self._run_local(op, [self._gathered(lt, lp), self._gathered(rt, rp)]), \
                REPLICATED

        # the probe side: the side whose rows the output is built from
        pi = 1 if mode is JoinMode.RIGHT else 0
        pt, pp = ins[pi]
        bt, bp = ins[1 - pi]
        pcol = (op.left_col, op.right_col)[pi]
        first = pt if isinstance(pt, Table) else pt[0]
        is_str = first.column(pcol).dtype is DataType.STRING
        sites, mesh, n = self._sites, self.mesh, self.n_shards

        def done(res, key: Optional[str]):
            if key is not None and (is_str or not res[0].has_column(key)):
                key = None
            return res, Placement(False, key)

        def side(t, p, k, lbl, target=None):
            """A side placed by `target` (or hash(k)): localized if
            replicated, shuffled if sharded."""
            if p.replicated:
                return localize_by_key(mesh, t, k, lbl, target=target, sites=sites)
            return repartition_sharded(mesh, t, k, lbl, target=target, exchange=self.exchange,
                                       sites=sites)

        if decision == "copart":
            return done(self._map(op, ins), pcol)

        if decision == "mpsm":
            spl = self._splitters[id(op)]
            lk, rk = self._promoted(lt, rt, op)

            def range_target(k):
                s = device_constant(spl, k.dtype, k.device)
                return torch.searchsorted(s, k, right=True).to(torch.int64)

            def targets(k):
                return range_target(k) if isinstance(k, torch.Tensor) else \
                    [range_target(x) for x in k]

            lt2 = side(lt, lp, lk, "join.mpsm_l", targets(lk))
            rt2 = side(rt, rp, rk, "join.mpsm_r", targets(rk))
            return done(self._map(op, [(lt2, Placement(False)), (rt2, Placement(False))]),
                        None)

        if decision == "broadcast":
            b_rep = self._gathered(bt, bp)
            tables = [None, None]
            tables[pi], tables[1 - pi] = (pt, pp), (b_rep, REPLICATED)
            return done(self._map(op, tables), pp.key)

        assert decision == "shuffle", decision
        lk, rk = self._promoted(lt, rt, op)
        hot = self._hot_keys.get(id(op))
        if hot is None:
            if tracing():
                raise RuntimeError(f"{op.name}: no hot keys were pinned before capacity mode")
            hot = self._detect_hot_keys(op, pi) if mode in _PROBE_PRESERVING else _NO_HOT
            self._hot_keys[id(op)] = hot
        if hot.size:
            # hot probe keys spread round-robin, their build rows replicated
            # to every shard (OUTER is excluded: replicated unmatched build
            # rows would be emitted once per shard)
            pk, bk = (lk, rk) if pi == 0 else (rk, lk)
            if pp.replicated:
                pt2 = localize_by_key(mesh, pt, pk, "join.localize_p",
                                      target=_skew_spread_target(pk, pt.live_mask(), hot, n,
                                                                 None), sites=sites)
            else:
                pt2 = repartition_sharded(
                    mesh, pt, pk, "join.shuffle_p",
                    target=[_skew_spread_target(k, t.live_mask(), hot, n, me)
                            for k, t, me in zip(pk, pt, mesh.local_shards)],
                    exchange=self.exchange, sites=sites)
            if bp.replicated:
                bt2 = localize_by_key(mesh, bt, bk, "join.localize_b",
                                      keep_also=_is_hot(bk, hot), sites=sites)
            else:
                bt2 = repartition_build_skew(mesh, bt, bk, hot, "join.shuffle_b",
                                             exchange=self.exchange, sites=sites)
            tables = [None, None]
            tables[pi], tables[1 - pi] = (pt2, Placement(False)), (bt2, Placement(False))
            return done(self._map(op, tables), None)

        if lp.replicated:
            lt2 = localize_by_key(mesh, lt, lk, "join.localize_l", sites=sites)
        elif lp.key == op.left_col:
            lt2 = lt
        else:
            lt2 = repartition_sharded(mesh, lt, lk, "join.shuffle_l", exchange=self.exchange,
                                      sites=sites)
        if rp.replicated:
            rt2 = localize_by_key(mesh, rt, rk, "join.localize_r", sites=sites)
        elif rp.key == op.right_col:
            rt2 = rt
        else:
            rt2 = repartition_sharded(mesh, rt, rk, "join.shuffle_r", exchange=self.exchange,
                                      sites=sites)
        return done(self._map(op, [(lt2, Placement(False)), (rt2, Placement(False))]), pcol)

    # -- aggregates -----------------------------------------------------------

    def _exec_aggregate(self, op: Aggregate, in_):
        t, p = in_
        if p.replicated:
            return self._run_local(op, [t]), REPLICATED
        if p.key is not None and p.key in op.groupby:
            # groups are shard-local: the local aggregate is the global one
            res = self._map(op, [in_])
            return res, self._preserved(p, res)
        if not {agg.fn for _, agg in op.aggregates} <= _DECOMPOSABLE or \
                any(getattr(agg, "distinct", False) for _, agg in op.aggregates):
            return self._run_local(op, [gather_replicated(self.mesh, t, self._sites)]), \
                REPLICATED

        # two-phase: per-shard partials -> gather -> combine -> finish
        partial_specs: List[Tuple[str, AggregateExpr]] = []
        combine_specs: List[Tuple[str, AggregateExpr]] = []
        finish: List[Tuple[str, str, Tuple[str, ...]]] = []
        F = AggregateFunction
        for i, (out_name, agg) in enumerate(op.aggregates):
            if agg.fn is F.AVG:
                s, c = f"__s{i}", f"__c{i}"
                partial_specs += [(s, AggregateExpr(F.SUM, agg.arg)),
                                  (c, AggregateExpr(F.COUNT, agg.arg))]
                combine_specs += [(s, AggregateExpr(F.SUM, ColumnRef(s))),
                                  (c, AggregateExpr(F.SUM, ColumnRef(c)))]
                finish.append(("avg", out_name, (s, c)))
            else:
                pn = f"__p{i}"
                partial_specs.append((pn, agg))
                fn = F.SUM if agg.fn in (F.SUM, F.COUNT) else agg.fn
                combine_specs.append((pn, AggregateExpr(fn, ColumnRef(pn))))
                finish.append(("count" if agg.fn is F.COUNT else "col", out_name, (pn,)))

        partial = [self._run_agg(x, op.groupby, partial_specs) for x in t]
        gathered = gather_replicated(self.mesh, partial, self._sites)
        combined = self._run_agg(gathered, op.groupby, combine_specs)

        cols: List[Column] = [combined.column(g) for g in op.groupby]
        for kind, out_name, names in finish:
            if kind == "avg":
                s, c = combined.column(names[0]), combined.column(names[1])
                cnt = c.data.to(torch.int64)
                data = s.data.to(torch.float64) / torch.clamp(cnt, min=1)
                cols.append(Column(out_name, DataType.FLOAT64, data, cnt > 0, None))
            elif kind == "count":
                c = combined.column(names[0])
                cols.append(Column(out_name, DataType.INT64, c.data.to(torch.int64), None, None))
            else:
                cols.append(combined.column(names[0]).with_name(out_name))
        return Table(cols, combined.num_rows, name=combined.name), REPLICATED

    def _run_agg(self, t: Table, groupby, specs) -> Table:
        return self._run_local(Aggregate(TableWrapper(None), groupby, specs), [t])

    # -- what the last run saw -----------------------------------------------

    def source_rows(self) -> Dict[str, List[int]]:
        """Every sharded table the last run read, with the rows each shard
        holds of it (all shards', also over a process group)."""
        return {src.name: list(src.counts) for op in self.ops
                for src in [self._op_source.get(id(op))]
                if isinstance(src, ShardedTable) and id(op) in self.op_rows}

    def _site_matrix(self) -> np.ndarray:
        """[n_shards, sites]: every shard's count at every exchange site of
        the last run (one all_gather over a process group)."""
        local = np.array([counts for _, counts in self._sites], dtype=np.int64).reshape(
            len(self._sites), len(self.mesh.local_shards)).T
        if self.mesh.group is None:
            return local
        (got,) = all_gather(self.mesh, [[torch.as_tensor(local[0], device=self.mesh.home)]])
        return got[0].reshape(self.n_shards, len(self._sites)).cpu().numpy()

    def exchange_stats(self) -> Dict[str, Dict[str, int]]:
        """Rows through every exchange site on the last run, by label, as
        the JAX package counts them: `rows` is a gather's total, or the sum
        over shards of what a shuffle received or a localize kept;
        `moved_rows` counts a gathered row once for each shard that did not
        hold it, and a shuffled row once (a localize moves nothing)."""
        if not self._sites:
            return {}
        arr = self._site_matrix()
        stats: Dict[str, Dict[str, int]] = {}
        for i, (lab, _) in enumerate(self._sites):
            if not (any(s in lab for s in _EXCHANGE_LABELS) or lab.startswith("skew")):
                continue
            entry = stats.setdefault(lab, {"sites": 0, "rows": 0, "moved_rows": 0})
            entry["sites"] += 1
            if "gather" in lab:
                rows = int(arr[:, i].max())
                entry["rows"] += rows
                entry["moved_rows"] += rows * (self.n_shards - 1)
            elif "localize" in lab:
                entry["rows"] += int(arr[:, i].sum())
            else:
                rows = int(arr[:, i].sum())
                entry["rows"] += rows
                entry["moved_rows"] += rows
        return stats


# ---------------------------------------------------------------------------
# the compiled form


class DistributedCompiledQuery(CompiledQuery):
    """A plan over a ShardedCatalog in capacity mode (plan/compiler.py): on
    the card every shard's operators and every exchange are one captured
    CUDA graph, replayed with one host read; on the CPU, and over a process
    group of CPU ranks, the same capacity mode runs uncaptured.

        dcq = DistributedCompiledQuery(TPCH_PLANS[3](cat), shard_cat)
        table = dcq.run()        # first call: an eager DistributedQuery run
                                 # that pins the decisions, then learn,
                                 # capture, replay; later calls: one replay
        dcq.exchange_stats()     # rows through every exchange site

    The decisions (join strategies, hot keys, MPSM splitters) are taken
    once, by an eager DistributedQuery run of the plan (`pins` counts them),
    and only read in capacity mode, so a learned capacity never changes the
    exchange structure. The exchanges are the capacity forms of
    parallel/exchange.py; each exchange site's rows a shard stay on the
    device and come back with the run's one host read, from which
    `exchange_stats()` counts as the eager form does. Over a process group
    that read all-gathers every rank's counts, and every rank grows and
    shrinks its capacities by the largest, so every rank's buffers have one
    size.

    Refused with PlanNotCompilable: what DistributedQuery refuses
    (writes, imports, exports, prints, MVCC tables),
    what CompiledQuery refuses, and a mesh whose shards sit on more than one
    device (one graph holds one card's work). A sharded or replicated
    source replaced in the ShardedCatalog since the last run (add_sharded,
    PlacementManager.run_once) drops the graph, which read the old one's
    tensors: the decisions are pinned anew and the plan learned and
    captured again."""

    def __init__(self, root: AbstractOperator, shard_cat: ShardedCatalog,
                 exchange: str = "all_to_all"):
        mesh = shard_cat.mesh
        if len(set(mesh.devices)) > 1:
            raise PlanNotCompilable(f"a mesh over {len(set(mesh.devices))} devices: a captured "
                                    "graph holds the work of one")
        self.shard_cat = shard_cat
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.exchange = exchange
        self.root = root
        self._dq = self._new_query()  # the eager form's refusals
        self._pinned = False
        self.pins = 0
        self._site_layout: List[Tuple[str, int]] = []
        super().__init__(root)

    def _new_query(self) -> DistributedQuery:
        """The eager form over this plan, whose decisions a run pins."""
        return DistributedQuery(self.root, self.shard_cat, self.exchange)

    def _resolve_sources(self) -> list:
        """The sharded and replicated tables the plan reads now, each once."""
        sources = []
        for op in self.ops:
            if isinstance(op, GetTable):
                src = self.shard_cat.get(op.table_name)
            elif isinstance(op, TableWrapper):
                src = op.table
            else:
                continue
            if all(s is not src for s in sources):
                sources.append(src)
        return sources

    def refresh_sources(self) -> None:
        """A source replaced since the last run: the graph is dropped, the
        decisions pinned anew and the capacities learned anew."""
        now = self._resolve_sources()
        if [id(t) for t in now] != [id(t) for t in self._sources]:
            self._sources = now
            self.drop_graph()
            self._constants = {}
            self.caps.clear()
            self._dq = self._new_query()
            self._pinned = False

    def _pin(self) -> None:
        """One eager run of the plan, which takes every decision."""
        try:
            self._dq.run()
        finally:
            for op in self.ops:
                op.clear_output()
        self._pinned = True
        self.pins += 1

    def _execute(self, learning: bool):
        if not self._pinned:
            self._pin()
        return super()._execute(learning)

    def _plan_output(self):
        ctx = active()
        out = self._dq.run()
        self._site_layout = [(label, len(counts)) for label, counts in self._dq._sites]
        for label, counts in self._dq._sites:
            for c in counts:
                ctx.stat(c if isinstance(c, torch.Tensor) else
                         torch.full((), c, dtype=torch.int64, device=self.device), label)
        return out

    def read_counts(self, counts: torch.Tensor) -> list:
        """The run's one host read. Over a process group it all-gathers every
        rank's counts and returns their largest, which every rank then
        holds its capacities to. The exchange sites' own rows set the
        eager form's site list, which exchange_stats() reads."""
        if self.mesh.group is None:
            mine = super().read_counts(counts)
        else:
            self.host_reads += 1
            (whole,) = gather_cap(self.mesh, [[counts.reshape(-1)]])
            ranks = whole[0].reshape(self.n_shards, *counts.shape)
            mine = counts.tolist()
            self.last_counts = ranks.max(dim=0).values.tolist()
        rows = mine if mine and isinstance(mine[0], list) else [mine]
        first = len(self._labels) + len(self._check_labels)
        sites = []
        for row in rows:
            values = iter(row[first:])
            sites += [(label, [next(values) for _ in range(k)]) for label, k in self._site_layout]
        self._dq._sites = sites
        return self.last_counts

    # -- what the last run saw -----------------------------------------------

    def join_decisions(self) -> List[str]:
        return self._dq.join_decisions()

    def exchange_stats(self) -> Dict[str, Dict[str, int]]:
        """DistributedQuery.exchange_stats() of the last run's counts."""
        return self._dq.exchange_stats()

    def source_rows(self) -> Dict[str, List[int]]:
        return self._dq.source_rows()
