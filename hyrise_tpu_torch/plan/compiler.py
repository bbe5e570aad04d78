"""Whole-plan compiled execution: a physical operator DAG captured once as a
CUDA graph and replayed with one host read.

Port of hyrise_tpu/plan/compiler.py, where a plan is traced into one XLA
program. A CUDA graph has XLA's constraint: every buffer has a size fixed
at capture, and nothing may read the device while the graph is captured.
The eager path reads the row count of every variable-size output (one
device->host round trip per operator); here those sites go through a
**capacity oracle**:

- Eager (no active context): `oracle_capacity` reads the count, as the
  eager operators always did.
- Capacity mode (under a CompileContext): the count stays a 0-dim int64
  tensor on the device; the oracle hands out a capacity for this call site
  (first run: a bound or an estimate; later runs: the learned count) and
  records the count. The site's output is a buffer of `cap` rows whose row
  count is that tensor, clamped to `cap`; `Table.live_mask()` compares
  positions with it on the device. After a run the host reads the vector
  [site counts..., n_rows] once and compares each count with its capacity;
  an overflow raises that site's capacity to the exact count and runs again.

Host values in capacity mode come only from capacities and from metadata the
host knows: `val_range`, dictionary sizes, table capacities. A join key
without a carried bound takes the hash lookup (K8) where the eager path
reads its bounds from the device. Host constants that the dictionary
rewrites upload (expression/evaluator.py) are made once per query
(`device_constant`), so a captured graph reads them from the same tensors.

`CompiledQuery` wraps a DAG. On CUDA tensors `run` (1) runs the plan once in
capacity mode uncaptured, under `torch.cuda.set_sync_debug_mode("error")`
where no other thread runs (_sync_errors), which builds the kernel libraries
and the query's constants, learns the counts and proves that no operator
reads the device, (2) captures the plan on a side stream into a memory pool
of its own, where a host read raises too, (3) replays it and copies the
result columns out of the pool (the next replay overwrites them). Later
runs only replay. On CPU
tensors the same capacity mode runs without a graph, so the oracle, the
retries and the tightening are the same code.

The JAX package's gather-site batching (`gather_columns_via_sort`,
`GATHER_SEEDS`) and capacity seeds (`CAP_SEEDS`) work around XLA's compile
times and have no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.utils import spans

_MIN_CAPACITY = 1024

_STATE = threading.local()
_EAGER_READS_LOCK = threading.Lock()
_eager_reads = 0


_COUNTS_LOCK = threading.Lock()
_counts = {"learning_runs": 0, "retries": 0, "captures": 0,
           "pool_bytes_live": 0, "pool_bytes_peak": 0}


def compiled_counts() -> Dict[str, int]:
    """What compiled execution did since the process began, over every
    CompiledQuery: `learning_runs` (uncaptured capacity-mode runs, each
    with one host read), `retries` (overflows that `grow` raised, each
    forcing a new learning run and capture), `captures`, and the device
    memory the captured graphs' private pools reserved: `pool_bytes_live`
    for the graphs alive now (a dropped or collected graph gives its bytes
    back) and `pool_bytes_peak`, the most held at once."""
    with _COUNTS_LOCK:
        return dict(_counts)


def _count(key: str) -> None:
    with _COUNTS_LOCK:
        _counts[key] += 1


def _hold_pool(graph, nbytes: int) -> None:
    """Count one capture whose pool reserved `nbytes`, held until `graph`
    is collected."""
    with _COUNTS_LOCK:
        _counts["captures"] += 1
        _counts["pool_bytes_live"] += nbytes
        _counts["pool_bytes_peak"] = max(_counts["pool_bytes_peak"], _counts["pool_bytes_live"])
    weakref.finalize(graph, _release_pool, nbytes)


def _release_pool(nbytes: int) -> None:
    with _COUNTS_LOCK:
        _counts["pool_bytes_live"] -= nbytes


def bucket_capacity(n: int) -> int:
    """Smallest power of two >= n, and >= _MIN_CAPACITY (the JAX package's
    buckets: a capacity learned from one run holds some growth)."""
    cap = _MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def active() -> Optional["CompileContext"]:
    """The capacity-mode context of this thread, or None (eager)."""
    return getattr(_STATE, "ctx", None)


def tracing() -> bool:
    return active() is not None


def eager_reads() -> int:
    """How many variable-size sites have read their count on the host
    eagerly (outside capacity mode), in this process."""
    return _eager_reads


def note_eager_read() -> None:
    """One more eager read of a site's count (oracle_capacity's, or a
    kernel's that hands its count to the host: K9, K5)."""
    global _eager_reads
    with _EAGER_READS_LOCK:
        _eager_reads += 1


class PlanNotCompilable(Exception):
    """Raised when the plan holds an operator with no capacity form
    (read-write and MVCC operators, imports, exports, prints), a source
    that changed under a run, or no base table. An IndexScan has one: its
    TableScan fallback (ops/index_scan.py)."""


_UNCOMPILABLE = ("Insert", "Delete", "Update", "ImportCsv", "ImportBinary",
                 "ExportCsv", "ExportBinary", "Print")


class CompileContext:
    """Per-run state: capacities by call-site sequence number (shared with
    the CompiledQuery, so a first run appends the sites it meets), the
    recorded counts and labels, the pinned source tables and the query's
    uploaded constants."""

    def __init__(self, caps: List[int], sources=(), constants: Optional[dict] = None):
        self.caps = caps
        self.sources = {id(t) for t in sources}
        self.constants = {} if constants is None else constants
        self.site = 0
        self.counts: List[torch.Tensor] = []
        self.labels: List[str] = []
        # (label, 0-dim tensor that must read 0): a kernel's refusal, read
        # with the counts
        self.checks: List[Tuple[str, torch.Tensor]] = []
        # (label, 0-dim tensor): values read with the counts for the caller's
        # statistics (an exchange's rows a shard), held to no capacity
        self.stats: List[Tuple[str, torch.Tensor]] = []

    def reserve(self, bound: Optional[int], estimate: Optional[int], label: str) -> int:
        """The capacity of the next call site."""
        i = self.site
        self.site += 1
        self.labels.append(label)
        if i < len(self.caps):
            return self.caps[i]
        if estimate is None:
            estimate = bound
        assert estimate is not None, f"oracle site {label!r} needs a bound or an estimate"
        if bound is not None:
            estimate = min(estimate, bound)
        cap = bucket_capacity(max(int(estimate), 1))
        self.caps.append(cap)
        return cap

    def record(self, count: torch.Tensor, cap: int) -> torch.Tensor:
        """Keep the site's count for the host's check; the plan goes on with
        it clamped to the capacity (an overflowed run is run again, and an
        unclamped count would point gathers past the buffers)."""
        count = count.reshape(()).to(torch.int64)
        self.counts.append(count)
        return count.clamp(max=cap)

    def check(self, failed: torch.Tensor, label: str) -> None:
        """A device flag that fails the run when it reads nonzero."""
        self.checks.append((label, failed.reshape(()).to(torch.int64)))

    def stat(self, value: torch.Tensor, label: str) -> None:
        """A device value read with the counts, for statistics only."""
        self.stats.append((label, value.reshape(()).to(torch.int64)))


@contextlib.contextmanager
def _activation(ctx: CompileContext):
    if active() is not None:
        raise RuntimeError("nested plan compilation is not supported")
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = None


def oracle_capacity(count, *, bound: Optional[int] = None,
                    estimate: Optional[int] = None, label: str = ""):
    """(count, capacity) for a variable-size output of `count` rows.

    Eager: reads the count (one device->host round trip) and returns it as
    both. Capacity mode: the count stays on the device, clamped to this
    site's capacity."""
    ctx = active()
    if ctx is None:
        note_eager_read()
        c = int(count)
        return c, c
    cap = ctx.reserve(bound, estimate, label)
    return ctx.record(torch.as_tensor(count), cap), cap


def oracle_compact(mask: torch.Tensor, label: str, estimate: Optional[int] = None):
    """Capacity mode's stream compaction: (int64 positions of the True rows
    of `mask`, padded with 0 to this site's capacity; their count clamped to
    it), through the K9 capacity form, which writes the count itself. A
    first run sizes the site by `estimate`, else by the mask's length."""
    from hyrise_tpu_torch.kernels.compact import compact_indices_cap

    ctx = active()
    cap = ctx.reserve(int(mask.shape[0]), estimate, label)
    indices, count = compact_indices_cap(mask.contiguous(), cap)
    return indices, ctx.record(count, cap)


@contextlib.contextmanager
def _syncs_allowed():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`values` (host) as a tensor on `device`. In capacity mode one upload
    per content and query: the captured graph reads the tensor the
    uncaptured run made (an upload cannot be captured), and a dictionary
    rewrite's table is uploaded once."""
    ctx = active()
    device = torch.device(device)
    if ctx is None:
        return torch.as_tensor(values, dtype=dtype, device=device)
    arr = np.ascontiguousarray(np.asarray(values))
    key = (str(dtype), str(device), arr.dtype.str, arr.shape,
           hashlib.sha1(arr.tobytes()).hexdigest())
    t = ctx.constants.get(key)
    if t is None:
        if device.type == "cuda":
            with _syncs_allowed():
                t = torch.as_tensor(arr, dtype=dtype, device=device)
        else:
            t = torch.as_tensor(arr, dtype=dtype, device=device)
        ctx.constants[key] = t
    return t


def _walk(root):
    seen, order = set(), []

    def rec(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.inputs:
            rec(i)
        order.append(op)

    rec(root)
    return order


@dataclasses.dataclass
class _ColMeta:
    name: str
    dtype: object
    dictionary: Optional[np.ndarray]
    unique: bool = False
    val_range: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def _sync_errors(on: bool):
    """torch.cuda.set_sync_debug_mode("error") while on and this is the
    process's only thread: a synchronising call raises. The mode is
    process-wide, so with other threads (server sessions, the scheduler's
    workers) it stays off, lest their eager work raise; the capture that
    follows (capture_error_mode="thread_local") still refuses any host
    read of this thread's plan."""
    if not on or threading.active_count() > 1:
        yield False
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield True
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CompiledQuery:
    """An operator DAG run in capacity mode: a CUDA graph on the card,
    uncaptured on the CPU.

    Usage:
        cq = CompiledQuery(root_op, catalog)
        table = cq.run()   # first call: learn, capture, replay (and
                           # overflow retries); later calls: one replay

    `caps` are the capacities by site, `last_counts` what the last run (or
    replay) counted, as the host read it: the sites' counts in site order
    (`labels`), the checks' flags, and the result's rows; `last_retries` the
    overflow retries of the last run, `captures` and `replays` count graph
    captures and replays, `pool_mb` is the device memory the last capture
    reserved (`compiled_counts()` sums both counts and the pools over every
    CompiledQuery), and
    `capture_launches` the launches of each kernel wrapper during it (a
    replay launches them again without the wrappers seeing it;
    `launches_captured` and `launches_replayed` sum them over every capture
    and every replay), `host_reads` the device->host reads of counts the
    last run made (one for a replay). `lock` is held through a run: a
    graph's buffers serve one caller at a time.

    The streamed forms (plan/blocked.py) drive the steps themselves:
    `learn`, `capture`, then `replay` once a block with no host read (the
    counts stay on the device), `read_counts`, `grow` and `shrink` over the
    counts of every block, `drop_graph`. The distributed form
    (parallel/dist_compiler.py) runs its own executor through
    `_plan_output` over the sources `_resolve_sources` names."""

    MAX_RETRIES = 12

    def __init__(self, root, catalog=None):
        self.root = root
        self.catalog = catalog
        self.ops = _walk(root)
        for op in self.ops:
            if op.name in _UNCOMPILABLE:
                raise PlanNotCompilable(op.name)
        self._sources = self._resolve_sources()
        if not self._sources:
            raise PlanNotCompilable("no base tables")
        self.device = self._sources[0].device
        self.caps: List[int] = []
        self.last_counts: List[int] = []
        self._labels: List[str] = []
        self._check_labels: List[str] = []
        self._out_meta: Optional[List[_ColMeta]] = None
        self._constants: dict = {}
        self.last_retries = 0
        # device->host reads of counts in the last run: 1 for a replay
        self.host_reads = 0
        self.captures = 0
        self.replays = 0
        self.pool_mb = 0.0
        # whether the last learning run ran under the sync check
        self.sync_checked = False
        self.capture_launches: Dict[str, int] = {}
        # summed over every capture, and over every replay (the launches a
        # replay makes are its capture's)
        self.launches_captured: Dict[str, int] = {}
        self.launches_replayed: Dict[str, int] = {}
        self._graph = None
        self._graph_outputs = None
        self.lock = threading.RLock()

    # -- sources ----------------------------------------------------------------

    def _resolve_sources(self) -> list:
        """The base tables the plan reads now, each once; MVCC tables are
        refused (Validate reads the snapshot on the host)."""
        from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper

        sources, seen = [], set()
        for op in self.ops:
            if isinstance(op, GetTable):
                t = op.catalog.get_table(op.table_name)
            elif isinstance(op, TableWrapper):
                t = op.table
            else:
                continue
            if id(t) in seen:
                continue
            if t.mvcc is not None:
                raise PlanNotCompilable("MVCC table " + t.name)
            seen.add(id(t))
            sources.append(t)
        return sources

    def refresh_sources(self) -> None:
        """A table replaced in the catalog since the last run is pinned
        anew, and the graph, which reads the old one's tensors, is dropped."""
        now = self._resolve_sources()
        if [id(t) for t in now] != [id(t) for t in self._sources]:
            self._sources = now
            self.drop_graph()
            self._constants = {}

    # -- execution --------------------------------------------------------------

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _plan_output(self):
        """The plan's result, run in the active capacity-mode context (the
        distributed form runs its shards and exchanges here)."""
        from hyrise_tpu_torch.ops.base import execute_plan

        return execute_plan(self.root)

    def _execute(self, learning: bool):
        """One capacity-mode run of the plan: (output data, output validity,
        counts [sites..., checks..., stats..., n_rows] on the device)."""
        from hyrise_tpu_torch.ops.materialize import ensure_prefix

        ctx = CompileContext(self.caps, self._sources, self._constants)
        for op in self.ops:
            op.clear_output()
        with _activation(ctx), \
                _sync_errors(learning and self.on_cuda) as checked:
            if learning:
                self.sync_checked = checked
            out = ensure_prefix(self._plan_output())
            datas = [c.data for c in out.columns]
            valids = [c.validity for c in out.columns]
            n = out.num_rows
            if not isinstance(n, torch.Tensor):
                n = torch.full((), n, dtype=torch.int64, device=self.device)
            counts = torch.stack(ctx.counts + [f for _, f in ctx.checks]
                                 + [v for _, v in ctx.stats]
                                 + [n.reshape(()).to(torch.int64)])
        self._out_meta = [_ColMeta(c.name, c.dtype, c.dictionary, bool(c.unique),
                                   c.val_range if isinstance(c.val_range, tuple) else None)
                          for c in out.columns]
        self._labels = ctx.labels
        self._check_labels = [label for label, _ in ctx.checks]
        for op in self.ops:
            op.clear_output()  # the graph keeps what it needs
        return datas, valids, counts

    def capture(self) -> None:
        """Capture the plan as a graph on the card, into a pool of its own
        (a learning run must have met every site first)."""
        from hyrise_tpu_torch.kernels.build import launch_counts

        self.drop_graph()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  capture_error_mode="thread_local"):
                outputs = self._execute(learning=False)
        after = launch_counts()
        self.capture_launches = {k: after[k] - before.get(k, 0) for k in after
                                 if after[k] != before.get(k, 0)}
        for k, v in self.capture_launches.items():
            self.launches_captured[k] = self.launches_captured.get(k, 0) + v
        nbytes = torch.cuda.memory_reserved(self.device) - reserved
        self.pool_mb = nbytes / 2**20
        self._graph, self._graph_outputs = graph, outputs
        self.captures += 1
        _hold_pool(graph, nbytes)

    def run(self, tighten: bool = True):
        """The plan's result. A capacity overflow raises that site's
        capacity to the observed count and runs (and on CUDA captures)
        again; with `tighten`, capacities are shrunk to the observed counts
        before a capture, or for the next run on the CPU."""
        from hyrise_tpu_torch.storage.table import Table

        # the steps' spans (utils/spans.py): compiled.wait for the lock (a
        # caller of the same text), .learn, .capture, .replay (the host's
        # launch), .read (the host waits on the device), .columns; .learn
        # carries `retry` (the overflows of this run before it), .capture
        # `bytes` (its pool)
        with spans.span("compiled.wait"):
            self.lock.acquire()
        try:
            self.refresh_sources()
            self.last_retries = 0
            self.host_reads = 0
            for _ in range(self.MAX_RETRIES):
                if self._graph is None:
                    with spans.span("compiled.learn") as s:
                        s.set("retry", self.last_retries)
                        learned = self.learn(tighten)
                    if learned is None:
                        continue
                    if not self.on_cuda:
                        n = self.last_counts[-1]
                        with spans.span("compiled.columns"):
                            return Table(self._make_columns(learned, n), n)
                    with spans.span("compiled.capture") as s:
                        self.capture()
                        s.set("bytes", int(self.pool_mb * 2**20))  # exact
                with spans.span("compiled.replay", cpu=True):
                    outputs = self.replay()
                with spans.span("compiled.read"):
                    counts = self.read_counts(outputs[2])
                if self.grow(counts):
                    self.drop_graph()
                    continue
                with spans.span("compiled.columns"):
                    return Table(self._make_columns(outputs, counts[-1]), counts[-1])
            raise RuntimeError("capacity retry limit exceeded: "
                               + str(list(zip(self._labels, self.caps))))
        finally:
            self.lock.release()

    # -- the hooks of the streamed forms (plan/blocked.py) -----------------------

    def learn(self, tighten: bool):
        """One uncaptured capacity-mode run over the sources' current
        contents (under the sync check on the card) and one host read of
        its counts: the outputs, or None after an overflow, which raised
        the sites' capacities. With `tighten`, capacities then shrink to
        the counts."""
        _count("learning_runs")
        outputs = self._execute(learning=True)
        counts = self.read_counts(outputs[2])
        if self.grow(counts):
            return None
        if tighten:
            self.shrink(counts[:len(self._labels)])
        return outputs

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def drop_graph(self) -> None:
        """Forget the graph: the next run learns and captures again."""
        self._graph = self._graph_outputs = None

    def replay(self):
        """One run over the sources' current contents with no host read:
        (output data, output validity, counts [sites..., checks..., n_rows]),
        all on the device, which the next replay overwrites. On the card the
        captured graph replays on the current stream, after what was enqueued
        there before (a source refilled in place); on the CPU the plan runs
        uncaptured in capacity mode."""
        if not self.on_cuda:
            return self._execute(learning=True)
        self._graph.replay()
        self.replays += 1
        for k, v in self.capture_launches.items():
            self.launches_replayed[k] = self.launches_replayed.get(k, 0) + v
        return self._graph_outputs

    def read_counts(self, counts: torch.Tensor) -> list:
        """The host read of a run's counts vector, or of every block's
        stacked (`host_reads`, `last_counts`)."""
        self.host_reads += 1
        self.last_counts = counts.tolist()
        return self.last_counts

    def grow(self, counts: List[int]) -> bool:
        """Raise every overflowed site's capacity; whether any was. A failed
        check raises."""
        n_sites = len(self._labels)
        for label, flag in zip(self._check_labels, counts[n_sites:]):
            if flag:
                raise ValueError(f"{label}: refused by the kernel")
        overflow = [i for i, c in enumerate(counts[:n_sites])
                    if i < len(self.caps) and c > self.caps[i]]
        for i in overflow:
            self.caps[i] = bucket_capacity(max(int(counts[i]), 1))
        if overflow:
            self.last_retries += 1
            _count("retries")
        return bool(overflow)

    def shrink(self, counts: List[int]) -> None:
        """Shrink every site's capacity to the bucket of its count."""
        for i, c in enumerate(counts):
            if i >= len(self.caps):
                break
            self.caps[i] = min(self.caps[i], bucket_capacity(max(int(c), 1)))

    def _make_columns(self, outputs, n: int) -> list:
        """The first n rows of every output column, copied (a replay
        overwrites the graph's buffers)."""
        from hyrise_tpu_torch.storage.column import Column

        datas, valids, _ = outputs
        return [Column(m.name, m.dtype, d[:n].clone(),
                       None if v is None else v[:n].clone(), m.dictionary,
                       unique=m.unique, val_range=m.val_range)
                for m, d, v in zip(self._out_meta, datas, valids)]

    @property
    def output_meta(self) -> List[_ColMeta]:
        """Name, type and metadata of each output column of the last run."""
        return list(self._out_meta)

    @property
    def labels(self) -> List[str]:
        """The label of every site of the last run, in site order."""
        return list(self._labels)
