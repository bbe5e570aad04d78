"""SQL pipeline: parse -> translate -> optimize -> physical plan -> execute.

Port of hyrise_tpu/sql/pipeline.py. Whole-plan compiled execution
(with_compiled_execution, or HYRISE_COMPILED=1) runs a read-only
statement's plan as a plan/compiler.py CompiledQuery, kept per cached text;
a plan it refuses runs eagerly. Not carried over: the JAX form's capacity
seeds, which carry XLA's static shapes between processes. Distributed
execution (with_distributed_execution) runs each read-only statement's plan
through parallel/dist_compiler.py's DistributedQuery over a ShardedCatalog,
a query object per caller on the tree translated for that caller (the JAX
form keeps one on the shared plan object: ROADMAP C19). A plan it cannot
distribute runs single-node. With both, a statement runs as a
DistributedCompiledQuery, kept per cached text and ShardedCatalog as a
CompiledQuery is (the JAX pipeline's route; its lock serves one caller at a
time). There is no default catalog: create_pipeline()
without with_catalog() raises, and the catalog's own TransactionManager
serves its transactions unless with_transaction_manager() names another.

Transactions: with_mvcc(True) puts a Validate over every stored MVCC table
of a statement's plan (its scalar subqueries' too) and runs the statement
in a transaction: the one with_transaction_context() gives, else a new one.
INSERT, UPDATE and DELETE always run in one, and a new one commits when the
statement succeeds and rolls back when it raises (auto-commit).

Reference: src/lib/sql/ —
- SQLPipelineBuilder (sql_pipeline_builder.*): fluent config (disable MVCC,
  custom optimizer, plan cache).
- SQLPipeline / SQLPipelineStatement (sql_pipeline_statement.cpp:49-283):
  per-statement stages with metrics (parse/translate/optimize/compile/
  execute micros), query-plan cache keyed by SQL text, prepared statements
  with parameter substitution, auto-commit for DML.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.optimizer import Optimizer
from hyrise_tpu_torch.plan.translator import translate_lqp
from hyrise_tpu_torch.sql import parser as P
from hyrise_tpu_torch.sql.translator import (ScalarSubquery, SQLToLQPTranslator,
                                       SQLTranslationError)
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans


@dataclasses.dataclass
class StatementMetrics:
    """Reference: SQLPipelineStatementMetrics (sql_pipeline.hpp:17-25). Each
    duration is its stage's span (utils/spans.py: `parse`, `translate`,
    `optimize`, `plan`, `execute`), timed whether or not the recorder is on;
    `span_id` is the id of the statement's span while the recorder is on,
    which every span of the statement and of its result's decode carries as
    `statement`."""

    parse_s: float = 0.0
    translate_s: float = 0.0
    optimize_s: float = 0.0
    compile_s: float = 0.0
    execute_s: float = 0.0  # taken after the device has finished
    cache_hit: bool = False
    span_id: Optional[int] = None


class SQLQueryCache:
    """Reference: sql/sql_query_cache.hpp with pluggable eviction policies —
    lru_cache.hpp, lru_k_cache.hpp, gds_cache.hpp, gdfs_cache.hpp,
    random_cache.hpp. Policies:

    - 'lru': least recently used.
    - 'lru_k': evict by oldest K-th most recent access (K=2); entries with
      fewer than K accesses are evicted first (classic LRU-K).
    - 'gds': greedy-dual size — priority = clock + cost/size; on eviction
      the clock advances to the evicted priority (cost/size per entry are
      optional put() args, both 1.0 by default).
    - 'gdfs': greedy-dual frequency-size — priority = clock +
      frequency * cost / size.
    - 'random'.
    """

    K = 2  # LRU-K history depth

    def __init__(self, capacity: int = 256, policy: str = "lru"):
        assert policy in ("lru", "lru_k", "gds", "gdfs", "random")
        self.capacity = capacity
        self.policy = policy
        self._d: OrderedDict = OrderedDict()
        self._freq: Dict = {}
        self._hist: Dict = {}        # lru_k: last K access tick times
        self._cost_size: Dict = {}   # gds/gdfs: (cost, size)
        self._prio: Dict = {}        # gds/gdfs: cached priority
        self._clock = 0.0
        self._tick = 0
        self._lock = threading.Lock()  # sessions and threads share the cache

    def _touch(self, key):
        self._tick += 1
        if self.policy == "lru":
            self._d.move_to_end(key)
        elif self.policy == "lru_k":
            h = self._hist.setdefault(key, [])
            h.append(self._tick)
            del h[:-self.K]
        elif self.policy in ("gds", "gdfs"):
            self._freq[key] = self._freq.get(key, 0) + 1
            cost, size = self._cost_size.get(key, (1.0, 1.0))
            f = self._freq[key] if self.policy == "gdfs" else 1.0
            self._prio[key] = self._clock + f * cost / size

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._touch(key)
            return self._d[key]

    def put(self, key, value, cost: float = 1.0, size: float = 1.0):
        with self._lock:
            self._d[key] = value
            if self.policy in ("gds", "gdfs"):
                self._cost_size[key] = (cost, size)
            self._touch(key)
            while len(self._d) > self.capacity:
                self._evict()

    def _evict(self):
        if self.policy == "lru":
            k, _ = self._d.popitem(last=False)
        elif self.policy == "random":
            import random
            k = random.choice(list(self._d))
            del self._d[k]
        elif self.policy == "lru_k":
            # oldest K-th-most-recent access; short histories evict first
            def kth(key):
                h = self._hist.get(key, [])
                return (0, h[-1] if h else 0) if len(h) < self.K \
                    else (1, h[0])
            k = min(self._d, key=kth)
            del self._d[k]
        else:  # gds / gdfs: evict minimum priority, advance the clock to it
            k = min(self._d, key=lambda x: self._prio.get(x, 0.0))
            self._clock = self._prio.get(k, self._clock)
            del self._d[k]
        self._freq.pop(k, None)
        self._hist.pop(k, None)
        self._cost_size.pop(k, None)
        self._prio.pop(k, None)

    def clear(self):
        with self._lock:
            for d in (self._d, self._freq, self._hist, self._cost_size,
                      self._prio):
                d.clear()


_plan_cache = SQLQueryCache()
# CompiledQuerys of cacheable read-only statements per catalog (kept on it,
# Catalog.compiled), at most this many a catalog, least recently used out
COMPILED_CACHE_CAPACITY = 64
_compiled_cache_lock = threading.Lock()


def _compiled_cache(catalog: Catalog) -> SQLQueryCache:
    """The catalog's cache of compiled statements: (text, statement) ->
    (catalog version, CompiledQuery). Each CompiledQuery holds its captured
    graph and a lock, so callers of one entry run one after another and
    never share its buffers."""
    with _compiled_cache_lock:
        cache = catalog.compiled.get("sql")
        if cache is None:
            cache = catalog.compiled["sql"] = SQLQueryCache(capacity=COMPILED_CACHE_CAPACITY)
        return cache


# the prepared statements of callers that bring no map of their own
# (SQLPipelineBuilder.with_prepared); a session keeps its own, as
# PostgreSQL scopes prepared statements to a session
_prepared: Dict[str, object] = {}


class UnknownPreparedStatement(SQLTranslationError):
    """EXECUTE of a name that this caller's map does not hold."""


def prepared_statement(name: str, prepared: Optional[Dict[str, object]] = None):
    """The parse tree PREPARE stored under `name` in `prepared` (the
    process-wide map when None), or None."""
    return (_prepared if prepared is None else prepared).get(name)


def _ok_table(device) -> Table:
    return Table.from_arrays(
        "ok", [TableColumnDefinition("ok", DataType.INT32)],
        [np.array([], dtype=np.int32)], device=device)


_DML = (P.InsertStmt, P.UpdateStmt, P.DeleteStmt)


class SQLPipelineStatement:
    def __init__(self, stmt, sql_text: str, catalog: Catalog,
                 optimizer: Optional[Optimizer], use_cache: bool,
                 params: Optional[List[object]] = None, position: int = 0,
                 use_mvcc: bool = False, transaction_manager=None, context=None,
                 prepared: Optional[Dict[str, object]] = None, dist_catalog=None,
                 use_compiled: bool = False):
        self.stmt = stmt
        self.sql_text = sql_text
        self.position = position  # of the statement within sql_text
        self.catalog = catalog
        self.optimizer = optimizer or Optimizer()
        self.use_cache = use_cache
        self.params = params
        self.use_mvcc = use_mvcc
        self.tm = transaction_manager or catalog.transaction_manager
        self.context = context
        self.prepared = _prepared if prepared is None else prepared
        self.dist_catalog = dist_catalog
        # the DistributedQuery of the last execution, or None (single-node)
        self.last_dist_query = None
        self.use_compiled = use_compiled
        # whether the last execution ran as a CompiledQuery (plan/compiler.py)
        self.last_compiled = False
        self.last_compiled_query = None
        self.metrics = StatementMetrics()
        # the pipeline's parse, recorded as this statement's first span (the
        # first statement of its text)
        self.parse_span: Optional[spans.Span] = None

    # -- stages --------------------------------------------------------------

    def get_lqp(self) -> L.LQPNode:
        with spans.stage("translate") as stage:
            tr = SQLToLQPTranslator(self.catalog, params=self.params)
            lqp = tr.translate(self.stmt)
            if self.use_mvcc:
                lqp = self._insert_validates(lqp)
        self.metrics.translate_s = stage.seconds
        return lqp

    def _insert_validates(self, root: L.LQPNode) -> L.LQPNode:
        """A ValidateNode over every stored MVCC table (the reference's SQL
        translator adds one to each table reference when MVCC is on): the
        source of an INSERT ... SELECT and the subqueries of a DELETE or
        UPDATE too, but not the rows a DELETE or UPDATE changes, which the
        translator already reads through a Validate with their row ids."""
        own_validate = set()
        if isinstance(root, (L.DeleteNode, L.UpdateNode)):
            def mark(n: L.LQPNode) -> L.LQPNode:
                if isinstance(n, L.AddRowIdsNode) and \
                        isinstance(n.children[0], L.StoredTableNode):
                    own_validate.add(id(n.children[0]))
                return n
            L.map_lqp(root, mark)

        def visit(n: L.LQPNode) -> L.LQPNode:
            if isinstance(n, L.StoredTableNode) and id(n) not in own_validate and \
                    self.catalog.has_table(n.table_name) and \
                    self.catalog.get_table(n.table_name).mvcc is not None:
                return L.ValidateNode(n)
            return n

        return L.map_lqp(root, visit)

    def get_optimized_lqp(self) -> L.LQPNode:
        lqp = self.get_lqp()
        with spans.stage("optimize") as stage:
            if not self.optimizer.stats:
                self.optimizer.stats = self.catalog.all_statistics()
            out = self.optimizer.optimize(lqp, self.catalog)
        self.metrics.optimize_s = stage.seconds
        return out

    def _resolve_scalar_subqueries(self, lqp: L.LQPNode, context) -> bool:
        """Execute ScalarSubquery placeholders, substitute their values as
        literals (ast.ComputedValue; the reference's uncorrelated
        PQPSelectExpression evaluation).
        Under MVCC a subquery validates its tables too. Returns whether
        there was one."""
        found = [False]

        def fix_expr(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ScalarSubquery):
                found[0] = True
                sub = e.lqp
                if self.use_mvcc:
                    sub = self._insert_validates(sub)
                sub_plan = translate_lqp(
                    self.optimizer.optimize(sub, self.catalog), self.catalog)
                return ast.ComputedValue(self._scalar_value(execute_plan(sub_plan, context)))
            for attr in ("left", "right", "value", "lower", "upper"):
                if hasattr(e, attr) and isinstance(getattr(e, attr), ast.Expr):
                    setattr(e, attr, fix_expr(getattr(e, attr)))
            return e

        def visit(n: L.LQPNode) -> L.LQPNode:
            if isinstance(n, L.PredicateNode):
                n.predicate = fix_expr(n.predicate)
            if isinstance(n, L.ProjectionNode):
                n.outputs = [o if isinstance(o, str) else (o[0], fix_expr(o[1]))
                             for o in n.outputs]
            return n

        L.map_lqp(lqp, visit)
        return found[0]

    def _scalar_value(self, t: Table):
        """The value a scalar subquery's result `t` stands for in the plan."""
        if t.num_rows == 0:
            return None  # SQL: an empty scalar subquery evaluates to NULL
        v = t._decode_col(t.columns[0])[0]
        if v is not None and not isinstance(v, str):
            v = float(v) if hasattr(v, "__float__") and \
                not isinstance(v, (int,)) else v
        return v if not hasattr(v, "item") else v.item()

    def get_physical_plan(self, context=None):
        # The cache keeps what callers can share: the optimized LQP, with
        # the literals its scalar subqueries resolved to, and translates a
        # physical plan of its own for every caller (the reference
        # deep-copies a cached PQP): operators hold their outputs, so two
        # callers of one tree would overwrite each other's. The key carries
        # the statement's position (sql_text is the whole pipeline's text:
        # without it every statement of one text would share the first
        # one's plan), whether MVCC is on (a plan without Validate shows
        # rows a transaction must not see) and the catalog's id; the entry
        # holds a weak reference to the catalog itself: an id can be reused
        # once its catalog is gone. An LQP whose scalar subqueries were
        # resolved into literals also keeps what they read: the catalog's
        # version and the snapshot. DML is never cached.
        cache_key = (self.sql_text, self.position, self.use_mvcc, id(self.catalog))
        cacheable = self.use_cache and self.params is None and \
            not isinstance(self.stmt, _DML)
        read_at = (self.catalog.version,
                   None if context is None else context.snapshot_commit_id)
        lqp = None
        if cacheable:
            cached = _plan_cache.get(cache_key)
            if cached is not None and cached[0]() is self.catalog and \
                    cached[2] in (None, read_at):
                self.metrics.cache_hit = True
                lqp = cached[1]
        if lqp is None:
            lqp = self.get_optimized_lqp()
            resolved = self._resolve_scalar_subqueries(lqp, context)
            if cacheable:
                _plan_cache.put(cache_key, (weakref.ref(self.catalog), lqp,
                                            read_at if resolved else None))
        with spans.stage("plan") as stage:
            plan = translate_lqp(lqp, self.catalog)
        self.metrics.compile_s = stage.seconds
        return plan

    def execute(self) -> Table:
        """Run the statement: its result (which carries the statement's span
        id while the recorder is on)."""
        with spans.statement(self.position, self.parse_span) as span:
            self.metrics.span_id = span.id
            result = self._execute()
        if span:
            result.statement = self.metrics.span_id
        return result

    def _execute(self) -> Table:
        if isinstance(self.stmt, P.ExplainStmt):
            inner = SQLPipelineStatement(
                self.stmt.stmt, self.sql_text, self.catalog, self.optimizer,
                use_cache=False, params=self.params, use_mvcc=self.use_mvcc,
                transaction_manager=self.tm, context=self.context,
                prepared=self.prepared)
            lqp = inner.get_optimized_lqp()
            lines = np.array(lqp.describe().split("\n"), dtype=object)
            return Table.from_arrays(
                "explain", [TableColumnDefinition("plan", DataType.STRING)],
                [lines], device=self.catalog.device)
        # prepared statements
        if isinstance(self.stmt, P.PrepareStmt):
            self.prepared[self.stmt.name] = self.stmt.stmt
            return _ok_table(self.catalog.device)
        if isinstance(self.stmt, P.ExecuteStmt):
            inner = self.prepared.get(self.stmt.name)
            if inner is None:
                raise UnknownPreparedStatement(
                    f"no prepared statement {self.stmt.name!r}")
            vals = []
            for p in self.stmt.params:
                if isinstance(p, P.ELiteral):
                    vals.append(p.value)
                elif isinstance(p, P.EUnary) and p.op == "-" and \
                        isinstance(p.value, P.ELiteral):
                    vals.append(-p.value.value)
                else:
                    raise SQLTranslationError("EXECUTE params must be literals")
            sub = SQLPipelineStatement(
                inner, self.sql_text + repr(vals), self.catalog,
                self.optimizer, use_cache=False, params=vals,
                use_mvcc=self.use_mvcc, transaction_manager=self.tm,
                context=self.context, prepared=self.prepared,
                dist_catalog=self.dist_catalog, use_compiled=self.use_compiled)
            out = sub.execute()
            self.metrics = sub.metrics
            self.last_compiled = sub.last_compiled
            return out

        is_dml = isinstance(self.stmt, _DML)
        context = self.context
        auto_commit = False
        if context is None and (is_dml or self.use_mvcc):
            context = self.tm.new_transaction_context()
            auto_commit = is_dml
        try:
            needs_tx = is_dml or self.use_mvcc
            compiled = self._cached_compiled(needs_tx)
            plan = compiled.root if compiled is not None else self.get_physical_plan(context)
            self.last_plan = plan  # retained for profiling / visualization
            with spans.stage("execute", cpu=False) as stage:
                result = self._execute_plan(plan, context, needs_tx, compiled)
                if result.device.type == "cuda":
                    with spans.span("execute.sync"):
                        torch.cuda.synchronize(result.device)
        except BaseException:
            if auto_commit:
                context.rollback()
            raise
        self.metrics.execute_s = stage.seconds
        if auto_commit:
            context.commit()
        return result

    def _distributed(self, needs_tx: bool) -> bool:
        """Whether this execution runs over the ShardedCatalog: it is set,
        its copies are current (ShardedCatalog.is_current: a write since
        they were taken, this pipeline's own too, is not in them) and the
        statement needs no transaction."""
        return self.dist_catalog is not None and not needs_tx and \
            self.dist_catalog.is_current(self.catalog)

    def _compiled_key(self, needs_tx: bool) -> tuple:
        key = (self.sql_text, self.position)
        return key + (id(self.dist_catalog),) if self._distributed(needs_tx) else key

    def _cached_compiled(self, needs_tx: bool):
        """The cached CompiledQuery of this statement (a
        DistributedCompiledQuery over the ShardedCatalog where the
        statement runs distributed), when compiled execution applies and
        one was made at this catalog version."""
        if not self.use_compiled or needs_tx or self.params is not None or \
                not self.use_cache or isinstance(self.stmt, _DML):
            return None
        entry = _compiled_cache(self.catalog).get(self._compiled_key(needs_tx))
        if entry is None or entry[0] != self.catalog.version or \
                getattr(entry[1], "shard_cat", None) is not (
                    self.dist_catalog if self._distributed(needs_tx) else None):
            return None
        self.metrics.cache_hit = True
        return entry[1]

    def _execute_plan(self, plan, context, needs_tx: bool, compiled=None) -> Table:
        """A read-only plan over the ShardedCatalog where it runs
        distributed (_distributed): with compiled execution on, as a
        DistributedCompiledQuery cached with its captured graph for the next
        caller of the text, else (and where that refuses the plan) as a
        DistributedQuery. Otherwise, or where the plan cannot be
        distributed, with compiled execution on as a CompiledQuery
        (plan/compiler.py), cached likewise; otherwise, and for statements
        that need a transaction or cannot compile, eagerly on one device."""
        from hyrise_tpu_torch.plan.compiler import CompiledQuery, PlanNotCompilable, _walk

        self.last_dist_query = None
        self.last_compiled = False
        self.last_compiled_query = None
        cacheable = self.use_cache and self.params is None
        if self._distributed(needs_tx):
            from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery,
                                                                 DistributedQuery)
            if self.use_compiled:
                try:
                    dq = compiled if compiled is not None else \
                        DistributedCompiledQuery(plan, self.dist_catalog)
                    out = dq.run()
                except PlanNotCompilable:
                    for op in _walk(plan):
                        op.clear_output()
                else:
                    if compiled is None and cacheable:
                        _compiled_cache(self.catalog).put(self._compiled_key(needs_tx),
                                                          (self.catalog.version, dq))
                    self.last_dist_query = dq
                    self.last_compiled, self.last_compiled_query = True, dq
                    return out
            try:
                dq = DistributedQuery(plan, self.dist_catalog)
            except PlanNotCompilable:
                pass
            else:
                self.last_dist_query = dq
                return dq.run()
            compiled = None
        if self.use_compiled and not needs_tx:
            try:
                cq = compiled if compiled is not None else CompiledQuery(plan, self.catalog)
                out = cq.run()
            except PlanNotCompilable:
                for op in _walk(plan):
                    op.clear_output()
            else:
                if compiled is None and cacheable:
                    _compiled_cache(self.catalog).put((self.sql_text, self.position),
                                                      (self.catalog.version, cq))
                self.last_compiled, self.last_compiled_query = True, cq
                return out
        return execute_plan(plan, context)


class SQLPipeline:
    """Multi-statement pipeline (reference: sql_pipeline.cpp)."""

    def __init__(self, sql: str, catalog: Catalog,
                 optimizer: Optional[Optimizer], use_cache: bool,
                 params: Optional[List[object]] = None, use_mvcc: bool = False,
                 transaction_manager=None, context=None,
                 prepared: Optional[Dict[str, object]] = None, dist_catalog=None,
                 use_compiled: bool = False):
        self._parse = spans.stage("parse", keep=False)
        with self._parse:
            self.statements = P.parse_sql(sql)
        self.parse_s = self._parse.seconds
        self._sql = sql
        self._args = (catalog, optimizer, use_cache, params)
        self._transactions = dict(use_mvcc=use_mvcc,
                                  transaction_manager=transaction_manager,
                                  context=context, prepared=prepared,
                                  dist_catalog=dist_catalog, use_compiled=use_compiled)
        self.pipeline_statements: List[SQLPipelineStatement] = []

    def execute_statements(self) -> Iterator[Tuple[SQLPipelineStatement, Table]]:
        """Run the statements in order, yielding each with its result as
        soon as it has run (a server answers statement by statement)."""
        catalog, optimizer, use_cache, params = self._args
        for position, stmt in enumerate(self.statements):
            ps = SQLPipelineStatement(stmt, self._sql, catalog, optimizer,
                                      use_cache, params=params, position=position,
                                      **self._transactions)
            ps.metrics.parse_s = self.parse_s / max(len(self.statements), 1)
            if position == 0:
                ps.parse_span = self._parse
            self.pipeline_statements.append(ps)
            yield ps, ps.execute()

    def get_result_table(self) -> Table:
        result: Optional[Table] = None
        for _, result in self.execute_statements():
            pass
        if result is None:
            raise ValueError("empty SQL pipeline")
        return result


class SQLPipelineBuilder:
    """Reference: sql/sql_pipeline_builder.hpp fluent API."""

    def __init__(self, sql: str):
        self.sql = sql
        self._catalog: Optional[Catalog] = None
        self._optimizer: Optional[Optimizer] = None
        self._use_cache = True
        self._params: Optional[List[object]] = None
        self._use_mvcc = False
        self._tm = None
        self._context = None
        self._prepared: Optional[Dict[str, object]] = None
        self._dist_catalog = None
        self._use_compiled = os.environ.get("HYRISE_COMPILED", "") == "1"

    def with_catalog(self, catalog: Catalog) -> "SQLPipelineBuilder":
        self._catalog = catalog
        return self

    def with_mvcc(self, enabled: bool = True) -> "SQLPipelineBuilder":
        self._use_mvcc = enabled
        return self

    def disable_mvcc(self) -> "SQLPipelineBuilder":
        self._use_mvcc = False
        return self

    def with_transaction_manager(self, tm) -> "SQLPipelineBuilder":
        self._tm = tm
        return self

    def with_transaction_context(self, context) -> "SQLPipelineBuilder":
        """Run every statement in `context`, which the caller commits or
        rolls back (no auto-commit)."""
        self._context = context
        return self

    def with_prepared(self, prepared: Dict[str, object]) -> "SQLPipelineBuilder":
        """Keep PREPARE's statements in `prepared` and read EXECUTE's from
        it: one map a session. Without it the process-wide map serves."""
        self._prepared = prepared
        return self

    def with_optimizer(self, optimizer: Optimizer) -> "SQLPipelineBuilder":
        self._optimizer = optimizer
        return self

    def dont_cache_query_plans(self) -> "SQLPipelineBuilder":
        self._use_cache = False
        return self

    def with_compiled_execution(self, enabled: bool = True) -> "SQLPipelineBuilder":
        """Execute read-only statements as CompiledQuerys (plan/compiler.py):
        on the card one captured CUDA graph a statement, replayed by later
        callers of the text at the same catalog version; with
        with_distributed_execution too, as DistributedCompiledQuerys over
        the ShardedCatalog (parallel/dist_compiler.py). A statement that
        needs a transaction, or whose plan cannot compile, runs eagerly (a
        plan the distributed compiled form refuses: as a DistributedQuery,
        else on one device). Default from the environment:
        HYRISE_COMPILED=1."""
        self._use_compiled = enabled
        return self

    def with_distributed_execution(self, shard_catalog) -> "SQLPipelineBuilder":
        """Run read-only statements over a ShardedCatalog taken from this
        pipeline's catalog (parallel/dist_compiler.py shard_tpch), as
        DistributedQuerys (as DistributedCompiledQuerys where compiled
        execution is on too). A statement runs on one device where it needs a transaction, where
        the plan cannot be distributed or reads a table the ShardedCatalog
        does not hold, and once the catalog was written after the copies
        were taken (an INSERT is read back): shard it again to distribute
        again."""
        self._dist_catalog = shard_catalog
        return self

    def with_params(self, params: Optional[List[object]]
                    ) -> "SQLPipelineBuilder":
        """Typed values for `?` placeholders, substituted as literal AST
        nodes at translation time (NO textual splicing — a string value
        containing quotes or `?` is just a string literal)."""
        self._params = params
        return self

    def create_pipeline(self) -> SQLPipeline:
        if self._catalog is None:
            raise ValueError("the pipeline needs a catalog: call "
                             "with_catalog() before create_pipeline()")
        return SQLPipeline(self.sql, self._catalog, self._optimizer,
                           self._use_cache, params=self._params,
                           use_mvcc=self._use_mvcc, transaction_manager=self._tm,
                           context=self._context, prepared=self._prepared,
                           dist_catalog=self._dist_catalog, use_compiled=self._use_compiled)


def run_sql(sql: str, catalog: Catalog, context=None, use_mvcc: bool = False) -> Table:
    b = SQLPipelineBuilder(sql).with_catalog(catalog).with_mvcc(use_mvcc)
    if context is not None:
        b.with_transaction_context(context)
    return b.create_pipeline().get_result_table()
