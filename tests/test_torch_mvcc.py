"""The port's transactions and read-write operators against the JAX package's,
on the CPU.

Every test of tests/test_mvcc.py runs here as a scenario over both
packages: the same tables (built as JAX tables from seeded numpy arrays and
carried into the port with storage/interop.table_from_numpy, MVCC state
included), the same operator plans, the same transactions. For each
snapshot the scenario reads the visible rows; the two packages must read the
same rows and raise the same TransactionConflict. The scenarios beside them
cover string inserts that grow a sorted dictionary, NULLs, in-place growth
and where the MVCC tensors live."""

import dataclasses
from types import SimpleNamespace
from typing import Callable

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.concurrency import transaction as jax_tx
from hyrise_tpu.expression import ast as jax_ast
from hyrise_tpu.ops import rw_ops as jax_rw
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.ops.get_table import GetTable as JaxGetTable
from hyrise_tpu.ops.get_table import TableWrapper as JaxTableWrapper
from hyrise_tpu.ops.table_scan import TableScan as JaxTableScan
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.types import bucket_capacity
from hyrise_tpu_torch.concurrency import transaction as tx
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops import rw_ops
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.misc import AddRowIds, with_row_ids
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy

torch.set_num_threads(1)


def jax_table(name: str, df: pd.DataFrame, mvcc: bool) -> JaxTable:
    t = JaxTable.from_pandas(name, df)
    if mvcc:
        t.mvcc = jax_tx.MvccData.for_new_table(t.num_rows, t.capacity)
    return t


def port_table(name: str, df: pd.DataFrame, mvcc: bool):
    """The JAX table of `df`, carried across: padding, validity and MVCC
    state as the JAX package holds them."""
    jt = jax_table(name, df, mvcc)
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    state = None
    if jt.mvcc is not None:
        state = (jt.mvcc.tids, jt.mvcc.begin_cids, jt.mvcc.end_cids)
    return table_from_numpy(name, cols, jt.num_rows, device="cpu", mvcc=state)


@dataclasses.dataclass
class Engine:
    """One package's names, so that a scenario runs unchanged on both."""

    name: str
    tx: SimpleNamespace
    catalog: Callable
    table: Callable
    execute: Callable
    GetTable: type
    TableWrapper: type
    TableScan: type
    Validate: type
    AddRowIds: type
    Insert: type
    Delete: type
    Update: type
    col: Callable
    lit: Callable


JAX = Engine("jax", jax_tx, JaxCatalog, jax_table, jax_execute_plan, JaxGetTable,
             JaxTableWrapper, JaxTableScan, jax_rw.Validate, jax_rw.AddRowIds,
             jax_rw.Insert, jax_rw.Delete, jax_rw.Update, jax_ast.col, jax_ast.lit)
PORT = Engine("port", tx, lambda: Catalog(device="cpu"), port_table, execute_plan,
              GetTable, TableWrapper, TableScan, rw_ops.Validate, AddRowIds,
              rw_ops.Insert, rw_ops.Delete, rw_ops.Update, ast.col, ast.lit)


def _plain(v):
    return v.item() if hasattr(v, "item") else v


def visible(e: Engine, cat, ctx, name: str = "t"):
    """The rows `ctx` sees in table `name`, sorted, as plain Python values."""
    out = e.execute(e.Validate(e.GetTable(name, cat)), ctx)
    return sorted((tuple(_plain(v) for v in r) for r in out.rows()),
                  key=lambda r: tuple((v is None, v) for v in r))


def ints(values) -> pd.DataFrame:
    return pd.DataFrame({"a": np.array(values, dtype=np.int32)})


def mvcc_catalog(e: Engine, values=(1, 2, 3)):
    cat = e.catalog()
    cat.add_table("t", e.table("t", ints(values), True))
    return cat


def rows_where(e: Engine, cat, predicate):
    """Validate over t with row ids, filtered: a Delete's or Update's input."""
    return e.TableScan(e.Validate(e.AddRowIds(e.GetTable("t", cat))), predicate)


def values(e: Engine, df: pd.DataFrame):
    return e.TableWrapper(e.table("v", df, False))


# -- the scenarios of tests/test_mvcc.py -------------------------------------------


def validate_sees_committed_rows(e: Engine):
    cat = mvcc_catalog(e)
    ctx = e.tx.TransactionManager().new_transaction_context()
    return [visible(e, cat, ctx)]


def insert_visibility_and_commit(e: Engine):
    cat = mvcc_catalog(e)
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    e.execute(e.Insert("t", values(e, ints([7, 8])), cat), ctx)
    seen = [visible(e, cat, ctx)]              # its own insert
    other = tm.new_transaction_context()
    seen.append(visible(e, cat, other))        # not yet another's
    ctx.commit()
    seen.append(ctx.phase.value)
    seen.append(visible(e, cat, tm.new_transaction_context()))  # a later snapshot
    seen.append(visible(e, cat, other))        # the old snapshot still not
    return seen


def insert_rollback(e: Engine):
    cat = mvcc_catalog(e)
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    e.execute(e.Insert("t", values(e, ints([7])), cat), ctx)
    ctx.rollback()
    return [ctx.phase.value, visible(e, cat, tm.new_transaction_context())]


def delete_and_visibility(e: Engine):
    cat = mvcc_catalog(e)
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    old = tm.new_transaction_context()
    e.execute(e.Delete("t", rows_where(e, cat, e.col("a") == e.lit(2)), cat), ctx)
    seen = [visible(e, cat, ctx), visible(e, cat, old)]
    ctx.commit()
    return seen + [visible(e, cat, tm.new_transaction_context()), visible(e, cat, old)]


def delete_conflict(e: Engine):
    cat = mvcc_catalog(e)
    tm = e.tx.TransactionManager()
    c1, c2 = tm.new_transaction_context(), tm.new_transaction_context()
    e.execute(e.Delete("t", rows_where(e, cat, e.col("a") == e.lit(2)), cat), c1)
    with pytest.raises(e.tx.TransactionConflict):
        e.execute(e.Delete("t", rows_where(e, cat, e.col("a") == e.lit(2)), cat), c2)
    seen = [c2.phase.value]
    c2.rollback()
    c1.commit()
    return seen + [c1.phase.value, c2.phase.value,
                   visible(e, cat, tm.new_transaction_context())]


def update(e: Engine):
    cat = mvcc_catalog(e)
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    e.execute(e.Update("t", rows_where(e, cat, e.col("a") == e.lit(3)),
                       values(e, ints([30])), cat), ctx)
    old = tm.new_transaction_context()
    seen = [visible(e, cat, ctx), visible(e, cat, old)]
    ctx.commit()
    return seen + [visible(e, cat, tm.new_transaction_context())]


def capacity_growth_preserves_pending_delete(e: Engine):
    """A Delete pending while an Insert grows the table past its capacity
    must still commit into the live MVCC vectors."""
    n = bucket_capacity(1)  # the JAX package's smallest capacity: full
    cat = mvcc_catalog(e, tuple(range(n)))
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    e.execute(e.Delete("t", rows_where(e, cat, e.col("a") < e.lit(2)), cat), ctx)
    e.execute(e.Insert("t", values(e, ints([777])), cat), ctx)
    grew = cat.get_table("t").capacity > n
    ctx.commit()
    after = [r[0] for r in visible(e, cat, tm.new_transaction_context())]
    return [grew, len(after), 0 in after, 1 in after, 777 in after]


def commit_publication_is_in_order(e: Engine):
    tm = e.tx.TransactionManager()
    tm.new_transaction_context(), tm.new_transaction_context()
    cid1, cid2 = tm._next_commit_id_locked(), tm._next_commit_id_locked()
    seen = [int(cid1), int(cid2)]
    tm._publish_commit_id(cid2)  # the later one finishes first
    seen.append(tm.last_commit_id)
    tm._publish_commit_id(cid1)
    return seen + [tm.last_commit_id]


# -- beyond tests/test_mvcc.py ------------------------------------------------------


def string_inserts_grow_a_sorted_dictionary(e: Engine):
    """New strings land between, before and after the stored ones: the stored
    codes are rewritten into the merged dictionary, and a snapshot taken
    before the insert still reads its rows' strings."""
    cat = e.catalog()
    cat.add_table("t", e.table("t", pd.DataFrame({
        "a": np.arange(4, dtype=np.int32),
        "s": np.array(["b", "d", "f", "d"], dtype=object)}), True))
    tm = e.tx.TransactionManager()
    old = tm.new_transaction_context()
    ctx = tm.new_transaction_context()
    e.execute(e.Insert("t", values(e, pd.DataFrame({
        "a": np.array([10, 11, 12, 13], dtype=np.int32),
        "s": np.array(["a", "c", "g", "d"], dtype=object)})), cat), ctx)
    ctx.commit()
    later = tm.new_transaction_context()
    ordered = e.execute(e.TableScan(e.Validate(e.GetTable("t", cat)),
                                    e.col("s") > e.lit("c")), later)
    return [visible(e, cat, old), visible(e, cat, later),
            sorted(_plain(r[0]) for r in ordered.rows()),
            list(cat.get_table("t").column("s").dictionary)]


def null_inserts(e: Engine):
    cat = e.catalog()
    cat.add_table("t", e.table("t", pd.DataFrame({
        "a": pd.array([1, None, 3], dtype="Int32"),
        "s": np.array(["x", None, "z"], dtype=object)}), True))
    tm = e.tx.TransactionManager()
    ctx = tm.new_transaction_context()
    e.execute(e.Insert("t", values(e, pd.DataFrame({
        "a": pd.array([None, 5], dtype="Int32"),
        "s": np.array(["w", None], dtype=object)})), cat), ctx)
    ctx.commit()
    return [visible(e, cat, tm.new_transaction_context())]


def rollback_after_conflict_then_retry(e: Engine):
    """The loser of a conflict rolls back; a transaction begun after the
    winner committed no longer sees the row and deletes nothing."""
    cat = mvcc_catalog(e, (1, 2, 3, 4))
    tm = e.tx.TransactionManager()
    c1, c2 = tm.new_transaction_context(), tm.new_transaction_context()
    e.execute(e.Delete("t", rows_where(e, cat, e.col("a") >= e.lit(3)), cat), c1)
    with pytest.raises(e.tx.TransactionConflict):
        e.execute(e.Delete("t", rows_where(e, cat, e.col("a") == e.lit(4)), cat), c2)
    c2.rollback()
    c1.commit()
    c3 = tm.new_transaction_context()
    e.execute(e.Delete("t", rows_where(e, cat, e.col("a") == e.lit(1)), cat), c3)
    c3.commit()
    return [visible(e, cat, tm.new_transaction_context()), tm.last_commit_id]


SCENARIOS = [validate_sees_committed_rows, insert_visibility_and_commit, insert_rollback,
             delete_and_visibility, delete_conflict, update,
             capacity_growth_preserves_pending_delete, commit_publication_is_in_order,
             string_inserts_grow_a_sorted_dictionary, null_inserts,
             rollback_after_conflict_then_retry]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_scenarios_read_what_the_reference_tests_expect():
    """The mirrored scenarios' own expectations (tests/test_mvcc.py), so a
    fault shared by both packages does not pass unseen."""
    assert validate_sees_committed_rows(PORT) == [[(1,), (2,), (3,)]]
    three, five = [(1,), (2,), (3,)], [(1,), (2,), (3,), (7,), (8,)]
    assert insert_visibility_and_commit(PORT) == [five, three, "committed", five, three]
    assert insert_rollback(PORT) == ["rolled_back", three]
    assert delete_and_visibility(PORT) == [[(1,), (3,)], three, [(1,), (3,)], three]
    assert delete_conflict(PORT) == ["aborted", "committed", "rolled_back", [(1,), (3,)]]
    assert update(PORT) == [[(1,), (2,), (30,)], three, [(1,), (2,), (30,)]]
    assert capacity_growth_preserves_pending_delete(PORT) == [
        True, bucket_capacity(1) - 2 + 1, False, False, True]
    assert commit_publication_is_in_order(PORT) == [1, 2, 0, 2]


@pytest.mark.parametrize("tid,begin,end,our_tid,snapshot,expected", [
    (0, 1, tx.MAX_COMMIT_ID, 5, 3, True),               # committed row
    (7, tx.MAX_COMMIT_ID, tx.MAX_COMMIT_ID, 5, 3, False),  # another's insert
    (5, tx.MAX_COMMIT_ID, tx.MAX_COMMIT_ID, 5, 3, True),   # our own insert
    (0, 1, 2, 5, 3, False),                             # deleted at cid 2
    (0, 1, 4, 5, 3, True),                              # deleted after the snapshot
    (5, 1, tx.MAX_COMMIT_ID, 5, 3, False),              # our own pending delete
    (0, 3, tx.MAX_COMMIT_ID, 5, 3, True),               # committed at the snapshot
    (0, tx.MAX_COMMIT_ID, 0, 5, 3, False),              # a rolled-back insert
])
def test_visibility_truth_table_matches_jax(tid, begin, end, our_tid, snapshot, expected):
    """Reference: validate_visibility_test.cpp. One row with the given MVCC
    state through Validate in both packages."""
    df = ints([42])
    seen = []
    for e in (PORT, JAX):
        cat = e.catalog()
        t = e.table("t", df, True)
        t.mvcc.tids[0], t.mvcc.begin_cids[0], t.mvcc.end_cids[0] = tid, begin, end
        cat.add_table("t", t)
        ctx = e.tx.TransactionManager().new_transaction_context()
        ctx.transaction_id, ctx.snapshot_commit_id = our_tid, snapshot
        seen.append(visible(e, cat, ctx) == [(42,)])
    assert seen == [expected, expected]


def test_mvcc_tensors_live_on_the_tables_device():
    cat = mvcc_catalog(PORT)
    tm = cat.transaction_manager
    ctx = tm.new_transaction_context()
    PORT.execute(PORT.Insert("t", values(PORT, ints(list(range(2000)))), cat), ctx)
    ctx.commit()
    t = cat.get_table("t")
    for vector in (t.mvcc.tids, t.mvcc.begin_cids, t.mvcc.end_cids):
        assert vector.device == t.device == torch.device("cpu")
        assert vector.dtype is torch.int64
        assert vector.shape[0] == t.capacity >= t.num_rows == 2003


def test_validate_keeps_the_rows_in_place_under_a_mask():
    """Validate gathers nothing: its output is its input's columns under a
    live mask of the visible rows, and a scan over it reads that mask."""
    cat = mvcc_catalog(PORT, (5, 6, 7, 8))
    tm = cat.transaction_manager
    ctx = tm.new_transaction_context()
    PORT.execute(PORT.Delete("t", rows_where(PORT, cat, PORT.col("a") == PORT.lit(6)), cat),
                 ctx)
    ctx.commit()
    base = cat.get_table("t")
    out = PORT.execute(PORT.Validate(PORT.GetTable("t", cat)), tm.new_transaction_context())
    assert out.columns[0] is base.columns[0]
    assert out.live[:4].tolist() == [True, False, True, True]
    assert not out.live[4:].any()  # the JAX package's padding rows
    assert out.num_rows == 3
    scan = PORT.execute(PORT.TableScan(PORT.Validate(PORT.GetTable("t", cat)),
                                       PORT.col("a") <= PORT.lit(7)),
                        tm.new_transaction_context())
    assert sorted(r[0] for r in scan.rows()) == [5, 7]


def test_growth_is_in_place_and_geometric():
    """grow keeps the MvccData object (a pending Delete holds it); a stream
    of one-row inserts grows the table a few times, not once per insert."""
    cat = mvcc_catalog(PORT, tuple(range(1024)))
    mvcc = cat.get_table("t").mvcc
    capacities = set()
    tm = cat.transaction_manager
    for i in range(600):
        ctx = tm.new_transaction_context()
        PORT.execute(PORT.Insert("t", values(PORT, ints([5000 + i])), cat), ctx)
        ctx.commit()
        capacities.add(cat.get_table("t").capacity)
        assert cat.get_table("t").mvcc is mvcc
    assert sorted(capacities) == [1536, 2304]
    assert mvcc.capacity == 2304
    assert len(visible(PORT, cat, tm.new_transaction_context())) == 1624


def test_append_drops_unique_and_widens_val_range():
    """An appended key column loses `unique` (K4/K8's lookup join trusts it)
    and its val_range covers the inserted values (K4 sizes its table from
    it); a computed column's unknown range leaves none."""
    cat = Catalog(device="cpu")
    t = table_from_numpy("t", [("k", "int32", np.array([1, 2, 3], dtype=np.int32), None,
                                None)], 3, device="cpu", unique={"k"},
                         val_ranges={"k": (1, 3)})
    t.mvcc = tx.MvccData.for_new_table(3, 3, device="cpu")
    cat.add_table("t", t)
    ctx = cat.transaction_manager.new_transaction_context()
    PORT.execute(PORT.Insert("t", PORT.TableWrapper(table_from_numpy(
        "v", [("k", "int32", np.array([-4, 2], dtype=np.int32), None, None)], 2,
        device="cpu")), cat), ctx)
    k = cat.get_table("t").column("k")
    assert not k.unique and k.val_range == (-4, 3)


def test_with_row_ids_carries_the_mvcc_state():
    t = port_table("t", ints([4, 5]), True)
    out = with_row_ids(t)
    assert out.mvcc is t.mvcc
    assert out.column("row_id").data.tolist()[:2] == [0, 1]


def test_transaction_manager_under_threads():
    """More threads than cores take transaction ids and commit ids from one
    manager: every id is handed out once and every commit is published."""
    import os
    import sys
    import threading

    tm = tx.TransactionManager()
    tids, per_thread = [], 200
    lock = threading.Lock()

    def work():
        mine = []
        for _ in range(per_thread):
            ctx = tm.new_transaction_context()
            ctx.commit()
            mine.append(ctx.transaction_id)
        with lock:
            tids.extend(mine)

    threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 2) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = len(threads) * per_thread
    assert sorted(tids) == list(range(1, n + 1))
    assert tm.last_commit_id == n
