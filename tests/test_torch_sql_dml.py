"""DML through the port's SQL pipeline against the JAX package's and sqlite,
on the CPU.

Every test of tests/test_sql_dml.py and test_sql.py's CREATE / INSERT /
SELECT / DROP TABLE runs here as a list of statements through both
pipelines with MVCC on: the same tables (JAX tables carried into the port
with storage/interop.table_from_numpy, MVCC state included), the same
statements, the same rows from every SELECT, the same conflict. Beside
them: string inserts that grow a sorted dictionary, NULLs, an INSERT with a
column subset, UPDATE of a key column followed by a join on it, TPC-H's
RF1 and RF2 statement forms, and snapshots of explicit transactions.

Where the JAX package is at fault (ROADMAP C9-C12: DML plans that validate
nothing, scalar subqueries that see deleted rows, an all-NULL insert into an
empty dictionary, INSERT ... SELECT and DML subqueries that read deleted
rows), the statements run against sqlite instead."""

import sqlite3

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.concurrency.transaction import MvccData as JaxMvccData
from hyrise_tpu.concurrency.transaction import (TransactionConflict as JaxConflict,
                                                default_transaction_manager,
                                                reset_default_transaction_manager)
from hyrise_tpu.sql.pipeline import run_sql as jax_run_sql
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu_torch.concurrency.transaction import TransactionConflict
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder, run_sql
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.utils.table_eq import tables_equal

torch.set_num_threads(1)

TABLES = {
    "t": pd.DataFrame({"a": np.array([1, 2, 3], dtype=np.int32),
                       "s": np.array(["x", "y", "z"], dtype=object)}),
    "u": pd.DataFrame({"k": np.array([1, 2, 3], dtype=np.int32),
                       "w": np.array(["one", "two", "three"], dtype=object)}),
}
UNIQUE = {"u": {"k"}}  # a primary key: the lookup join trusts the flag


def _jax_table(name: str) -> JaxTable:
    t = JaxTable.from_pandas(name, TABLES[name])
    for c in UNIQUE.get(name, ()):
        t.column(c).unique = True
    t.mvcc = JaxMvccData.for_new_table(t.num_rows, t.capacity)
    return t


def _port_table(name: str, jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return table_from_numpy(name, cols, jt.num_rows, device="cpu",
                            unique=UNIQUE.get(name, ()),
                            mvcc=(jt.mvcc.tids, jt.mvcc.begin_cids, jt.mvcc.end_cids))


def _plain(v):
    return v.item() if hasattr(v, "item") else v


def _rows(table):
    return [tuple(_plain(v) for v in r) for r in table.rows()]


def _catalogs():
    """(JAX catalog, port catalog) over the same tables and MVCC state."""
    reset_default_transaction_manager()
    jcat, cat = JaxCatalog(), Catalog(device="cpu")
    for name in TABLES:
        jt = _jax_table(name)
        jcat.add_table(name, jt)
        cat.add_table(name, _port_table(name, jt))
    return jcat, cat


def _sqlite():
    conn = sqlite3.connect(":memory:")
    for name, df in TABLES.items():
        cols = ", ".join(f"{c} {'INTEGER' if df[c].dtype.kind == 'i' else 'TEXT'}"
                         for c in df.columns)
        conn.execute(f"CREATE TABLE {name} ({cols})")
        conn.executemany(f"INSERT INTO {name} VALUES ({', '.join('?' * len(df.columns))})",
                         [tuple(_plain(v) for v in r) for r in df.itertuples(index=False)])
    return conn


def _is_select(sql: str) -> bool:
    return sql.lstrip().upper().startswith("SELECT")


def _selected(statements, run):
    """Run every statement in order; the rows of each SELECT."""
    out = []
    for sql in statements:
        rows = run(sql)
        if _is_select(sql):
            out.append(rows)
    return out


def _port(statements, cat):
    return _selected(statements, lambda sql: _rows(run_sql(sql, cat, use_mvcc=True)))


def _jax(statements, jcat):
    return _selected(statements, lambda sql: _rows(jax_run_sql(sql, jcat, use_mvcc=True)))


def _sqlite_rows(statements):
    conn = _sqlite()
    return _selected(statements, lambda sql: conn.execute(sql).fetchall())


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        ok, msg = tables_equal(g, w, ordered=False, rel_tol=1e-9, abs_tol=0.0)
        assert ok, msg


# -- tests/test_sql_dml.py and test_sql.py, statement for statement ---------------

MIRRORED = {
    "insert_values": ["INSERT INTO t VALUES (4, 'w'), (5, 'v')",
                      "SELECT a FROM t ORDER BY a"],
    "insert_select": ["INSERT INTO t SELECT a + 10, s FROM t WHERE a <= 2",
                      "SELECT a FROM t ORDER BY a"],
    "delete": ["DELETE FROM t WHERE a = 2", "SELECT a FROM t ORDER BY a"],
    "delete_all": ["DELETE FROM t", "SELECT COUNT(*) FROM t"],
    "update": ["UPDATE t SET a = a + 100 WHERE s = 'y'",
               "SELECT a, s FROM t ORDER BY a"],
    "update_string_column": ["UPDATE t SET s = 'updated' WHERE a = 1",
                             "SELECT s FROM t WHERE a = 1"],
    "insert_column_subset": ["INSERT INTO t (a) VALUES (9)",
                             "SELECT a, s FROM t WHERE a = 9"],
    "create_insert_select_drop_table": [
        "CREATE TABLE nt (x int, y string)",
        "INSERT INTO nt VALUES (1, 'one'), (2, 'two')",
        "SELECT x, y FROM nt ORDER BY x", "DROP TABLE nt", "SHOW TABLES"],
    # beyond them
    "strings_grow_a_sorted_dictionary": [
        "INSERT INTO t VALUES (6, 'a'), (7, 'yy'), (8, 'zzz'), (9, 'y')",
        "SELECT a, s FROM t WHERE s > 'x'", "SELECT s, COUNT(*) FROM t GROUP BY s",
        "SELECT MIN(s), MAX(s) FROM t"],
    "nulls": ["INSERT INTO t VALUES (NULL, 'n'), (9, NULL)",
              "SELECT a, s FROM t WHERE a IS NULL OR s IS NULL",
              "SELECT COUNT(a), COUNT(s), COUNT(*) FROM t"],
    "insert_column_subset_of_strings": [
        "INSERT INTO t (s) VALUES ('q'), ('x')", "SELECT a, s FROM t"],
    "update_key_then_join_beyond_its_range": [
        "INSERT INTO t VALUES (500, 'big')", "UPDATE u SET k = 500 WHERE k = 2",
        "SELECT t.a, u.w FROM t JOIN u ON t.a = u.k",
        "SELECT t.s FROM t WHERE t.a IN (SELECT k FROM u)"],
    "update_key_to_a_duplicate_then_join": [
        "UPDATE u SET k = 1 WHERE k = 3", "SELECT t.a, u.w FROM t JOIN u ON t.a = u.k",
        "SELECT u.k, COUNT(*) FROM u GROUP BY u.k"],
    "rf1_form": ["CREATE TABLE stage (a int, s string)",
                 "INSERT INTO stage VALUES (40, 'new'), (41, 'x')",
                 "INSERT INTO t SELECT * FROM stage", "SELECT a, s FROM t"],
    "rf2_form": ["DELETE FROM t WHERE a IN (SELECT k FROM u WHERE k >= 2)",
                 "SELECT a, s FROM t", "INSERT INTO t SELECT k + 10, w FROM u",
                 "SELECT a, s FROM t"],
}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_statements_match_jax(name):
    jcat, cat = _catalogs()
    got, want = _port(MIRRORED[name], cat), _jax(MIRRORED[name], jcat)
    _assert_same(got, want)


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_statements_match_sqlite(name):
    statements = [s for s in MIRRORED[name] if s != "SHOW TABLES"]
    _, cat = _catalogs()
    _assert_same(_port(statements, cat), _sqlite_rows(statements))


def test_dml_is_invisible_to_an_older_snapshot():
    """tests/test_sql_dml.py::test_dml_invisible_to_old_snapshot in both."""
    jcat, cat = _catalogs()
    counts = []
    for run, c, tm in ((run_sql, cat, cat.transaction_manager),
                       (jax_run_sql, jcat, default_transaction_manager())):
        old = tm.new_transaction_context()
        run("INSERT INTO t VALUES (7, 'q')", c)
        counts.append((_rows(run("SELECT COUNT(*) FROM t", c, use_mvcc=True)),
                       _rows(run("SELECT COUNT(*) FROM t", c, context=old, use_mvcc=True))))
    assert counts[0] == counts[1] == ([(4,)], [(3,)])


def test_an_explicit_transaction_sees_its_own_writes_and_commits_them():
    jcat, cat = _catalogs()
    seen = []
    for run, c, tm in ((run_sql, cat, cat.transaction_manager),
                       (jax_run_sql, jcat, default_transaction_manager())):
        ctx = tm.new_transaction_context()
        run("INSERT INTO t VALUES (4, 'w')", c, context=ctx)
        run("DELETE FROM t WHERE a = 1", c, context=ctx)
        inside = _rows(run("SELECT a FROM t", c, context=ctx, use_mvcc=True))
        outside = _rows(run("SELECT a FROM t", c, use_mvcc=True))
        ctx.commit()
        after = _rows(run("SELECT a FROM t", c, use_mvcc=True))
        seen.append((sorted(inside), sorted(outside), sorted(after)))
    assert seen[0] == seen[1] == ([(2,), (3,), (4,)], [(1,), (2,), (3,)],
                                  [(2,), (3,), (4,)])


def test_conflicting_deletes_raise_like_jax():
    jcat, cat = _catalogs()
    outcome = []
    for run, c, tm, conflict in (
            (run_sql, cat, cat.transaction_manager, TransactionConflict),
            (jax_run_sql, jcat, default_transaction_manager(), JaxConflict)):
        c1, c2 = tm.new_transaction_context(), tm.new_transaction_context()
        run("DELETE FROM t WHERE a = 2", c, context=c1)
        with pytest.raises(conflict):
            run("DELETE FROM t WHERE a >= 2", c, context=c2)
        phase = c2.phase.value
        c2.rollback()
        c1.commit()
        outcome.append((phase, sorted(_rows(run("SELECT a FROM t", c, use_mvcc=True)))))
    assert outcome[0] == outcome[1] == ("aborted", [(1,), (3,)])


def test_a_failing_statement_rolls_its_auto_commit_back():
    _, cat = _catalogs()
    other = cat.transaction_manager.new_transaction_context()
    run_sql("DELETE FROM t WHERE a = 3", cat, context=other)
    with pytest.raises(TransactionConflict):
        run_sql("UPDATE t SET s = 'v' WHERE a >= 2", cat)
    other.rollback()
    assert sorted(_rows(run_sql("SELECT a, s FROM t", cat, use_mvcc=True))) == [
        (1, "x"), (2, "y"), (3, "z")]


# -- where the JAX package is at fault: sqlite decides ---------------------------

AGAINST_SQLITE = {
    # C9: the JAX DML plan validates nothing (its Alias drops the MVCC
    # state), so rows a committed DELETE removed still reach the next DML
    "dml_after_a_committed_delete": [
        "DELETE FROM t WHERE a = 2", "UPDATE t SET a = a + 100 WHERE s = 'y'",
        "UPDATE t SET a = a + 1", "DELETE FROM t WHERE a = 2", "SELECT a, s FROM t"],
    # C10: a scalar subquery of the JAX pipeline sees deleted rows
    "scalar_subquery_after_a_delete": [
        "DELETE FROM t WHERE a = 1", "SELECT a FROM t WHERE a >= (SELECT MIN(a) FROM t)",
        "SELECT (SELECT MIN(a) FROM t)"],
    # a cached plan keeps its scalar subquery's value: it must not after DML
    "cached_scalar_subquery_after_an_insert": [
        "SELECT a FROM t WHERE a > (SELECT AVG(a) FROM t)",
        "INSERT INTO t VALUES (30, 'w')",
        "SELECT a FROM t WHERE a > (SELECT AVG(a) FROM t)",
        "DELETE FROM t WHERE a = 30",
        "SELECT a FROM t WHERE a > (SELECT AVG(a) FROM t)"],
    # C12: the JAX pipeline validates neither the source of an INSERT ...
    # SELECT nor the subqueries of a DELETE, so they read deleted rows
    "insert_select_and_delete_subquery_after_a_delete": [
        "DELETE FROM t WHERE a = 1", "INSERT INTO t SELECT a + 10, s FROM t",
        "SELECT a, s FROM t", "DELETE FROM u WHERE k = 2",
        "DELETE FROM t WHERE a IN (SELECT k FROM u)", "SELECT a, s FROM t",
        "UPDATE t SET s = 'in u' WHERE a IN (SELECT k + 10 FROM u)", "SELECT a, s FROM t"],
    # C11: an all-NULL insert into an empty dictionary raises in the JAX package
    "null_strings_into_an_empty_dictionary": [
        "CREATE TABLE nt (x int, y string)", "INSERT INTO nt (x) VALUES (1), (2)",
        "SELECT x, y FROM nt", "INSERT INTO nt VALUES (3, 'c')",
        "SELECT x, y FROM nt WHERE y IS NULL", "SELECT x, y FROM nt WHERE y = 'c'"],
}


@pytest.mark.parametrize("name", sorted(AGAINST_SQLITE))
def test_where_jax_is_at_fault_the_port_matches_sqlite(name):
    _, cat = _catalogs()
    _assert_same(_port(AGAINST_SQLITE[name], cat), _sqlite_rows(AGAINST_SQLITE[name]))


def test_the_jax_faults_are_still_there():
    """C9-C12 reproduced, so the tests above keep comparing with sqlite only
    while the JAX package needs it."""
    jcat, _ = _catalogs()
    jax_run_sql("DELETE FROM u WHERE k = 3", jcat, use_mvcc=True)
    jax_run_sql("INSERT INTO t SELECT k, w FROM u", jcat, use_mvcc=True)
    assert _rows(jax_run_sql("SELECT COUNT(*) FROM t", jcat, use_mvcc=True)) == [(6,)]
    jax_run_sql("DELETE FROM t WHERE a = 2", jcat, use_mvcc=True)
    with pytest.raises(JaxConflict):
        jax_run_sql("UPDATE t SET a = a + 100 WHERE s = 'y'", jcat, use_mvcc=True)
    jax_run_sql("DELETE FROM t WHERE a = 1", jcat, use_mvcc=True)
    assert _rows(jax_run_sql("SELECT (SELECT MIN(a) FROM t)", jcat, use_mvcc=True)) == [(1.0,)]
    jax_run_sql("CREATE TABLE nt (x int, y string)", jcat)
    with pytest.raises(IndexError):
        jax_run_sql("INSERT INTO nt (x) VALUES (1)", jcat)


# -- TPC-H's refresh functions, as chip_smoke.py's phase 7 runs them -------------


def test_tpch_refresh_functions_match_sqlite(tmp_path):
    """RF1 (new orders and lineitems written as .tbl files, loaded with
    load_table, inserted with INSERT ... SELECT) and RF2 (DELETE ... WHERE
    ... IN (SELECT ...)) at SF 0.01 on the CPU, with sqlite running the same
    statements; TPC-H texts with MVCC on after each against sqlite. This is
    chip_smoke.py's small-scale check of phase 7, on fewer texts."""
    import chip_smoke
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL
    from hyrise_tpu_torch.utils import table_eq
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    summary = chip_smoke.small_refresh_run(
        torch.device("cpu"), 0.01, [1, 3, 4, 6, 10, 13, 15, 18, 21], SQLPipelineBuilder,
        SqliteOracle, TPCH_SQL, table_eq, str(tmp_path))
    assert summary.startswith("SF0.01: rows after RF1")


def test_rf1_rows_fill_the_key_gaps_with_new_comments():
    import chip_smoke
    from hyrise_tpu_torch.tpch import dbgen

    specs = dbgen.generate_specs(0.01, chip_smoke.SEED)
    rf1, li = chip_smoke.rf1_rows(specs, 0.01, np.random.default_rng(3))
    orders = {name: values for name, _, values in rf1["rf1_orders"]}
    lines = {name: values for name, _, values in rf1["rf1_lineitem"]}
    base_keys = chip_smoke.spec_payload(specs, "orders", "o_orderkey")
    assert len(orders["o_orderkey"]) == 15
    assert not np.isin(orders["o_orderkey"], base_keys).any()
    counts = np.unique(lines["l_orderkey"], return_counts=True)[1]
    assert counts.min() >= 1 and counts.max() <= 7
    assert np.array_equal(li["l_orderkey"], lines["l_orderkey"])
    _, pool = chip_smoke.spec_payload(specs, "lineitem", "l_comment")
    assert 0 < (~np.isin(lines["l_comment"].astype(str), pool)).sum() < len(counts) * 7


def test_q1_and_q6_under_mvcc_keep_their_fused_aggregate():
    """With MVCC on, Q1's and Q6's plans read lineitem through a Validate and
    still hold a FusedFilterAggregate that does not fall back; the rows are
    those of the same texts without MVCC (after a delete, those of sqlite)."""
    import chip_smoke
    from hyrise_tpu_torch.tpch.dbgen import generate_tables
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    tables = generate_tables(0.01, chip_smoke.SEED, device="cpu")
    cat = Catalog(device="cpu")
    for name, t in tables.items():
        cat.add_table(name, t)
    without = {q: run_sql(TPCH_SQL[q], cat).rows() for q in (1, 6)}
    oracle = SqliteOracle(tables)
    chip_smoke.set_mvcc(tables)
    old = cat.transaction_manager.new_transaction_context()
    run_sql("DELETE FROM lineitem WHERE l_orderkey < 200", cat)
    oracle.conn.execute("DELETE FROM lineitem WHERE l_orderkey < 200")
    for q in (1, 6):
        for context, want in ((cat.transaction_manager.new_transaction_context(),
                               oracle.query(TPCH_SQL[q])), (old, without[q])):
            rows, plan = chip_smoke.mvcc_rows(TPCH_SQL[q], cat, SQLPipelineBuilder,
                                              torch.device("cpu"), context)
            assert chip_smoke.ran_fused(plan)
            ok, msg = tables_equal(rows, want, ordered=False, rel_tol=1e-6, abs_tol=0.0)
            assert ok, (q, msg)
    oracle.close()
