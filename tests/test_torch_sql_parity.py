"""The port's SQL front end against the JAX package's, on the CPU.

For every statement of tests/sql_corpus.sql and each of the 22 TPC-H texts:
(a) the optimized LQP prints the same text in both packages, which pins the
    port's copies of the parser, the SQL translator, lqp, statistics, the
    optimizer, join ordering and the cost model;
(b) generate_table_statistics gives equal numbers on the same table;
(c) the port's pipeline returns the JAX pipeline's rows and sqlite's:
    integers and strings equal, floats within 1e-6 relative (sums are taken
    in another order), compared as row sets like tests/test_sql_corpus.py
    and tests/test_tpch_sql.py, at their scale factors.

The corpus tables are made with numpy from a seed, built as JAX tables and
carried across with storage/interop.table_from_numpy, capacity padding and
all; the TPC-H tables come from each package's copy of the same numpy
generator."""

import dataclasses
import itertools
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.plan import cost_model as jax_cost_model
from hyrise_tpu.plan.optimizer import Optimizer as JaxOptimizer
from hyrise_tpu.plan.statistics import \
    generate_table_statistics as jax_generate_table_statistics
from hyrise_tpu.sql import parser as jax_parser
from hyrise_tpu.sql import translator as jax_translator
from hyrise_tpu.sql.pipeline import SQLPipelineBuilder as JaxPipelineBuilder
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu.utils.table_eq import assert_tables_equal
from hyrise_tpu_torch.plan import cost_model
from hyrise_tpu_torch.plan.optimizer import Optimizer
from hyrise_tpu_torch.plan.statistics import generate_table_statistics
from hyrise_tpu_torch.sql import parser, translator
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_SQL

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "sql_corpus.sql")
SF = 0.01
QUERY_SF = {20: 0.05}
_state = {}


def _corpus_queries():
    with open(CORPUS) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.strip().startswith("--")]
    return [q.strip() for q in "\n".join(lines).split(";") if q.strip()]


def _port_table(name: str, jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(name, cols, jt.num_rows, live, device="cpu")


def _corpus_setup():
    """(JAX catalog, port catalog, sqlite) over the tables of
    tests/test_sql_corpus.py."""
    if "corpus" in _state:
        return _state["corpus"]
    rng = np.random.default_rng(5)
    n = 10
    mixed = pd.DataFrame({
        "a": np.arange(1, n + 1, dtype=np.int32),
        "b": (rng.random(n) * 100).astype(np.float32),
        "s": np.array(["red", "green", None, "blue", "red", "green", "red",
                       None, "amber", "blue"], dtype=object),
    })
    lookup = pd.DataFrame({
        "k": np.array([1, 2, 2, 5, 11], dtype=np.int32),
        "v": np.array(["one", "two", "deux", "five", "eleven"], dtype=object),
    })
    empty_t = pd.DataFrame({"x": np.array([], dtype=np.int32)})
    nullnum = pd.DataFrame({
        "i": pd.array([1, None, 3, None, 5, 3, None, 8], dtype="Int32"),
        "f": pd.array([0.5, 1.5, None, None, 2.5, None, 3.5, 4.5], dtype="Float64"),
        "g": np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.int32),
    })
    tables = {name: JaxTable.from_pandas(name, df)
              for name, df in (("mixed", mixed), ("lookup", lookup),
                               ("empty_t", empty_t), ("nullnum", nullnum))}
    jcat, cat = JaxCatalog(), Catalog()
    for name, t in tables.items():
        jcat.add_table(name, t)
        cat.add_table(name, _port_table(name, t))
    _state["corpus"] = (jcat, cat, SqliteOracle(tables))
    return _state["corpus"]


def _tpch_setup(sf):
    if sf not in _state:
        jax_tables = jax_generate_tables(sf)
        jcat, cat = JaxCatalog(), Catalog()
        for name, t in jax_tables.items():
            jcat.add_table(name, t)
        for name, t in generate_tables(sf, device="cpu").items():
            cat.add_table(name, t)
        oracle = SqliteOracle(jax_tables)
        # indexes keep the oracle's correlated subqueries fast
        for ddl in ["CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"]:
            oracle.conn.execute(ddl)
        _state[sf] = (jcat, cat, oracle)
    return _state[sf]


def _plan_texts(sql, jcat, cat):
    """The optimized LQP's text in the JAX package and in the port. Both
    translators number their generated names from one counter per module:
    each starts from 0 here, so equal plans print equal names."""
    jax_translator._uniq = itertools.count()
    translator._uniq = itertools.count()
    jstmt = jax_parser.parse_sql(sql)[0]
    jlqp = jax_translator.SQLToLQPTranslator(jcat).translate(jstmt)
    want = JaxOptimizer(jcat.all_statistics()).optimize(jlqp, jcat).describe()
    stmt = parser.parse_sql(sql)[0]
    lqp = translator.SQLToLQPTranslator(cat).translate(stmt)
    got = Optimizer(cat.all_statistics()).optimize(lqp, cat).describe()
    return got, want


def _run_both(sql, jcat, cat):
    got = (SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans()
           .create_pipeline().get_result_table())
    want = (JaxPipelineBuilder(sql).with_catalog(jcat).dont_cache_query_plans()
            .create_pipeline().get_result_table())
    return got, want


# -- (a) the optimized LQP ----------------------------------------------------


@pytest.mark.parametrize("idx,sql", list(enumerate(_corpus_queries())))
def test_corpus_lqp_text_matches_jax(idx, sql):
    jcat, cat, _ = _corpus_setup()
    got, want = _plan_texts(sql, jcat, cat)
    assert got == want


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_tpch_lqp_text_matches_jax(qid):
    jcat, cat, _ = _tpch_setup(QUERY_SF.get(qid, SF))
    got, want = _plan_texts(TPCH_SQL[qid], jcat, cat)
    assert got == want
    assert "[Join" in got or qid in (1, 6)


def test_tpch_plan_costs_match_jax():
    """The cost model's estimate of every optimized TPC-H plan."""
    jcat, cat, _ = _tpch_setup(SF)
    for qid in sorted(TPCH_SQL):
        jlqp = JaxOptimizer(jcat.all_statistics()).optimize(
            jax_translator.SQLToLQPTranslator(jcat).translate(
                jax_parser.parse_sql(TPCH_SQL[qid])[0]), jcat)
        lqp = Optimizer(cat.all_statistics()).optimize(
            translator.SQLToLQPTranslator(cat).translate(
                parser.parse_sql(TPCH_SQL[qid])[0]), cat)
        want = jax_cost_model.CostModelLogical(jcat.all_statistics()) \
            .estimate_plan_cost(jlqp)
        got = cost_model.CostModelLogical(cat.all_statistics()).estimate_plan_cost(lqp)
        assert got == want, qid


# -- (b) statistics -----------------------------------------------------------


def _assert_stats_equal(got, want):
    assert got.row_count == want.row_count
    assert list(got.columns) == list(want.columns)
    for name, cs in want.columns.items():
        assert dataclasses.asdict(got.columns[name]) == dataclasses.asdict(cs), name


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer", "part",
                                   "partsupp", "supplier", "nation", "region"])
def test_tpch_table_statistics_match_jax(table):
    jcat, cat, _ = _tpch_setup(SF)
    _assert_stats_equal(generate_table_statistics(cat.get_table(table)),
                        jax_generate_table_statistics(jcat.get_table(table)))
    # a sample step above 1
    _assert_stats_equal(generate_table_statistics(cat.get_table(table), sample=7),
                        jax_generate_table_statistics(jcat.get_table(table), sample=7))


@pytest.mark.parametrize("table", ["mixed", "lookup", "empty_t", "nullnum"])
def test_corpus_table_statistics_match_jax(table):
    jcat, cat, _ = _corpus_setup()
    _assert_stats_equal(cat.table_statistics(table), jcat.table_statistics(table))
    assert cat.table_statistics(table) is cat.table_statistics(table)  # cached


# -- (c) rows -----------------------------------------------------------------


@pytest.mark.parametrize("idx,sql", list(enumerate(_corpus_queries())))
def test_corpus_rows_match_jax_and_sqlite(idx, sql):
    jcat, cat, oracle = _corpus_setup()
    got, want = _run_both(sql, jcat, cat)
    assert got.column_names == want.column_names
    assert_tables_equal(got.rows(), want.rows(), ordered=False, rel_tol=1e-6,
                        abs_tol=0.0)
    # sqlite computes float32 columns in float64: the tolerance of
    # tests/test_sql_corpus.py
    assert_tables_equal(got.rows(), oracle.query(sql), ordered=False, rel_tol=1e-4,
                        abs_tol=1e-4)


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_tpch_rows_match_jax_and_sqlite(qid):
    jcat, cat, oracle = _tpch_setup(QUERY_SF.get(qid, SF))
    got, want = _run_both(TPCH_SQL[qid], jcat, cat)
    assert got.column_names == want.column_names
    if qid != 2:  # Q2's double equality on price can be empty at a tiny SF
        assert got.num_rows > 0
    assert_tables_equal(got.rows(), want.rows(), ordered=False, rel_tol=1e-6,
                        abs_tol=0.0)
    assert_tables_equal(got.rows(), oracle.query(TPCH_SQL[qid]), ordered=False,
                        rel_tol=1e-6, abs_tol=0.0)


# -- (d) ORDER BY: the rows in order --------------------------------------------


def _ordered(sql: str) -> bool:
    return "ORDER BY" in " ".join(sql.upper().split())


@pytest.mark.parametrize("idx,sql", [(i, q) for i, q in enumerate(_corpus_queries())
                                     if _ordered(q)])
def test_corpus_order_by_rows_in_order_match_jax(idx, sql):
    """Statements with an ORDER BY give the JAX pipeline's rows in its order
    (not sqlite's, which puts NULLs last under DESC where both packages put
    them first)."""
    jcat, cat, _ = _corpus_setup()
    got, want = _run_both(sql, jcat, cat)
    assert got.column_names == want.column_names
    assert_tables_equal(got.rows(), want.rows(), ordered=True, rel_tol=1e-6, abs_tol=0.0)


@pytest.mark.parametrize("qid", [q for q in sorted(TPCH_SQL) if _ordered(TPCH_SQL[q])])
def test_tpch_order_by_rows_in_order_match_jax(qid):
    jcat, cat, _ = _tpch_setup(QUERY_SF.get(qid, SF))
    got, want = _run_both(TPCH_SQL[qid], jcat, cat)
    assert got.column_names == want.column_names
    assert_tables_equal(got.rows(), want.rows(), ordered=True, rel_tol=1e-6, abs_tol=0.0)
