"""The compiled segmented form of the port (hyrise_tpu_torch/plan/segmented.py
SegmentedQuery(..., compiled=True)) against its eager form and the JAX
package's SegmentedQuery, which is always compiled, on the CPU.

The same numpy-seeded TPC-H at SF 0.02 goes through both packages with
tests/test_segmented.py's thresholds, so every query streams. All 22 plans:
the compiled answer equals the port's eager SegmentedQuery's (ints and
strings exactly, floats within 1e-6 relative, in order) on a first run and
on a rerun, where no stage retries; the compiled stage list is the JAX
describe(), and the eager one is it up to the word for a stage that runs
whole. The multi-stage Q4, Q15, Q17, Q18, Q20 and Q21 are also held against
the JAX SegmentedQuery's answers (one run each, computed once per module),
Q11 against sqlite (ROADMAP C23: the JAX plan keeps a value within float
rounding of its HAVING threshold). Binding: a rerun copies every stage's
result into its placeholder's tensors (same data_ptr()); with lineitem
replaced by half of it, Q4, Q6 and Q18 give the eager answers over the
half table, every blocked stage over lineitem streams the new table, and
the stages after a result that changed its rows are made anew."""

import pytest
import torch

from hyrise_tpu.plan.segmented import SegmentedQuery as JaxSegmentedQuery
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu_torch.plan.blocked import BlockedCompiledQuery
from hyrise_tpu_torch.plan.compiler import CompiledQuery
from hyrise_tpu_torch.plan.segmented import SegmentedQuery
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query
from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

SF = 0.02
THRESHOLDS = dict(block_rows=1 << 14, resident_rows=1 << 15, hoist_min_rows=1 << 11)
MULTI_STAGE = (4, 15, 17, 18, 20, 21)
_state = {}


def _catalogs():
    if not _state:
        jcat = JaxCatalog()
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        tables = generate_tables(SF, device="cpu")
        cat = Catalog(device="cpu")
        for name, t in tables.items():
            cat.add_table(name, t)
        _state.update(jcat=jcat, cat=cat, tables=tables)
    return _state["jcat"], _state["cat"]


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX SegmentedQuery's rows of each multi-stage query (one run)."""
    jcat, _ = _catalogs()
    return {qid: JaxSegmentedQuery(JAX_PLANS[qid](jcat), jcat, **THRESHOLDS).run().rows()
            for qid in MULTI_STAGE}


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_compiled_segmented_matches_eager(qid):
    jcat, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[qid](cat), cat, compiled=True, **THRESHOLDS)
    eager = SegmentedQuery(TPCH_PLANS[qid](cat), cat, **THRESHOLDS)
    jax_stages = JaxSegmentedQuery(JAX_PLANS[qid](jcat), jcat, **THRESHOLDS).describe()
    assert sq.describe() == jax_stages
    assert eager.describe() == jax_stages.replace(" compiled ", " whole ")
    want = eager.run().rows()
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-6)
    for stage in sq.stages:
        kind = BlockedCompiledQuery if stage.stream else CompiledQuery
        assert type(stage.query) is kind
    queries = [s.query for s in sq.stages]
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-6)
    assert [s.query for s in sq.stages] == queries  # kept across runs
    assert all(s.query.last_retries == 0 for s in sq.stages)


@pytest.mark.parametrize("qid", MULTI_STAGE)
def test_compiled_segmented_matches_jax(qid, jax_answers):
    _, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[qid](cat), cat, compiled=True, **THRESHOLDS)
    assert len(sq.stages) >= 2, sq.describe()
    assert_tables_equal(sq.run().rows(), jax_answers[qid], ordered=True, rel_tol=1e-6)


def test_compiled_segmented_q11_against_sqlite():
    _, cat = _catalogs()
    out = run_query(11, cat, via="compiled-segmented", block_rows=THRESHOLDS["block_rows"],
                    resident_rows=THRESHOLDS["resident_rows"]).rows()
    eager = run_query(11, cat, via="segmented", block_rows=THRESHOLDS["block_rows"],
                      resident_rows=THRESHOLDS["resident_rows"]).rows()
    oracle = SqliteOracle(_state["tables"])
    want = oracle.query(TPCH_SQL[11])
    oracle.close()
    assert_tables_equal(eager, want, ordered=True, rel_tol=1e-6)
    assert_tables_equal(out, want, ordered=True, rel_tol=1e-6)
    key = ("compiled-segmented", 11, THRESHOLDS["block_rows"], THRESHOLDS["resident_rows"])
    assert isinstance(cat.compiled.pop(key), SegmentedQuery)


def _placeholder_pointers(sq):
    return [[(c.data.data_ptr(), None if c.validity is None else c.validity.data_ptr())
             for c in s.wrapper.table.columns] for s in sq.stages if s.wrapper is not None]


def test_rerun_copies_into_the_placeholders():
    _, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[21](cat), cat, compiled=True, **THRESHOLDS)
    sq.run()
    tables = [s.wrapper.table for s in sq.stages if s.wrapper is not None]
    pointers = _placeholder_pointers(sq)
    assert len(tables) >= 2
    sq.run()
    assert [s.wrapper.table for s in sq.stages if s.wrapper is not None] == tables
    assert _placeholder_pointers(sq) == pointers


@pytest.mark.parametrize("qid", [4, 6, 18])
def test_replaced_lineitem_rebinds_and_rebuilds(qid):
    """After lineitem is replaced by its first half: every blocked stage
    over it streams the new table through a window of its own, a stage
    whose result changed its rows is bound anew, and every stage after it
    has a new compiled query (at SF 0.02 Q18's stage 0 has no rows either
    way, so its later stages are kept; Q4's stage 0 loses rows)."""
    _, cat = _catalogs()
    own = Catalog(device="cpu")
    for name in cat.table_names():
        own.add_table(name, cat.get_table(name))
    sq = SegmentedQuery(TPCH_PLANS[qid](own), own, compiled=True, **THRESHOLDS)
    sq.run()
    queries = [s.query for s in sq.stages]
    windows = [s.query._window if s.stream else None for s in sq.stages]
    bound = [s.wrapper.table if s.wrapper is not None else None for s in sq.stages]
    li = own.get_table("lineitem")
    own.replace_table("lineitem", li.block(0, li.num_rows // 2))
    want = SegmentedQuery(TPCH_PLANS[qid](own), own, **THRESHOLDS).run().rows()
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-6)
    rebound = [i for i, s in enumerate(sq.stages)
               if s.wrapper is not None and s.wrapper.table is not bound[i]]
    assert bool(rebound) == (qid == 4)
    first = rebound[0] if rebound else len(sq.stages)
    for i, s in enumerate(sq.stages):
        if i > first:
            assert s.query is not queries[i]
        else:
            assert s.query is queries[i]
            if s.stream == "lineitem":
                assert s.query._window is not windows[i]
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-6)
    assert all(s.query.last_retries == 0 for s in sq.stages)
