"""Segmented streaming execution (hyrise_tpu_torch/plan/segmented.py) against
the JAX package, on the CPU.

The same numpy-seeded TPC-H at SF 0.02 goes through both packages'
generate_tables and TPCH_PLANS. With the resident threshold forced far
below lineitem's rows (tests/test_segmented.py's thresholds) every query
streams: the port's SegmentedQuery answer must equal the JAX package's
eager answer (ints and strings exactly, floats within 1e-6 relative, in
order), a second run() must give it again, and the port's stage list (kind
and stream table of each stage) must equal the JAX SegmentedQuery's,
which is only constructed here (that compiles nothing).

tests/test_segmented.py's test_segmented_seed_roundtrip is not ported: it
checks the capacity seeds of the JAX compiler, which the port does not have
(ROADMAP A, "not ported by decision")."""

import pytest
import torch

from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.plan.segmented import SegmentedQuery as JaxSegmentedQuery
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.plan.segmented import SegmentedQuery
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL
from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

SF = 0.02
THRESHOLDS = dict(block_rows=1 << 14, resident_rows=1 << 15, hoist_min_rows=1 << 11)
# queries whose plans one blocked pass cannot stream: at least 2 stages
MULTI_STAGE = {4, 15, 17, 18, 20, 21}
# Q11 at SF 0.02: one part's value lies within float rounding of the HAVING
# threshold, and the JAX plan keeps it where the port's eager plan and
# sqlite drop it; there the port's streamed answer is held against its own
# eager answer and sqlite
JAX_FLOAT_EDGE = {11}
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


def _kinds(stages):
    return [("final" if s.wrapper is None else "segment", s.stream) for s in stages]


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_segmented_matches_jax_eager(qid):
    jcat, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[qid](cat), cat, **THRESHOLDS)
    jsq = JaxSegmentedQuery(JAX_PLANS[qid](jcat), jcat, **THRESHOLDS)
    assert _kinds(sq.stages) == _kinds(jsq.stages), (sq.describe(), jsq.describe())
    if qid in MULTI_STAGE:
        assert len(sq.stages) >= 2, sq.describe()
    assert any(s.stream == "lineitem" for s in sq.stages) or qid in (2, 11, 13, 16, 22)
    out = sq.run().rows()
    if qid in JAX_FLOAT_EDGE:
        want = execute_plan(TPCH_PLANS[qid](cat)).rows()
        oracle = SqliteOracle(_state["tables"])
        assert_tables_equal(want, oracle.query(TPCH_SQL[qid]), ordered=True, rel_tol=1e-6)
        oracle.close()
    else:
        want = jax_execute_plan(JAX_PLANS[qid](jcat)).rows()
    assert_tables_equal(out, want, ordered=True, rel_tol=1e-6)
    # a second run rebinds every stage's result into the same placeholders
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-6)


def test_segmented_existence_build_rewrite():
    """A semi join against a large build subtree gets a DISTINCT-key
    aggregate around the build (presence only), which makes the large
    reference streamable. Q4's shape."""
    _, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[4](cat), cat, block_rows=1 << 14,
                        resident_rows=1 << 15)
    assert _kinds(sq.stages) == [("segment", "lineitem"), ("final", None)], sq.describe()


def test_segmented_no_large_tables_runs_whole():
    _, cat = _catalogs()
    sq = SegmentedQuery(TPCH_PLANS[6](cat), cat, block_rows=1 << 14,
                        resident_rows=1 << 30)
    assert len(sq.stages) == 1 and sq.stages[0].stream is None
    want = execute_plan(TPCH_PLANS[6](cat)).rows()
    assert_tables_equal(sq.run().rows(), want, ordered=True, rel_tol=1e-9)
    assert sq.stages[0].query is None
