"""Whole-plan compiled execution of the port (hyrise_tpu_torch/plan/compiler.py)
against the JAX package's CompiledQuery (hyrise_tpu/plan/compiler.py).

The cases of tests/test_compiler.py run through both CompiledQuerys over the
same numpy-seeded tables, and through the port's eager path: rows equal in
order, ints and strings exact, floats within 1e-6 relative. On CPU tensors
the port's CompiledQuery runs its capacity mode without a CUDA graph, so the
oracle, the overflow retries, the tightening and the second run's freedom
from eager reads are the code the card runs. Also: the capacity forms of K9
and K5 (plain versions) against tpu_prims.compact_indices(mask, cap) and
ops/join.py _expand_pairs, including counts above the capacity; a replaced
table re-pinned; a table changed under a run; MVCC tables and write
operators refused; four threads on one cached compiled SQL text."""

import threading

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import hyrise_tpu.ops as jax_ops
import hyrise_tpu_torch.ops as torch_ops
from hyrise_tpu.expression import ast as jax_ast
from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.ops.join import _expand_pairs as jax_expand_pairs
from hyrise_tpu.plan.compiler import CompiledQuery as JaxCompiledQuery
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.types import JoinMode as JaxJoinMode
from hyrise_tpu.types import PredicateCondition as JaxCond
from hyrise_tpu_torch.expression import ast as torch_ast
from hyrise_tpu_torch.kernels.compact import compact_indices_cap, compact_indices_cap_plain
from hyrise_tpu_torch.kernels.join_probe import expand_pairs_cap, expand_pairs_plain
from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.plan.compiler import CompiledQuery, PlanNotCompilable
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import JoinMode, PredicateCondition
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(jt.name, cols, int(jt.num_rows), live, device="cpu",
                            unique=[c.name for c in jt.columns if c.unique],
                            val_ranges={c.name: c.val_range for c in jt.columns})


def _catalogs(frames):
    """The same tables in a JAX catalog and in a port catalog on the CPU."""
    jcat, pcat = JaxCatalog(), Catalog(device="cpu")
    for name, frame in frames.items():
        jt = JaxTable.from_pandas(name, frame)
        jcat.add_table(name, jt)
        pcat.add_table(name, _port_table(jt))
    return jcat, pcat


def _frames():
    """tests/test_compiler.py's make_catalog tables."""
    rng = np.random.default_rng(7)
    n, m = 500, 80
    return {
        "t": pd.DataFrame({
            "a": rng.integers(0, 50, size=n).astype(np.int32),
            "b": rng.random(n).astype(np.float64),
            "s": np.array([f"v{int(x):02d}" for x in rng.integers(0, 9, n)], dtype=object),
            "nullable": np.where(rng.random(n) < 0.2, np.nan, rng.random(n)),
        }),
        "d": pd.DataFrame({
            "k": np.arange(m, dtype=np.int32),
            "w": rng.random(m).astype(np.float64),
        }),
    }


_CATALOGS = {}


def _shared_catalogs():
    if "main" not in _CATALOGS:
        _CATALOGS["main"] = _catalogs(_frames())
    return _CATALOGS["main"]


def _both(plan_factory):
    """plan_factory(ops, ast, modes, catalog) in both packages: the JAX
    CompiledQuery, the port's CompiledQuery (twice: learned, then tightened)
    and the port's eager plan give the same rows in the same order."""
    jcat, pcat = _shared_catalogs()
    jax_side = (jax_ops, jax_ast, (JaxJoinMode, JaxCond), jcat)
    port_side = (torch_ops, torch_ast, (JoinMode, PredicateCondition), pcat)
    want = JaxCompiledQuery(plan_factory(*jax_side), jcat).run().rows()
    eager = torch_ops.execute_plan(plan_factory(*port_side)).rows()
    cq = CompiledQuery(plan_factory(*port_side), pcat)
    first = cq.run().rows()
    second = cq.run().rows()
    for rows in (eager, first, second):
        assert_tables_equal(rows, want, ordered=True, rel_tol=1e-6, abs_tol=0.0)
    assert cq.last_retries == 0
    return cq


def _scan_project_sort(ops, a, modes, cat):
    return ops.Sort(ops.Projection(ops.TableScan(ops.GetTable("t", cat),
                                                 a.col("a") < a.lit(10)),
                                   ["a", ("bb", a.col("b") * a.lit(2.0))]), ["a", "bb"])


def _aggregate_groups(ops, a, modes, cat):
    return ops.Sort(ops.Aggregate(ops.GetTable("t", cat), ["s"],
                                  [("cnt", a.count_()), ("sb", a.sum_(a.col("b"))),
                                   ("an", a.avg_(a.col("nullable")))]), ["s"])


def _join(mode_name):
    def plan(ops, a, modes, cat):
        return ops.Sort(ops.Join(ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(30)),
                                 ops.GetTable("d", cat), getattr(modes[0], mode_name),
                                 ("a", "k")), ["a", "b"])
    return plan


def _outer_limit(ops, a, modes, cat):
    return ops.Limit(ops.Sort(ops.Join(ops.GetTable("t", cat), ops.GetTable("d", cat),
                                       modes[0].OUTER, ("a", "k")), ["a", "b"]), 17)


def _union(ops, a, modes, cat):
    return ops.Sort(ops.UnionAll(
        ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(5)),
        ops.TableScan(ops.GetTable("t", cat), a.col("a") >= a.lit(45))), ["a", "b"])


def _existence(mode_name):
    def plan(ops, a, modes, cat):
        return ops.Sort(ops.Join(ops.GetTable("t", cat),
                                 ops.TableScan(ops.GetTable("d", cat), a.col("k") < a.lit(20)),
                                 getattr(modes[0], mode_name), ("a", "k")), ["a", "b"])
    return plan


def _product(ops, a, modes, cat):
    return ops.Sort(ops.Product(ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(2)),
                                ops.TableScan(ops.GetTable("d", cat), a.col("k") < a.lit(3))),
                    ["a", "b", "k"])


def _nested_loop(ops, a, modes, cat):
    return ops.Sort(ops.JoinNestedLoop(
        ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(5)),
        ops.TableScan(ops.GetTable("d", cat), a.col("k") < a.lit(10)),
        modes[0].INNER, ("a", "k"), modes[1].GREATER_THAN), ["a", "k"])


def _difference(ops, a, modes, cat):
    return ops.Sort(ops.misc.Difference(
        ops.Projection(ops.GetTable("t", cat), ["a"]),
        ops.Projection(ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(25)), ["a"])),
        ["a"])


def test_scan_project_sort():
    _both(_scan_project_sort)


def test_aggregate_groups():
    _both(_aggregate_groups)


@pytest.mark.parametrize("mode", ["INNER", "LEFT"])
def test_join_inner_and_left(mode):
    _both(_join(mode))


@pytest.mark.parametrize("plan", [_outer_limit, _union], ids=["outer_limit", "union_all"])
def test_join_outer_union_limit(plan):
    _both(plan)


@pytest.mark.parametrize("plan", [_existence("SEMI"), _existence("ANTI"), _product],
                         ids=["semi", "anti", "product"])
def test_semi_anti_product(plan):
    _both(plan)


@pytest.mark.parametrize("plan", [_nested_loop, _difference], ids=["nested_loop", "difference"])
def test_nested_loop_and_difference(plan):
    _both(plan)


def _fanout_catalogs():
    n = 2000
    return _catalogs({"f": pd.DataFrame({"k": np.zeros(n, dtype=np.int32)}),
                      "g": pd.DataFrame({"k2": np.zeros(5, dtype=np.int32),
                                         "x": np.arange(5.0)})})


def test_overflow_retry_converges():
    """A join with fan-out 5 overflows the one-pair-a-probe-row estimate and
    converges by a retry, in both packages."""
    jcat, pcat = _fanout_catalogs()
    jcq = JaxCompiledQuery(jax_ops.Join(jax_ops.GetTable("f", jcat), jax_ops.GetTable("g", jcat),
                                        JaxJoinMode.INNER, ("k", "k2")), jcat)
    want = jcq.run()
    cq = CompiledQuery(torch_ops.Join(torch_ops.GetTable("f", pcat),
                                      torch_ops.GetTable("g", pcat), JoinMode.INNER,
                                      ("k", "k2")), pcat)
    out = cq.run()
    assert out.num_rows == want.num_rows == 2000 * 5
    assert jcq.last_retries >= 1 and cq.last_retries >= 1
    assert_tables_equal(out.rows(), want.rows(), ordered=True, rel_tol=1e-6, abs_tol=0.0)
    assert "join.expand" in cq.labels


def test_compiled_is_sync_free_after_learning():
    """After the capacities are learned, a run reads no count eagerly: the
    counts stay on the device until the one read of the count vector."""
    cq = _both(lambda ops, a, modes, cat: ops.Sort(ops.Aggregate(
        ops.TableScan(ops.GetTable("t", cat), a.col("a") < a.lit(10)),
        ["s"], [("cnt", a.count_())]), ["s"]))
    caps = list(cq.caps)
    reads = compiler.eager_reads()
    torch_ops.execute_plan(cq.root)  # eagerly, each site reads its count
    assert compiler.eager_reads() == reads + 2
    for op in compiler._walk(cq.root):
        op.clear_output()
    reads = compiler.eager_reads()
    cq.run()
    assert compiler.eager_reads() == reads
    assert cq.last_retries == 0 and cq.caps == caps
    assert cq.labels == ["filter", "aggregate.groups"]


def test_eager_oracle_reads_the_count():
    reads = compiler.eager_reads()
    assert compiler.oracle_capacity(torch.tensor(37), bound=100, label="x") == (37, 37)
    assert compiler.eager_reads() == reads + 1


# -- the capacity forms of K9 and K5 against the JAX package ------------------


@pytest.mark.parametrize("n", [1, 1000, 65_543])
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_compact_cap_matches_jax(n, share):
    """K9's capacity form: the first min(count, cap) positions equal JAX
    compact_indices(mask, cap)'s, the rest 0; the count is the mask's, also
    above cap."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < share
    count = int(mask.sum())
    for cap in sorted({1, max(count, 1), max(count // 2, 1), count + 17}):
        want = np.asarray(tpu_prims.compact_indices(jnp.asarray(mask), cap))
        got, got_n = compact_indices_cap(torch.as_tensor(mask), cap)
        assert got.shape == (cap,) and got.dtype == torch.int64
        assert int(got_n) == count
        k = min(count, cap)
        np.testing.assert_array_equal(got.numpy()[:k], want[:k])
        assert not got[k:].any()
        plain, plain_n = compact_indices_cap_plain(torch.as_tensor(mask), cap)
        assert torch.equal(plain, got) and int(plain_n) == count


@pytest.mark.parametrize("n", [1, 1000, 20_011])
def test_expand_pairs_cap_matches_jax(n):
    """K5's capacity form: the first min(total, cap) pairs equal JAX
    _expand_pairs(lo, counts, build_perm, out_cap)'s and the port's exact
    expand_pairs, the rest 0; the total is the ranges', also above cap."""
    rng = np.random.default_rng(n + 3)
    nb = n // 4 + 4
    counts = np.minimum(rng.integers(0, 4, n), nb).astype(np.int32)
    lo = (rng.integers(0, nb, n) % (nb - counts + 1)).astype(np.int32)
    perm = rng.permutation(nb).astype(np.int64)
    total = int(counts.sum())
    t_lo, t_counts, t_perm = (torch.as_tensor(x) for x in (lo, counts, perm))
    exact_p, exact_b = expand_pairs_plain(t_lo, t_counts, t_perm)
    for cap in sorted({1, max(total, 1), max(total // 2, 1), total + 5}):
        jp, jb = jax_expand_pairs(jnp.asarray(lo), jnp.asarray(counts),
                                  jnp.asarray(perm, dtype=jnp.int32), cap)
        p, b, got_total, refused = expand_pairs_cap(t_lo, t_counts, t_perm, cap)
        k = min(total, cap)
        assert int(got_total) == total and not bool(refused)
        np.testing.assert_array_equal(p.numpy()[:k], np.asarray(jp)[:k])
        np.testing.assert_array_equal(b.numpy()[:k], np.asarray(jb)[:k])
        assert torch.equal(p[:k], exact_p[:k]) and torch.equal(b[:k], exact_b[:k])
        assert not p[k:].any() and not b[k:].any()


@pytest.mark.parametrize("bad", ["negative_count", "past_the_build_side", "negative_lo"])
def test_expand_pairs_cap_refuses_bad_ranges(bad):
    """A range the exact form refuses sets the capacity form's flag and
    writes no pair; the CompiledQuery raises on the flag."""
    lo = torch.tensor([0, 1, 2], dtype=torch.int32)
    counts = torch.tensor([1, 1, 1], dtype=torch.int32)
    perm = torch.arange(4, dtype=torch.int64)
    if bad == "negative_count":
        counts[1] = -1
    elif bad == "past_the_build_side":
        lo[2] = 3
        counts[2] = 2
    else:
        lo[0] = -1
    with pytest.raises(ValueError):
        expand_pairs_plain(lo, counts, perm)
    p, b, _, refused = expand_pairs_cap(lo, counts, perm, 8)
    assert bool(refused) and not p.any() and not b.any()


# -- sources, refusals, concurrency --------------------------------------------


def _port_catalog():
    return _catalogs(_frames())[1]


def test_replaced_table_is_pinned_again():
    """Replacing a table in the catalog makes the next run read the new one
    (on the card: capture again) and answer accordingly."""
    cat = _port_catalog()
    plan = torch_ops.Aggregate(torch_ops.GetTable("t", cat), [],
                               [("n", torch_ast.count_())])
    cq = CompiledQuery(plan, cat)
    assert cq.run().rows() == [(500,)]
    cat.replace_table("t", cat.get_table("t").block(0, 123))
    assert cq.run().rows() == [(123,)]


def test_table_changed_under_a_run_is_not_compilable():
    """GetTable in capacity mode takes only a table the CompiledQuery pinned."""
    cat = _port_catalog()
    ctx = compiler.CompileContext([], sources=[cat.get_table("d")])
    with compiler._activation(ctx):
        with pytest.raises(PlanNotCompilable):
            torch_ops.execute_plan(torch_ops.GetTable("t", cat))


def test_mvcc_table_and_writes_are_not_compilable():
    from hyrise_tpu_torch.concurrency.transaction import MvccData
    from hyrise_tpu_torch.ops.rw_ops import Delete

    cat = _port_catalog()
    t = cat.get_table("t")
    t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device=t.device)
    with pytest.raises(PlanNotCompilable, match="MVCC"):
        CompiledQuery(torch_ops.GetTable("t", cat), cat)
    cat = _port_catalog()
    with pytest.raises(PlanNotCompilable, match="Delete"):
        CompiledQuery(Delete("d", torch_ops.GetTable("d", cat), cat), cat)


def test_sql_compiled_falls_back_and_caches():
    """with_compiled_execution: a read-only text runs compiled and later
    callers reuse its CompiledQuery; a text whose plan cannot compile, and
    one under MVCC, run eagerly with last_compiled False; HYRISE_COMPILED=1
    turns it on by default."""
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder

    cat = _port_catalog()
    sql = "SELECT s, COUNT(*) AS c FROM t WHERE a < 20 GROUP BY s ORDER BY s"

    def run(text, **kw):
        b = SQLPipelineBuilder(text).with_catalog(cat).with_compiled_execution()
        if kw.get("mvcc"):
            b = b.with_mvcc()
        p = b.create_pipeline()
        rows = p.get_result_table().rows()
        return rows, p.pipeline_statements[-1]

    eager = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline() \
        .get_result_table().rows()
    rows, st = run(sql)
    assert rows == eager and st.last_compiled
    rows2, st2 = run(sql)
    assert rows2 == eager and st2.last_compiled
    assert st2.last_compiled_query is st.last_compiled_query
    rows, st = run("SELECT CAST(a AS TEXT) AS x FROM t WHERE a < 3 ORDER BY x LIMIT 2")
    assert not st.last_compiled and len(rows) == 2
    import os
    os.environ["HYRISE_COMPILED"] = "1"
    try:
        p = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline()
        assert p.get_result_table().rows() == eager
        assert p.pipeline_statements[-1].last_compiled
    finally:
        del os.environ["HYRISE_COMPILED"]


def test_four_threads_on_one_cached_compiled_text():
    """Four threads running one cached compiled text each get one thread's
    answer: the CompiledQuery's lock keeps its buffers to one caller."""
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder

    cat = _port_catalog()
    sql = ("SELECT t.s, SUM(d.w) AS w FROM t JOIN d ON t.a = d.k WHERE t.a < 40 "
           "GROUP BY t.s ORDER BY t.s")
    want = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline().get_result_table().rows()
    answers, errors = [], []

    def caller():
        try:
            for _ in range(3):
                p = SQLPipelineBuilder(sql).with_catalog(cat).with_compiled_execution() \
                    .create_pipeline()
                answers.append((p.get_result_table().rows(),
                                p.pipeline_statements[-1].last_compiled))
        except Exception as exc:  # raised below, in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=caller) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(answers) == 12
    for rows, compiled in answers:
        assert compiled
        assert_tables_equal(rows, want, ordered=True, rel_tol=1e-9, abs_tol=0.0)


def test_sync_check_stays_off_beside_other_threads():
    """set_sync_debug_mode is process-wide: a learning run turns it on only
    while no other thread runs, so another session's eager reads never
    raise."""
    release = threading.Event()
    other = threading.Thread(target=release.wait)
    other.start()
    try:
        with compiler._sync_errors(True) as checked:
            assert checked is False
    finally:
        release.set()
        other.join()
    with compiler._sync_errors(False) as checked:
        assert checked is False
