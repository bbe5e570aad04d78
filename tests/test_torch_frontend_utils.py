"""The port's host utilities against the JAX package's: utils/timer.py (a
copy), utils/visualize.py (the same DOT text for the same LQP and PQP),
utils/profiling.py (the same operators and row counts over the same plan,
the roofline against the H100's memory rate) and utils/asserts.py (raises
under HYRISE_DEVICE_ASSERTS where the JAX package does, nothing without)."""

import itertools
import re

import numpy as np
import pytest
import torch

from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.plan.optimizer import Optimizer as JaxOptimizer
from hyrise_tpu.plan.translator import translate_lqp as jax_translate_lqp
from hyrise_tpu.sql import parser as jax_parser
from hyrise_tpu.sql import translator as jax_translator
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.utils import asserts as jax_asserts
from hyrise_tpu.utils import profiling as jax_profiling
from hyrise_tpu.utils import timer as jax_timer
from hyrise_tpu.utils import visualize as jax_visualize
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.materialize import gather_columns_at
from hyrise_tpu_torch.plan.optimizer import Optimizer
from hyrise_tpu_torch.plan.translator import translate_lqp
from hyrise_tpu_torch.sql import parser, translator
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL
from hyrise_tpu_torch.utils import asserts, profiling, timer, visualize

torch.set_num_threads(1)

SF = 0.01
WALL = re.compile(r"\d+\.\d+ms")
_state = {}


def catalogs():
    if "cats" not in _state:
        jcat, cat = JaxCatalog(), Catalog(device="cpu")
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        _state["cats"] = (jcat, cat)
    return _state["cats"]


def optimized(sql):
    """The optimized LQP of `sql` in the port and in the JAX package, the
    generated names numbered from 0 in both."""
    jcat, cat = catalogs()
    jax_translator._uniq = itertools.count()
    translator._uniq = itertools.count()
    jroot = JaxOptimizer(jcat.all_statistics()).optimize(
        jax_translator.SQLToLQPTranslator(jcat).translate(jax_parser.parse_sql(sql)[0]), jcat)
    root = Optimizer(cat.all_statistics()).optimize(
        translator.SQLToLQPTranslator(cat).translate(parser.parse_sql(sql)[0]), cat)
    return root, jroot


@pytest.mark.parametrize("seconds", [0.0, 3e-10, 4.2e-7, 0.0123, 0.5, 7.25, 59.9, 61.0,
                                     3725.5])
def test_format_duration_equals_jax(seconds):
    assert timer.format_duration(seconds) == jax_timer.format_duration(seconds)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536.5, 2**20, 3 * 2**30, 2**40 * 5,
                               2**50 * 3, -2048])
def test_format_bytes_equals_jax(n):
    assert timer.format_bytes(n) == jax_timer.format_bytes(n)


def test_timer_and_warnings(capsys):
    t = timer.Timer()
    first = t.lap()
    assert first >= 0 and t.lap() >= 0
    assert re.fullmatch(r"\d+(ns|µs)|\d+\.\d\dms", t.lap_formatted())
    timer.reset_performance_warnings()
    for _ in range(3):
        timer.performance_warning("slow path taken")
    timer.performance_warning("another")
    assert capsys.readouterr().err == "[PERF] slow path taken\n[PERF] another\n"
    timer.reset_performance_warnings()
    timer.performance_warning("slow path taken")
    assert capsys.readouterr().err == "[PERF] slow path taken\n"
    timer.reset_performance_warnings()


@pytest.mark.parametrize("qid", [1, 3, 5, 9, 13, 17, 22])
def test_lqp_dot_equals_jax(qid):
    root, jroot = optimized(TPCH_SQL[qid])
    dot = visualize.lqp_to_dot(root)
    assert dot.startswith("digraph LQP {")
    assert dot == jax_visualize.lqp_to_dot(jroot)


@pytest.mark.parametrize("qid", [1, 3, 6, 10, 18])
def test_pqp_dot_equals_jax_but_for_walltimes(qid):
    jcat, cat = catalogs()
    root, jroot = optimized(TPCH_SQL[qid])
    plan, jplan = translate_lqp(root, cat), jax_translate_lqp(jroot, jcat)
    before = visualize.pqp_to_dot(plan)
    assert "rows" not in before  # nothing executed yet
    assert before == jax_visualize.pqp_to_dot(jplan)
    execute_plan(plan)
    jax_execute_plan(jplan)
    dot = visualize.pqp_to_dot(plan)
    assert " rows" in dot
    assert WALL.sub("t", dot) == WALL.sub("t", jax_visualize.pqp_to_dot(jplan))


def test_render_dot_without_graphviz(tmp_path, monkeypatch):
    monkeypatch.setattr(visualize.shutil, "which", lambda name: None)
    root, _ = optimized(TPCH_SQL[6])
    dot = visualize.lqp_to_dot(root)
    path = visualize.render_dot(dot, str(tmp_path / "plan"))
    assert path == str(tmp_path / "plan.dot")
    assert open(path).read() == dot


@pytest.mark.parametrize("qid", [1, 5, 18])
def test_plan_profile_equals_jax(qid):
    jcat, cat = catalogs()
    plan, jplan = TPCH_PLANS[qid](cat), JAX_PLANS[qid](jcat)
    execute_plan(plan)
    jax_execute_plan(jplan)
    rows, jrows = profiling.plan_profile(plan), jax_profiling.plan_profile(jplan)
    assert [(r["operator"], r["output_rows"]) for r in rows] == \
        [(r["operator"], r["output_rows"]) for r in jrows]
    for r in rows:
        assert set(r) == {"operator", "walltime_s", "output_rows", "output_bytes",
                          "effective_gbps", "extra"}
        assert r["walltime_s"] > 0 and r["output_bytes"] >= 0
    text = profiling.format_profile(plan)
    assert text.splitlines()[0].split() == ["operator", "wall", "rows", "out", "GB/s",
                                            "%peak"]
    assert text.splitlines()[-1].startswith("TOTAL")
    assert len(text.splitlines()) == len(rows) + 2


def test_profile_roofline_is_the_h100s():
    assert profiling.HBM_PEAK_GBPS == 3350.0


def test_output_bytes_skip_lazy_columns():
    _, cat = catalogs()
    plan = TPCH_PLANS[6](cat)
    execute_plan(plan)
    for r, op in zip(profiling.plan_profile(plan), _post_order(plan)):
        out = op.get_output()
        want = sum(c.data.numel() * c.data.element_size()
                   + (c.validity.numel() if c.has_validity else 0)
                   for c in out.columns if not c.is_lazy)
        assert r["output_bytes"] == want


def _post_order(root):
    seen, out = set(), []

    def walk(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.inputs:
            walk(i)
        out.append(op)

    walk(root)
    return out


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_device_assert_under_the_switch(monkeypatch, on):
    monkeypatch.setenv("HYRISE_DEVICE_ASSERTS", "1" if on else "0")
    assert asserts.enabled() == jax_asserts.enabled() == on
    good = np.array([0, 3, 9], dtype=np.int64)
    bad = np.array([0, 3, 10], dtype=np.int64)
    asserts.assert_indices_in_range(torch.tensor(good), 10, "good")
    jax_asserts.assert_indices_in_range(good, 10, "good")
    for idx in (bad, -good - 1):
        if on:
            with pytest.raises(asserts.DeviceAssertionError, match="bad"):
                asserts.assert_indices_in_range(torch.tensor(idx), 10, "bad")
            with pytest.raises(jax_asserts.DeviceAssertionError, match="bad"):
                jax_asserts.assert_indices_in_range(idx, 10, "bad")
        else:
            asserts.assert_indices_in_range(torch.tensor(idx), 10, "bad")
            jax_asserts.assert_indices_in_range(idx, 10, "bad")
    if on:
        with pytest.raises(asserts.DeviceAssertionError):
            asserts.device_assert(torch.tensor([True, False]), "mixed")
        with pytest.raises(asserts.DeviceAssertionError):
            asserts.device_assert(False, "host bool")
    asserts.device_assert(torch.tensor([True, True]), "all")
    asserts.device_assert(torch.empty(0, dtype=torch.bool), "empty")


def test_gathers_check_their_indices(monkeypatch):
    """ops/materialize.py's gathers, where the JAX package checks them."""
    _, cat = catalogs()
    nation = cat.get_table("nation")
    bad = torch.tensor([0, nation.capacity], dtype=torch.int64)
    monkeypatch.setenv("HYRISE_DEVICE_ASSERTS", "1")
    with pytest.raises(asserts.DeviceAssertionError, match="gather.indices"):
        gather_columns_at(nation, bad)
    monkeypatch.setenv("HYRISE_DEVICE_ASSERTS", "0")
    cols = gather_columns_at(nation, bad)  # no check: the gather stays lazy
    assert all(c.is_lazy for c in cols)
