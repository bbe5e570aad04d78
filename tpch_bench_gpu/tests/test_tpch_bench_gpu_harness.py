"""The harness on CPU tensors at small scale factors: the result line, the
check and its faults, the control, the trace reduction, and data-driven
cells, configurations and metrics."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpch_bench_gpu import calibrate, datagen, harness, trace
from tpch_bench_gpu.compare import compare, order_violations, sorted_answer
from tpch_bench_gpu.reference.common import Answer, Data

BENCH = Path(harness.__file__).resolve().parent
REPO = BENCH.parent
SEED = 2**40 + 17  # seeds run past 32 bits
CELLS = ["tpch-sf1-compiled.throughput"]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup", "checks"]


def run_small(workload, seconds=1.0, seed=SEED):
    return harness.run_cell(workload, seed, seconds, False, device="cpu", scale_factor=0.01,
                            log=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_cpu_tensors(workload):
    out = run_small(workload)
    assert list(out) == RESULT_KEYS  # checks come last
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    # a short window on a busy CPU may not reach every text; each text is
    # held against the reference on its own below
    assert 1 <= out["checks"]["answers_compared"]["value"] <= 22
    names = [m["name"] for m in harness.metrics_of(harness.bench_spec(), workload, False)]
    assert sorted(out["metrics"]) == sorted(names)
    assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}


@pytest.fixture(scope="module")
def small():
    """SF 0.01 uploaded through the harness onto CPU tensors, and the same
    arrays for the reference."""
    specs = datagen.generate_specs(0.01, SEED)
    config = json.loads((BENCH / "configs" / "tpch-sf1-compiled.json").read_text())
    return harness.upload(specs, "cpu", set(config["primary_keys"])), Data(specs, "cpu")


@pytest.mark.parametrize("qid", range(1, 23))
def test_reference_matches_the_port(small, qid):
    catalog, data = small
    req, frame = harness.execute(catalog, harness.sql_text(qid), False, 0, qid)
    assert req.error is None, req.error
    module = harness.reference_module(qid)
    ref = module.answer(data, torch.float64)
    cols = [frame.iloc[:, i].to_numpy() for i in range(frame.shape[1])]
    mismatches, err = compare(cols, ref, module.ORDER_BY)
    assert mismatches == 0
    assert err <= 1e-12


@pytest.fixture(scope="module")
def columns():
    specs = datagen.generate_specs(0.05, SEED)
    return {c: (kind, payload, n) for cols, n in specs.values() for c, kind, payload in cols}


TEXT = [("r_comment", 31, 115), ("n_comment", 31, 114), ("s_comment", 25, 100),
        ("c_comment", 29, 116), ("p_comment", 5, 22), ("ps_comment", 49, 198),
        ("o_comment", 19, 78), ("l_comment", 10, 43), ("s_address", 10, 40),
        ("c_address", 10, 40)]


@pytest.mark.parametrize("name,lo,hi", TEXT, ids=[t[0] for t in TEXT])
def test_text_is_drawn_per_row(columns, name, lo, hi):
    """Clause 4.2.2.10 / 4.2.2.7: a value a row, of a length in [lo, hi];
    nearly every value distinct, as in TPC-H; the pool sorted and every
    entry used."""
    kind, (codes, pool), n = columns[name]
    assert kind == "string" and len(codes) == n
    assert np.all(pool[:-1] < pool[1:])
    assert len(np.unique(codes)) == len(pool)
    lengths = np.char.str_len(pool)
    assert lengths.min() >= lo and lengths.max() <= hi
    assert len(pool) >= (0.9 if lo >= 10 else 0.6) * n


def test_names_phones_and_planted_comments(columns):
    _, (codes, pool), n = columns["p_name"]
    words = [p.split(" ") for p in pool[codes]]
    assert all(len(w) == 5 and len(set(w)) == 5 and set(w) <= set(datagen.P_NAME_WORDS)
               for w in words)
    assert len(pool) >= 0.99 * n
    _, (codes, pool), n = columns["c_phone"]
    nation = columns["c_nationkey"][1]
    phones = pool[codes]
    assert all(re.fullmatch(r"\d\d-\d{3}-\d{3}-\d{4}", p) for p in phones)
    assert np.array_equal(np.array([int(p[:2]) for p in phones]), nation + 10)
    _, (codes, pool), n = columns["c_name"]
    assert pool[codes[0]] == "Customer#000000001" and np.array_equal(codes, np.arange(n))
    _, (codes, pool), n = columns["s_comment"]
    text = pool[codes]
    assert sum(re.fullmatch(".*Customer.*Complaints.*", t) is not None for t in text) == 1
    assert sum(re.fullmatch(".*Customer.*Recommends.*", t) is not None for t in text) == 1


LIKE_PATTERNS = ["%special%requests%", "%Customer%Complaints%", "%green%", "forest%", "%BRASS",
                 "PROMO%", "MEDIUM POLISHED%", "a%", "%a", "%", "ab", "a_c%", "%_b_%", "_%_", "%ab%ba%",
                 "aa%aa", "%b%b%b", "", "abcabc"]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_the_references_like_is_sqls(pattern):
    """like_rows against LIKE as a regular expression, over TPC-H text and
    short strings of few letters, where parts overlap and repeat."""
    from tpch_bench_gpu.reference.common import like_rows

    rng = np.random.default_rng(7)
    short = ["".join(rng.choice(list("abc "), size=int(k))) for k in rng.integers(0, 9, 3000)]
    text = datagen.generate_specs(0.01, 5)
    pools = [np.array(short)] + [p[1] for cols, _ in text.values()
                                 for _, kind, p in cols if kind == "string"]
    rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                            for ch in pattern), re.DOTALL)
    for pool in pools:
        pool = np.asarray(pool, dtype=str)
        chars = torch.from_numpy(pool.view(np.int32).reshape(len(pool), -1).copy())
        got = like_rows(chars, pattern).numpy()
        want = np.array([rx.fullmatch(s) is not None for s in pool])
        assert np.array_equal(got, want), [s for s, g, w in zip(pool, got, want) if g != w][:5]


COLUMN = re.compile(r"\b(?:r|n|s|c|p|ps|o|l)_[a-z]+\b")


@pytest.mark.parametrize("qid", range(1, 23))
def test_scan_bytes_lists_the_texts_columns(qid):
    text = harness.sql_text(qid).lower()
    specs = datagen.generate_specs(0.01, 1)
    base = {c for cols, _ in specs.values() for c, _, _ in cols}
    listed = json.loads((BENCH / "scan_bytes" / f"q{qid:02d}.json").read_text())["columns"]
    assert set(listed) == set(COLUMN.findall(text)) & base
    assert harness.scan_bytes(specs, [qid])[qid] == sum(
        n * 4 for cols, n in specs.values() for c, _, _ in cols if c in listed)


def _alter(frame):
    frame = frame.copy()
    last = frame.columns[-1]
    value = frame[last].iloc[0]
    if isinstance(value, str):
        frame.loc[frame.index[0], last] = value + "x"
    elif isinstance(value, (float, np.floating)):
        frame[last] = frame[last].astype(np.float64)
        frame.loc[frame.index[0], last] = float(value) * (1 + 1e-6)
    else:
        frame.loc[frame.index[0], last] = value + 1
    return frame


def test_faults_fail_the_check(monkeypatch):
    """The timed path broken underneath: an answer altered where it is
    produced, half of an answer's rows left out, and a stale answer (the
    statement's state left as the previous one made it)."""
    from hyrise_tpu_torch.sql import pipeline
    from hyrise_tpu_torch.storage.table import Table

    to_pandas = Table.to_pandas
    get_result = pipeline.SQLPipeline.get_result_table
    faults = {
        "altered": (Table, "to_pandas", lambda self: _alter(to_pandas(self))),
        "half": (Table, "to_pandas",
                 lambda self: to_pandas(self).iloc[:len(to_pandas(self)) // 2]),
    }
    last = {}

    def stale(self):
        out = last.get("t") or get_result(self)
        last["t"] = get_result(self)
        return out

    faults["stale"] = (pipeline.SQLPipeline, "get_result_table", stale)
    for name, (owner, attr, fn) in faults.items():
        with monkeypatch.context() as m:
            m.setattr(owner, attr, fn)
            out = run_small("tpch-sf1-compiled.throughput", seconds=0.5)
        assert out["correct"] is False, name


def test_the_control_fails_and_the_program_passes():
    """The reference with float32 aggregates in the program's place fails
    the float limit on each of three seeds (the program passes it: the
    cell tests above)."""
    for workload in CELLS:
        limits = harness.limits_of(harness.cell(harness.bench_spec(), workload)[1])
        for seed in (3, 2**33 + 1, 12345):
            specs = datagen.generate_specs(0.05, seed)
            got = calibrate.control(specs, range(1, 23), "cpu")
            assert got["float_rel_err_max"] > limits["float_rel_err_max"], (workload, seed)


def test_compare_rows_in_any_tie_order():
    ref = Answer([np.array(["a", "b", "c"], dtype=object), np.array([2.0, 1.0, 1.0])],
                 ["str", "float"])
    order = [(1, "desc")]
    prog = [np.array(["a", "c", "b"], dtype=object), np.array([2.0, 1.0, 1.0])]
    assert compare(prog, ref, order) == (0, 0.0)
    swapped = [np.array(["c", "a", "b"], dtype=object), np.array([1.0, 2.0, 1.0])]
    assert compare(swapped, ref, order)[0] == 1  # out of ORDER BY order
    assert compare(prog[:1], ref, order)[0] > 0
    assert compare([prog[0][:2], prog[1][:2]], ref, order)[0] > 0
    close = [prog[0], np.array([2.0, 1.0 + 1e-12, 1.0])]
    assert compare(close, ref, order)[1] == pytest.approx(1e-12)
    nulls = [prog[0], np.array([2.0, None, 1.0], dtype=object)]
    assert compare(nulls, ref, order)[0] > 0
    assert order_violations(prog, ref.kinds, order) == 0
    shuffled = Answer([np.array(["c", "a", "b"], dtype=object), np.array([1.0, 2.0, 1.0])],
                      ["str", "float"])
    assert compare(sorted_answer(shuffled, order).columns, ref, order) == (0, 0.0)


def test_trace_union_gaps_and_names():
    events = [(100, 200, "k1"), (150, 300, "k2"), (500, 600, "k1"), (50, 60, "early")]
    spans = [[(0, 400, "execute q01"), (400, 1000, "fetch q01")],
             [(0, 1000, "frontend q22")]]
    t = trace.read(events, 100, 1000, spans)
    assert t.busy_s == pytest.approx(300 / 1e9)
    assert t.window_s == pytest.approx(900 / 1e9)
    assert t.device_ops[0] == ["k1", pytest.approx(200 / 1e9)]
    assert t.idle_gaps[0] == ["c1 fetch q01; c2 frontend q22", pytest.approx(400 / 1e9)]
    assert t.idle_gaps[1][1] == pytest.approx(200 / 1e9)


def test_metric_readers_report_nothing_without_a_trace():
    run = harness.Run({}, {}, [], {"setup_s": 1.0}, 1.0, {}, None)
    for name in ("device_idle_share", "scan_roofline_share", "compiled_retries", "qps.window"):
        assert harness.metric_reader(name).read(run) is None


def _subprocess(code, cwd, extra_path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), *map(str, extra_path)]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_new_cell_configuration_and_metric_need_no_edit(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added as new
    files (and entries in BENCHMARK.json) run with no existing file edited."""
    shutil.copytree(BENCH, tmp_path / "tpch_bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "tpch_bench_gpu"
    config = json.loads((bench / "configs" / "tpch-sf1-compiled.json").read_text())
    config.update(name="tpch-sf001", scale_factor=0.01)
    (bench / "configs" / "tpch-sf001.json").write_text(json.dumps(config))
    (bench / "limits" / "tpch-sf001.json").write_text(
        (bench / "limits" / "tpch-sf1-compiled.json").read_text())
    (bench / "traffic" / "one-stream.json").write_text(json.dumps(
        {"loop": "closed", "why": "one client", "streams": [[6, 1, 14]]}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return len(run.completed) or None\n")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tpch-sf001", "source": "test", "reduced": ["scale_factor"],
                            "file": "tpch_bench_gpu/configs/tpch-sf001.json", "why": "test"})
    spec["workloads"].append({"name": "tpch-sf001.one", "config": "tpch-sf001",
                              "traffic": "one-stream", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "count", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tpch-sf001.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    done = _subprocess(
        "import json; from tpch_bench_gpu import harness\n"
        "out = harness.run_cell('tpch-sf001.one', 5, 2.0, False, device='cpu')\n"
        "print(json.dumps(out))", tmp_path, [REPO])
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["checks"]["answers_compared"]["value"] == 3
    assert out["metrics"]["requests_done"]["value"] >= 3
    assert {"latency_geomean_ms", "setup_s", "requests_done"} <= set(out["metrics"])


def test_a_run_loads_no_jax_and_the_reference_no_program():
    done = _subprocess(
        "import sys; from tpch_bench_gpu import harness\n"
        "harness.run_cell('tpch-sf1-compiled.throughput', 9, 0.3, False, device='cpu',"
        " scale_factor=0.01, log=lambda *a: None)\n"
        "print(harness.forbidden_modules())", REPO)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
    done = _subprocess(
        "import sys, torch; from tpch_bench_gpu import harness, compare, datagen\n"
        "from tpch_bench_gpu.reference.common import Data\n"
        "d = Data(datagen.generate_specs(0.01, 3), 'cpu')\n"
        "[harness.reference_module(q).answer(d, torch.float64) for q in range(1, 23)]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'hyrise_tpu', 'hyrise_tpu_torch', 'jax', 'jaxlib', 'flax'}))", REPO)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + [BENCH / "compare.py", BENCH / "datagen.py"], ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names] + \
        [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert {n.split(".")[0] for n in names} <= {"__future__", "dataclasses", "re", "typing",
                                                "numpy", "torch", "tpch_bench_gpu"}


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    done = subprocess.run([sys.executable, "-m", "tpch_bench_gpu.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 3
    assert done.stdout == ""
    assert "CUDA" in done.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card_at_small_scale(card, workload):
    out = harness.run_cell(workload, SEED, 1.0, True, device=card, scale_factor=0.01,
                           log=lambda *a: None)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["metrics"]["scan_roofline_share"]["value"] <= 100
