"""The port's measurement tools (hyrise_tpu_torch/bench/tpch_bench.py,
reference_compare.py, scaling_bench.py and merge_reports.py) on CPU
tensors at SF 0.01, against the JAX package's scripts/ where there is
something to compare:

- tpch_bench: Q1, Q3 and Q6 through `plans`, `sql` and `compiled`; the
  report has every field of the JAX runner's, and the via in its context;
- reference_compare: Q1, Q6 and Q14 through the port's compiled form, with
  the verdicts of the JAX script's compare_query on the same rows and
  oracle, every exact cell equal to sqlite and the float aggregates within
  1e-6 relative of the sequential fold;
- scaling_bench: Q6 over 1, 2 and 4 shards answers alike;
- merge_reports: the JAX script's output on the same input files;
- the tools default to the card (a machine without one needs `--device
  cpu`), and their reports go under bench_reports/, which git ignores, so
  no tool writes into a file of the repo."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from hyrise_tpu_torch.bench import merge_reports, reference_compare, scaling_bench, tpch_bench

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SF = 0.01
_state = {}


def _catalog():
    if "cat" not in _state:
        _state["cat"] = tpch_bench.load_catalog(SF, "cpu")
    return _state["cat"]


def _jax_report_fields():
    """The keys of the JAX BenchmarkRunner's report, its context and a
    benchmark entry."""
    from hyrise_tpu.bench.runner import BenchmarkConfig, BenchmarkRunner

    runner = BenchmarkRunner(BenchmarkConfig(max_runs=1, warmup_runs=0), {"q": lambda: 1})
    runner.run()
    rep = runner.report()
    return set(rep), set(rep["context"]), set(rep["benchmarks"][0])


@pytest.mark.parametrize("via", ["plans", "sql", "compiled"])
def test_tpch_bench_report_has_the_jax_runner_fields(via, tmp_path):
    out = tmp_path / "report.json"
    rep = tpch_bench.run_suite(_catalog(), [1, 3, 6], via, runs=2, warmup=1, sf=SF,
                               out=str(out))
    top, context, entry = _jax_report_fields()
    assert set(rep) >= top and set(rep["context"]) >= context
    assert rep["context"]["via"] == via and rep["context"]["scale_factor"] == SF
    assert [b["name"] for b in rep["benchmarks"]] == ["TPC-H 01", "TPC-H 03", "TPC-H 06"]
    for b in rep["benchmarks"]:
        assert set(b) >= entry
        assert b["iterations"] == 2 and 0 < b["min_time_ms"] <= b["max_time_ms"]
    assert json.loads(out.read_text())["benchmarks"] == rep["benchmarks"]


def test_tpch_bench_main(tmp_path):
    out = tmp_path / "sub" / "report.json"
    rep = tpch_bench.main(["--sf", str(SF), "--runs", "1", "--warmup", "0", "--queries", "6",
                           "--via", "sql-compiled", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    assert rep["context"]["devices"] == ["cpu"] and rep["context"]["tables_on"] == "cpu"


@pytest.mark.parametrize("qid", [1, 6, 14])
def test_reference_compare_verdicts_equal_the_jax_scripts(qid):
    from scripts.reference_compare import SPECS as JAX_SPECS
    from scripts.reference_compare import compare_query as jax_compare_query

    cat = _catalog()
    if "oracle" not in _state:
        _state["oracle"] = reference_compare.make_oracle(
            {name: cat.get_table(name) for name in cat.table_names()})
    oracle = _state["oracle"]
    result = reference_compare.compare(cat, oracle, [qid], via="compiled")
    ours = result["queries"][f"q{qid}"]
    run, = tpch_bench.make_queries(cat, [qid], "compiled").values()
    rows = run().rows()
    theirs = jax_compare_query(qid, rows, oracle, JAX_SPECS[qid])
    mine = reference_compare.compare_query(qid, rows, oracle, reference_compare.SPECS[qid])
    assert {k: mine[k] for k in theirs} == theirs
    for key in ("rows", "oracle_rows", "exact_cells", "exact_mismatches", "int_exact",
                "float_cells"):
        assert ours[key] == theirs[key]
    assert ours["int_exact"] and ours["float_cells"] > 0
    assert ours["max_rel"] <= 1e-6
    assert result["summary"]["all_int_exact"]


def test_reference_compare_main(tmp_path):
    out = tmp_path / "rc.json"
    report = reference_compare.main(["--sf", str(SF), "--queries", "6,12", "--device", "cpu",
                                     "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report["queries"]) == {"q6", "q12"} and report["summary"]["all_int_exact"]
    assert report["via"] == "compiled" and report["devices"] == ["cpu"]


def test_scaling_bench_answers_alike(tmp_path):
    report = scaling_bench.run_scaling(_catalog(), [6], [1, 2, 4], runs=2, device="cpu")
    per_mesh = report["queries"][6]
    assert sorted(per_mesh) == [1, 2, 4]
    assert all(e["answer_equal"] and e["rows_per_s"] > 0 for e in per_mesh.values())
    assert per_mesh[1]["efficiency_vs_1_shard"] is None
    assert all(per_mesh[n]["efficiency_vs_1_shard"] > 0 for n in (2, 4))
    assert report["context"]["shards_share_one_device"] is True
    out = tmp_path / "s.json"
    scaling_bench.main(["--sf", str(SF), "--runs", "1", "--queries", "6", "--meshes", "1,2",
                        "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["queries"]["6"]["2"]["answer_equal"]


def test_merge_reports_merges_as_the_jax_script(tmp_path):
    first = {"context": {"scale_factor": 1}, "benchmarks": [
        {"name": "TPC-H 02", "real_time_ms": 3.0}, {"name": "TPC-H 01", "real_time_ms": 1.0}]}
    second = {"benchmarks": [{"name": "TPC-H 01", "real_time_ms": 2.0}]}
    third = {"context": {"scale_factor": 10}, "benchmarks": [
        {"name": "TPC-H 03", "real_time_ms": 5.0}]}
    paths = []
    for i, rep in enumerate((first, second, third)):
        paths.append(tmp_path / f"in{i}.json")
        paths[-1].write_text(json.dumps(rep))
    ins = [str(p) for p in paths]
    ours = tmp_path / "ours.json"
    merge_reports.main([str(ours)] + ins)
    theirs = tmp_path / "theirs.json"
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "merge_reports.py"),
                           str(theirs)] + ins, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert [b["real_time_ms"] for b in json.loads(ours.read_text())["benchmarks"]] == \
        [2.0, 3.0, 5.0]


TOOLS = {"tpch_bench": tpch_bench, "reference_compare": reference_compare,
         "scaling_bench": scaling_bench}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tools_default_to_the_card_and_write_outside_the_repo(name, monkeypatch):
    """Without --device a tool asks for the card; its default report lies
    under bench_reports/, which .gitignore lists and git tracks nothing of."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        return seen["args"]

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        TOOLS[name].main([])
    args = seen["args"]
    assert args.device == "cuda"
    out = pathlib.PurePosixPath(args.out)
    assert out.parts[0] == tpch_bench.REPORT_DIR and not out.is_absolute()
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{tpch_bench.REPORT_DIR}/" in ignored
    if (REPO / ".git").exists():
        tracked = subprocess.run(["git", "ls-files", tpch_bench.REPORT_DIR], cwd=REPO,
                                 capture_output=True, text=True, timeout=60)
        assert tracked.returncode == 0 and tracked.stdout == ""
