"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json names its configuration (configs/<name>.json, with its
`limits/<name>.json`) and its traffic mix (traffic/<name>.json); each SQL
text is queries/qNN.sql, its plain reference reference/qNN.py and the
columns it must read scan_bytes/qNN.json; each metric is metrics/<name>.py,
a `read(run)` that returns a number or None (nothing to read: the metric is
left out of the result).

A request is one statement through the program's default entry:
SQLPipelineBuilder(text).with_catalog(catalog), with compiled execution as
the configuration says, .create_pipeline().get_result_table(), then
Table.to_pandas(), which reads the result's columns to the host. Clients
are threads in a closed loop, each running its stream's order again and
again until the window ends; requests in flight then are waited for and
counted, and the window's seconds run to the last completion.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import resource
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from tpch_bench_gpu import datagen, trace as trace_mod
from tpch_bench_gpu.compare import compare

ROOT = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hyrise_tpu")


@dataclasses.dataclass
class Request:
    """One statement a client sent, with host-clock stamps (perf_counter
    seconds) and what the program's StatementMetrics say of it."""

    client: int
    qid: int
    t_issue: float
    t_result: float = 0.0   # get_result_table() returned
    t_done: float = 0.0     # the columns are on the host
    frontend_s: float = 0.0  # parse + translate + optimize + compile
    execute_s: float = 0.0   # taken after the device has finished
    compiled: bool = False
    retries: Optional[int] = None
    cpu_s: float = 0.0  # the client thread's CPU time over the request
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_issue

    @property
    def fetch_s(self) -> float:
        return self.t_done - self.t_result


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    workload: dict
    config: dict
    requests: List[Request]
    setup: Dict[str, float]
    window_s: float
    scan_bytes: Dict[int, int]
    peaks: Optional[dict]
    trace: Optional[trace_mod.Trace] = None

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.error is None]


# -- the files of the benchmark -------------------------------------------------


def bench_spec(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str, root: Path = ROOT):
    """(workload entry, configuration file's content, traffic file's
    content) of the cell `name`."""
    workloads = {w["name"]: w for w in spec["workloads"]}
    if name not in workloads:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(workloads)}")
    wl = workloads[name]
    entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = json.loads((root.parent / entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, config, traffic


def sql_text(qid: int, root: Path = ROOT) -> str:
    return (root / "queries" / f"q{qid:02d}.sql").read_text().strip()


def _load(path: Path, key: str):
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(qid: int, root: Path = ROOT):
    return _load(root / "reference" / f"q{qid:02d}.py", f"tpch_bench_gpu_reference_q{qid:02d}")


def metric_reader(name: str, root: Path = ROOT):
    return _load(root / "metrics" / f"{name}.py", "tpch_bench_gpu_metric_" + name.replace(".", "_"))


def metrics_of(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with a trace its per-layer ones."""
    return [m for m in spec["per_layer" if traced else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def limits_of(config: dict, root: Path = ROOT) -> Dict[str, float]:
    return json.loads((root / "limits" / f"{config['name']}.json").read_text())["limits"]


def scan_bytes(specs: dict, qids, root: Path = ROOT) -> Dict[int, int]:
    """The least bytes each query must read: every base-table column its
    text references, whole, at the width the generated arrays have (a
    string column is its 4-byte code a row)."""
    width = {}
    for cols, n in specs.values():
        for name, kind, payload in cols:
            codes = payload[0] if kind == "string" else payload
            width[name] = n * np.asarray(codes).dtype.itemsize
    out = {}
    for q in qids:
        cols = json.loads((root / "scan_bytes" / f"q{q:02d}.json").read_text())["columns"]
        out[q] = sum(width[c] for c in cols)
    return out


def peaks_of(kind: str, root: Path = ROOT) -> Optional[dict]:
    return json.loads((root / "peaks.json").read_text()).get(kind)


# -- the program under test -----------------------------------------------------


def upload(specs: dict, device, primary_keys) -> object:
    """The generated tables, through the port's storage API, into a new
    Catalog: each column uploaded by Column.from_numpy (a string column
    with its pool as the dictionary), the primary keys declared unique."""
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    from hyrise_tpu_torch.types import DataType

    types = {"int32": DataType.INT32, "float32": DataType.FLOAT32, "string": DataType.STRING}
    catalog = Catalog(device)
    for name, (cols, n) in specs.items():
        columns = []
        for col, kind, payload in cols:
            if kind == "string":
                codes, pool = payload
                column = Column.from_numpy(col, DataType.STRING, codes, dictionary=pool,
                                           device=device)
            else:
                column = Column.from_numpy(col, types[kind], payload, device=device)
            column.unique = col in primary_keys
            columns.append(column)
        catalog.add_table(name, Table(columns, n, name=name))
    return catalog


def execute(catalog, text: str, compiled: bool, client: int, qid: int):
    """One request: (Request, the result as a DataFrame, or None if it
    raised)."""
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder

    req = Request(client, qid, time.perf_counter())
    cpu = time.thread_time()
    try:
        pipeline = SQLPipelineBuilder(text).with_catalog(catalog) \
            .with_compiled_execution(compiled).create_pipeline()
        table = pipeline.get_result_table()
        req.t_result = time.perf_counter()
        frame = table.to_pandas()
        req.t_done = time.perf_counter()
        req.cpu_s = time.thread_time() - cpu
    except Exception:  # a failed request is counted, and the run goes on
        req.t_result = req.t_done = time.perf_counter()
        req.error = traceback.format_exc()
        return req, None
    st = pipeline.pipeline_statements[-1]
    m = st.metrics
    req.frontend_s = m.parse_s + m.translate_s + m.optimize_s + m.compile_s
    req.execute_s = m.execute_s
    req.compiled = bool(st.last_compiled)
    if req.compiled:
        req.retries = int(st.last_compiled_query.last_retries)
    return req, frame


def fingerprint(frame) -> str:
    import pandas as pd

    h = hashlib.sha1(repr([str(t) for t in frame.dtypes]).encode())
    h.update(pd.util.hash_pandas_object(frame, index=False).to_numpy().tobytes())
    return h.hexdigest()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN_MODULES})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


SAMPLE_SHARE = 0.1  # of the later answers of a (client, query), kept for the check


def _window(catalog, streams, sqls, compiled: bool, seconds: float, traced: bool, device,
            seed: int):
    """The measured window: (requests, the sampled answers as (request,
    frame), t_start, t_end, trace inputs or None). The check compares a
    sample drawn from the seed: each client's first answer to each query,
    and each later one with probability SAMPLE_SHARE; the others are
    dropped as a server drops what it has sent."""
    records: List[list] = [[] for _ in streams]
    sampled: List[list] = [[] for _ in streams]
    barrier = threading.Barrier(len(streams) + 1)
    stop = [0.0]

    def client(i: int) -> None:
        rng = np.random.default_rng([seed, i])
        seen = set()
        barrier.wait()
        order = streams[i]
        k = 0
        while time.perf_counter() < stop[0]:
            qid = order[k % len(order)]
            k += 1
            req, frame = execute(catalog, sqls[qid], compiled, i, qid)
            records[i].append(req)
            if frame is not None and (qid not in seen or rng.random() < SAMPLE_SHARE):
                seen.add(qid)
                sampled[i].append((req, frame))
            del frame

    threads = [threading.Thread(target=client, args=(i,), name=f"client{i + 1}")
               for i in range(len(streams))]
    for t in threads:
        t.start()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    wall_offset = time.time_ns() - time.perf_counter_ns()
    t_start = time.perf_counter()
    stop[0] = t_start + seconds
    barrier.wait()
    for t in threads:
        t.join()
    _sync(device)
    requests = [r for rec in records for r in rec]
    t_end = max([r.t_done for r in requests] + [t_start])
    trace_in = None
    if prof is not None:
        prof.stop()
        trace_in = (trace_mod.device_events(prof), wall_offset)
        del prof
    return requests, [x for s in sampled for x in s], t_start, t_end, trace_in


def _spans(requests: List[Request], n_clients: int, wall_offset: int):
    spans: List[list] = [[] for _ in range(n_clients)]
    ns = 1e9
    for r in requests:
        t_exec = r.t_result - r.execute_s
        for a, b, what in ((r.t_issue, t_exec, "frontend"), (t_exec, r.t_result, "execute"),
                           (r.t_result, r.t_done, "fetch")):
            spans[r.client].append((int(a * ns) + wall_offset, int(b * ns) + wall_offset,
                                    f"{what} q{r.qid:02d}"))
    return spans


def judge(specs: dict, requests: List[Request], answers, device, limits: Dict[str, float],
          acc=torch.float64, log=print) -> Dict[str, dict]:
    """Every distinct sampled answer (request, frame) against the plain
    reference's, each query's reference run once; a request that failed is
    unanswered. The compared numbers with their limits."""
    from tpch_bench_gpu.reference.common import Data

    by_query: Dict[int, dict] = {}
    unanswered = sum(r.error is not None for r in requests)
    for req, frame in answers:
        by_query.setdefault(req.qid, {}).setdefault(fingerprint(frame), frame)
    t0 = time.perf_counter()
    data = Data(specs, device)
    mismatches, widest, compared = 0, 0.0, 0
    for qid in sorted(by_query):
        module = reference_module(qid)
        ref = module.answer(data, acc)
        for frame in by_query[qid].values():
            cols = [frame.iloc[:, i].to_numpy() for i in range(frame.shape[1])]
            m, err = compare(cols, ref, module.ORDER_BY)
            compared += 1
            if m or err > limits["float_rel_err_max"]:
                log(f"q{qid:02d}: {m} exact mismatches, float relative error {err!r}")
            mismatches += m
            widest = max(widest, err)
    del data
    log(f"reference: {len(by_query)} queries, {compared} distinct answers compared in "
        f"{time.perf_counter() - t0:.3f} s")
    return {
        "unanswered": {"value": unanswered, "limit": 0},
        "answers_compared": {"value": compared, "limit": 1},
        "exact_mismatches": {"value": mismatches, "limit": limits["exact_mismatches"]},
        "float_rel_err_max": {"value": widest, "limit": limits["float_rel_err_max"]},
    }


def passed(checks: Dict[str, dict]) -> bool:
    """answers_compared must reach its limit; every other number must not
    pass its own."""
    return all(c["value"] >= c["limit"] if name == "answers_compared" else c["value"] <= c["limit"]
               for name, c in checks.items())


@dataclasses.dataclass
class Cell:
    """A cell's files and its generated data, ready to run."""

    workload: dict
    config: dict
    streams: List[List[int]]
    sqls: Dict[int, str]
    specs: dict
    data_s: float
    seed: int


def prepare(workload: str, seed: int, scale_factor: Optional[float] = None,
            device="cuda") -> Cell:
    """Read the cell's files and generate its data from `seed` (host
    arrays, the text drawn on `device`); `scale_factor` replaces the
    configuration's, for tests on CPU tensors."""
    wl, config, traffic = cell(bench_spec(), workload)
    streams = traffic["streams"]
    qids = sorted({q for s in streams for q in s})
    t = time.perf_counter()
    specs = datagen.generate_specs(config["scale_factor"] if scale_factor is None
                                   else scale_factor, seed, device)
    _sync(device)
    return Cell(wl, config, streams, {q: sql_text(q) for q in qids}, specs,
                time.perf_counter() - t, seed)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             t0: Optional[float] = None, scale_factor: Optional[float] = None,
             log=None, dump: Optional[str] = None) -> dict:
    """Run the cell once and return the result line's object. `t0` is the
    process's start on the perf_counter clock (set-up is counted from it);
    `dump` names a file for every request's record, for analysis."""
    t0 = time.perf_counter() if t0 is None else t0
    return run_prepared(prepare(workload, seed, scale_factor, device), seconds, traced, device,
                        t0, log, dump)


def run_prepared(c: Cell, seconds: float, traced: bool, device="cuda",
                 t0: Optional[float] = None, log=None, dump: Optional[str] = None) -> dict:
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = torch.device(device)
    compiled = bool(c.config["execution"]["compiled"])
    qids = sorted(c.sqls)

    t = time.perf_counter()
    catalog = upload(c.specs, device, set(c.config["primary_keys"]))
    _sync(device)
    t_upload = time.perf_counter() - t
    resident = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    t = time.perf_counter()
    warm = [execute(catalog, c.sqls[q], compiled, 0, q)[0] for q in qids]
    _sync(device)
    t_warm = time.perf_counter() - t
    for r in warm:
        if r.error:
            log(f"warm-up q{r.qid:02d} failed:\n{r.error}")
    if compiled:
        log(f"warm-up: {sum(r.compiled for r in warm)} of {len(warm)} texts run compiled")
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup = {"setup_s": time.perf_counter() - t0, "data_s": c.data_s, "upload_s": t_upload,
             "warm_s": t_warm, "resident_bytes": resident}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the peak is the window's own

    requests, answers, t_start, t_end, trace_in = _window(
        catalog, c.streams, c.sqls, compiled, seconds, traced, device, c.seed)
    is_cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    kind = torch.cuda.get_device_name(device) if is_cuda else "cpu"
    del catalog
    gc.unfreeze()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    run = Run(c.workload, c.config, requests, setup, t_end - t_start, scan_bytes(c.specs, qids),
              peaks_of(kind))
    if trace_in is not None:
        events, wall_offset = trace_in
        run.trace = trace_mod.read(events, int(t_start * 1e9) + wall_offset,
                                   int(t_end * 1e9) + wall_offset,
                                   _spans(requests, len(c.streams), wall_offset))
        del events
    if dump:
        Path(dump).write_text(json.dumps({
            "setup": setup, "window_s": run.window_s,
            "requests": [dict(dataclasses.asdict(r), t_issue=r.t_issue - t_start,
                              t_result=r.t_result - t_start, t_done=r.t_done - t_start)
                         for r in requests]}))
    failed = [r for r in requests if r.error]
    for r in failed[:3]:
        log(f"q{r.qid:02d} failed:\n{r.error}")
    _log_requests(requests, setup, log)

    checks = judge(c.specs, requests, answers, device, limits_of(c.config), log=log)
    metrics = {}
    for m in metrics_of(bench_spec(), c.workload["name"], traced):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": not failed and passed(checks),
        "attempted": len(requests),
        "failed": len(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if is_cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)},
        "setup": setup,
    }
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
        log(f"trace: {run.trace.events} device events, busy {run.trace.busy_s} s "
            f"of {run.trace.window_s} s")
    for name, check in checks.items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    out["checks"] = checks
    return out


def _log_requests(requests: List[Request], setup: Dict[str, float], log) -> None:
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f"; host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")
    done = [r for r in requests if r.error is None]
    log(f"latency samples: {len(done)}")
    by_q: Dict[int, list] = {}
    for r in done:
        by_q.setdefault(r.qid, []).append(r.latency_s * 1e3)
    log("median ms by query: " + ", ".join(
        f"q{q:02d} {np.median(v):.1f} ({len(v)})" for q, v in sorted(by_q.items())))
