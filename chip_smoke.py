#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hyrise_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device  — requires CUDA (there is no CPU run) and prints the card's name
             and power limit as nvidia-smi reports them;
2. build   — compiles the CUDA kernels from hyrise_tpu_torch/kernels/csrc
             with nvcc for sm_90a and prints the build seconds and ptxas'
             register counts;
3. kernels — each kernel against its plain torch version on the card, on
             seeded data at n = 1, 1000, 65,543 and 6,006,330 rows: K1
             (q6_scan) within 1e-5 relative of q6_compute (the bound of
             tests/test_pallas.py), K2 (q6_encoded) equal to the host's
             exact int64 total; then the median ms of each at the largest n;
4. data    — all 8 TPC-H tables at SF1 generated and uploaded to the card;
5. main    — with every launch count at 0: TPC-H Q6 and Q1 through the
             operator DAG, held against numpy oracles computed from the same
             generated arrays (keys and counts equal, floats within 1e-6
             relative, the float policy of ARCHITECTURE.md), then the Q6
             bench (hyrise_tpu_torch/bench_q6.py) through K1 and K2 on that
             lineitem; both counts must have risen.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SF = 1.0
SEED = 19940607
KERNEL_SIZES = (1, 1000, 65_543, 6_006_330)
QUERY_REPS = 5


def log(*parts) -> None:
    print(*parts, flush=True)


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def kernel_inputs(n: int, device):
    """Seeded Q6 columns in both layouts, as the JAX package's tests make
    them (tests/test_pallas.py, tests/test_q6_encoded.py)."""
    rng = np.random.default_rng(n)
    ship = rng.integers(0, 2557, n).astype(np.int32)
    dense = dict(
        ship=ship,
        disc=(rng.integers(0, 11, n) / 100).astype(np.float32),
        qty=rng.integers(1, 51, n).astype(np.float32),
        price=(rng.random(n) * 1e5).astype(np.float32),
        live=np.arange(n) < n - 3)
    encoded = dict(
        ship=ship.astype(np.int16),
        disc_cents=rng.integers(0, 11, n).astype(np.int8),
        qty=rng.integers(1, 51, n).astype(np.int8),
        price_cents=rng.integers(90_000, 10_495_000, n).astype(np.int32))
    exact = int(np.sum(np.where(
        (encoded["ship"] >= 731) & (encoded["ship"] < 1096)
        & (encoded["disc_cents"] >= 5) & (encoded["disc_cents"] <= 7)
        & (encoded["qty"] < 24),
        encoded["price_cents"].astype(np.int64)
        * encoded["disc_cents"].astype(np.int64), 0)))

    def up(d):
        return {k: torch.as_tensor(v, device=device) for k, v in d.items()}

    return up(dense), up(encoded), exact


def q6_oracle(li, pool) -> float:
    """Q6 revenue in numpy: float32 compares and products, float64 sum."""
    ship, _ = li["l_shipdate"]
    disc, qty, price = li["l_discount"], li["l_quantity"], li["l_extendedprice"]
    dates = pool[ship]
    m = ((dates >= "1994-01-01") & (dates < "1995-01-01")
         & (disc >= np.float32(0.06 - 0.01)) & (disc <= np.float32(0.06 + 0.01001))
         & (qty < np.float32(24)))
    return float(np.sum((price[m] * disc[m]).astype(np.float64)))


def q1_oracle(li, pool):
    """Q1 rows in numpy: float32 expressions, float64 sums, groups in key
    order."""
    ship, _ = li["l_shipdate"]
    rf_codes, rf_pool = li["l_returnflag"]
    ls_codes, ls_pool = li["l_linestatus"]
    m = pool[ship] <= "1998-12-01"
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    one = np.float32(1)
    disc_price = price * (one - disc)
    charge = disc_price * (one + tax)
    n_ls = len(ls_pool)
    gid = rf_codes[m].astype(np.int64) * n_ls + ls_codes[m]
    g = len(rf_pool) * n_ls

    def sums(v):
        return np.bincount(gid, weights=v.astype(np.float64), minlength=g)

    counts = np.bincount(gid, minlength=g)
    s_qty, s_price, s_disc = sums(qty), sums(price), sums(disc)
    s_disc_price, s_charge = sums(disc_price), sums(charge)
    rows = []
    for i in np.nonzero(counts)[0]:
        rows.append((str(rf_pool[i // n_ls]), str(ls_pool[i % n_ls]), s_qty[i],
                     s_price[i], s_disc_price[i], s_charge[i],
                     s_qty[i] / counts[i], s_price[i] / counts[i],
                     s_disc[i] / counts[i], int(counts[i])))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def check_q1(actual, expected) -> float:
    """Keys and counts equal, floats within 1e-6 relative; returns the
    largest relative float difference."""
    if len(actual) != len(expected):
        raise AssertionError(f"Q1: {len(actual)} groups, oracle {len(expected)}")
    worst = 0.0
    for a, e in zip(actual, expected):
        if a[0] != e[0] or a[1] != e[1] or int(a[9]) != e[9]:
            raise AssertionError(f"Q1 keys/counts differ: {a} vs {e}")
        for x, y in zip(a[2:9], e[2:9]):
            if not np.isfinite(float(x)):
                raise AssertionError(f"Q1 non-finite value in {a}")
            worst = max(worst, rel_diff(float(x), float(y)))
    if worst > 1e-6:
        raise AssertionError(f"Q1 floats differ by {worst:.3e} relative")
    return worst


def timed_query(run):
    """Host-clock ms of run() (which ends in a host read) over QUERY_REPS
    runs: (first, median), and the last result."""
    times, out = [], None
    for _ in range(QUERY_REPS):
        t0 = time.perf_counter()
        out = run()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[0], statistics.median(times), out


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(f"device: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    from hyrise_tpu_torch import bench_q6
    from hyrise_tpu_torch.kernels import build, q6
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import run_query

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    q6._library()
    log(f"build: q6_scan.cu with nvcc for sm_90a in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log("q6_scan").splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    # -- 3. kernels against their plain versions -----------------------------
    k1_err = k2_err = 0.0
    for n in KERNEL_SIZES:
        dense, enc, exact = kernel_inputs(n, device)
        args = (dense["ship"], dense["disc"], dense["qty"], dense["price"],
                dense["live"], 731, 1096)
        got, ref = float(q6.q6_scan(*args)), float(q6.q6_compute(*args))
        eargs = (enc["ship"], enc["disc_cents"], enc["qty"], enc["price_cents"],
                 731, 1096)
        total, plain_total = int(q6.q6_encoded(*eargs)), int(q6.q6_encoded_reference(*eargs))
        torch.cuda.synchronize()
        if not (np.isfinite(got) and rel_diff(got, ref) <= 1e-5):
            raise AssertionError(f"K1 q6_scan at n={n}: {got} vs q6_compute {ref}")
        if total != exact or plain_total != exact:
            raise AssertionError(f"K2 q6_encoded at n={n}: {total} "
                                 f"(plain {plain_total}) vs exact {exact}")
        k1_err = max(k1_err, abs(got - ref))
        k2_err = max(k2_err, float(abs(total - exact)))
        log(f"kernels n={n}: K1 {got!r} vs plain {ref!r} "
            f"(rel {rel_diff(got, ref):.3e}); K2 {total} == exact {exact}")
    # timed at the largest n, in turns: plain, kernel, kernel, plain
    k1_fn = lambda i: q6.q6_scan(*args[:5], 731 - i, 1096)  # noqa: E731
    k1_plain = lambda i: q6.q6_compute(*args[:5], 731 - i, 1096)  # noqa: E731
    k2_fn = lambda i: q6.q6_encoded(*eargs[:4], 731 - i, 1096)  # noqa: E731
    k2_plain = lambda i: q6.q6_encoded_reference(*eargs[:4], 731 - i, 1096)  # noqa: E731
    ms = {}
    for name, fn in (("k1_plain", k1_plain), ("k1", k1_fn), ("k1", k1_fn),
                     ("k1_plain", k1_plain), ("k2_plain", k2_plain), ("k2", k2_fn),
                     ("k2", k2_fn), ("k2_plain", k2_plain)):
        ms.setdefault(name, []).append(bench_q6.time_ms(fn, device))
    ms = {k: statistics.median(v) for k, v in ms.items()}
    n = KERNEL_SIZES[-1]
    log(f"kernels n={n} median device ms (CUDA events, L2 flushed) {card}: "
        f"K1 q6_scan {ms['k1']:.4f} vs plain q6_compute {ms['k1_plain']:.4f}; "
        f"K2 q6_encoded {ms['k2']:.4f} vs plain q6_encoded_reference {ms['k2_plain']:.4f}")
    log(f"kernels n={n} effective GB/s {card}: K1 {n * 17 / ms['k1'] / 1e6:.1f}, "
        f"K2 {n * 8 / ms['k2'] / 1e6:.1f}")

    # -- 4. data -----------------------------------------------------------
    q6.q6_scan.launches = 0
    q6.q6_encoded.launches = 0
    t0 = time.perf_counter()
    tables = dbgen.generate_tables(SF, SEED, device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    total_bytes = 0
    for name, t in tables.items():
        for c in t.columns:
            if c.data.device != device:
                raise AssertionError(f"{name}.{c.name} is on {c.data.device}")
            total_bytes += c.data.numel() * c.data.element_size()
        log(f"data: {name} {t.num_rows} rows, {len(t.columns)} columns on {t.device}")
    log(f"data: SF{SF} generated and uploaded in {gen_s:.1f} s, "
        f"{total_bytes / 1e6:.1f} MB of column tensors on {device}")
    cat = Catalog()
    for name, t in tables.items():
        cat.add_table(name, t)

    # -- 5. main path --------------------------------------------------------
    specs, _ = dbgen.generate_specs(SF, SEED)["lineitem"]
    li = {name: payload for name, _, payload in specs}
    pool = li["l_shipdate"][1]

    q6_first, q6_ms, q6_rows = timed_query(lambda: run_query(6, cat).rows())
    expected6 = q6_oracle(li, pool)
    if len(q6_rows) != 1 or not np.isfinite(float(q6_rows[0][0])):
        raise AssertionError(f"Q6 result {q6_rows}")
    dag_revenue = float(q6_rows[0][0])
    if rel_diff(dag_revenue, expected6) > 1e-6:
        raise AssertionError(f"Q6 DAG {dag_revenue} vs numpy oracle {expected6}")
    log(f"main: Q6 DAG revenue {dag_revenue!r} vs oracle {expected6!r} "
        f"(rel {rel_diff(dag_revenue, expected6):.3e})")

    q1_first, q1_ms, q1_rows = timed_query(lambda: run_query(1, cat).rows())
    worst = check_q1(q1_rows, q1_oracle(li, pool))
    log(f"main: Q1 {len(q1_rows)} groups match the numpy oracle "
        f"(keys and counts equal, floats within {worst:.3e} relative)")
    log(f"main: SF{SF} wall ms (host clock, to rows on the host) {card}: "
        f"Q6 DAG median {q6_ms:.3f} (first {q6_first:.3f}), "
        f"Q1 DAG median {q1_ms:.3f} (first {q1_first:.3f}), {QUERY_REPS} runs each")

    qcols = bench_q6.prepare(li, device)
    bench = bench_q6.run(qcols)
    if rel_diff(bench["revenue_f32"], dag_revenue) > 1e-6:
        raise AssertionError(f"K1 revenue {bench['revenue_f32']} vs DAG {dag_revenue}")
    log(f"main: bench_q6 SF{SF} {card}: K1 revenue {bench['revenue_f32']!r} "
        f"(DAG {dag_revenue!r}), K2 exact {bench['revenue_encoded']!r}; "
        f"K1 {bench['q6_f32_ms']:.4f} ms ({bench['f32_gb_per_s']:.1f} GB/s), "
        f"K2 {bench['q6_encoded_ms']:.4f} ms ({bench['encoded_gb_per_s']:.1f} GB/s)")

    launches = {"q6_scan": q6.q6_scan.launches, "q6_encoded": q6.q6_encoded.launches}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"main: launches on the main path {launches}")

    src = "hyrise_tpu_torch/kernels/csrc/q6_scan.cu"
    log(json.dumps({"kernels": [
        {"name": "q6_scan", "route": "cuda", "source": src,
         "replaces": "hyrise_tpu/kernels/pallas_scan.py:29",
         "launches": launches["q6_scan"], "max_abs_err": k1_err,
         "ms": ms["k1"], "plain_ms": ms["k1_plain"]},
        {"name": "q6_encoded", "route": "cuda", "source": src,
         "replaces": "hyrise_tpu/kernels/q6.py:87",
         "launches": launches["q6_encoded"], "max_abs_err": k2_err,
         "ms": ms["k2"], "plain_ms": ms["k2_plain"]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
