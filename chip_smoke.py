#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hyrise_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device  — requires CUDA (there is no CPU run) and prints the card's name
             and power limit as nvidia-smi reports them;
2. build   — compiles every CUDA source of hyrise_tpu_torch/kernels/csrc
             with nvcc for sm_90a, one nvcc process per source, all started
             together, and prints the build seconds, each nvcc's own seconds
             and ptxas' register counts;
3. kernels — each kernel against its plain torch version on the card, on
             seeded data at n = 1, 1000, 65,543 and 6,006,330 rows: K1
             (q6_scan) within 1e-5 relative of q6_compute (the bound of
             tests/test_pallas.py); K2 (q6_encoded) equal to the host's
             exact int64 total; K3 (segment_reduce_cells) as sum of float64,
             float32, int64 and int32 values, count, min and max into 1, 4,
             6, 25 and 64 cells (6 and 25 are Q1's and Q5's on the main
             path), integers equal and float sums within 1e-12 relative,
             and the same bits from two launches; K4
             (lookup_last_eq_lut) and K5 (expand_pairs) equal. Then the
             median device ms of each kernel, of its plain version and, for
             K3, of the one PyTorch call that computes the same sums
             (index_add_), at the largest n and the shapes of the main path,
             each timed shape first held against its plain version;
4. data    — all 8 TPC-H tables at SF1 generated and uploaded to the card;
5. main    — all 22 TPC-H queries through the operator DAG on the card at
             SF 0.01 (Q20 at 0.05, where it returns rows) against a sqlite
             database loaded from the same tables: integers and strings
             equal, floats within 1e-6 relative. Then, with every launch
             count at 0, all 22 at SF1: every value finite, rows wherever the
             small run had rows, Q6 and Q1 against numpy oracles computed
             from the same generated arrays, and Q3, Q5, Q9, Q10, Q14 and
             Q18 equal to the same plans run over CPU copies of the same
             tables; then the Q6 bench (hyrise_tpu_torch/bench_q6.py)
             through K1 and K2 on that lineitem. Every kernel's launch count
             must have risen.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SF = 1.0
SMALL_SF = 0.01
SMALL_SF_OF = {20: 0.05}       # scale factors at which every query returns rows
SEED = 19940607
KERNEL_SIZES = (1, 1000, 65_543, 6_006_330)
K3_CELLS = (1, 4, 6, 25, 64)   # 6 and 25: Q1's and Q5's groups on the main path
QUERY_REPS = 5
CPU_CHECKED = (3, 5, 9, 10, 14, 18)
# NVIDIA H100 SXM data sheet: device memory rate, and the float64 rate
# outside the tensor cores (half the 67 TFLOP/s float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 33.5e12


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


def turns(pairs, device, time_ms):
    """Median device ms per name; `pairs` lists (name, fn) in the order the
    timed blocks run (plain, kernel, kernel, plain), each block timed by
    bench_q6.time_ms."""
    ms = {}
    for name, fn in pairs:
        ms.setdefault(name, []).append(time_ms(fn, device))
    return {k: statistics.median(v) for k, v in ms.items()}


def k3_inputs(n: int, n_cells: int, device):
    """Seeded values of the four types and cell ids for K3. The float values
    are binary fractions small enough that every partial sum is exact in
    float64, so any summation order gives the same sum; `noisy` are
    arbitrary doubles for the run-to-run check."""
    rng = np.random.default_rng(n * 67 + n_cells)
    cell = rng.integers(-1, n_cells + 1, n).astype(np.int32)  # some rows outside
    values = {
        "float64": rng.integers(0, 10**7, n) / 128.0,
        "float32": (rng.integers(0, 2**14, n) / 4.0).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    noisy = rng.random(n) * 1e5 - 2e4
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {k: up(v) for k, v in values.items()}, up(cell), up(noisy)


def check_k3(n: int, device, group_reduce) -> float:
    """K3 against its plain version at n rows; returns the largest absolute
    difference of a float sum."""
    worst = 0.0
    for n_cells in K3_CELLS:
        values, cell, noisy = k3_inputs(n, n_cells, device)
        cases = [("count", None, None)]
        for name, v in values.items():
            cases.append(("sum", name, v))
            for kind in ("min", "max"):
                cases.append((kind, name, v))
        for kind, name, v in cases:
            sentinel = None
            if kind in ("min", "max"):
                if v.is_floating_point():
                    sentinel = float("inf") if kind == "min" else float("-inf")
                else:
                    info = torch.iinfo(v.dtype)
                    sentinel = info.max if kind == "min" else info.min
            got = group_reduce.segment_reduce_cells(v, cell, n_cells, kind, sentinel)
            ref = group_reduce.segment_reduce_cells_plain(v, cell, n_cells, kind, sentinel)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or got.shape != ref.shape:
                raise AssertionError(f"K3 {kind} {name} n={n} cells={n_cells}: "
                                     f"{got.dtype}{tuple(got.shape)} vs plain "
                                     f"{ref.dtype}{tuple(ref.shape)}")
            if kind == "sum" and got.dtype == torch.float64:
                diff = (got - ref).abs()
                if bool((diff > 1e-12 * ref.abs().clamp(min=1.0)).any()):
                    raise AssertionError(f"K3 sum {name} n={n} cells={n_cells}: "
                                         f"{got.tolist()} vs plain {ref.tolist()}")
                worst = max(worst, float(diff.max()))
            elif not torch.equal(got, ref):
                raise AssertionError(f"K3 {kind} {name} n={n} cells={n_cells}: "
                                     f"{got.tolist()} vs plain {ref.tolist()}")
        # arbitrary doubles: the same bits from two launches, and the plain
        # version's sum up to its own summation order
        a = group_reduce.segment_reduce_cells(noisy, cell, n_cells, "sum")
        b = group_reduce.segment_reduce_cells(noisy, cell, n_cells, "sum")
        ref = group_reduce.segment_reduce_cells_plain(noisy, cell, n_cells, "sum")
        if not torch.equal(a, b):
            raise AssertionError(f"K3 n={n} cells={n_cells}: two launches differ")
        if bool(((a - ref).abs() > 1e-9 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K3 noisy sum n={n} cells={n_cells}: {a.tolist()} "
                                 f"vs plain {ref.tolist()}")
    return worst


def k4_inputs(n: int, device):
    """Build keys (a quarter of n, duplicates, a fifth invalid, some outside
    the range), n probe keys and the key range."""
    rng = np.random.default_rng(n + 4)
    nb = n // 4 + 1
    lo, hi = -7, max(n, 8)
    build_keys = rng.integers(lo - 3, hi + 4, nb)
    valid = rng.random(nb) > 0.2
    probe_keys = rng.integers(lo - 5, hi + 6, n)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(build_keys), up(valid), up(probe_keys), lo, hi


def max_abs_diff(pairs) -> float:
    """Largest absolute difference over (got, plain) tensor pairs."""
    worst = 0.0
    for got, ref in pairs:
        if got.numel():
            worst = max(worst, float((got.to(torch.float64)
                                      - ref.to(torch.float64)).abs().max()))
    return worst


def check_k4(n: int, device, join_probe) -> float:
    """K4 against its plain version; returns the largest absolute
    difference (the check itself is equality)."""
    args = k4_inputs(n, device)
    matched, rows = join_probe.lookup_last_eq_lut(*args)
    ref_matched, ref_rows = join_probe.lookup_last_eq_lut_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(matched, ref_matched) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K4 lookup_last_eq_lut at n={n} differs from its plain version")
    if n > 1 and not bool(matched.any()):
        raise AssertionError(f"K4 at n={n}: nothing matched, the check is empty")
    return max_abs_diff(((matched, ref_matched), (rows, ref_rows)))


def k5_inputs(n: int, device):
    """n probe ranges of 0 to 3 build rows (one of them long, as a skewed
    key has) over a build side of n // 4 + 4 rows."""
    rng = np.random.default_rng(n + 5)
    nb = n // 4 + 4
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts = np.minimum(counts, nb).astype(np.int32)
    if n > 1000:
        counts[n // 2] = min(100_000, nb)
    lo = (rng.integers(0, nb, n) % (nb - counts + 1)).astype(np.int32)
    perm = rng.permutation(nb).astype(np.int64)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(lo), up(counts), up(perm)


def check_k5(n: int, device, join_probe):
    """K5 against its plain version; returns the number of pairs and the
    largest absolute difference (the check itself is equality)."""
    lo, counts, perm = k5_inputs(n, device)
    probe, rows = join_probe.expand_pairs(lo, counts, perm)
    ref_probe, ref_rows = join_probe.expand_pairs_plain(lo, counts, perm)
    torch.cuda.synchronize()
    if not (torch.equal(probe, ref_probe) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K5 expand_pairs at n={n} differs from its plain version")
    return probe.shape[0], max_abs_diff(((probe, ref_probe), (rows, ref_rows)))


def check_rows(got, want, what: str, table_eq) -> None:
    """Integers and strings equal, floats within 1e-6 relative, as row sets
    (ties of an ORDER BY may fall either way)."""
    ok, msg = table_eq.tables_equal(got, want, ordered=False, rel_tol=1e-6,
                                    abs_tol=0.0)
    if not ok:
        raise AssertionError(f"{what}: {msg}")


def check_finite(rows, what: str) -> None:
    for r in rows:
        for v in r:
            if isinstance(v, (float, np.floating)) and not np.isfinite(v):
                raise AssertionError(f"{what}: non-finite value in {r}")


def cpu_copy(tables):
    """The same tables as CPU tensors (metadata kept)."""
    from hyrise_tpu_torch.storage.column import Column
    from hyrise_tpu_torch.storage.table import Table
    out = {}
    for name, t in tables.items():
        cols = [Column(c.name, c.dtype, c.data.cpu(),
                       None if c.validity is None else c.validity.cpu(),
                       c.dictionary, unique=c.unique, val_range=c.val_range)
                for c in t.columns]
        out[name] = Table(cols, t.num_rows, name=name)
    return out


def catalog_of(tables):
    from hyrise_tpu_torch.storage.catalog import Catalog
    cat = Catalog()
    for name, t in tables.items():
        cat.add_table(name, t)
    return cat


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
    from hyrise_tpu_torch.kernels import build, group_reduce, join_probe, q6
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query
    from hyrise_tpu_torch.utils import table_eq
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for lib in (q6._library, group_reduce._library, join_probe._library):
        lib()
    log(f"build: {', '.join(f'{s}.cu' for s in build.SOURCES)} with nvcc for sm_90a, "
        f"in parallel, in {time.perf_counter() - t0:.2f} s")
    for source in build.SOURCES:
        text = build.build_log(source)
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for pair in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text) for b in pair]
        seconds = re.search(r"nvcc seconds: ([\d.]+)", text).group(1)
        log(f"build: {source}.cu: nvcc {seconds} s, {len(registers)} kernels, at most "
            f"{max(registers)} registers, {sum(spills)} bytes of spills (ptxas -v)")

    # -- 3. kernels against their plain versions -----------------------------
    k1_err = k2_err = k3_err = k4_err = k5_err = 0.0
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
        k3_err = max(k3_err, check_k3(n, device, group_reduce))
        k4_err = max(k4_err, check_k4(n, device, join_probe))
        pairs, err = check_k5(n, device, join_probe)
        k5_err = max(k5_err, err)
        log(f"kernels n={n}: K1 {got!r} vs plain {ref!r} "
            f"(rel {rel_diff(got, ref):.3e}); K2 {total} == exact {exact}; "
            f"K3 equal to plain in 13 reductions x {len(K3_CELLS)} cell counts, and bit-stable; "
            f"K4 equal; K5 equal over {pairs} pairs")
    # timed at the largest n, in turns: plain, kernel, kernel, plain
    n = KERNEL_SIZES[-1]
    k1_fn = lambda i: q6.q6_scan(*args[:5], 731 - i, 1096)  # noqa: E731
    k1_plain = lambda i: q6.q6_compute(*args[:5], 731 - i, 1096)  # noqa: E731
    k2_fn = lambda i: q6.q6_encoded(*eargs[:4], 731 - i, 1096)  # noqa: E731
    k2_plain = lambda i: q6.q6_encoded_reference(*eargs[:4], 731 - i, 1096)  # noqa: E731
    ms = turns((("k1_plain", k1_plain), ("k1", k1_fn), ("k1", k1_fn),
                ("k1_plain", k1_plain), ("k2_plain", k2_plain), ("k2", k2_fn),
                ("k2", k2_fn), ("k2_plain", k2_plain)), device, bench_q6.time_ms)
    log(f"kernels n={n} median device ms (CUDA events, L2 flushed) {card}: "
        f"K1 q6_scan {ms['k1']:.4f} vs plain q6_compute {ms['k1_plain']:.4f}; "
        f"K2 q6_encoded {ms['k2']:.4f} vs plain q6_encoded_reference {ms['k2_plain']:.4f}")
    log(f"kernels n={n} effective GB/s {card}: K1 {n * 17 / ms['k1'] / 1e6:.1f}, "
        f"K2 {n * 8 / ms['k2'] / 1e6:.1f}")

    # K3 at Q1's shape on the main path: float32 values summed into the 6
    # cells of (l_returnflag, l_linestatus); beside it float64 values into 1,
    # 4 and 64 cells. The library call is index_add_ on the same inputs,
    # already promoted to float64 with int64 cell ids.
    k3 = {}
    for label, dtype, n_cells in (("f32x6", "float32", 6), ("f64x1", "float64", 1),
                                  ("f64x4", "float64", 4), ("f64x64", "float64", 64)):
        values, cell, _ = k3_inputs(n, n_cells, device)
        v = values[dtype]
        cell = cell.clamp(0, n_cells - 1)  # every row inside, as after Q1's scan
        v64, cell64 = v.to(torch.float64), cell.to(torch.int64)
        kernel = lambda i, v=v, c=cell, k=n_cells: (  # noqa: E731
            group_reduce.segment_reduce_cells(v, c, k, "sum"))
        plain = lambda i, v=v, c=cell, k=n_cells: (  # noqa: E731
            group_reduce.segment_reduce_cells_plain(v, c, k, "sum"))
        library = lambda i, v=v64, c=cell64, k=n_cells: (  # noqa: E731
            torch.zeros(k, dtype=torch.float64, device=device).index_add_(0, c, v))
        got, ref = kernel(0), plain(0)
        if bool(((got - ref).abs() > 1e-12 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K3 sum {label} n={n}: {got.tolist()} vs plain "
                                 f"{ref.tolist()}")
        if not torch.equal(library(0), ref):
            raise AssertionError(f"K3 {label}: index_add_ is not the same function")
        k3_err = max(k3_err, float((got - ref).abs().max()))
        k3[label] = turns((("plain", plain), ("kernel", kernel), ("library", library),
                           ("kernel", kernel), ("plain", plain)), device, bench_q6.time_ms)
        k3[label]["bytes"] = n * (v.element_size() + 4) + n_cells * 8
        k3[label]["bound"] = max(k3[label]["bytes"] / PEAK_BYTES_PER_S,
                                 n / PEAK_F64_PER_S) * 1e3
        log(f"kernels n={n} K3 sum {label} median device ms {card}: kernel "
            f"{k3[label]['kernel']:.4f}, plain {k3[label]['plain']:.4f}, index_add_ "
            f"{k3[label]['library']:.4f}, bound {k3[label]['bound']:.4f} "
            f"({k3[label]['bytes'] / k3[label]['kernel'] / 1e6:.1f} GB/s)")
    k4_args = k4_inputs(n, device)
    k5_args = k5_inputs(n, device)
    k5_total = int(k5_args[1].sum())
    jm = turns((("k4_plain", lambda i: join_probe.lookup_last_eq_lut_plain(*k4_args)),
                ("k4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)),
                ("k4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)),
                ("k4_plain", lambda i: join_probe.lookup_last_eq_lut_plain(*k4_args)),
                ("k5_plain", lambda i: join_probe.expand_pairs_plain(*k5_args)),
                ("k5", lambda i: join_probe.expand_pairs(*k5_args)),
                ("k5", lambda i: join_probe.expand_pairs(*k5_args)),
                ("k5_plain", lambda i: join_probe.expand_pairs_plain(*k5_args))),
               device, bench_q6.time_ms)
    nb4 = k4_args[0].shape[0]
    # each input read once, each output written once (the table is scratch)
    k4_bytes = nb4 * (8 + 1) + n * 8 + n * (1 + 8)
    k5_bytes = n * (4 + 4) + k5_args[2].shape[0] * 8 + k5_total * 16
    k4_bound = k4_bytes / PEAK_BYTES_PER_S * 1e3
    k5_bound = k5_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"kernels n={n} median device ms {card}: K4 lookup_last_eq_lut ({nb4} build "
        f"rows, {n} probes, {k4_args[4] - k4_args[3] + 1} table entries) {jm['k4']:.4f} "
        f"vs plain {jm['k4_plain']:.4f}, bound {k4_bound:.4f}; K5 expand_pairs ({n} "
        f"ranges, {k5_total} pairs, cumsum included) {jm['k5']:.4f} vs plain "
        f"{jm['k5_plain']:.4f}, bound {k5_bound:.4f}")

    # -- 4. data -----------------------------------------------------------
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
    cat = catalog_of(tables)

    # -- 5. main path --------------------------------------------------------
    # 5a. every query on the card at a small scale against sqlite
    small_rows = {}
    t0 = time.perf_counter()
    for sf in sorted({SMALL_SF, *SMALL_SF_OF.values()}):
        qids = [q for q in sorted(TPCH_PLANS) if SMALL_SF_OF.get(q, SMALL_SF) == sf]
        small = dbgen.generate_tables(sf, SEED, device=device)
        oracle = SqliteOracle(small)
        for ddl in ("CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                    "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
                    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                    "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
                    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"):
            oracle.conn.execute(ddl)
        small_cat = catalog_of(small)
        for qid in qids:
            out = run_query(qid, small_cat)
            if out.device != device:
                raise AssertionError(f"Q{qid} at SF{sf} came out on {out.device}")
            rows = out.rows()
            check_rows(rows, oracle.query(TPCH_SQL[qid]), f"Q{qid} at SF{sf} vs sqlite",
                       table_eq)
            small_rows[qid] = len(rows)
        oracle.close()
    log(f"main: all {len(small_rows)} queries on {device} match sqlite at SF{SMALL_SF} "
        f"(Q20 at SF{SMALL_SF_OF[20]}): ints and strings equal, floats within 1e-6 "
        f"relative; rows {small_rows}; {time.perf_counter() - t0:.1f} s")

    # 5b. every query at SF1, the launch counts starting from 0
    wrappers = {"q6_scan": q6.q6_scan, "q6_encoded": q6.q6_encoded,
                "segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs}
    for w in wrappers.values():
        w.launches = 0
    specs, _ = dbgen.generate_specs(SF, SEED)["lineitem"]
    li = {name: payload for name, _, payload in specs}
    pool = li["l_shipdate"][1]
    results, wall = {}, {}
    for qid in sorted(TPCH_PLANS):
        first, median, rows = timed_query(lambda: run_query(qid, cat).rows())
        check_finite(rows, f"Q{qid} at SF{SF}")
        if small_rows[qid] and not rows:
            raise AssertionError(f"Q{qid} at SF{SF} returned no rows")
        results[qid], wall[qid] = rows, (first, median)
    log(f"main: SF{SF} wall ms (host clock, to rows on the host; first run, then "
        f"median of {QUERY_REPS}) {card}: "
        + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f} ({len(results[q])} rows)"
                    for q in sorted(wall)))
    log(f"main: SF{SF} all 22 queries, sum of medians "
        f"{sum(m for _, m in wall.values()):.3f} ms {card}")

    expected6 = q6_oracle(li, pool)
    if len(results[6]) != 1:
        raise AssertionError(f"Q6 result {results[6]}")
    dag_revenue = float(results[6][0][0])
    if rel_diff(dag_revenue, expected6) > 1e-6:
        raise AssertionError(f"Q6 DAG {dag_revenue} vs numpy oracle {expected6}")
    log(f"main: Q6 DAG revenue {dag_revenue!r} vs oracle {expected6!r} "
        f"(rel {rel_diff(dag_revenue, expected6):.3e})")
    worst = check_q1(results[1], q1_oracle(li, pool))
    log(f"main: Q1 {len(results[1])} groups match the numpy oracle "
        f"(keys and counts equal, floats within {worst:.3e} relative)")

    t0 = time.perf_counter()
    cpu_cat = catalog_of(cpu_copy(tables))
    before = {name: w.launches for name, w in wrappers.items()}
    for qid in CPU_CHECKED:
        check_rows(results[qid], run_query(qid, cpu_cat).rows(),
                   f"Q{qid} at SF{SF}, card vs CPU tensors", table_eq)
    if before != {name: w.launches for name, w in wrappers.items()}:
        raise AssertionError("a plan over CPU tensors launched a kernel")
    log(f"main: Q{', Q'.join(map(str, CPU_CHECKED))} at SF{SF} equal to the same plans "
        f"over CPU tensors (floats within 1e-6 relative) in "
        f"{time.perf_counter() - t0:.1f} s")

    qcols = bench_q6.prepare(li, device)
    bench = bench_q6.run(qcols)
    if rel_diff(bench["revenue_f32"], dag_revenue) > 1e-6:
        raise AssertionError(f"K1 revenue {bench['revenue_f32']} vs DAG {dag_revenue}")
    log(f"main: bench_q6 SF{SF} {card}: K1 revenue {bench['revenue_f32']!r} "
        f"(DAG {dag_revenue!r}), K2 exact {bench['revenue_encoded']!r}; "
        f"K1 {bench['q6_f32_ms']:.4f} ms ({bench['f32_gb_per_s']:.1f} GB/s), "
        f"K2 {bench['q6_encoded_ms']:.4f} ms ({bench['encoded_gb_per_s']:.1f} GB/s)")

    launches = {name: w.launches for name, w in wrappers.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"main: launches on the main path {launches}")

    csrc = "hyrise_tpu_torch/kernels/csrc/"

    def entry(name, source, replaces, err, t, plain, bound, library=None):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": t, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library}

    log(json.dumps({"kernels": [
        entry("q6_scan", "q6_scan.cu", "hyrise_tpu/kernels/pallas_scan.py:29",
              k1_err, ms["k1"], ms["k1_plain"], n * 17 / PEAK_BYTES_PER_S * 1e3),
        entry("q6_encoded", "q6_scan.cu", "hyrise_tpu/kernels/q6.py:87",
              k2_err, ms["k2"], ms["k2_plain"], n * 8 / PEAK_BYTES_PER_S * 1e3),
        entry("segment_reduce_cells", "group_reduce.cu",
              "hyrise_tpu/kernels/tpu_prims.py:470", k3_err, k3["f32x6"]["kernel"],
              k3["f32x6"]["plain"], k3["f32x6"]["bound"], k3["f32x6"]["library"]),
        entry("lookup_last_eq_lut", "join_probe.cu",
              "hyrise_tpu/kernels/tpu_prims.py:354", k4_err, jm["k4"], jm["k4_plain"],
              k4_bound),
        entry("expand_pairs", "join_probe.cu", "hyrise_tpu/ops/join.py:140", k5_err,
              jm["k5"], jm["k5_plain"], k5_bound),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
