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
             (lookup_last_eq_lut: a memset, a build and a probe of four rows
             a thread from one C call) equal and the same bits from two
             launches, at 65,543 and 6,006,330 rows also from views one
             element into their buffers, with every probe key outside the
             range, an empty build side, every build row invalid, a third of
             the build rows on one key, a table of LUT_MAX_ENTRIES entries
             and 0 to 9 build rows against 1 to 9 probes; K5 (expand_pairs:
             a scan of the counts whose tiles hand their sums on through
             status words, then an expansion whose blocks own 2,048 output
             positions) equal, at those two sizes also in 200 launches in a
             row, with all ranges empty but five, as one range over the whole
             build side, as the triangular ranges of a `<` join, as one range
             of 150,000 pairs, at totals of 0, 1, one output tile and one
             more, at range counts around the scan's tile, from views, and
             five kinds of ranges outside the build side must raise; K6
             (fused_cells_reduce) in four shapes and K8 (lookup_last_eq) on
             int64 and float64 keys, with a hot key and an empty build side.
             K7 (segment_reduce_sorted, which works on tiles of 2,048
             positions of the group order): sum, min and max of the four
             types and the count, with and without the permutation and the
             validity column, at about 4 rows a group, at 1,000 groups, as
             one group, with a third of the rows in one group, with every
             boundary on a tile boundary, with runs of empty groups at both
             ends and on a tile boundary, and with starts[0] > 0; integers
             equal, float64 sums within 1e-12 relative (exact binary
             fractions, so any order of summation gives the same sum), and
             the same bits from two launches of every case (no atomics touch
             a result: a sum's order is fixed by the group offsets alone).
             K9 (compact_indices, one pass in one launch whose tiles hand
             their counts on through status words): equal at five
             selectivities, from an aligned mask and from a view one byte
             into it, and at 65,543 and 6,006,330 rows 200 launches in a
             row, each held against the plain version. Then the median
             device ms of each kernel, of its plain version and of the
             PyTorch call that computes the same function where there is one
             (index_add_ for K3; for K7 index_add_ and torch.segment_reduce,
             without and with the index_select that gathers the values;
             torch.nonzero for K9), at the largest n and the shapes of the
             main path (K9 also on a 1,000-row mask, as a view of its
             worst-case buffer and as a copy; K5 also with a third of the
             pairs in one range, with ranges and build side in order and at
             100,000 ranges; K4 also with its probe keys in order), each
             timed shape first held against its plain version; and for K4, K5, K7 and K9 the
             kernels' own device time from one torch.profiler run per shape,
             which for K4 and K5 must show at most two kernels and a memset
             a call;
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
             through K1 and K2 on that lineitem. The launch count of each of
             K1-K5 must have risen;
6. sql     — the SQL entry point (SQLPipelineBuilder: parse, LQP, optimize,
             physical plan, execute) on the card: the 22 TPC-H texts at
             SF 0.01 (Q20 at 0.05) against the same sqlite databases as
             phase 5 and the SELECTs of tests/sql_corpus.sql over its four
             small tables against sqlite (integers and strings equal, floats
             within 1e-6 relative; a statement that needs the 1e-4 of
             tests/test_sql_corpus.py is named), with every launch count at 0
             again before them; then the 22 texts at SF1, each equal as a row set
             (1e-6 relative) to the rows phase 5 got from the hand plan of the
             same query: first run and median of 5 with the plan cache on,
             and the stage seconds of StatementMetrics. Q1's and Q6's plans
             must hold a FusedFilterAggregate that did not fall back, and
             the launch count of each of K6-K9 must have risen.

Phases 5 and 6 also print the mean rows per launch of K4, K5, K7 and K9 and
K5's mean pairs per launch (the wrappers count the rows they are given), so
their launch counts can be read against sizes. After phase 6 comes the
script's run time, the build included. The line before the last is
{"kernels": [...]}; the last line is
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


def same_lookup(args, join_probe, what: str) -> float:
    """K4 on `args` equal to its plain version, and the same bits from two
    launches; returns the largest absolute difference."""
    matched, rows = join_probe.lookup_last_eq_lut(*args)
    again = join_probe.lookup_last_eq_lut(*args)
    ref_matched, ref_rows = join_probe.lookup_last_eq_lut_plain(*args)
    torch.cuda.synchronize()
    if matched.dtype != torch.bool or rows.dtype != torch.int64:
        raise AssertionError(f"K4 {what}: {matched.dtype}, {rows.dtype}")
    if not (torch.equal(matched, ref_matched) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K4 lookup_last_eq_lut {what} differs from its plain version")
    if not (torch.equal(matched, again[0]) and torch.equal(rows, again[1])):
        raise AssertionError(f"K4 lookup_last_eq_lut {what}: two launches differ")
    return max_abs_diff(((matched, ref_matched), (rows, ref_rows)))


def check_k4(n: int, device, join_probe) -> float:
    """K4 against its plain version; returns the largest absolute
    difference (the check itself is equality)."""
    args = k4_inputs(n, device)
    worst = same_lookup(args, join_probe, f"at n={n}")
    if n > 1 and not bool(join_probe.lookup_last_eq_lut(*args)[0].any()):
        raise AssertionError(f"K4 at n={n}: nothing matched, the check is empty")
    return worst


K4_SHAPES = ("views one element into a buffer", "every probe key outside the range",
             "empty build side", "every build row invalid",
             "a third of the build rows on one key", "a table of LUT_MAX_ENTRIES entries",
             "lengths 1 to 9")


def check_k4_shapes(n: int, device, join_probe) -> float:
    """K4 in the K4_SHAPES at n probe rows, each equal to the plain version
    and the same bits from two launches."""
    build_keys, valid, probe_keys, lo, hi = k4_inputs(n + 1, device)
    nb = build_keys.shape[0]
    worst = 0.0
    views = (build_keys[1:], valid[1:], probe_keys[1:], lo, hi)
    if views[0].data_ptr() % 16 == build_keys.data_ptr() % 16:
        raise AssertionError("K4: the view is not off its buffer's 16-byte boundary")
    one_key = torch.where(torch.rand(nb, device=device) < 1 / 3, build_keys[0], build_keys)
    rng = np.random.default_rng(n + 44)
    top = join_probe.LUT_MAX_ENTRIES - 1
    wide = [torch.as_tensor(rng.integers(-3, top + 4, k), device=device) for k in (nb, n)]
    cases = {
        K4_SHAPES[0]: views,
        K4_SHAPES[1]: (build_keys, valid, probe_keys + (hi - lo + 50), lo, hi),
        K4_SHAPES[2]: (build_keys[:0], valid[:0], probe_keys, lo, hi),
        K4_SHAPES[3]: (build_keys, torch.zeros_like(valid), probe_keys, lo, hi),
        K4_SHAPES[4]: (one_key, valid | True, probe_keys, lo, hi),
        K4_SHAPES[5]: (wide[0], valid, wide[1], 0, top),
    }
    for what, args in cases.items():
        worst = max(worst, same_lookup(args, join_probe, f"{what}, n={n}"))
    for shape in (K4_SHAPES[1], K4_SHAPES[2], K4_SHAPES[3]):
        if bool(join_probe.lookup_last_eq_lut(*cases[shape])[0].any()):
            raise AssertionError(f"K4 {shape}: something matched")
    for nb_small in range(0, 10):
        for nq in range(1, 10):
            for off in (0, 1):  # whole buffers, and views one element in
                args = (build_keys[off:off + nb_small], valid[off:off + nb_small],
                        build_keys[off + 3:off + 3 + nq], lo, hi)
                worst = max(worst, same_lookup(args, join_probe,
                                               f"{nb_small} build rows, {nq} probes"))
    return worst


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


def k5_skewed_inputs(n: int, device):
    """k5_inputs with one range made as long as half of all the others
    together: a third of the pairs come from one probe row."""
    lo, counts, perm = k5_inputs(n, device)
    counts = counts.clone()
    counts[n // 2] = 0
    big = int(counts.sum()) // 2
    perm = torch.cat([perm, torch.arange(big, device=device)])
    lo = lo.clone()
    lo[n // 3], counts[n // 3] = 0, big
    return lo, counts, perm


def same_pairs(args, join_probe, what: str):
    """K5 on `args` equal to its plain version; returns the number of pairs
    and the largest absolute difference."""
    probe, rows = join_probe.expand_pairs(*args)
    ref_probe, ref_rows = join_probe.expand_pairs_plain(*args)
    torch.cuda.synchronize()
    if probe.dtype != torch.int64 or rows.dtype != torch.int64:
        raise AssertionError(f"K5 {what}: {probe.dtype}, {rows.dtype}")
    if not (torch.equal(probe, ref_probe) and torch.equal(rows, ref_rows)):
        raise AssertionError(f"K5 expand_pairs {what} differs from its plain version")
    return probe.shape[0], max_abs_diff(((probe, ref_probe), (rows, ref_rows)))


K5_REPEATS = 200               # launches per size in the repeated check
K5_REPEATED_SIZES = (65_543, 6_006_330)
K5_BAD_RANGES = {"end past build": ([0, 3], [1, 2]), "negative lo": ([-1, 0], [1, 1]),
                 "negative count": ([0, 0], [1, -1]),
                 "empty range past build": ([5, 0], [0, 1]),
                 "end past int32": ([2**31 - 1, 0], [2**31 - 1, 1])}


def check_k5(n: int, device, join_probe):
    """K5 against its plain version; at the K5_REPEATED_SIZES also
    K5_REPEATS launches in a row, each held against the plain version (a
    look-back that misses a tile once in a hundred launches fails here).
    Returns the number of pairs and the largest absolute difference (the
    check itself is equality)."""
    args = k5_inputs(n, device)
    pairs, worst = same_pairs(args, join_probe, f"at n={n}")
    if n in K5_REPEATED_SIZES:
        ref = join_probe.expand_pairs_plain(*args)
        for i in range(K5_REPEATS):
            got = join_probe.expand_pairs(*args)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"K5 expand_pairs at n={n}: launch {i} of "
                                     f"{K5_REPEATS} differs from its plain version")
    return pairs, worst


def check_k5_shapes(n: int, device, join_probe) -> float:
    """K5 in the shapes its two kernels have to get right, each equal to the
    plain version: n ranges of which all but five are empty; one range over
    the whole build side; the triangular ranges of a `<` join; one range of
    150,000 pairs among empty ones; totals of 0, 1, one output tile and one
    more; range counts around the scan's tile; ranges as views one element
    into their buffers; and the K5_BAD_RANGES, which must raise."""
    up = lambda a, dtype=np.int32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, dtype=dtype), device=device)
    scan_tile, out_tile = join_probe.scan_tile_rows(), join_probe.out_tile_pairs()
    rng = np.random.default_rng(n + 55)
    nb = n // 4 + 4
    perm = up(rng.permutation(nb), np.int64)
    cases = {}
    few = np.zeros(n, dtype=np.int32)
    few[rng.integers(0, n, 5)] = rng.integers(1, 4, 5)
    cases[f"{n} ranges, all empty but 5"] = (up(np.minimum(few, 1)), up(few), perm)
    cases["one range over the whole build side"] = (up([0]), up([nb]), perm)
    side = 3000
    cases[f"triangular, {side} ranges"] = (up(np.zeros(side)), up(np.arange(side)),
                                          up(rng.permutation(side), np.int64))
    long_one = np.zeros(1000, dtype=np.int32)
    long_one[500] = min(150_000, nb)
    cases["one range of 150,000 pairs"] = (up(np.zeros(1000)), up(long_one), perm)
    for total in (0, 1, out_tile, out_tile + 1):
        counts = np.zeros(5000, dtype=np.int32)
        for _ in range(total):
            counts[rng.integers(0, 5000)] += 1
        cases[f"a total of {total}"] = (up(rng.integers(0, nb - 8, 5000)), up(counts), perm)
    for ranges in (scan_tile - 1, scan_tile, scan_tile + 1):
        counts = np.minimum(rng.integers(0, 4, ranges + 1), nb)
        lo = rng.integers(0, nb, ranges + 1) % (nb - counts + 1)
        cases[f"{ranges} ranges"] = (up(lo)[:ranges], up(counts)[:ranges], perm)
        counts = np.minimum(counts, nb - 1)  # perm[1:] is one row shorter
        cases[f"{ranges} ranges as views"] = (up(lo % (nb - counts))[1:], up(counts)[1:],
                                              perm[1:])
    worst, totals = 0.0, {}
    for what, args in cases.items():
        totals[what], err = same_pairs(args, join_probe, f"{what}, n={n}")
        worst = max(worst, err)
    for total in (0, 1, out_tile, out_tile + 1):
        if totals[f"a total of {total}"] != total:
            raise AssertionError(f"K5: the case of {total} pairs has another total")
    if totals[f"triangular, {side} ranges"] != side * (side - 1) // 2:
        raise AssertionError("K5: the triangular case has another total")
    small_perm = torch.arange(4, device=device)
    for what, (lo, counts) in K5_BAD_RANGES.items():
        try:
            join_probe.expand_pairs(torch.tensor(lo, dtype=torch.int32, device=device),
                                    torch.tensor(counts, dtype=torch.int32, device=device),
                                    small_perm)
        except ValueError as exc:
            if "outside the build side" not in str(exc):
                raise
        else:
            raise AssertionError(f"K5: ranges with {what} did not raise on the card")
    return worst


def exact_values(rng, n: int, device):
    """Seeded values of the four types. The float values are binary
    fractions small enough that every partial sum is exact in float64, so any
    summation order gives the same sum."""
    values = {
        "float64": rng.integers(0, 10**7, n) / 128.0,
        "float32": (rng.integers(0, 2**14, n) / 4.0).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in values.items()}


def same_reduction(got, ref, what: str) -> float:
    """Dtype and shape equal; a float64 result within 1e-12 relative, any
    other equal. Returns the largest absolute difference."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
                             f"{ref.dtype}{tuple(ref.shape)}")
    if got.numel() == 0:
        return 0.0
    if got.dtype == torch.float64:
        both_inf = torch.isinf(got) & (got == ref)  # an empty group's extreme
        diff = torch.where(both_inf, 0.0, (got - ref).abs())
        if bool((diff > 1e-12 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"{what}: differs from plain by {float(diff.max())}")
        return float(diff.max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: differs from its plain version")
    return 0.0


def k6_inputs(n: int, shape: str, device):
    """(mask, keys, sizes, slots) for K6. 'q1': Q1's launch, two code
    columns of 3 x 2 cells, the sums of five float32 inputs (two of them
    read by a second slot, as AVG shares SUM's input) and COUNT(*), 98% of
    the rows. 'q6': no key, one float32 sum, 2% of the rows. 'mixed': 64
    cells, the four input types, sum, min, max and count, two validity
    columns. 'split': 64 cells and 16 nullable float64 sums, more
    accumulators than one launch holds."""
    rng = np.random.default_rng(n * 31 + len(shape))
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    v = exact_values(rng, n, device)
    share = {"q1": 0.98, "q6": 0.02}.get(shape, 0.7)
    mask = up(rng.random(n) < share)
    if shape == "q1":
        sizes = [3, 2]
        f = [up((rng.integers(0, 2**14, n) / 4.0).astype(np.float32)) for _ in range(5)]
        slots = [(f[0], None, "sum"), (f[1], None, "sum"), (f[2], None, "sum"),
                 (f[3], None, "sum"), (f[0], None, "sum"), (f[1], None, "sum"),
                 (f[4], None, "sum"), (None, None, "count")]
    elif shape == "q6":
        sizes, slots = [], [(v["float32"], None, "sum")]
    elif shape == "mixed":
        sizes = [4, 4, 4]
        va, vb = up(rng.random(n) < 0.6), up(rng.random(n) < 0.9)
        slots = [(v["float64"], va, "sum"), (v["int64"], None, "sum"),
                 (v["int32"], va, "min"), (v["float32"], None, "max"),
                 (v["int64"], vb, "max"), (v["float64"], vb, "min"),
                 (v["int32"], None, "sum"), (None, va, "count"), (None, None, "count")]
    else:
        sizes = [8, 8]
        slots = [(up(rng.integers(0, 10**7, n) / 128.0), up(rng.random(n) < 0.8), "sum")
                 for _ in range(16)]
    keys = [up(rng.integers(0, size, n).astype(np.int32)) for size in sizes]
    return mask, keys, sizes, slots


def check_k6(n: int, device, fused_reduce) -> float:
    """K6 against its plain version in four shapes; the same bits from two
    launches. Returns the largest absolute difference of a float sum."""
    worst = 0.0
    for shape, launches in (("q1", 1), ("q6", 1), ("mixed", 1), ("split", 3)):
        args = k6_inputs(n, shape, device)
        before = fused_reduce.fused_cells_reduce.launches
        counts, results = fused_reduce.fused_cells_reduce(*args)
        if fused_reduce.fused_cells_reduce.launches - before != launches:
            raise AssertionError(f"K6 {shape}: expected {launches} launch(es)")
        again_counts, again = fused_reduce.fused_cells_reduce(*args)
        ref_counts, ref = fused_reduce.fused_cells_reduce_plain(*args)
        torch.cuda.synchronize()
        same_reduction(counts, ref_counts, f"K6 {shape} n={n} row counts")
        if n > 1000 and int(counts.sum()) == 0:
            raise AssertionError(f"K6 {shape} n={n}: no row passed, the check is empty")
        for i, ((r, c), (r2, c2), (rr, rc)) in enumerate(zip(results, again, ref)):
            worst = max(worst, same_reduction(r, rr, f"K6 {shape} n={n} slot {i}"))
            same_reduction(c, rc, f"K6 {shape} n={n} slot {i} valid counts")
            if not (torch.equal(r, r2) and torch.equal(c, c2)):
                raise AssertionError(f"K6 {shape} n={n} slot {i}: two launches differ")
    return worst


K7_SHAPES = ("4 rows a group", "1000 groups", "one group", "skewed", "tile boundaries",
             "empty runs", "offset start")
K7_TIMED = ("4 rows a group", "1000 groups", "skewed")


def k7_columns(n: int, device):
    """n rows for K7: values of the four types, a permutation, a validity
    column and arbitrary doubles."""
    rng = np.random.default_rng(n * 13 + 7)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (exact_values(rng, n, device), up(rng.permutation(n).astype(np.int64)),
            up(rng.random(n) < 0.7), up(rng.random(n) * 1e5 - 2e4))


def k7_starts(n: int, shape: str, tile: int, device):
    """Offsets of sorted segments over n positions (some groups empty).
    '4 rows a group' and '1000 groups' cut at uniform random places; 'one
    group' holds every row; 'skewed' is n // 4 groups of which one holds a
    third of the rows; 'tile boundaries' puts every boundary on a multiple
    of the kernel's tile; 'empty runs' adds runs of 70 empty groups at the
    first position, on the tile boundary nearest the middle and at the last
    position; 'offset start' begins at n // 3 and ends at n - n // 5."""
    rng = np.random.default_rng(n * 13 + K7_SHAPES.index(shape))

    def cut(lo, hi, n_groups):
        cuts = np.sort(rng.integers(lo, hi + 1, max(n_groups - 1, 0)))
        return np.concatenate([[lo], cuts, [hi]])

    if shape == "4 rows a group":
        starts = cut(0, n, n // 4 + 1)
    elif shape == "1000 groups":
        starts = cut(0, n, min(n, 1000))
    elif shape == "one group":
        starts = np.array([0, n])
    elif shape == "skewed":
        big = n // 3
        rest = cut(0, n - big, max(n // 4 - 1, 1))
        at = len(rest) // 2
        starts = np.concatenate([rest[:at + 1], rest[at:] + big])
    elif shape == "tile boundaries":
        starts = np.arange(0, n + 1, tile) if n >= tile else np.array([0, n])
    elif shape == "empty runs":
        starts = cut(0, n, n // 4 + 1)
        middle = (n // 2) // tile * tile
        starts = np.sort(np.concatenate([starts, np.repeat([0, middle, n], 70)]))
    else:
        starts = cut(n // 3, n - n // 5, n // 8 + 1)
    return torch.as_tensor(starts.astype(np.int64), device=device)


def check_k7(n: int, device, segment_reduce) -> float:
    """K7 against its plain version in the K7_SHAPES: sum, min and max of the
    four types and the count, with and without the permutation and the
    validity column; the same bits from two launches."""
    worst = 0.0
    tile = segment_reduce.tile_positions()
    values, rows, validity, noisy = k7_columns(n, device)
    cases = [("count", None)]
    for name in values:
        cases += [("sum", name), ("min", name), ("max", name)]
    for shape in K7_SHAPES:
        starts = k7_starts(n, shape, tile, device)
        for kind, name in cases:
            v = None if name is None else values[name]
            for r, m in ((rows, validity), (None, None), (rows, None), (None, validity)):
                got = segment_reduce.segment_reduce_sorted(v, starts, kind, r, m)
                again = segment_reduce.segment_reduce_sorted(v, starts, kind, r, m)
                ref = segment_reduce.segment_reduce_sorted_plain(v, starts, kind, r, m)
                torch.cuda.synchronize()
                what = f"K7 {kind} {name} n={n} {shape}"
                worst = max(worst, same_reduction(got[0], ref[0], what))
                same_reduction(got[1], ref[1], what + " valid counts")
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{what}: two launches differ")
        a = segment_reduce.segment_reduce_sorted(noisy, starts, "sum", rows, validity)[0]
        b = segment_reduce.segment_reduce_sorted(noisy, starts, "sum", rows, validity)[0]
        ref = segment_reduce.segment_reduce_sorted_plain(noisy, starts, "sum", rows,
                                                         validity)[0]
        if not torch.equal(a, b):
            raise AssertionError(f"K7 n={n} {shape}: two launches differ")
        if bool(((a - ref).abs() > 1e-9 * ref.abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K7 noisy sum n={n} {shape} differs from plain")
    return worst


def k8_inputs(n: int, kind: str, device):
    """Build keys (a quarter of n; each value about twice, as a join on a
    foreign key finds them, and one value 64 times; a fifth invalid) and n
    probe keys, half of them build keys: int64 keys spread over 2^40 values,
    more than the direct-address table takes, INT64_MIN among them; or
    float64 keys with -0.0, 0.0 and NaN among them."""
    rng = np.random.default_rng(n + 8 + len(kind))
    nb = n // 4 + 1
    pool = rng.integers(-2**39, 2**39, nb // 2 + 1)
    build_keys = rng.choice(pool, nb)
    build_keys[rng.integers(0, nb, min(64, nb))] = pool[0]
    probe_keys = np.where(rng.random(n) < 0.5, rng.choice(build_keys, n),
                          rng.integers(-2**39, 2**39, n))
    if kind == "float64":
        build_keys, probe_keys = build_keys / 8.0, probe_keys / 8.0
        special = np.array([-0.0, 0.0, np.nan, np.inf])
    else:
        special = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1])
    if n >= 1000:
        build_keys[1:5], build_keys[-4:] = special, special
        probe_keys[:4], probe_keys[-4:] = special, special[::-1]
    valid = rng.random(nb) > 0.2
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return up(build_keys), up(valid), up(probe_keys)


def k8_hot_key_inputs(n: int, device):
    """k8_inputs' int64 keys with a third of the build rows on ONE key: the
    skew that would serialise a build that always used its atomics."""
    build_keys, valid, probe_keys = k8_inputs(n, "int64", device)
    hot = torch.rand(build_keys.shape[0], device=device) < 1 / 3
    return torch.where(hot, build_keys[0], build_keys), valid, probe_keys


def check_k8(n: int, device, hash_lookup) -> float:
    """K8 against its plain version on int64 and float64 keys, and with an
    empty build side; the check is equality."""
    worst = 0.0
    for kind in ("int64", "float64", "hot key"):
        args = k8_hot_key_inputs(n, device) if kind == "hot key" \
            else k8_inputs(n, kind, device)
        for build_keys, valid, probe_keys in (args, (args[0][:0], args[1][:0], args[2])):
            matched, rows = hash_lookup.lookup_last_eq(build_keys, valid, probe_keys)
            ref_matched, ref_rows = hash_lookup.lookup_last_eq_plain(build_keys, valid,
                                                                     probe_keys)
            torch.cuda.synchronize()
            if not (torch.equal(matched, ref_matched) and torch.equal(rows, ref_rows)):
                raise AssertionError(f"K8 lookup_last_eq {kind} at n={n}, "
                                     f"{build_keys.shape[0]} build rows, differs from "
                                     "its plain version")
            worst = max(worst, max_abs_diff(((matched, ref_matched), (rows, ref_rows))))
    return worst


K9_SHARES = (0.0, 0.02, 0.5, 0.98, 1.0)


def k9_mask(n: int, share: float, device):
    rng = np.random.default_rng(n + int(share * 100))
    return torch.as_tensor(rng.random(n) < share, device=device)


K9_REPEATS = 200               # launches per size in the repeated check
K9_REPEATED_SIZES = (65_543, 6_006_330)


def check_k9(n: int, device, compact) -> float:
    """K9 against its plain version at five selectivities and from a view
    that starts one byte into its buffer; at the K9_REPEATED_SIZES also
    K9_REPEATS launches in a row, each held against the plain version (a
    look-back that misses a tile once in a hundred launches fails here). The
    check is equality."""
    worst = 0.0
    masks = []
    for share in K9_SHARES:
        mask = k9_mask(n + 1, share, device)
        for m in (mask[:n], mask[1:]):
            got, ref = compact.compact_indices(m), compact.compact_indices_plain(m)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"K9 compact_indices at n={n}, share {share}, "
                                     "differs from its plain version")
            worst = max(worst, max_abs_diff(((got, ref),)))
            masks.append((m, ref))
    if n in K9_REPEATED_SIZES:
        for i in range(K9_REPEATS):
            m, ref = masks[i % len(masks)]
            if not torch.equal(compact.compact_indices(m), ref):
                raise AssertionError(f"K9 compact_indices at n={n}: launch {i} of "
                                     f"{K9_REPEATS} differs from its plain version")
    return worst


PROFILED_CALLS = 20


def kernel_only_ms(fn, device):
    """Device ms per call of everything fn(i) runs on the card (kernels,
    memsets, copies), from one torch.profiler run over PROFILED_CALLS calls,
    each after an L2 flush (whose fill kernel is left out):
    {short name: ms, ..., "sum": ms}, and the number of device kernels,
    memsets and copies per call. A profiler run that comes back without
    any device event, or with only a part of them (it happens once in some
    tens of runs), is made again, three times at most."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(2 * max(l2, 1 << 20), dtype=torch.uint8, device=device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        fn(0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for i in range(PROFILED_CALLS):
                flush.zero_()
                fn(i)
            torch.cuda.synchronize()
        ms, launched = {}, 0
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA or "FillFunctor" in avg.key:
                continue
            # torch renamed self_cuda_time_total to self_device_time_total
            total_us = getattr(avg, "self_device_time_total", None)
            if total_us is None:
                total_us = avg.self_cuda_time_total
            named = re.search(r"(\w+)(<.*>)?\(", avg.key)
            name = named.group(1) if named else avg.key[:40]
            ms[name] = ms.get(name, 0.0) + total_us / 1e3 / PROFILED_CALLS
            launched += avg.count
        # a run that lost part of its device events shows a broken number of
        # launches per call
        if ms and launched % PROFILED_CALLS == 0:
            ms["sum"] = sum(ms.values())
            return ms, launched // PROFILED_CALLS
    raise AssertionError("torch.profiler lost device events in three runs")


def time_k6_to_k9(n: int, device, card: str, time_ms, mods):
    """Median device ms of K6-K9, their plain versions and the PyTorch calls
    that compute the same function, at the shapes of the main path; each
    shape is first held against its plain version. Returns, per label,
    {kernel, plain, library, bytes, bound} (ms; bound: each input read and
    each output written once at the card's memory rate) and the largest
    absolute difference seen."""
    fused_reduce, segment_reduce, hash_lookup, compact, group_reduce = mods
    out, worst = {}, 0.0

    def record(label, kernel, plain, library, nbytes, note):
        order = [("plain", plain), ("kernel", kernel)]
        order += [("library", library)] if library is not None else []
        order += [("kernel", kernel), ("plain", plain)]
        t = turns(order, device, time_ms)
        t.setdefault("library", None)
        t["bytes"], t["bound"] = nbytes, nbytes / PEAK_BYTES_PER_S * 1e3
        out[label] = t
        lib = "" if t["library"] is None else f", {note} {t['library']:.4f}"
        log(f"kernels n={n} {label} median device ms {card}: kernel {t['kernel']:.4f}, "
            f"plain {t['plain']:.4f}{lib}, bound {t['bound']:.4f} "
            f"({nbytes / t['kernel'] / 1e6:.1f} GB/s)")

    # K6 in Q1's shape (what replaces it: the cell column by `where` and the 8
    # K3 launches of Aggregate._dense) and in Q6's
    for shape in ("q1", "q6"):
        mask, keys, sizes, slots = k6_inputs(n, shape, device)
        n_cells = int(np.prod(sizes)) if sizes else 1
        got, ref = (f(mask, keys, sizes, slots) for f in
                    (fused_reduce.fused_cells_reduce, fused_reduce.fused_cells_reduce_plain))
        for i, ((r, c), (rr, rc)) in enumerate(zip(got[1], ref[1])):
            worst = max(worst, same_reduction(r, rr, f"K6 {shape} timed slot {i}"))
            same_reduction(c, rc, f"K6 {shape} timed slot {i} valid counts")

        def k3_launches(i, mask=mask, keys=keys, sizes=sizes, slots=slots, k=n_cells):
            cell = torch.zeros(n, dtype=torch.int32, device=device)
            for key, size in zip(keys, sizes):
                cell = cell * size + key
            cell = torch.where(mask, cell, k)
            res = [group_reduce.segment_reduce_cells(None, cell, k, "count")]
            for values, _, kind in slots:
                if kind == "sum":
                    res.append(group_reduce.segment_reduce_cells(values, cell, k, "sum"))
            return res

        lib_out = k3_launches(0)
        same_reduction(lib_out[0], got[0], f"K6 {shape}: the K3 launches' row count")
        same_reduction(lib_out[1], got[1][0][0], f"K6 {shape}: the K3 launches' first sum")
        distinct = {id(v): v for v, _, _ in slots if v is not None}
        nbytes = n * (1 + 4 * len(keys)) + sum(v.element_size() * n for v in
                                               distinct.values()) \
            + 8 * n_cells * (1 + len(slots))
        record(f"K6 {shape}",
               lambda i, a=(mask, keys, sizes, slots): fused_reduce.fused_cells_reduce(*a),
               lambda i, a=(mask, keys, sizes, slots):
                   fused_reduce.fused_cells_reduce_plain(*a),
               k3_launches, nbytes, f"where + {len(lib_out)} K3 launches")

    # K7: a float64 sum through the permutation, at about 4 rows a group (Q18,
    # Q21), at 1,000 groups and with a third of the rows in one group. The
    # library calls are index_add_ and torch.segment_reduce: once given the
    # values already gathered into group order, once with the index_select
    # that gathers them, which is K7's whole function
    values, rows, _, _ = k7_columns(n, device)
    v = values["float64"]
    for label in K7_TIMED:
        starts = k7_starts(n, label, segment_reduce.tile_positions(), device)
        n_groups = starts.shape[0] - 1
        got = segment_reduce.segment_reduce_sorted(v, starts, "sum", rows)
        ref = segment_reduce.segment_reduce_sorted_plain(v, starts, "sum", rows)
        worst = max(worst, same_reduction(got[0], ref[0], f"K7 timed {label}"))
        gathered = v.index_select(0, rows)
        lengths = starts[1:] - starts[:-1]
        gid = torch.repeat_interleave(torch.arange(n_groups, device=device), lengths)

        def index_add(i, d=gathered, g=gid, k=n_groups):
            return torch.zeros(k, dtype=torch.float64, device=device).index_add_(0, g, d)

        def seg_reduce(i, d=gathered, ln=lengths):
            return torch.segment_reduce(d, "sum", lengths=ln)

        library = {
            "index_add_ (gather not included)": index_add,
            "torch.segment_reduce (gather not included)": seg_reduce,
            "index_select + index_add_": lambda i: index_add(i, v.index_select(0, rows)),
            "index_select + torch.segment_reduce":
                lambda i: seg_reduce(i, v.index_select(0, rows)),
        }
        for name, fn in library.items():
            same_reduction(fn(0), ref[0], f"K7 {label}: {name}")
        nbytes = n * (8 + 8) + (n_groups + 1) * 8 + n_groups * 16
        args = (v, starts, "sum", rows)
        kernel = lambda i, a=args: segment_reduce.segment_reduce_sorted(*a)  # noqa: E731
        record(f"K7 {label}", kernel,
               lambda i, a=args: segment_reduce.segment_reduce_sorted_plain(*a),
               index_add, nbytes, "index_add_ (gather not included)")
        t = out[f"K7 {label}"]
        t["libraries"] = {name: time_ms(fn, device) for name, fn in library.items()}
        t["kernel_only"], _ = kernel_only_ms(kernel, device)
        log(f"kernels n={n} K7 {label} ({n_groups} groups) {card}: library ms "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in t["libraries"].items())
            + "; kernel-only device ms (torch.profiler) "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in t["kernel_only"].items()))

    # K8: int64 keys spread over 2^40 values, n // 4 + 1 build rows, n probes
    args = k8_inputs(n, "int64", device)
    got, ref = hash_lookup.lookup_last_eq(*args), hash_lookup.lookup_last_eq_plain(*args)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("K8 timed shape differs from its plain version")
    nb = args[0].shape[0]
    record(f"K8 {nb} build rows",
           lambda i: hash_lookup.lookup_last_eq(*args),
           lambda i: hash_lookup.lookup_last_eq_plain(*args), None,
           nb * (8 + 1) + n * 8 + n * (1 + 8), "")
    out["K8"] = out[f"K8 {nb} build rows"]
    hot = k8_hot_key_inputs(n, device)
    got, ref = hash_lookup.lookup_last_eq(*hot), hash_lookup.lookup_last_eq_plain(*hot)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("K8 hot-key shape differs from its plain version")
    record(f"K8 {nb} build rows, a third on one key",
           lambda i: hash_lookup.lookup_last_eq(*hot),
           lambda i: hash_lookup.lookup_last_eq_plain(*hot), None,
           nb * (8 + 1) + n * 8 + n * (1 + 8), "")

    # K9 at Q6's, an even and Q1's selectivity over n rows, and over the 1,000
    # rows of a small mask (such as `rows_per_cell > 0`); the library call is
    # nonzero. Beside each, the two ways to hand out the result: a view of the
    # worst-case buffer, or a copy of the positions
    for rows_in, share in ((n, 0.02), (n, 0.5), (n, 0.98), (1000, 0.5)):
        mask = k9_mask(rows_in, share, device)
        got, ref = compact.compact_indices(mask), compact.compact_indices_plain(mask)
        if not torch.equal(got, ref):
            raise AssertionError(f"K9 timed share {share} differs from its plain version")
        label = f"K9 share {share}" + ("" if rows_in == n else f" of {rows_in} rows")
        kernel = lambda i, m=mask: compact.compact_indices(m)  # noqa: E731
        record(label, kernel,
               lambda i, m=mask: compact.compact_indices_plain(m),
               lambda i, m=mask: torch.nonzero(m), rows_in + 8 * got.shape[0],
               "torch.nonzero")

        def view(i, m=mask):
            buffer, count = compact.select_into_buffer(m)
            return buffer[:count]

        t = out[label]
        t["view"] = time_ms(view, device)
        t["copy"] = time_ms(lambda i: view(i).clone(), device)
        t["kernel_only"], _ = kernel_only_ms(kernel, device)
        log(f"kernels n={rows_in} {label} ({got.shape[0]} True) {card}: K9 view or copy: "
            f"median device ms as a view of the {rows_in}-entry buffer {t['view']:.4f}, "
            f"as a copy {t['copy']:.4f}; kernel-only device ms (torch.profiler) "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in t["kernel_only"].items()))
    return out, worst


SMALL_RANGES = 100_000         # a K5 call of the main path's smaller joins


def k5_ordered_inputs(n: int, device):
    """k5_inputs' counts over ranges that follow one another through a build
    side in its own order, as a join of two tables sorted by the key finds
    them: the gathers of build_perm run through it once."""
    _, counts, _ = k5_inputs(n, device)
    ends = torch.cumsum(counts, 0)
    return ((ends - counts).to(torch.int32), counts,
            torch.arange(int(ends[-1]), device=device))


def time_k4_k5_more(n: int, device, card: str, time_ms, join_probe, k4_args, k5_args):
    """Beside the timed shapes of K4 and K5, each first held against its plain
    version: K5 with a third of the pairs in one range, with ranges and build
    side in order, and at SMALL_RANGES ranges; K4 with its probe keys in
    order; and the kernels' own device time per call from torch.profiler,
    which must show at most two kernels and a memset a call."""
    def profiled(label, fn):
        ms, per_call = kernel_only_ms(fn, device)
        if per_call > 3:
            raise AssertionError(f"{label}: {per_call} device kernels and memsets a call")
        return (f"kernel-only device ms (torch.profiler, {per_call} kernels and "
                f"memsets a call) " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))

    log(f"kernels n={n} K5 expand_pairs {card}: "
        + profiled("K5", lambda i: join_probe.expand_pairs(*k5_args)))
    for label, args in (("a third of the pairs in one range", k5_skewed_inputs(n, device)),
                        ("ranges and build side in order", k5_ordered_inputs(n, device)),
                        (f"{SMALL_RANGES} ranges", k5_inputs(SMALL_RANGES, device))):
        total, _ = same_pairs(args, join_probe, f"timed, {label}")
        kernel = lambda i, a=args: join_probe.expand_pairs(*a)  # noqa: E731
        plain = lambda i, a=args: join_probe.expand_pairs_plain(*a)  # noqa: E731
        t = turns((("plain", plain), ("kernel", kernel), ("kernel", kernel),
                   ("plain", plain)), device, time_ms)
        bound = (args[0].shape[0] * 8 + args[2].shape[0] * 8 + total * 16) \
            / PEAK_BYTES_PER_S * 1e3
        log(f"kernels n={args[0].shape[0]} K5 expand_pairs, {label} ({total} pairs) "
            f"median device ms {card}: kernel {t['kernel']:.4f}, plain {t['plain']:.4f}, "
            f"bound {bound:.4f}; " + profiled("K5 " + label, kernel))

    log(f"kernels n={n} K4 lookup_last_eq_lut {card}: "
        + profiled("K4", lambda i: join_probe.lookup_last_eq_lut(*k4_args)))
    build_keys, valid, probe_keys, key_lo, key_hi = k4_args
    ordered = (build_keys, valid, torch.sort(probe_keys).values, key_lo, key_hi)
    same_lookup(ordered, join_probe, "timed, probe keys in order")
    kernel = lambda i: join_probe.lookup_last_eq_lut(*ordered)  # noqa: E731
    plain = lambda i: join_probe.lookup_last_eq_lut_plain(*ordered)  # noqa: E731
    t = turns((("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)),
              device, time_ms)
    log(f"kernels n={n} K4 lookup_last_eq_lut, probe keys in order, median device ms "
        f"{card}: kernel {t['kernel']:.4f}, plain {t['plain']:.4f}; "
        + profiled("K4 in order", kernel))


def reset_counts(wrappers) -> None:
    """Every wrapper's launch count, and row and pair counts where it keeps
    them, to 0."""
    for w in wrappers.values():
        w.launches = 0
        for count in ("rows_seen", "pairs_out"):
            if hasattr(w, count):
                setattr(w, count, 0)


def rows_per_launch(wrappers) -> str:
    """Mean rows per launch of the wrappers that count their rows (K4: probe
    rows; K5: ranges, and the pairs made of them; K7: the positions a call
    covered; K9: its mask's rows)."""
    return ", ".join(
        f"{name} {w.rows_seen / max(w.launches, 1):.1f}"
        + (f" (and {w.pairs_out / max(w.launches, 1):.1f} pairs)"
           if hasattr(w, "pairs_out") else "") + f" over {w.launches}"
        for name, w in wrappers.items() if hasattr(w, "rows_seen"))


def corpus_tables(device):
    """The four small tables tests/sql_corpus.sql is written against (those
    of tests/test_sql_corpus.py)."""
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition as Def
    from hyrise_tpu_torch.types import DataType as T
    rng = np.random.default_rng(5)
    n = 10
    obj = lambda values: np.array(values, dtype=object)  # noqa: E731
    s = ["red", "green", None, "blue", "red", "green", "red", None, "amber", "blue"]
    return {
        "mixed": Table.from_arrays(
            "mixed", [Def("a", T.INT32), Def("b", T.FLOAT32), Def("s", T.STRING, True)],
            [np.arange(1, n + 1, dtype=np.int32), (rng.random(n) * 100).astype(np.float32),
             obj(s)], device=device),
        "lookup": Table.from_arrays(
            "lookup", [Def("k", T.INT32), Def("v", T.STRING)],
            [np.array([1, 2, 2, 5, 11], dtype=np.int32),
             obj(["one", "two", "deux", "five", "eleven"])], device=device),
        "empty_t": Table.from_arrays("empty_t", [Def("x", T.INT32)],
                                     [np.array([], dtype=np.int32)], device=device),
        "nullnum": Table.from_arrays(
            "nullnum", [Def("i", T.INT32, True), Def("f", T.FLOAT64, True),
                        Def("g", T.INT32)],
            [np.array([1, 0, 3, 0, 5, 3, 0, 8], dtype=np.int32),
             np.array([0.5, 1.5, 0, 0, 2.5, 0, 3.5, 4.5]),
             np.arange(1, 9, dtype=np.int32)],
            [np.array([1, 0, 1, 0, 1, 1, 0, 1], dtype=bool),
             np.array([1, 1, 0, 0, 1, 0, 1, 1], dtype=bool), None], device=device),
    }


def corpus_statements():
    import pathlib
    text = (pathlib.Path(__file__).resolve().parent / "tests" / "sql_corpus.sql").read_text()
    lines = [ln for ln in text.splitlines() if not ln.strip().startswith("--")]
    return [q.strip() for q in "\n".join(lines).split(";") if q.strip()]


def operators_of(plan):
    seen = {}

    def walk(op):
        if id(op) not in seen:
            seen[id(op)] = op
            for i in op.inputs:
                walk(i)

    walk(plan)
    return list(seen.values())


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


def run_sql_text(sql: str, cat, make_pipeline):
    """(rows, statement metrics, physical plan, wall ms to rows on the host)
    of one statement through the SQL pipeline, the plan cache on."""
    t0 = time.perf_counter()
    pipeline = make_pipeline(sql).with_catalog(cat).create_pipeline()
    rows = pipeline.get_result_table().rows()
    ms = (time.perf_counter() - t0) * 1e3
    statement = pipeline.pipeline_statements[-1]
    return rows, statement.metrics, getattr(statement, "last_plan", None), ms


def sql_phase(device, card, cat, hand_rows, hand_wall, wrappers, sql_kernels, table_eq,
              make_pipeline, fused_operator, oracle_class, tpch_sql):
    """Phase 6 after its TPC-H part at the small scale: the corpus against
    sqlite, then the 22 texts at SF1 against the hand plans' rows, with every
    launch count set to 0 before the two. Returns the launch counts read
    after them. (The corpus' EXCEPT and INTERSECT reach K8 through Difference;
    no join of the 22 optimized TPC-H plans takes the general lookup.)"""
    reset_counts(wrappers)
    # 6b. the corpus
    tables = corpus_tables(device)
    oracle = oracle_class(tables)
    corpus_cat = catalog_of(tables)
    statements = corpus_statements()
    loose = []
    t0 = time.perf_counter()
    for sql in statements:
        out = make_pipeline(sql).with_catalog(corpus_cat).dont_cache_query_plans() \
            .create_pipeline().get_result_table()
        if out.device != device:
            raise AssertionError(f"corpus statement came out on {out.device}: {sql}")
        rows, want = out.rows(), oracle.query(sql)
        ok, _ = table_eq.tables_equal(rows, want, ordered=False, rel_tol=1e-6, abs_tol=0.0)
        if not ok:
            # sqlite computes a float32 column's arithmetic in float64
            ok, msg = table_eq.tables_equal(rows, want, ordered=False, rel_tol=1e-4,
                                            abs_tol=1e-4)
            if not ok:
                raise AssertionError(f"corpus vs sqlite: {sql}: {msg}")
            loose.append(sql)
    oracle.close()
    log(f"sql: {len(statements)} statements of tests/sql_corpus.sql on {device} match "
        f"sqlite in {time.perf_counter() - t0:.1f} s: ints and strings equal, floats "
        f"within 1e-6 relative, but for {len(loose)} that need 1e-4 (float32 arithmetic "
        f"that sqlite does in float64): {loose}")

    corpus_launches = {name: w.launches for name, w in wrappers.items()}
    # 6c. the 22 texts at SF1
    wall, stages = {}, {}
    for qid in sorted(tpch_sql):
        rows, first_metrics, plan, first_ms = run_sql_text(tpch_sql[qid], cat, make_pipeline)
        if first_metrics.cache_hit:
            raise AssertionError(f"SQL Q{qid}: the first run hit the plan cache")
        check_rows(rows, hand_rows[qid], f"SQL Q{qid} at SF{SF} vs its hand plan", table_eq)
        check_finite(rows, f"SQL Q{qid} at SF{SF}")
        times, execute = [], []
        for _ in range(QUERY_REPS):
            rows, metrics, plan, ms = run_sql_text(tpch_sql[qid], cat, make_pipeline)
            if not metrics.cache_hit:
                raise AssertionError(f"SQL Q{qid}: a repeated run missed the plan cache")
            times.append(ms)
            execute.append(metrics.execute_s * 1e3)
        check_rows(rows, hand_rows[qid], f"SQL Q{qid} at SF{SF}, cached plan", table_eq)
        wall[qid] = (first_ms, statistics.median(times))
        stages[qid] = (first_metrics, statistics.median(execute))
        if qid in (1, 6):
            fused = [op for op in operators_of(plan) if isinstance(op, fused_operator)]
            if len(fused) != 1 or fused[0].fell_back is not False:
                raise AssertionError(f"SQL Q{qid}: no FusedFilterAggregate ran fused")
    log(f"sql: SF{SF} wall ms (host clock, to rows on the host; first run, then median "
        f"of {QUERY_REPS} with the plan cached; the hand plan's median beside it) {card}: "
        + "; ".join(f"Q{q} {wall[q][0]:.3f} / {wall[q][1]:.3f} (hand {hand_wall[q][1]:.3f})"
                    for q in sorted(wall)))
    log(f"sql: SF{SF} all 22 texts equal to their hand plans' rows (as sets, floats within "
        f"1e-6 relative); sum of medians {sum(m for _, m in wall.values()):.3f} ms, hand "
        f"plans {sum(m for _, m in hand_wall.values()):.3f} ms {card}")
    log(f"sql: SF{SF} stage ms of the first run (parse / translate / optimize / compile / "
        f"execute; Q1's optimize includes the table statistics), then the median execute "
        f"ms of the cached runs {card}: "
        + "; ".join(f"Q{q} {m.parse_s * 1e3:.3f} / {m.translate_s * 1e3:.3f} / "
                    f"{m.optimize_s * 1e3:.3f} / {m.compile_s * 1e3:.3f} / "
                    f"{m.execute_s * 1e3:.3f}, {e:.3f}"
                    for q, (m, e) in sorted(stages.items())))
    launches = {name: w.launches for name, w in wrappers.items()}
    for name in sql_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the SQL path")
    log(f"sql: launches on the SQL path: the corpus {corpus_launches}, with the 22 "
        f"texts at SF{SF} {launches}")
    log(f"sql: mean rows per launch on the SQL path: {rows_per_launch(wrappers)}")
    return launches


def main() -> None:
    # -- 1. device ---------------------------------------------------------
    started = time.perf_counter()
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
    from hyrise_tpu_torch.kernels import (build, compact, fused_reduce, group_reduce,
                                          hash_lookup, join_probe, q6, segment_reduce)
    from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query
    from hyrise_tpu_torch.utils import table_eq
    from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for module in (q6, group_reduce, join_probe, fused_reduce, segment_reduce,
                   hash_lookup, compact):
        module._library()
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
    k6_err = k7_err = k8_err = k9_err = 0.0
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
        shapes = ""
        if n in K5_REPEATED_SIZES:
            k4_err = max(k4_err, check_k4_shapes(n, device, join_probe))
            k5_err = max(k5_err, check_k5_shapes(n, device, join_probe))
            shapes = (f"; K4 also equal and bit-stable in {K4_SHAPES}; K5 also equal in "
                      f"{K5_REPEATS} launches in a row, with all ranges empty but 5, as one "
                      f"range over the build side, as triangular ranges, as one range of "
                      f"150,000 pairs, at totals of 0, 1, one output tile and one more, at "
                      f"range counts around the scan's tile, from views, and the "
                      f"{len(K5_BAD_RANGES)} bad ranges {tuple(K5_BAD_RANGES)} raise")
        log(f"kernels n={n}: K1 {got!r} vs plain {ref!r} "
            f"(rel {rel_diff(got, ref):.3e}); K2 {total} == exact {exact}; "
            f"K3 equal to plain in 13 reductions x {len(K3_CELLS)} cell counts, and bit-stable; "
            f"K4 equal and bit-stable; K5 equal over {pairs} pairs{shapes}")
        k6_err = max(k6_err, check_k6(n, device, fused_reduce))
        k7_err = max(k7_err, check_k7(n, device, segment_reduce))
        k8_err = max(k8_err, check_k8(n, device, hash_lookup))
        k9_err = max(k9_err, check_k9(n, device, compact))
        log(f"kernels n={n}: K6 equal to plain in 4 shapes (1, 1, 1 and 3 launches) and "
            f"bit-stable; K7 equal to plain in 13 reductions x {len(K7_SHAPES)} shapes "
            f"{K7_SHAPES} x with/without rows and validity, and bit-stable; K8 equal on "
            f"int64 and float64 keys, with a hot key and on an empty build side; K9 equal "
            f"at {len(K9_SHARES)} selectivities, aligned and not"
            + (f", and in {K9_REPEATS} launches in a row" if n in K9_REPEATED_SIZES else ""))
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
        f"ranges, {k5_total} pairs, scan and range check included) {jm['k5']:.4f} vs "
        f"plain {jm['k5_plain']:.4f}, bound {k5_bound:.4f}")
    time_k4_k5_more(n, device, card, bench_q6.time_ms, join_probe, k4_args, k5_args)

    new, new_err = time_k6_to_k9(n, device, card, bench_q6.time_ms,
                                 (fused_reduce, segment_reduce, hash_lookup, compact,
                                  group_reduce))
    k6_err = max(k6_err, new_err)

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
            want = oracle.query(TPCH_SQL[qid])
            check_rows(rows, want, f"Q{qid} at SF{sf} vs sqlite", table_eq)
            small_rows[qid] = len(rows)
            # phase 6, first part: the same text through the SQL pipeline
            out = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(small_cat) \
                .create_pipeline().get_result_table()
            if out.device != device:
                raise AssertionError(f"SQL Q{qid} at SF{sf} came out on {out.device}")
            check_rows(out.rows(), want, f"SQL Q{qid} at SF{sf} vs sqlite", table_eq)
        oracle.close()
    log(f"main: all {len(small_rows)} queries on {device} match sqlite at SF{SMALL_SF} "
        f"(Q20 at SF{SMALL_SF_OF[20]}): ints and strings equal, floats within 1e-6 "
        f"relative; rows {small_rows}; {time.perf_counter() - t0:.1f} s")
    log(f"sql: all {len(small_rows)} TPC-H texts through SQLPipelineBuilder on {device} "
        f"match sqlite at the same scale factors and tolerance")

    # 5b. every query at SF1, the launch counts starting from 0
    wrappers = {"q6_scan": q6.q6_scan, "q6_encoded": q6.q6_encoded,
                "segment_reduce_cells": group_reduce.segment_reduce_cells,
                "lookup_last_eq_lut": join_probe.lookup_last_eq_lut,
                "expand_pairs": join_probe.expand_pairs,
                "fused_cells_reduce": fused_reduce.fused_cells_reduce,
                "segment_reduce_sorted": segment_reduce.segment_reduce_sorted,
                "lookup_last_eq": hash_lookup.lookup_last_eq,
                "compact_indices": compact.compact_indices}
    sql_kernels = ("fused_cells_reduce", "segment_reduce_sorted", "lookup_last_eq",
                   "compact_indices")
    reset_counts(wrappers)
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
        if count <= 0 and name not in sql_kernels:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"main: launches on the main path {launches}")
    log(f"main: mean rows per launch on the main path: {rows_per_launch(wrappers)}")

    # -- 6. the SQL entry point ----------------------------------------------
    sql_launches = sql_phase(device, card, cat, results, wall, wrappers, sql_kernels,
                             table_eq, SQLPipelineBuilder, FusedFilterAggregate,
                             SqliteOracle, TPCH_SQL)
    launches.update({name: sql_launches[name] for name in sql_kernels})

    csrc = "hyrise_tpu_torch/kernels/csrc/"

    def entry(name, source, replaces, err, t, plain, bound, library=None):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": t, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library}

    def new_entry(name, source, replaces, err, t):
        return entry(name, source, replaces, err, t["kernel"], t["plain"], t["bound"],
                     t["library"])

    log(f"elapsed: {time.perf_counter() - started:.1f} s, the build included")
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
        new_entry("fused_cells_reduce", "fused_reduce.cu",
                  "hyrise_tpu/kernels/fused.py:101", k6_err, new["K6 q1"]),
        new_entry("segment_reduce_sorted", "segment_reduce.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:494", k7_err, new["K7 4 rows a group"]),
        new_entry("lookup_last_eq", "hash_lookup.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:383", k8_err, new["K8"]),
        new_entry("compact_indices", "compact.cu",
                  "hyrise_tpu/kernels/tpu_prims.py:144", k9_err, new["K9 share 0.5"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
