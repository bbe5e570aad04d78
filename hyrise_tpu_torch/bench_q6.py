"""TPC-H Q6 over lineitem through the hand-written kernels, timed on the card.

The measurement part of bench.py, ported: the same lineitem data (SF from
--sf, seed DEFAULT_SEED) and the same two column layouts —

- dense: int32 shipdate codes, float32 discount / quantity / price and a
  bool live mask, 17 bytes a row, through K1 (kernels.q6.q6_scan);
- encoded: int16 shipdate codes, int8 discount cents, int8 quantity, int32
  price cents, 8 bytes a row, through K2 (kernels.q6.q6_encoded), whose
  int64 total must equal the host's exact integer oracle.

Each timed call runs after a write of twice the card's L2 (so the columns
come from device memory, as a scan of a table finds them) and its device
time is taken with CUDA events; the result is the median over TIMING_REPS
calls.
Consecutive calls move the lower date bound down by one day, so no two
launches are the same.

Run:  python -m hyrise_tpu_torch.bench_q6 [--sf 1.0]
It prints one JSON line, and fails when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Callable, Dict

import numpy as np
import torch

from hyrise_tpu_torch.kernels.q6 import q6_encoded, q6_scan
from hyrise_tpu_torch.tpch import dbgen

DATE_LO = "1994-01-01"
DATE_HI = "1995-01-01"
DEFAULT_SEED = 19940607
TIMING_REPS = 50
# device clock cycles to spin before each timed call (about 1 ms at 2 GHz),
# through torch.cuda._sleep: a private torch function, checked on torch
# 2.11.0+cu128 on an H100; a later torch may rename or change it.
_HOST_HEADSTART_CYCLES = 2_000_000


def lineitem_arrays(sf: float) -> Dict[str, object]:
    """Host lineitem columns, generated as bench.py does: orders and
    lineitem only, from a fresh generator (so not the lineitem that
    dbgen.generate_tables draws after the other tables)."""
    rng = np.random.default_rng(DEFAULT_SEED)
    C = max(int(150000 * sf), 3)
    P = max(int(200000 * sf), 8)
    S = max(int(10000 * sf), 1)
    pk = np.arange(1, P + 1, dtype=np.int64)
    retail = ((90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0
              ).astype(np.float32)
    _, _, l_specs, _ = dbgen.gen_orders_lineitem(rng, sf, C, P, S, retail)
    return {name: payload for name, _, payload in l_specs}


@dataclasses.dataclass
class Q6Columns:
    """Q6's lineitem columns on one device in both layouts, with the exact
    total in cents x cents that the encoded form must reproduce."""

    n: int
    date_lo: int
    date_hi: int
    ship: torch.Tensor
    disc: torch.Tensor
    qty: torch.Tensor
    price: torch.Tensor
    live: torch.Tensor
    ship16: torch.Tensor
    disc_cents: torch.Tensor
    qty8: torch.Tensor
    price_cents: torch.Tensor
    exact_total: int


def prepare(cols: Dict[str, object], device) -> Q6Columns:
    """Both layouts of the host lineitem columns `cols` (name -> array, or
    (codes, dictionary) for strings) on `device`."""
    ship_codes, date_dict = cols["l_shipdate"]
    disc = np.asarray(cols["l_discount"], dtype=np.float32)
    qty = np.asarray(cols["l_quantity"], dtype=np.float32)
    price = np.asarray(cols["l_extendedprice"], dtype=np.float32)
    n = len(ship_codes)
    date_lo = int(np.searchsorted(date_dict, DATE_LO))
    date_hi = int(np.searchsorted(date_dict, DATE_HI))
    # encoded-at-rest forms (bench.py:156-170)
    if len(date_dict) > 2**15:
        raise ValueError("shipdate codes do not fit int16")
    ship16 = np.asarray(ship_codes).astype(np.int16)
    disc_cents = np.rint(disc * 100).astype(np.int8)
    qty8 = np.rint(qty).astype(np.int8)
    price_cents = np.rint(price.astype(np.float64) * 100).astype(np.int64)
    if np.abs(price_cents / 100.0 - price.astype(np.float64)).max(initial=0.0) > 0.005 + 1e-9:
        raise ValueError("extendedprice does not round-trip through cents")
    # exact host oracle in integer cents x cents (bench.py:172-175)
    m = ((ship16 >= date_lo) & (ship16 < date_hi) & (disc_cents >= 5)
         & (disc_cents <= 7) & (qty8 < 24))
    exact_total = int((price_cents[m] * disc_cents[m].astype(np.int64)).sum())

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return Q6Columns(
        n=n, date_lo=date_lo, date_hi=date_hi,
        ship=up(ship_codes, np.int32), disc=up(disc, np.float32),
        qty=up(qty, np.float32), price=up(price, np.float32),
        live=torch.ones(n, dtype=torch.bool, device=device),
        ship16=up(ship16, np.int16), disc_cents=up(disc_cents, np.int8),
        qty8=up(qty8, np.int8), price_cents=up(price_cents, np.int32),
        exact_total=exact_total)


def time_ms(fn: Callable[[int], object], device) -> float:
    """Median device ms of fn(i) for i in range(TIMING_REPS) on `device`,
    each call timed with CUDA events after writing twice the L2 so the call
    finds its data in device memory; three untimed warm-up calls come first.

    Before each call the device first spins for about a millisecond, so the
    host has enqueued the flush, both events and fn's launches before the
    device reaches them: the events then time the device work of fn alone,
    not the gaps while the host runs fn's Python."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(2 * max(l2, 1 << 20), dtype=torch.uint8, device=device)
    for i in range(3):
        fn(i)
    times = []
    for i in range(TIMING_REPS):
        torch.cuda._sleep(_HOST_HEADSTART_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(q: Q6Columns) -> Dict[str, object]:
    """Q6 through K1 and K2 on q's device: both results, validated, and the
    median ms of each."""
    device = q.ship.device
    if device.type != "cuda":
        raise RuntimeError(f"bench_q6 measures a CUDA device, got {device}")
    revenue_f32 = float(q6_scan(q.ship, q.disc, q.qty, q.price, q.live,
                                q.date_lo, q.date_hi))
    total = int(q6_encoded(q.ship16, q.disc_cents, q.qty8, q.price_cents,
                           q.date_lo, q.date_hi))
    if total != q.exact_total:
        raise AssertionError(f"encoded Q6 total {total} != exact {q.exact_total}")
    revenue_encoded = total * 1e-4
    rel = abs(revenue_encoded - revenue_f32) / max(abs(revenue_encoded), 1.0)
    if rel > 1e-5:
        raise AssertionError(f"f32 revenue {revenue_f32} vs exact {revenue_encoded}")

    f32_ms = time_ms(lambda i: q6_scan(q.ship, q.disc, q.qty, q.price, q.live,
                                       q.date_lo - i, q.date_hi), device)
    encoded_ms = time_ms(lambda i: q6_encoded(q.ship16, q.disc_cents, q.qty8,
                                              q.price_cents, q.date_lo - i,
                                              q.date_hi), device)
    return {"rows": q.n, "revenue_f32": revenue_f32,
            "revenue_encoded": revenue_encoded, "q6_f32_ms": f32_ms,
            "q6_encoded_ms": encoded_ms,
            "f32_gb_per_s": q.n * 17 / (f32_ms * 1e-3) / 1e9,
            "encoded_gb_per_s": q.n * 8 / (encoded_ms * 1e-3) / 1e9}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sf", type=float, default=1.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_q6: no CUDA device")
    q = prepare(lineitem_arrays(args.sf), "cuda")
    result = run(q)
    print(json.dumps({"sf": args.sf, "device": torch.cuda.get_device_name(0),
                      **result}))


if __name__ == "__main__":
    main()
