"""TPC-C table generator.

Port of hyrise_tpu/tpcc/generator.py (reference:
src/benchmarklib/tpcc/tpcc_table_generator.cpp and random_generator.hpp):
the 9 TPC-C tables at a warehouse count (the reference generates tables
only; its benchmark binary runs no transaction mix). Spec
cardinalities per warehouse: 10 districts, 3000 customers a district, 100k
items (global), 100k stock rows, 3000 orders a district with 5-15 order
lines each, 900 new orders a district. The numpy generation is the JAX
package's, draw for draw, so one seed gives equal tables in both packages;
the tables are built on the device the caller names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

_SYLLABLES = ["BAR", "OUGHT", "ABLE", "PRI", "PRES", "ESE", "ANTI", "CALLY",
              "ATION", "EING"]


def _last_name(nums: np.ndarray) -> np.ndarray:
    return np.array([_SYLLABLES[n // 100] + _SYLLABLES[(n // 10) % 10]
                     + _SYLLABLES[n % 10] for n in nums], dtype=object)


def _table(name, cols, n, device) -> Table:
    return Table([Column.from_numpy(cname, dt, arr, device=device)
                  for cname, dt, arr in cols], n, name=name)


def generate_tpcc_tables(warehouses: int = 1, seed: int = 42, *,
                         device) -> Dict[str, Table]:
    """The 9 tables for `warehouses` warehouses, drawn from `seed`, on
    `device`. The order table is named tpcc_order (ORDER is an SQL
    keyword)."""
    rng = np.random.default_rng(seed)
    W = warehouses
    I = 100_000
    D = 10 * W
    C_PER_D = 3000
    O_PER_D = 3000

    tables: Dict[str, Table] = {}

    # ITEM
    i_id = np.arange(1, I + 1, dtype=np.int32)
    tables["item"] = _table("item", [
        ("i_id", DataType.INT32, i_id),
        ("i_im_id", DataType.INT32,
         rng.integers(1, 10001, I).astype(np.int32)),
        ("i_name", DataType.STRING,
         np.array([f"item-{k}" for k in rng.integers(0, 65536, I)],
                  dtype=object)),
        ("i_price", DataType.FLOAT32,
         (rng.integers(100, 10001, I) / 100).astype(np.float32)),
        ("i_data", DataType.STRING,
         np.array([f"data-{k}" for k in rng.integers(0, 4096, I)],
                  dtype=object)),
    ], I, device)

    # WAREHOUSE
    w_id = np.arange(1, W + 1, dtype=np.int32)
    tables["warehouse"] = _table("warehouse", [
        ("w_id", DataType.INT32, w_id),
        ("w_name", DataType.STRING,
         np.array([f"wh-{i}" for i in w_id], dtype=object)),
        ("w_tax", DataType.FLOAT32,
         (rng.integers(0, 2001, W) / 10000).astype(np.float32)),
        ("w_ytd", DataType.FLOAT32, np.full(W, 300000.0, dtype=np.float32)),
    ], W, device)

    # DISTRICT
    d_w = np.repeat(w_id, 10)
    d_id = np.tile(np.arange(1, 11, dtype=np.int32), W)
    tables["district"] = _table("district", [
        ("d_id", DataType.INT32, d_id),
        ("d_w_id", DataType.INT32, d_w),
        ("d_name", DataType.STRING,
         np.array([f"dist-{w}-{d}" for w, d in zip(d_w, d_id)], dtype=object)),
        ("d_tax", DataType.FLOAT32,
         (rng.integers(0, 2001, D) / 10000).astype(np.float32)),
        ("d_ytd", DataType.FLOAT32, np.full(D, 30000.0, dtype=np.float32)),
        ("d_next_o_id", DataType.INT32,
         np.full(D, O_PER_D + 1, dtype=np.int32)),
    ], D, device)

    # CUSTOMER
    C = D * C_PER_D
    c_d = np.repeat(np.arange(D), C_PER_D)
    c_id = np.tile(np.arange(1, C_PER_D + 1, dtype=np.int32), D)
    lastname_nums = np.where(c_id <= 1000, c_id - 1,
                             rng.integers(0, 1000, C)).astype(np.int64)
    tables["customer"] = _table("customer", [
        ("c_id", DataType.INT32, c_id),
        ("c_d_id", DataType.INT32, d_id[c_d]),
        ("c_w_id", DataType.INT32, d_w[c_d]),
        ("c_last", DataType.STRING, _last_name(lastname_nums)),
        ("c_first", DataType.STRING,
         np.array([f"first-{k}" for k in rng.integers(0, 8192, C)],
                  dtype=object)),
        ("c_credit", DataType.STRING,
         np.where(rng.random(C) < 0.1, "BC", "GC").astype(object)),
        ("c_credit_lim", DataType.FLOAT32,
         np.full(C, 50000.0, dtype=np.float32)),
        ("c_discount", DataType.FLOAT32,
         (rng.integers(0, 5001, C) / 10000).astype(np.float32)),
        ("c_balance", DataType.FLOAT32, np.full(C, -10.0, dtype=np.float32)),
        ("c_ytd_payment", DataType.FLOAT32,
         np.full(C, 10.0, dtype=np.float32)),
        ("c_payment_cnt", DataType.INT32, np.ones(C, dtype=np.int32)),
    ], C, device)

    # HISTORY
    tables["history"] = _table("history", [
        ("h_c_id", DataType.INT32, c_id),
        ("h_c_d_id", DataType.INT32, d_id[c_d]),
        ("h_c_w_id", DataType.INT32, d_w[c_d]),
        ("h_amount", DataType.FLOAT32, np.full(C, 10.0, dtype=np.float32)),
        ("h_data", DataType.STRING,
         np.array([f"hist-{k}" for k in rng.integers(0, 4096, C)],
                  dtype=object)),
    ], C, device)

    # STOCK
    S = W * I
    s_w = np.repeat(w_id, I)
    s_i = np.tile(i_id, W)
    tables["stock"] = _table("stock", [
        ("s_i_id", DataType.INT32, s_i),
        ("s_w_id", DataType.INT32, s_w),
        ("s_quantity", DataType.INT32,
         rng.integers(10, 101, S).astype(np.int32)),
        ("s_ytd", DataType.INT32, np.zeros(S, dtype=np.int32)),
        ("s_order_cnt", DataType.INT32, np.zeros(S, dtype=np.int32)),
    ], S, device)

    # ORDER (named "orders" to avoid the SQL keyword, like many ports)
    O = D * O_PER_D
    o_d = np.repeat(np.arange(D), O_PER_D)
    o_id = np.tile(np.arange(1, O_PER_D + 1, dtype=np.int32), D)
    o_c_id = np.concatenate([rng.permutation(C_PER_D).astype(np.int32) + 1
                             for _ in range(D)])
    o_ol_cnt = rng.integers(5, 16, O).astype(np.int32)
    carrier = np.where(o_id < 2101, rng.integers(1, 11, O), 0).astype(np.int32)
    tables["tpcc_order"] = _table("tpcc_order", [
        ("o_id", DataType.INT32, o_id),
        ("o_d_id", DataType.INT32, d_id[o_d]),
        ("o_w_id", DataType.INT32, d_w[o_d]),
        ("o_c_id", DataType.INT32, o_c_id),
        ("o_carrier_id", DataType.INT32, carrier),
        ("o_ol_cnt", DataType.INT32, o_ol_cnt),
        ("o_all_local", DataType.INT32, np.ones(O, dtype=np.int32)),
    ], O, device)

    # ORDER_LINE
    OL = int(o_ol_cnt.sum())
    ol_order_row = np.repeat(np.arange(O), o_ol_cnt)
    offsets = np.concatenate([[0], np.cumsum(o_ol_cnt)[:-1]])
    ol_number = (np.arange(OL) - offsets[ol_order_row] + 1).astype(np.int32)
    delivered = o_id[ol_order_row] < 2101
    amount = np.where(delivered, 0.0,
                      rng.integers(1, 999999, OL) / 100).astype(np.float32)
    tables["order_line"] = _table("order_line", [
        ("ol_o_id", DataType.INT32, o_id[ol_order_row]),
        ("ol_d_id", DataType.INT32, d_id[o_d][ol_order_row]),
        ("ol_w_id", DataType.INT32, d_w[o_d][ol_order_row]),
        ("ol_number", DataType.INT32, ol_number),
        ("ol_i_id", DataType.INT32,
         rng.integers(1, I + 1, OL).astype(np.int32)),
        ("ol_supply_w_id", DataType.INT32, d_w[o_d][ol_order_row]),
        ("ol_quantity", DataType.INT32, np.full(OL, 5, dtype=np.int32)),
        ("ol_amount", DataType.FLOAT32, amount),
    ], OL, device)

    # NEW_ORDER (last 900 orders per district)
    no_mask = o_id > O_PER_D - 900
    tables["new_order"] = _table("new_order", [
        ("no_o_id", DataType.INT32, o_id[no_mask]),
        ("no_d_id", DataType.INT32, d_id[o_d][no_mask]),
        ("no_w_id", DataType.INT32, d_w[o_d][no_mask]),
    ], int(no_mask.sum()), device)

    return tables
