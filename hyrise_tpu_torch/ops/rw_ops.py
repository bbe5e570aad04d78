"""MVCC Validate and the read-write operators Insert, Delete and Update.

Port of hyrise_tpu/ops/rw_ops.py (reference: operators/validate.cpp:16-29,
insert.cpp, delete.cpp, update.cpp):

- Validate: a row is visible iff
  snapshot_cid < end_cid && ((snapshot_cid >= begin_cid) != (row_tid == our_tid)),
  one elementwise mask over the table's MVCC tensors where they live. The
  output is the input under a live MASK (no gather); operators that need a
  prefix compact it themselves (materialize.ensure_prefix, kernel K9).
- Insert writes the new rows into the table's headroom on its device and
  marks them with the inserting transaction; commit sets their begin cid.
  An encoded column comes out dense (tasks.ChunkCompressionTask encodes
  it again).
  When the headroom runs out the table grows by half its capacity, so a
  stream of small inserts copies a large table only now and then.
- Delete locks its rows through their tids (one host read checks for a
  lock held by another transaction); commit sets their end cid.
- Update is a Delete and an Insert in one transaction.

Only a string column's dictionary merge is host work; the rewrite of the
stored codes into a merged dictionary is one gather on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.concurrency.transaction import (INVALID_TID, MAX_COMMIT_ID,
                                                      MvccData, TransactionConflict)
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.ops.misc import AddRowIds, with_row_ids  # noqa: F401
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

MIN_CAPACITY = 1024  # the first growth of a small table


def visible_rows(mvcc: MvccData, capacity: int, context) -> torch.Tensor:
    """Bool (capacity,): the rows `context` sees, over the MVCC tensors on
    their device (no host copy)."""
    tids = mvcc.tids[:capacity]
    begin = mvcc.begin_cids[:capacity]
    end = mvcc.end_cids[:capacity]
    snapshot = context.snapshot_commit_id
    return (end > snapshot) & ((begin <= snapshot) != (tids == context.transaction_id))


class Validate(AbstractOperator):
    name = "Validate"

    def _on_execute(self, context) -> Table:
        if context is None:
            raise ValueError("Validate needs a transaction context")
        table = self.input_table(0)
        if table.mvcc is None:
            return table  # a table without MVCC: every row is visible
        live = table.live_mask() & visible_rows(table.mvcc, table.capacity, context)
        out = Table(table.columns, int(live.sum()), name=table.name, live=live)
        out.mvcc = table.mvcc
        return out


class AbstractReadWriteOperator(AbstractOperator):
    """Reference: abstract_read_write_operator.hpp. Registers itself with the
    transaction, which calls commit_records or rollback_records."""

    def execute(self, context=None) -> Table:
        if context is None:
            raise ValueError(f"{self.name} needs a transaction context")
        if self._output is None:
            context.register_operator(self)
        return super().execute(context)

    def commit_records(self, commit_id: int) -> None:
        raise NotImplementedError

    def rollback_records(self) -> None:
        raise NotImplementedError


def grown_capacity(capacity: int, need: int) -> int:
    return max(need, capacity + capacity // 2, MIN_CAPACITY)


def _grown(t: torch.Tensor, capacity: int) -> torch.Tensor:
    out = torch.zeros(capacity, dtype=t.dtype, device=t.device)
    out[:t.shape[0]] = t
    return out


def _merged_range(a: Optional[Tuple[int, int]], b: Optional[Tuple[int, int]],
                  n_old: int) -> Optional[Tuple[int, int]]:
    """The val_range of an appended integer column: the union of the stored
    rows' range and the inserted values', when both are known."""
    if n_old == 0:
        return b
    if a is None or b is None:
        return None
    return min(a[0], b[0]), max(a[1], b[1])


def _string_codes(c: Column, vc: Column, n_old: int, n_new: int):
    """(stored codes, codes of the inserted values, dictionary) of a string
    column after an append. The merged dictionary holds the stored one and
    the inserted non-NULL values; the stored codes are rewritten on the
    device only when it differs. A NULL value takes code 0."""
    dictionary = c.dictionary if c.dictionary is not None else np.array([], dtype=str)
    vals = vc.decode(n_new)
    present = np.array([v is not None for v in vals], dtype=bool)
    strings = np.asarray(vals[present], dtype=str)
    merged = np.unique(np.concatenate([np.asarray(dictionary, dtype=str), strings]))
    data = c.data
    if n_old and len(dictionary) and (len(merged) != len(dictionary)
                                      or not np.array_equal(merged, dictionary)):
        remap = torch.as_tensor(np.searchsorted(merged, dictionary).astype(np.int32),
                                device=data.device)
        data = remap[data.to(torch.int64).clamp_(0, len(dictionary) - 1)]
    codes = np.zeros(n_new, dtype=np.int32)
    codes[present] = np.searchsorted(merged, strings)
    return data, torch.as_tensor(codes, device=data.device), merged


def append_rows(target: Table, values: Table, catalog: Catalog) -> Table:
    """The target with the rows of `values` appended, written into its
    headroom (the table grows when that runs out) and registered in the
    catalog under its name. Columns map by position, as in the reference's
    Insert (INSERT ... SELECT gives expression columns any names). The new
    table shares the target's MvccData, grown in place."""
    values = ensure_prefix(values)
    if len(values.columns) != len(target.columns):
        raise ValueError(f"INSERT gives {len(values.columns)} columns for the "
                         f"{len(target.columns)} of {target.name!r}")
    n_old, n_new = target.num_rows, values.num_rows
    need = n_old + n_new
    capacity = target.capacity
    if need > capacity:
        capacity = grown_capacity(capacity, need)
        if target.mvcc is not None:
            target.mvcc.grow(capacity)
    cols = []
    for c, vc in zip(target.columns, values.columns):
        if (c.dtype is DataType.STRING) != (vc.dtype is DataType.STRING):
            raise TypeError(f"cannot insert {vc.dtype.value} values into "
                            f"{c.dtype.value} column {c.name!r}")
        if c.dtype is DataType.STRING:
            data, new_data, dictionary = _string_codes(c, vc, n_old, n_new)
            val_range = None
        else:
            data = c.data
            new_data = vc.data[:n_new].to(c.dtype.torch_dtype)
            dictionary = None
            val_range = (_merged_range(c.val_range, vc.val_range, n_old)
                         if c.dtype.is_integral else None)
        validity = c.validity
        if validity is not None or vc.validity is not None:
            if validity is None:
                validity = torch.ones(c.capacity, dtype=torch.bool, device=c.device)
            new_valid = (vc.validity[:n_new] if vc.validity is not None else True)
        if data.shape[0] < capacity or c.encoded is not None:
            # an encoded column becomes dense in a tensor of its own: its
            # decode is cached on the older table's column and may even be
            # the payload itself (int32 codes)
            data = _grown(data, capacity)
        if validity is not None and validity.shape[0] < capacity:
            validity = _grown(validity, capacity)
        # rows [n_old, need) are headroom: no table over these tensors has
        # them among its rows yet, so writing in place is safe
        data[n_old:need] = new_data
        if validity is not None:
            validity[n_old:need] = new_valid
        # an appended column may repeat a value: `unique` is dropped
        cols.append(Column(c.name, c.dtype, data, validity, dictionary,
                           val_range=val_range))
    out = Table(cols, need, name=target.name)
    out.mvcc = target.mvcc
    # the appended columns are dense; ChunkCompressionTask (tasks.py)
    # re-encodes them to this spec. Block statistics and indexes would be
    # stale and are not carried.
    out.encoding_spec = target.encoding_spec
    catalog.replace_table(target.name, out)
    return out


class Insert(AbstractReadWriteOperator):
    name = "Insert"

    def __init__(self, table_name: str, values_op: AbstractOperator, catalog: Catalog):
        super().__init__(values_op)
        self.table_name = table_name
        self.catalog = catalog
        self._rows: Optional[slice] = None
        self._mvcc: Optional[MvccData] = None

    def _on_execute(self, context) -> Table:
        mvcc = self.catalog.get_table(self.table_name).mvcc
        if mvcc is None:
            raise ValueError(f"Insert needs an MVCC table; {self.table_name!r} has none")
        with mvcc.write_lock:
            # the newest version of the table: another session's append may
            # have replaced it while this one waited
            target = self.catalog.get_table(self.table_name)
            n_old = target.num_rows
            target = append_rows(target, self.input_table(0), self.catalog)
            rows = slice(n_old, target.num_rows)
            mvcc.tids[rows] = context.transaction_id
            mvcc.begin_cids[rows] = MAX_COMMIT_ID
            mvcc.end_cids[rows] = MAX_COMMIT_ID
        self._rows, self._mvcc = rows, mvcc
        return target

    def commit_records(self, commit_id: int) -> None:
        # under the lock: another session's append may grow the vectors,
        # and a store into the tensors it replaces would be lost
        with self._mvcc.write_lock:
            self._mvcc.begin_cids[self._rows] = commit_id
            self._mvcc.tids[self._rows] = INVALID_TID

    def rollback_records(self) -> None:
        if self._mvcc is None:
            return
        with self._mvcc.write_lock:
            self._mvcc.begin_cids[self._rows] = MAX_COMMIT_ID
            self._mvcc.end_cids[self._rows] = 0  # never visible again
            self._mvcc.tids[self._rows] = INVALID_TID


class Delete(AbstractReadWriteOperator):
    """Its input is a Validate (and scans) over the target table with the
    `row_id` column of with_row_ids: the rows' positions in the stored
    table, in a masked or a prefix layout."""

    name = "Delete"

    def __init__(self, table_name: str, rows_op: AbstractOperator, catalog: Catalog):
        super().__init__(rows_op)
        self.table_name = table_name
        self.catalog = catalog
        self._rows: Optional[torch.Tensor] = None
        self._mvcc: Optional[MvccData] = None

    def _on_execute(self, context) -> Table:
        mvcc = self.catalog.get_table(self.table_name).mvcc
        if mvcc is None:
            raise ValueError(f"Delete needs an MVCC table; {self.table_name!r} has none")
        rows_t = self.input_table(0)
        selected = ensure_prefix(rows_t)
        rows = selected.column("row_id").data[:selected.num_rows].to(torch.int64)
        rows = rows.to(mvcc.device)
        # lock the rows: tid 0 -> ours; the check and the set are one step
        # under the table's write lock (two sessions must not both see 0)
        tid = context.transaction_id
        with mvcc.write_lock:
            current = mvcc.tids[rows]
            if bool(((current != INVALID_TID) & (current != tid)).any()):
                context.mark_aborted()
                raise TransactionConflict(
                    f"rows of {self.table_name!r} are locked by another transaction")
            mvcc.tids[rows] = tid
        self._rows, self._mvcc = rows, mvcc
        self.catalog.mark_changed()
        return rows_t

    def commit_records(self, commit_id: int) -> None:
        # the tid stays: visibility turns on the end cid (delete.cpp:68);
        # under the lock, as Insert's commit
        with self._mvcc.write_lock:
            self._mvcc.end_cids[self._rows] = commit_id

    def rollback_records(self) -> None:
        if self._mvcc is None:
            return
        with self._mvcc.write_lock:
            self._mvcc.tids[self._rows] = INVALID_TID


class Update(AbstractReadWriteOperator):
    """Reference update.cpp: a Delete of the old rows and an Insert of their
    new values, which register themselves with the transaction."""

    name = "Update"

    def __init__(self, table_name: str, rows_op: AbstractOperator,
                 values_op: AbstractOperator, catalog: Catalog):
        super().__init__(rows_op, values_op)
        self.table_name = table_name
        self.catalog = catalog

    def _on_execute(self, context) -> Table:
        delete = Delete(self.table_name, self.inputs[0], self.catalog)
        insert = Insert(self.table_name, self.inputs[1], self.catalog)
        delete.execute(context)
        return insert.execute(context)

    def commit_records(self, commit_id: int) -> None:
        pass  # the Delete and the Insert commit their own records

    def rollback_records(self) -> None:
        pass
