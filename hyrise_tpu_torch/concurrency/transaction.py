"""Transactions and MVCC bookkeeping.

Port of hyrise_tpu/concurrency/transaction.py (reference:
src/lib/concurrency/ — TransactionManager, transaction_manager.hpp:48-85;
TransactionContext, transaction_context.hpp:37-120):

- `TransactionManager` hands out transaction ids and snapshots and
  publishes commit ids in order, over a contiguous prefix only.
- `TransactionContext` is one transaction: its id, its snapshot commit id,
  the phase machine Active -> Committing -> Committed / Aborted ->
  RolledBack, and the read-write operators whose records it commits or
  rolls back.
- `MvccData` is a table's three MVCC vectors (reference:
  storage/mvcc_columns.hpp:15-46). Unlike the JAX package, which keeps them
  in host numpy and uploads them on every Validate, they are int64 tensors
  on the table's device: Validate reads them there, and Insert, Delete and
  commit write them there.

The manager is host Python under a lock, as in the JAX package. There is
no process-wide default manager: each Catalog owns one (the reference's
TransactionManager is a singleton beside its StorageManager, whose place
the Catalog takes here).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import List, Optional

import torch

MAX_COMMIT_ID = 2**62
INVALID_TID = 0


@dataclasses.dataclass
class MvccData:
    """A table's MVCC vectors, one entry per row of its capacity.

    tids:       the transaction that inserted or locked the row (0 = none)
    begin_cids: commit id from which the row is visible
    end_cids:   commit id from which the row is deleted
    write_lock: held by every writer of the vectors. A Delete checks that
                its rows' tids are free and sets them to its own under it, so
                that the check and the set are one step for every other
                session (the reference takes each row with a compare-and-swap,
                delete.cpp). An Insert appends under it, so that two sessions
                never write the same headroom, and `grow` runs inside that
                append. Commits and rollbacks write under it too: `grow`
                rebinds the three vectors, and a store into the old ones
                would be lost.
    """

    tids: torch.Tensor
    begin_cids: torch.Tensor
    end_cids: torch.Tensor
    write_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @staticmethod
    def for_new_table(num_rows: int, capacity: int, *, device) -> "MvccData":
        """Rows [0, num_rows) visible from commit id 0; the rest unused."""
        tids = torch.zeros(capacity, dtype=torch.int64, device=device)
        begin = torch.full((capacity,), MAX_COMMIT_ID, dtype=torch.int64, device=device)
        begin[:num_rows] = 0
        end = torch.full((capacity,), MAX_COMMIT_ID, dtype=torch.int64, device=device)
        return MvccData(tids, begin, end)

    @property
    def device(self) -> torch.device:
        return self.tids.device

    @property
    def capacity(self) -> int:
        return self.tids.shape[0]

    def grow(self, new_capacity: int) -> "MvccData":
        """Lengthen the vectors IN PLACE (this object keeps its identity) and
        return self. A pending Delete or Insert holds this object; if growth
        made a new one, its commit would write into orphaned tensors (a lost
        delete, an insert never visible). The caller holds `write_lock`, as
        every writer of the vectors does."""
        extra = new_capacity - self.capacity
        if extra <= 0:
            return self

        def grown(t: torch.Tensor, fill: int) -> torch.Tensor:
            return torch.cat([t, torch.full((extra,), fill, dtype=torch.int64,
                                            device=t.device)])

        self.tids = grown(self.tids, INVALID_TID)
        self.begin_cids = grown(self.begin_cids, MAX_COMMIT_ID)
        self.end_cids = grown(self.end_cids, MAX_COMMIT_ID)
        return self


class TransactionPhase(enum.Enum):
    ACTIVE = "active"
    COMMITTING = "committing"
    COMMITTED = "committed"
    ABORTED = "aborted"
    ROLLED_BACK = "rolled_back"


class TransactionConflict(Exception):
    pass


class TransactionContext:
    def __init__(self, manager: "TransactionManager", tid: int, snapshot_cid: int):
        self.manager = manager
        self.transaction_id = int(tid)
        self.snapshot_commit_id = int(snapshot_cid)
        self.phase = TransactionPhase.ACTIVE
        self.rw_operators: List[object] = []  # AbstractReadWriteOperator
        self.commit_id: Optional[int] = None

    def register_operator(self, op) -> None:
        self.rw_operators.append(op)

    def rollback(self) -> None:
        if self.phase not in (TransactionPhase.ACTIVE, TransactionPhase.ABORTED):
            raise RuntimeError(f"cannot roll back from phase {self.phase}")
        for op in self.rw_operators:
            op.rollback_records()
        self.phase = TransactionPhase.ROLLED_BACK

    def mark_aborted(self) -> None:
        self.phase = TransactionPhase.ABORTED

    def commit(self) -> None:
        if self.phase is not TransactionPhase.ACTIVE:
            raise RuntimeError(f"cannot commit from phase {self.phase}")
        self.phase = TransactionPhase.COMMITTING
        cid = self.manager._next_commit_id_locked()
        self.commit_id = cid
        for op in self.rw_operators:
            op.commit_records(cid)
        self.manager._publish_commit_id(cid)
        self.phase = TransactionPhase.COMMITTED


class TransactionManager:
    """In-order commit publication (the reference's CommitContext chain,
    commit_context.hpp, is a lock and a set of published ids here)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_tid = 1
        self._last_commit_id = 0
        self._next_cid = 1
        self._published: set = set()

    @property
    def last_commit_id(self) -> int:
        return self._last_commit_id

    def new_transaction_context(self) -> TransactionContext:
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            return TransactionContext(self, tid, self._last_commit_id)

    def _next_commit_id_locked(self) -> int:
        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            return cid

    def _publish_commit_id(self, cid: int) -> None:
        """Advance last_commit_id only over a CONTIGUOUS prefix of published
        ids: a higher id finishing first must not expose a lower one that is
        still writing its records to new snapshots."""
        with self._lock:
            self._published.add(int(cid))
            while (self._last_commit_id + 1) in self._published:
                self._published.remove(self._last_commit_id + 1)
                self._last_commit_id += 1
