"""Device-resident columns as torch tensors.

Port of hyrise_tpu/storage/column.py:

- Every column is ONE dense tensor on an explicit device. Strings become
  order-preserving int32 dictionary codes; the sorted dictionary stays a
  host numpy array, so <, <=, ORDER BY and range predicates run on codes
  (the reference's "compare ValueIDs, not values" scan trick).
- NULLs: optional bool validity tensor (True = valid).
- Late materialization: `data` and `validity` may be zero-argument thunks
  that run on first access (ops/materialize.py gathers lazily, so operators
  pay only for the columns they read).

There is no capacity padding: a base column holds exactly its rows. Tables
with a live mask (storage/table.py) may still carry dead rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.types import DataType


def encode_strings(values: np.ndarray, dictionary: Optional[np.ndarray] = None):
    """Encode an object/str numpy array into (codes:int32, dictionary).

    The dictionary is sorted (order-preserving codes). If `dictionary` is
    given, values must all be present in it. None entries map to code 0 with
    validity handled by the caller.
    """
    vals = np.asarray(values, dtype=object)
    none_mask = np.array([v is None for v in vals], dtype=bool)
    safe = np.where(none_mask, "", vals).astype(str)
    if dictionary is None:
        dictionary, codes = np.unique(safe, return_inverse=True)
    else:
        codes = np.searchsorted(dictionary, safe)
    codes = codes.astype(np.int32)
    codes[none_mask] = 0
    return codes, dictionary, none_mask


def merge_dictionaries(dict_a: np.ndarray, dict_b: np.ndarray):
    """Merge two sorted string dictionaries.

    Returns (merged, remap_a, remap_b) where remap_x maps old codes to merged
    codes (host-side; dictionaries are small).
    """
    merged = np.unique(np.concatenate([dict_a, dict_b]))
    remap_a = np.searchsorted(merged, dict_a).astype(np.int32)
    remap_b = np.searchsorted(merged, dict_b).astype(np.int32)
    return merged, remap_a, remap_b


class Column:
    """A named, typed column on one device.

    data:       tensor of shape (capacity,) — dict codes for STRING — or a
                zero-argument thunk producing it (cached on first access).
    validity:   optional bool tensor (capacity,), True = valid, or a thunk.
                None means "no NULLs among live rows".
    dictionary: host numpy array of strings for STRING columns (sorted).
    device:     where the tensors live; taken from `data` unless `data` is
                a thunk, in which case the caller names it.
    capacity:   row count of a thunk column, known without running it.
    unique:     the live values are pairwise distinct (primary keys, a
                single group-by key's output). Filters, renames and the
                probe side of a lookup join keep the flag; anything that
                can repeat a row drops it. It selects the lookup join
                (ops/join.py), so a wrong True gives wrong join results:
                only provably distinct sources set it.
    val_range:  host-known (min, max) over the live values of an integer
                column, set at ingest. It sizes the lookup join's
                direct-address table without a device read; it is
                conservative, so any row subset keeps it and any value
                transformation drops it.
    """

    __slots__ = ("name", "dtype", "_data", "_validity", "dictionary",
                 "device", "_capacity", "unique", "val_range")

    def __init__(self, name: str, dtype: DataType, data, validity=None,
                 dictionary: Optional[np.ndarray] = None,
                 device: Optional[torch.device] = None,
                 capacity: Optional[int] = None, unique: bool = False,
                 val_range: Optional[Tuple[int, int]] = None):
        self.name = name
        self.dtype = dtype
        self._data = data
        self._validity = validity
        self.dictionary = dictionary
        self.unique = unique
        self.val_range = val_range
        if callable(data):
            if device is None or capacity is None:
                raise ValueError("a lazy column needs its device and capacity")
            self.device = torch.device(device)
            self._capacity = capacity
        else:
            self.device = data.device
            self._capacity = data.shape[0]

    @property
    def data(self) -> torch.Tensor:
        if callable(self._data):
            self._data = self._data()
        return self._data

    @property
    def validity(self) -> Optional[torch.Tensor]:
        if callable(self._validity):
            self._validity = self._validity()
        return self._validity

    @property
    def has_validity(self) -> bool:
        """Whether a validity mask exists, WITHOUT materializing it."""
        return self._validity is not None

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_numpy(name: str, dtype: DataType, values: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   dictionary: Optional[np.ndarray] = None, *,
                   device) -> "Column":
        """Upload host values to `device`. STRING values without a
        dictionary are encoded here; None entries become NULLs. Integer
        columns get their `val_range` from the non-NULL values."""
        if dtype is DataType.STRING and dictionary is None:
            codes, dictionary, none_mask = encode_strings(values)
            if none_mask.any():
                v = np.ones(len(codes), dtype=bool) if validity is None \
                    else np.array(validity, dtype=bool)
                v[none_mask] = False
                validity = v
            values = codes
        arr = np.ascontiguousarray(values, dtype=dtype.numpy_dtype)
        # torch.tensor copies, so the column never aliases the caller's array
        data = torch.tensor(arr, device=device)
        vmask = None
        if validity is not None:
            vmask = torch.tensor(np.asarray(validity, dtype=bool), device=device)
        val_range = None
        if dtype.is_integral:
            present = arr if validity is None else arr[np.asarray(validity, dtype=bool)]
            if len(present):
                val_range = (int(present.min()), int(present.max()))
        return Column(name, dtype, data, vmask, dictionary, val_range=val_range)

    # -- accessors -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._capacity

    def decode(self, num_rows: int) -> np.ndarray:
        """Copy the first num_rows to the host, decoding dictionary codes
        and turning NULLs into None (object array)."""
        data = self.data[:num_rows].cpu().numpy()
        valid = (self.validity[:num_rows].cpu().numpy()
                 if self.validity is not None else np.ones(num_rows, dtype=bool))
        if self.dtype is DataType.STRING:
            out = np.empty(num_rows, dtype=object)
            decoded = self.dictionary[np.clip(data, 0, len(self.dictionary) - 1)] \
                if len(self.dictionary) else np.array([""] * num_rows, dtype=object)
            out[:] = decoded
            out[~valid] = None
            return out
        if not valid.all():
            out = np.empty(num_rows, dtype=object)
            out[:] = data
            out[~valid] = None
            return out
        return data

    def with_name(self, name: str) -> "Column":
        # shares the (possibly still-unmaterialized) payload; a rename never
        # transforms values, so the value metadata survives
        return Column(name, self.dtype, self._data, self._validity,
                      self.dictionary, self.device, self._capacity,
                      self.unique, self.val_range)

    def code_for(self, value: str) -> Optional[int]:
        """Exact dictionary code of a string value, or None if absent."""
        assert self.dtype is DataType.STRING
        idx = int(np.searchsorted(self.dictionary, value))
        if idx < len(self.dictionary) and self.dictionary[idx] == value:
            return idx
        return None

    def lower_bound(self, value: str) -> int:
        """searchsorted-left on the dictionary — the reference's ValueID
        lower_bound (dictionary_column.hpp lower_bound/upper_bound)."""
        assert self.dtype is DataType.STRING
        return int(np.searchsorted(self.dictionary, value, side="left"))

    def upper_bound(self, value: str) -> int:
        assert self.dtype is DataType.STRING
        return int(np.searchsorted(self.dictionary, value, side="right"))
