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
- At-rest encodings (storage/encoding.py): an encoded column keeps its
  payload in `encoded` and its `data` is a thunk that decodes it.
- A result's string column reaches a DataFrame by one `take` of its codes
  from the array pandas makes of its dictionary's values, made once per
  dictionary object and kept while the dictionary lives
  (`Column.decode_frame_column`).

There is no capacity padding: a base column holds exactly its rows. Tables
with a live mask (storage/table.py) may still carry dead rows.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans


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


# -- a dictionary's values as pandas holds them -------------------------------
#
# Table.to_pandas takes each string column from an array that pandas itself
# made of the column's dictionary (`pd.Series(values).array`: Arrow-backed
# `str` under pandas' string inference, object otherwise), so a request makes
# no Python string and the DataFrame infers nothing. An entry is kept per
# dictionary object, keyed by its id and dropped by a weak reference's
# callback when the dictionary dies. A dictionary made afresh for one request
# must not pay its whole length each time, so the array is built on the first
# decode that reads at least as many rows as the dictionary has entries, or
# on the second decode of the same object; before that the column is decoded
# directly, as Column.decode does. Two threads may build one entry at once:
# each array is whole before it is stored, and either serves.


class _FrameEntry:
    """One dictionary's arrays by pandas setting; none while the dictionary
    has been decoded only once."""

    __slots__ = ("ref", "arrays")

    def __init__(self, dictionary: np.ndarray, key: int):
        self.ref = weakref.ref(dictionary, lambda ref: _frame_forget(key, ref))
        self.arrays: Dict[tuple, object] = {}


_frame_entries: Dict[int, _FrameEntry] = {}
_frame_counts = {"hit": 0, "build": 0, "direct": 0}
_frame_counts_lock = threading.Lock()


def _frame_forget(key: int, ref) -> None:
    entry = _frame_entries.get(key)
    if entry is not None and entry.ref is ref:
        _frame_entries.pop(key, None)


def _count(word: str) -> str:
    with _frame_counts_lock:
        _frame_counts[word] += 1
    return word


def frame_decode_counts() -> Dict[str, int]:
    """How Table.to_pandas decoded its string columns since the process
    began: `hit` (taken from a kept array), `build` (the array made, then
    taken), `direct` (a fresh object array); and `entries`, the dictionaries
    tracked now."""
    with _frame_counts_lock:
        out = dict(_frame_counts)
    out["entries"] = len(_frame_entries)
    return out


def _direct_strings(dictionary: np.ndarray, codes: np.ndarray,
                    valid: Optional[np.ndarray]) -> np.ndarray:
    """Codes as a fresh object array of Python strings, NULLs None."""
    out = np.empty(len(codes), dtype=object)
    out[:] = dictionary[np.clip(codes, 0, len(dictionary) - 1)] \
        if len(dictionary) else np.array([""] * len(codes), dtype=object)
    if valid is not None:
        out[~valid] = None
    return out


def _frame_strings(dictionary: np.ndarray, codes: np.ndarray,
                  valid: Optional[np.ndarray]) -> Tuple[object, str]:
    """(the rows of `codes` as the DataFrame takes them, how: `hit`, `build`
    or `direct`). The DataFrame built from the result holds what it would
    hold from Column.decode's object array: `str` values with NaN for NULL
    under pandas' string inference, else objects with None."""
    import pandas as pd

    n, size = len(codes), len(dictionary)
    if (not n or not size or dictionary.dtype.kind != "U"
            or (valid is not None and not valid.any())):
        # nothing to take from, or no string for pandas to infer `str` from
        return _direct_strings(dictionary, codes, valid), _count("direct")
    key = id(dictionary)
    entry = _frame_entries.get(key)
    if entry is None or entry.ref() is not dictionary:
        entry = _frame_entries[key] = _FrameEntry(dictionary, key)
        seen = False
    else:
        seen = True
    setting = (pd.get_option("future.infer_string"), pd.get_option("mode.string_storage"))
    array = entry.arrays.get(setting)
    if array is not None:
        how = "hit"
    elif n >= size or seen:
        array = pd.Series(dictionary.astype(object), copy=False).array
        if isinstance(array, pd.arrays.NumpyExtensionArray):
            array = array.to_numpy()  # object values: numpy takes them, None fills
        entry.arrays[setting] = array
        how = "build"
    else:
        return _direct_strings(dictionary, codes, valid), _count("direct")
    index = np.clip(codes, 0, size - 1)
    if isinstance(array, np.ndarray):
        out = array.take(index)
        if valid is not None:
            out[~valid] = None
    elif valid is None or valid.all():
        out = array.take(index)
    else:
        out = array.take(np.where(valid, index, -1), allow_fill=True)
    return out, _count(how)


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
    encoded:    the at-rest payload of an encoded column, whose `data` is
                then a thunk that decodes it (storage/encoding.py), else
                None. Encodings are lossless, so `unique` and `val_range`
                hold for both forms.
    """

    __slots__ = ("name", "dtype", "_data", "_validity", "dictionary",
                 "device", "_capacity", "unique", "val_range", "encoded")

    def __init__(self, name: str, dtype: DataType, data, validity=None,
                 dictionary: Optional[np.ndarray] = None,
                 device: Optional[torch.device] = None,
                 capacity: Optional[int] = None, unique: bool = False,
                 val_range: Optional[Tuple[int, int]] = None, encoded=None):
        self.name = name
        self.dtype = dtype
        self._data = data
        self._validity = validity
        self.dictionary = dictionary
        self.unique = unique
        self.val_range = val_range
        self.encoded = encoded
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
    def is_lazy(self) -> bool:
        """Whether the data or the validity is a thunk not run yet."""
        return callable(self._data) or callable(self._validity)

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

    def _to_host(self, num_rows: int):
        """(data, validity or None) of the first num_rows, copied to the
        host in the span `decode.copy` (`bytes`)."""
        with spans.span("decode.copy") as span:
            data = self.data[:num_rows].cpu().numpy()
            validity = self.validity
            valid = validity[:num_rows].cpu().numpy() if validity is not None else None
            if span:
                span.set("bytes", data.nbytes + (0 if valid is None else valid.nbytes))
        return data, valid

    def decode(self, num_rows: int) -> np.ndarray:
        """Copy the first num_rows to the host, decoding dictionary codes
        and turning NULLs into None (object array). Spans: `decode.copy`
        (the copies, `bytes`), `decode.strings` (the dictionary's values
        and the NULLs filled in, `rows`)."""
        data, valid = self._to_host(num_rows)
        if valid is None:
            valid = np.ones(num_rows, dtype=bool)
        if self.dtype is DataType.STRING:
            with spans.span("decode.strings", cpu=True) as span:
                span.set("rows", num_rows)
                return _direct_strings(self.dictionary, data, valid)
        if not valid.all():
            with spans.span("decode.strings", cpu=True) as span:
                span.set("rows", num_rows)
                out = np.empty(num_rows, dtype=object)
                out[:] = data
                out[~valid] = None
                return out
        return data

    def decode_frame_column(self, num_rows: int, mask: Optional[np.ndarray] = None):
        """The first num_rows, or those of them that `mask` keeps, as
        Table.to_pandas puts them into its DataFrame: what decode gives,
        except that a string column's codes are picked by the mask first
        and then taken from its dictionary's kept array (_frame_strings).
        The span `decode.strings` (`rows`, and `cache`: `hit`, `build` or
        `direct`) covers the take."""
        if self.dtype is not DataType.STRING:
            values = self.decode(num_rows)
            return values if mask is None else values[mask]
        data, valid = self._to_host(num_rows)
        if mask is not None:
            data = data[mask]
            valid = None if valid is None else valid[mask]
        with spans.span("decode.strings", cpu=True) as span:
            values, how = _frame_strings(self.dictionary, data, valid)
            if span:
                span.set("rows", len(data))
                span.set("cache", how)
            return values

    def with_name(self, name: str) -> "Column":
        # shares the (possibly still-unmaterialized) payload; a rename never
        # transforms values, so the value metadata survives
        return Column(name, self.dtype, self._data, self._validity,
                      self.dictionary, self.device, self._capacity,
                      self.unique, self.val_range, self.encoded)

    def block(self, lo: int, hi: int) -> "Column":
        """Rows [lo, hi) over this column's storage, copying nothing: views
        of the data and validity, or of an encoded column's payload where
        its encoding can be cut there (storage/encoding.py; the block then
        decodes its own rows on first read); otherwise, and for a lazy
        column, a thunk that slices this column's dense form. The
        dictionary is shared; `unique` and `val_range` hold for any subset
        of the rows, so they carry over."""
        validity = self._validity
        if callable(validity):
            validity = (lambda: self.validity[lo:hi])  # noqa: E731
        elif validity is not None:
            validity = validity[lo:hi]
        payload = None if self.encoded is None else self.encoded.block(lo, hi)
        if payload is not None:
            dtype = self.dtype.torch_dtype
            data = (lambda: payload.decode(dtype))  # noqa: E731
        elif callable(self._data):
            data = (lambda: self.data[lo:hi])  # noqa: E731
        else:
            data = self._data[lo:hi]
        return Column(self.name, self.dtype, data, validity, self.dictionary, self.device,
                      hi - lo, self.unique, self.val_range, payload)

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
