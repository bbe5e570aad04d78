"""Column encodings.

Port of hyrise_tpu/storage/encoding.py (reference: src/lib/storage/
encoding_type.hpp, chunk_encoder.hpp, run_length_column.hpp,
frame_of_reference_column.hpp and vector_compression/):

- DICTIONARY (and FIXED_STRING_DICTIONARY): a string column is already
  dictionary codes, which are narrowed to the smallest integer type that
  holds them; a numeric column gets a sorted dictionary of its distinct
  values and narrowed codes into it.
- RUN_LENGTH: (values, end positions) of the runs of equal values.
- FRAME_OF_REFERENCE: per block of 2,048 rows the block's minimum, and
  narrowed offsets from it (integral columns and string codes only).

Every encoded column is a regular Column whose `encoded` slot holds the
payload and whose `data` is a thunk that decodes it on first read, so the
operators never see an encoding. Encoding runs on the column's device; the
payloads are the JAX package's, dtype for dtype and value for value.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

FOR_BLOCK = 2048  # reference: frame_of_reference_column.hpp block_size


class EncodingType(enum.Enum):
    """Reference: storage/encoding_type.hpp:20."""

    UNENCODED = "unencoded"
    DICTIONARY = "dictionary"
    RUN_LENGTH = "run_length"
    FIXED_STRING_DICTIONARY = "fixed_string_dictionary"
    FRAME_OF_REFERENCE = "frame_of_reference"


def compress_attribute_vector(data: torch.Tensor) -> torch.Tensor:
    """Integer values in the narrowest of int8, int16, int32 and int64 that
    holds their range (one host read of the minimum and maximum)."""
    if data.dtype.is_floating_point or data.numel() == 0:
        return data
    lo, hi = torch.stack([data.amin(), data.amax()]).tolist()
    for dt in (torch.int8, torch.int16, torch.int32):
        info = torch.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return data.to(dt)
    return data.to(torch.int64)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclasses.dataclass
class NarrowCodes:
    """Dictionary codes in the narrowest integer type, with the sorted
    dictionary of a numeric column (None for a string column, whose
    dictionary stays on the host)."""

    codes: torch.Tensor
    dictionary: Optional[torch.Tensor]

    def memory_bytes(self) -> int:
        return _nbytes(self.codes) + _nbytes(self.dictionary)

    def decode(self, dtype: torch.dtype) -> torch.Tensor:
        if self.dictionary is None:
            return self.codes.to(torch.int32)
        return self.dictionary[self.codes.long()].to(dtype)

    def block(self, lo: int, hi: int) -> "NarrowCodes":
        """Rows [lo, hi): a view of the codes, the dictionary shared."""
        return NarrowCodes(self.codes[lo:hi], self.dictionary)


@dataclasses.dataclass
class RunLengthColumn:
    """values[i] fills rows [end_positions[i-1], end_positions[i])."""

    values: torch.Tensor
    end_positions: torch.Tensor  # int32, ascending, the last == num_rows
    num_rows: int

    def memory_bytes(self) -> int:
        return _nbytes(self.values) + _nbytes(self.end_positions)

    def decode(self, dtype: torch.dtype) -> torch.Tensor:
        rows = torch.arange(self.num_rows, dtype=torch.int32,
                            device=self.values.device)
        run = torch.searchsorted(self.end_positions, rows, right=True)
        return self.values[run.clamp_(max=max(self.values.shape[0] - 1, 0))].to(dtype)

    def block(self, lo: int, hi: int) -> None:
        """A run may start before `lo`: no view of the runs gives the rows."""
        return None


@dataclasses.dataclass
class FrameOfReferenceColumn:
    frames: torch.Tensor   # per block of FOR_BLOCK rows: its minimum
    offsets: torch.Tensor  # narrowed, FOR_BLOCK per block
    num_rows: int

    def memory_bytes(self) -> int:
        return _nbytes(self.frames) + _nbytes(self.offsets)

    def decode(self, dtype: torch.dtype) -> torch.Tensor:
        dense = self.frames[:, None] + self.offsets.view(-1, FOR_BLOCK).to(self.frames.dtype)
        return dense.view(-1)[:self.num_rows].to(dtype)

    def block(self, lo: int, hi: int) -> Optional["FrameOfReferenceColumn"]:
        """Rows [lo, hi) as views of whole frames where `lo` starts one, else
        None."""
        if lo % FOR_BLOCK:
            return None
        first, last = lo // FOR_BLOCK, -(-hi // FOR_BLOCK)
        return FrameOfReferenceColumn(self.frames[first:last],
                                      self.offsets[first * FOR_BLOCK:last * FOR_BLOCK],
                                      hi - lo)


def dictionary_encode(data: torch.Tensor) -> NarrowCodes:
    """Sorted distinct values and each row's code, as np.unique gives them:
    NaNs share one entry (the last), and -0.0 and 0.0 one entry."""
    n = data.shape[0]
    sorted_values, order = torch.sort(data, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=data.device)
    if n > 1:
        same = sorted_values[1:] == sorted_values[:-1]
        if data.dtype.is_floating_point:
            same |= sorted_values[1:].isnan() & sorted_values[:-1].isnan()
        new[1:] = ~same
    codes = torch.empty(n, dtype=torch.int64, device=data.device)
    codes[order] = torch.cumsum(new, 0) - 1
    return NarrowCodes(compress_attribute_vector(codes), sorted_values[new])


def run_length_encode(data: torch.Tensor) -> RunLengthColumn:
    n = data.shape[0]
    change = torch.ones(n, dtype=torch.bool, device=data.device)
    if n > 1:
        change[1:] = data[1:] != data[:-1]  # NaN != NaN: each NaN is a run
    starts = change.nonzero().view(-1)
    ends = torch.cat([starts[1:], torch.tensor([n], device=data.device)]) if n \
        else starts
    return RunLengthColumn(data[change], ends.to(torch.int32), n)


def frame_of_reference_encode(data: torch.Tensor) -> FrameOfReferenceColumn:
    n = data.shape[0]
    n_blocks = max(-(-n // FOR_BLOCK), 1)
    padded = torch.zeros(n_blocks * FOR_BLOCK, dtype=data.dtype, device=data.device)
    padded[:n] = data
    if n:
        padded[n:] = data[-1]  # the tail repeats the last value
    blocks = padded.view(n_blocks, FOR_BLOCK)
    frames = blocks.amin(dim=1)
    # the difference is taken in the column's type, as numpy does (it wraps
    # where a block spans more than the type; the decode wraps back)
    offsets = (blocks - frames[:, None]).to(torch.int64).view(-1)
    return FrameOfReferenceColumn(frames, compress_attribute_vector(offsets), n)


def _encoded_column(column: Column, payload, dtype: torch.dtype) -> Column:
    return Column(column.name, column.dtype, lambda: payload.decode(dtype),
                  column._validity, column.dictionary, column.device,
                  column.capacity, column.unique, column.val_range, payload)


class ChunkEncoder:
    """Reference: storage/chunk_encoder.hpp:20-40: re-encode the columns of
    a table by a spec."""

    @staticmethod
    def encode_column(column: Column, encoding: EncodingType) -> Column:
        """The column in `encoding`; UNENCODED returns it as it is. A
        column's encoding covers its whole capacity."""
        if encoding is EncodingType.UNENCODED:
            return column
        data = column.data
        dtype = column.dtype.torch_dtype
        if encoding in (EncodingType.DICTIONARY, EncodingType.FIXED_STRING_DICTIONARY):
            if column.dtype is DataType.STRING:
                payload = NarrowCodes(compress_attribute_vector(data), None)
            else:
                payload = dictionary_encode(data)
        elif encoding is EncodingType.RUN_LENGTH:
            payload = run_length_encode(data)
        elif encoding is EncodingType.FRAME_OF_REFERENCE:
            if column.dtype is DataType.STRING:  # the code vector is integral
                data = data.to(torch.int64)
            elif not column.dtype.is_integral:
                raise ValueError(f"FrameOfReference needs an integral column, "
                                 f"{column.name!r} is {column.dtype.value}")
            payload = frame_of_reference_encode(data)
        else:
            raise ValueError(encoding)
        return _encoded_column(column, payload, dtype)

    @staticmethod
    def encode_table(table: Table, spec) -> Table:
        """A new table over the re-encoded columns. `spec` is one
        EncodingType for every column it suits, or {column name:
        EncodingType} (reference: a ColumnEncodingSpec per column);
        FRAME_OF_REFERENCE leaves floating-point columns as they are. The
        new table keeps the rows, live mask and MVCC state, and remembers
        the spec, merged into the one it had, for ChunkCompressionTask."""
        cols = []
        for c in table.columns:
            enc = spec.get(c.name) if isinstance(spec, dict) else spec
            if enc is None or (enc is EncodingType.FRAME_OF_REFERENCE
                               and c.dtype.is_floating):
                cols.append(c)
            else:
                cols.append(ChunkEncoder.encode_column(c, enc))
        out = Table(cols, table.num_rows, name=table.name, live=table.live)
        out.mvcc = table.mvcc
        prev = table.encoding_spec
        out.encoding_spec = {**prev, **spec} if isinstance(prev, dict) and \
            isinstance(spec, dict) else spec
        return out


def encoded_memory_bytes(column: Column) -> int:
    """The device bytes a column holds at rest: its payload if it is
    encoded, else its dense data, plus a byte a row of validity."""
    if column.encoded is not None:
        n = column.encoded.memory_bytes()
    else:
        n = _nbytes(column.data)
    if column.has_validity:
        n += column.capacity
    return n
