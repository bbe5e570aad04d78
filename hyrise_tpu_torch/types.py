"""Core type system (host-only).

Copy of hyrise_tpu/types.py for the PyTorch/CUDA port, pinned by the parity
tests in tests/test_torch_*.py:

- The reference's 5-type `DataType` enum {int, long, float, double, string}
  maps to `DataType` below; strings are stored on the device as
  order-preserving int32 dictionary codes.
- `PredicateCondition`, `JoinMode`, `SortMode` and `AggregateFunction` keep
  the JAX package's semantics.

The JAX package's power-of-two capacity buckets (`bucket_capacity`) are not
carried over: they exist for XLA's static shapes, and PyTorch runs eagerly
on tensors of any length, so base tables hold exactly `num_rows` rows.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    STRING = "string"  # device repr: int32 order-preserving dictionary codes
    NULL = "null"      # type of an untyped NULL literal

    @property
    def numpy_dtype(self) -> np.dtype:
        if self is DataType.STRING:
            return np.dtype(np.int32)  # dictionary codes
        if self is DataType.NULL:
            return np.dtype(np.int32)
        return np.dtype(self.value)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.numpy_dtype]

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_integral(self) -> bool:
        return self in (DataType.INT32, DataType.INT64)

    @property
    def is_numeric(self) -> bool:
        return self.is_floating or self.is_integral


_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Numeric type promotion for arithmetic / comparisons (C++-like)."""
    if a is DataType.NULL:
        return b
    if b is DataType.NULL:
        return a
    if not (a.is_numeric and b.is_numeric):
        if a is DataType.STRING and b is DataType.STRING:
            return DataType.STRING
        raise TypeError(f"no common type for {a} and {b}")
    if DataType.FLOAT64 in (a, b):
        return DataType.FLOAT64
    if DataType.FLOAT32 in (a, b):
        # int64 + float32 -> float64 to avoid precision loss
        if DataType.INT64 in (a, b):
            return DataType.FLOAT64
        return DataType.FLOAT32
    if DataType.INT64 in (a, b):
        return DataType.INT64
    return DataType.INT32


class PredicateCondition(enum.Enum):
    """Reference: src/lib/types.hpp:166 (enum class PredicateCondition)."""

    EQUALS = "="
    NOT_EQUALS = "<>"
    LESS_THAN = "<"
    LESS_THAN_EQUALS = "<="
    GREATER_THAN = ">"
    GREATER_THAN_EQUALS = ">="
    BETWEEN = "between"
    IN = "in"
    NOT_IN = "not in"
    LIKE = "like"
    NOT_LIKE = "not like"
    IS_NULL = "is null"
    IS_NOT_NULL = "is not null"

    def flipped(self) -> "PredicateCondition":
        """Condition with operand sides swapped (a ? b  ==  b ?' a)."""
        flip = {
            PredicateCondition.LESS_THAN: PredicateCondition.GREATER_THAN,
            PredicateCondition.LESS_THAN_EQUALS: PredicateCondition.GREATER_THAN_EQUALS,
            PredicateCondition.GREATER_THAN: PredicateCondition.LESS_THAN,
            PredicateCondition.GREATER_THAN_EQUALS: PredicateCondition.LESS_THAN_EQUALS,
        }
        return flip.get(self, self)


class JoinMode(enum.Enum):
    """Reference: src/lib/types.hpp:189 (enum class JoinMode)."""

    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"
    CROSS = "cross"
    SEMI = "semi"
    ANTI = "anti"                          # AntiNullAsFalse (NOT EXISTS)
    ANTI_NULL_AS_TRUE = "anti_null_true"   # NOT IN: NULL key/probe rejects


# existence joins emit a filtered probe side, never build columns
EXISTENCE_MODES = (JoinMode.SEMI, JoinMode.ANTI, JoinMode.ANTI_NULL_AS_TRUE)
ANTI_MODES = (JoinMode.ANTI, JoinMode.ANTI_NULL_AS_TRUE)


class SortMode(enum.Enum):
    """Reference: OrderByMode in src/lib/types.hpp (Ascending/Descending ×
    NullsFirst/NullsLast)."""

    ASCENDING = "asc"               # nulls first (Hyrise default)
    DESCENDING = "desc"             # nulls first
    ASCENDING_NULLS_LAST = "asc_nulls_last"
    DESCENDING_NULLS_LAST = "desc_nulls_last"

    @property
    def ascending(self) -> bool:
        return self in (SortMode.ASCENDING, SortMode.ASCENDING_NULLS_LAST)

    @property
    def nulls_first(self) -> bool:
        return self in (SortMode.ASCENDING, SortMode.DESCENDING)


class AggregateFunction(enum.Enum):
    """Reference: AggregateFunction in src/lib/types.hpp (Min/Max/Sum/Avg/
    Count/CountDistinct, used by operators/aggregate.cpp)."""

    MIN = "min"
    MAX = "max"
    SUM = "sum"
    AVG = "avg"
    COUNT = "count"
    COUNT_DISTINCT = "count_distinct"


def aggregate_result_type(fn: AggregateFunction, input_type: DataType) -> DataType:
    """Result types, following the reference's aggregate_traits
    (src/lib/operators/aggregate/aggregate_traits.hpp): SUM widens integers to
    int64 and floats to float64, AVG is always float64, COUNT int64.
    """
    if fn in (AggregateFunction.COUNT, AggregateFunction.COUNT_DISTINCT):
        return DataType.INT64
    if fn is AggregateFunction.AVG:
        return DataType.FLOAT64
    if fn is AggregateFunction.SUM:
        if input_type.is_integral:
            return DataType.INT64
        return DataType.FLOAT64
    # MIN / MAX keep their input type.
    return input_type


NULL_SENTINEL_STRING_CODE = np.int32(-1)
