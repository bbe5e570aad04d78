"""Multi-key stable sort machinery shared by Sort and Aggregate.

Port of hyrise_tpu/ops/sort_util.py (reference: src/lib/operators/sort.cpp
std::stable_sorts (RowID, value) pairs, sort.cpp:180-210). torch has no
lexsort, so the permutation is built the way a least-significant-digit
radix sort is: one stable torch.sort per key, from the least significant
key to the most significant, each reordering the permutation so far.

Conventions:
- dead rows always sort last;
- NULL ordering per SortMode (Hyrise default: NULLs first);
- strings sort by their order-preserving dictionary codes;
- DESC negates the int64/float64 key, so the INT64 minimum sorts as if it
  were the maximum (negation wraps), exactly as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, SortMode


def _value_key(data: torch.Tensor, dtype: DataType, ascending: bool) -> torch.Tensor:
    if dtype.is_integral or dtype is DataType.STRING:
        key = data.to(torch.int64)
    else:
        key = data.to(torch.float64)
    return key if ascending else -key


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by keys; the LAST key is primary
    (numpy/jax lexsort order)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = torch.sort(key.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, order)
    return perm


def sort_permutation(table: Table, sort_defs: Sequence[Tuple[str, SortMode]],
                     nulls_tie: bool = False) -> torch.Tensor:
    """Stable permutation ordering live rows by sort_defs, dead rows last.
    With nulls_tie the NULLs of a key compare equal, whatever values lie
    under them; without it they order by those values, as in the JAX
    package's Sort."""
    keys: List[torch.Tensor] = []
    # lexsort: LAST key is primary; append from least to most significant.
    for name, mode in reversed(list(sort_defs)):
        c = table.column(name)
        key = _value_key(c.data, c.dtype, mode.ascending)
        if nulls_tie and c.validity is not None:
            key = torch.where(c.validity, key, 0)
        keys.append(key)
        if c.validity is not None:
            # the null flag outranks the value. nulls_first: NULL -> 0 else 1.
            flag = c.validity if mode.nulls_first else ~c.validity
            keys.append(flag.to(torch.int32))
    keys.append((~table.live_mask()).to(torch.int32))
    return lexsort(keys)


def group_permutation(table: Table, groupby: Sequence[str]) -> torch.Tensor:
    """Permutation clustering equal group keys. NULLs are one group: they
    must tie, or a later key would be sorted within each value hidden under
    a NULL and split the NULL group into several runs."""
    return sort_permutation(table, [(name, SortMode.ASCENDING) for name in groupby],
                            nulls_tie=True)


def group_boundaries(table: Table, groupby: Sequence[str],
                     perm: torch.Tensor) -> torch.Tensor:
    """Bool flags over the permuted row order: True where a new group starts.

    Only meaningful for live rows; flag[0] is True when num_rows > 0.
    """
    flags = torch.zeros(perm.shape[0], dtype=torch.bool, device=perm.device)
    if perm.shape[0] == 0:
        return flags
    # slices, not flags[0] = ...: a Python value set into a CUDA tensor is a
    # copy from the host, which a captured plan may not make
    if isinstance(table.num_rows, torch.Tensor):
        flags[:1].copy_((table.num_rows > 0).reshape(1))
    else:
        flags[:1].fill_(table.num_rows > 0)
    for name in groupby:
        c = table.column(name)
        v = c.data.index_select(0, perm)
        prev = torch.roll(v, 1)
        differs = v != prev
        if v.is_floating_point():
            # the sort clusters NaNs contiguously; NaN != NaN would start a
            # new group per NaN row — SQL grouping puts all NaNs in ONE
            differs = differs & ~(torch.isnan(v) & torch.isnan(prev))
        if c.validity is not None:
            val = c.validity.index_select(0, perm)
            val_prev = torch.roll(val, 1)
            differs = (differs & val & val_prev) | (val != val_prev)
        differs[:1].zero_()
        flags = flags | differs
    return flags
