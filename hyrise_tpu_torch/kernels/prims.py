"""The primitives the operators share.

The port's counterparts of hyrise_tpu/kernels/tpu_prims.py: stream
compaction, segmented reductions, ranks in a sorted array and the join
lookups. Each hand-written CUDA kernel lives in a module of its own with
its plain torch version beside it, and is re-exported here:
`segment_reduce_cells` and `segment_reduce_cells_many`
(kernels/group_reduce.py), `lookup_last_eq_lut` and
`expand_pairs` (kernels/join_probe.py), `compact_indices`
(kernels/compact.py), `segment_reduce_sorted` (kernels/segment_reduce.py)
and `lookup_last_eq` (kernels/hash_lookup.py). The rest are plain torch.
The TPU-only forms (MXU prefix sums, packed sort payloads, merged-sort
ranks, the fast_path() switch) work around XLA on the TPU and have no
counterpart: each primitive has one form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hyrise_tpu_torch.kernels.compact import compact_indices  # noqa: F401
from hyrise_tpu_torch.kernels.group_reduce import (  # noqa: F401
    DENSE_CELL_MAX, segment_reduce_cells, segment_reduce_cells_many)
from hyrise_tpu_torch.kernels.hash_lookup import lookup_last_eq  # noqa: F401
from hyrise_tpu_torch.kernels.join_probe import (  # noqa: F401
    LUT_MAX_ENTRIES, expand_pairs, lookup_last_eq_lut)
from hyrise_tpu_torch.kernels.segment_reduce import segment_reduce_sorted  # noqa: F401


def rank_in_sorted(sorted_keys: torch.Tensor, queries: torch.Tensor,
                   side: str) -> torch.Tensor:
    """int32 insertion rank of every query in sorted_keys, before ('left')
    or after ('right') the entries equal to it."""
    return torch.searchsorted(sorted_keys, queries, right=(side == "right"),
                              out_int32=True)


def ranks_lo_hi(sorted_keys: torch.Tensor,
                queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left rank, right rank) of every query: the entries equal to query q
    are sorted_keys[lo[q]:hi[q]]."""
    return (rank_in_sorted(sorted_keys, queries, "left"),
            rank_in_sorted(sorted_keys, queries, "right"))


def sort_valid_keys(keys: torch.Tensor,
                    valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valid rows of `keys` in ascending (key, original row) order:
    (sorted keys, int64 original row of each). One compaction and one
    stable sort; invalid rows are left out instead of sorted last behind a
    sentinel."""
    rows = compact_indices(valid)
    sorted_keys, order = torch.sort(keys.index_select(0, rows), stable=True)
    return sorted_keys, rows.index_select(0, order)
