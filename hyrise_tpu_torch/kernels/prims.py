"""The primitives the operators share.

The port's counterparts of hyrise_tpu/kernels/tpu_prims.py: stream
compaction, segmented reductions, ranks in a sorted array and the join
lookups. Three of them are hand-written CUDA kernels with a plain torch
version beside each, kept in modules of their own and re-exported here:
`segment_reduce_cells` (kernels/group_reduce.py), `lookup_last_eq_lut` and
`expand_pairs` (kernels/join_probe.py). The rest are plain torch. The
TPU-only forms (MXU prefix sums, packed sort payloads, merged-sort ranks,
the fast_path() switch) work around XLA on the TPU and have no
counterpart: each primitive has one form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hyrise_tpu_torch.kernels.group_reduce import (  # noqa: F401
    DENSE_CELL_MAX, segment_reduce_cells)
from hyrise_tpu_torch.kernels.join_probe import (  # noqa: F401
    LUT_MAX_ENTRIES, expand_pairs, lookup_last_eq_lut)


def compact_indices(mask: torch.Tensor) -> torch.Tensor:
    """int64 positions of the True entries of a bool mask, in order."""
    return torch.nonzero(mask).squeeze(1)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[i] with segment_ids[i] == s (0 if none)."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, identity) -> torch.Tensor:
    """out[s] = min of values[i] with segment_ids[i] == s (identity if none)."""
    out = torch.full((num_segments,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segment_ids, values, reduce="amin")


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, identity) -> torch.Tensor:
    """out[s] = max of values[i] with segment_ids[i] == s (identity if none)."""
    out = torch.full((num_segments,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segment_ids, values, reduce="amax")


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


def lookup_last_eq(build_keys: torch.Tensor, build_valid: torch.Tensor,
                   probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each probe key: (matched, build row), with lookup_last_eq_lut's
    meaning (the LAST valid build row with an equal key, 0 where none), for
    keys of any range and for float keys: one stable sort of the build side
    and two binary searches per probe row. Plain torch."""
    sorted_keys, perm = sort_valid_keys(build_keys, build_valid)
    lo, hi = ranks_lo_hi(sorted_keys, probe_keys)
    matched = hi > lo
    if perm.shape[0] == 0:
        return matched, torch.zeros_like(probe_keys, dtype=torch.int64)
    # the stable sort keeps equal keys in row order: the last is at hi - 1
    row = perm.index_select(0, (hi - 1).clamp(min=0).to(torch.int64))
    return matched, torch.where(matched, row, 0)
