"""Plain torch primitives the operators share.

The slice's counterparts of hyrise_tpu/kernels/tpu_prims.py: stream
compaction and segmented reductions. The TPU-only forms there (MXU prefix
sums, packed sort payloads, the fast_path() switch) work around XLA on the
TPU and have no counterpart: each primitive has one form.
"""

from __future__ import annotations

import torch


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
