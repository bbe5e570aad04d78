"""hyrise_tpu_torch — the PyTorch/CUDA port of hyrise_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths:

- Storage: tables are sets of device-resident column tensors (dictionary
  codes for strings) with validity masks, on a device the caller names.
- Operators: scan / projection / aggregate / sort over (values, validity)
  tensors, in plain torch; the TPU's Pallas kernels become hand-written
  CUDA kernels for sm_90a (kernels/csrc), built on first use.

It imports torch and numpy, never jax and nothing of hyrise_tpu; the
tests/test_torch_*.py files hold it against the JAX package.
"""

__version__ = "0.1.0"

from hyrise_tpu_torch.types import DataType, JoinMode, PredicateCondition, SortMode  # noqa: F401
from hyrise_tpu_torch.storage.table import Table  # noqa: F401
from hyrise_tpu_torch.storage.column import Column  # noqa: F401
from hyrise_tpu_torch.storage.catalog import Catalog  # noqa: F401
