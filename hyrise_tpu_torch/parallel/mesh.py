"""The mesh of shards.

Port of hyrise_tpu/parallel/mesh.py (the successor of the reference's
Topology singleton, src/lib/scheduler/topology.hpp:43-110). A Mesh is the
list of shards a query runs over and where this process holds them:

- in one process (no process group): every shard is held here, shard `s`
  on `cuda:(s % device_count)`. On one card every shard shares `cuda:0`:
  the analogue of the JAX package's
  `--xla_force_host_platform_device_count`, with real tables in each shard;
- over a `torch.distributed` process group (parallel/multihost.py): one
  shard per rank, held by that rank on its own device. A mix of several
  local shards and several ranks is not supported.

The JAX file's `shard_spec` and `replicated_spec` name XLA shardings of one
array over the mesh; eager torch keeps a list of per-shard tensors instead
(parallel/partition.py), so they have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

SHARD_AXIS = "shards"


@dataclasses.dataclass
class Mesh:
    """`devices`: the device of each shard this process holds, in shard
    order; `group`: the process group whose ranks hold one shard each, or
    None when this process holds every shard."""

    devices: List[torch.device]
    group: Optional[object] = None

    @property
    def n_shards(self) -> int:
        if self.group is None:
            return len(self.devices)
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def local_shards(self) -> List[int]:
        """The global indices of the shards this process holds."""
        if self.group is None:
            return list(range(len(self.devices)))
        import torch.distributed as dist
        return [dist.get_rank(self.group)]

    @property
    def home(self) -> torch.device:
        """Where this process keeps what every shard holds alike (replicated
        tables): its first shard's device."""
        return self.devices[0]


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A mesh of `n_devices` shards on `device` ("cuda", the default, or
    "cpu"); raises if "cuda" is asked for without a card. In a process that
    joined a process group (multihost.initialize_from_env), one shard per
    rank: `n_devices` must then be None or the world size. Otherwise every
    shard is held here: `n_devices` of them (default: one per card, or one
    on the CPU), shard s on cuda:(s % device_count)."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for a CPU mesh)")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a process group of {world} ranks holds {world} shards, "
                             f"not {n_devices} (several shards per rank are not supported)")
        dev = torch.device("cuda", rank % torch.cuda.device_count()) if kind == "cuda" \
            else torch.device("cpu")
        return Mesh([dev], group=dist.group.WORLD)
    n = n_devices if n_devices is not None else \
        (torch.cuda.device_count() if kind == "cuda" else 1)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if kind == "cuda":
        count = torch.cuda.device_count()
        return Mesh([torch.device("cuda", s % count) for s in range(n)])
    return Mesh([torch.device("cpu")] * n)
