"""Several processes, one shard each.

Port of hyrise_tpu/parallel/multihost.py (reference: none; Hyrise is
single-node). Every process calls `initialize_from_env()` before it builds
a mesh:

    COORDINATOR=host0:8476 NUM_PROCESSES=4 PROCESS_ID=$i python app.py

It joins a `torch.distributed` process group (NCCL on the card, gloo on the
CPU); `make_mesh()` then gives one shard per rank on that rank's device, and
the exchanges of parallel/exchange.py run as the group's collectives. Every
rank builds the same tables (from the same seed) and keeps its own shard
(parallel/partition.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch


def initialize_from_env(device: str = "cuda",
                        timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group that COORDINATOR (`host:port`, or an init
    method URL such as `file:///path`), NUM_PROCESSES and PROCESS_ID
    describe: NCCL on the card (the rank takes cuda:(rank % device_count)),
    gloo on the CPU (`device="cpu"`). Returns False, and does nothing, when
    COORDINATOR is not set. `timeout` bounds every collective of the group
    (torch's default when None)."""
    import torch.distributed as dist

    coordinator = os.environ.get("COORDINATOR")
    if not coordinator:
        return False
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_from_env: no CUDA device (pass device='cpu' for gloo)")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    world = int(os.environ["NUM_PROCESSES"])
    rank = int(os.environ["PROCESS_ID"])
    if kind == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=url,
                            world_size=world, rank=rank, **kwargs)
    return True


def process_info():
    """This process's index and the process count, its shard's device and
    every rank's (one all_gather_object over the group: every rank calls
    it). Without a process group: one process holding every card."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cpu"]
        return {"process_index": 0, "process_count": 1, "local_devices": devices,
                "global_devices": devices}
    local = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu"
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_devices": [local], "global_devices": every}
