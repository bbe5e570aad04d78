"""Parallelism of the port: the operator-task scheduler (scheduler.py) and
distribution over a mesh of shards (mesh, multihost, partition, exchange,
dist_query, skew, dist_compiler, blocked_dist, placement), the JAX
package's parallel/ on torch tensors and torch.distributed."""

from hyrise_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from hyrise_tpu_torch.parallel.partition import ShardedTable, hash_partition  # noqa: F401
from hyrise_tpu_torch.parallel.exchange import (  # noqa: F401
    dist_filter_aggregate,
    dist_join_aggregate_step,
    repartition_by_key,
)
