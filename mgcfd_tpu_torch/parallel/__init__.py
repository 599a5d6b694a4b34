"""The sharded solver over torch.distributed (mgcfd_tpu/parallel/):
partition.py (node blocks, separators, 2-D tiles, MG bookkeeping, each
rank's CSRs), comm.py (the process group and the collectives), launch.py
(P ranks on one machine) and sharded.py (ShardedSolver, dryrun)."""
from .partition import (ShardedLevelData, ShardedMeshData,
                        partition2d_hierarchy, partition_level,
                        partition_mesh, partition_order_2d)
from .sharded import ShardedSolver, dryrun

__all__ = ["ShardedLevelData", "ShardedMeshData", "ShardedSolver", "dryrun",
           "partition2d_hierarchy", "partition_level", "partition_mesh",
           "partition_order_2d"]
