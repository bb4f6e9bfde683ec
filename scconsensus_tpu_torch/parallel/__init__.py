"""Mesh parallelism: one process driving one shard per device.

The torch form of ``scconsensus_tpu/parallel/``: cells sharded across the
mesh for the aggregate reductions (``psum``) and the N×N distance work
(the ring's ``ppermute`` rotation of cell blocks), genes sharded for the
rank-sum tests. See ``parallel.mesh`` for the mesh and its collectives.
"""

from scconsensus_tpu_torch.parallel.mesh import make_mesh, pad_axis_to_multiple
from scconsensus_tpu_torch.parallel.ring import (
    ring_cluster_distance_sums,
    sharded_silhouette_widths,
)
from scconsensus_tpu_torch.parallel.sharded_de import (
    sharded_aggregates,
    sharded_wilcox_logp,
)
from scconsensus_tpu_torch.parallel.step import distributed_refine_step

__all__ = [
    "make_mesh",
    "pad_axis_to_multiple",
    "ring_cluster_distance_sums",
    "sharded_silhouette_widths",
    "sharded_aggregates",
    "sharded_wilcox_logp",
    "distributed_refine_step",
]
