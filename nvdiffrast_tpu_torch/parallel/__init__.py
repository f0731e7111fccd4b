"""Multi-device scaling on torch.distributed: meshes of ranks, data
parallelism and row-band (spatial) rendering.

Counterpart of ``nvdiffrast_tpu/parallel``. One process a rank, one
device a rank: the minibatch is split over the "dp" axis of a mesh and
image rows over the "sp" axis, while the geometry and textures are
replicated. Every rank runs the single-device pipeline, its kernels
included; ``collectives`` holds what crosses ranks (the dp gradient
means, the sp one-row AA halos and gradient sums), on nccl or gloo.
``replicated`` marks a row band's inputs that every rank holds the same
copy of, so that their gradients are summed over the bands.

Left out, as decided for the port: ``render_shardings``,
``shard_pipeline`` and ``sharded_train_step``, the JAX package's
GSPMD-constraint API. Eager PyTorch has no sharding constraints, and
``shard_map_train_step`` (data parallelism) and ``make_sp_render`` /
``antialias_sp`` (row bands) cover what they did.
"""

from . import multihost
from .collectives import replicated
from .mesh import default_mesh, make_mesh
from .shard import shard_map_train_step
from .spatial import antialias_sp, make_sp_render

__all__ = [
    "make_mesh",
    "default_mesh",
    "shard_map_train_step",
    "antialias_sp",
    "make_sp_render",
    "multihost",
    "replicated",
]
