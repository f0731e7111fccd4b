"""nvdiffrast_tpu_torch — the PyTorch + CUDA port of nvdiffrast_tpu.

The JAX package ``nvdiffrast_tpu`` is the reference; this package holds
the ported slices, with the same public layouts (``pos [B, V, 4]``,
``tri [T, 3]``, ``attr [B|1, V, A]``, images ``[B, H, W, A]``). It
imports torch and numpy only.

Ported so far: ``render_pipeline`` (rasterize + interpolate +
antialias), forward and backward, with its four hand-written CUDA
kernels for Hopper (``csrc/``, built with nvcc at first use on a GPU):
gradients flow to the clip-space positions and the vertex attributes.
CPU tensors run the kernels' plain PyTorch twins. Every call runs on the
device of its input.
"""

__version__ = "0.1.0"

from .ops.antialias import TopologyHashWrapper, antialias_construct_topology_hash
from .ops.coord import float_to_triidx, triidx_to_float
from .ops.pipeline import render_pipeline
from .ops.rasterize import RasterizeCudaContext
from .utils.log import get_log_level, set_log_level

__all__ = [
    "__version__",
    "RasterizeCudaContext",
    "antialias_construct_topology_hash",
    "TopologyHashWrapper",
    "render_pipeline",
    "triidx_to_float",
    "float_to_triidx",
    "get_log_level",
    "set_log_level",
]
