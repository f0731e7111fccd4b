"""nvdiffrast_tpu_torch — the PyTorch + CUDA port of nvdiffrast_tpu.

The JAX package ``nvdiffrast_tpu`` is the reference; this package holds
the ported slices, with the same public layouts (``pos [B, V, 4]``,
``tri [T, 3]``, ``attr [B|1, V, A]``, images ``[B, H, W, A]``). It
imports torch and numpy only.

Ported so far, each a ``torch.autograd.Function`` with a hand-written
backward and hand-written CUDA kernels for Hopper (``csrc/``, built with
nvcc at first use on a GPU):

* the composable ops ``rasterize`` (instance mode, with ``rast_db``),
  ``interpolate`` (with ``diff_attrs``) and ``antialias``;
* ``render_pipeline`` (rasterize + interpolate + antialias fused):
  gradients to the clip-space positions and the vertex attributes;
* ``render_pipeline_textured`` (rasterize with bary derivatives + uv
  interpolate + 2-D texture + antialias), in the linear and mip filter
  modes: gradients to the positions, the uvs and the texture.

``models`` holds the cube and pose fitting models on the ops. CPU
tensors run the kernels' plain PyTorch twins. Every call runs on the
device of its input.
"""

__version__ = "0.1.0"

from .ops.antialias import (TopologyHashWrapper, antialias,
                            antialias_construct_topology_hash)
from .ops.coord import float_to_triidx, triidx_to_float
from .ops.interpolate import interpolate
from .ops.pipeline import render_pipeline
from .ops.pipeline_tex import render_pipeline_textured
from .ops.rasterize import DepthPeeler, RasterizeCudaContext, rasterize
from .utils.log import get_log_level, set_log_level

__all__ = [
    "__version__",
    "RasterizeCudaContext",
    "DepthPeeler",
    "rasterize",
    "interpolate",
    "antialias",
    "antialias_construct_topology_hash",
    "TopologyHashWrapper",
    "render_pipeline",
    "render_pipeline_textured",
    "triidx_to_float",
    "float_to_triidx",
    "get_log_level",
    "set_log_level",
]
