"""nvdiffrast_tpu_torch — the PyTorch + CUDA port of nvdiffrast_tpu.

The JAX package ``nvdiffrast_tpu`` is the reference; this package holds
every op of its public surface, with the same public layouts (``pos
[B, V, 4]``, ``tri [T, 3]``, ``attr [B|1, V, A]``, images ``[B, H, W,
A]``). It imports torch and numpy only.

Each op is a ``torch.autograd.Function`` with a hand-written backward
and hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at
first use on a GPU):

* the composable ops ``rasterize`` (instance and range mode, with
  ``rast_db`` and viewport bands) and ``DepthPeeler``, ``interpolate``
  (with ``diff_attrs``) and ``antialias`` (any channel count);
* ``render_pipeline`` (rasterize + interpolate + antialias fused; more
  than 8 attributes through the composed ops): gradients to the
  clip-space positions and the vertex attributes;
* ``texture`` (2-D textures in every filter and boundary mode, cube maps
  with seamless filtering; ``uv_da``, ``mip_level_bias``, mip stacks from
  ``texture_construct_mip`` or lists): gradients to the texture (or its
  mip levels), uv, uv_da and the bias;
* ``render_pipeline_textured`` (rasterize with bary derivatives + uv
  interpolate + texture + antialias): fused kernels for 2-D textures of
  up to 8 channels, the composed ops for the rest; gradients to the
  positions, the uvs and the texture.

``models`` holds the cube, pose, earth and envphong fitting models on
the ops. CPU
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
from .ops.rasterize import (DepthPeeler, RasterizeCudaContext, RasterizeGLContext,
                            rasterize)
from .ops.texture import TextureMipWrapper, texture, texture_construct_mip
from .utils.log import get_log_level, set_log_level

__all__ = [
    "__version__",
    "RasterizeCudaContext",
    "RasterizeGLContext",
    "rasterize",
    "DepthPeeler",
    "interpolate",
    "texture",
    "texture_construct_mip",
    "TextureMipWrapper",
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
