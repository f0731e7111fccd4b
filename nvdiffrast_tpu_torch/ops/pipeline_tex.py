"""Textured render pipeline, forward (torch).

Counterpart of ``nvdiffrast_tpu/ops/pipeline_tex.py`` for 2-D textures:
``render_pipeline_textured`` renders

    rast, rast_db = rasterize(pos, tri, resolution, grad_db=True)
    uv, uv_da = interpolate(uv_attr, rast, uv_tri, rast_db, diff_attrs='all')
    color = texture(tex, uv, uv_da, filter_mode, boundary_mode)
    out = antialias(color, rast, pos, tri)

on flat channel-major buffers, as the JAX package's fused branch
(``_ptex_fwd_core``) and its flat chain for ``filter_mode='linear'``
do. Four kernels carry it: the rasterizer with bary derivatives
(``rasterize_cuda``), the interpolate forward (``interpolate_cuda``), the
texture sampler (``texture_cuda``) and the antialias forward
(``antialias_cuda``); the mip pyramid, the mip level and the neighbour
adds are plain tensor glue. A call runs on the device of ``pos``: CPU
tensors take the plain PyTorch twins, CUDA tensors the kernels.

Only the forward is ported: a call that would record gradients raises.
"""

import numpy as np
import torch

from . import texture as tx
from .antialias import TopologyHashWrapper, _build_tables
from .antialias_cuda import MAX_C, aa_forward
from .interpolate_cuda import interp_forward
from .pipeline import _attr_table
from .rasterize import _check_rasterize_args
from .rasterize_cuda import rasterize_fused
from .texture_cuda import sample
from .topology import build_opposite_table


def _ptex_fwd_core(pos, uv_attr, tex, tri, uv_tri, op_table, resolution,
                   filter_mode, boundary_mode, max_mip_level):
    """Forward of the textured pipeline: [B, H, W, C] image."""
    N = pos.shape[0] * resolution[0] * resolution[1]
    outs = rasterize_fused(pos, tri, resolution,
                           emit_db="mipmap" in filter_mode)
    return _shade_textured(pos, uv_attr, tex, tri, uv_tri, op_table,
                           tuple(a.reshape(N) for a in outs), resolution,
                           filter_mode, boundary_mode, max_mip_level)


def _shade_textured(pos, uv_attr, tex, tri, uv_tri, op_table, raster,
                    resolution, filter_mode, boundary_mode, max_mip_level):
    """The chain after the rasterizer. raster: flat [N] (u, v, zw, idf),
    followed by (dudx, dudy, dvdx, dvdy) for the mip filter modes."""
    H, W = resolution
    B = pos.shape[0]
    T = tri.shape[0]
    D, th, tw, C = tex.shape
    use_mip = "mipmap" in filter_mode

    levels = [tex] + (tx.build_mip_stack(tex, max_mip_level) if use_mip else [])
    meta, _ = tx._static_meta(levels)
    L = len(levels)
    flat = tx._pack_pyramid(levels)

    # uv and, for the mip level, its screen derivatives.
    u, v, zw, idf = raster[:4]
    uv, da = interp_forward(_attr_table(uv_attr, uv_tri, 1, T), u, v, idf,
                            raster[4:8] if use_mip else None,
                            (0, 1) if use_mip else ())
    flevel = tx.mip_level(da, th, tw, L) if use_mip else torch.zeros_like(u)
    color = sample(flat, uv[0], uv[1], flevel, meta, (B, H, W), D > 1,
                   boundary_mode, filter_mode)

    ftable, _, _, _ = _build_tables(pos, tri, op_table, H, W)
    out, _ = aa_forward(color, idf, zw, ftable, (B, H, W), T)
    return out.T.reshape(B, H, W, C)


def render_pipeline_textured(pos, tri, uv_attr, tex, resolution, uv_tri=None,
                             filter_mode="linear-mipmap-linear",
                             boundary_mode="wrap", max_mip_level=-1,
                             pos_gradient_boost=1.0, topology_hash=None):
    """Render rasterize + uv interpolate + 2-D texture + antialias.

    Args:
        pos: [minibatch, num_vertices, 4] float32 clip-space positions.
            A tensor runs on its device (CPU tensors on the plain
            twins); anything else is put on the default CUDA device,
            and raises RuntimeError where there is none.
        tri: [num_triangles, 3] int32.
        uv_attr: [num_uv_vertices, 2] or [1, num_uv_vertices, 2] float32
            texture coordinates.
        tex: [D, height, width, C] float32 texture, D = 1 or minibatch,
            C <= 8.
        resolution: (height, width).
        uv_tri: [num_triangles, 3] int32 uv indices (defaults to `tri`).
        filter_mode: 'linear', 'linear-mipmap-nearest' or
            'linear-mipmap-linear' ('nearest' is not ported yet).
        boundary_mode: 'wrap', 'clamp' or 'zero' ('cube' is not ported
            yet).
        max_mip_level: limit on the mip levels built; -1 = down to 1x1.
        pos_gradient_boost: antialias position-gradient multiplier; kept
            for the reference's signature (the backward is not ported).
        topology_hash: optional TopologyHashWrapper for `tri`.

    Returns:
        Antialiased textured image [minibatch, height, width, C].
    """
    del pos_gradient_boost  # a backward parameter; only the forward is ported
    tx.check_modes(filter_mode, boundary_mode)
    if not isinstance(pos, torch.Tensor):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "render_pipeline_textured: a non-tensor pos runs on the GPU, "
                "and torch sees no CUDA device; pass CPU tensors to run on "
                "the CPU")
        pos = torch.as_tensor(np.asarray(pos, np.float32), device="cuda")
    dev = pos.device
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (pos, uv_attr, tex)):
        raise NotImplementedError(
            "backward of render_pipeline_textured is not ported yet; call "
            "under torch.no_grad()")
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    uv_attr = torch.as_tensor(uv_attr, dtype=torch.float32, device=dev)
    tex = torch.as_tensor(tex, dtype=torch.float32, device=dev)
    uv_tri = tri if uv_tri is None else torch.as_tensor(
        uv_tri, dtype=torch.int32, device=dev)
    resolution = tuple(int(x) for x in resolution)

    if pos.ndim != 3:
        raise NotImplementedError(
            "render_pipeline_textured: only instance mode ([minibatch, V, 4] "
            "pos) is ported")
    _check_rasterize_args(pos, tri, resolution)
    if uv_tri.shape != tri.shape:
        raise ValueError(
            f"render_pipeline_textured: uv_tri {tuple(uv_tri.shape)} must "
            f"match tri {tuple(tri.shape)}")
    if uv_attr.shape[-1] != 2 or not (
            uv_attr.ndim == 2 or (uv_attr.ndim == 3 and uv_attr.shape[0] == 1)):
        raise ValueError(
            "render_pipeline_textured: uv_attr must be [V, 2] or [1, V, 2]; "
            f"got {tuple(uv_attr.shape)}")
    if uv_tri.numel() and (int(uv_tri.min()) < 0
                           or int(uv_tri.max()) >= uv_attr.shape[-2]):
        raise ValueError("render_pipeline_textured: uv_tri indices out of "
                         f"range [0, {uv_attr.shape[-2]})")
    if tex.ndim != 4 or tex.shape[0] not in (1, pos.shape[0]):
        raise ValueError(
            "render_pipeline_textured: tex must be [1 or minibatch, h, w, C]; "
            f"got {tuple(tex.shape)}")
    if not 1 <= tex.shape[-1] <= MAX_C:
        raise NotImplementedError(
            f"render_pipeline_textured: {tex.shape[-1]} texture channels; the "
            f"kernels serve 1 to {MAX_C}")

    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("render_pipeline_textured: topology_hash must be "
                            "a TopologyHashWrapper")
        op_table = topology_hash.op_table.to(dev)
    else:
        op_table = build_opposite_table(tri)
    return _ptex_fwd_core(pos, uv_attr, tex, tri, uv_tri, op_table, resolution,
                          filter_mode, boundary_mode, int(max_mip_level))
