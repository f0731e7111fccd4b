"""Textured render pipeline, forward and backward (torch).

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

In the mip filter modes the pipeline is a ``torch.autograd.Function``
with gradients to ``pos``, ``uv_attr`` and ``tex``: its backward follows
the JAX package's pipeline-level vjp (``_ptex_bwd_core``) with four more
kernels: the texture's uv / level backward and its gradient
(``texture_bwd_cuda``), the fused interpolate + rasterize backward
(``pipeline_tex_bwd_cuda``) and the gradient scatter with the uv_da
terms (``pipeline_bwd_cuda.grad_scatter``); the slim antialias backward,
the mip level's and the pyramid's vjps and the vertex sums are tensor
glue. ``filter_mode='linear'`` renders, but a call that would record
gradients there raises: the JAX package takes the composed ops' own
backwards for it, which are not ported yet.
"""

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import texture as tx
from .antialias import TopologyHashWrapper, _build_tables
from .antialias_cuda import MAX_C, aa_forward
from .interpolate_cuda import interp_forward
from .pipeline import _attr_table, own_rows, vertex_attr_grad, vertex_pos_grad
from .pipeline_bwd_cuda import grad_scatter
from .pipeline_tex_bwd_cuda import aa_bwd_slim, interp_raster_bwd_tex
from .rasterize import _check_rasterize_args
from .rasterize_cuda import rasterize_fused
from .texture_bwd_cuda import texture_bwd, texture_grad
from .texture_cuda import sample
from .topology import build_opposite_table


def _ptex_fwd_core(pos, uv_attr, tex, tri, uv_tri, op_table, resolution,
                   filter_mode, boundary_mode, max_mip_level):
    """Forward of the textured pipeline: ([B, H, W, C] image, saved,
    meta), with what the backward reads (``_ptex_bwd_core``)."""
    N = pos.shape[0] * resolution[0] * resolution[1]
    outs = rasterize_fused(pos, tri, resolution,
                           emit_db="mipmap" in filter_mode)
    return _shade_textured(pos, uv_attr, tex, tri, uv_tri, op_table,
                           tuple(a.reshape(N) for a in outs), resolution,
                           filter_mode, boundary_mode, max_mip_level)


def _shade_textured(pos, uv_attr, tex, tri, uv_tri, op_table, raster,
                    resolution, filter_mode, boundary_mode, max_mip_level):
    """The chain after the rasterizer. raster: flat [N] (u, v, zw, idf),
    followed by (dudx, dudy, dvdx, dvdy) for the mip filter modes.

    Returns (image [B, H, W, C], saved, meta): saved = (u, v, idf, the 4
    bary derivatives [N] (mip modes; else empty), uv [2, N], da [4, N],
    flevel, the packed pyramid, the pre-AA colour [C, N], the AA
    residuals al0, ax0, al1, ax1 and the clip-space vertex table), what
    the backward reads; meta = the pyramid's level layout."""
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

    ftable, vtbl, _, _ = _build_tables(pos, tri, op_table, H, W)
    out, res = aa_forward(color, idf, zw, ftable, (B, H, W), T)
    saved = (u, v, idf, *raster[4:8], uv, da, flevel, flat, color, *res, vtbl)
    return out.T.reshape(B, H, W, C), saved, meta


def _ptex_bwd_core(saved, uv_attr, tri, uv_tri, resolution, filter_mode,
                   boundary_mode, meta, boost, pos_shape, tex_shape, needs,
                   dy):
    """(g_pos, g_uv, g_tex) from the image gradient dy [B, H, W, C]
    (``nvdiffrast_tpu/ops/pipeline_tex.py:122-220``); a gradient not in
    `needs` (pos, uv, tex) is None and its chain is skipped."""
    u, v, idf, *db, uv, da, flevel, flat, color, al0, ax0, al1, ax1, vtbl = saved
    H, W = resolution
    B = pos_shape[0]
    T = tri.shape[0]
    D, th, tw, C = tex_shape
    N = B * H * W
    shape = (B, H, W)

    # 1. Slim antialias backward: colour cotangent + pair streams.
    gc, dd2, rid2 = aa_bwd_slim(dy.reshape(N, C).T.contiguous(), color, idf,
                                (al0, ax0, al1, ax1), shape, T)
    g_pos = g_uv = g_tex = None

    # 2. Texture gradient, through the pyramid to the base texture.
    if needs[2]:
        g_flat = texture_grad(uv[0], uv[1], flevel, gc, meta, flat.shape[0],
                              shape, D > 1, boundary_mode, filter_mode)
        g_tex = tx.pyramid_vjp(g_flat, meta, D, C)
    if not (needs[0] or needs[1]):
        return g_pos, g_uv, g_tex

    # 3. uv and mip level gradients, the level's chain to uv_da.
    gu, gv, gfl = texture_bwd(flat, uv[0], uv[1], flevel, gc, meta, shape,
                              D > 1, boundary_mode, filter_mode)
    gda4 = tx.mip_level_vjp(da, gfl, th, tw, len(meta))

    # 4. Fused interpolate + rasterize backward; 5. one scatter for the uv,
    # raster and antialias pair gradients; then triangle -> vertex rows.
    out15 = interp_raster_bwd_tex(_attr_table(uv_attr, uv_tri, B, T), vtbl,
                                  idf, gu, gv, gda4, torch.stack(db), resolution,
                                  T)
    gt, gaa = grad_scatter(own_rows(idf, T, resolution), out15[:11], dd2, rid2,
                           u, v, ax0, ax1, vtbl, resolution, da4=out15[11:])
    if needs[0]:
        g_pos = vertex_pos_grad(gt[:, 6:], gaa, tri, pos_shape, boost)
    if needs[1]:
        g_uv = vertex_attr_grad(gt[:, :6], uv_tri, tuple(uv_attr.shape), B)
    return g_pos, g_uv, g_tex


class _PipelineTexFn(torch.autograd.Function):
    """render_pipeline_textured (mip filter modes) with its hand-written
    backward."""

    @staticmethod
    def forward(ctx, pos, uv_attr, tex, tri, uv_tri, op_table, resolution,
                filter_mode, boundary_mode, max_mip_level, boost):
        img, saved, meta = _ptex_fwd_core(pos, uv_attr, tex, tri, uv_tri,
                                          op_table, resolution, filter_mode,
                                          boundary_mode, max_mip_level)
        ctx.save_for_backward(uv_attr, tri, uv_tri, *saved)
        ctx.modes = (resolution, filter_mode, boundary_mode, meta, boost)
        ctx.shapes = (tuple(pos.shape), tuple(tex.shape))
        return img

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        uv_attr, tri, uv_tri, *saved = ctx.saved_tensors
        grads = _ptex_bwd_core(saved, uv_attr, tri, uv_tri, *ctx.modes,
                               *ctx.shapes, ctx.needs_input_grad[:3],
                               dy.contiguous())
        return grads + (None,) * 8


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
        pos_gradient_boost: antialias position-gradient multiplier.
        topology_hash: optional TopologyHashWrapper for `tri`.

    Returns:
        Antialiased textured image [minibatch, height, width, C];
        differentiable with respect to `pos`, `uv_attr` and `tex` in the
        mip filter modes.
    """
    tx.check_modes(filter_mode, boundary_mode)
    if not isinstance(pos, torch.Tensor):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "render_pipeline_textured: a non-tensor pos runs on the GPU, "
                "and torch sees no CUDA device; pass CPU tensors to run on "
                "the CPU")
        pos = torch.as_tensor(np.asarray(pos, np.float32), device="cuda")
    dev = pos.device
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (pos, uv_attr, tex))
    if grad and "mipmap" not in filter_mode:
        raise NotImplementedError(
            "render_pipeline_textured: gradients with filter_mode='linear' "
            "are not ported yet (ROADMAP A.4: the composed chain's "
            "backwards, kernels B6 and B8 and the standalone rasterize "
            "backward); use a mip filter mode, or call under "
            "torch.no_grad()")
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
    args = (pos, uv_attr, tex, tri, uv_tri, op_table, resolution, filter_mode,
            boundary_mode, int(max_mip_level))
    if grad:
        return _PipelineTexFn.apply(*args, float(pos_gradient_boost))
    return _ptex_fwd_core(*args)[0]
