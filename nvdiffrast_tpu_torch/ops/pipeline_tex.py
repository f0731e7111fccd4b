"""Textured render pipeline, forward and backward (torch).

Counterpart of ``nvdiffrast_tpu/ops/pipeline_tex.py``:
``render_pipeline_textured`` renders

    rast, rast_db = rasterize(pos, tri, resolution, grad_db=True)
    uv, uv_da = interpolate(uv_attr, rast, uv_tri, rast_db, diff_attrs='all')
    color = texture(tex, uv, uv_da, filter_mode, boundary_mode)
    out = antialias(color, rast, pos, tri)

on flat channel-major buffers, as the JAX package's fused branch
(``_ptex_fwd_core``) and its flat chain for ``filter_mode='linear'``
do. Kernels carry it: the rasterizer with bary derivatives
(``rasterize_cuda``), the interpolate forward (``interpolate_cuda``), the
mip level (``texture.mip_level``) and the texture sampler
(``texture_cuda``), and the antialias forward (``antialias_cuda``); the
mip pyramid and the neighbour adds are plain tensor glue. A call runs on
the device of ``pos``: CPU tensors take the plain PyTorch twins, CUDA
tensors the kernels.

The pipeline is a ``torch.autograd.Function`` with gradients to ``pos``,
``uv_attr`` and ``tex``. In the mip filter modes its backward follows
the JAX package's pipeline-level vjp (``_ptex_bwd_core``) with more
kernels: the texture's uv / level backward and its gradient
(``texture_bwd_cuda``), the mip level's vjp (``texture.level_vjp``),
the fused interpolate + rasterize backward (``pipeline_tex_bwd_cuda``)
and the gradient scatter with the uv_da terms
(``pipeline_bwd_cuda.grad_scatter``); the slim antialias backward, the
pyramid's vjp and the vertex sums are tensor glue. With
``filter_mode='linear'`` it composes the standalone ops' backwards, as
the JAX package's flat chain does
(``pipeline_tex.py:362-427``): antialias (kernels B8, B10), the texture
(``texture_bwd_cuda``), interpolate (kernels B6, B10) and rasterize
(kernels B9, B10).

What the fused kernels do not serve (per-image uvs, more than 8
channels, 'nearest', cube maps) composes the standalone ops, as the JAX
package's fallback does (``_composed``).
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import span, spanned
from . import texture as tx
from .antialias import TopologyHashWrapper, _build_tables, aa_bwd_flat
from .antialias_cuda import MAX_C, aa_forward
from .interpolate_cuda import interp_backward, interp_forward
from .pipeline import _attr_table, own_rows, vertex_attr_grad, vertex_pos_grad
from .pipeline_bwd_cuda import grad_scatter
from .pipeline_tex_bwd_cuda import aa_bwd_slim, interp_raster_bwd_tex
from .rasterize import _check_rasterize_args, as_device_tensor, pixel_rows, raster_pos_grad
from .rasterize_cuda import rasterize_fused
from .scatter import scatter_add_by_id
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

    with span("nvdr.tex.pyramid"):
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

    use_mip = "mipmap" in filter_mode
    dy = dy.reshape(N, C).T.contiguous()
    res = (al0, ax0, al1, ax1)
    # 1. Antialias backward: colour cotangent + pair streams (mip modes:
    # the slim form; linear: the op's, with its position gradient).
    if use_mip:
        gc, dd2, rid2 = aa_bwd_slim(dy, color, idf, res, shape, T)
    else:
        gc, g_pos_aa = aa_bwd_flat(dy, color, idf, vtbl, res, shape, tri, pos_shape,
                                   boost, need_pos=needs[0])
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
    if not use_mip:
        # Linear: interpolate's backward (uv, no derivatives), then the
        # rasterizer's without db.
        grast, gval, _ = interp_backward(_attr_table(uv_attr, uv_tri, 1, T), u, v, idf,
                                         None, torch.stack([gu, gv]), None, (), T, 0)
        if needs[1]:
            gt = scatter_add_by_id(pixel_rows(idf, T, 0, T), gval, T)
            g_uv = vertex_attr_grad(gt, uv_tri, tuple(uv_attr.shape), 1)
        if needs[0]:
            g_pos = raster_pos_grad(vtbl, tri, pos_shape, idf, grast[0], grast[1], None,
                                    resolution) + g_pos_aa
        return g_pos, g_uv, g_tex
    gda4 = tx.level_vjp(da, gfl, th, tw, len(meta))[0]

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
    """render_pipeline_textured with its hand-written backward."""

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
    @spanned("nvdr.render_pipeline_textured.bwd")
    def backward(ctx, dy):
        uv_attr, tri, uv_tri, *saved = ctx.saved_tensors
        grads = _ptex_bwd_core(saved, uv_attr, tri, uv_tri, *ctx.modes,
                               *ctx.shapes, ctx.needs_input_grad[:3],
                               dy.contiguous())
        return grads + (None,) * 8


@spanned("nvdr.render_pipeline_textured")
def render_pipeline_textured(pos, tri, uv_attr, tex, resolution, uv_tri=None,
                             filter_mode="linear-mipmap-linear",
                             boundary_mode="wrap", max_mip_level=-1,
                             pos_gradient_boost=1.0, topology_hash=None):
    """Render rasterize + uv interpolate + texture + antialias.

    Args:
        pos: [minibatch, num_vertices, 4] float32 clip-space positions.
            A tensor runs on its device (CPU tensors on the plain
            twins); anything else is put on the default CUDA device,
            and raises RuntimeError where there is none.
        tri: [num_triangles, 3] int32.
        uv_attr: [num_uv_vertices, 2], [1, num_uv_vertices, 2] or
            [minibatch, num_uv_vertices, 2] float32 texture coordinates,
            or [..., 3] directions with boundary_mode='cube'.
        tex: [D, height, width, C] float32 texture, or a cube map
            [D, 6, w, w, C]; D = 1 or minibatch.
        resolution: (height, width).
        uv_tri: [num_triangles, 3] int32 uv indices (defaults to `tri`).
        filter_mode: 'nearest', 'linear', 'linear-mipmap-nearest' or
            'linear-mipmap-linear'.
        boundary_mode: 'wrap', 'clamp', 'zero' or 'cube'.
        max_mip_level: limit on the mip levels built; -1 = down to 1x1.
        pos_gradient_boost: antialias position-gradient multiplier.
        topology_hash: optional TopologyHashWrapper for `tri`.

    Returns:
        Antialiased textured image [minibatch, height, width, C];
        differentiable with respect to `pos`, `uv_attr` and `tex`.

    The fused kernels serve 2-D textures of up to 8 channels with one uv
    table in the linear and mip filter modes. Per-image uvs, more
    channels, 'nearest' and cube maps compose the standalone ops
    ``rasterize`` -> ``interpolate`` -> ``texture`` -> ``antialias``, as
    the JAX package's fallback does (``pipeline_tex.py:324-347``).
    """
    tx.check_modes(filter_mode, boundary_mode)
    pos = as_device_tensor(pos, "render_pipeline_textured")
    dev = pos.device
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (pos, uv_attr, tex))
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    uv_attr = torch.as_tensor(uv_attr, dtype=torch.float32, device=dev)
    tex = torch.as_tensor(tex, dtype=torch.float32, device=dev)
    uv_tri = tri if uv_tri is None else torch.as_tensor(
        uv_tri, dtype=torch.int32, device=dev)
    resolution = tuple(int(x) for x in resolution)
    cube = boundary_mode == "cube"

    # 2-D pos raises ValueError (range mode without ranges), as in JAX.
    _check_rasterize_args(pos, tri, resolution)
    B = pos.shape[0]
    if uv_tri.shape != tri.shape:
        raise ValueError(
            f"render_pipeline_textured: uv_tri {tuple(uv_tri.shape)} must "
            f"match tri {tuple(tri.shape)}")
    A = 3 if cube else 2
    if uv_attr.shape[-1] != A or not (
            uv_attr.ndim == 2 or (uv_attr.ndim == 3 and uv_attr.shape[0] in (1, B))):
        raise ValueError(
            f"render_pipeline_textured: uv_attr must be [V, {A}], [1, V, {A}] or "
            f"[minibatch, V, {A}]; got {tuple(uv_attr.shape)}")
    if uv_tri.numel():
        with span("nvdr.sync.uv_range_min"):
            out = int(uv_tri.min()) < 0
        if not out:
            with span("nvdr.sync.uv_range_max"):
                out = int(uv_tri.max()) >= uv_attr.shape[-2]
        if out:
            raise ValueError("render_pipeline_textured: uv_tri indices out of "
                             f"range [0, {uv_attr.shape[-2]})")
    if tex.ndim != (5 if cube else 4) or tex.shape[0] not in (1, B) or (
            cube and tex.shape[1] != 6):
        raise ValueError(
            "render_pipeline_textured: tex must be [1 or minibatch, h, w, C] (cube: "
            f"[1 or minibatch, 6, w, w, C]); got {tuple(tex.shape)}")

    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("render_pipeline_textured: topology_hash must be "
                            "a TopologyHashWrapper")
        op_table = topology_hash.op_table.to(dev)
    else:
        op_table = build_opposite_table(tri)
    per_image_uv = uv_attr.ndim == 3 and uv_attr.shape[0] > 1
    if (cube or filter_mode == "nearest" or tex.shape[-1] > MAX_C or per_image_uv):
        return _composed(pos, tri, uv_attr, tex, uv_tri, op_table, resolution, filter_mode,
                         boundary_mode, max_mip_level, pos_gradient_boost)
    args = (pos, uv_attr, tex, tri, uv_tri, op_table, resolution, filter_mode,
            boundary_mode, int(max_mip_level))
    if grad:
        return _PipelineTexFn.apply(*args, float(pos_gradient_boost))
    return _ptex_fwd_core(*args)[0]


def _composed(pos, tri, uv_attr, tex, uv_tri, op_table, resolution, filter_mode,
              boundary_mode, max_mip_level, boost):
    """The textured chain through the standalone ops (their kernels and
    backwards)."""
    from .antialias import antialias
    from .interpolate import interpolate
    from .rasterize import rasterize

    use_mip = "mipmap" in filter_mode
    rast, rast_db = rasterize(None, pos, tri, resolution, grad_db=use_mip)
    uv, uv_da = interpolate(uv_attr, rast, uv_tri, rast_db,
                            diff_attrs="all" if use_mip else None)
    img = tx.texture(tex, uv, uv_da if use_mip else None, filter_mode=filter_mode,
                     boundary_mode=boundary_mode, max_mip_level=max_mip_level)
    return antialias(img, rast, pos, tri, topology_hash=TopologyHashWrapper(op_table),
                     pos_gradient_boost=boost)
