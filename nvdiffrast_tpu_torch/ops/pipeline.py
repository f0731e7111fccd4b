"""Fused rasterize -> interpolate -> antialias render (torch).

Counterpart of ``nvdiffrast_tpu/ops/pipeline.py``. ``render_pipeline``
renders ``antialias(interpolate(attr, rast, attr_idx)[0], rast, pos,
tri)`` as a ``torch.autograd.Function``. The forward runs two kernels,
the rasterizer (``rasterize_cuda``) and the fused interpolate +
antialias shade (``pipeline_cuda.shade_fwd``); the backward runs two,
the per-pixel backward and the per-triangle gradient scatter
(``pipeline_bwd_cuda``), with plain tensor glue around them. Gradients
flow to ``pos`` (rasterize and antialias paths, ``pos_gradient_boost``
on the antialias part) and ``attr``. A call runs on the device of
``pos``: CPU tensors take the plain PyTorch twins, CUDA tensors the
kernels.
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import spanned
from . import coord
from .antialias import antialias
from .interpolate import interpolate
from .pipeline_bwd_cuda import grad_scatter, pipeline_bwd
from .pipeline_cuda import MAX_A, shade_fwd
from .rasterize import as_device_tensor, rasterize
from .rasterize_cuda import rasterize_fused
from .topology import (TopologyHashWrapper, _attr_table, _build_tables, opposite_table,
                       vertex_attr_grad, vertex_pos_grad)


def _pipeline_fwd_core(pos, attr, tri, atri, op_table, resolution):
    """Forward core: (color [B, H, W, A], saved) where saved holds what
    the backward consumes: the flat rasterizer buffers b0, b1, idf, the
    pre-AA colour c0 [A, N], the AA residuals al0, ax0, al1, ax1 and the
    attribute and clip-space vertex tables."""
    H, W = resolution
    B = pos.shape[0]
    T = tri.shape[0]
    A = attr.shape[-1]
    N = B * H * W

    u, v, zw, idf = rasterize_fused(pos, tri, resolution)
    b0f = u.reshape(N)
    b1f = v.reshape(N)
    zwf = zw.reshape(N)
    idff = idf.reshape(N)

    atbl = _attr_table(attr, atri, B, T)
    ftable, btable, _R, _T = _build_tables(pos, tri, op_table, H, W)
    out_cols, c0, res = shade_fwd(atbl, ftable, b0f, b1f, zwf, idff,
                                  resolution, T)
    color = out_cols.T.reshape(B, H, W, A)
    return color, (b0f, b1f, idff, c0, *res, atbl, btable)


def own_rows(idf, T, resolution):
    """[N] int32 table row of each pixel's own triangle, b*T + id - 1;
    pixels without a triangle (all-zero gradient columns) get row b*T."""
    H, W = resolution
    N = idf.shape[0]
    tid0 = coord.float_to_triidx(idf) - 1
    valid = (tid0 >= 0) & (tid0 < T)
    rofs = torch.arange(N, dtype=torch.int32, device=idf.device) // (H * W) * T
    return torch.where(valid, tid0, 0) + rofs


def _pipeline_bwd_core(tri, atri, saved, resolution, boost, pos_shape,
                       attr_shape, dy):
    """(g_pos [B, V, 4], g_attr shaped like attr) from the image gradient
    dy [B, H, W, A] (ops/pipeline.py:98-167 of the JAX package)."""
    b0f, b1f, idff, c0, al0, ax0, al1, ax1, atbl, vtbl = saved
    H, W = resolution
    B = pos_shape[0]
    T = tri.shape[0]
    A = attr_shape[-1]
    N = B * H * W
    K = 3 * A

    dy_cols = dy.reshape(N, A).T.contiguous()
    gs, dd2, rid2 = pipeline_bwd(atbl, vtbl, idff, c0, dy_cols,
                                 (al0, ax0, al1, ax1), resolution, T)
    gt, gaa = grad_scatter(own_rows(idff, T, resolution), gs, dd2, rid2, b0f,
                           b1f, ax0, ax1, vtbl, resolution)
    return (vertex_pos_grad(gt[:, K:], tri, pos_shape, gaa, boost),
            vertex_attr_grad(gt[:, :K], atri, attr_shape, B))


class _PipelineFn(torch.autograd.Function):
    """render_pipeline with its hand-written backward."""

    @staticmethod
    def forward(ctx, pos, attr, tri, atri, op_table, resolution, boost):
        color, saved = _pipeline_fwd_core(pos, attr, tri, atri, op_table,
                                          resolution)
        ctx.save_for_backward(tri, atri, *saved)
        ctx.resolution = resolution
        ctx.boost = boost
        ctx.pos_shape = tuple(pos.shape)
        ctx.attr_shape = tuple(attr.shape)
        return color

    @staticmethod
    @once_differentiable
    @spanned("nvdr.render_pipeline.bwd")
    def backward(ctx, dy):
        tri, atri, *saved = ctx.saved_tensors
        g_pos, g_attr = _pipeline_bwd_core(
            tri, atri, saved, ctx.resolution, ctx.boost, ctx.pos_shape,
            ctx.attr_shape, dy)
        return (g_pos if ctx.needs_input_grad[0] else None,
                g_attr if ctx.needs_input_grad[1] else None,
                None, None, None, None, None)


@spanned("nvdr.render_pipeline")
def render_pipeline(pos, tri, attr, resolution, attr_idx=None,
                    topology_hash=None, pos_gradient_boost=1.0):
    """Render the fused rasterize + interpolate + antialias pipeline.

    Equivalent to::

        rast, _ = rasterize(None, pos, tri, resolution, grad_db=False)
        color, _ = interpolate(attr, rast, attr_idx or tri)
        out = antialias(color, rast, pos, tri, topology_hash,
                        pos_gradient_boost)

    Differentiable with respect to `pos` and `attr`.

    Args:
        pos: [minibatch, num_vertices, 4] float32 clip-space positions.
            A tensor runs on its device (CPU tensors on the plain
            twins); anything else is put on the default CUDA device,
            and raises RuntimeError where there is none.
        tri: [num_triangles, 3] int32.
        attr: [minibatch or 1, num_vertices_attr, A] or
            [num_vertices_attr, A] float32 vertex attributes; past 8
            channels the call composes rasterize, interpolate and
            antialias.
        resolution: (height, width).
        attr_idx: triangle tensor for the attribute topology (defaults
            to `tri`; must have the same number of triangles).
        topology_hash: optional TopologyHashWrapper for `tri`.
        pos_gradient_boost: multiplier for the antialias position
            gradients.

    Returns:
        Antialiased color image [minibatch, height, width, A].
    """
    pos = as_device_tensor(pos, "render_pipeline")
    dev = pos.device
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    attr = torch.as_tensor(attr, dtype=torch.float32, device=dev)
    atri = tri if attr_idx is None else torch.as_tensor(
        attr_idx, dtype=torch.int32, device=dev)
    resolution = tuple(int(x) for x in resolution)

    if pos.ndim != 3:
        # As the JAX package: its composed path calls rasterize without
        # ranges, which refuses 2-D pos.
        raise ValueError("render_pipeline: range mode requires `ranges` (pos is 2D); "
                         "pass [minibatch, num_vertices, 4] positions")
    if atri.shape[0] != tri.shape[0]:
        raise ValueError(
            f"render_pipeline: attr_idx triangle count {atri.shape[0]} "
            f"must match tri {tri.shape[0]}")
    if attr.ndim not in (2, 3) or (attr.ndim == 3
                                   and attr.shape[0] not in (1, pos.shape[0])):
        raise ValueError(
            "render_pipeline: attr must be [minibatch or 1, V, A] or [V, A]; "
            f"got {tuple(attr.shape)}")
    A = attr.shape[-1]
    if A < 1:
        raise ValueError("render_pipeline: attr has no channels")

    op_table = opposite_table(topology_hash, tri, "render_pipeline")

    if A > MAX_A:
        # Past the fused kernel's width: the standalone ops, as the JAX
        # package's fallback composes them (ops/pipeline.py:249-262).
        rast, _ = rasterize(None, pos, tri, resolution, grad_db=False)
        color, _ = interpolate(attr, rast, atri)
        return antialias(color, rast, pos, tri, topology_hash=TopologyHashWrapper(op_table),
                         pos_gradient_boost=pos_gradient_boost)
    return _PipelineFn.apply(pos, attr, tri, atri, op_table, resolution,
                             float(pos_gradient_boost))
