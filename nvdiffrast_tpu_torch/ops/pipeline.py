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

from ..utils.trace import span, spanned
from . import coord
from .antialias import TopologyHashWrapper, _build_tables
from .pipeline_bwd_cuda import grad_scatter, pipeline_bwd
from .pipeline_cuda import MAX_A, shade_fwd
from .rasterize import as_device_tensor
from .rasterize_cuda import rasterize_fused
from .topology import build_opposite_table


@spanned("nvdr.attr_table")
def _attr_table(attr, atri, B, T):
    """[3A, B*T + 1] attribute table (dummy zero column last).

    Row k*A + a holds channel a of the triangle's vertex k. Broadcast
    attributes ([V, A] or [1, V, A]) are tiled over the B images so all
    gathers share the row offset b*T.
    """
    A = attr.shape[-1]
    atri = atri.long()
    if attr.ndim == 3 and attr.shape[0] != 1:
        tbl = attr[:, atri].reshape(-1, 3 * A).T  # [3A, B*T]
    else:
        a2d = attr[0] if attr.ndim == 3 else attr
        tbl = a2d[atri].reshape(-1, 3 * A).T  # [3A, T]
        if B > 1:
            tbl = tbl.repeat(1, B)
    zcol = torch.zeros((3 * A, 1), dtype=torch.float32, device=attr.device)
    return torch.cat([tbl, zcol], dim=1).contiguous()


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


def _corner_table(idx, V):
    """[V, D] corner ids 3*t + k of each vertex, ascending, padded with
    3T (a zero row of `_vertex_sum`); D is the largest vertex degree."""
    flat = idx.reshape(-1).long()
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    # On the card bincount reads the ids' min and max back: two syncs.
    with span("nvdr.sync.corner_count_min"), span("nvdr.sync.corner_count_max"):
        counts = torch.bincount(flat, minlength=V)
    with span("nvdr.sync.corner_degree"):
        D = int(counts.max()) if n else 0
    slot = torch.arange(D, device=idx.device)
    pos = (torch.cumsum(counts, 0) - counts)[:, None] + slot
    has = slot < counts[:, None]
    return torch.where(has, order[pos.clamp(max=max(n - 1, 0))], n)


def _vertex_sum(rows, corners):
    """Triangle-corner rows [B, 3T, F] -> vertex rows [B, V, F].

    A gather and a dense sum over each vertex's corners: no scatter and
    no atomics, so the result is the same on every run and device.
    """
    zero = rows.new_zeros((rows.shape[0], 1, rows.shape[2]))
    return torch.cat([rows, zero], dim=1)[:, corners].sum(2)


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
    return (vertex_pos_grad(gt[:, K:], gaa, tri, pos_shape, boost),
            vertex_attr_grad(gt[:, :K], atri, attr_shape, B))


@spanned("nvdr.vertex_sums")
def vertex_attr_grad(ga, atri, attr_shape, B):
    """Triangle-corner attribute rows [B*T, 3A] -> the gradient shaped
    like attr; broadcast attributes sum the batch first."""
    T = atri.shape[0]
    A = attr_shape[-1]
    ga = ga.reshape(B, 3 * T, A)
    acorners = _corner_table(atri, attr_shape[-2])
    if len(attr_shape) == 2 or attr_shape[0] == 1:  # broadcast attributes
        return _vertex_sum(ga.sum(0, keepdim=True), acorners).reshape(attr_shape)
    return _vertex_sum(ga, acorners)


@spanned("nvdr.vertex_sums")
def vertex_pos_grad(g9, gaa, tri, pos_shape, boost):
    """Triangle-corner clip-space rows (raster [B*T, 9], antialias
    [B*T, 9]) -> g_pos [B, V, 4], the antialias part times boost."""
    B, V = pos_shape[0], pos_shape[1]
    T = tri.shape[0]
    gxyw = torch.cat([g9.reshape(B, 3 * T, 3), gaa.reshape(B, 3 * T, 3)], dim=2)
    gv = _vertex_sum(gxyw, _corner_table(tri, V))
    g_aa = gv[..., 3:] * boost if boost != 1.0 else gv[..., 3:]
    g_xyw = gv[..., :3] + g_aa
    g_pos = torch.zeros((B, V, 4), dtype=torch.float32, device=g9.device)
    with span("nvdr.sync.pos_grad_xyw"):  # the list index is copied to the card
        g_pos[..., [0, 1, 3]] = g_xyw
    return g_pos


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

    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("render_pipeline: topology_hash must be a "
                            "TopologyHashWrapper")
        op_table = topology_hash.op_table.to(dev)
    else:
        op_table = build_opposite_table(tri)

    if A > MAX_A:
        # Past the fused kernel's width: the standalone ops, as the JAX
        # package's fallback composes them (ops/pipeline.py:249-262).
        from .antialias import antialias
        from .interpolate import interpolate
        from .rasterize import rasterize

        rast, _ = rasterize(None, pos, tri, resolution, grad_db=False)
        color, _ = interpolate(attr, rast, atri)
        return antialias(color, rast, pos, tri, topology_hash=TopologyHashWrapper(op_table),
                         pos_gradient_boost=pos_gradient_boost)
    return _PipelineFn.apply(pos, attr, tri, atri, op_table, resolution,
                             float(pos_gradient_boost))
