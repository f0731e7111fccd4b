"""The differentiable rasterize op and its helpers (torch).

Counterpart of ``nvdiffrast_tpu/ops/rasterize.py``: the
correctly-rounded edge coefficient product, the near-plane epsilon, the
context class, the argument checks, ``rasterize``, a
``torch.autograd.Function``, and ``DepthPeeler``. The forward is the
record setup and the rasterizer kernel with bary derivatives
(``rasterize_cuda.rasterize_records(emit_db=True)``) in instance or range
mode, under a viewport, and with the peel depth of the previous layer;
the kernel writes rast and rast_db as ``[B, H, W, 4]`` itself. The
backward reads the id channel of rast, gathers each pixel's clip-space
vertex table column (kernel B9, ``gather.table_take``), runs the
per-pixel math of ``_raster_grad_pixel_cols`` as tensor glue (it is XLA
in the JAX package too), reduces the rows to triangles (kernel B10,
``scatter.scatter_add_by_id``) and sums them into vertices (in range
mode into the one shared ``[V, 4]``, over all images).
"""

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import spanned
from . import coord
from .topology import check_indices, vertex_pos_grad, vertex_table

# Triangles are clipped against w >= _W_CLIP_EPS (near plane guard).
_W_CLIP_EPS = 1e-9


class RasterizeCudaContext:
    """Stateless rasterizer context, kept for API parity.

    All state lives in tensors; the object only carries the device and
    the active depth peeler slot of the reference's API.
    """

    def __init__(self, device=None):
        self.device = device
        self.active_depth_peeler = None


class RasterizeGLContext(RasterizeCudaContext):
    """Deprecated alias of RasterizeCudaContext, kept for API parity."""

    def __init__(self, output_db=True, mode="automatic", device=None):
        import warnings

        warnings.warn(
            "RasterizeGLContext has been deprecated and uses RasterizeCudaContext internally",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(device=device)

    def set_context(self):
        pass

    def release_context(self):
        pass


def _dop(a, b, c, d):
    """Correctly-rounded f32 difference of products fl(a*b - c*d).

    Both f32 products are exact in f64 (24+24 <= 53 mantissa bits), so
    the single f64 subtraction rounds once and the f64->f32 convert
    rounds again, deterministically, as the JAX package does. The two
    triangles sharing an edge see bitwise opposite coefficients, and a
    bitwise-duplicate (x, y, w) vertex pair gets exact zeros.
    """
    a, b, c, d = (t.to(torch.float64) for t in (a, b, c, d))
    return (a * b - c * d).to(torch.float32)


def _check_rasterize_args(pos, tri, resolution, ranges=None):
    """Shape, dtype and index checks (rasterize.py:1001-1005 of the JAX
    package): range mode (2-D pos) requires ranges [minibatch, 2].
    Raises ValueError for a malformed call."""
    if pos.ndim not in (2, 3) or pos.shape[-1] != 4 or pos.shape[-2] == 0:
        raise ValueError(
            "rasterize: pos must be [num_vertices, 4] (range mode) or "
            f"[minibatch, num_vertices, 4] (instanced); got {tuple(pos.shape)}")
    if pos.dtype != torch.float32:
        raise ValueError(f"rasterize: pos must be float32; got {pos.dtype}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(
            f"rasterize: tri must be [num_triangles, 3]; got {tuple(tri.shape)}")
    if tri.dtype != torch.int32:
        raise ValueError(f"rasterize: tri must be int32; got {tri.dtype}")
    if tri.shape[0] >= (1 << 24):
        raise ValueError(
            f"rasterize: triangle count {tri.shape[0]} exceeds the 2**24 "
            "capacity limit")
    h, w = resolution
    if h <= 0 or w <= 0:
        raise ValueError(f"rasterize: invalid resolution {resolution}")
    if pos.ndim == 2 and (ranges is None or ranges.ndim != 2 or ranges.shape[1] != 2):
        raise ValueError(
            "rasterize: range mode requires ranges [minibatch, 2]; "
            f"got {None if ranges is None else tuple(ranges.shape)}")
    check_indices(tri, pos.shape[-2], "rasterize: triangle indices", "tri_range")


def as_device_tensor(x, what):
    """`x` itself if it is a tensor (a call runs on its device); anything
    else as a float32 tensor on the default CUDA device, or RuntimeError
    where torch sees none."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: a non-tensor input runs on the GPU, and torch sees no CUDA "
            "device; pass CPU tensors to run on the CPU")
    return torch.as_tensor(np.asarray(x, np.float32), device="cuda")


# ---------------------------------------------------------------------------
# Backward (rasterize.py:612-800 of the JAX package).
# ---------------------------------------------------------------------------

def raster_grad_math(t9, fx, fy, gb0, gb1, ddb, W, H):
    """The 9 clip-space vertex gradient columns of pixels with bary
    cotangents (gb0, gb1) and, optionally, db cotangents ddb = (d0, d1,
    d2, d3): the math of ``_raster_grad_pixel_cols`` (rasterize.py:655-750)
    before its mask, with the copysign(1e-6) area epsilon. t9: the
    gathered (x, y, w) of the 3 vertices; fx, fy: pixel centres in clip
    space. Returns a list of 9 tensors."""
    x0, y0, w0, x1, y1, w1, x2, y2, w2 = t9
    p0x = x0 - fx * w0
    p0y = y0 - fy * w0
    p1x = x1 - fx * w1
    p1y = y1 - fy * w1
    p2x = x2 - fx * w2
    p2y = y2 - fy * w2
    a0 = p1x * p2y - p1y * p2x
    a1 = p2x * p0y - p2y * p0x
    a2 = p0x * p1y - p0y * p1x
    at = a0 + a1 + a2
    ep = torch.where(at >= 0, 1e-6, -1e-6)
    iw = 1.0 / (at + ep)
    b0 = a0 * iw
    b1 = a1 * iw
    gB0 = gb0 * iw
    gB1 = gb1 * iw
    gbb = gB0 * b0 + gB1 * b1
    gp0x = gbb * (p2y - p1y) - gB1 * p2y
    gp1x = gbb * (p0y - p2y) + gB0 * p2y
    gp2x = gbb * (p1y - p0y) - gB0 * p1y + gB1 * p0y
    gp0y = gbb * (p1x - p2x) + gB1 * p2x
    gp1y = gbb * (p2x - p0x) - gB0 * p2x
    gp2y = gbb * (p0x - p1x) + gB0 * p1x - gB1 * p0x
    gp0w = -fx * gp0x - fy * gp0y
    gp1w = -fx * gp1x - fy * gp1y
    gp2w = -fx * gp2x - fy * gp2y
    if ddb is not None:
        dfxdX = (2.0 / W) * iw
        dfydY = (2.0 / H) * iw
        d0 = ddb[0] * dfxdX
        d1 = ddb[1] * dfydY
        d2 = ddb[2] * dfxdX
        d3 = ddb[3] * dfydY
        da0dX = y1 * w2 - y2 * w1
        da1dX = y2 * w0 - y0 * w2
        da2dX = y0 * w1 - y1 * w0
        da0dY = x2 * w1 - x1 * w2
        da1dY = x0 * w2 - x2 * w0
        da2dY = x1 * w0 - x0 * w1
        datdX = da0dX + da1dX + da2dX
        datdY = da0dY + da1dY + da2dY
        x01 = x0 - x1
        x12 = x1 - x2
        x20 = x2 - x0
        y01 = y0 - y1
        y12 = y1 - y2
        y20 = y2 - y0
        w01 = w0 - w1
        w12 = w1 - w2
        w20 = w2 - w0
        a0p1 = fy * x2 - fx * y2
        a0p2 = fx * y1 - fy * x1
        a1p0 = fx * y2 - fy * x2
        a1p2 = fy * x0 - fx * y0
        wdudX = 2.0 * b0 * datdX - da0dX
        wdudY = 2.0 * b0 * datdY - da0dY
        wdvdX = 2.0 * b1 * datdX - da1dX
        wdvdY = 2.0 * b1 * datdY - da1dY
        c0 = iw * (d0 * wdudX + d1 * wdudY + d2 * wdvdX + d3 * wdvdY)
        cx = c0 * fx - d0 * b0 - d2 * b1
        cy = c0 * fy - d1 * b0 - d3 * b1
        cxy = iw * (d0 * datdX + d1 * datdY)
        czw = iw * (d2 * datdX + d3 * datdY)
        gp0x = gp0x + c0 * y12 - cy * w12 + czw * p2y + d3 * w2
        gp1x = gp1x + c0 * y20 - cy * w20 - cxy * p2y - d1 * w2
        gp2x = gp2x + c0 * y01 - cy * w01 + cxy * p1y - czw * p0y + d1 * w1 - d3 * w0
        gp0y = gp0y + cx * w12 - c0 * x12 - czw * p2x - d2 * w2
        gp1y = gp1y + cx * w20 - c0 * x20 + cxy * p2x + d0 * w2
        gp2y = gp2y + cx * w01 - c0 * x01 - cxy * p1x + czw * p0x - d0 * w1 + d2 * w0
        gp0w = gp0w + cy * x12 - cx * y12 - czw * a1p0 + d2 * y2 - d3 * x2
        gp1w = gp1w + cy * x20 - cx * y20 - cxy * a0p1 - d0 * y2 + d1 * x2
        gp2w = (gp2w + cy * x01 - cx * y01 - cxy * a0p2 - czw * a1p2
                + d0 * y1 - d1 * x1 - d2 * y0 + d3 * x0)
    return [gp0x, gp0y, gp0w, gp1x, gp1y, gp1w, gp2x, gp2y, gp2w]


def pixel_rows(idf, T, hw, rows):
    """[N] int32 table row of each pixel of a flat id channel: b*T + t for
    per-image tables (hw = H*W pixels an image), t for one table (hw = 0),
    and `rows` (out of range) where the pixel has no triangle."""
    tid = coord.float_to_triidx(idf) - 1
    valid = (tid >= 0) & (tid < T)
    if hw:
        pix = torch.arange(idf.shape[0], dtype=torch.int32, device=idf.device)
        tid = tid + pix // hw * T
    return torch.where(valid, tid, rows)


def pixel_centres(N, resolution, device, viewport=None):
    """Clip-space centres (fx, fy) [N] of the flat pixels of B images;
    viewport (y0, full_height): the images are rows [y0, y0 + H) of
    full_height-tall ones."""
    H, W = resolution
    y0, Hf = (0, H) if viewport is None else viewport
    xs, xo, ys, yo = coord.pixel_scale_offset(Hf, W)
    pix = torch.arange(N, dtype=torch.int32, device=device)
    fx = (pix % W).to(torch.float32) * xs + xo
    fy = ((pix // W) % H + y0).to(torch.float32) * ys + yo
    return fx, fy


@spanned("nvdr.raster.grad")
def raster_grad_rows(vtbl, idf, dyx, dyy, ddb, resolution, T, viewport=None):
    """Per-pixel vertex-position gradient rows (``_raster_grad_pixel_cols``).

    Args:
      vtbl: [9, B*T+1] ``vertex_table`` (instance mode) or [9, T+1]
        (range mode: one table, rows are the global triangle ids);
        idf: [N] rast id channel.
      dyx, dyy: [N] cotangents of rast channels 0-1; ddb: the 4 rast_db
        cotangent flats, or None without the db terms.
      resolution: (H, W); T: triangles per image; viewport: (y0,
        full_height) of the render, or None.

    Returns (g [9, N], rid [N] int32): the columns, zero where the pixel
    has no triangle or a value is not finite, and each pixel's table row
    (out of range where it has none). The 9-row gather is kernel B9
    (``gather.table_take``); the rest is tensor glue.
    """
    from .gather import table_take

    H, W = resolution
    R = vtbl.shape[1] - 1
    # One table (range mode, or one image): rows are the triangle ids.
    rid = pixel_rows(idf, T, H * W if R != T else 0, R)
    t9 = table_take(vtbl, rid)
    fx, fy = pixel_centres(idf.shape[0], resolution, idf.device, viewport)
    Hf = H if viewport is None else viewport[1]
    g = torch.stack(raster_grad_math(list(t9), fx, fy, dyx, dyy, ddb, W, Hf))
    return torch.where((rid < R)[None] & torch.isfinite(g), g, 0.0), rid


def raster_pos_grad(vtbl, tri, pos_shape, idf, dyx, dyy, ddb, resolution, viewport=None):
    """g_pos (pos_shape: [B, V, 4], or [V, 4] in range mode) of the
    rasterizer from its flat cotangents (vtbl: ``vertex_table`` of the
    positions): the per-pixel rows, their reduction to triangle rows
    (kernel B10, ``scatter.scatter_add_by_id``) and the deterministic
    vertex sums."""
    from .scatter import scatter_add_by_id

    g, rid = raster_grad_rows(vtbl, idf, dyx, dyy, ddb, resolution, tri.shape[0], viewport)
    return vertex_pos_grad(scatter_add_by_id(rid, g, vtbl.shape[1] - 1), tri, pos_shape)


class _RasterizeFn(torch.autograd.Function):
    """rasterize (and a depth peeling layer) with its hand-written
    backward. Returns (rast, rast_db, zbuf); zbuf, made only for the
    depth peeler (`emit_zbuf`) and None otherwise, is not
    differentiable."""

    @staticmethod
    def forward(ctx, pos, tri, resolution, grad_db, ranges, peel, viewport, emit_zbuf):
        from .rasterize_cuda import rasterize_records, setup_records

        # The arguments were checked by _prepare.
        outs = rasterize_records(setup_records(pos, tri, resolution, viewport), resolution,
                                 True, ranges=ranges, peel=peel, viewport=viewport,
                                 emit_zbuf=emit_zbuf, _api_layout=True)
        rast, rast_db = outs[:2]
        ctx.save_for_backward(pos, tri, rast)
        ctx.meta = (resolution, grad_db, viewport)
        ctx.set_materialize_grads(False)
        zbuf = outs[2] if emit_zbuf else None
        if emit_zbuf:
            ctx.mark_non_differentiable(zbuf)
        return rast, rast_db, zbuf

    @staticmethod
    @once_differentiable
    @spanned("nvdr.rasterize.bwd")
    def backward(ctx, d_rast, d_db, _d_zbuf):
        pos, tri, rast = ctx.saved_tensors
        resolution, grad_db, viewport = ctx.meta
        if not grad_db:
            d_db = None
        if d_rast is None and d_db is None:
            return (None,) * 8
        N = rast.numel() // 4
        idf = rast.reshape(N, 4)[:, 3]
        zero = idf.new_zeros(N)
        dy = (zero, zero) if d_rast is None else tuple(d_rast.reshape(N, 4).T[:2])
        ddb = None if d_db is None else tuple(d_db.reshape(N, 4).T)
        g_pos = raster_pos_grad(vertex_table(pos, tri), tri, tuple(pos.shape),
                                idf, *dy, ddb, resolution, viewport)
        return (g_pos,) + (None,) * 7


def _prepare(pos, tri, resolution, ranges, what):
    """The checked tensors of a rasterize call: (pos, tri, resolution,
    ranges); ranges is None in instance mode, where it is ignored."""
    pos = as_device_tensor(pos, what)
    tri = torch.as_tensor(tri, dtype=torch.int32, device=pos.device)
    resolution = tuple(int(x) for x in resolution)
    if pos.ndim == 2:
        if ranges is None:
            raise ValueError("range mode requires `ranges` (pos is 2D)")
        ranges = torch.as_tensor(ranges, dtype=torch.int32, device=pos.device)
    else:
        ranges = None
    _check_rasterize_args(pos, tri, resolution, ranges)
    return pos, tri, resolution, ranges


@spanned("nvdr.rasterize")
def rasterize(glctx, pos, tri, resolution, ranges=None, grad_db=True, viewport=None):
    """Rasterize triangles.

    Args:
        glctx: a ``RasterizeCudaContext`` or None (kept for API parity).
        pos: float32 clip-space positions, [minibatch, V, 4] (instance
            mode) or [V, 4] (range mode, with `ranges`). A tensor runs on
            its device (CPU tensors on the plain twins); anything else is
            put on the default CUDA device, and raises RuntimeError where
            there is none.
        tri: [T, 3] int32 triangles. On a GPU its index range is checked
            once per tensor (a host sync) and trusted while torch sees no
            write to it; do not write it by other means than torch ops.
        resolution: (height, width).
        ranges: range mode only: [minibatch, 2] int32 (start, count) into
            `tri`. Ignored in instance mode.
        grad_db: propagate the gradients of rast_db into pos.
        viewport: (y0, full_height): render rows [y0, y0 + height) of a
            full_height-tall image, bit for bit the same rows of the full
            render.

    Returns:
        (rast, rast_db), both [minibatch, H, W, 4]: rast = (u, v, z/w,
        triangle id + 1 as float), rast_db = (du/dX, du/dY, dv/dX, dv/dY).
        Differentiable with respect to pos through rast channels 0-1 and,
        with grad_db, rast_db; in range mode the gradients of all images
        sum into the one [V, 4].
    """
    if glctx is not None:
        if not isinstance(glctx, RasterizeCudaContext):
            raise TypeError("rasterize: glctx must be a RasterizeCudaContext or None")
        if glctx.active_depth_peeler is not None:
            raise RuntimeError("Cannot call rasterize() during depth peeling "
                               "operation, use rasterize_next_layer() instead")
    if grad_db is not True and grad_db is not False:
        raise ValueError("rasterize: grad_db must be True or False")
    pos, tri, resolution, ranges = _prepare(pos, tri, resolution, ranges, "rasterize")
    if viewport is not None:
        viewport = (int(viewport[0]), int(viewport[1]))
    rast, rast_db, _ = _RasterizeFn.apply(pos, tri, resolution, grad_db, ranges, None,
                                          viewport, False)
    return rast, rast_db


class DepthPeeler:
    """Depth peeling context manager (reference API: nvdiffrast/torch/ops.py
    DepthPeeler; JAX package rasterize.py:1084-1155).

    Each ``rasterize_next_layer`` rasterizes the next depth layer: it
    culls the fragments at depths <= the previous layer's, compared on
    the rounded quotient z/w the previous layer stored, so its winner
    never reappears. Layers are differentiable to pos as ``rasterize``.
    """

    def __init__(self, glctx, pos, tri, resolution, ranges=None, grad_db=True):
        if glctx is not None and not isinstance(glctx, RasterizeCudaContext):
            raise TypeError("DepthPeeler: glctx must be a RasterizeCudaContext or None")
        if grad_db is not True and grad_db is not False:
            raise ValueError("DepthPeeler: grad_db must be True or False")
        self.raster_ctx = glctx
        self.pos, self.tri, self.resolution, self.ranges = _prepare(
            pos, tri, resolution, ranges, "DepthPeeler")
        self.grad_db = grad_db
        self.peeling_idx = None
        self._peel_depth = None

    def __enter__(self):
        if self.raster_ctx is None:
            raise RuntimeError("Cannot re-enter a terminated depth peeling operation")
        if self.raster_ctx.active_depth_peeler is not None:
            raise RuntimeError("Cannot have multiple depth peelers active simultaneously "
                               "in a rasterization context")
        self.raster_ctx.active_depth_peeler = self
        self.peeling_idx = 0
        self._peel_depth = None
        return self

    def __exit__(self, *args):
        assert self.raster_ctx.active_depth_peeler is self
        self.raster_ctx.active_depth_peeler = None
        self.raster_ctx = None
        self.pos = None
        self.tri = None
        self.resolution = None
        self.ranges = None
        self.grad_db = None
        self.peeling_idx = None
        self._peel_depth = None
        return None

    @spanned("nvdr.rasterize")
    def rasterize_next_layer(self):
        """Rasterize the next depth layer: (rast, rast_db) as ``rasterize``."""
        assert self.raster_ctx.active_depth_peeler is self
        assert self.peeling_idx >= 0
        rast, rast_db, zbuf = _RasterizeFn.apply(
            self.pos, self.tri, self.resolution, self.grad_db, self.ranges,
            self._peel_depth, None, True)
        self._peel_depth = zbuf.detach()
        self.peeling_idx += 1
        return rast, rast_db
