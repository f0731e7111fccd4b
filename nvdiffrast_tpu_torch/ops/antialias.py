"""Antialiasing (torch): the differentiable op and the pair math.

Counterpart of ``nvdiffrast_tpu/ops/antialias.py``: the shared per-pair
math (``pair_ids``, ``pair_alpha`` and their sign and rational helpers;
the backward's ``pair_pos_grad`` and ``decode_aux``), the flat pixel
grid, and ``antialias``, a ``torch.autograd.Function`` in instance and
range mode and under a viewport; its per-triangle tables and the
topology wrapper it exports are ``topology``'s. Its forward is kernel B7
(``antialias_cuda.aa_forward``); its backward kernel B8
(``antialias_cuda.aa_backward``), the reduction of the pairs' position
gradients to triangle rows (kernel B10, ``scatter.scatter_add_by_id``)
and the deterministic vertex sums, times ``pos_gradient_boost``; rast
gets no gradient. The math is the same expressions in the same order;
the plain twins and the CUDA kernels (``csrc/aa_pair.cuh``) follow it.
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import spanned
from .rasterize import as_device_tensor
from .topology import (TopologyHashWrapper, _build_tables, _same_sign,  # noqa: F401
                       antialias_construct_topology_hash, opposite_table, vertex_pos_grad)

_F32_MAX = 3.402823466e38


# ---------------------------------------------------------------------------
# Shared pointwise pair math (antialias.py:92-215).
# ---------------------------------------------------------------------------

def _rational_gt(n0, n1, d0, d1):
    return (n0 * d1 > n1 * d0) == _same_sign(d0, d1)


def _max_idx3(n0, n1, n2, d0, d1, d2):
    g10 = _rational_gt(n1, n0, d1, d0)
    g20 = _rational_gt(n2, n0, d2, d0)
    g21 = _rational_gt(n2, n1, d2, d1)
    return torch.where(g20 & g21, 2, torch.where(g10, 1, 0))


def pair_ids(idf0, idf1, z0, z1, T):
    """Triangle choice for a pixel pair.

    `idf1`/`z1` are the neighbour's values with image borders folded to
    the pixel's own (which disables the pair).

    Returns (tid, is_t1, active): clamped table id, whether the
    neighbour's triangle was selected, and the pair-active mask.
    """
    tri0 = idf0.to(torch.int32) - 1
    tri1 = idf1.to(torch.int32) - 1
    work = idf1 != idf0
    tsel = torch.where(tri0 >= 0, tri0, tri1)
    both = (tri0 >= 0) & (tri1 >= 0)
    tsel = torch.where(both, torch.where(z0 < z1, tri0, tri1), tsel)
    is_t1 = tsel == tri1
    tri_ok = (tsel >= 0) & (tsel < T)
    active = work & tri_ok
    tid = torch.where(tri_ok, tsel, 0)
    return tid, is_t1, active


def pair_alpha(t7, fx, fy, is_t1, active, d):
    """Edge crossing analysis for one pixel pair.

    Args:
      t7: 7 gathered per-pixel tensors (sx0, sx1, sx2, sy0, sy1, sy2,
        sign bitmask) from the forward table.
      fx, fy: image-centered pixel coordinates (unshifted).
      is_t1, active: from `pair_ids`.
      d: 0 = horizontal pair (right neighbour), 1 = vertical (down).

    Returns (alpha, di): blend weight (0 when inactive) and the edge
    index used.
    """
    sx0, sx1, sx2, sy0, sy1, sy2, sbits = t7
    shift = is_t1.to(torch.float32)
    fxs = fx + shift * (1 - d)
    fys = fy + shift * d

    x0 = sx0 - fxs
    x1 = sx1 - fxs
    x2 = sx2 - fxs
    y0 = sy0 - fys
    y1 = sy1 - fys
    y2 = sy2 - fys

    sb = sbits.to(torch.int32)
    s0 = (sb & 1) != 0
    s1 = (sb & 2) != 0
    s2 = (sb & 4) != 0
    any_sil = s0 | s1 | s2

    if d == 1:  # XY flip for horizontal edges
        x0, y0 = y0, x0
        x1, y1 = y1, x1
        x2, y2 = y2, x2

    dx0 = x2 - x1
    dx1 = x0 - x2
    dx2 = x1 - x0
    dy0 = y2 - y1
    dy1 = y0 - y2
    dy2 = y1 - y0

    ds = torch.where(is_t1, -1.0, 1.0)
    d0 = ds * (x1 * dy0 - y1 * dx0)
    d1 = ds * (x2 * dy1 - y2 * dx1)
    d2 = ds * (x0 * dy2 - y0 * dx2)

    c0 = _same_sign(y1, y2)
    c1 = _same_sign(y2, y0)
    c2 = _same_sign(y0, y1)
    d0 = torch.where(c0, -_F32_MAX, d0)
    d1 = torch.where(c1, -_F32_MAX, d1)
    d2 = torch.where(c2, -_F32_MAX, d2)
    dy0 = torch.where(c0, 1.0, dy0)
    dy1 = torch.where(c1, 1.0, dy1)
    dy2 = torch.where(c2, 1.0, dy2)

    di = _max_idx3(d0, d1, d2, dy0, dy1, dy2)

    dc = torch.full_like(d0, -_F32_MAX)
    use0 = (di == 0) & s0 & (dy0.abs() >= dx0.abs())
    use1 = (di == 1) & s1 & (dy1.abs() >= dx1.abs())
    use2 = (di == 2) & s2 & (dy2.abs() >= dx2.abs())
    dc = torch.where(use0, d0 / dy0, dc)
    dc = torch.where(use1, d1 / dy1, dc)
    dc = torch.where(use2, d2 / dy2, dc)

    eps = 0.0625  # 1/16 pixel inaccuracy bound
    found = (dc > -eps) & (dc < 1.0 + eps)
    active = active & any_sil & found
    dcc = torch.clamp(dc, 0.0, 1.0)
    alpha = torch.where(active, ds * (0.5 - dcc), 0.0)
    alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
    return alpha, di


def pair_pos_grad(t9, dd, ok, di, is_t1, fx, fy, d, W, H):
    """Analytic d(alpha)/d(p1, p2) of one pixel pair, routed into the 9
    per-triangle columns (antialias.py:218-298).

    Args:
      t9: 9 gathered clip-space values (x, y, w per vertex).
      dd: colour-dot weight; ok: mask of pairs with real work (the
        |alpha| >= 0.5 kill is the caller's).
      di, is_t1: edge index and side (`decode_aux`).
      fx, fy: image-centered pixel coordinates (unshifted).
      d: 0 = horizontal pair, 1 = vertical; W, H: image size.

    Returns a list of 9 tensors: column 3*vert + comp of the gradient
    row, non-finite values zeroed.
    """
    # Edge vertices: i1 = di+1, i2 = di+2 (mod 3).
    i1 = torch.where(di < 2, di + 1, 0)
    i2 = torch.where(i1 < 2, i1 + 1, 0)

    def vert(idx, comp):
        r = t9[0 + comp]
        r = torch.where(idx == 1, t9[3 + comp], r)
        return torch.where(idx == 2, t9[6 + comp], r)

    p1x, p1y, p1w = vert(i1, 0), vert(i1, 1), vert(i1, 2)
    p2x, p2y, p2w = vert(i2, 0), vert(i2, 1), vert(i2, 2)

    shift = is_t1.to(torch.float32)
    pxh = 0.5 * W
    pyh = 0.5 * H
    fxs = fx + shift * (1 - d)
    fys = fy + shift * d
    if d == 1:
        p1x, p1y = p1y, p1x
        p2x, p2y = p2y, p2x
        pxh, pyh = pyh, pxh
        fxs, fys = fys, fxs

    w1 = 1.0 / p1w
    w2 = 1.0 / p2w
    x1 = p1x * w1 * pxh - fxs
    y1 = p1y * w1 * pyh - fys
    x2 = p2x * w2 * pxh - fxs
    y2 = p2y * w2 * pyh - fys
    dxe = x2 - x1
    dye = y2 - y1
    db = x1 * dye - y1 * dxe

    ep = torch.where(dye >= 0, 1e-3, -1e-3)  # copysign(1e-3, dy)
    iy = 1.0 / (dye + ep)

    dby = db * iy
    iw1 = -w1 * iy * dd
    iw2 = w2 * iy * dd
    gp1x = iw1 * pxh * y2
    gp2x = iw2 * pxh * y1
    gp1y = iw1 * pyh * (dby - x2)
    gp2y = iw2 * pyh * (dby - x1)
    gp1w = -(p1x * gp1x + p1y * gp1y) * w1
    gp2w = -(p2x * gp2x + p2y * gp2y) * w2
    if d == 1:
        gp1x, gp1y = gp1y, gp1x
        gp2x, gp2y = gp2y, gp2x

    g1 = (gp1x, gp1y, gp1w)
    g2 = (gp2x, gp2y, gp2w)
    cols = []
    for vtx in range(3):
        m1 = (i1 == vtx) & ok
        m2 = (i2 == vtx) & ok
        for comp in range(3):
            val = (torch.where(m1, g1[comp], 0.0)
                   + torch.where(m2, g2[comp], 0.0))
            cols.append(torch.where(torch.isfinite(val), val, 0.0))
    return cols


def decode_aux(aux):
    """AA residual aux value -> (di, is_t1); aux = di + 4 * is_t1."""
    is_t1 = aux >= 3.5
    di = (aux - 4.0 * is_t1.to(torch.float32)).to(torch.int32)
    return di, is_t1


# ---------------------------------------------------------------------------
# The flat pixel grid.
# ---------------------------------------------------------------------------

def _pixel_grid(B, H, W, T, device, viewport=None, ranged=False):
    """(fx, fy, rofs, border_x, border_y) flat [N] tensors.

    fx, fy are image-centered pixel coordinates; rofs = b*T is the
    table-row offset of each pixel's image (0 in range mode, one table).
    viewport = (y0, full_height): the band holds rows [y0, y0 + H) of a
    full_height image; fy is the full image's, and the band's top and
    bottom rows fold as borders.
    """
    y0, Hf = (0, H) if viewport is None else viewport
    N = B * H * W
    pix = torch.arange(N, dtype=torch.int32, device=device)
    colp = pix % W
    rowp = (pix // W) % H
    fx = colp.to(torch.float32) + (0.5 - 0.5 * W)
    fy = (rowp + y0).to(torch.float32) + (0.5 - 0.5 * Hf)
    rofs = torch.zeros_like(pix) if ranged else (pix // (H * W)) * T
    return fx, fy, rofs, colp >= W - 1, rowp >= H - 1


# ---------------------------------------------------------------------------
# The op (antialias.py:479-728).
# ---------------------------------------------------------------------------

def channel_groups(C, width):
    """Channel ranges [a, b) of at most `width` channels covering C: how
    the kernels of at most 8 channels serve wider images and textures."""
    return [(a, min(a + width, C)) for a in range(0, C, width)]


def aa_fwd_groups(ct, idf, zw, ftable, shape, T, ranged=False, viewport=None):
    """``antialias_cuda.aa_forward`` over channel groups of 8: (out
    [C, N], residuals). The residuals are the pairs' geometry, the same
    for every group."""
    from .antialias_cuda import MAX_C, aa_forward

    outs = []
    for a, b in channel_groups(ct.shape[0], MAX_C):
        out, res = aa_forward(ct[a:b].contiguous(), idf, zw, ftable, shape, T, ranged,
                              viewport)
        outs.append(out)
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), res


@spanned("nvdr.aa.bwd")
def aa_bwd_flat(dy, ct, idf, vtbl, residuals, shape, tri, pos_shape, boost,
                need_pos=True, viewport=None):
    """(g_color [C, N], g_pos (pos_shape: [B, V, 4], or [V, 4] in range
    mode) or None) from the cotangent
    dy [C, N] of the antialiased image: kernel B8, then the pairs' rows
    reduced by kernel B10 and summed into vertices, times boost.

    Past 8 channels B8 runs per group of 8; a pair's position gradient is
    linear in its colour difference, so each group's columns add to those
    of the groups before it (the pair rows are the same for every group).
    The sum over channels then rounds per group: within a few float32
    ulps of the columns of one pass, not bit for bit.
    """
    from .antialias_cuda import MAX_C, aa_backward
    from .scatter import scatter_add_by_id

    T = tri.shape[0]
    ranged = len(pos_shape) == 2
    g_color, gval2 = [], None
    for a, b in channel_groups(ct.shape[0], MAX_C):
        gc, rid2, gv = aa_backward(dy[a:b].contiguous(), ct[a:b].contiguous(), idf, vtbl,
                                   residuals, shape, T, ranged, viewport)
        g_color.append(gc)
        gval2 = gv if gval2 is None else gval2 + gv
    g_color = g_color[0] if len(g_color) == 1 else torch.cat(g_color)
    if not need_pos:
        return g_color, None
    gt = scatter_add_by_id(rid2.reshape(-1), gval2, vtbl.shape[1] - 1)
    g_pos = vertex_pos_grad(gt, tri, pos_shape)
    return g_color, (g_pos * boost if boost != 1.0 else g_pos)


class _AntialiasFn(torch.autograd.Function):
    """antialias with its hand-written backward."""

    @staticmethod
    def forward(ctx, color, rast, pos, tri, op_table, boost, viewport):
        B, H, W, C = color.shape
        N = B * H * W
        T = tri.shape[0]
        Hf = H if viewport is None else viewport[1]
        ct = color.reshape(N, C).T.contiguous()
        idf = rast[..., 3].reshape(N).contiguous()
        zw = rast[..., 2].reshape(N).contiguous()
        ftable, vtbl, _, _ = _build_tables(pos, tri, op_table, Hf, W)
        out, res = aa_fwd_groups(ct, idf, zw, ftable, (B, H, W), T, pos.ndim == 2, viewport)
        ctx.save_for_backward(ct, idf, vtbl, tri, *res)
        ctx.meta = (tuple(color.shape), tuple(pos.shape), boost, viewport)
        return out.T.reshape(B, H, W, C)

    @staticmethod
    @once_differentiable
    @spanned("nvdr.antialias.bwd")
    def backward(ctx, dy):
        ct, idf, vtbl, tri, *res = ctx.saved_tensors
        (B, H, W, C), pos_shape, boost, viewport = ctx.meta
        N = B * H * W
        g_color, g_pos = aa_bwd_flat(dy.reshape(N, C).T.contiguous(), ct, idf, vtbl, res,
                                     (B, H, W), tri, pos_shape, boost,
                                     need_pos=ctx.needs_input_grad[2], viewport=viewport)
        g_color = g_color.T.reshape(B, H, W, C) if ctx.needs_input_grad[0] else None
        return g_color, None, g_pos, None, None, None, None


@spanned("nvdr.antialias")
def antialias(color, rast, pos, tri, topology_hash=None, pos_gradient_boost=1.0,
              viewport=None):
    """Antialias silhouette edges.

    Args:
        color: [minibatch, H, W, C] float32 image (C > 8 runs in groups
            of 8 channels through the same kernels). A tensor runs on
            its device (CPU tensors on the plain twins); anything else is
            put on the default CUDA device, and raises RuntimeError where
            there is none.
        rast: [minibatch, H, W, 4] output of ``rasterize``.
        pos: [minibatch, V, 4] (instance mode) or [V, 4] (range mode)
            clip-space positions used to rasterize.
        tri: [T, 3] int32 triangles used to rasterize.
        topology_hash: optional ``TopologyHashWrapper`` for `tri`.
        pos_gradient_boost: multiplier of the gradients to `pos`.
        viewport: (y0, full_height): `color` and `rast` are rows
            [y0, y0 + H) of a full_height-tall image. Pixel pairs across
            the band's top and bottom edges are not evaluated (the band's
            edge rows fold as borders).

    Returns:
        The antialiased image, shaped like `color`; differentiable with
        respect to `color` and `pos` (rast gets no gradient).
    """
    color = as_device_tensor(color, "antialias")
    dev = color.device
    rast = torch.as_tensor(rast, dtype=torch.float32, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    if color.ndim != 4 or rast.ndim != 4 or rast.shape[3] != 4:
        raise ValueError("antialias: color must be [minibatch, H, W, C] and rast "
                         f"[minibatch, H, W, 4]; got {tuple(color.shape)}, "
                         f"{tuple(rast.shape)}")
    if color.shape[:3] != rast.shape[:3]:
        raise ValueError(f"antialias: color {tuple(color.shape)} and rast "
                         f"{tuple(rast.shape)} minibatch/resolution mismatch")
    if pos.ndim not in (2, 3) or pos.shape[-1] != 4:
        raise ValueError(f"antialias: pos must be [V, 4] or [minibatch, V, 4]; got "
                         f"{tuple(pos.shape)}")
    if pos.ndim == 3 and pos.shape[0] != color.shape[0]:
        raise ValueError(f"antialias: instanced pos minibatch {pos.shape[0]} != "
                         f"color minibatch {color.shape[0]}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"antialias: tri must be [num_triangles, 3]; got "
                         f"{tuple(tri.shape)}")
    if color.shape[-1] < 1:
        raise ValueError("antialias: color has no channels")
    op_table = opposite_table(topology_hash, tri, "antialias")
    if viewport is not None:
        viewport = (int(viewport[0]), int(viewport[1]))
    return _AntialiasFn.apply(color, rast, pos, tri, op_table, float(pos_gradient_boost),
                              viewport)
