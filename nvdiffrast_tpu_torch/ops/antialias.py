"""Antialiasing (torch): the differentiable op and the pair math.

Counterpart of ``nvdiffrast_tpu/ops/antialias.py``: the shared per-pair
math (``pair_ids``, ``pair_alpha`` and their sign and rational helpers;
the backward's ``pair_pos_grad`` and ``decode_aux``), the per-triangle
tables, the flat pixel grid, the topology wrapper, and ``antialias``, a
``torch.autograd.Function`` in instance mode. Its forward is kernel B7
(``antialias_cuda.aa_forward``); its backward kernel B8
(``antialias_cuda.aa_backward``), the reduction of the pairs' position
gradients to triangle rows (kernel B10, ``scatter.scatter_add_by_id``)
and the deterministic vertex sums, times ``pos_gradient_boost``; rast
gets no gradient. The math is the same expressions in the same order;
the plain twins and the CUDA kernels (``csrc/aa_pair.cuh``) follow it.
"""

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .topology import build_opposite_table

_F32_MAX = 3.402823466e38


class TopologyHashWrapper:
    """Opaque topology table: op[T, 3] int32 opposite vertices.

    Accepts a tensor, or the JAX package's ``op_table`` as a numpy array
    (the same table; see ``build_opposite_table``).
    """

    def __init__(self, op_table):
        if isinstance(op_table, np.ndarray):
            op_table = torch.from_numpy(np.array(op_table, dtype=np.int32))
        self.op_table = torch.as_tensor(op_table, dtype=torch.int32)


def antialias_construct_topology_hash(tri):
    """Topology table for a triangle tensor [T, 3] int32."""
    return TopologyHashWrapper(build_opposite_table(tri))


# ---------------------------------------------------------------------------
# Shared pointwise pair math (antialias.py:92-215).
# ---------------------------------------------------------------------------

def _same_sign(a, b):
    # Sign-BIT comparison on the int32 bitcast: +0.0 and -0.0 differ.
    return (a.view(torch.int32) ^ b.view(torch.int32)) >= 0


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
# Tables (antialias.py:312-401).
# ---------------------------------------------------------------------------

def _build_tables(pos, tri, op_table, H, W):
    """Per-triangle screen tables (channel-major) + a dummy zero column.

    Instance mode: pos [B, V, 4], tri/op_table [T, 3].
    Returns (ftable [7, B*T+1], btable [9, B*T+1], R = B*T, T). ftable
    holds each triangle's screen vertices (SX*3, SY*3) and its wing-sign
    bitmask: the silhouette test is pixel-independent, so it is
    evaluated once per triangle. btable holds the raw clip (x, y, w).
    """
    T = tri.shape[0]
    xh = 0.5 * W
    yh = 0.5 * H
    tri_l = tri.long()
    ov = torch.where(op_table >= 0, op_table, tri).long()

    tv = pos[:, tri_l]  # [B, T, 3, 4]
    o = pos[:, ov]

    def screen(q):
        iw = 1.0 / q[..., 3]
        return q[..., 0] * iw * xh, q[..., 1] * iw * yh

    sx, sy = screen(tv)  # [B, T, 3]
    ox, oy = screen(o)

    bb = ((sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0])
          - (sx[..., 2] - sx[..., 0]) * (sy[..., 1] - sy[..., 0]))
    a0 = ((sx[..., 1] - ox[..., 0]) * (sy[..., 2] - oy[..., 0])
          - (sx[..., 2] - ox[..., 0]) * (sy[..., 1] - oy[..., 0]))
    a1 = ((sx[..., 2] - ox[..., 1]) * (sy[..., 0] - oy[..., 1])
          - (sx[..., 0] - ox[..., 1]) * (sy[..., 2] - oy[..., 1]))
    a2 = ((sx[..., 0] - ox[..., 2]) * (sy[..., 1] - oy[..., 2])
          - (sx[..., 1] - ox[..., 2]) * (sy[..., 0] - oy[..., 2]))
    sbits = (_same_sign(a0, bb).to(torch.float32)
             + 2.0 * _same_sign(a1, bb).to(torch.float32)
             + 4.0 * _same_sign(a2, bb).to(torch.float32))

    ftable = torch.cat([sx, sy, sbits[..., None]], dim=-1).reshape(-1, 7).T
    btable = tv[..., [0, 1, 3]].reshape(-1, 9).T
    R = ftable.shape[1]
    zcol7 = torch.zeros((7, 1), dtype=torch.float32, device=pos.device)
    zcol9 = torch.zeros((9, 1), dtype=torch.float32, device=pos.device)
    ftable = torch.cat([ftable, zcol7], dim=1).contiguous()
    btable = torch.cat([btable, zcol9], dim=1).contiguous()
    return ftable, btable, R, T


def _pixel_grid(B, H, W, T, device):
    """(fx, fy, rofs, border_x, border_y) flat [N] tensors, instance mode.

    fx, fy are image-centered pixel coordinates; rofs = b*T is the
    table-row offset of each pixel's image.
    """
    N = B * H * W
    pix = torch.arange(N, dtype=torch.int32, device=device)
    colp = pix % W
    rowp = (pix // W) % H
    fx = colp.to(torch.float32) + (0.5 - 0.5 * W)
    fy = rowp.to(torch.float32) + (0.5 - 0.5 * H)
    rofs = (pix // (H * W)) * T
    return fx, fy, rofs, colp >= W - 1, rowp >= H - 1


# ---------------------------------------------------------------------------
# The op (antialias.py:479-728).
# ---------------------------------------------------------------------------

def aa_bwd_flat(dy, ct, idf, vtbl, residuals, shape, tri, pos_shape, boost,
                need_pos=True):
    """(g_color [C, N], g_pos [B, V, 4] or None) from the cotangent
    dy [C, N] of the antialiased image: kernel B8, then the pairs' rows
    reduced by kernel B10 and summed into vertices, times boost."""
    from .antialias_cuda import aa_backward
    from .rasterize import xyw_rows_to_vertices
    from .scatter import scatter_add_by_id

    T = tri.shape[0]
    g_color, rid2, gval2 = aa_backward(dy, ct, idf, vtbl, residuals, shape, T)
    if not need_pos:
        return g_color, None
    gt = scatter_add_by_id(rid2.reshape(-1), gval2, vtbl.shape[1] - 1)
    g_pos = xyw_rows_to_vertices(gt, tri, pos_shape)
    return g_color, (g_pos * boost if boost != 1.0 else g_pos)


class _AntialiasFn(torch.autograd.Function):
    """antialias with its hand-written backward."""

    @staticmethod
    def forward(ctx, color, rast, pos, tri, op_table, boost):
        from .antialias_cuda import aa_forward

        B, H, W, C = color.shape
        N = B * H * W
        T = tri.shape[0]
        ct = color.reshape(N, C).T.contiguous()
        idf = rast[..., 3].reshape(N).contiguous()
        zw = rast[..., 2].reshape(N).contiguous()
        ftable, vtbl, _, _ = _build_tables(pos, tri, op_table, H, W)
        out, res = aa_forward(ct, idf, zw, ftable, (B, H, W), T)
        ctx.save_for_backward(ct, idf, vtbl, tri, *res)
        ctx.meta = (tuple(color.shape), tuple(pos.shape), boost)
        return out.T.reshape(B, H, W, C)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        ct, idf, vtbl, tri, *res = ctx.saved_tensors
        (B, H, W, C), pos_shape, boost = ctx.meta
        N = B * H * W
        g_color, g_pos = aa_bwd_flat(dy.reshape(N, C).T.contiguous(), ct, idf, vtbl, res,
                                     (B, H, W), tri, pos_shape, boost,
                                     need_pos=ctx.needs_input_grad[2])
        g_color = g_color.T.reshape(B, H, W, C) if ctx.needs_input_grad[0] else None
        return g_color, None, g_pos, None, None, None


def antialias(color, rast, pos, tri, topology_hash=None, pos_gradient_boost=1.0,
              viewport=None):
    """Antialias silhouette edges (instance mode).

    Args:
        color: [minibatch, H, W, C] float32 image, C <= 8. A tensor runs on
            its device (CPU tensors on the plain twins); anything else is
            put on the default CUDA device, and raises RuntimeError where
            there is none.
        rast: [minibatch, H, W, 4] output of ``rasterize``.
        pos: [minibatch, V, 4] clip-space positions used to rasterize.
        tri: [T, 3] int32 triangles used to rasterize.
        topology_hash: optional ``TopologyHashWrapper`` for `tri`.
        pos_gradient_boost: multiplier of the gradients to `pos`.
        viewport: row bands are not ported yet (ROADMAP A.9): must be None.

    Returns:
        The antialiased image, shaped like `color`; differentiable with
        respect to `color` and `pos` (rast gets no gradient).
    """
    from .antialias_cuda import MAX_C
    from .rasterize import as_device_tensor

    if viewport is not None:
        raise NotImplementedError("antialias: viewport bands are not ported yet "
                                  "(ROADMAP A.9)")
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
    if pos.ndim == 2:
        raise NotImplementedError(
            "antialias: range mode (2-D pos) is not ported yet (ROADMAP A.9); pass "
            "[minibatch, V, 4] positions")
    if pos.ndim != 3 or pos.shape[-1] != 4:
        raise ValueError(f"antialias: pos must be [minibatch, V, 4]; got "
                         f"{tuple(pos.shape)}")
    if pos.shape[0] != color.shape[0]:
        raise ValueError(f"antialias: instanced pos minibatch {pos.shape[0]} != "
                         f"color minibatch {color.shape[0]}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"antialias: tri must be [num_triangles, 3]; got "
                         f"{tuple(tri.shape)}")
    if not 1 <= color.shape[-1] <= MAX_C:
        raise NotImplementedError(
            f"antialias: {color.shape[-1]} channels; the kernels serve 1 to {MAX_C}")
    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("antialias: topology_hash must be a TopologyHashWrapper")
        op_table = topology_hash.op_table.to(dev)
    else:
        op_table = build_opposite_table(tri)
    return _AntialiasFn.apply(color, rast, pos, tri, op_table, float(pos_gradient_boost))
