"""Backward of the textured pipeline around the texture: glue and one
CUDA kernel (torch).

Counterparts of ``nvdiffrast_tpu/ops/pipeline_tex_pallas.py``:

* ``aa_bwd_slim`` (tensor glue, as the JAX package leaves it to XLA):
  the antialias backward without the position-gradient expansion. It
  emits the colour cotangent into the texture stage and the two pair
  streams (dd2, rid2) whose position gradients ``grad_scatter`` replays.
  The arithmetic is ``aa_bwd_slim_cols``' in its order; the residuals are
  row-major already (``antialias_cuda.aa_forward``).
* ``interp_raster_bwd_tex`` (kernel ``csrc/interp_raster_bwd_tex.cu``):
  per pixel, the interpolate(uv, diff_attrs) backward and the db-aware
  rasterize backward in one pass, emitting the 15 slim rows
  ``grad_scatter(da4=...)`` reduces. ``interp_raster_bwd_tex_plain`` is
  its twin, bit for bit.
"""

import ctypes

import torch

from .. import _build
from . import coord
from .antialias import _pixel_grid, decode_aux
from .pipeline_cuda import _folded, _roll_next
from .rasterize import pixel_centres, raster_grad_math

KERNEL = _build.Kernel(
    "nvdr_interp_raster_bwd_tex",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 6)


def _roll_prev(x, stride):
    """x at pixel p + stride along the last axis; the tail repeats (its
    pairs are inactive)."""
    return torch.cat([x[..., stride:], x[..., -stride:]], dim=-1)


def aa_bwd_slim(dy, c0, idf, residuals, shape, T):
    """Antialias backward, slim emission.

    Args:
      dy: [C, N] loss cotangent of the image; c0: [C, N] pre-AA colour
        (the texture's output); idf: [N] rasterizer id channel;
      residuals: (al0, ax0, al1, ax1) flat [N] AA forward residuals;
      shape: (B, H, W); T: triangles per image.

    Returns (gc [C, N] colour cotangent into the texture stage,
    dd2 [2, N] masked pair colour-dot weights, rid2 [2, N] int32 pair
    table rows).
    """
    B, H, W = shape
    al0, ax0, al1, ax1 = residuals
    _, _, rofs, bx, by = _pixel_grid(B, H, W, T, dy.device)
    gc = dy
    dd2 = []
    rid2 = []
    for d, (idn, al, ax) in enumerate(zip(_folded(idf, bx, by, W), (al0, al1),
                                          (ax0, ax1))):
        stride = 1 if d == 0 else W
        _, is_t1 = decode_aux(ax)
        tsel = torch.where(is_t1, idn, idf).to(torch.int32) - 1
        ok = (al != 0.0) & (tsel >= 0) & (tsel < T)
        rid2.append(torch.where(ok, tsel, 0) + rofs)
        pdy = torch.where(al > 0, dy, _roll_prev(dy, stride))
        v = al * pdy
        gc = gc - v + _roll_next(v, stride)
        dd = torch.zeros_like(al)
        for c in range(dy.shape[0]):
            dd = dd + pdy[c] * (_roll_prev(c0[c], stride) - c0[c])
        dd = torch.where(al != 0.0, dd, 0.0)
        keep = ok & (dd != 0.0) & (al.abs() < 0.5)
        dd2.append(torch.where(keep, dd, 0.0))
    return gc, torch.stack(dd2), torch.stack(rid2).to(torch.int32)


def _check(atbl, vtbl, idf, gu, gv, gda4, db4, resolution, T):
    H, W = resolution
    N = idf.shape[0]
    cols = atbl.shape[1] if atbl.ndim == 2 else -1
    if atbl.shape != (6, cols) or vtbl.shape != (9, cols):
        raise ValueError("interp_raster_bwd_tex: atbl must be [6, R+1] and vtbl "
                         f"[9, R+1]; got {tuple(atbl.shape)}, {tuple(vtbl.shape)}")
    if N % (H * W) or (N // (H * W)) * T + 1 != cols:
        raise ValueError(f"interp_raster_bwd_tex: {N} pixels and {cols} table "
                         f"columns do not fit resolution {resolution} and T={T}")
    if gu.shape != (N,) or gv.shape != (N,) or gda4.shape != (4, N) \
            or db4.shape != (4, N):
        raise ValueError("interp_raster_bwd_tex: idf, gu, gv must be [N], gda4 "
                         "and db4 [4, N]")
    if any(t.dtype != torch.float32 or t.device != atbl.device
           for t in (atbl, vtbl, idf, gu, gv, gda4, db4)):
        raise ValueError("interp_raster_bwd_tex: expects float32 tensors on one "
                         "device")
    return N


def interp_raster_bwd_tex(atbl, vtbl, idf, gu, gv, gda4, db4, resolution, T):
    """Fused interpolate(uv, da) + rasterize(db) backward.

    Args:
      atbl: [6, B*T+1] uv table (v0u, v0v, v1u, v1v, v2u, v2v; zero
        column last; ``pipeline._attr_table``); vtbl: [9, B*T+1]
        clip-space vertex table (``antialias._build_tables``' btable).
      idf: [N] rasterizer id channel, N = B*H*W.
      gu, gv: [N] uv cotangents (``texture_bwd``); gda4: [4, N] uv_da
        cotangents (``texture.mip_level_vjp``), (du/dX, du/dY, dv/dX,
        dv/dY); db4: [4, N] the rasterizer's bary derivatives.
      resolution: (H, W); T: triangles per image.

    Returns out [15, N]: rows 0-1 the masked (gu, gv), rows 2-10 the 9
    clip-space vertex columns, rows 11-14 the da terms (c0_u, c0_v, c1_u,
    c1_v); all zero where the pixel has no triangle.
    """
    if atbl.device.type == "cpu":
        return interp_raster_bwd_tex_plain(atbl, vtbl, idf, gu, gv, gda4, db4,
                                           resolution, T)
    if atbl.device.type != "cuda":
        raise ValueError(f"interp_raster_bwd_tex: unsupported device {atbl.device}")
    atbl, vtbl, idf, gu, gv, gda4, db4 = (
        t.contiguous() for t in (atbl, vtbl, idf, gu, gv, gda4, db4))
    N = _check(atbl, vtbl, idf, gu, gv, gda4, db4, resolution, T)
    H, W = resolution
    xs, xo, ys, yo = coord.pixel_scale_offset(H, W)
    out = torch.empty((15, N), dtype=torch.float32, device=atbl.device)
    KERNEL.launch(atbl.device, _build.ptr(atbl), _build.ptr(vtbl), atbl.shape[1],
                  *(_build.ptr(t) for t in (idf, gu, gv, gda4, db4, out)),
                  N, T, H, W, xs, xo, ys, yo, 2.0 / W, 2.0 / H)
    return out


def interp_raster_bwd_tex_plain(atbl, vtbl, idf, gu, gv, gda4, db4, resolution, T):
    """Plain PyTorch twin of the interp_raster_bwd_tex kernel (the
    reference's expressions in its order)."""
    N = _check(atbl, vtbl, idf, gu, gv, gda4, db4, resolution, T)
    H, W = resolution
    R = atbl.shape[1] - 1
    pix = torch.arange(N, dtype=torch.int32, device=idf.device)
    tid0 = idf.to(torch.int32) - 1
    valid = (tid0 >= 0) & (tid0 < T)
    rid = torch.where(valid, tid0 + pix // (H * W) * T, R).long()
    a6 = atbl[:, rid]
    fxv, fyv = pixel_centres(N, resolution, idf.device)
    zero = torch.zeros_like(idf)

    # Interpolate backward (uv and its pixel derivatives).
    gyu = torch.where(valid, gu, 0.0)
    gyv = torch.where(valid, gv, 0.0)
    dsdu0 = a6[0] - a6[4]
    dsdu1 = a6[1] - a6[5]
    dsdv0 = a6[2] - a6[4]
    dsdv1 = a6[3] - a6[5]
    gb0 = gyu * dsdu0 + gyv * dsdu1
    gb1 = gyu * dsdv0 + gyv * dsdv1
    d0, d1, d2, d3 = (torch.where(valid, db4[k], 0.0) for k in range(4))
    gdb = [zero, zero, zero, zero]
    cda = []
    for j, (dsdu, dsdv) in enumerate(((dsdu0, dsdv0), (dsdu1, dsdv1))):
        gdax = gda4[2 * j]
        gday = gda4[2 * j + 1]
        cda.append(torch.where(valid, d0 * gdax + d1 * gday, 0.0))
        cda.append(torch.where(valid, d2 * gdax + d3 * gday, 0.0))
        gdb[0] = gdb[0] + gdax * dsdu
        gdb[1] = gdb[1] + gday * dsdu
        gdb[2] = gdb[2] + gdax * dsdv
        gdb[3] = gdb[3] + gday * dsdv
    dd0, dd1, dd2_, dd3 = (torch.where(valid, c, 0.0) for c in gdb)

    # Rasterize backward with bary derivatives.
    g9 = torch.stack(raster_grad_math(list(vtbl[:, rid]), fxv, fyv, gb0, gb1,
                                      (dd0, dd1, dd2_, dd3), W, H))
    g9 = torch.where(valid & torch.isfinite(g9), g9, 0.0)
    return torch.cat([gyu[None], gyv[None], g9,
                      torch.stack([cda[0], cda[2], cda[1], cda[3]])])
