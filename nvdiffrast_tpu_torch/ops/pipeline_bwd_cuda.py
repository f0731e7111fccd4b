"""Backward of the fused render pipeline: two CUDA kernels (torch).

Counterparts of ``pipeline_bwd`` and ``pipeline_grad_scatter`` in
``nvdiffrast_tpu/ops/pipeline_pallas.py``:

* ``pipeline_bwd`` (kernel ``csrc/pipeline_bwd.cu``): per pixel, the
  antialias, interpolate and rasterize backward in one pass. Emits the
  slim stream gs [A+9, N] (post-AA colour gradient, 9 raster vertex
  columns), the per-axis AA colour-dot weights dd2 [2, N] and the pair
  rows rid2 [2, N]. ``pipeline_bwd_plain`` is its twin, bit for bit.
* ``grad_scatter`` (kernels ``csrc/grad_scatter.cu``, then the shared
  ``csrc/segment_sum.cu`` sums of ``segments``): reduces that stream to
  per-triangle rows, expanding the bary outer product and replaying the
  AA position gradients (``antialias.pair_pos_grad``) on the way (and,
  for the textured chain, the uv_da terms ``da4``). Each 16x16 screen
  tile sums its own entries by row in shared memory into float64
  partials (``scatter_partials``); only those are sorted by row and
  added, in a fixed order, with one host sync (the partials' count).
  ``tile_partials_plain`` is the plain twin of the partials, bit for
  bit; ``grad_scatter_plain`` expands with tensor ops and sums with
  ``index_add_`` in float64; the two agree to float64 rounding.

Each wrapper runs the twin for CPU tensors and launches its kernel for
CUDA tensors (built at first use), or raises.
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import spanned
from . import segments
from .antialias import _pixel_grid, decode_aux, pair_pos_grad
from .pipeline_cuda import MAX_A, _folded, _roll_next

BWD_KERNEL = _build.Kernel(
    "nvdr_pipeline_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4)

SCATTER_KERNEL = _build.Kernel(
    "nvdr_grad_scatter",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_float] * 4)
# The second pass of the same entry: the scratch moved into place, and
# the tiles of more than SCATTER_CAP rows computed again.
SCATTER_COMPACT_KERNEL = _build.Kernel("nvdr_grad_scatter_compact", SCATTER_KERNEL.argtypes,
                                       symbol="nvdr_grad_scatter")
SCATTER_SEGMENT_KERNEL = _build.Kernel("nvdr_grad_scatter_segments", segments.SEGMENT_ARGS,
                                       symbol="nvdr_segment_starts")
SCATTER_SUM_KERNEL = _build.Kernel("nvdr_grad_scatter_sum", segments.SUM_ARGS,
                                   symbol="nvdr_segment_sums")
SCATTER_TILE = 16  # screen tile of the pre-reduction (csrc/grad_scatter.cu TILE)
SCATTER_CAP = 16   # partials a tile keeps in the first pass's scratch (csrc/grad_scatter.cu CAP)


def _device_of(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _check_float32(what, dev, *ts):
    if any(t.dtype != torch.float32 or t.device != dev for t in ts):
        raise ValueError(f"{what}: expects float32 tensors on one device")


# ---------------------------------------------------------------------------
# B3: per-pixel backward.
# ---------------------------------------------------------------------------

def _check_bwd(atbl, vtbl, flats, c0, dy, resolution, T):
    H, W = resolution
    K, cols = atbl.shape
    A = K // 3
    N = flats[0].shape[0]
    if K % 3 or not 1 <= A <= MAX_A:
        raise ValueError(f"pipeline_bwd: atbl must be [3A, R+1] with 1 <= A <= "
                         f"{MAX_A}; got {tuple(atbl.shape)}")
    if vtbl.shape != (9, cols):
        raise ValueError(f"pipeline_bwd: vtbl must be [9, {cols}]; got "
                         f"{tuple(vtbl.shape)}")
    if N % (H * W) or (N // (H * W)) * T + 1 != cols:
        raise ValueError(f"pipeline_bwd: {N} pixels and {cols} table columns "
                         f"do not fit resolution {resolution} and T={T}")
    if any(t.shape != (N,) for t in flats):
        raise ValueError("pipeline_bwd: idf and the residuals must all be "
                         "flat [N]")
    if c0.shape != (A, N) or dy.shape != (A, N):
        raise ValueError(f"pipeline_bwd: c0 and dy must be [{A}, {N}]")
    _check_float32("pipeline_bwd", atbl.device, atbl, vtbl, *flats, c0, dy)
    return A, N


@spanned("nvdr.pipeline_bwd")
def pipeline_bwd(atbl, vtbl, idf, c0, dy, residuals, resolution, T):
    """Per-pixel antialias + interpolate + rasterize backward.

    Args:
      atbl: [3A, B*T+1] attribute table; vtbl: [9, B*T+1] clip-space
        vertex table (topology._build_tables' btable).
      idf: flat [N] rasterizer id buffer, N = B*H*W (the backward
        recomputes the barycentrics from the clip-space vertices).
      c0: [A, N] pre-AA colour; dy: [A, N] loss gradient of the image.
      residuals: (al0, ax0, al1, ax1) flat [N] AA forward residuals.
      resolution: (H, W); T: triangles per image.

    Returns (gs [A+9, N], dd2 [2, N] float32, rid2 [2, N] int32).
    """
    if _device_of(atbl, "pipeline_bwd") == "cpu":
        return pipeline_bwd_plain(atbl, vtbl, idf, c0, dy, residuals,
                                  resolution, T)
    H, W = resolution
    flats = [t.contiguous() for t in (idf, *residuals)]
    c0 = c0.contiguous()
    dy = dy.contiguous()
    A, N = _check_bwd(atbl, vtbl, flats, c0, dy, resolution, T)
    atbl = atbl.contiguous()
    vtbl = vtbl.contiguous()
    dev = atbl.device
    gs = torch.empty((A + 9, N), dtype=torch.float32, device=dev)
    dd2 = torch.empty((2, N), dtype=torch.float32, device=dev)
    rid2 = torch.empty((2, N), dtype=torch.int32, device=dev)
    BWD_KERNEL.launch(dev, _build.ptr(atbl), _build.ptr(vtbl), atbl.shape[1],
                      *(_build.ptr(t) for t in flats), _build.ptr(c0),
                      _build.ptr(dy), _build.ptr(gs), _build.ptr(dd2),
                      _build.ptr(rid2), N, A, T, H, W, 0.5 - 0.5 * W,
                      0.5 - 0.5 * H, 2.0 / W, 2.0 / H)
    return gs, dd2, rid2


def pipeline_bwd_plain(atbl, vtbl, idf, c0, dy, residuals, resolution, T):
    """Plain PyTorch twin of the pipeline_bwd kernel (same arithmetic)."""
    H, W = resolution
    A, N = _check_bwd(atbl, vtbl, (idf, *residuals), c0, dy, resolution, T)
    B = N // (H * W)
    fx, fy, rofs, bx, by = _pixel_grid(B, H, W, T, atbl.device)
    al0, ax0, al1, ax1 = residuals

    # AA backward, both axes; neighbours at p+1 / p+W, borders folded.
    gc = dy
    dd2 = []
    rid2 = []
    for d, (idn, c1, dyn, al, ax) in enumerate(zip(
            _folded(idf, bx, by, W), _folded(c0, bx, by, W),
            _folded(dy, bx, by, W), (al0, al1), (ax0, ax1))):
        pdy = torch.where(al > 0, dy, dyn)
        gc = gc - al * pdy
        _, is_t1 = decode_aux(ax)
        active = al != 0.0
        tsel = torch.where(is_t1, idn, idf).to(torch.int32) - 1
        ok = active & (tsel >= 0) & (tsel < T)
        rid2.append(torch.where(ok, tsel, 0) + rofs)
        dd = torch.zeros_like(al)
        for c in range(A):
            dd = dd + pdy[c] * (c1[c] - c0[c])
        dd = torch.where(active, dd, 0.0)
        keep = ok & (dd != 0.0) & (al.abs() < 0.5)
        dd2.append(torch.where(keep, dd, 0.0))

    # Blends the left (p-1) and upper (p-W) neighbours' pairs put here:
    # ((dy - v0) - v1) + v0[p-1] + v1[p-W].
    a0m = _roll_next(al0, 1)
    a1m = _roll_next(al1, W)
    vm0 = a0m * torch.where(a0m > 0, _roll_next(dy, 1), dy)
    vm1 = a1m * torch.where(a1m > 0, _roll_next(dy, W), dy)
    gc = gc + vm0 + vm1

    # Interpolate backward: bary gradients from the attribute rows.
    tid0 = idf.to(torch.int32) - 1
    valid = (tid0 >= 0) & (tid0 < T)
    rid = (torch.where(valid, tid0, 0) + rofs).long()
    g = torch.where(valid, atbl[:, rid], 0.0)
    gb0 = torch.zeros_like(idf)
    gb1 = torch.zeros_like(idf)
    for a in range(A):
        gb0 = gb0 + gc[a] * (g[a] - g[2 * A + a])
        gb1 = gb1 + gc[a] * (g[A + a] - g[2 * A + a])

    # Rasterize backward (no db): clip-space vertex gradients.
    x0, y0, w0, x1, y1, w1, x2, y2, w2 = torch.where(valid, vtbl[:, rid], 0.0)
    fxc = fx * (2.0 / W)  # pixel centre in clip space
    fyc = fy * (2.0 / H)
    p0x = x0 - fxc * w0
    p0y = y0 - fyc * w0
    p1x = x1 - fxc * w1
    p1y = y1 - fyc * w1
    p2x = x2 - fxc * w2
    p2y = y2 - fyc * w2
    a0 = p1x * p2y - p1y * p2x
    a1 = p2x * p0y - p2y * p0x
    a2 = p0x * p1y - p0y * p1x
    at = a0 + a1 + a2
    ep = torch.where(at >= 0, 1e-6, -1e-6)
    iw = 1.0 / (at + ep)
    rb0 = a0 * iw
    rb1 = a1 * iw
    gB0 = gb0 * iw
    gB1 = gb1 * iw
    gbb = gB0 * rb0 + gB1 * rb1
    gp0x = gbb * (p2y - p1y) - gB1 * p2y
    gp1x = gbb * (p0y - p2y) + gB0 * p2y
    gp2x = gbb * (p1y - p0y) - gB0 * p1y + gB1 * p0y
    gp0y = gbb * (p1x - p2x) + gB1 * p2x
    gp1y = gbb * (p2x - p0x) - gB0 * p2x
    gp2y = gbb * (p0x - p1x) + gB0 * p1x - gB1 * p0x
    g9 = torch.stack([gp0x, gp0y, -fxc * gp0x - fyc * gp0y,
                      gp1x, gp1y, -fxc * gp1x - fyc * gp1y,
                      gp2x, gp2y, -fxc * gp2x - fyc * gp2y])
    gs = torch.cat([torch.where(valid, gc, 0.0),
                    torch.where(valid & torch.isfinite(g9), g9, 0.0)])
    return gs, torch.stack(dd2), torch.stack(rid2).to(torch.int32)


# ---------------------------------------------------------------------------
# B4: per-triangle reduction.
# ---------------------------------------------------------------------------

def _check_scatter(rid0, gs, dd2, rid2, flats, vtbl, resolution, da4=None):
    H, W = resolution
    N = rid0.shape[0]
    A = gs.shape[0] - 9
    if da4 is not None:
        if A != 2 or da4.shape != (4, N):
            raise ValueError(f"grad_scatter: da4 must be [4, {N}] with A = 2 "
                             f"(uv); got A = {A}, da4 {tuple(da4.shape)}")
        _check_float32("grad_scatter", gs.device, da4)
    if not 1 <= A <= MAX_A or gs.shape != (A + 9, N):
        raise ValueError(f"grad_scatter: gs must be [A+9, {N}] with 1 <= A <= "
                         f"{MAX_A}; got {tuple(gs.shape)}")
    if dd2.shape != (2, N) or rid2.shape != (2, N):
        raise ValueError(f"grad_scatter: dd2 and rid2 must be [2, {N}]")
    if any(t.shape != (N,) for t in flats) or N % (H * W):
        raise ValueError("grad_scatter: b0, b1, ax0, ax1 must be flat [N] "
                         f"with N a multiple of {H}*{W}")
    if vtbl.ndim != 2 or vtbl.shape[0] != 9 or vtbl.shape[1] < 1:
        raise ValueError(f"grad_scatter: vtbl must be [9, R+1]; got "
                         f"{tuple(vtbl.shape)}")
    if rid0.dtype != torch.int32 or rid2.dtype != torch.int32:
        raise ValueError("grad_scatter: rid0 and rid2 must be int32")
    _check_float32("grad_scatter", gs.device, gs, dd2, *flats, vtbl)
    if rid0.device != gs.device or rid2.device != gs.device:
        raise ValueError("grad_scatter: expects all tensors on one device")
    return A, N, vtbl.shape[1] - 1


def _own_live(gs, da4):
    live = (gs != 0.0).any(0)
    return live if da4 is None else live | (da4 != 0.0).any(0)


@spanned("nvdr.grad_scatter")
def grad_scatter(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, resolution,
                 da4=None):
    """Per-pixel gradient rows -> per-triangle rows.

    Args:
      rid0: [N] int32 own-pixel table rows (any row in range where the
        pixel's gs column is zero).
      gs, dd2, rid2: pipeline_bwd's outputs.
      b0, b1: [N] rasterizer barycentrics (bb2 = 1 - b0 - b1).
      ax0, ax1: [N] AA aux residuals (di + 4*is_t1).
      vtbl: [9, R+1] clip-space vertex table.
      resolution: (H, W).
      da4: optional [4, N] uv_da terms (c0_u, c0_v, c1_u, c1_v) of the
        textured chain (A = 2): vertex k's attribute row j takes
        bb0*g_j + c0_j, bb1*g_j + c1_j, bb2*g_j - c0_j - c1_j.

    Returns (gt [R, 3A+9] attribute + raster rows, gaa [R, 9] AA
    position rows), float32.
    """
    if _device_of(gs, "grad_scatter") == "cpu":
        return grad_scatter_plain(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl,
                                  resolution, da4)
    row, partial, _ = scatter_partials(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl,
                                       resolution, da4)
    K = 3 * (gs.shape[0] - 9) + 9  # gt's columns
    out = segments.row_sums(row, partial, vtbl.shape[1] - 1, SCATTER_SEGMENT_KERNEL,
                            SCATTER_SUM_KERNEL)
    return out[:, :K], out[:, K:]


def _tile_grid(N, resolution):
    """(tiles in x, tiles in y, tiles in all) of the 16x16 screen tiles."""
    H, W = resolution
    ntx, nty = -(-W // SCATTER_TILE), -(-H // SCATTER_TILE)
    return ntx, nty, N // (H * W) * ntx * nty


def scatter_tiles(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, resolution, da4=None):
    """(launch, tiles, 3A+18, cap): the tiles pass of csrc/grad_scatter.cu
    on CUDA tensors, as ``segments.tile_partials`` runs it."""
    H, W = resolution
    rid0, gs, dd2, rid2, vtbl = (t.contiguous()
                                 for t in (rid0, gs, dd2, rid2, vtbl))
    flats = [t.contiguous() for t in (b0, b1, ax0, ax1)]
    da4 = None if da4 is None else da4.contiguous()
    A, N, R = _check_scatter(rid0, gs, dd2, rid2, flats, vtbl, resolution, da4)
    if 3 * N >= 2 ** 31:
        raise ValueError(f"grad_scatter: {N} pixels exceed the int32 partial "
                         "count (3*N < 2**31)")
    dims = (N // (H * W), H, W, R, A, 0.5 - 0.5 * W, 0.5 - 0.5 * H, 0.5 * W, 0.5 * H)

    def launch(offsets, counts, row_s, part_s, row, partial):
        kernel = SCATTER_KERNEL if offsets is None else SCATTER_COMPACT_KERNEL
        kernel.launch(gs.device, *(None if x is None else _build.ptr(x) for x in (
            rid0, gs, dd2, rid2, *flats, da4, vtbl)), vtbl.shape[1],
            *(None if x is None else _build.ptr(x) for x in (
                offsets, counts, row_s, part_s, row, partial)), *dims)

    return launch, _tile_grid(N, resolution)[2] if R else 0, 3 * A + 18, SCATTER_CAP


def scatter_partials(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, resolution,
                     da4=None):
    """The per-tile pre-reduction on CUDA tensors (csrc/grad_scatter.cu,
    two passes around the one host sync): (row [E] int32, partial [E,
    3A+18] float64, counts [tiles] int32), tile-major, each tile's rows
    ascending: tile (b * nty + ty) * ntx + tx holds counts[tile]
    partials, the sums of its live entries of one row (columns 0..3A+8
    gt's, 3A+9.. gaa's)."""
    return segments.tile_partials(*scatter_tiles(rid0, gs, dd2, rid2, b0, b1, ax0, ax1,
                                                 vtbl, resolution, da4),
                                  gs.device, "grad_scatter")


def expand_rows(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, resolution,
                da4=None):
    """The live entries expanded to rows, as the kernel expands them.

    Returns ((own rows [M0], own values [M0, 3A+9]),
    (AA rows [M1], AA values [M1, 9])), float32, entries in pixel order
    (AA: axis 0, then axis 1).
    """
    H, W = resolution
    A = gs.shape[0] - 9
    N = rid0.shape[0]
    live = _own_live(gs, da4)
    g = gs[:, live]
    bb0 = b0[live]
    bb1 = b1[live]
    bb2 = 1.0 - bb0 - bb1
    if da4 is None:
        own = torch.cat([bb0 * g[:A], bb1 * g[:A], bb2 * g[:A], g[A:]]).T
    else:
        c0, c1 = da4[:2, live], da4[2:, live]
        own = torch.cat([bb0 * g[:A] + c0, bb1 * g[:A] + c1,
                         bb2 * g[:A] - c0 - c1, g[A:]]).T

    fx, fy, _, _, _ = _pixel_grid(N // (H * W), H, W, 0, gs.device)
    rows = []
    vals = []
    for d, ax in enumerate((ax0, ax1)):
        act = dd2[d] != 0.0
        rid = rid2[d][act]
        di, is_t1 = decode_aux(ax[act])
        cols = pair_pos_grad(list(vtbl[:, rid.long()]), dd2[d][act],
                             torch.ones_like(is_t1), di, is_t1, fx[act],
                             fy[act], d, W, H)
        rows.append(rid)
        vals.append(torch.stack(cols, 1))
    return (rid0[live], own), (torch.cat(rows), torch.cat(vals))


def grad_scatter_plain(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl,
                       resolution, da4=None):
    """Plain PyTorch twin of grad_scatter: expand, then index_add_ in
    float64, rounded to float32 once."""
    flats = (b0, b1, ax0, ax1)
    A, _, R = _check_scatter(rid0, gs, dd2, rid2, flats, vtbl, resolution, da4)
    (own_rows, own), (aa_rows, aa) = expand_rows(rid0, gs, dd2, rid2, *flats,
                                                 vtbl, resolution, da4)
    f64 = dict(dtype=torch.float64, device=gs.device)
    gt = torch.zeros((R, 3 * A + 9), **f64).index_add_(
        0, own_rows.long(), own.double())
    gaa = torch.zeros((R, 9), **f64).index_add_(0, aa_rows.long(), aa.double())
    return gt.float(), gaa.float()


def tile_partials_plain(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, resolution,
                        da4=None):
    """Plain twin of ``scatter_partials``: (row [E], tile [E], partial
    [E, 3A+18] float64, entries [E]) in the kernel's order (tile, then
    row), each partial the kernel's bit for bit: a tile's live entries
    of one row (own pixel, then its AA pairs of axis 0 and 1, per pixel
    in pixel order) expanded as ``expand_rows`` and summed as
    ``segments.run_sums``. Rows must lie in [0, R)."""
    H, W = resolution
    A = gs.shape[0] - 9
    N = rid0.shape[0]
    K = 3 * A + 9
    (orow, own), (arow, aav) = expand_rows(rid0, gs, dd2, rid2, b0, b1, ax0, ax1,
                                           vtbl, resolution, da4)
    opix = torch.nonzero(_own_live(gs, da4)).squeeze(1)
    apix = [torch.nonzero(dd2[d] != 0.0).squeeze(1) for d in (0, 1)]
    pix = torch.cat([opix] + apix)
    item = torch.cat([torch.zeros_like(opix), torch.ones_like(apix[0]),
                      torch.full_like(apix[1], 2)])
    vals = torch.zeros((pix.shape[0], K + 9), dtype=torch.float32, device=gs.device)
    vals[:opix.shape[0], :K] = own
    vals[opix.shape[0]:, K:] = aav
    ntx, nty, _ = _tile_grid(N, resolution)
    y, x = (pix // W) % H, pix % W
    tile = ((pix // (H * W)) * nty + y // SCATTER_TILE) * ntx + x // SCATTER_TILE
    item = ((y % SCATTER_TILE) * SCATTER_TILE + x % SCATTER_TILE) * 3 + item
    tile, row, partial, n = segments.run_sums(tile, torch.cat([orow, arow]).long(), item,
                                              vals)
    return row, tile, partial, n
