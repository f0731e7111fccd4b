"""Texture sampler backward: two CUDA kernels (torch).

Counterparts of the 2-D texture backward of
``nvdiffrast_tpu/ops/texture_pallas.py`` (``_sample_fwd`` /
``_sample_bwd``, as the textured pipeline's vjp calls them):

* ``texture_bwd`` (kernel ``csrc/texture_bwd.cu``): per pixel, the
  gradients to u, v and the mip level from the colour cotangent. The
  TPU kernel stashes each slot's (dqu, dqv, val) rows in the forward
  (mode ``fwd_stash``, 3*C*slots floats per pixel) and ``_sample_bwd``
  sums them; this kernel gathers the corners again instead, which reads
  less than the stash would move. ``texture_bwd_plain`` is its twin, bit
  for bit.
* ``texture_grad`` (kernels ``csrc/texture_grad.cu``, then the shared
  ``csrc/segment_sum.cu`` sums of ``segments``): the gradient of
  the packed pyramid, every (pixel, slot, corner) tap's
  ``lw * vw * gc * uw`` summed into the texel its corner resolves to
  (wrap by modulo, clamp by clamping, zero by dropping). That is
  ``lattice_scatter.lattice_scatter_grad`` (the separable scatter on the
  apron pyramid and its border fold) for one texture, and the generic
  scatter path for per-image textures. The taps are pre-reduced per
  16x16 screen tile (``grad_tile_entries``: one float64 partial sum per
  lattice cell a tile's taps fall on, made and summed in shared memory),
  the few hundred thousand entries are sorted by (texel, tile), and each
  texel's entries
  are summed in float64 in that order and rounded once, with no float
  atomics and one host sync (the entry count).
  ``tile_entries_plain`` is the plain twin of the entries;
  ``texture_grad_plain`` expands the taps and sums them with
  ``index_add_`` in float64; kernel and twin agree within 1 float32 ulp.

CPU tensors run the twins; CUDA tensors launch the kernels or raise.
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import spanned
from . import segments
from .pipeline_bwd_cuda import _device_of
from .texture_cuda import (BOUNDARY, FILTER, _check, level_corners,
                           level_tables, level_weights)

BWD_KERNEL = _build.Kernel(
    "nvdr_texture_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8)

GRAD_KERNEL = _build.Kernel(
    "nvdr_texture_grad_tiles", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8)
# The second pass of the same entry: the scratch moved into place, and
# the tiles of more than GRAD_CAP entries computed again.
GRAD_COMPACT_KERNEL = _build.Kernel("nvdr_texture_grad_compact", GRAD_KERNEL.argtypes,
                                    symbol="nvdr_texture_grad_tiles")
GRAD_SEGMENT_KERNEL = _build.Kernel("nvdr_texture_grad_segments", segments.SEGMENT_ARGS,
                                    symbol="nvdr_segment_starts")
GRAD_SUM_KERNEL = _build.Kernel("nvdr_texture_grad_sum", segments.SUM_ARGS,
                                symbol="nvdr_segment_sums")

GRAD_TILE = 16  # screen tile of the pre-reduction (csrc/texture_grad.cu TILE)
GRAD_CAP = 64   # entries a tile keeps in the first pass's scratch (csrc/texture_grad.cu CAP)


def _slots(flevel, L, filter_mode):
    """((level [N], level weight [N], d out/d flevel sign), ...) per mip
    slot, as _sample_bwd takes them."""
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    if filter_mode == "linear-mipmap-linear":
        return ((l0, 1.0 - frac, -1.0), (l1, frac, 1.0))
    return ((l0, torch.ones_like(frac), 0.0),)


def _check_bwd(flat, u, v, flevel, gc, meta, shape, per_image, boundary_mode,
               filter_mode, what):
    C, N, L = _check(flat, u, v, flevel, meta, shape, per_image, boundary_mode,
                     filter_mode)
    if gc.shape != (C, N) or gc.dtype != torch.float32 or gc.device != flat.device:
        raise ValueError(f"{what}: gc must be float32 [{C}, {N}] on the device of "
                         "the pyramid")
    return C, N, L


def _meta_arg(meta):
    return ctypes.cast((ctypes.c_int * (3 * len(meta)))(*(x for m in meta for x in m)),
                       ctypes.c_void_p)


# ---------------------------------------------------------------------------
# uv / level backward.
# ---------------------------------------------------------------------------

@spanned("nvdr.tex.bwd")
def texture_bwd(flat, u, v, flevel, gc, meta, shape, per_image, boundary_mode,
                filter_mode):
    """Gradients of the sampled colour to u, v and flevel.

    Args:
      flat: [n_texels, C] packed pyramid; u, v, flevel: flat [N];
      gc: [C, N] cotangent of the sampled colour; meta, shape,
      per_image, modes: as ``texture_cuda.sample``.

    Returns (gu, gv, gfl) flat [N] float32.
    """
    if _device_of(flat, "texture_bwd") == "cpu":
        return texture_bwd_plain(flat, u, v, flevel, gc, meta, shape, per_image,
                                 boundary_mode, filter_mode)
    flat, u, v, flevel, gc = (t.contiguous() for t in (flat, u, v, flevel, gc))
    C, N, L = _check_bwd(flat, u, v, flevel, gc, meta, shape, per_image,
                         boundary_mode, filter_mode, "texture_bwd")
    B, H, W = shape
    out = torch.empty((3, N), dtype=torch.float32, device=flat.device)
    BWD_KERNEL.launch(flat.device, _build.ptr(flat), _build.ptr(u), _build.ptr(v),
                      _build.ptr(flevel), _build.ptr(gc), _build.ptr(out),
                      _meta_arg(meta), B, H, W, C, L, int(bool(per_image)),
                      BOUNDARY[boundary_mode], FILTER[filter_mode])
    return out[0], out[1], out[2]


def texture_bwd_plain(flat, u, v, flevel, gc, meta, shape, per_image,
                      boundary_mode, filter_mode):
    """Plain PyTorch twin of the texture_bwd kernel (same arithmetic)."""
    C, N, L = _check_bwd(flat, u, v, flevel, gc, meta, shape, per_image,
                         boundary_mode, filter_mode, "texture_bwd")
    offs, hs, ws, tz = level_tables(meta, shape, per_image, flat.device)
    gu = torch.zeros_like(u)
    gv = torch.zeros_like(u)
    gfl = torch.zeros_like(u)
    for lsel, lw, dsign in _slots(flevel, L, filter_mode):
        hl, wl = hs[lsel], ws[lsel]
        q, fu, fv, w4, ok4 = level_corners(flat, offs[lsel] + tz * hl * wl, hl, wl,
                                           u, v, boundary_mode)
        val = ((w4[0] * q[0] + w4[1] * q[1]) + w4[2] * q[2]) + w4[3] * q[3]
        if boundary_mode == "zero":  # invalid corners: 0 in the derivatives
            q = [qk * ok for qk, ok in zip(q, ok4)]
        dqu = (1.0 - fv) * (q[1] - q[0]) + fv * (q[3] - q[2])
        dqv = (1.0 - fu) * (q[2] - q[0]) + fu * (q[3] - q[1])
        du = torch.zeros_like(u)
        dv = torch.zeros_like(u)
        dval = torch.zeros_like(u)
        for c in range(C):
            du = du + gc[c] * dqu[c]
            dv = dv + gc[c] * dqv[c]
            dval = dval + gc[c] * val[c]
        gu = gu + lw * du * wl.to(torch.float32)
        gv = gv + lw * dv * hl.to(torch.float32)
        if dsign:
            gfl = gfl + dsign * dval
    return gu, gv, gfl


# ---------------------------------------------------------------------------
# Gradient of the pyramid.
# ---------------------------------------------------------------------------

def lattice_taps(u, v, flevel, meta, shape, per_image, boundary_mode, filter_mode):
    """The texture-gradient taps of every pixel, in code order.

    Returns a list, one item per (slot, dv, du) (code index
    (slot*2 + dv)*2 + du), of (texel [N] int64, lwv [N], uw [N], ok [N]
    bool): the texel the corner resolves to, the row factor lw * vw_dv,
    the column factor uw_du (``lattice_scatter.lattice_setup_sep``) and
    whether the corner lies in the texture (zero boundary; else all
    True). A tap adds ((lwv * gc_c) * uw) to its texel.
    """
    N = u.shape[0]
    L = len(meta)
    offs, hs, ws, tz = level_tables(meta, shape, per_image, u.device)
    taps = []
    for lsel, lw, _ in _slots(flevel, L, filter_mode):
        hl, wl = hs[lsel], ws[lsel]
        h, w = hl.to(torch.float32), wl.to(torch.float32)
        uu, vv = u, v
        if boundary_mode == "wrap":
            uu = uu - torch.floor(uu)
            vv = vv - torch.floor(vv)
        uu = uu * w - 0.5
        vv = vv * h - 0.5
        if boundary_mode == "clamp":
            uu = torch.minimum(torch.maximum(uu, torch.zeros_like(uu)), w - 1.0)
            vv = torch.minimum(torch.maximum(vv, torch.zeros_like(vv)), h - 1.0)
        ju = torch.floor(uu).to(torch.int32).long()
        jv = torch.floor(vv).to(torch.int32).long()
        fu = uu - ju.to(torch.float32)
        fv = vv - jv.to(torch.float32)
        base = offs[lsel] + tz * hl * wl
        for dv in (0, 1):
            row = jv + dv
            vw = (1.0 - fv) if dv == 0 else fv
            for du in (0, 1):
                col = ju + du
                uw = (1.0 - fu) if du == 0 else fu
                ok = torch.ones(N, dtype=torch.bool, device=u.device)
                if boundary_mode == "zero":
                    okr = (row >= 0) & (row < hl)
                    okc = (col >= 0) & (col < wl)
                    vw = vw * okr.to(torch.float32)
                    uw = uw * okc.to(torch.float32)
                    ok = okr & okc
                    r, c = row.clamp(min=0), col.clamp(min=0)
                elif boundary_mode == "wrap":
                    r = torch.remainder(row, hl)
                    c = torch.remainder(col, wl)
                else:
                    r = torch.minimum(row.clamp(min=0), hl - 1)
                    c = torch.minimum(col.clamp(min=0), wl - 1)
                texel = torch.where(ok, base + r * wl + c, 0)
                taps.append((texel, lw * vw, uw, ok))
    return taps


def _tile_blocks(shape):
    """(tiles in x, tiles in y, tiles in all) of the 16x16 screen tiles."""
    B, H, W = shape
    ntx, nty = -(-W // GRAD_TILE), -(-H // GRAD_TILE)
    return ntx, nty, B * ntx * nty


def grad_tiles(u, v, flevel, gc, meta, shape, per_image, boundary_mode, filter_mode):
    """(launch, tiles, C, cap): the tiles pass of csrc/texture_grad.cu on
    CUDA tensors, as ``segments.tile_partials`` runs it."""
    B, H, W = shape
    C = gc.shape[0]
    modes = (B, H, W, C, len(meta), int(bool(per_image)), BOUNDARY[boundary_mode],
             FILTER[filter_mode])
    m = _meta_arg(meta)

    def launch(offsets, counts, texel_s, part_s, texel, partial):
        kernel = GRAD_KERNEL if offsets is None else GRAD_COMPACT_KERNEL
        kernel.launch(gc.device, *(_build.ptr(x) for x in (u, v, flevel, gc)), m,
                      *(None if x is None else _build.ptr(x) for x in (
                          offsets, counts, texel_s, part_s, texel, partial)), *modes)

    return launch, _tile_blocks(shape)[2], C, GRAD_CAP


def grad_tile_entries(u, v, flevel, gc, meta, n_texels, shape, per_image, boundary_mode,
                      filter_mode):
    """The per-tile pre-reduction on CUDA tensors (csrc/texture_grad.cu
    tiles, two passes around the one host sync, ``segments.tile_partials``):
    (texel [E] int32, partial [E, C] float64, counts [tiles] int32),
    tile-major: tile (b * nty + ty) * ntx + tx of the 16x16 screen tiles
    holds counts[tile] entries, one per run of equal sort keys in its sort
    (one unwrapped lattice cell)."""
    return segments.tile_partials(*grad_tiles(u, v, flevel, gc, meta, shape, per_image,
                                              boundary_mode, filter_mode),
                                  gc.device, "texture_grad")


@spanned("nvdr.tex.grad")
def texture_grad(u, v, flevel, gc, meta, n_texels, shape, per_image, boundary_mode,
                 filter_mode):
    """Gradient of the packed pyramid [n_texels, C] float32 from the
    colour cotangent gc [C, N] (u, v, flevel flat [N] as sampled).

    CPU tensors run ``texture_grad_plain``; CUDA tensors launch the
    pre-reduction (``grad_tile_entries``), sort the entries stably by
    texel (index glue) and launch the segment-starts and sum kernels
    (``segments.row_sums``)."""
    if _device_of(gc, "texture_grad") == "cpu":
        return texture_grad_plain(u, v, flevel, gc, meta, n_texels, shape, per_image,
                                  boundary_mode, filter_mode)
    u, v, flevel, gc = (t.contiguous() for t in (u, v, flevel, gc))
    _check_grad(u, v, flevel, gc, meta, n_texels, shape, per_image, boundary_mode,
                filter_mode)
    texel, partial, _ = grad_tile_entries(u, v, flevel, gc, meta, n_texels, shape, per_image,
                                          boundary_mode, filter_mode)
    return segments.row_sums(texel, partial, n_texels, GRAD_SEGMENT_KERNEL, GRAD_SUM_KERNEL)


def tile_entries_plain(u, v, flevel, gc, meta, n_texels, shape, per_image, boundary_mode,
                       filter_mode):
    """Plain twin of the pre-reduced index structure: (texel [E], tile
    [E] int64, partial [E, C] float64, taps [E] int64), one entry per
    (texel, 16x16 screen tile) that a kept tap falls on, sorted by
    (texel, tile): the float64 sum of those taps' values and their count.
    The kernel's entries are per lattice cell, so a texel that two cells
    of a tile resolve to (the wrap seam, a clamped border) has two there,
    which add up to the twin's one; each is summed in another fixed
    order, so the partials agree to float64 rounding."""
    B, H, W = shape
    N = B * H * W
    ntx, nty, n_tiles = _tile_blocks(shape)
    p = torch.arange(N, device=gc.device)
    y, x = (p // W) % H, p % W
    tile = ((p // (H * W)) * nty + y // GRAD_TILE) * ntx + x // GRAD_TILE
    keys, vals = [], []
    for texel, lwv, uw, ok in lattice_taps(u, v, flevel, meta, shape, per_image,
                                           boundary_mode, filter_mode):
        keep = ok & (lwv != 0.0) & (uw != 0.0)
        keys.append((texel * n_tiles + tile)[keep])
        vals.append(((lwv * gc) * uw).T[keep].double())
    ukeys, inv = torch.unique(torch.cat(keys), return_inverse=True)
    partial = torch.zeros((ukeys.shape[0], gc.shape[0]), dtype=torch.float64,
                          device=gc.device).index_add_(0, inv, torch.cat(vals))
    return (ukeys // n_tiles, ukeys % n_tiles, partial,
            torch.bincount(inv, minlength=ukeys.shape[0]))


def _check_grad(u, v, flevel, gc, meta, n_texels, shape, per_image, boundary_mode,
                filter_mode):
    if n_texels <= 0 or gc.ndim != 2:
        raise ValueError("texture_grad: needs a pyramid and gc [C, N]")
    # The sampler's checks, on a stand-in pyramid of the right size.
    return _check_bwd(gc.new_empty((n_texels, gc.shape[0])), u, v, flevel, gc, meta,
                      shape, per_image, boundary_mode, filter_mode, "texture_grad")


def texture_grad_plain(u, v, flevel, gc, meta, n_texels, shape, per_image,
                       boundary_mode, filter_mode):
    """Plain PyTorch twin of texture_grad: expand every tap, then
    index_add_ in float64, rounded to float32 once."""
    C, N, L = _check_grad(u, v, flevel, gc, meta, n_texels, shape, per_image,
                          boundary_mode, filter_mode)
    acc = torch.zeros((n_texels + 1, C), dtype=torch.float64, device=gc.device)
    for texel, lwv, uw, ok in lattice_taps(u, v, flevel, meta, shape, per_image,
                                           boundary_mode, filter_mode):
        vals = (lwv * gc) * uw  # [C, N]
        acc.index_add_(0, torch.where(ok, texel, n_texels), vals.T.double())
    return acc[:n_texels].float()
