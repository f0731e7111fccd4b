"""Cube-map sampler, forward and backward, and the cube texture
gradient: CUDA kernels (torch).

Counterpart of ``nvdiffrast_tpu/ops/texture_pallas.py``'s ``_call_cube``
(B12; kernel body ``_build_cube_kernel``) in its modes, of the texture
gradient of its vjp (``_sample_cube_bwd``), and of the per-pixel glue
before it:

* ``cube_setup`` (kernel ``csrc/texture_cube_setup.cu``): the
  per-pixel columns the sampler reads, from the directions, their screen
  derivatives and the level bias in one pass: face, (s, t) clipped,
  validity, texture index, and the level of the face coordinates'
  footprint (the footprint Jacobian too where the level's vjp needs it);
  no Pallas kernel, XLA fuses the JAX package's glue;
* ``sample_cube`` (kernel ``csrc/texture_cube.cu``, ``cube_fwd``):
  seamless cube-map samples [C, N] of the flat-packed 6-face pyramid at
  per-pixel face coordinates (s, t), mip level, validity, face and
  texture index, with the linear, linear-mipmap-nearest and
  linear-mipmap-linear filters: corners that fall off a face wrap to the
  neighbour face, a missing cube-corner texel takes the average of the
  other three, an invalid direction gives zeros;
* ``cube_bwd`` (kernel ``cube_tiles``): the gradients (gs, gt, gfl) of
  the samples to s, t and the level from the colour cotangent;
* ``cube_texture_grad`` (the same tiles pass, then the shared
  ``csrc/segment_sum.cu`` sums of ``segments``): the gradient of the
  packed pyramid. Each 16x16 screen tile forms its pixels' texel taps
  (texel, effective weight times the cotangent) and sums them by texel
  in shared memory, in float64; the (texel, tile) partial sums are
  sorted by texel and each texel's are added in float64 in that order
  and rounded once, with no float atomics and one host sync (the
  partial count). ``cube_grads`` computes (gs, gt, gfl) and the texture
  gradient in one pass.

``cube_setup_plain``, ``sample_cube_plain`` and ``cube_bwd_plain`` are
the plain PyTorch twins of the setup and the samplers with the same
arithmetic; ``cube_grad_entries`` expands every tap as
``_sample_cube_bwd`` does, and the CPU path sums them with
``scatter.scatter_add_by_id_plain`` (float64 ``index_add_``);
``cube_tile_partials_plain`` replays the tiles pass's partials bit for
bit (``segments.run_sums``).

Pixels lie on a (B, H, W) grid, p = (b * H + y) * W + x (``shape``,
which the kernels' 16x16 tiles need: CUDA tensors without it raise; the
samplers' twins ignore it). CPU tensors run the twins; CUDA tensors
launch the kernels or raise.
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import span
from . import segments
from .pipeline_bwd_cuda import _device_of
from .scatter import scatter_add_by_id_plain
from .texture_bwd_cuda import _meta_arg
from .texture import mip_level_plain
from .texture_cube import cube_corner_setup, cube_faceid, cube_project, cube_st_da
from .texture_cuda import FILTER, MAX_C, MAX_LEVELS, level_weights

# The per-pixel setup of a cube lookup (csrc/texture_cube_setup.cu).
SETUP_KERNEL = _build.Kernel(
    "nvdr_cube_setup",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] * 2 + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4)

FWD_KERNEL = _build.Kernel(
    "nvdr_texture_cube_fwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6)

# The backward tiles pass's first run: (gs, gt, gfl) and / or the texture
# gradient's partials (counts and the scratch).
BWD_KERNEL = _build.Kernel(
    "nvdr_texture_cube_bwd",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7)
# Its second run: the scratch moved into place and the tiles of more than
# CUBE_CAP partials computed again.
GRAD_COMPACT_KERNEL = _build.Kernel("nvdr_texture_cube_compact", BWD_KERNEL.argtypes,
                                    symbol="nvdr_texture_cube_bwd")
GRAD_SEGMENT_KERNEL = _build.Kernel("nvdr_texture_cube_segments", segments.SEGMENT_ARGS,
                                    symbol="nvdr_segment_starts")
GRAD_SUM_KERNEL = _build.Kernel("nvdr_texture_cube_sum", segments.SUM_ARGS,
                                symbol="nvdr_segment_sums")

CUBE_TILE = 16  # screen tile of the kernels (csrc/texture_cube.cu TILE)
CUBE_CAP = 256  # partials a tile keeps in the first pass's scratch


def _grid(shape, N, what):
    """(B, H, W) of the N pixels, checked."""
    if shape is None:
        raise ValueError(f"{what}: the kernels need the pixels' (B, H, W) shape")
    B, H, W = (int(x) for x in shape)
    if B * H * W != N or (N and min(B, H, W) <= 0):
        raise ValueError(f"{what}: shape {tuple(shape)} does not hold {N} pixels")
    return B, H, W


def _check(n_tex, C, dev, cols, meta, filter_mode, dy=None, what="sample_cube"):
    s, t, flevel, finite, face, tz = cols
    N = s.shape[0]
    L = len(meta)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{what}: {C} channels; the sampler serves 1 to {MAX_C}")
    if not 1 <= L <= MAX_LEVELS or filter_mode not in FILTER:
        raise ValueError(f"{what}: {L} levels, filter {filter_mode!r}")
    if any(x.shape != (N,) for x in cols):
        raise ValueError(f"{what}: s, t, flevel, finite, face, tz must be flat [{N}]")
    if any(x.dtype != torch.float32 for x in (s, t, flevel)) or any(
            x.dtype != torch.int32 for x in (finite, face, tz)):
        raise ValueError(f"{what}: float32 pyramid, s, t, flevel; int32 finite, face, tz")
    if any(x.device != dev for x in cols):
        raise ValueError(f"{what}: tensors on several devices")
    if n_tex * C >= 2 ** 31:
        raise ValueError(f"{what}: pyramid of 2**31 floats or more")
    for off, h, w in meta:
        if h != w or off < 0 or off + 6 * w * w > n_tex:
            raise ValueError(f"{what}: level ({off}, {h}, {w}) outside the "
                             f"{n_tex}-texel pyramid or not square")
    if dy is not None and (dy.shape != (C, N) or dy.dtype != torch.float32
                           or dy.device != dev):
        raise ValueError(f"{what}: dy must be float32 [{C}, {N}] on the pyramid's device")
    return C, N, L


def _check_flat(flat, cols, meta, filter_mode, dy=None, what="sample_cube"):
    """_check for a pyramid flat [n_texels, C] float32."""
    if flat.ndim != 2 or flat.dtype != torch.float32:
        raise ValueError(f"{what}: the pyramid must be float32 [n_texels, C]")
    return _check(flat.shape[0], flat.shape[1], flat.device, cols, meta, filter_mode, dy, what)


def sample_cube(flat, cols, meta, filter_mode, shape=None):
    """Cube-map samples [C, N].

    Args:
      flat: [n_texels, C] texel-major pyramid of [D, 6, w, w, C] levels
        (texture._pack_pyramid).
      cols: (s, t, flevel, finite, face, tz), flat [N]: face coordinates
        in [0, 1] and level (float32; flevel unread by 'linear'), the
        validity, face and texture index (int32).
      meta: ((offset, w, w), ...) per level (texture._static_meta).
      shape: the pixels' (B, H, W) grid (the kernel's 16x16 tiles);
        needed on CUDA tensors, unread by the CPU twin.
    """
    if _device_of(flat, "sample_cube") == "cpu":
        return sample_cube_plain(flat, cols, meta, filter_mode)
    flat = flat.contiguous()
    cols = tuple(x.contiguous() for x in cols)
    C, N, L = _check_flat(flat, cols, meta, filter_mode)
    B, H, W = _grid(shape, N, "sample_cube")
    out = torch.empty((C, N), dtype=torch.float32, device=flat.device)
    if N:
        FWD_KERNEL.launch(flat.device, _build.ptr(flat), *(_build.ptr(x) for x in cols),
                          _build.ptr(out), _meta_arg(meta), B, H, W, C, L, FILTER[filter_mode])
    return out


def _check_setup(uv, uvd, bias, w, L, hw, keep_da):
    """N, the pixels of the cube setup's columns: uv [N, 3], uvd [N, 6]
    or None, bias [N] or None, float32 on one device, the CPU or a CUDA
    device; ValueError otherwise."""
    if uv.ndim != 2 or uv.shape[1] != 3:
        raise ValueError(f"cube_setup: uv must be [N, 3]; got {tuple(uv.shape)}")
    N = uv.shape[0]
    if uvd is not None and tuple(uvd.shape) != (N, 6):
        raise ValueError(f"cube_setup: uv_da must be [{N}, 6]; got {tuple(uvd.shape)}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"cube_setup: bias must be flat [{N}]; got {tuple(bias.shape)}")
    ts = [x for x in (uv, uvd, bias) if x is not None]
    if any(x.dtype != torch.float32 or x.device != uv.device for x in ts):
        raise ValueError("cube_setup: expects float32 tensors on one device")
    _device_of(uv, "cube_setup")
    if w < 1 or not 1 <= L <= MAX_LEVELS or hw < 0 or (hw and N % hw):
        raise ValueError(f"cube_setup: face width {w}, {L} levels, {hw} pixels an image "
                         f"for {N} pixels")
    if keep_da and uvd is None:
        raise ValueError("cube_setup: keep_da needs uv_da")
    if N >= 2 ** 31:
        raise ValueError("cube_setup: 2**31 pixels or more")
    return N


def cube_setup(uv, uvd, bias, w, L, hw, keep_da=False):
    """The per-pixel setup of a cube-map lookup: ((s, t, flevel, finite,
    face, tz), da).

    Args:
      uv: [N, 3] float32 directions, any strides.
      uvd: [N, 6] float32 screen derivatives of the directions (dx/dX,
        dx/dY, dy/dX, dy/dY, dz/dX, dz/dY), any strides, or None; with
        it the level has the footprint of the face coordinates.
      bias: [N] level bias or None. Without uvd and bias the level is 0.
      w: the base level's face width; L: the number of levels.
      hw: the pixels of an image: pixel p samples texture p // hw; 0 for
        one texture (tz = 0).
      keep_da: also return the footprint Jacobian da [4, N] (ds/dX,
        ds/dY, dt/dX, dt/dY), which the level's vjp reads; else None.

    Returns the columns ``sample_cube`` and ``cube_grads`` read: s, t in
    [0, 1] and flevel float32, finite, face and tz int32, each [N]. CPU
    tensors run ``cube_setup_plain``; CUDA tensors one launch of
    csrc/texture_cube_setup.cu, bit for bit the twin's on the card.
    """
    N = _check_setup(uv, uvd, bias, w, L, hw, keep_da)
    if uv.device.type == "cpu":
        return cube_setup_plain(uv, uvd, bias, w, L, hw, keep_da)
    dev = uv.device
    bias = None if bias is None else bias.contiguous()
    fout = torch.empty((3, N), dtype=torch.float32, device=dev)
    iout = torch.empty((3, N), dtype=torch.int32, device=dev)
    da = torch.empty((4, N), dtype=torch.float32, device=dev) if keep_da else None
    if N:
        SETUP_KERNEL.launch(dev, _build.ptr(uv), uv.stride(0), uv.stride(1),
                            *((None, 0, 0) if uvd is None else
                              (_build.ptr(uvd), uvd.stride(0), uvd.stride(1))),
                            None if bias is None else _build.ptr(bias), _build.ptr(fout),
                            _build.ptr(iout), None if da is None else _build.ptr(da), N,
                            int(hw), int(w), int(L))
    return (fout[0], fout[1], fout[2], iout[0], iout[1], iout[2]), da


def _tile_blocks(shape):
    """(tiles in x, tiles in y, tiles in all) of the 16x16 screen tiles."""
    B, H, W = shape
    ntx, nty = -(-W // CUBE_TILE), -(-H // CUBE_TILE)
    return ntx, nty, B * ntx * nty


def cube_tiles(flat, cols, dy, meta, filter_mode, shape, uv_out=None, cap=CUBE_CAP):
    """(launch, tiles, C, cap): the backward tiles pass of
    csrc/texture_cube.cu on contiguous CUDA tensors, as
    ``segments.tile_partials`` runs it; its first run also writes (gs,
    gt, gfl) into uv_out [3, N] when given (then flat is read).
    ``launch(None, None, ...)`` runs the uv part alone."""
    C = dy.shape[0]
    dims = (cap, *shape, C, len(meta), FILTER[filter_mode])
    m = _meta_arg(meta)
    ins = [None if flat is None else _build.ptr(flat)] + [_build.ptr(x) for x in (*cols, dy)]

    def launch(offsets, counts, texel_s, part_s, texel, partial):
        kernel = BWD_KERNEL if offsets is None else GRAD_COMPACT_KERNEL
        uv = None if offsets is not None or uv_out is None else _build.ptr(uv_out)
        kernel.launch(dy.device, *ins, uv, m,
                      *(None if x is None or x.numel() == 0 else _build.ptr(x) for x in (
                          offsets, counts, texel_s, part_s, texel, partial)), *dims)

    return launch, _tile_blocks(shape)[2], C, cap


def cube_grads(flat, cols, dy, meta, n_texels, filter_mode, shape=None, uv=True, tex=True):
    """((gs, gt, gfl) flat [N] or None, texture gradient [n_texels, C]
    float32 or None): the gradients of ``sample_cube`` from the
    cotangent dy [C, N], to s, t, flevel when `uv`, to the packed pyramid
    when `tex`; on the card both from one tiles pass."""
    if _device_of(dy, "cube_grads") == "cpu":
        return (cube_bwd_plain(flat, cols, dy, meta, filter_mode) if uv else None,
                cube_texture_grad(cols, dy, meta, n_texels, filter_mode) if tex else None)
    dy = dy.contiguous()
    cols = tuple(x.contiguous() for x in cols)
    flat = flat.contiguous() if uv else None
    C, N, _ = _check(n_texels, dy.shape[0], dy.device, cols, meta, filter_mode, dy,
                     "cube_grads")
    if uv and (flat.shape != (n_texels, C) or flat.dtype != torch.float32
               or flat.device != dy.device):
        raise ValueError(f"cube_grads: the pyramid must be float32 [{n_texels}, {C}] on "
                         "the device of dy")
    shape = _grid(shape, N, "cube_grads")
    uv_out = torch.empty((3, N), dtype=torch.float32, device=dy.device) if uv else None
    g3 = g_flat = None
    tiles = cube_tiles(flat, cols, dy, meta, filter_mode, shape, uv_out)
    if tex:
        texel, partial, _ = segments.tile_partials(*tiles, dy.device, "cube_texture_grad")
        g_flat = segments.row_sums(texel, partial, n_texels, GRAD_SEGMENT_KERNEL,
                                   GRAD_SUM_KERNEL)
    elif uv and N:
        tiles[0](None, None, None, None, None, None)
    if uv:
        g3 = (uv_out[0], uv_out[1], uv_out[2])
    return g3, g_flat


def cube_bwd(flat, cols, dy, meta, filter_mode, shape=None):
    """(gs, gt, gfl) flat [N]: gradients of ``sample_cube`` to s, t and
    flevel from the cotangent dy [C, N]."""
    if _device_of(flat, "cube_bwd") == "cpu":
        return cube_bwd_plain(flat, cols, dy, meta, filter_mode)
    return cube_grads(flat, cols, dy, meta, flat.shape[0], filter_mode, shape, tex=False)[0]


def cube_texture_grad(cols, dy, meta, n_texels, filter_mode, shape=None):
    """Gradient of the packed cube pyramid [n_texels, C] float32 from dy
    [C, N]. CPU tensors expand the taps (``cube_grad_entries``) and sum
    them with float64 ``index_add_``; CUDA tensors run the tiles pass,
    sort the partials stably by texel and launch the segment-starts and
    sum kernels (``segments.row_sums``)."""
    if _device_of(dy, "cube_texture_grad") == "cuda":
        return cube_grads(None, cols, dy, meta, n_texels, filter_mode, shape, uv=False)[1]
    _check(n_texels, dy.shape[0], dy.device, cols, meta, filter_mode, dy, "cube_texture_grad")
    ids, w = cube_grad_entries(cols, meta, filter_mode)
    vals = dy.repeat(1, w.shape[0] // dy.shape[1]) * w
    return scatter_add_by_id_plain(ids, vals, n_texels)


def cube_tile_partials(cols, dy, meta, filter_mode, shape, cap=CUBE_CAP):
    """The per-tile pre-reduction on CUDA tensors (the tiles pass, two
    runs around the one host sync, ``segments.tile_partials``): (texel
    [E] int32, partial [E, C] float64, counts [tiles] int32), tile-major:
    tile (b * nty + ty) * ntx + tx of the 16x16 screen tiles holds
    counts[tile] partials, one per run of equal keys in its sort."""
    dy = dy.contiguous()
    cols = tuple(x.contiguous() for x in cols)
    _check(int(max(off + 6 * w * w for off, _, w in meta)), dy.shape[0], dy.device, cols,
           meta, filter_mode, dy, "cube_tile_partials")
    shape = _grid(shape, dy.shape[1], "cube_tile_partials")
    return segments.tile_partials(*cube_tiles(None, cols, dy, meta, filter_mode, shape,
                                              cap=cap), dy.device, "cube_texture_grad")


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

def _level_taps(flat, s, t, face, tz, lev, meta):
    """Corners of the per-pixel level `lev`: (q, ok4, fu, fv, w4, ids,
    wl) with q the four corner texels [C, N] and ids their rows of the
    pyramid."""
    offs = torch.tensor([m[0] for m in meta], dtype=torch.int64, device=s.device)
    ws = torch.tensor([m[2] for m in meta], dtype=torch.int64, device=s.device)
    wl = ws[lev]
    rows4, cols4, ok4, fu, fv, w4 = cube_corner_setup(s, t, face.long(), wl)
    base = offs[lev] + tz.long() * (6 * wl * wl)
    ids = [base + r * wl + c for r, c in zip(rows4, cols4)]
    q = [flat[i].T for i in ids] if flat is not None else None
    return q, ok4, fu, fv, w4, ids, wl


def cube_setup_plain(uv, uvd, bias, w, L, hw, keep_da=False):
    """Plain PyTorch twin of the cube setup kernel (``cube_setup``): the
    glue ``cube_faceid``, ``cube_project``, ``cube_st_da`` and
    ``mip_level_plain`` of the face coordinates' footprint."""
    N = _check_setup(uv, uvd, bias, w, L, hw, keep_da)
    x, y, z = uv.unbind(1)
    da = None
    if uvd is not None:
        with span("nvdr.tex.cube.da"):
            da = torch.stack(cube_st_da(x, y, z, uvd.T))
    if da is None and bias is None:
        flevel = torch.zeros(N, dtype=torch.float32, device=uv.device)
    else:
        flevel = mip_level_plain(da, w, w, L, bias)
    finfo = cube_faceid(x, y, z)
    s, t, finite = cube_project(finfo, x, y, z)
    tz = (torch.arange(N, device=uv.device) // hw if hw
          else torch.zeros(N, dtype=torch.int64, device=uv.device))
    cols = (s, t, flevel) + tuple(a.to(torch.int32) for a in (finite, finfo[0], tz))
    return cols, (da if keep_da else None)


def _fill_corners(q, ok4):
    """The average-of-3 rule: a missing corner takes the mean of the
    valid ones."""
    n_ok = torch.clamp(((ok4[0] + ok4[1]) + ok4[2]) + ok4[3], min=1.0)
    avg = (((ok4[0] * q[0] + ok4[1] * q[1]) + ok4[2] * q[2]) + ok4[3] * q[3]) / n_ok
    return [torch.where(ok > 0, qk, avg) for qk, ok in zip(q, ok4)]


def sample_cube_plain(flat, cols, meta, filter_mode):
    """Plain PyTorch twin of the cube_fwd kernel (same arithmetic)."""
    C, N, L = _check_flat(flat, cols, meta, filter_mode)
    s, t, flevel, finite, face, tz = cols
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    fin = finite != 0

    def term(lev):
        wgt = (torch.where(lev == l0, 1.0 - frac, 0.0)
               + torch.where(lev == l1, frac, 0.0))
        q, ok4, _, _, w4, _, _ = _level_taps(flat, s, t, face, tz, lev, meta)
        qq = _fill_corners(q, ok4)
        val = ((w4[0] * qq[0] + w4[1] * qq[1]) + w4[2] * qq[2]) + w4[3] * qq[3]
        return torch.where(fin, wgt * val, 0.0)

    out = torch.zeros((C, N), dtype=torch.float32, device=flat.device) + term(l0)
    if filter_mode == "linear-mipmap-linear":
        out = out + torch.where(l1 != l0, term(l1), 0.0)
    return out


def cube_bwd_plain(flat, cols, dy, meta, filter_mode):
    """Plain PyTorch twin of the cube_tiles kernel's (gs, gt, gfl) (same
    arithmetic)."""
    C, N, L = _check_flat(flat, cols, meta, filter_mode, dy, "cube_bwd")
    s, t, flevel, finite, face, tz = cols
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    fin = finite != 0

    def term(lev):
        on0, on1 = lev == l0, lev == l1
        wgt = torch.where(on0, 1.0 - frac, 0.0) + torch.where(on1, frac, 0.0)
        q, ok4, fu, fv, w4, _, wl = _level_taps(flat, s, t, face, tz, lev, meta)
        qq = _fill_corners(q, ok4)
        dqu = (1.0 - fv) * (qq[1] - qq[0]) + fv * (qq[3] - qq[2])
        dqv = (1.0 - fu) * (qq[2] - qq[0]) + fu * (qq[3] - qq[1])
        val = ((w4[0] * qq[0] + w4[1] * qq[1]) + w4[2] * qq[2]) + w4[3] * qq[3]
        gu = torch.zeros_like(s)
        gv = torch.zeros_like(s)
        gl = torch.zeros_like(s)
        for c in range(C):
            gu = gu + dy[c] * dqu[c]
            gv = gv + dy[c] * dqv[c]
            gl = gl + dy[c] * val[c]
        wf = wl.to(torch.float32)
        dwdf = on1.to(torch.float32) - on0.to(torch.float32)
        return (torch.where(fin, wgt * gu * wf, 0.0), torch.where(fin, wgt * gv * wf, 0.0),
                torch.where(fin, dwdf * gl, 0.0))

    g = [torch.zeros_like(s) + x for x in term(l0)]
    if filter_mode == "linear-mipmap-linear":
        g = [a + torch.where(l1 != l0, b, 0.0) for a, b in zip(g, term(l1))]
    return tuple(g)


# ---------------------------------------------------------------------------
# Gradient of the pyramid.
# ---------------------------------------------------------------------------

def _slot_taps(cols, meta, filter_mode):
    """The texture-gradient taps of every pixel, one item per (slot,
    corner) in code order (slot * 4 + corner): (texel [N] int64, weight
    [N] float32). A tap adds dy * weight to its texel; the weight folds in
    the average-of-3 rule,

        w_eff[j] = w_j ok_j + ok_j / n_ok * sum_i w_i (1 - ok_i),

    times the validity and the slot's level weight; it is 0 for an
    invalid pixel."""
    s, t, flevel, finite, face, tz = cols
    L = len(meta)
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    if filter_mode == "linear-mipmap-linear":
        slots = ((l0, 1.0 - frac), (l1, frac))
    else:
        slots = ((l0, torch.ones_like(frac)),)
    fin = finite.to(torch.float32)
    for lsel, lw in slots:
        _, ok4, _, _, w4, ids4, _ = _level_taps(None, s, t, face, tz, lsel, meta)
        inv_w = ((w4[0] * (1.0 - ok4[0]) + w4[1] * (1.0 - ok4[1]))
                 + w4[2] * (1.0 - ok4[2])) + w4[3] * (1.0 - ok4[3])
        n_ok = torch.clamp(((ok4[0] + ok4[1]) + ok4[2]) + ok4[3], min=1.0)
        for k in range(4):
            w_eff = (w4[k] * ok4[k] + ok4[k] / n_ok * inv_w) * fin
            yield ids4[k], w_eff * lw


def cube_grad_entries(cols, meta, filter_mode):
    """The texture-gradient taps of every pixel (``_sample_cube_bwd``):
    (ids [S*4*N] int32, w [S*4*N] float32) for S mip slots, slot-major
    then corner-major (``_slot_taps``). Invalid pixels have zero
    weights."""
    ids, w = zip(*_slot_taps(cols, meta, filter_mode))
    return torch.cat(ids).to(torch.int32), torch.cat(w)


def cube_tile_partials_plain(cols, dy, meta, filter_mode, shape):
    """Plain twin of ``cube_tile_partials``: (texel [E], tile [E] int64,
    partial [E, C] float64, taps [E] int64) in the kernel's order (tile,
    then texel), each partial the kernel's bit for bit: a 16x16 tile's
    kept taps (valid direction, weight != 0) of one texel, items pixel *
    8 + code in order, summed as ``segments.run_sums`` sums them."""
    N = cols[0].shape[0]
    B, H, W = _grid(shape, N, "cube_tile_partials_plain")
    ntx, nty, _ = _tile_blocks((B, H, W))
    p = torch.arange(N, device=dy.device)
    y, x = (p // W) % H, p % W
    tile_p = ((p // max(H * W, 1)) * nty + y // CUBE_TILE) * ntx + x // CUBE_TILE
    pix = (y % CUBE_TILE) * CUBE_TILE + x % CUBE_TILE
    fin = cols[3] != 0
    parts = []
    for code, (texel, wt) in enumerate(_slot_taps(cols, meta, filter_mode)):
        k = torch.nonzero(fin & (wt != 0.0)).squeeze(1)
        parts.append((tile_p[k], texel[k], pix[k] * 8 + code, (dy[:, k] * wt[k]).T))
    tile, texel, item, vals = (torch.cat(z) for z in zip(*parts))
    rtile, rtexel, partial, n = segments.run_sums(tile, texel, item, vals)
    return rtexel, rtile, partial, n
