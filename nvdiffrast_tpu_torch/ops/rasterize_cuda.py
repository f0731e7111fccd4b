"""Rasterizer: record setup, per-tile binning and one sweep kernel family
(torch).

Counterpart of ``nvdiffrast_tpu/ops/rasterize_pallas.py``.

* **Record setup** ``csrc/raster_setup.cu`` (``setup_records``): per
  triangle one 16-float record (3 winding-normalized affine edge
  functions, the z and w planes, id+1 or 1e30 when invalid) and a screen
  AABB that includes the coverage slop, as the JAX package's XLA prepass
  computes them inside ``rasterize_fused``; also the tiles each AABB
  meets (for binning) and the union box of each 256-record chunk (for
  the unbinned sweep). ``build_records`` is its plain twin (same
  formulas, same float32 operation order, edge rows from the
  correctly-rounded ``_dop``; bit for bit the kernel's, and the edge rows
  bit for bit the JAX records). Instance mode builds one record set per
  image, range mode (2-D pos) one set that every image reads; under a
  viewport the AABB rows are band-local.
* **Binning** ``csrc/raster_bin.cu`` (``bin_records``): per-tile lists of
  the records whose AABB meets the tile, ascending; the TPU's dense,
  remap and CSR layouts are not carried over. A scan of the setup's
  counts, one host sync for the total, the emit kernel, a stable sort of
  the entries' segments and the segment-starts kernel. Engaged when the unbinned sweep's
  AABB tests (images x records x tiles) reach ``BIN_MIN_WORK``.
* **Sweep** ``csrc/rasterize.cu`` (``rasterize_records``): coverage with
  the exclusive tie rule and near-clip cut, the lexicographic (z/w, id)
  minimum with the lowest id winning ties, and the final shading to
  (u, v, z/w, id); with ``emit_db`` also the four bary pixel
  derivatives (dudx, dudy, dvdx, dvdy) from the winner's edge
  gradients; range windows, the peel cull on the rounded depth, the
  zbuf output and viewport rows as arguments. ``rasterize_records_plain``
  is its plain PyTorch twin with the same arithmetic in the same merge
  order (ascending id per pixel; candidates per 8x4 pixel block of a
  warp whose AABB test they pass, from the tile's records or its list),
  so the two agree bit for bit; ``bin_records_plain`` builds the same
  lists as the binning kernels.

Host syncs of a forward (``rasterize_fused``): the binned path reads the
list total back once; the triangle-index check reads tri's range once
per tri tensor (``rasterize._check_indices``), so repeated calls with
the same tri add none, and the unbinned path then has no sync.
"""

import ctypes

import torch

from .. import _build
from . import coord, segments
from .rasterize import _W_CLIP_EPS, _check_rasterize_args, _dop

_BIG = 1e30
_ID_INVALID = 1e30
_ID_VALID_THRESH = 1e29
# Near-plane cut epsilon of the kernel (rasterize._W_CLIP_EPS).
_CLIP_EPS = 1e-9

# Tile edge of the kernel's per-tile AABB rejection (csrc/rasterize.cu TILE).
RASTER_TILE = 16

# The binned sweep is taken when images x records x tiles (the unbinned
# sweep's per-tile AABB tests, before the chunk boxes skip most) reach
# this; below it the unbinned sweep needs no binning glue and no host
# sync. On the H100 (chip_smoke.py phase 16, four calls; PERF.md) the
# unbinned sweep wins at the bench scene's 65 M tests (0.12-0.13 ms
# against 0.23-0.32 ms binned with its glue), at 130 M (bench, B = 2:
# 0.25-0.26 against 0.31-0.52 ms) and at 520 M (peel scene: 0.45-0.49
# against 0.44-0.62 ms, behind in one call of four); the binned one wins
# at 1 M triangles (17 G: 1.4 + 0.2 ms against 2.3 ms). Range mode's
# eight images over 15,872 records (2.1 G) stay binned. 2**30 lies
# between. At the peel scene a peeled layer through rasterize_fused
# (setup, glue, the peel sweep; phase 16, in turns, two calls) is no
# faster binned: CUDA events 0.520-0.527 ms unbinned against 0.497-0.618
# binned, host clock 0.516-0.520 against 0.539-0.617, so DepthPeeler's
# layers there stay unbinned and sync-free.
BIN_MIN_WORK = 1 << 30

# Fragments the plain twin evaluates at once (~150 bytes each).
_TWIN_FRAGMENTS = 1 << 22

# Coverage slop (rasterize_pallas._coverage_slop): per-edge rounding
# bound in units of |c0| + |cx| + |cy|, subnormal floor, margin.
_SLOP_KAPPA = (1.01 + 3.0) * 2.0 ** -24
_SLOP_ABS_FLOOR = 3.0 * 2.0 ** -126
_SLOP_MARGIN = 1.25

# One kernel family behind one entry point (csrc/rasterize.cu
# nvdr_rasterize: rec, aabb, boxes, tile_start, tile_list, tile_order,
# ranges, peel, 9 outputs; B, T, sets, H, W, y0; xs, xo, ys, yo), with one
# launch count per mode. A launch counts under the first of: peel, range
# mode, viewport band (each binned or not), binned, db, plain.
_RASTER_ARGS = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4


def _raster_mode(name):
    return _build.Kernel(name, _RASTER_ARGS, symbol="nvdr_rasterize")


KERNEL = _raster_mode("nvdr_rasterize_fwd")          # unbinned, no db
DB_KERNEL = _raster_mode("nvdr_rasterize_fwd_db")    # unbinned, db
BINNED_KERNEL = _raster_mode("nvdr_rasterize_binned")
PEEL_KERNEL = _raster_mode("nvdr_rasterize_peel")    # with a peel buffer
RANGE_KERNEL = _raster_mode("nvdr_rasterize_range")  # range mode
BAND_KERNEL = _raster_mode("nvdr_rasterize_band")    # viewport band
# Record setup (csrc/raster_setup.cu).
SETUP_KERNEL = _build.Kernel(
    "nvdr_raster_setup", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7)
# Binning (csrc/raster_bin.cu).
BIN_EMIT_KERNEL = _build.Kernel(
    "nvdr_bin_emit", [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 2)
BIN_SEGMENT_KERNEL = _build.Kernel("nvdr_bin_segments", segments.SEGMENT_ARGS,
                                   symbol="nvdr_segment_starts")

# The binned sweep launches the tiles longest list first (one sort of the
# tile list lengths) when the lists hold at least this many entries, so
# that the few long lists of a big mesh (5,730 entries at a pole tile of
# the 1 M-triangle sphere against a median of 85) start in the first wave.
ORDER_MIN_ENTRIES = 1 << 20

# Records a chunk box covers (csrc/raster_setup.cu CHUNK, rasterize.cu NT).
CHUNK = 256
# Pixel block of one warp of the sweep (csrc/rasterize.cu WX, WY): a
# candidate is evaluated on a block only when its AABB meets the block.
# (RASTER_TILE, RASTER_TILE) is the rule of a sweep without that test,
# which gives the same bits because the AABBs are conservative.
CULL = (8, 4)

_KEY_BITS = 24  # record index bits of a plain binning key (T < 2^24)
# List entries of one binning; the lists are indexed with int32.
MAX_BIN_ENTRIES = 1 << 31


def _f32(x, like):
    """A float32 scalar tensor on `like`'s device (f32 constant math)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Record setup (rasterize_pallas.py:177-411) and its plain twin.
# ---------------------------------------------------------------------------

def _gather_tri_cols(pos, tri):
    """Vertex coordinates as per-coordinate flats: (x, y, z, w), each a
    tuple of 3 tensors [B, T] (vertex j of each triangle)."""
    tri = tri.long()
    g = [pos[:, tri[:, j], :] for j in range(3)]  # [B, T, 4]
    return tuple(tuple(gj[..., c] for gj in g) for c in range(4))


def _edge_coeffs_cols(x, y, w):
    """e[k] = (c0, cx, cy) of edge k opposite vertex k: (1,2), (2,0), (0,1)."""
    def edge(j, kk):
        c0 = _dop(x[j], y[kk], x[kk], y[j])
        cx = _dop(y[j], w[kk], w[j], y[kk])
        cy = _dop(w[j], x[kk], x[j], w[kk])
        return (c0, cx, cy)

    return (edge(1, 2), edge(2, 0), edge(0, 1))


def _coverage_slop_from_edges(e_coef):
    """Sound AABB expansion (clip-fraction units) from the edge
    coefficients: how far the f32 coverage polytope can reach beyond
    the projected triangle (rasterize_pallas._coverage_slop)."""
    def edge(k):
        c0, cx, cy = e_coef[k]
        ek = (_SLOP_KAPPA * (c0.abs() + cx.abs() + cy.abs())
              + _SLOP_ABS_FLOOR)
        return ek, torch.sqrt(cx * cx + cy * cy), cx, cy

    e = [edge(0), edge(1), edge(2)]
    slop = torch.zeros_like(e_coef[0][0])
    for k in range(3):
        ek, gk, cxk, cyk = e[k]
        el, gl, cxl, cyl = e[(k + 1) % 3]
        d = (cxk * cyl - cyk * cxl).abs()
        delta = torch.where(d > 0, (ek * gl + el * gk)
                            / torch.clamp(d, min=1e-38), _BIG)
        slop = torch.maximum(slop, delta)
    return _SLOP_MARGIN * slop


def _near_clip_cols(x, y, w):
    """Near-plane clip (w >= eps) into <= 2 subtriangles, used only to
    bound the screen AABB. Returns (sx, sy, sw, valid): s*[slot][vert]
    flats for the 2 slots, and valid[slot]."""
    inside = [wj >= _W_CLIP_EPS for wj in w]
    n_in = (inside[0].to(torch.int32) + inside[1].to(torch.int32)
            + inside[2].to(torch.int32))

    i0, i1, i2 = inside
    k_one = torch.where(i0, 0, torch.where(i1, 1, 2))
    k_two = torch.where(~i2, 0, torch.where(~i0, 1, 2))
    k = torch.where(n_in == 1, k_one, torch.where(n_in == 2, k_two, 0))

    def rot(vals, j):
        return torch.where(k == 0, vals[j % 3],
                           torch.where(k == 1, vals[(j + 1) % 3],
                                       vals[(j + 2) % 3]))

    r = [tuple(rot(c, j) for c in (x, y, w)) for j in range(3)]

    def isect(p, q):
        denom = q[2] - p[2]
        safe = torch.where(denom.abs() > 0, denom, 1.0)
        t = torch.clamp((_W_CLIP_EPS - p[2]) / safe, 0.0, 1.0)
        return tuple(pc + t * (qc - pc) for pc, qc in zip(p, q))

    i01 = isect(r[0], r[1])
    i02 = isect(r[0], r[2])
    i12 = isect(r[1], r[2])

    case_one = n_in == 1
    case_two = n_in == 2

    # n==3: (r0, r1, r2); n==1: (r0, i01, i02); n==2: (r0, r1, i12).
    s0 = [r[0],
          tuple(torch.where(case_one, a, b) for a, b in zip(i01, r[1])),
          tuple(torch.where(case_one, a, torch.where(case_two, b, c))
                for a, b, c in zip(i02, i12, r[2]))]
    s1 = [r[0], i12, i02]

    sx = [[v[0] for v in s0], [v[0] for v in s1]]
    sy = [[v[1] for v in s0], [v[1] for v in s1]]
    sw = [[v[2] for v in s0], [v[2] for v in s1]]
    valid = [n_in >= 1, case_two]
    return sx, sy, sw, valid


def _aabb_union_cols(sx, sy, sw, svalid, ok_tri, slop, H, W, y0=0, Hf=None):
    """Pixel-unit screen AABB of the clipped slots plus the half-pixel
    guard band and the slop; empty (+BIG, -BIG) when culled. Under a
    viewport the band holds rows [y0, y0 + H) of an Hf-tall image and the
    rows are band-local (rasterize_pallas._aabb_union_cols)."""
    Hf = H if Hf is None else Hf
    y0f = float(y0)
    gx = 0.5 + torch.clamp(slop * (W * 0.5), 0.0, 1e9)
    gy = 0.5 + torch.clamp(slop * (Hf * 0.5), 0.0, 1e9)

    u = None
    for s in range(2):
        pxs = []
        pys = []
        for v in range(3):
            wv = torch.clamp(sw[s][v], min=1e-12)
            pxs.append(torch.clamp((sx[s][v] / wv + 1.0) * (W * 0.5) - 0.5,
                                   -1e9, 1e9))
            pys.append(torch.clamp((sy[s][v] / wv + 1.0) * (Hf * 0.5) - 0.5 - y0f,
                                   -1e9, 1e9))
        xmin = torch.minimum(torch.minimum(pxs[0], pxs[1]), pxs[2]) - gx
        xmax = torch.maximum(torch.maximum(pxs[0], pxs[1]), pxs[2]) + gx
        ymin = torch.minimum(torch.minimum(pys[0], pys[1]), pys[2]) - gy
        ymax = torch.maximum(torch.maximum(pys[0], pys[1]), pys[2]) + gy
        onscreen = ((xmax >= -0.5) & (xmin <= W - 0.5)
                    & (ymax >= -0.5) & (ymin <= H - 0.5))
        ok = svalid[s] & ok_tri & onscreen
        box = (torch.where(ok, xmin, _BIG), torch.where(ok, ymin, _BIG),
               torch.where(ok, xmax, -_BIG), torch.where(ok, ymax, -_BIG))
        if u is None:
            u = box
        else:
            u = (torch.minimum(u[0], box[0]), torch.minimum(u[1], box[1]),
                 torch.maximum(u[2], box[2]), torch.maximum(u[3], box[3]))
    return u


def _build_records_cm(pos, tri):
    """Channel-major records [B, 16, T] plus the AABB inputs.

    Returns (rec_cm, (sx, sy, sw, svalid), valid [B, T], slop [B, T]).
    Edge rows are bitwise the JAX package's; the z/w plane rows are the
    same three-term sums, which XLA may contract differently (~1 ulp).
    """
    x, y, z, w = _gather_tri_cols(pos, tri)
    e = _edge_coeffs_cols(x, y, w)
    zc = tuple(z[0] * e[0][c] + z[1] * e[1][c] + z[2] * e[2][c]
               for c in range(3))
    wc = tuple(w[0] * e[0][c] + w[1] * e[1][c] + w[2] * e[2][c]
               for c in range(3))
    # Winding normalization by the sign of the homogeneous area form,
    # evaluated once per triangle and multiplied into every row.
    pD = e[0][0] * w[0] + e[0][1] * x[0] + e[0][2] * y[0]
    po = torch.where(pD < 0, -1.0, 1.0)

    sx, sy, sw, svalid = _near_clip_cols(x, y, w)

    # Cull triangles with a bitwise-duplicate (x, y, w) vertex pair
    # (they get an exact-zero edge row).
    def eq(j, k):
        return (x[j] == x[k]) & (y[j] == y[k]) & (w[j] == w[k])

    dup = eq(0, 1) | eq(1, 2) | eq(2, 0)
    valid = (pD != 0.0) & ~dup & (svalid[0] | svalid[1])

    T = tri.shape[0]
    ids = torch.arange(T, dtype=torch.float32, device=pos.device) + 1.0
    idf = torch.where(valid, ids.expand_as(valid), _ID_INVALID)

    rows = []
    for k in range(3):
        for c in range(3):
            rows.append(torch.where(valid, e[k][c] * po, 0.0))
    for c in range(3):
        rows.append(torch.where(valid, zc[c] * po, 0.0))
    for c in range(3):
        rows.append(torch.where(valid, wc[c] * po, 0.0))
    rows.append(idf)
    rec_cm = torch.stack(rows, dim=-2)  # [B, 16, T]
    slop = _coverage_slop_from_edges(e)
    return rec_cm, (sx, sy, sw, svalid), valid, slop


def build_records(pos, tri, resolution, viewport=None):
    """Plain PyTorch twin of the record setup kernel, and its CPU path:
    records [S, T, 16] and AABBs [S, T, 4], contiguous; S = B for
    instance-mode pos [B, V, 4], S = 1 for range-mode pos [V, 4].
    viewport = (y0, full_height): band-local AABB rows."""
    H, W = resolution
    y0, Hf = (0, H) if viewport is None else (int(viewport[0]), int(viewport[1]))
    if pos.ndim == 2:
        pos = pos[None]
    rec_cm, (sx, sy, sw, svalid), valid, slop = _build_records_cm(pos, tri)
    aabb = _aabb_union_cols(sx, sy, sw, svalid, valid, slop, H, W, y0, Hf)
    rec = rec_cm.transpose(-1, -2).contiguous()
    return rec, torch.stack(aabb, dim=-1).contiguous()


def tile_counts_plain(aabb, resolution):
    """Tiles [S * T] int32 that each AABB meets by the sweep's tile test
    (the setup kernel's counts)."""
    S, T, _ = aabb.shape
    ntx, nty = _tile_grid(resolution)
    box = aabb.reshape(S * T, 4)
    x0, x1 = _tile_span(box[:, 0], box[:, 2], ntx)
    y0, y1 = _tile_span(box[:, 1], box[:, 3], nty)
    return ((x1 - x0 + 1) * (y1 - y0 + 1)).to(torch.int32)


def chunk_boxes_plain(aabb):
    """Union AABB [S, ceil(T / CHUNK), 4] of each chunk of CHUNK records
    (the setup kernel's boxes; min / max are exact in any order)."""
    S, T, _ = aabb.shape
    n = -(-T // CHUNK)
    pad = aabb.new_tensor([_BIG, _BIG, -_BIG, -_BIG]).expand(S, n * CHUNK - T, 4)
    box = torch.cat([aabb, pad], dim=1).reshape(S, n, CHUNK, 4)
    return torch.cat([box[..., :2].amin(2), box[..., 2:].amax(2)], dim=-1).contiguous()


def setup_records(pos, tri, resolution, viewport=None):
    """Record setup: (rec [S, T, 16], aabb [S, T, 4] float32, counts
    [S * T] int32, boxes [S, ceil(T / CHUNK), 4] float32), arguments as
    ``build_records``; counts and boxes feed the binning and the
    unbinned sweep.

    CPU tensors run the plain twins; CUDA tensors launch the setup kernel
    (csrc/raster_setup.cu) or raise. Triangle indices must lie in
    [0, V) (``rasterize._check_indices``); the kernel makes any other
    triangle invalid rather than read outside pos.
    """
    if pos.device.type == "cpu":
        rec, aabb = build_records(pos, tri, resolution, viewport)
        return rec, aabb, tile_counts_plain(aabb, resolution), chunk_boxes_plain(aabb)
    if pos.device.type != "cuda":
        raise ValueError(f"setup_records: unsupported device {pos.device}")
    H, W = resolution
    y0, Hf = (0, H) if viewport is None else (int(viewport[0]), int(viewport[1]))
    p3 = pos[None] if pos.ndim == 2 else pos
    if (pos.dtype != torch.float32 or tri.dtype != torch.int32 or tri.device != pos.device
            or tri.ndim != 2 or tri.shape[1] != 3 or p3.ndim != 3 or p3.shape[-1] != 4):
        raise ValueError("setup_records: expects float32 pos [B, V, 4] or [V, 4] and int32 "
                         "tri [T, 3] on one device")
    p3 = p3.contiguous()
    tri = tri.contiguous()
    S, V, _ = p3.shape
    T = tri.shape[0]
    dev = pos.device
    rec = torch.empty((S, T, 16), dtype=torch.float32, device=dev)
    aabb = torch.empty((S, T, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((S * T,), dtype=torch.int32, device=dev)
    boxes = torch.empty((S, -(-T // CHUNK), 4), dtype=torch.float32, device=dev)
    if T:
        SETUP_KERNEL.launch(dev, _build.ptr(p3), _build.ptr(tri), _build.ptr(rec),
                            _build.ptr(aabb), _build.ptr(counts), _build.ptr(boxes),
                            S, V, T, H, W, y0, Hf)
    return rec, aabb, counts, boxes


# ---------------------------------------------------------------------------
# Binning (rasterize_pallas.py:414-637).
# ---------------------------------------------------------------------------

def _tile_grid(resolution):
    H, W = resolution
    return -(-W // RASTER_TILE), -(-H // RASTER_TILE)


def _tile_span(lo, hi, n_tiles, size=RASTER_TILE):
    """Blocks [first, last] of `size` pixels whose pixel range
    [size*t, size*t + size - 1] meets [lo, hi] (the kernel's per-tile and
    per-warp AABB tests, exact in f64)."""
    lo = lo.to(torch.float64)
    hi = hi.to(torch.float64)
    first = torch.ceil((lo - (size - 1)) / size).clamp(0, n_tiles)
    last = torch.floor(hi / size).clamp(-1, n_tiles - 1)
    empty = ~(first <= last)  # also catches NaN bounds
    first = torch.where(empty, 0.0, first).long()
    last = torch.where(empty, -1.0, last).long()
    return first, last


def _check_entries(total):
    if total >= MAX_BIN_ENTRIES:
        raise ValueError(f"bin_records: {total} tile list entries; the lists hold fewer "
                         f"than {MAX_BIN_ENTRIES}")


def _segments(keys, n_seg):
    """Sorted plain keys -> (tile_start [n_seg + 1] int32, tile_list [E] int32)."""
    seg = keys >> _KEY_BITS
    bounds = torch.arange(n_seg + 1, dtype=torch.int64, device=keys.device)
    tile_start = torch.searchsorted(seg, bounds).to(torch.int32)
    return tile_start, (keys & ((1 << _KEY_BITS) - 1)).to(torch.int32)


def bin_records(aabb, resolution, counts):
    """Per-tile record lists of AABBs [S, T, 4]: (tile_start [S*tiles + 1],
    tile_list [E]) int32. Segment set*tiles + ty*ntx + tx of 16x16 tiles
    holds, ascending, the indices (within the set) of the records whose
    AABB meets the tile by the kernel's test. counts: the setup's tile
    counts [S * T] int32 (``setup_records``).

    CPU tensors run the plain twin, which counts the tiles itself; CUDA
    tensors scan the counts, read the total back to the host once (the one
    host sync) to allocate the entries, launch the emit kernel
    (csrc/raster_bin.cu: each entry's segment and record, record-major),
    sort the segments stably (index glue; int16 when they fit) and launch
    the segment-starts kernel, which gathers the records through the
    sort's permutation.
    """
    if aabb.device.type == "cpu":
        return bin_records_plain(aabb, resolution)
    if aabb.device.type != "cuda":
        raise ValueError(f"bin_records: unsupported device {aabb.device}")
    S, T, _ = aabb.shape
    if T >= (1 << _KEY_BITS) or aabb.dtype != torch.float32:
        raise ValueError("bin_records: expects float32 AABBs of < 2**24 records a set")
    n = S * T
    if (not isinstance(counts, torch.Tensor) or counts.shape != (n,)
            or counts.dtype != torch.int32 or counts.device != aabb.device):
        raise ValueError("bin_records: counts must be the setup's int32 [S * T] tile counts "
                         "on the AABBs' device")
    ntx, nty = _tile_grid(resolution)
    aabb = aabb.contiguous()
    dev = aabb.device
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(ends[-1]) if n else 0  # the one host sync
    _check_entries(total)
    n_seg = S * ntx * nty
    seg_type = torch.int16 if n_seg <= 2 ** 15 else torch.int32
    seg = torch.empty((total,), dtype=seg_type, device=dev)
    rec_at = torch.empty((total,), dtype=torch.int32, device=dev)
    if total:
        BIN_EMIT_KERNEL.launch(dev, _build.ptr(aabb), _build.ptr(ends - counts), n, T, ntx,
                               nty, seg.element_size(), _build.ptr(seg), _build.ptr(rec_at))
    seg, perm = torch.sort(seg, stable=True)
    tile_start = torch.empty((n_seg + 1,), dtype=torch.int32, device=dev)
    tile_list = torch.empty((total,), dtype=torch.int32, device=dev)
    BIN_SEGMENT_KERNEL.launch(dev, _build.ptr(seg), total, 0, n_seg, seg.element_size(),
                              _build.ptr(perm), _build.ptr(rec_at), _build.ptr(tile_start),
                              _build.ptr(tile_list))
    return tile_start, tile_list


def bin_records_plain(aabb, resolution):
    """Plain PyTorch twin of ``bin_records``: the same lists."""
    S, T, _ = aabb.shape
    ntx, nty = _tile_grid(resolution)
    box = aabb.reshape(S * T, 4)
    x0, x1 = _tile_span(box[:, 0], box[:, 2], ntx)
    y0, y1 = _tile_span(box[:, 1], box[:, 3], nty)
    nx = x1 - x0 + 1
    cnt = nx * (y1 - y0 + 1)
    _check_entries(int(cnt.sum()))
    dev = aabb.device
    own = torch.repeat_interleave(torch.arange(S * T, device=dev), cnt)
    local = torch.arange(own.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[own]
    tx = x0[own] + local % nx[own]
    ty = y0[own] + local // nx[own]
    seg = ((own // T) * nty + ty) * ntx + tx
    keys = (seg << _KEY_BITS) | (own % T)
    return _segments(torch.sort(keys).values, S * ntx * nty)


def binned_by_default(B, T, resolution):
    """Whether ``rasterize_records`` bins: images x records x tiles at or
    above BIN_MIN_WORK."""
    ntx, nty = _tile_grid(resolution)
    return B * T * ntx * nty >= BIN_MIN_WORK


# ---------------------------------------------------------------------------
# Kernel wrapper and its plain twin.
# ---------------------------------------------------------------------------

def _modes(rec, aabb, resolution, ranges, peel, viewport):
    """Checked mode arguments: (B, sets, y0, Hf, ranges)."""
    H, W = resolution
    S, T, nf = rec.shape
    if (nf != 16 or rec.dtype != torch.float32 or aabb.shape != (S, T, 4)
            or aabb.dtype != torch.float32 or aabb.device != rec.device):
        raise ValueError("rasterize_records: expects rec [S, T, 16] and "
                         "aabb [S, T, 4] float32 on one device")
    if ranges is not None:
        ranges = torch.as_tensor(ranges, dtype=torch.int32, device=rec.device)
        if S != 1 or ranges.ndim != 2 or ranges.shape[1] != 2:
            raise ValueError("rasterize_records: range mode takes one record set "
                             "and ranges [B, 2]")
        B = ranges.shape[0]
    else:
        B = S
    if peel is not None and (peel.shape != (B, H, W) or peel.dtype != torch.float32
                             or peel.device != rec.device):
        raise ValueError(f"rasterize_records: peel must be float32 [{B}, {H}, {W}]")
    y0, Hf = (0, H) if viewport is None else (int(viewport[0]), int(viewport[1]))
    return B, S, y0, Hf, ranges


def rasterize_records(setup, resolution, emit_db=False, *, ranges=None, peel=None,
                      viewport=None, emit_zbuf=False):
    """Rasterize prepass records: (u, v, zw, idf), each [B, H, W] f32,
    followed by (dudx, dudy, dvdx, dvdy) when `emit_db` and by zbuf
    (pz/pw, +inf where empty) when `emit_zbuf`.

    setup: the tuple (rec [S, T, 16], aabb [S, T, 4], counts, boxes) of
    ``setup_records``; ranges [B, 2] int32 (range mode, S = 1); peel
    [B, H, W] the previous layer's zbuf; viewport (y0, full_height) of the
    records' setup. The sweep walks the per-tile lists of ``bin_records``
    when ``binned_by_default``, else the chunk boxes.

    CPU tensors run the plain twin; CUDA tensors launch the kernel
    (built at first use) or raise.
    """
    rec, aabb, counts, boxes = setup
    B = _modes(rec, aabb, resolution, ranges, peel, viewport)[0]
    bins = None
    if binned_by_default(B, rec.shape[1], resolution):
        bins = bin_records(aabb, resolution, counts)
    if rec.device.type == "cpu":
        return rasterize_records_plain(rec, aabb, resolution, emit_db, ranges=ranges,
                                       peel=peel, viewport=viewport, emit_zbuf=emit_zbuf,
                                       bins=bins)
    return launch_records(rec, aabb, resolution, emit_db, ranges=ranges, peel=peel,
                          viewport=viewport, emit_zbuf=emit_zbuf, bins=bins, boxes=boxes)


def launch_records(rec, aabb, resolution, emit_db=False, *, ranges=None, peel=None,
                   viewport=None, emit_zbuf=False, bins=None, boxes=None):
    """The kernel launch of ``rasterize_records`` on CUDA tensors: the
    binned sweep over the lists `bins` of ``bin_records``, or else the
    unbinned one over the chunk boxes `boxes` of ``setup_records``."""
    B, S, y0, Hf, ranges = _modes(rec, aabb, resolution, ranges, peel, viewport)
    if rec.device.type != "cuda":
        raise ValueError(f"rasterize_records: unsupported device {rec.device}")
    H, W = resolution
    T = rec.shape[1]
    rec = rec.contiguous()
    aabb = aabb.contiguous()
    if rec.data_ptr() % 16 or aabb.data_ptr() % 16:
        raise ValueError("rasterize_records: inputs must be 16-byte aligned")
    dev = rec.device
    outs = [torch.empty((B, H, W), dtype=torch.float32, device=dev)
            for _ in range(4 + 4 * emit_db + emit_zbuf)]
    ptrs = [_build.ptr(o) for o in outs[:4]]
    ptrs += [_build.ptr(o) for o in outs[4:8]] if emit_db else [None] * 4
    ptrs.append(_build.ptr(outs[-1]) if emit_zbuf else None)
    start = lst = order = None
    if bins is not None:
        start, lst = bins
        if lst.numel() >= ORDER_MIN_ENTRIES and S == B:
            order = torch.argsort(start[1:] - start[:-1], descending=True).to(torch.int32)
        if lst.numel() == 0:  # no record meets a tile; the kernel reads none
            lst = torch.zeros((1,), dtype=torch.int32, device=dev)
    elif boxes is None:
        raise ValueError("rasterize_records: the unbinned sweep needs the setup's chunk boxes")
    if boxes is not None:
        boxes = boxes.contiguous()
        if boxes.shape != (S, -(-T // CHUNK), 4) or boxes.data_ptr() % 16:
            raise ValueError("rasterize_records: boxes must be [S, ceil(T / 256), 4], "
                             "16-byte aligned")
    if peel is not None:
        kernel = PEEL_KERNEL
    elif ranges is not None:
        kernel = RANGE_KERNEL
    elif viewport is not None:
        kernel = BAND_KERNEL
    elif lst is not None:
        kernel = BINNED_KERNEL
    else:
        kernel = DB_KERNEL if emit_db else KERNEL
    if peel is not None:
        peel = peel.contiguous()
    if ranges is not None:
        ranges = ranges.contiguous()
    xs, xo, ys, yo = coord.pixel_scale_offset(Hf, W)
    opt = [None if t is None else _build.ptr(t)
           for t in (boxes, start, lst, order, ranges, peel)]
    kernel.launch(dev, _build.ptr(rec), _build.ptr(aabb), *opt, *ptrs,
                  B, T, S, H, W, y0, xs, xo, ys, yo)
    return tuple(outs)


def _merge_fragments(state, s, img, x0, y0, nx, cnt, resolution, fy0, scale, peel):
    """Evaluate the fragments of records s [n, 19] over their pixel
    rectangles (x0, y0, nx wide, cnt pixels) of images img [n], and merge
    them into `state` in the kernel's order (see rasterize_records_plain).
    fy0: the viewport's row offset; peel: flat [B*H*W] or None."""
    H, W = resolution
    xs, xo, ys, yo = scale
    az, aw, aid, apa = state
    dev = s.device
    F = int(cnt.sum())
    if F == 0:
        return
    own = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    local = torch.arange(F, device=dev) - (torch.cumsum(cnt, 0) - cnt)[own]
    nxo = nx[own]
    px = x0[own] + local % nxo
    py = y0[own] + local // nxo
    s = s[own]  # [F, 19]
    fx = px.to(torch.float32) * xs + xo
    fy = (py + fy0).to(torch.float32) * ys + yo

    def aff(i):
        return (s[:, i] + s[:, i + 1] * fx) + s[:, i + 2] * fy

    def inside(a, i):
        tie = (s[:, i + 2] > 0) | ((s[:, i + 2] == 0) & (s[:, i + 1] > 0))
        return (a > 0) | ((a == 0) & tie)

    a0, a1, a2 = aff(0), aff(3), aff(6)
    pz, pw, cutv = aff(9), aff(12), aff(16)
    idf = s[:, 15]
    ok = (inside(a0, 0) & inside(a1, 3) & inside(a2, 6) & (cutv >= 0)
          & (pw > 0) & (pz.abs() <= pw) & (idf < _ID_VALID_THRESH))
    pix = (img[own] * H + py) * W + px
    if peel is not None:
        # Rounded-depth peel cull: the IEEE quotient the zbuf stores.
        ok &= (pz / pw) > peel[pix]
    keep = ok.nonzero().squeeze(1)
    if keep.numel() == 0:
        return
    pix = pix[keep]
    # The winner's (pa0, pa1, pa2), plus its six edge gradients with db.
    rows = [pz, pw, idf, a0, a1, a2]
    if apa.shape[0] == 9:
        rows += [s[:, i] for i in (1, 2, 4, 5, 7, 8)]
    cand = torch.stack([r[keep] for r in rows])

    # Rank of each candidate among its pixel's, in id order; round r
    # merges every pixel's r-th candidate (pixels unique per round).
    pix, order = torch.sort(pix, stable=True)
    cand = cand[:, order]
    n = pix.shape[0]
    idx = torch.arange(n, device=dev)
    new_pix = torch.ones(n, dtype=torch.bool, device=dev)
    new_pix[1:] = pix[1:] != pix[:-1]
    rank = idx - torch.cummax(torch.where(new_pix, idx, 0), 0).values
    rank, by_rank = torch.sort(rank, stable=True)
    pix = pix[by_rank]
    cand = cand[:, by_rank]
    start = 0
    for end in torch.bincount(rank).cumsum(0).tolist():
        p = pix[start:end]
        cz, cw, cid = cand[0, start:end], cand[1, start:end], cand[2, start:end]
        lhs = cz * aw[p]
        rhs = az[p] * cw
        better = (lhs < rhs) | ((lhs == rhs) & (cid < aid[p]))
        q = p[better]
        az[q] = cz[better]
        aw[q] = cw[better]
        aid[q] = cid[better]
        apa[:, q] = cand[3:, start:end][:, better]
        start = end


def _candidates(rec, aabb, resolution, B, ranges, bins):
    """The twin's candidate stream, in the kernel's order: (row into the
    flat [S*T] records, image, pixel rectangle x0, y0, nx, ny) per
    candidate. Unbinned, each image's records with the CULL blocks
    (the warps' pixel blocks) their AABB meets; binned, each image's tile
    segments, one entry per tile with the CULL blocks of that tile the
    record's AABB meets. Range mode drops the records outside the image's
    id window."""
    H, W = resolution
    S, T, _ = rec.shape
    dev = rec.device
    ntx, nty = _tile_grid(resolution)
    bw, bh = CULL
    nbx, nby = -(-W // bw), -(-H // bh)
    box = aabb.reshape(S * T, 4)
    if bins is None:
        rows = torch.arange(S * T, device=dev)
    else:
        tile_start, tile_list = bins
        seg = torch.repeat_interleave(
            torch.arange(S * ntx * nty, device=dev),
            (tile_start[1:] - tile_start[:-1]).long())
        rows = (seg // (ntx * nty)) * T + tile_list.long()
        box = box[rows]
    bx0, bx1 = _tile_span(box[:, 0], box[:, 2], nbx, bw)
    by0, by1 = _tile_span(box[:, 1], box[:, 3], nby, bh)
    if bins is not None:
        # The blocks of the entry's own tile.
        tx, ty = seg % ntx, (seg // ntx) % nty
        bx0 = torch.maximum(bx0, tx * (RASTER_TILE // bw))
        bx1 = torch.minimum(bx1, (tx + 1) * (RASTER_TILE // bw) - 1)
        by0 = torch.maximum(by0, ty * (RASTER_TILE // bh))
        by1 = torch.minimum(by1, (ty + 1) * (RASTER_TILE // bh) - 1)
    x0 = bx0 * bw
    y0 = by0 * bh
    nx = (torch.clamp((bx1 + 1) * bw, max=W) - x0).clamp(min=0)
    ny = (torch.clamp((by1 + 1) * bh, max=H) - y0).clamp(min=0)
    if ranges is None:
        img = rows // T
        return rows, img, x0, y0, nx, ny
    # Range mode: one set, every image masks ids against its window.
    idf = rec.reshape(T, 16)[rows, 15]
    parts = []
    for b in range(B):
        start_f = ranges[b, 0].to(torch.float32) + 1.0
        end_f = start_f + ranges[b, 1].to(torch.float32)
        sel = ((idf >= start_f) & (idf < end_f)).nonzero().squeeze(1)
        parts.append((rows[sel], torch.full_like(sel, b), x0[sel], y0[sel], nx[sel],
                      ny[sel]))
    return tuple(torch.cat(c) for c in zip(*parts))


def rasterize_records_plain(rec, aabb, resolution, emit_db=False, *, ranges=None,
                            peel=None, viewport=None, emit_zbuf=False, bins=None):
    """Plain PyTorch twin of the rasterizer kernel (same arithmetic).

    Fragments are enumerated per candidate over the pixels of the warp
    blocks (CULL) its AABB meets (the kernel's rejection: unbinned, of
    every tile; binned, of its tile of the lists `bins` from
    ``bin_records``), evaluated in bulk, and merged per pixel in rounds:
    round r applies every pixel's r-th surviving candidate in ascending
    id order, which is the kernel's sequential merge order. Arguments as
    ``rasterize_records``.
    """
    H, W = resolution
    B, S, y0, Hf, ranges = _modes(rec, aabb, resolution, ranges, peel, viewport)
    T = rec.shape[1]
    dev = rec.device
    N = B * H * W
    scale = tuple(_f32(v, rec) for v in coord.pixel_scale_offset(Hf, W))

    # Running (z, w, id) and winner edges (a0, a1, a2) per pixel, with db
    # also the winner's (cx0, cy0, cx1, cy1, cx2, cy2).
    state = (torch.full((N,), _BIG, dtype=torch.float32, device=dev),
             torch.ones((N,), dtype=torch.float32, device=dev),
             torch.full((N,), _ID_INVALID, dtype=torch.float32, device=dev),
             torch.zeros((9 if emit_db else 3, N), dtype=torch.float32,
                         device=dev))

    # Records plus their near-clip cut line s12+c - eps*((s_c + s3+c) + s6+c).
    r = rec.reshape(S * T, 16)
    eps = _f32(_CLIP_EPS, r)
    cut = torch.stack(
        [r[:, 12 + c] - eps * ((r[:, c] + r[:, 3 + c]) + r[:, 6 + c])
         for c in range(3)], dim=1)
    s_all = torch.cat([r, cut], dim=1)  # [S*T, 19]
    peel_flat = None if peel is None else peel.reshape(N)

    rows, img, x0, y0r, nx, ny = _candidates(rec, aabb, resolution, B, ranges, bins)
    cnt = nx * ny

    # Candidates in stream order, a slice of about _TWIN_FRAGMENTS
    # fragments at a time (bounds memory); slice after slice keeps each
    # pixel's merge in ascending id order.
    cum = torch.cumsum(cnt, 0)
    lo, n = 0, rows.shape[0]
    while lo < n:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, base + _TWIN_FRAGMENTS, right=True))
        hi = max(hi, lo + 1)
        _merge_fragments(state, s_all[rows[lo:hi]], img[lo:hi], x0[lo:hi], y0r[lo:hi],
                         nx[lo:hi], cnt[lo:hi], resolution, y0, scale, peel_flat)
        lo = hi

    az, aw, aid, apa = state
    # Final shading (rasterize_pallas.py final grid step).
    valid = aid < _ID_VALID_THRESH
    pa0, pa1, pa2 = apa[0], apa[1], apa[2]
    iw = 1.0 / ((pa0 + pa1) + pa2)
    b0 = torch.clamp(pa0 * iw, 0.0, 1.0)
    b1 = torch.clamp(pa1 * iw, 0.0, 1.0)
    bs = 1.0 / torch.clamp(b0 + b1, min=1.0)
    b0 = b0 * bs
    b1 = b1 * bs
    depth = az / aw
    outs = [b0, b1, torch.clamp(depth, -1.0, 1.0), aid]
    if emit_db:
        # Bary pixel derivatives (rasterize_pallas.py final step, emit_db).
        xs, _, ys, _ = scale
        cx0, cy0, cx1, cy1, cx2, cy2 = apa[3:]
        da0dx, da1dx, da2dx = -cx0, -cx1, -cx2
        da0dy, da1dy, da2dy = -cy0, -cy1, -cy2
        datdx = (da0dx + da1dx) + da2dx
        datdy = (da0dy + da1dy) + da2dy
        dfxdx = xs * iw
        dfydy = ys * iw
        outs += [dfxdx * (b0 * datdx - da0dx), dfydy * (b0 * datdy - da0dy),
                 dfxdx * (b1 * datdx - da1dx), dfydy * (b1 * datdy - da1dy)]
    outs = [torch.where(valid, o, 0.0) for o in outs]
    if emit_zbuf:
        outs.append(torch.where(valid, depth, float("inf")))
    return tuple(o.reshape(B, H, W) for o in outs)


def rasterize_fused(pos, tri, resolution, ranges=None, peel_depth=None,
                    viewport=None, emit_db=False, emit_zbuf=False):
    """Rasterize forward: (u, v, zw, idf), each [B, H, W] float32,
    followed by the bary pixel derivatives (dudx, dudy, dvdx, dvdy) when
    `emit_db` and the zbuf when `emit_zbuf`
    (rasterize_pallas.rasterize_fused(flat=True)).

    pos [B, V, 4] (instance mode; `ranges` is ignored) or [V, 4] (range
    mode, with ranges [B, 2] int32 (start, count) into tri) float32
    clip-space positions, tri [T, 3] int32; peel_depth [B, H, W] the
    previous layer's zbuf; viewport (y0, full_height): rows [y0, y0 + H)
    of a full_height-tall image, bit for bit the same rows of the full
    render. Runs on pos's device: the plain twin on the CPU, the CUDA
    kernels on a GPU.
    """
    resolution = tuple(int(x) for x in resolution)
    if pos.ndim == 3:
        ranges = None
    else:
        ranges = None if ranges is None else torch.as_tensor(
            ranges, dtype=torch.int32, device=pos.device)
    _check_rasterize_args(pos, tri, resolution, ranges)
    return rasterize_records(setup_records(pos, tri, resolution, viewport), resolution,
                             emit_db, ranges=ranges, peel=peel_depth, viewport=viewport,
                             emit_zbuf=emit_zbuf)
