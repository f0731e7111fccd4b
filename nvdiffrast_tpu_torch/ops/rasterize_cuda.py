"""Rasterizer: plain-tensor prepass + one CUDA kernel (torch).

Counterpart of ``nvdiffrast_tpu/ops/rasterize_pallas.py``.

* **Prepass** (plain tensor code, as the JAX package's XLA prepass):
  per triangle one 16-float record (3 winding-normalized affine edge
  functions, the z and w planes, id+1 or 1e30 when invalid) and a
  screen AABB that includes the coverage slop. Same formulas, same
  operation order; the edge rows come from the correctly-rounded
  ``_dop`` and match the JAX records bit for bit.
* **Kernel** ``csrc/rasterize.cu`` (``rasterize_records``): coverage with
  the exclusive tie rule and near-clip cut, the lexicographic (z/w, id)
  minimum with the lowest id winning ties, and the final shading to
  (u, v, z/w, id). ``rasterize_records_plain`` is its plain PyTorch
  twin with the same arithmetic in the same merge order (ascending id
  per pixel, candidates rejected per 16x16 tile by AABB), so the two
  agree bit for bit.

Only instance mode without bary derivatives is ported: range mode,
depth peeling, viewports and ``emit_db`` raise NotImplementedError.
"""

import ctypes

import torch

from .. import _build
from . import coord
from .rasterize import _W_CLIP_EPS, _check_rasterize_args, _dop

_BIG = 1e30
_ID_INVALID = 1e30
_ID_VALID_THRESH = 1e29
# Near-plane cut epsilon of the kernel (rasterize._W_CLIP_EPS).
_CLIP_EPS = 1e-9

# Tile edge of the kernel's per-tile AABB rejection (csrc/rasterize.cu TILE).
RASTER_TILE = 16

# Fragments the plain twin evaluates at once (~150 bytes each).
_TWIN_FRAGMENTS = 1 << 22

# Coverage slop (rasterize_pallas._coverage_slop): per-edge rounding
# bound in units of |c0| + |cx| + |cy|, subnormal floor, margin.
_SLOP_KAPPA = (1.01 + 3.0) * 2.0 ** -24
_SLOP_ABS_FLOOR = 3.0 * 2.0 ** -126
_SLOP_MARGIN = 1.25

KERNEL = _build.Kernel(
    "nvdr_rasterize_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4)


def _f32(x, like):
    """A float32 scalar tensor on `like`'s device (f32 constant math)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Prepass (rasterize_pallas.py:177-411).
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


def _aabb_union_cols(sx, sy, sw, svalid, ok_tri, slop, H, W):
    """Pixel-unit screen AABB of the clipped slots plus the half-pixel
    guard band and the slop; empty (+BIG, -BIG) when culled."""
    gx = 0.5 + torch.clamp(slop * (W * 0.5), 0.0, 1e9)
    gy = 0.5 + torch.clamp(slop * (H * 0.5), 0.0, 1e9)

    u = None
    for s in range(2):
        pxs = []
        pys = []
        for v in range(3):
            wv = torch.clamp(sw[s][v], min=1e-12)
            pxs.append(torch.clamp((sx[s][v] / wv + 1.0) * (W * 0.5) - 0.5,
                                   -1e9, 1e9))
            pys.append(torch.clamp((sy[s][v] / wv + 1.0) * (H * 0.5) - 0.5,
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


def build_records(pos, tri, resolution):
    """Kernel inputs: records [B, T, 16] and AABBs [B, T, 4], contiguous."""
    H, W = resolution
    rec_cm, (sx, sy, sw, svalid), valid, slop = _build_records_cm(pos, tri)
    aabb = _aabb_union_cols(sx, sy, sw, svalid, valid, slop, H, W)
    rec = rec_cm.transpose(-1, -2).contiguous()
    return rec, torch.stack(aabb, dim=-1).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper and its plain twin.
# ---------------------------------------------------------------------------

def rasterize_records(rec, aabb, resolution):
    """Rasterize prepass records: (u, v, zw, idf), each [B, H, W] f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel
    (built at first use) or raise.
    """
    if rec.device.type == "cpu":
        return rasterize_records_plain(rec, aabb, resolution)
    if rec.device.type != "cuda":
        raise ValueError(f"rasterize_records: unsupported device {rec.device}")
    H, W = resolution
    B, T, nf = rec.shape
    if (nf != 16 or rec.dtype != torch.float32 or aabb.shape != (B, T, 4)
            or aabb.dtype != torch.float32 or aabb.device != rec.device):
        raise ValueError("rasterize_records: expects rec [B, T, 16] and "
                         "aabb [B, T, 4] float32 on one device")
    rec = rec.contiguous()
    aabb = aabb.contiguous()
    if rec.data_ptr() % 16 or aabb.data_ptr() % 16:
        raise ValueError("rasterize_records: inputs must be 16-byte aligned")
    outs = [torch.empty((B, H, W), dtype=torch.float32, device=rec.device)
            for _ in range(4)]
    xs, xo, ys, yo = coord.pixel_scale_offset(H, W)
    KERNEL.launch(rec.device, _build.ptr(rec), _build.ptr(aabb),
                  *(_build.ptr(o) for o in outs), B, T, H, W, xs, xo, ys, yo)
    return tuple(outs)


def _tile_span(lo, hi, n_tiles):
    """Tiles [first, last] whose pixel range [16t, 16t+15] meets [lo, hi]
    (the kernel's per-tile AABB test, exact in f64)."""
    lo = lo.to(torch.float64)
    hi = hi.to(torch.float64)
    first = torch.ceil((lo - (RASTER_TILE - 1)) / RASTER_TILE).clamp(0, n_tiles)
    last = torch.floor(hi / RASTER_TILE).clamp(-1, n_tiles - 1)
    empty = ~(first <= last)  # also catches NaN bounds
    first = torch.where(empty, 0.0, first).long()
    last = torch.where(empty, -1.0, last).long()
    return first, last


def _merge_fragments(state, s, first, x0, y0, nx, cnt, T, resolution, scale):
    """Evaluate the fragments of records [first, first + len(s)) and merge
    them into `state` in the kernel's order (see rasterize_records_plain)."""
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
    fy = py.to(torch.float32) * ys + yo

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
    keep = ok.nonzero().squeeze(1)
    if keep.numel() == 0:
        return
    pix = (((first + own[keep]) // T) * H + py[keep]) * W + px[keep]
    cand = torch.stack([pz[keep], pw[keep], idf[keep], a0[keep], a1[keep],
                        a2[keep]])

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


def rasterize_records_plain(rec, aabb, resolution):
    """Plain PyTorch twin of the rasterizer kernel (same arithmetic).

    Fragments are enumerated per record over the pixels of the tiles its
    AABB meets (the kernel's rejection), evaluated in bulk, and merged
    per pixel in rounds: round r applies every pixel's r-th surviving
    candidate in ascending id order, which is the kernel's sequential
    merge order.
    """
    H, W = resolution
    B, T, _ = rec.shape
    dev = rec.device
    N = B * H * W
    scale = tuple(_f32(v, rec) for v in coord.pixel_scale_offset(H, W))

    # Running (z, w, id) and winner edges (a0, a1, a2) per pixel.
    state = (torch.full((N,), _BIG, dtype=torch.float32, device=dev),
             torch.ones((N,), dtype=torch.float32, device=dev),
             torch.full((N,), _ID_INVALID, dtype=torch.float32, device=dev),
             torch.zeros((3, N), dtype=torch.float32, device=dev))

    # Records plus their near-clip cut line s12+c - eps*((s_c + s3+c) + s6+c).
    r = rec.reshape(B * T, 16)
    eps = _f32(_CLIP_EPS, r)
    cut = torch.stack(
        [r[:, 12 + c] - eps * ((r[:, c] + r[:, 3 + c]) + r[:, 6 + c])
         for c in range(3)], dim=1)
    s_all = torch.cat([r, cut], dim=1)  # [B*T, 19]

    # Tile rectangle of each record, clipped to the image.
    box = aabb.reshape(B * T, 4)
    tx0, tx1 = _tile_span(box[:, 0], box[:, 2], -(-W // RASTER_TILE))
    ty0, ty1 = _tile_span(box[:, 1], box[:, 3], -(-H // RASTER_TILE))
    x0 = tx0 * RASTER_TILE
    y0 = ty0 * RASTER_TILE
    nx = (torch.clamp((tx1 + 1) * RASTER_TILE, max=W) - x0).clamp(min=0)
    ny = (torch.clamp((ty1 + 1) * RASTER_TILE, max=H) - y0).clamp(min=0)
    cnt = nx * ny

    # Records in id order, a slice of about _TWIN_FRAGMENTS fragments at a
    # time (bounds memory); slice after slice keeps each pixel's merge in
    # ascending id order.
    cum = torch.cumsum(cnt, 0)
    lo = 0
    while lo < B * T:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, base + _TWIN_FRAGMENTS, right=True))
        hi = max(hi, lo + 1)
        _merge_fragments(state, s_all[lo:hi], lo, x0[lo:hi], y0[lo:hi],
                         nx[lo:hi], cnt[lo:hi], T, resolution, scale)
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
    zwv = torch.clamp(az / aw, -1.0, 1.0)
    outs = (torch.where(valid, b0, 0.0), torch.where(valid, b1, 0.0),
            torch.where(valid, zwv, 0.0), torch.where(valid, aid, 0.0))
    return tuple(o.reshape(B, H, W) for o in outs)


def rasterize_fused(pos, tri, resolution, ranges=None, peel_depth=None,
                    viewport=None, emit_db=False):
    """Rasterize forward: (u, v, zw, idf), each [B, H, W] float32.

    pos [B, V, 4] float32 clip-space positions, tri [T, 3] int32. Runs on
    pos's device: the plain twin on the CPU, the CUDA kernel on a GPU.
    Range mode, depth peeling, viewports and bary derivatives are not
    ported yet and raise NotImplementedError.
    """
    if (ranges is not None or peel_depth is not None or viewport is not None
            or emit_db):
        raise NotImplementedError(
            "rasterize_fused: range mode, depth peeling, viewports and "
            "emit_db are not ported yet (ROADMAP queue B, item 1)")
    resolution = tuple(int(x) for x in resolution)
    _check_rasterize_args(pos, tri, resolution)
    rec, aabb = build_records(pos, tri, resolution)
    return rasterize_records(rec, aabb, resolution)
