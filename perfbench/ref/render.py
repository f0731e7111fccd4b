"""Plain PyTorch reference of the rendering chain the benchmark drives.

Rasterize (coverage with the exclusive tie rule, the near-plane cut and
the depth range, the nearest depth with the lowest id on ties),
perspective-correct barycentrics and their pixel derivatives,
interpolation, the mip pyramid and trilinear texture sampling with the
mip level from the uv footprint, and analytic antialiasing of
silhouette edges: the semantics of nvdiffrast (Laine et al. 2020,
"Modular Primitives for High-Performance Differentiable Rendering").

Written for clarity, one view at a time, in float64 by default; it
imports torch alone and takes nothing the program under test made: the
topology, the pyramid and every table are worked out here again.
Gradients come from torch's autograd through these formulas, except the
antialias edge crossing, whose derivative divides by the edge's extent
plus 1e-3 pixels of the same sign, as nvdiffrast's does.

``data`` is the dtype of the data path (attributes, texels,
barycentrics once computed, the image); coverage and the edge crossings
stay in ``geom``. float64 for both is the reference; a lower ``data``
type gives the benchmark's precision control.
"""

import math

import torch

NEAR_EPS = 1e-9       # the near-plane cut: interpolated w >= NEAR_EPS
AA_FIND_EPS = 0.0625  # a crossing within 1/16 pixel outside the pair counts
AA_GRAD_EPS = 1e-3    # pixels added to an edge's extent in its derivative
CHUNK = 1 << 23       # candidate (triangle, pixel) pairs evaluated at once


def topology(tri):
    """op [T, 3] int64: for triangle t and edge e (the edge opposite its
    vertex e), the vertex opposite that edge in the other triangle that
    shares it, or -1. Raises ValueError on an edge of three triangles."""
    T = tri.shape[0]
    a = tri[:, [1, 2, 0]].reshape(-1)
    b = tri[:, [2, 0, 1]].reshape(-1)
    own = tri.reshape(-1)
    V = int(tri.max()) + 1
    key = torch.minimum(a, b) * V + torch.maximum(a, b)
    key, order = torch.sort(key, stable=True)
    same_next = torch.zeros_like(key, dtype=torch.bool)
    same_next[:-1] = key[1:] == key[:-1]
    if bool((same_next[:-1] & same_next[1:]).any()):
        raise ValueError("reference topology: an edge shared by three triangles")
    op_sorted = torch.full_like(key, -1)
    i = same_next.nonzero().squeeze(1)
    op_sorted[i] = own[order[i + 1]]
    op_sorted[i + 1] = own[order[i]]
    op = torch.empty_like(op_sorted)
    op[order] = op_sorted
    return op.reshape(T, 3)


def gather_rows(x, idx):
    """x[idx] for an index tensor of any shape, through index_select,
    whose backward adds with atomics: advanced indexing's backward
    serialises the many repeats of one row (a vertex every pixel of a
    triangle reads) and is orders of magnitude slower."""
    return x.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def _edges(x, y, w):
    """Edge function coefficients (c0, cx, cy), each [..., 3]: edge k is
    the one opposite vertex k, E_k(fx, fy) = c0 + cx * fx + cy * fy."""
    j, k = [1, 2, 0], [2, 0, 1]
    xj, yj, wj = x[..., j], y[..., j], w[..., j]
    xk, yk, wk = x[..., k], y[..., k], w[..., k]
    return xj * yk - xk * yj, yj * wk - wj * yk, wj * xk - xj * wk


def _winding(c0, cx, cy, x, y, w):
    """+1 or -1 per triangle: the sign that makes E_0 positive at vertex 0;
    and the triangle's validity (a nonzero area, no two equal vertices)."""
    pd = c0[..., 0] * w[..., 0] + cx[..., 0] * x[..., 0] + cy[..., 0] * y[..., 0]
    dup = torch.zeros_like(pd, dtype=torch.bool)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        dup |= (x[..., i] == x[..., j]) & (y[..., i] == y[..., j]) & (w[..., i] == w[..., j])
    return torch.where(pd < 0, -1.0, 1.0).to(pd.dtype), (pd != 0) & ~dup


def raster(pos, tri, H, W):
    """Nearest triangle per pixel of one view.

    pos [V, 4] clip-space positions (float64), tri [T, 3] int64.
    Returns (tid [H*W] int64, -1 where empty; depth z/w [H*W], inf where
    empty). Vertices must lie in front of the near plane (w > 1e-6)."""
    v = pos.detach()[tri]
    x, y, z, w = v.unbind(-1)
    if bool((w <= 1e-6).any()):
        raise ValueError("reference raster: a vertex at or behind the camera plane")
    c0, cx, cy = _edges(x, y, w)
    po, valid = _winding(c0, cx, cy, x, y, w)
    c0, cx, cy = c0 * po[:, None], cx * po[:, None], cy * po[:, None]
    px = (x / w + 1.0) * (W * 0.5) - 0.5
    py = (y / w + 1.0) * (H * 0.5) - 0.5
    x0 = torch.clamp(torch.floor(px.min(1).values) - 1, 0, W - 1).long()
    x1 = torch.clamp(torch.ceil(px.max(1).values) + 1, 0, W - 1).long()
    y0 = torch.clamp(torch.floor(py.min(1).values) - 1, 0, H - 1).long()
    y1 = torch.clamp(torch.ceil(py.max(1).values) + 1, 0, H - 1).long()
    onscreen = ((px.max(1).values >= -1) & (px.min(1).values <= W)
                & (py.max(1).values >= -1) & (py.min(1).values <= H))
    nx = x1 - x0 + 1
    cnt = torch.where(valid & onscreen, nx * (y1 - y0 + 1), 0)
    tids = cnt.nonzero().squeeze(1)
    cnt = cnt[tids]
    kept = []
    cum = torch.cumsum(cnt, 0)
    lo = 0
    while lo < tids.shape[0]:
        base = int(cum[lo - 1]) if lo else 0
        hi = max(int(torch.searchsorted(cum, base + CHUNK, right=True)), lo + 1)
        t = tids[lo:hi]
        c = cnt[lo:hi]
        own = torch.repeat_interleave(torch.arange(t.shape[0], device=pos.device), c)
        local = torch.arange(int(c.sum()), device=pos.device) - (torch.cumsum(c, 0) - c)[own]
        t = t[own]
        qx = x0[t] + local % nx[t]
        qy = y0[t] + local // nx[t]
        fx = (qx.to(pos.dtype) + 0.5) * (2.0 / W) - 1.0
        fy = (qy.to(pos.dtype) + 0.5) * (2.0 / H) - 1.0
        a = c0[t] + cx[t] * fx[:, None] + cy[t] * fy[:, None]
        tie = (cy[t] > 0) | ((cy[t] == 0) & (cx[t] > 0))
        inside = ((a > 0) | ((a == 0) & tie)).all(1)
        pz = (z[t] * a).sum(1)
        pw = (w[t] * a).sum(1)
        ok = (inside & (pw - NEAR_EPS * a.sum(1) >= 0) & (pw > 0) & (pz.abs() <= pw))
        kept.append(((qy * W + qx)[ok], t[ok], (pz / pw)[ok]))
        lo = hi
    N = H * W
    depth = torch.full((N,), math.inf, dtype=pos.dtype, device=pos.device)
    tid = torch.full((N,), -1, dtype=torch.int64, device=pos.device)
    if kept:
        pix = torch.cat([k[0] for k in kept])
        t = torch.cat([k[1] for k in kept])
        d = torch.cat([k[2] for k in kept])
        depth.scatter_reduce_(0, pix, d, "amin")
        win = d == depth[pix]
        big = torch.full((N,), tri.shape[0], dtype=torch.int64, device=pos.device)
        big.scatter_reduce_(0, pix[win], t[win], "amin")
        tid = torch.where(big < tri.shape[0], big, -1)
    return tid, depth


def bary(pos, tri, tid, H, W, with_db):
    """Perspective-correct barycentrics of the covered pixels, and with
    `with_db` their derivatives per pixel step in x and y; differentiable
    in pos. Returns (pix [M], b [M, 3], db (dbdx [M, 3], dbdy [M, 3]) or
    None)."""
    pix = (tid >= 0).nonzero().squeeze(1)
    t = tid[pix]
    v = gather_rows(pos, tri[t])
    x, y, w = v[..., 0], v[..., 1], v[..., 3]
    c0, cx, cy = _edges(x, y, w)
    po, _ = _winding(c0.detach(), cx.detach(), cy.detach(), x.detach(), y.detach(),
                     w.detach())
    c0, cx, cy = c0 * po[:, None], cx * po[:, None], cy * po[:, None]
    fx = ((pix % W).to(pos.dtype) + 0.5) * (2.0 / W) - 1.0
    fy = ((pix // W).to(pos.dtype) + 0.5) * (2.0 / H) - 1.0
    a = c0 + cx * fx[:, None] + cy * fy[:, None]
    s = a.sum(1, keepdim=True)
    b = a / s
    if not with_db:
        return pix, b, None
    dbdx = (2.0 / W) * (cx - b * cx.sum(1, keepdim=True)) / s
    dbdy = (2.0 / H) * (cy - b * cy.sum(1, keepdim=True)) / s
    return pix, b, (dbdx, dbdy)


def interpolate(attr, atri, tid, pix, b, N):
    """[N, A] attributes at every pixel: the barycentric blend of the
    triangle's vertex attributes where covered, 0 elsewhere."""
    vals = (b[..., None] * gather_rows(attr, atri[tid[pix]])).sum(1)
    out = torch.zeros((N, attr.shape[-1]), dtype=vals.dtype, device=vals.device)
    return out.index_put((pix,), vals)


def uv_derivatives(uv, atri, tid, pix, db):
    """[M, 4] (du/dx, du/dy, dv/dx, dv/dy) of the covered pixels."""
    g = gather_rows(uv, atri[tid[pix]])         # [M, 3, 2]
    dbdx, dbdy = db
    ddx = (dbdx[..., None] * g).sum(1)
    ddy = (dbdy[..., None] * g).sum(1)
    return torch.stack([ddx[:, 0], ddy[:, 0], ddx[:, 1], ddy[:, 1]], dim=1)


def pyramid(tex, max_level):
    """[tex, level 1, ...] of a [h, w, C] texture: 2x2 box filters (2x1 or
    1x2 where an axis is 1), down to 1x1 or `max_level` levels."""
    levels = [tex]
    while True:
        h, w = levels[-1].shape[:2]
        if (h == 1 and w == 1) or (max_level >= 0 and len(levels) > max_level):
            return levels
        if (h > 1 and h % 2) or (w > 1 and w % 2):
            raise ValueError(f"reference pyramid: {h}x{w} cannot be halved")
        t = levels[-1]
        if h > 1:
            t = 0.5 * (t[0::2] + t[1::2])
        if w > 1:
            t = 0.5 * (t[:, 0::2] + t[:, 1::2])
        levels.append(t)


def mip_level(da, tex_h, tex_w, L):
    """Mip level of each covered pixel: half the log2 of the squared major
    axis of its texel footprint, clamped to [0, L - 1]."""
    dsdx, dsdy = da[:, 0] * tex_w, da[:, 1] * tex_w
    dtdx, dtdy = da[:, 2] * tex_h, da[:, 3] * tex_h
    A = dsdx * dsdx + dtdx * dtdx
    B = dsdy * dsdy + dtdy * dtdy
    C = dsdx * dsdy + dtdx * dtdy
    l2n = 0.25 * (A - B) ** 2 + C * C
    root = torch.sqrt(torch.where(l2n > 0, l2n, 1.0))
    major = 0.5 * (A + B) + torch.where(l2n > 0, root, 0.0)
    fl = 0.5 * torch.log2(torch.clamp(major, min=1e-38))
    return torch.clamp(fl, 0.0, float(L - 1))


def sample(levels, uv, flevel):
    """Trilinear samples [N, C] with wrapped uvs: bilinear at levels
    floor(flevel) and the next, blended by the fraction."""
    L = len(levels)
    C = levels[0].shape[-1]
    flat = torch.cat([lv.reshape(-1, C) for lv in levels])
    dev = uv.device
    hs = torch.tensor([lv.shape[0] for lv in levels], device=dev)
    ws = torch.tensor([lv.shape[1] for lv in levels], device=dev)
    offs = torch.cumsum(hs * ws, 0) - hs * ws
    l0 = torch.clamp(torch.floor(flevel.detach()), 0, L - 1).long()
    l1 = torch.clamp(l0 + 1, max=L - 1)
    frac = flevel - l0.to(flevel.dtype)

    def bilinear(lev):
        h, w = hs[lev], ws[lev]
        u = uv[:, 0] - torch.floor(uv[:, 0].detach())
        v = uv[:, 1] - torch.floor(uv[:, 1].detach())
        x = u * w.to(u.dtype) - 0.5
        y = v * h.to(v.dtype) - 0.5
        ix, iy = torch.floor(x.detach()).long(), torch.floor(y.detach()).long()
        fx, fy = (x - ix.to(x.dtype))[:, None], (y - iy.to(y.dtype))[:, None]
        ix0, iy0 = torch.remainder(ix, w), torch.remainder(iy, h)
        ix1, iy1 = torch.remainder(ix + 1, w), torch.remainder(iy + 1, h)

        def tap(r, c):
            return flat.index_select(0, offs[lev] + r * w + c)

        return ((1 - fx) * (1 - fy) * tap(iy0, ix0) + fx * (1 - fy) * tap(iy0, ix1)
                + (1 - fx) * fy * tap(iy1, ix0) + fx * fy * tap(iy1, ix1))

    fr = frac[:, None]
    return (1 - fr) * bilinear(l0) + fr * bilinear(l1)


class _Crossing(torch.autograd.Function):
    """x where the segment (x1, y1)-(x2, y2) meets y = 0; its derivative
    divides by dy + copysign(AA_GRAD_EPS, dy), as nvdiffrast's does."""

    @staticmethod
    def forward(ctx, x1, y1, x2, y2):
        ctx.save_for_backward(x1, y1, x2, y2)
        dy = y2 - y1
        return (x1 * dy - y1 * (x2 - x1)) / dy

    @staticmethod
    def backward(ctx, g):
        x1, y1, x2, y2 = ctx.saved_tensors
        dy = y2 - y1
        iy = 1.0 / (dy + torch.where(dy >= 0, AA_GRAD_EPS, -AA_GRAD_EPS))
        c = (x1 * dy - y1 * (x2 - x1)) * iy
        return g * y2 * iy, g * (c - x2) * iy, -g * y1 * iy, g * (x1 - c) * iy


def _silhouettes(sx, sy, tri, op):
    """[T, 3] bool: edge k of a triangle is a silhouette candidate, the
    vertex opposite it in the neighbour (or, without one, its own vertex
    k) lies on the triangle's side of it."""
    own = tri
    ov = torch.where(op >= 0, op, own)
    X, Y = sx[own], sy[own]
    OX, OY = sx[ov], sy[ov]
    bb = (X[:, 1] - X[:, 0]) * (Y[:, 2] - Y[:, 0]) - (X[:, 2] - X[:, 0]) * (Y[:, 1] - Y[:, 0])
    out = []
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        ak = (X[:, i] - OX[:, k]) * (Y[:, j] - OY[:, k]) - (X[:, j] - OX[:, k]) * (Y[:, i] - OY[:, k])
        out.append(torch.signbit(ak) == torch.signbit(bb))
    return torch.stack(out, dim=1)


def antialias(color, tid, depth, pos, tri, op, H, W):
    """Antialiased [H*W, C] image of one view from its colour [H*W, C].

    Every horizontal and vertical pixel pair whose triangle ids differ is
    judged by the nearer triangle (or the only one): where a silhouette
    edge of it crosses the segment between the two pixel centers, the
    pixel on the far side of the crossing's midpoint takes a share
    alpha = 0.5 - distance of the other's colour. Differentiable in the
    colour and, through the crossing, in pos."""
    g = torch.float64 if pos.dtype == torch.float64 else torch.float32
    p4 = pos.to(g)
    sx = p4[:, 0] / p4[:, 3] * (W * 0.5)
    sy = p4[:, 1] / p4[:, 3] * (H * 0.5)
    with torch.no_grad():
        sil = _silhouettes(sx, sy, tri, op)
    idx = torch.arange(H * W, device=color.device).reshape(H, W)
    out = color
    for d in (0, 1):
        p = (idx[:, :-1] if d == 0 else idx[:-1, :]).reshape(-1)
        n = (idx[:, 1:] if d == 0 else idx[1:, :]).reshape(-1)
        t0, t1 = tid[p], tid[n]
        work = t0 != t1
        p, n, t0, t1 = p[work], n[work], t0[work], t1[work]
        both = (t0 >= 0) & (t1 >= 0)
        ts = torch.where(both, torch.where(depth[p] < depth[n], t0, t1),
                         torch.where(t0 >= 0, t0, t1))
        is_t1 = ts == t1
        org = torch.where(is_t1, n, p)
        ox = (org % W).to(g) + (0.5 - 0.5 * W)
        oy = (org // W).to(g) + (0.5 - 0.5 * H)
        vt = tri[ts]
        X = gather_rows(sx, vt) - ox[:, None]
        Y = gather_rows(sy, vt) - oy[:, None]
        if d == 1:
            X, Y = Y, X
        ds = torch.where(is_t1, -1.0, 1.0).to(g)
        with torch.no_grad():
            Xd, Yd = X.detach(), Y.detach()
            vals, dxs, dys, cuts = [], [], [], []
            for k in range(3):
                i, j = (k + 1) % 3, (k + 2) % 3
                dx, dy = Xd[:, j] - Xd[:, i], Yd[:, j] - Yd[:, i]
                cut = torch.signbit(Yd[:, i]) != torch.signbit(Yd[:, j])
                v = ds * (Xd[:, i] * dy - Yd[:, i] * dx) / torch.where(cut, dy, 1.0)
                vals.append(torch.where(cut, v, -math.inf))
                dxs.append(dx)
                dys.append(dy)
                cuts.append(cut)
            vals = torch.stack(vals, 1)
            di = vals.argmax(1)
            pick = di[:, None]
            dc = vals.gather(1, pick).squeeze(1)
            dxk = torch.stack(dxs, 1).gather(1, pick).squeeze(1)
            dyk = torch.stack(dys, 1).gather(1, pick).squeeze(1)
            use = sil[ts, di] & (dyk.abs() >= dxk.abs()) & torch.isfinite(dc)
            keep = use & (dc > -AA_FIND_EPS) & (dc < 1.0 + AA_FIND_EPS)
            alpha0 = torch.where(keep, ds * (0.5 - torch.clamp(dc, 0.0, 1.0)), 0.0)
            inner = (keep & (dc > 0) & (dc < 1)).nonzero().squeeze(1)
        if inner.numel():
            i1, i2 = ((di + 1) % 3)[inner], ((di + 2) % 3)[inner]
            Xi, Yi = X[inner], Y[inner]
            cross = _Crossing.apply(Xi.gather(1, i1[:, None]).squeeze(1),
                                    Yi.gather(1, i1[:, None]).squeeze(1),
                                    Xi.gather(1, i2[:, None]).squeeze(1),
                                    Yi.gather(1, i2[:, None]).squeeze(1))
            alpha = alpha0.index_put((inner,), 0.5 * ds[inner] - cross)
        else:
            alpha = alpha0
        alpha = alpha.to(color.dtype)
        contrib = alpha[:, None] * (color.index_select(0, n) - color.index_select(0, p))
        right = alpha > 0
        left = alpha < 0
        out = out.index_add(0, p[right], contrib[right]).index_add(0, n[left], contrib[left])
    return out
