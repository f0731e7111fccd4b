"""Plain PyTorch reference of cube-map sampling as nvdiffrast defines it.

Written again from nvdiffrast's description of ``texture(...,
boundary_mode='cube')`` (Laine et al. 2020, and its documentation):

* face selection: the direction's largest component picks the face
  (0 +x, 1 -x, 2 +y, 3 -y, 4 +z, 5 -z); z wins only when |z| is strictly
  the largest, then y when |y| > |x|, else x;
* projection: s = 1/2 + sign_s * d[axis_s] / (2 |d[major]|), t likewise,
  with the OpenGL cube-map axes below, clipped to [0, 1]; the mip level's
  footprint is the derivative of the unclipped (s, t);
* seamless bilinear taps: a corner texel that falls one texel off its
  face is the texel of the neighbour face whose centre lies nearest the
  direction of its own centre; a corner that falls off two edges at once
  (a cube corner) is missing and takes the mean of the other three;
* the pyramid: each face's 2x2 box filter, level by level;
* the level: half the log2 of the squared major axis of the footprint in
  face texels (``render.mip_level``), and trilinear blending of the two
  levels around it.

Imports torch alone. Texel indices are worked out in float64 whatever
the data type, as integer arithmetic; the sampled values, weights and
footprint follow the dtype of their inputs.
"""

import torch

from perfbench.ref import render as R

# Per face: the major axis, and the axis and sign of the s and t components.
MAJOR = (0, 0, 1, 1, 2, 2)
S_AXIS, S_SIGN = (2, 2, 0, 0, 0, 0), (-1.0, 1.0, 1.0, 1.0, 1.0, -1.0)
T_AXIS, T_SIGN = (1, 1, 2, 2, 1, 1), (-1.0, -1.0, 1.0, -1.0, -1.0, -1.0)


def _per_face(table, face, dtype=None):
    t = torch.tensor(table, device=face.device)
    return t[face] if dtype is None else t.to(dtype)[face]


def face_of(d):
    """Face [M] int64 of directions d [M, 3] (the tie rule above)."""
    a = d.detach().abs()
    z = a[:, 2] > torch.maximum(a[:, 0], a[:, 1])
    y = ~z & (a[:, 1] > a[:, 0])
    axis = torch.where(z, 2, torch.where(y, 1, 0))
    neg = d.detach().gather(1, axis[:, None])[:, 0] < 0
    return 2 * axis + neg.long()


def _components(d, face):
    """(c, u, v, sign_s, sign_t): the major component and the s and t
    components of d [M, 3] on `face`, and their signs."""
    def comp(table):
        return d.gather(1, _per_face(table, face)[:, None])[:, 0]

    return (comp(MAJOR), comp(S_AXIS), comp(T_AXIS), _per_face(S_SIGN, face, d.dtype),
            _per_face(T_SIGN, face, d.dtype))


def project(d, face):
    """Unclipped face coordinates (s, t) [M] of d [M, 3] on `face`."""
    c, u, v, ss, ts = _components(d, face)
    half = 0.5 / c.abs()
    return 0.5 + ss * u * half, 0.5 + ts * v * half


def footprint(d, ddx, ddy, face):
    """[M, 4] (ds/dX, ds/dY, dt/dX, dt/dY) of the unclipped projection at
    d [M, 3] from the direction's screen derivatives ddx, ddy [M, 3]:
    ds = sign_s / (2|c|) (du - u dc / c), dt likewise."""
    c, u, v, ss, ts = _components(d, face)
    half = 0.5 / c.abs()
    cols = []
    for x, x_sign, x_axis in ((u, ss, S_AXIS), (v, ts, T_AXIS)):
        for dd in (ddx, ddy):
            dc, dx = (dd.gather(1, _per_face(t, face)[:, None])[:, 0] for t in (MAJOR, x_axis))
            cols.append(x_sign * half * (dx - x * dc / c))
    return torch.stack(cols, dim=1)


def _direction(face, s, t):
    """Direction [M, 3] float64 of face coordinates (s, t) on `face`, its
    major component +-1."""
    d = torch.zeros(face.shape + (3,), dtype=torch.float64, device=face.device)
    major_sign = torch.where(face % 2 == 1, -1.0, 1.0).to(torch.float64)
    d.scatter_(1, _per_face(MAJOR, face)[:, None], major_sign[:, None])
    d.scatter_(1, _per_face(S_AXIS, face)[:, None],
               (_per_face(S_SIGN, face, torch.float64) * (2 * s - 1))[:, None])
    d.scatter_(1, _per_face(T_AXIS, face)[:, None],
               (_per_face(T_SIGN, face, torch.float64) * (2 * t - 1))[:, None])
    return d


def texel(face, ix, iy, w):
    """(face, ix, iy, ok) of texel (ix, iy) of `face`, which may lie one
    texel off the face (w: the face's width, an int64 tensor): in-face
    texels pass through, one off an edge lands on the neighbour face,
    one off two edges is missing (ok False)."""
    out_x = (ix < 0) | (ix >= w)
    out_y = (iy < 0) | (iy >= w)
    inside = ~(out_x | out_y)
    wf = w.to(torch.float64)
    d = _direction(face, (ix.to(torch.float64) + 0.5) / wf, (iy.to(torch.float64) + 0.5) / wf)
    f2 = face_of(d)
    s2, t2 = (torch.clamp(x, 0.0, 1.0) for x in project(d, f2))
    nix = torch.minimum(torch.clamp(torch.round(s2 * wf - 0.5).long(), min=0), w - 1)
    niy = torch.minimum(torch.clamp(torch.round(t2 * wf - 0.5).long(), min=0), w - 1)
    return (torch.where(inside, face, f2), torch.where(inside, ix, nix),
            torch.where(inside, iy, niy), ~(out_x & out_y))


def pyramid(env, max_level):
    """[env, level 1, ...] of a cube map [6, w, w, C]: each face's 2x2 box
    filter, down to 1x1 or `max_level` levels past the base."""
    levels = [env]
    while levels[-1].shape[1] > 1 and (max_level < 0 or len(levels) <= max_level):
        t = levels[-1]
        t = 0.5 * (t[:, 0::2] + t[:, 1::2])
        levels.append(0.5 * (t[:, :, 0::2] + t[:, :, 1::2]))
    return levels


def sample(levels, d, flevel):
    """Trilinear seamless samples [M, C] of the cube pyramid `levels` at
    directions d [M, 3] and levels flevel [M] (in [0, L-1])."""
    L = len(levels)
    C = levels[0].shape[-1]
    dev = d.device
    flat = torch.cat([lv.reshape(-1, C) for lv in levels])
    ws = torch.tensor([lv.shape[1] for lv in levels], device=dev)
    offs = torch.cumsum(6 * ws * ws, 0) - 6 * ws * ws
    face = face_of(d)
    s, t = (torch.clamp(x, 0.0, 1.0) for x in project(d, face))
    l0 = torch.clamp(torch.floor(flevel.detach()), 0, L - 1).long()
    l1 = torch.clamp(l0 + 1, max=L - 1)
    frac = (flevel - l0.to(flevel.dtype))[:, None]

    def bilinear(lev):
        w = ws[lev]
        u = s * w.to(s.dtype) - 0.5
        v = t * w.to(t.dtype) - 0.5
        # The corner texels from (s, t) in float64: at most one texel off
        # the face, whatever the data type rounds s * w to.
        iu, iv = (torch.floor(x.detach().double() * w - 0.5).long() for x in (s, t))
        fu, fv = (u - iu.to(u.dtype))[:, None], (v - iv.to(v.dtype))[:, None]
        taps, oks = [], []
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            f, x, y, ok = texel(face, iu + dx, iv + dy, w)
            taps.append(flat.index_select(0, offs[lev] + (f * w + y) * w + x))
            oks.append(ok[:, None])
        n_ok = sum(ok.to(flat.dtype) for ok in oks)
        mean = sum(torch.where(ok, q, 0.0) for q, ok in zip(taps, oks)) / n_ok
        q = [torch.where(ok, q, mean) for q, ok in zip(taps, oks)]
        return ((1 - fu) * (1 - fv) * q[0] + fu * (1 - fv) * q[1]
                + (1 - fu) * fv * q[2] + fu * fv * q[3])

    return (1 - frac) * bilinear(l0) + frac * bilinear(l1)


def level(d, ddx, ddy, width, L):
    """Mip level [M] of each lookup: the footprint of (s, t) in face
    texels of the base level's `width` (``render.mip_level``)."""
    return R.mip_level(footprint(d, ddx, ddy, face_of(d)), float(width), float(width), L)
