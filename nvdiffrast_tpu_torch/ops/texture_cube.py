"""Cube-map glue of the port (torch): face selection, projection, seam
wrap and the footprint Jacobian.

Copies of ``nvdiffrast_tpu/ops/texture.py``'s ``_cube_faceid``,
``_cube_project``, ``_cube_face_direction``, ``_cube_wrap_texel``,
``_cube_st_da_cols`` / ``_cube_uv_da_to_st_da`` and of
``nvdiffrast_tpu/ops/texture_pallas.py``'s chained-where forms
``_face_dir_2d``, ``_faceid_project_2d``, ``_wrap_corner_2d`` and
``cube_corner_setup``, which the cube kernels restate in C++ with the
same float32 operation order: the sampler and its tiles pass
(``csrc/texture_cube.cu``) the chained-where forms, and the per-pixel
setup (``csrc/texture_cube_setup.cu``; ``texture_cube_cuda.cube_setup``)
``cube_faceid``, ``cube_project`` and ``cube_st_da``.

The JAX package gets the footprint Jacobian d(s, t)/d(X, Y) from
``jax.jvp`` of the face projection and its gradient from autodiff of
that jvp. Here both are closed forms. With c the major-axis component,
sigma the face's sign and u_in the direction component on the s axis,

    s = sigma * u_in / (2|c|) + 1/2,   ds = sigma / (2|c|) * (du_in - u_in * dc / c),

t the same with v_in; ``cube_st_da_vjp`` and ``cube_project_vjp`` are
their vjps, written by hand. The projection's clip to [0, 1] passes half
the gradient on a tie (s = 0 or 1 exactly), as JAX differentiates
``clip`` (``minimum(maximum(x, 0), 1)``).
"""

import torch


def _tie(x, out, other):
    """JAX's derivative of max/min(x, other) = out with respect to x:
    1 where x is the result, 0.5 on a tie, 0 where `other` is."""
    return torch.where(x == out, 1.0, 0.0) / torch.where(other == out, 2.0, 1.0)


def _clip_idx(i, hi):
    """jnp.clip(i, 0, hi) of integer tensors; hi an int or a tensor."""
    return torch.minimum(torch.maximum(i, torch.zeros_like(i)), torch.as_tensor(hi))


# ---------------------------------------------------------------------------
# Face selection and projection (texture.py:162-197).
# ---------------------------------------------------------------------------

def cube_faceid(x, y, z):
    """(face, x_major, y_major, z_major, c): the face index (int64; 0 +x,
    1 -x, 2 +y, 3 -y, 4 +z, 5 -z), the major-axis masks and the
    major-axis component. Ties go to z only when |z| is strictly the
    largest, then to y when |y| > |x|."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    z_major = az > torch.maximum(ax, ay)
    y_major = ~z_major & (ay > ax)
    x_major = ~(z_major | y_major)
    c = torch.where(z_major, z, torch.where(y_major, y, x))
    base = torch.where(z_major, 4, torch.where(y_major, 2, 0))
    face = base + (c < 0).long()
    return face, x_major, y_major, z_major, c


def _face_terms(face, x_major, y_major, c, x, y, z):
    """(u_in, v_in, ok, c_safe, m0, m1): the components on the s and t
    axes, |c| > 0, c with 1 where it is 0, and the signed scales."""
    u_in = torch.where(x_major, z, x)
    v_in = torch.where(y_major, z, y)
    ok = c.abs() > 0
    c_safe = torch.where(ok, c, 1.0)
    m = 0.5 / c_safe.abs()
    m0 = torch.where((face == 0) | (face == 5), -m, m)
    m1 = torch.where(face == 2, m, -m)
    return u_in, v_in, ok, c_safe, m0, m1


def cube_project(finfo, x, y, z):
    """(s, t, finite): the face coordinates clipped to [0, 1] and whether
    the lookup is valid (a non-zero, finite direction); s = t = 0 where
    it is not."""
    face, x_major, y_major, _, c = finfo
    u_in, v_in, ok, _, m0, m1 = _face_terms(face, x_major, y_major, c, x, y, z)
    s = u_in * m0 + 0.5
    t = v_in * m1 + 0.5
    finite = ok & torch.isfinite(s) & torch.isfinite(t)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    s = torch.minimum(torch.maximum(torch.where(finite, s, 0.0), zero), one)
    t = torch.minimum(torch.maximum(torch.where(finite, t, 0.0), zero), one)
    return s, t, finite


def cube_project_vjp(x, y, z, gs, gt):
    """Gradient of ``cube_project``'s (s, t) with respect to (x, y, z):
    three [N] tensors from the cotangents gs, gt [N]."""
    face, x_major, y_major, z_major, c = cube_faceid(x, y, z)
    u_in, v_in, ok, c_safe, m0, m1 = _face_terms(face, x_major, y_major, c, x, y, z)
    s_raw = u_in * m0 + 0.5
    t_raw = v_in * m1 + 0.5
    finite = ok & torch.isfinite(s_raw) & torch.isfinite(t_raw)

    def clip_grad(raw, g):
        w = torch.where(finite, raw, 0.0)
        zero = torch.zeros_like(w)
        one = torch.ones_like(w)
        lo = torch.maximum(w, zero)
        out = torch.minimum(lo, one)
        g = g * _tie(lo, out, one) * _tie(w, lo, zero)
        return torch.where(finite, g, 0.0)

    g_s = clip_grad(s_raw, gs)
    g_t = clip_grad(t_raw, gt)
    g_u = g_s * m0
    g_v = g_t * m1
    g_c = -(g_u * u_in + g_v * v_in) / c_safe  # through m = 1/(2|c|)
    return _route(x_major, y_major, z_major, g_u, g_v, g_c)


def _route(x_major, y_major, z_major, g_u, g_v, g_c):
    """(gx, gy, gz) from the cotangents of u_in, v_in and c."""
    gx = torch.where(x_major, g_c, g_u)
    gy = torch.where(y_major, g_c, g_v)
    gz = (torch.where(x_major, g_u, 0.0) + torch.where(y_major, g_v, 0.0)
          + torch.where(z_major, g_c, 0.0))
    return gx, gy, gz


# ---------------------------------------------------------------------------
# Geometric seam wrap (texture.py:199-261).
# ---------------------------------------------------------------------------

def cube_face_direction(face, s, t):
    """Texel (s, t) on `face` -> direction (x, y, z) with |c| = 1; s and
    t may lie outside [0, 1]."""
    du = 2.0 * (s - 0.5)
    dv = 2.0 * (t - 0.5)
    one = torch.ones_like(du)
    xs = torch.stack([one, -one, du, du, du, -du])
    ys = torch.stack([-dv, -dv, one, -one, -dv, -dv])
    zs = torch.stack([-du, du, dv, -dv, one, -one])
    f = face.long()[None]
    return tuple(a.gather(0, f)[0] for a in (xs, ys, zs))


def cube_wrap_texel(face, ix, iy, w):
    """(face', ix', iy', valid) of a texel that may lie one texel outside
    its face: in-face texels pass through, edge overflows land on the
    neighbour face through the cube geometry, diagonal (cube-corner)
    overflows are invalid."""
    ix_out = (ix < 0) | (ix >= w)
    iy_out = (iy < 0) | (iy >= w)
    corner = ix_out & iy_out
    inface = ~(ix_out | iy_out)
    wf = float(w)
    s = (ix.to(torch.float32) + 0.5) / wf
    t = (iy.to(torch.float32) + 0.5) / wf
    dx, dy, dz = cube_face_direction(face, s, t)
    finfo = cube_faceid(dx, dy, dz)
    s2, t2, _ = cube_project(finfo, dx, dy, dz)
    nix = _clip_idx(torch.round(s2 * wf - 0.5).to(torch.int32).long(), w - 1)
    niy = _clip_idx(torch.round(t2 * wf - 0.5).to(torch.int32).long(), w - 1)
    rface = torch.where(inface, face, finfo[0])
    rix = torch.where(inface, _clip_idx(ix, w - 1), nix)
    riy = torch.where(inface, _clip_idx(iy, w - 1), niy)
    return rface, rix, riy, ~corner


# ---------------------------------------------------------------------------
# The kernels' chained-where forms (texture_pallas.py:1165-1257).
# ---------------------------------------------------------------------------

def face_dir_2d(face, s, t):
    """Texel (s, t) on `face` -> direction (chained-where form)."""
    du = 2.0 * (s - 0.5)
    dv = 2.0 * (t - 0.5)
    one = torch.ones_like(du)
    x = torch.where(face == 0, one, torch.where(face == 1, -one,
                                                torch.where(face == 5, -du, du)))
    y = torch.where(face == 2, one, torch.where(face == 3, -one, -dv))
    z = torch.where(face == 0, -du, torch.where(
        face == 1, du, torch.where(face == 2, dv, torch.where(
            face == 3, -dv, torch.where(face == 4, one, -one)))))
    return x, y, z


def faceid_project_2d(x, y, z):
    """Direction -> (face, s, t), unclipped (chained-where form)."""
    face, x_major, y_major, _, c = cube_faceid(x, y, z)
    u_in, v_in, _, _, m0, m1 = _face_terms(face, x_major, y_major, c, x, y, z)
    return face, u_in * m0 + 0.5, v_in * m1 + 0.5


def wrap_corner_2d(face, ix, iy, w):
    """``cube_wrap_texel`` in the kernels' form; w an int or a per-pixel
    int64 tensor. The wrapped texel's index rounds half to even
    (jnp.round; rintf in the kernels)."""
    ix_out = (ix < 0) | (ix >= w)
    iy_out = (iy < 0) | (iy >= w)
    corner = ix_out & iy_out
    inface = ~(ix_out | iy_out)
    wf = w.to(torch.float32) if isinstance(w, torch.Tensor) else float(w)
    s = (ix.to(torch.float32) + 0.5) / wf
    t = (iy.to(torch.float32) + 0.5) / wf
    nface, s2, t2 = faceid_project_2d(*face_dir_2d(face, s, t))
    nix = _clip_idx(torch.round(s2 * wf - 0.5).to(torch.int32).long(), w - 1)
    niy = _clip_idx(torch.round(t2 * wf - 0.5).to(torch.int32).long(), w - 1)
    rface = torch.where(inface, face, nface)
    rix = torch.where(inface, _clip_idx(ix, w - 1), nix)
    riy = torch.where(inface, _clip_idx(iy, w - 1), niy)
    return rface, rix, riy, ~corner


def cube_corner_setup(s, t, face, wl):
    """Bilinear corners on a cube face of size wl (an int, or a per-pixel
    int64 tensor): (rows4, cols4, ok4, fu, fv, w4), the corners in (00,
    10, 01, 11) order as face-combined rows face*wl + iy and columns, the
    validity (0/1 floats; 0 for a missing cube-corner texel), the
    fractions and the bilinear weights without the validity."""
    w = wl.to(torch.float32) if isinstance(wl, torch.Tensor) else float(wl)
    u = s * w - 0.5
    v = t * w - 0.5
    iu0 = torch.floor(u).to(torch.int32).long()
    iv0 = torch.floor(v).to(torch.int32).long()
    fu = u - iu0.to(torch.float32)
    fv = v - iv0.to(torch.float32)
    rows4, cols4, ok4 = [], [], []
    for ix, iy in ((iu0, iv0), (iu0 + 1, iv0), (iu0, iv0 + 1), (iu0 + 1, iv0 + 1)):
        f, x, y, ok = wrap_corner_2d(face, ix, iy, wl)
        rows4.append(f * wl + y)
        cols4.append(x)
        ok4.append(ok.to(torch.float32))
    gu = 1.0 - fu
    gv = 1.0 - fv
    w4 = (gu * gv, fu * gv, gu * fv, fu * fv)
    return tuple(rows4), tuple(cols4), tuple(ok4), fu, fv, w4


# ---------------------------------------------------------------------------
# Footprint Jacobian and its vjp (texture.py:557-613).
# ---------------------------------------------------------------------------

def _st_da_terms(x, y, z, d):
    """Shared forward of the footprint Jacobian. d: 6 columns (dx/dX,
    dx/dY, dy/dX, dy/dY, dz/dX, dz/dY)."""
    face, x_major, y_major, z_major, c = cube_faceid(x, y, z)
    u_in, v_in, ok, c_safe, m0, m1 = _face_terms(face, x_major, y_major, c, x, y, z)
    per_dir = []
    for k in (0, 1):  # X, Y
        dx, dy, dz = d[k], d[2 + k], d[4 + k]
        du = torch.where(x_major, dz, dx)
        dv = torch.where(y_major, dz, dy)
        dc = torch.where(z_major, dz, torch.where(y_major, dy, dx))
        e = dc / c_safe
        a_s = du - u_in * e
        a_t = dv - v_in * e
        per_dir.append((e, a_s, a_t))
    cols = (m0 * per_dir[0][1], m0 * per_dir[1][1], m1 * per_dir[0][2], m1 * per_dir[1][2])
    keep = ok
    for col in cols:
        keep = keep & torch.isfinite(col)
    return (x_major, y_major, z_major, u_in, v_in, c_safe, m0, m1, per_dir), cols, keep


def cube_st_da(x, y, z, d):
    """(ds/dX, ds/dY, dt/dX, dt/dY) [N] of the unclipped face projection
    from the direction's screen derivatives d (6 columns); zeros where
    the lookup is invalid or a column is not finite."""
    _, cols, keep = _st_da_terms(x, y, z, d)
    return tuple(torch.where(keep, col, 0.0) for col in cols)


def cube_st_da_vjp(x, y, z, d, g4):
    """Vjp of ``cube_st_da``: ((gx, gy, gz), g_d [6, N]) from the
    cotangents g4 of its four columns."""
    terms, _, keep = _st_da_terms(x, y, z, d)
    x_major, y_major, z_major, u_in, v_in, c_safe, m0, m1, per_dir = terms
    g_s = (torch.where(keep, g4[0], 0.0), torch.where(keep, g4[1], 0.0))
    g_t = (torch.where(keep, g4[2], 0.0), torch.where(keep, g4[3], 0.0))
    g_u = torch.zeros_like(x)
    g_v = torch.zeros_like(x)
    g_c = torch.zeros_like(x)
    g_m0 = torch.zeros_like(x)
    g_m1 = torch.zeros_like(x)
    g_d = [None] * 6
    for k in (0, 1):
        e, a_s, a_t = per_dir[k]
        gs, gt = g_s[k], g_t[k]
        g_du = gs * m0
        g_dv = gt * m1
        g_e = -(g_du * u_in + g_dv * v_in)
        g_dc = g_e / c_safe
        g_u = g_u - g_du * e
        g_v = g_v - g_dv * e
        g_c = g_c - g_e * e / c_safe
        g_m0 = g_m0 + gs * a_s
        g_m1 = g_m1 + gt * a_t
        gdx, gdy, gdz = _route(x_major, y_major, z_major, g_du, g_dv, g_dc)
        g_d[k], g_d[2 + k], g_d[4 + k] = gdx, gdy, gdz
    g_c = g_c - (g_m0 * m0 + g_m1 * m1) / c_safe  # through m = 1/(2|c|)
    return _route(x_major, y_major, z_major, g_u, g_v, g_c), torch.stack(g_d)
