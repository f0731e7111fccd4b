"""Texture glue of the port: mip pyramid, packing and the mip level (torch).

Counterparts of parts of ``nvdiffrast_tpu/ops/texture.py``: the level
sizes (``_mip_shapes``, with its odd-size rule), the 2x2 box-filter
pyramid (``build_mip_stack``), the flat texel-major packing of all levels
(``_pack_pyramid``, ``_static_meta``), the footprint -> mip level map
(``_mip_level_from_footprint_cols``) and the mode checks. All of it is
plain tensor code on both routes, so the sampler kernel
(``texture_cuda.sample``) and its plain twin read the same pyramid and
the same ``flevel`` bits.
"""

import torch

# Maximum number of mip levels (the reference's texture.h).
MAX_MIP_LEVEL = 16

FILTER_MODES = ("nearest", "linear", "linear-mipmap-nearest",
                "linear-mipmap-linear")
BOUNDARY_MODES = ("cube", "wrap", "clamp", "zero")


def check_modes(filter_mode, boundary_mode):
    """ValueError for an unknown mode; NotImplementedError for the modes
    the port does not have yet (cube maps, nearest filtering)."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}; expected one "
                         f"of {FILTER_MODES}")
    if boundary_mode not in BOUNDARY_MODES:
        raise ValueError(f"unknown boundary_mode {boundary_mode!r}; expected "
                         f"one of {BOUNDARY_MODES}")
    if boundary_mode == "cube":
        raise NotImplementedError(
            "boundary_mode='cube' (cube maps) is not ported yet (ROADMAP A.10)")
    if filter_mode == "nearest":
        raise NotImplementedError(
            "filter_mode='nearest' is not ported yet (ROADMAP A.7)")


def _mip_shapes(h, w, max_levels):
    """Level sizes [(h0, w0), (h1, w1), ...]: each level halves every
    axis that is > 1; an axis that is odd and > 1 cannot be halved."""
    shapes = [(h, w)]
    level = 0
    while (h | w) > 1:
        level += 1
        if (w > 1 and (w & 1)) or (h > 1 and (h & 1)):
            raise ValueError(
                f"mip-map generation failed at level {level}: texture size "
                f"{w}x{h} is not divisible by 2; limit mip level count or "
                f"use power-of-two texture dimensions")
        if w > 1:
            w >>= 1
        if h > 1:
            h >>= 1
        shapes.append((h, w))
        if max_levels >= 0 and level == max_levels:
            break
        if level >= MAX_MIP_LEVEL:
            break
    return shapes


def _downsample2x(x):
    """One mip level of [D, h, w, C]: 2x2 box filter, 2x1 / 1x2 where an
    axis is 1. The sum runs in a fixed order, the same on every device."""
    D, h, w, C = x.shape
    if h > 1 and w > 1:
        x = x.reshape(D, h // 2, 2, w // 2, 2, C)
        s = ((x[:, :, 0, :, 0] + x[:, :, 0, :, 1]) + x[:, :, 1, :, 0]) + x[:, :, 1, :, 1]
        return s * 0.25
    if h > 1:
        x = x.reshape(D, h // 2, 2, w, C)
        return (x[:, :, 0] + x[:, :, 1]) * 0.5
    x = x.reshape(D, h, w // 2, 2, C)
    return (x[..., 0, :] + x[..., 1, :]) * 0.5


def build_mip_stack(tex, max_mip_level=-1):
    """Mip levels 1.. of a 2-D texture [D, h, w, C] (the base not
    included; empty when the texture is 1x1 or max_mip_level is 0)."""
    shapes = _mip_shapes(int(tex.shape[-3]), int(tex.shape[-2]), max_mip_level)
    levels = []
    cur = tex
    for _ in shapes[1:]:
        cur = _downsample2x(cur)
        levels.append(cur)
    return levels


def _pack_pyramid(levels):
    """All levels as one flat texel-major [n_texels, C] buffer: level l's
    [D, h, w] texels start at its offset (``_static_meta``)."""
    C = levels[0].shape[-1]
    return torch.cat([lvl.reshape(-1, C) for lvl in levels], dim=0).contiguous()


def _static_meta(levels):
    """(((offset, h, w) per level), n_texels) as Python ints; offsets
    count the texels of the whole [D, h, w] block of each level."""
    meta = []
    off = 0
    for lvl in levels:
        h, w = int(lvl.shape[-3]), int(lvl.shape[-2])
        meta.append((off, h, w))
        n = 1
        for s in lvl.shape[:-1]:
            n *= int(s)
        off += n
    return tuple(meta), off


def _mip_level_from_footprint_cols(da0, da1, da2, da3, tex_w, tex_h):
    """Mip level of each pixel from its uv pixel derivatives
    (du/dx, du/dy, dv/dx, dv/dy): half the log2 of the footprint's major
    axis squared, floored at 1e-38; NaN -> 0."""
    dsdx = da0 * tex_w
    dsdy = da1 * tex_w
    dtdx = da2 * tex_h
    dtdy = da3 * tex_h
    A = dsdx * dsdx + dtdx * dtdx
    B = dsdy * dsdy + dtdy * dtdy
    C = dsdx * dsdy + dtdx * dtdy
    l2b = 0.5 * (A + B)
    l2n = 0.25 * (A - B) * (A - B) + C * C
    l2a = torch.sqrt(l2n)
    len_major_sqr = torch.clamp(l2b + l2a, min=1e-38)
    flevel = 0.5 * torch.log2(len_major_sqr)
    return torch.where(torch.isnan(flevel), 0.0, flevel)


def mip_level(da, tex_h, tex_w, L):
    """flevel [N] from da [4, N], clipped to [0, L-1] (pipeline_tex.py)."""
    fl = _mip_level_from_footprint_cols(da[0], da[1], da[2], da[3],
                                        float(tex_w), float(tex_h))
    return torch.clamp(fl, 0.0, float(L - 1))


# float32 log(2), the divisor of jnp.log2.
_LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32).item()


def _tie(x, out, other):
    """JAX's derivative of max/min(x, other) = out with respect to x:
    1 where x is the result, 0.5 on a tie, 0 where `other` is."""
    return torch.where(x == out, 1.0, 0.0) / torch.where(other == out, 2.0, 1.0)


def mip_level_vjp(da, gfl, tex_h, tex_w, L):
    """Gradient of ``mip_level`` with respect to da: [4, N] from gfl [N].

    Written by hand in the order of JAX's reverse pass over
    ``clip(_mip_level_from_footprint_cols(...), 0, L-1)``
    (``pipeline_tex.py:166-175`` of the JAX package), with its rules:
    the square root's derivative is 0 where its argument is 0
    (``_sqrt_grad_safe``; torch's would be inf and turn every background
    pixel into NaN), and max/min pass half the gradient on a tie (at
    flevel = 0, at L-1 and at the 1e-38 floor), where torch.clamp would
    pass all of it.
    """
    tw, th = float(tex_w), float(tex_h)
    dsdx, dsdy = da[0] * tw, da[1] * tw
    dtdx, dtdy = da[2] * th, da[3] * th
    A = dsdx * dsdx + dtdx * dtdx
    B = dsdy * dsdy + dtdy * dtdy
    Cc = dsdx * dsdy + dtdx * dtdy
    l2b = 0.5 * (A + B)
    t7 = 0.25 * (A - B)
    l2n = t7 * (A - B) + Cc * Cc
    l2a = torch.sqrt(l2n)
    s = l2b + l2a
    floor = torch.full_like(s, 1e-38)
    lms = torch.maximum(s, floor)
    fl0 = 0.5 * torch.log2(lms)
    nan = torch.isnan(fl0)
    fl1 = torch.where(nan, 0.0, fl0)
    zero = torch.zeros_like(fl1)
    top = torch.full_like(fl1, float(L - 1))
    y = torch.maximum(zero, fl1)       # jnp.clip: minimum(hi, maximum(lo, x))
    z = torch.minimum(top, y)

    g = gfl * _tie(y, z, top)
    g = g * _tie(fl1, y, zero)
    g = torch.where(nan, 0.0, g)
    g = ((0.5 * g) / _LN2) / lms       # 0.5 * log(x) / log(2)
    g_s = g * _tie(s, lms, floor)
    coef = torch.where(l2n > 0, 0.5 / torch.clamp(l2a, min=1e-30), 0.0)
    g_l2n = coef * g_s
    g_C = g_l2n * Cc + g_l2n * Cc
    g_D2 = t7 * g_l2n                   # the second (A - B)
    g_D1 = 0.25 * (g_l2n * (A - B))     # the first, through t7
    g_s1 = 0.5 * g_s                    # l2b = 0.5 * (A + B)
    g_A = (g_D2 + g_D1) + g_s1
    g_B = ((-g_D2) + (-g_D1)) + g_s1
    g_dtdy = (dtdx * g_C + dtdy * g_B) + g_B * dtdy
    g_dtdx = (g_C * dtdy + dtdx * g_A) + g_A * dtdx
    g_dsdy = (dsdx * g_C + dsdy * g_B) + g_B * dsdy
    g_dsdx = (g_C * dsdy + dsdx * g_A) + g_A * dsdx
    return torch.stack([g_dsdx * tw, g_dsdy * tw, g_dtdx * th, g_dtdy * th])


def pyramid_vjp(g_flat, meta, D, C):
    """Gradient of the base texture [D, h0, w0, C] from the gradient of
    the packed pyramid g_flat [n_texels, C] (the adjoint of
    ``build_mip_stack`` + ``_pack_pyramid``).

    Coarsest level first: each level's own gradient plus its parent's,
    spread to the 2x2 children with weight 0.25 (2x1 / 1x2 children with
    0.5 where an axis is 1); the same fixed order on every device.
    """
    levels = [g_flat[off:off + D * h * w].reshape(D, h, w, C)
              for off, h, w in meta]
    acc = levels[-1]
    for lvl in reversed(levels[:-1]):
        h, w = lvl.shape[1], lvl.shape[2]
        if h > 1 and w > 1:
            up = acc.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.25
        elif h > 1:
            up = acc.repeat_interleave(2, dim=1) * 0.5
        else:
            up = acc.repeat_interleave(2, dim=2) * 0.5
        acc = lvl + up
    return acc
