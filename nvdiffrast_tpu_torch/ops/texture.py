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
