"""Texture op of the port: mip pyramid, packing, the mip level and
``texture`` (torch).

Counterparts of ``nvdiffrast_tpu/ops/texture.py``: the level sizes
(``_mip_shapes``, with its odd-size rule), the 2x2 box-filter pyramid of
2-D and cube textures (``build_mip_stack``, ``TextureMipWrapper``,
``texture_construct_mip``), the flat texel-major packing of all levels
(``_pack_pyramid``, ``_static_meta``), the footprint -> mip level map
(``_mip_level_from_footprint_cols``) and its vjp, the mode checks, and
the public op ``texture`` (``_texture_impl``) as a
``torch.autograd.Function`` with a hand-written backward. Its kernels:
the 2-D sampler B11 (``texture_cuda.sample``), its uv / level backward
(``texture_bwd_cuda.texture_bwd``) and texture gradient B13
(``texture_bwd_cuda.texture_grad``); the cube sampler B12 and its
backward (``texture_cube_cuda``), whose tiles pass also pre-reduces the
cube texture gradient per screen tile (``texture_cube_cuda.cube_grads``:
(gs, gt, gfl) and the gradient from one pass); the mip level and its
vjp, one kernel each way (``mip_level``, ``level_vjp``;
``csrc/mip_level.cu``), whose plain twins ``mip_level_plain`` and
``level_vjp_plain`` give the same bits on the card.
``filter_mode='nearest'`` is tensor glue, as the JAX package's XLA-only
``_sample_nearest``. Textures of more than 8 channels run in groups of 8
through the same kernels. The pyramid and the cube glue
(``texture_cube``) are plain tensor code on both routes, so a kernel and
its plain twin read the same bits.
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import span, spanned
from .texture_cuda import check_level_args, launch_level_vjp, launch_mip_level

# Maximum number of mip levels (the reference's texture.h).
MAX_MIP_LEVEL = 16

FILTER_MODES = ("nearest", "linear", "linear-mipmap-nearest",
                "linear-mipmap-linear")
BOUNDARY_MODES = ("cube", "wrap", "clamp", "zero")


def check_modes(filter_mode, boundary_mode):
    """ValueError for an unknown mode."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}; expected one "
                         f"of {FILTER_MODES}")
    if boundary_mode not in BOUNDARY_MODES:
        raise ValueError(f"unknown boundary_mode {boundary_mode!r}; expected "
                         f"one of {BOUNDARY_MODES}")


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


def build_mip_stack(tex, max_mip_level=-1, cube_mode=False):
    """Mip levels 1.. of a 2-D texture [D, h, w, C] or a cube map
    [D, 6, w, w, C], whose faces must be square and downsample each on
    its own (the base not included; empty when the texture is 1x1 or
    max_mip_level is 0)."""
    h, w = int(tex.shape[-3]), int(tex.shape[-2])
    if cube_mode and h != w:
        raise ValueError("cube map faces must be square")
    shapes = _mip_shapes(h, w, max_mip_level)
    lead = tuple(tex.shape[:-3])
    levels = []
    cur = tex.reshape((-1,) + tuple(tex.shape[-3:]))
    for _ in shapes[1:]:
        cur = _downsample2x(cur)
        levels.append(cur.reshape(lead + tuple(cur.shape[1:])))
    return levels


class TextureMipWrapper:
    """Opaque mipmap stack: the constructed level tensors (the base not
    included) and how they were made. Levels built from a tensor that
    requires grad keep their autograd history, so gradients reach it."""

    def __init__(self, levels=None, max_mip_level=-1, cube_mode=False):
        self.levels = list(levels) if levels is not None else []
        self.max_mip_level = int(max_mip_level)
        self.cube_mode = bool(cube_mode)


def texture_construct_mip(tex, max_mip_level=None, cube_mode=False):
    """Construct a mipmap stack for a texture (the JAX package's
    ``texture_construct_mip``).

    Args:
        tex: texture tensor with the same constraints as in ``texture``;
            a tensor stays on its device, anything else goes to the
            default CUDA device.
        max_mip_level: if given (>= 0), limits the number of levels built.
        cube_mode: must be True for cube map textures.

    Returns:
        A ``TextureMipWrapper`` usable as the ``mip`` argument of
        ``texture``.
    """
    from .rasterize import as_device_tensor

    if cube_mode is not True and cube_mode is not False:
        raise ValueError("texture_construct_mip: cube_mode must be True or False")
    tex = as_device_tensor(tex, "texture_construct_mip").to(torch.float32)
    if max_mip_level is None:
        max_mip_level = -1
    elif int(max_mip_level) < 0:
        raise ValueError("texture_construct_mip: max_mip_level must be >= 0 or None")
    levels = build_mip_stack(tex, int(max_mip_level), cube_mode)
    return TextureMipWrapper(levels, max_mip_level, cube_mode)


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


@spanned("nvdr.tex.level")
def mip_level(da, tex_h, tex_w, L, bias=None):
    """flevel [N] = clamp(footprint(da) [+ bias], 0, L-1) from da [4, N]
    (any strides) and/or bias [N]; either may be None, not both (no
    footprint: the level is the bias alone). CPU tensors run
    ``mip_level_plain``, CUDA tensors the kernel
    (``texture_cuda.launch_mip_level``), bit for bit the twin's on the
    card; ValueError for other tensors."""
    col = da if da is not None else bias
    if col is not None and col.device.type == "cpu":
        return mip_level_plain(da, tex_h, tex_w, L, bias)
    return launch_mip_level(da, bias, tex_h, tex_w, L)


def mip_level_plain(da, tex_h, tex_w, L, bias=None):
    """Plain PyTorch twin of the mip level kernel (``mip_level``)."""
    check_level_args(da, bias)
    if da is not None:
        fl = _mip_level_from_footprint_cols(da[0], da[1], da[2], da[3],
                                            float(tex_w), float(tex_h))
    else:
        fl = torch.zeros(bias.shape, dtype=torch.float32, device=bias.device)
    if bias is not None:
        fl = fl + bias
    return torch.clamp(fl, 0.0, float(L - 1))


# float32 log(2), the divisor of jnp.log2.
_LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32).item()


def _tie(x, out, other):
    """JAX's derivative of max/min(x, other) = out with respect to x:
    1 where x is the result, 0.5 on a tie, 0 where `other` is."""
    return torch.where(x == out, 1.0, 0.0) / torch.where(other == out, 2.0, 1.0)


@spanned("nvdr.tex.level_vjp")
def level_vjp(da, gfl, tex_h, tex_w, L, bias=None):
    """Vjp of the mip level clip(footprint(da) + bias, 0, L-1): (g_da
    [4, N] or None when da is None, g_bias [N] or None when bias is None
    and da is not) from gfl [N]; either of da and bias may be None, not
    both (no footprint: the level is the bias alone). CPU tensors run
    ``level_vjp_plain``, CUDA tensors the kernel
    (``texture_cuda.launch_level_vjp``), bit for bit the twin's on the
    card; ValueError for other tensors."""
    if gfl.device.type == "cpu":
        return level_vjp_plain(da, gfl, tex_h, tex_w, L, bias)
    return launch_level_vjp(da, gfl, bias, tex_h, tex_w, L)


def level_vjp_plain(da, gfl, tex_h, tex_w, L, bias=None):
    """Plain PyTorch twin of the level vjp kernel (``level_vjp``).

    Written by hand in the order of JAX's reverse pass over
    ``clip(_mip_level_from_footprint_cols(...), 0, L-1)``
    (``pipeline_tex.py:166-175`` of the JAX package), with its rules:
    the square root's derivative is 0 where its argument is 0
    (``_sqrt_grad_safe``; torch's would be inf and turn every background
    pixel into NaN), and max/min pass half the gradient on a tie (at
    flevel = 0, at L-1 and at the 1e-38 floor), where torch.clamp would
    pass all of it.
    """
    check_level_args(da, bias, gfl)
    if da is not None:
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
        fl = torch.where(nan, 0.0, fl0)
    else:
        fl = torch.zeros_like(gfl)
    if bias is not None:
        fl = fl + bias
    zero = torch.zeros_like(fl)
    top = torch.full_like(fl, float(L - 1))
    y = torch.maximum(zero, fl)       # jnp.clip: minimum(hi, maximum(lo, x))
    z = torch.minimum(top, y)

    g = gfl * _tie(y, z, top)
    g = g * _tie(fl, y, zero)
    if da is None:
        return None, g
    g_bias = g if bias is not None else None
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
    return torch.stack([g_dsdx * tw, g_dsdy * tw, g_dtdx * th, g_dtdy * th]), g_bias


@spanned("nvdr.tex.pyramid_vjp")
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


# ---------------------------------------------------------------------------
# The op (texture.py:620-816 of the JAX package).
# ---------------------------------------------------------------------------

def _nearest_taps(meta, uv, tz, boundary_mode, cube):
    """Texel [N] int64 and validity [N] of nearest filtering at the base
    level (``_sample_nearest``)."""
    from .texture_cube import cube_faceid, cube_project

    off, h, w = meta[0]
    if cube:
        x, y, z = uv.unbind(1)
        finfo = cube_faceid(x, y, z)
        s, t, valid = cube_project(finfo, x, y, z)
        iu = torch.clamp(torch.floor(s * float(w)).to(torch.int32).long(), 0, w - 1)
        iv = torch.clamp(torch.floor(t * float(h)).to(torch.int32).long(), 0, h - 1)
        return off + ((tz * 6 + finfo[0]) * h + iv) * w + iu, valid
    u, v = uv.unbind(1)
    if boundary_mode == "wrap":
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    iu = torch.floor(u * float(w)).to(torch.int32).long()
    iv = torch.floor(v * float(h)).to(torch.int32).long()
    valid = torch.ones_like(iu, dtype=torch.bool)
    if boundary_mode == "zero":
        valid = (iu >= 0) & (iu < w) & (iv >= 0) & (iv < h)
    iu = torch.clamp(iu, 0, w - 1)
    iv = torch.clamp(iv, 0, h - 1)
    return off + (tz * h + iv) * w + iu, valid


def _texture_fwd(spec, tex, uv, uv_da, bias, mips):
    """Forward of ``texture``: (image [B, H, W, C], saved tensors)."""
    from .texture_cube import cube_faceid, cube_project, cube_st_da
    from .antialias import channel_groups
    from .texture_cube_cuda import sample_cube
    from .texture_cuda import MAX_C, sample

    filter_mode, boundary_mode, max_mip_level, use_mip = spec
    cube = boundary_mode == "cube"
    B, H, W = uv.shape[:3]
    N = B * H * W
    D, C = tex.shape[0], tex.shape[-1]
    uvf = uv.reshape(N, uv.shape[-1])
    with span("nvdr.tex.pyramid"):
        if use_mip and not mips:
            mips = build_mip_stack(tex, max_mip_level, cube)
        levels = [tex] + list(mips if use_mip else ())
        meta, _ = _static_meta(levels)
        L = len(levels)
        flat = _pack_pyramid(levels)
    tz = (torch.arange(N, device=uv.device) // (H * W) if D > 1
          else torch.zeros(N, dtype=torch.int64, device=uv.device))

    # Mip level: the footprint (of the face coordinates for cube maps)
    # plus the bias, clipped to the levels there are.
    d = uv_da.reshape(N, uv_da.shape[-1]).T if uv_da is not None else None
    da = None
    if use_mip:
        if d is not None:
            da = torch.stack(cube_st_da(*uvf.unbind(1), d)) if cube else d
        flevel = mip_level(da, tex.shape[-3], tex.shape[-2], L,
                           None if bias is None else bias.reshape(N))
    else:
        flevel = torch.zeros(N, dtype=torch.float32, device=uv.device)

    cols = ()
    if filter_mode == "nearest":
        idx, valid = _nearest_taps(meta, uvf, tz, boundary_mode, cube)
        out = torch.where(valid, flat[idx].T, 0.0)
    elif cube:
        x, y, z = uvf.unbind(1)
        finfo = cube_faceid(x, y, z)
        s, t, finite = cube_project(finfo, x, y, z)
        cols = (s, t, flevel) + tuple(a.to(torch.int32) for a in (finite, finfo[0], tz))
        out = torch.cat([sample_cube(flat[:, a:b].contiguous(), cols, meta, filter_mode,
                                     (B, H, W)) for a, b in channel_groups(C, MAX_C)])
    else:
        out = torch.cat([sample(flat[:, a:b].contiguous(), uvf[:, 0], uvf[:, 1], flevel,
                                meta, (B, H, W), D > 1, boundary_mode, filter_mode)
                         for a, b in channel_groups(C, MAX_C)])
    return out.T.reshape(B, H, W, C), (flat, uvf, d, da, flevel, tz) + cols, meta


def _texture_bwd(spec, meta, saved, shapes, bias, needs, dy):
    """(g_tex, g_uv, g_uv_da, g_bias, g_mips) from the image cotangent dy
    [B, H, W, C]; a gradient not in `needs` is None."""
    from .antialias import channel_groups
    from .scatter import scatter_add_by_id
    from .texture_bwd_cuda import texture_bwd, texture_grad
    from .texture_cube import cube_project_vjp, cube_st_da_vjp
    from .texture_cube_cuda import cube_grads
    from .texture_cuda import MAX_C

    filter_mode, boundary_mode, _, use_mip = spec
    flat, uvf, d, da, flevel, tz, *cols = saved
    tex_shape, uv_shape, mip_shapes = shapes
    cube = boundary_mode == "cube"
    B, H, W = uv_shape[:3]
    N = B * H * W
    C = tex_shape[-1]
    D = tex_shape[0]
    n_tex = flat.shape[0]
    gc = dy.reshape(N, C).T.contiguous()
    groups = channel_groups(C, MAX_C)
    g_tex = g_uv = g_da = g_bias = None
    g_mips = [None] * len(mip_shapes)
    want_tex = needs[0] or any(needs[4:])
    if cube and filter_mode != "nearest":  # both gradients from one pass per group
        cube_parts = [cube_grads(flat[:, a:b], tuple(cols), gc[a:b], meta, n_tex, filter_mode,
                                 (B, H, W), uv=any(needs[1:4]), tex=want_tex)
                      for a, b in groups]

    # Texture gradient: to the base texture through the pyramid, or to the
    # level tensors the caller passed.
    if want_tex:
        if filter_mode == "nearest":
            idx, valid = _nearest_taps(meta, uvf, tz, boundary_mode, cube)
            g_flat = scatter_add_by_id(torch.where(valid, idx, -1).to(torch.int32), gc, n_tex)
        elif cube:
            g_flat = torch.cat([part[1] for part in cube_parts], dim=1)
        else:
            g_flat = torch.cat([texture_grad(uvf[:, 0], uvf[:, 1], flevel, gc[a:b], meta,
                                             n_tex, (B, H, W), D > 1, boundary_mode,
                                             filter_mode) for a, b in groups], dim=1)
        if mip_shapes:
            parts = torch.split(g_flat, [int(torch.Size(sh[:-1]).numel())
                                         for sh in (tex_shape,) + mip_shapes])
            g_tex = parts[0].reshape(tex_shape)
            g_mips = [p.reshape(sh) for p, sh in zip(parts[1:], mip_shapes)]
        else:
            g_tex = pyramid_vjp(g_flat, meta, D * (6 if cube else 1), C).reshape(tex_shape)
    if not any(needs[1:4]):
        return g_tex, g_uv, g_da, g_bias, g_mips
    if filter_mode == "nearest":  # piecewise constant in uv
        g_uv = torch.zeros(uv_shape, dtype=torch.float32, device=gc.device)
        if d is not None:
            g_da = torch.zeros_like(d.T).reshape(uv_shape[:3] + (d.shape[0],))
        if bias is not None:
            g_bias = torch.zeros_like(bias)
        return g_tex, g_uv, g_da, g_bias, g_mips

    # Gradients to the sampling coordinates and the level, summed over the
    # channel groups in order.
    g3 = None
    for i, (a, b) in enumerate(groups):
        if cube:
            part = cube_parts[i][0]
        else:
            part = texture_bwd(flat[:, a:b].contiguous(), uvf[:, 0], uvf[:, 1], flevel,
                               gc[a:b].contiguous(), meta, (B, H, W), D > 1, boundary_mode,
                               filter_mode)
        g3 = part if g3 is None else tuple(x + y for x, y in zip(g3, part))
    gs, gt, gfl = g3
    xyz = uvf.unbind(1)
    g_cols = list(cube_project_vjp(*xyz, gs, gt)) if cube else [gs, gt]
    g_d = None
    if use_mip:
        g_da4, g_b = level_vjp(da, gfl, tex_shape[-3], tex_shape[-2], len(meta),
                               None if bias is None else bias.reshape(N))
        if bias is not None:
            g_bias = g_b.reshape(bias.shape)
        if d is not None:
            if cube:
                g_xyz, g_d = cube_st_da_vjp(*xyz, d, g_da4)
                g_cols = [g + h for g, h in zip(g_cols, g_xyz)]
            else:
                g_d = g_da4
    elif bias is not None:
        g_bias = torch.zeros_like(bias)
    if d is not None:
        g_da = (g_d.T if g_d is not None else torch.zeros_like(d.T))
        g_da = g_da.reshape(uv_shape[:3] + (d.shape[0],))
    g_uv = torch.stack(g_cols, dim=1).reshape(uv_shape)
    return g_tex, g_uv, g_da, g_bias, g_mips


class _TextureFn(torch.autograd.Function):
    """texture with its hand-written backward."""

    @staticmethod
    def forward(ctx, spec, tex, uv, uv_da, bias, *mips):
        img, saved, meta = _texture_fwd(spec, tex, uv, uv_da, bias, mips)
        saved = saved + (bias,)
        ctx.present = [x is not None for x in saved]
        ctx.save_for_backward(*[x for x in saved if x is not None])
        ctx.spec, ctx.meta = spec, meta
        ctx.shapes = (tuple(tex.shape), tuple(uv.shape), tuple(tuple(m.shape) for m in mips))
        return img

    @staticmethod
    @once_differentiable
    @spanned("nvdr.texture.bwd")
    def backward(ctx, dy):
        it = iter(ctx.saved_tensors)
        saved = [next(it) if p else None for p in ctx.present]
        bias = saved.pop()
        grads = _texture_bwd(ctx.spec, ctx.meta, saved, ctx.shapes, bias,
                             ctx.needs_input_grad[1:], dy.contiguous())
        return (None,) + grads[:4] + tuple(grads[4])


def _on_device(x, dev, what):
    """`x` as float32 on `dev`: a tensor on another device raises
    ValueError (no quiet copy between host and card); anything else is
    put there."""
    if isinstance(x, torch.Tensor) and x.device != dev:
        raise ValueError(f"texture: {what} is on {x.device} but uv is on {dev}")
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@spanned("nvdr.texture")
def texture(tex, uv, uv_da=None, mip_level_bias=None, mip=None, filter_mode="auto",
            boundary_mode="wrap", max_mip_level=None):
    """Perform texture sampling (the JAX package's ``texture``).

    Args:
        tex: float32 texture [D, tex_height, tex_width, C], or a cube map
            [D, 6, w, w, C] with boundary_mode='cube'; D = 1 or the
            minibatch size.
        uv: [minibatch, height, width, 2] texture coordinates, or [..., 3]
            directions for cube maps. A tensor runs on its device (CPU
            tensors on the plain twins); anything else is put on the
            default CUDA device, and raises RuntimeError where there is
            none. Tensor arguments on another device than uv raise
            ValueError.
        uv_da: optional screen derivatives of uv [..., 4] (cube: [..., 6]),
            for the mip level.
        mip_level_bias: optional per-pixel level bias [minibatch, height,
            width]; used alone it selects the level.
        mip: optional ``TextureMipWrapper`` from ``texture_construct_mip``,
            or a list of level tensors (the base not included), which then
            receive the gradients instead of `tex`.
        filter_mode: 'auto', 'nearest', 'linear', 'linear-mipmap-nearest'
            or 'linear-mipmap-linear'.
        boundary_mode: 'wrap', 'clamp', 'zero' or 'cube'.
        max_mip_level: limit on the levels built; None or -1 for all, 0
            drops the mip filters to 'linear'.

    Returns:
        [minibatch, height, width, C]; differentiable with respect to tex
        (or the mip levels), uv, uv_da and mip_level_bias. Cube-map
        lookups with an invalid direction (a zero vector) return zeros and
        pass no gradient.
    """
    from .rasterize import as_device_tensor

    if filter_mode == "auto":
        filter_mode = ("linear-mipmap-linear"
                       if (uv_da is not None or mip_level_bias is not None) else "linear")
    check_modes(filter_mode, boundary_mode)
    max_mip_level = -1 if max_mip_level is None else int(max_mip_level)
    if max_mip_level < -1:
        raise ValueError(f"texture: max_mip_level {max_mip_level} < -1")
    uv = as_device_tensor(uv, "texture")
    dev = uv.device
    tex = _on_device(tex, dev, "tex")
    uv = uv.to(torch.float32)
    cube = boundary_mode == "cube"
    if cube:
        if tex.ndim != 5 or tex.shape[1] != 6:
            raise ValueError("texture: cube map texture must have shape [>0, 6, >0, >0, >0]")
        if tex.shape[2] != tex.shape[3]:
            raise ValueError("texture: cube map texture must have square faces")
        if uv.shape[-1] != 3:
            raise ValueError("texture: cube map sampling requires 3-channel uv")
    else:
        if tex.ndim != 4:
            raise ValueError("texture: texture must have shape [>0, >0, >0, >0]")
        if uv.shape[-1] != 2:
            raise ValueError("texture: 2-D texture sampling requires 2-channel uv")
    if uv.ndim != 4:
        raise ValueError(f"texture: uv must be [minibatch, height, width, {uv.shape[-1]}]; "
                         f"got {tuple(uv.shape)}")
    if tex.shape[0] not in (1, uv.shape[0]):
        raise ValueError("texture: texture minibatch size must be 1 or match uv")
    use_mip = "mipmap" in filter_mode
    if use_mip and uv_da is None and mip_level_bias is None:
        raise ValueError("texture: mipmap filter modes require uv_da and/or mip_level_bias")
    if max_mip_level == 0 and use_mip:
        filter_mode, use_mip = "linear", False
    if uv_da is not None:
        uv_da = _on_device(uv_da, dev, "uv_da")
        if uv_da.shape != uv.shape[:3] + (6 if cube else 4,):
            raise ValueError(f"texture: uv_da must be {tuple(uv.shape[:3])} + "
                             f"({6 if cube else 4},); got {tuple(uv_da.shape)}")
    if mip_level_bias is not None:
        mip_level_bias = _on_device(mip_level_bias, dev, "mip_level_bias")
        if mip_level_bias.numel() != uv.shape[:3].numel():
            raise ValueError("texture: mip_level_bias must be [minibatch, height, width]")
    mips = ()
    if use_mip and mip is not None:
        if isinstance(mip, TextureMipWrapper):
            mips = tuple(mip.levels)
        elif isinstance(mip, (list, tuple)):
            mips = tuple(mip)
        else:
            raise TypeError("texture: mip must be a TextureMipWrapper or a list of tensors")
        mips = tuple(_on_device(m, dev, "a mip level") for m in mips)
        for m in mips:
            if m.ndim != tex.ndim or m.shape[0] != tex.shape[0] or m.shape[-1] != tex.shape[-1]:
                raise ValueError(f"texture: mip level {tuple(m.shape)} does not fit the "
                                 f"texture {tuple(tex.shape)}")
    spec = (filter_mode, boundary_mode, max_mip_level, use_mip)
    return _TextureFn.apply(spec, tex, uv, uv_da, mip_level_bias, *mips)
