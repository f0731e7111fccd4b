"""Texture sampler forward and the mip level: CUDA kernels (torch).

Counterpart of ``nvdiffrast_tpu/ops/texture_pallas.py`` (``_call_sampler``
in mode ``"fwd"``, as ``sample_fused`` calls it) for 2-D textures. The
kernel ``csrc/texture_fwd.cu`` (``sample``) samples the flat-packed mip
pyramid of ``ops/texture.py`` at per-pixel (u, v, flevel) with the
linear, linear-mipmap-nearest and linear-mipmap-linear filters and the
wrap, clamp and zero boundaries; ``sample_plain`` is its plain PyTorch
twin with the same arithmetic (``corner_setup`` and ``level_weights``).

``csrc/mip_level.cu`` computes the level those filters read and its
vjp, one pass a pixel each way (``launch_mip_level``,
``launch_level_vjp``); ``texture.mip_level`` and ``texture.level_vjp``
launch them for CUDA tensors, and their plain twins
(``texture.mip_level_plain``, ``texture.level_vjp_plain``) run the
same arithmetic as tensor ops.
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import spanned

MAX_C = 8          # channels served by the kernel (texture_pallas._MAX_CHANNELS)
MAX_LEVELS = 17    # texture.MAX_MIP_LEVEL + the base level
BOUNDARY = {"wrap": 0, "clamp": 1, "zero": 2}
FILTER = {"linear": 0, "linear-mipmap-nearest": 1, "linear-mipmap-linear": 2}

KERNEL = _build.Kernel(
    "nvdr_texture_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8)
LEVEL_KERNEL = _build.Kernel(
    "nvdr_mip_level",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 4)
LEVEL_VJP_KERNEL = _build.Kernel(
    "nvdr_level_vjp",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4)


def _check(flat, u, v, flevel, meta, shape, per_image, boundary_mode,
           filter_mode):
    B, H, W = shape
    N = B * H * W
    n_tex, C = flat.shape
    L = len(meta)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sample: {C} channels; the sampler serves 1 to {MAX_C}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"sample: {L} levels; at most {MAX_LEVELS}")
    if boundary_mode not in BOUNDARY or filter_mode not in FILTER:
        raise ValueError(f"sample: unsupported modes {filter_mode!r}, "
                         f"{boundary_mode!r}")
    D = B if per_image else 1
    for off, h, w in meta:
        if off < 0 or off + D * h * w > n_tex:
            raise ValueError(f"sample: level ({off}, {h}, {w}) of {D} "
                             f"textures outside the {n_tex}-texel pyramid")
    if n_tex * C >= 2 ** 31:
        raise ValueError("sample: pyramid of 2**31 floats or more")
    if any(t.shape != (N,) for t in (u, v, flevel)):
        raise ValueError(f"sample: u, v, flevel must be flat [{N}]")
    if any(t.dtype != torch.float32 or t.device != flat.device
           for t in (flat, u, v, flevel)):
        raise ValueError("sample: expects float32 tensors on one device")
    return C, N, L


@spanned("nvdr.tex.sample")
def sample(flat, u, v, flevel, meta, shape, per_image, boundary_mode,
           filter_mode):
    """Filtered texture samples [C, N].

    Args:
      flat: [n_texels, C] texel-major pyramid (texture._pack_pyramid).
      u, v, flevel: flat [N] per-pixel uv and mip level, N = B*H*W
        (flevel is not read by filter_mode='linear').
      meta: ((offset, h, w), ...) per level (texture._static_meta).
      shape: (B, H, W); per_image: image b samples texture b (D = B),
        else texture 0 (D = 1).

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.
    """
    if flat.device.type == "cpu":
        return sample_plain(flat, u, v, flevel, meta, shape, per_image,
                            boundary_mode, filter_mode)
    if flat.device.type != "cuda":
        raise ValueError(f"sample: unsupported device {flat.device}")
    C, N, L = _check(flat, u, v, flevel, meta, shape, per_image,
                     boundary_mode, filter_mode)
    B, H, W = shape
    flat = flat.contiguous()
    u, v, flevel = (t.contiguous() for t in (u, v, flevel))
    out = torch.empty((C, N), dtype=torch.float32, device=flat.device)
    m = (ctypes.c_int * (3 * L))(*(x for lev in meta for x in lev))
    KERNEL.launch(flat.device, _build.ptr(flat), _build.ptr(u), _build.ptr(v),
                  _build.ptr(flevel), _build.ptr(out), ctypes.cast(m, ctypes.c_void_p),
                  B, H, W, C, L, int(bool(per_image)), BOUNDARY[boundary_mode],
                  FILTER[filter_mode])
    return out


def level_tables(meta, shape, per_image, device):
    """(offs, hs, ws) int64 [L] level tables and tz [N], the texture
    each pixel samples (its image's for per_image, else texture 0)."""
    B, H, W = shape
    N = B * H * W
    offs, hs, ws = (torch.tensor([m[i] for m in meta], dtype=torch.int64,
                                 device=device) for i in range(3))
    tz = (torch.arange(N, device=device) // (H * W) if per_image
          else torch.zeros(N, dtype=torch.int64, device=device))
    return offs, hs, ws, tz


def level_weights(flevel, L, filter_mode):
    """Per-pixel (l0, l1, frac): the level pair and the blend weight."""
    if filter_mode == "linear":
        z = torch.zeros(flevel.shape, dtype=torch.int64, device=flevel.device)
        return z, z, torch.zeros_like(flevel)
    l0 = torch.clamp(torch.floor(flevel).to(torch.int32), 0, L - 1).long()
    if filter_mode == "linear-mipmap-nearest":
        return l0, l0, torch.zeros_like(flevel)
    l1 = torch.clamp(l0 + 1, max=L - 1)
    return l0, l1, flevel - l0.to(torch.float32)


def _level_value(flat, base, hl, wl, u, v, boundary_mode):
    """Bilinear value [C, N] at per-pixel level dims hl, wl (int64) and
    texel base (corner_setup and the corner gather)."""
    q, _, _, w4, _ = level_corners(flat, base, hl, wl, u, v, boundary_mode)
    return ((w4[0] * q[0] + w4[1] * q[1]) + w4[2] * q[2]) + w4[3] * q[3]


def level_corners(flat, base, hl, wl, u, v, boundary_mode):
    """corner_setup and the corner gather at one level per pixel.

    Returns (q, fu, fv, w4, ok4): the four corner texels [C, N] in
    (00, 10, 01, 11) order, the bilinear fractions, the weights with the
    zero boundary's validity folded in, and that validity (0/1 floats,
    all ones for wrap and clamp).
    """
    w = wl.to(torch.float32)
    h = hl.to(torch.float32)
    if boundary_mode == "wrap":
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    u = u * w - 0.5
    v = v * h - 0.5
    if boundary_mode == "clamp":
        u = torch.minimum(torch.maximum(u, torch.zeros_like(u)), w - 1.0)
        v = torch.minimum(torch.maximum(v, torch.zeros_like(v)), h - 1.0)
        step_u = torch.where((u == 0.0) | (u == w - 1.0), 0, 1)
        step_v = torch.where((v == 0.0) | (v == h - 1.0), 0, 1)
    else:
        step_u = step_v = 1
    iu0 = torch.floor(u).to(torch.int32).long()
    iv0 = torch.floor(v).to(torch.int32).long()
    iu1 = iu0 + step_u
    iv1 = iv0 + step_v
    fu = u - iu0.to(torch.float32)
    fv = v - iv0.to(torch.float32)
    if boundary_mode == "wrap":
        iu0 = torch.where(iu0 < 0, iu0 + wl, iu0)
        iv0 = torch.where(iv0 < 0, iv0 + hl, iv0)
        iu1 = torch.where(iu1 >= wl, iu1 - wl, iu1)
        iv1 = torch.where(iv1 >= hl, iv1 - hl, iv1)
    if boundary_mode == "zero":
        def ok(i, n):
            return ((i >= 0) & (i < n)).to(torch.float32)

        u0, u1, v0, v1 = ok(iu0, wl), ok(iu1, wl), ok(iv0, hl), ok(iv1, hl)
        ok4 = (u0 * v0, u1 * v0, u0 * v1, u1 * v1)
    else:
        one = torch.ones_like(fu)
        ok4 = (one, one, one, one)
    gu = 1.0 - fu
    gv = 1.0 - fv
    w4 = (gu * gv * ok4[0], fu * gv * ok4[1], gu * fv * ok4[2], fu * fv * ok4[3])

    def clip(i, n):
        return torch.minimum(torch.maximum(i, torch.zeros_like(i)), n - 1)

    iu0, iu1 = clip(iu0, wl), clip(iu1, wl)
    iv0, iv1 = clip(iv0, hl), clip(iv1, hl)
    q = [flat[base + r * wl + c].T for r, c in
         ((iv0, iu0), (iv0, iu1), (iv1, iu0), (iv1, iu1))]
    return q, fu, fv, w4, ok4


def sample_plain(flat, u, v, flevel, meta, shape, per_image, boundary_mode,
                 filter_mode):
    """Plain PyTorch twin of the texture sampler kernel."""
    C, N, L = _check(flat, u, v, flevel, meta, shape, per_image,
                     boundary_mode, filter_mode)
    dev = flat.device
    offs, hs, ws, tz = level_tables(meta, shape, per_image, dev)
    l0, l1, frac = level_weights(flevel, L, filter_mode)

    def term(lev):
        hl, wl = hs[lev], ws[lev]
        wgt = (torch.where(lev == l0, 1.0 - frac, 0.0)
               + torch.where(lev == l1, frac, 0.0))
        val = _level_value(flat, offs[lev] + tz * hl * wl, hl, wl, u, v,
                           boundary_mode)
        return wgt * val

    # Levels in ascending order; l1's term only where it is another level.
    out = torch.zeros((C, N), dtype=torch.float32, device=dev) + term(l0)
    if filter_mode == "linear-mipmap-linear":
        out = out + torch.where(l1 != l0, term(l1), 0.0)
    return out


def check_level_args(da, bias, gfl=None):
    """N, the pixels of the mip level's columns: da [4, N] (any strides)
    and bias [N], either None but not both, and gfl [N] when given;
    ValueError unless they are float32 on one device."""
    if da is None and bias is None:
        raise ValueError("mip level: needs da or bias")
    if da is not None and (da.ndim != 2 or da.shape[0] != 4):
        raise ValueError(f"mip level: da must be [4, N]; got {tuple(da.shape)}")
    N = da.shape[1] if da is not None else bias.shape[0]
    cols = [t for t in (da, bias, gfl) if t is not None]
    if any(t.shape != (N,) for t in (bias, gfl) if t is not None):
        raise ValueError(f"mip level: bias and gfl must be flat [{N}]")
    if any(t.dtype != torch.float32 or t.device != cols[0].device for t in cols):
        raise ValueError("mip level: expects float32 tensors on one device")
    if cols[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"mip level: unsupported device {cols[0].device}")
    return N


def _ptr(t):
    return None if t is None else _build.ptr(t)


def _da_args(da):
    """da's pointer and its element and row strides (None, 0, 0 without
    da)."""
    return (None, 0, 0) if da is None else (_build.ptr(da), da.stride(1), da.stride(0))


def launch_mip_level(da, bias, tex_h, tex_w, L):
    """flevel [N] = clamp(footprint(da) [+ bias], 0, L-1) from CUDA
    tensors (``csrc/mip_level.cu``; ``texture.mip_level``'s arguments)."""
    N = check_level_args(da, bias)
    dev = (da if da is not None else bias).device
    if dev.type != "cuda":
        raise ValueError(f"mip level: the kernel needs CUDA tensors, not {dev}")
    bias = None if bias is None else bias.contiguous()
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        LEVEL_KERNEL.launch(dev, *_da_args(da), _ptr(bias), _build.ptr(out), N, int(tex_w),
                            int(tex_h), int(L))
    return out


def launch_level_vjp(da, gfl, bias, tex_h, tex_w, L):
    """(g_da [4, N] or None without da, g_bias [N] or None without a
    bias) from CUDA tensors (``csrc/mip_level.cu``;
    ``texture.level_vjp``'s arguments)."""
    N = check_level_args(da, bias, gfl)
    dev = gfl.device
    if dev.type != "cuda":
        raise ValueError(f"level vjp: the kernel needs CUDA tensors, not {dev}")
    gfl = gfl.contiguous()
    bias = None if bias is None else bias.contiguous()
    g_da = None if da is None else torch.empty((4, N), dtype=torch.float32, device=dev)
    g_lvl = None if bias is None else torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        LEVEL_VJP_KERNEL.launch(dev, *_da_args(da), _build.ptr(gfl), _ptr(bias), _ptr(g_da),
                                _ptr(g_lvl), N, int(tex_w), int(tex_h), int(L))
    return g_da, g_lvl
