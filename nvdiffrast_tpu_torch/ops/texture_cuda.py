"""Texture sampler forward: one CUDA kernel (torch).

Counterpart of ``nvdiffrast_tpu/ops/texture_pallas.py`` (``_call_sampler``
in mode ``"fwd"``, as ``sample_fused`` calls it) for 2-D textures. The
kernel ``csrc/texture_fwd.cu`` (``sample``) samples the flat-packed mip
pyramid of ``ops/texture.py`` at per-pixel (u, v, flevel) with the
linear, linear-mipmap-nearest and linear-mipmap-linear filters and the
wrap, clamp and zero boundaries; ``sample_plain`` is its plain PyTorch
twin with the same arithmetic (``corner_setup`` and ``level_weights``).
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
