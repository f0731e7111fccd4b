"""Fused interpolate + antialias forward: one CUDA kernel (torch).

Counterpart of the forward half of ``nvdiffrast_tpu/ops/pipeline_pallas.py``
(``shade_fwd``). The kernel ``csrc/shade_fwd.cu`` (``shade_cols``) reads
the rasterizer's flat buffers and the per-triangle tables and writes the
own-pixel colour, the pre-AA colour c0, the two neighbour contribution
images and the AA residuals; ``shade_cols_plain`` is its plain PyTorch
twin with the same arithmetic. ``shade_fwd`` adds the neighbour
contributions in the reference's order (plain tensor glue, as the JAX
package leaves it to XLA).
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import spanned
from .antialias import _pixel_grid, pair_alpha, pair_ids

MAX_A = 8  # channels served by the kernel

KERNEL = _build.Kernel(
    "nvdr_shade_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2)


def _check(atbl, ftable, flats, resolution, T):
    H, W = resolution
    N = flats[0].shape[0]
    K, cols = atbl.shape
    if K % 3 or not 1 <= K // 3 <= MAX_A:
        raise ValueError(f"shade_fwd: atbl must be [3A, R+1] with 1 <= A <= "
                         f"{MAX_A}; got {tuple(atbl.shape)}")
    if ftable.shape != (7, cols):
        raise ValueError(f"shade_fwd: ftable must be [7, {cols}]; got "
                         f"{tuple(ftable.shape)}")
    if N % (H * W) or (N // (H * W)) * T + 1 != cols:
        raise ValueError(f"shade_fwd: {N} pixels and {cols} table columns "
                         f"do not fit resolution {resolution} and T={T}")
    if any(t.shape != (N,) for t in flats):
        raise ValueError("shade_fwd: b0, b1, zw, idf must all be flat [N]")
    if any(t.dtype != torch.float32 or t.device != atbl.device
           for t in (atbl, ftable, *flats)):
        raise ValueError("shade_fwd: expects float32 tensors on one device")
    return K // 3, N


def shade_cols(atbl, ftable, b0, b1, zw, idf, resolution, T):
    """Per-pixel interpolate + antialias pair analysis.

    Args:
      atbl: [3A, B*T+1] attribute table (dummy zero column last).
      ftable: [7, B*T+1] AA forward table (topology._build_tables).
      b0, b1, zw, idf: flat [N] rasterizer buffers, N = B*H*W.
      resolution: (H, W); T: triangles per image.

    Returns (out, c0, negx, negy, al0, ax0, al1, ax1): out/c0/negx/negy
    [A, N], the residuals [N]. CPU tensors run the plain twin; CUDA
    tensors launch the kernel (built at first use) or raise.
    """
    if atbl.device.type == "cpu":
        return shade_cols_plain(atbl, ftable, b0, b1, zw, idf, resolution, T)
    if atbl.device.type != "cuda":
        raise ValueError(f"shade_cols: unsupported device {atbl.device}")
    H, W = resolution
    flats = [t.contiguous() for t in (b0, b1, zw, idf)]
    A, N = _check(atbl, ftable, flats, resolution, T)
    atbl = atbl.contiguous()
    ftable = ftable.contiguous()
    dev = atbl.device
    chans = [torch.empty((A, N), dtype=torch.float32, device=dev)
             for _ in range(4)]
    res = [torch.empty((N,), dtype=torch.float32, device=dev)
           for _ in range(4)]
    KERNEL.launch(dev, _build.ptr(atbl), _build.ptr(ftable), atbl.shape[1],
                  *(_build.ptr(t) for t in flats),
                  *(_build.ptr(t) for t in chans + res),
                  N, A, T, H, W, 0.5 - 0.5 * W, 0.5 - 0.5 * H)
    return (*chans, *res)


def _folded(x, bx, by, W):
    """Right and down neighbour copies along the last (pixel) axis,
    borders folded onto the pixel."""
    xr = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    xd = torch.cat([x[..., W:], x[..., -W:]], dim=-1)
    return torch.where(bx, x, xr), torch.where(by, x, xd)


def shade_cols_plain(atbl, ftable, b0, b1, zw, idf, resolution, T):
    """Plain PyTorch twin of the shade_fwd kernel (same arithmetic)."""
    H, W = resolution
    A, N = _check(atbl, ftable, (b0, b1, zw, idf), resolution, T)
    B = N // (H * W)
    fx, fy, rofs, bx, by = _pixel_grid(B, H, W, T, atbl.device)

    def colour(tid, valid, gather, bb0, bb1):
        """Bary combine of the rows gathered where `gather` (zeros
        elsewhere), with the barys kept where `valid` (zeros elsewhere)."""
        rid = (torch.where(valid, tid, 0) + rofs).long()
        g = torch.where(gather, atbl[:, rid], 0.0)
        w0 = torch.where(valid, bb0, 0.0)
        w1 = torch.where(valid, bb1, 0.0)
        w2 = torch.where(valid, 1.0 - bb0 - bb1, 0.0)
        return (w0 * g[:A] + w1 * g[A:2 * A]) + w2 * g[2 * A:]

    tid0 = idf.to(torch.int32) - 1
    valid0 = (tid0 >= 0) & (tid0 < T)
    c0 = colour(tid0, valid0, valid0, b0, b1)
    out = c0
    negs = []
    res = []
    for d, (idn, zn, b0n, b1n) in enumerate(zip(
            *(_folded(t, bx, by, W) for t in (idf, zw, b0, b1)))):
        tid, is_t1, active = pair_ids(idf, idn, zw, zn, T)
        t7 = torch.where(active, ftable[:, (tid + rofs).long()], 0.0)
        alpha, di = pair_alpha(list(t7), fx, fy, is_t1, active, d)
        # Neighbour colour: the neighbour pixel's own interpolation.
        tid1 = idn.to(torch.int32) - 1
        nvalid = (tid1 >= 0) & (tid1 < T)
        c1 = colour(tid1, nvalid, active & nvalid, b0n, b1n)
        contrib = alpha * (c1 - c0)
        apos = alpha > 0
        out = out + torch.where(apos, contrib, 0.0)
        negs.append(torch.where(apos, 0.0, contrib))
        res += [alpha, di.to(torch.float32) + 4.0 * is_t1.to(torch.float32)]
    return (out, c0, negs[0], negs[1], *res)


def _roll_next(x, stride):
    """Scatter from pixel p onto p + stride along the last axis."""
    z = torch.zeros(x.shape[:-1] + (stride,), dtype=x.dtype, device=x.device)
    return torch.cat([z, x[..., :-stride]], dim=-1)


def finish_shade(cols, W):
    """(out, c0, residuals) from shade_cols' outputs: adds the right and
    down neighbours' contributions in the reference's order."""
    out, c0, negx, negy, al0, ax0, al1, ax1 = cols
    out = out + _roll_next(negx, 1)
    out = out + _roll_next(negy, W)
    return out, c0, (al0, ax0, al1, ax1)


@spanned("nvdr.shade")
def shade_fwd(atbl, ftable, b0, b1, zw, idf, resolution, T):
    """Fused interpolate + antialias forward.

    Returns (out [A, N] final colour, c0 [A, N] pre-AA colour,
    (al0, ax0, al1, ax1) flat [N] AA residuals), as
    ``pipeline_pallas.shade_fwd``.
    """
    cols = shade_cols(atbl, ftable, b0, b1, zw, idf, resolution, T)
    return finish_shade(cols, resolution[1])
