"""Antialias forward on flat channel-major buffers: one CUDA kernel (torch).

Counterpart of ``nvdiffrast_tpu/ops/antialias_pallas.py``
(``aa_forward_fused_cols``, instance mode). The kernel ``csrc/aa_fwd.cu``
(``aa_cols``) reads a colour image [C, N] and the rasterizer's flat id
and depth buffers and writes the own-pixel colour, the two neighbour
contribution images and the AA residuals, all row-major;
``aa_cols_plain`` is its plain PyTorch twin with the same arithmetic.
``aa_forward`` adds the neighbour contributions with
``pipeline_cuda.finish_shade`` (plain tensor glue, as the JAX package
leaves it to XLA).
"""

import ctypes

import torch

from .. import _build
from .antialias import _pixel_grid, pair_alpha, pair_ids
from .pipeline_cuda import _folded, finish_shade

MAX_C = 8  # channels served by the kernel (antialias_pallas._MAX_CHANNELS)

KERNEL = _build.Kernel(
    "nvdr_aa_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 5 + [ctypes.c_float] * 2)


def _check(ct, idf, zw, ftable, shape, T):
    B, H, W = shape
    N = B * H * W
    C = ct.shape[0]
    if ct.ndim != 2 or ct.shape[1] != N or not 1 <= C <= MAX_C:
        raise ValueError(f"aa_forward: colour must be [C, {N}] with 1 <= C <= "
                         f"{MAX_C}; got {tuple(ct.shape)}")
    if ftable.shape != (7, B * T + 1):
        raise ValueError(f"aa_forward: ftable must be [7, {B * T + 1}]; got "
                         f"{tuple(ftable.shape)}")
    if idf.shape != (N,) or zw.shape != (N,):
        raise ValueError("aa_forward: idf and zw must be flat [N]")
    if any(t.dtype != torch.float32 or t.device != ct.device
           for t in (ct, idf, zw, ftable)):
        raise ValueError("aa_forward: expects float32 tensors on one device")
    return C, N


def aa_cols(ct, idf, zw, ftable, shape, T):
    """Per-pixel AA pair analysis of a colour image.

    Args:
      ct: [C, N] colour, channel-major; idf, zw: flat [N] rasterizer id
        and depth; ftable: [7, B*T+1] (antialias._build_tables);
      shape: (B, H, W); T: triangles per image.

    Returns (out, ct, negx, negy, al0, ax0, al1, ax1): out/negx/negy
    [C, N], the residuals [N] (the layout of shade_cols, for
    finish_shade). CPU tensors run the plain twin; CUDA tensors launch
    the kernel or raise.
    """
    if ct.device.type == "cpu":
        return aa_cols_plain(ct, idf, zw, ftable, shape, T)
    if ct.device.type != "cuda":
        raise ValueError(f"aa_cols: unsupported device {ct.device}")
    C, N = _check(ct, idf, zw, ftable, shape, T)
    B, H, W = shape
    ct, idf, zw, ftable = (t.contiguous() for t in (ct, idf, zw, ftable))
    dev = ct.device
    chans = [torch.empty((C, N), dtype=torch.float32, device=dev)
             for _ in range(3)]
    res = [torch.empty((N,), dtype=torch.float32, device=dev)
           for _ in range(4)]
    KERNEL.launch(dev, _build.ptr(ct), _build.ptr(idf), _build.ptr(zw),
                  _build.ptr(ftable), ftable.shape[1],
                  *(_build.ptr(t) for t in chans + res),
                  N, C, T, H, W, 0.5 - 0.5 * W, 0.5 - 0.5 * H)
    return (chans[0], ct, chans[1], chans[2], *res)


def aa_cols_plain(ct, idf, zw, ftable, shape, T):
    """Plain PyTorch twin of the AA forward kernel (same arithmetic)."""
    _check(ct, idf, zw, ftable, shape, T)
    B, H, W = shape
    fx, fy, rofs, bx, by = _pixel_grid(B, H, W, T, ct.device)
    out = ct
    negs = []
    res = []
    for d, (idn, zn, cn) in enumerate(zip(
            *(_folded(t, bx, by, W) for t in (idf, zw, ct)))):
        tid, is_t1, active = pair_ids(idf, idn, zw, zn, T)
        t7 = torch.where(active, ftable[:, (tid + rofs).long()], 0.0)
        alpha, di = pair_alpha(list(t7), fx, fy, is_t1, active, d)
        contrib = alpha * (cn - ct)
        apos = alpha > 0
        out = out + torch.where(apos, contrib, 0.0)
        negs.append(torch.where(apos, 0.0, contrib))
        res += [alpha, di.to(torch.float32) + 4.0 * is_t1.to(torch.float32)]
    return (out, ct, negs[0], negs[1], *res)


def aa_forward(ct, idf, zw, ftable, shape, T):
    """Antialiased colour [C, N] and the residuals (al0, ax0, al1, ax1)
    flat [N] row-major, as ``antialias_pallas.aa_forward_fused_cols``
    (whose residuals are tile-ordered)."""
    out, _, res = finish_shade(aa_cols(ct, idf, zw, ftable, shape, T), shape[2])
    return out, res
