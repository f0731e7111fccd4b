"""Antialias forward and backward on flat channel-major buffers: two
CUDA kernels (torch).

Counterparts of ``nvdiffrast_tpu/ops/antialias_pallas.py`` (instance
and range mode, viewport bands):

* ``aa_cols`` (kernel ``csrc/aa_fwd.cu``, B7 ``aa_forward_fused_cols``)
  reads a colour image [C, N] and the rasterizer's flat id and depth
  buffers and writes the own-pixel colour, the two neighbour contribution
  images and the AA residuals, all row-major; ``aa_forward`` adds the
  neighbour contributions with ``pipeline_cuda.finish_shade`` (plain
  tensor glue, as the JAX package leaves it to XLA);
* ``aa_backward`` (kernel ``csrc/aa_bwd.cu``, B8
  ``aa_backward_fused_cols``) writes the colour gradient and, per pixel
  pair, its table row and 9 position-gradient columns, which
  ``scatter.scatter_add_by_id`` reduces to triangle rows.

``aa_cols_plain`` and ``aa_backward_plain`` are the plain PyTorch twins,
with the same arithmetic. Every function takes `ranged` (range mode: one
table [*, T+1] for all images) and `viewport` ((y0, full_height) of the
band, or None).
"""

import ctypes

import torch

from .. import _build
from ..utils.trace import spanned
from .antialias import _pixel_grid, decode_aux, pair_alpha, pair_ids, pair_pos_grad
from .pipeline_cuda import _folded, _roll_next, finish_shade

MAX_C = 8  # channels served by the kernel (antialias_pallas._MAX_CHANNELS)

KERNEL = _build.Kernel(
    "nvdr_aa_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 6 + [ctypes.c_float] * 2)

BWD_KERNEL = _build.Kernel(
    "nvdr_aa_bwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 6 + [ctypes.c_float] * 4)


def _geometry(shape, T, ranged, viewport):
    """(table row stride per image RT, fy offset fyo, full height Hf)."""
    H = shape[1]
    y0, Hf = (0, H) if viewport is None else viewport
    return (0 if ranged else T), y0 + 0.5 - 0.5 * Hf, Hf


def _check(ct, idf, zw, ftable, shape, T, ranged=False):
    B, H, W = shape
    N = B * H * W
    C = ct.shape[0]
    cols = (T if ranged else B * T) + 1
    if ct.ndim != 2 or ct.shape[1] != N or not 1 <= C <= MAX_C:
        raise ValueError(f"aa_forward: colour must be [C, {N}] with 1 <= C <= "
                         f"{MAX_C}; got {tuple(ct.shape)}")
    if ftable.shape != (7, cols):
        raise ValueError(f"aa_forward: ftable must be [7, {cols}]; got "
                         f"{tuple(ftable.shape)}")
    if idf.shape != (N,) or zw.shape != (N,):
        raise ValueError("aa_forward: idf and zw must be flat [N]")
    if any(t.dtype != torch.float32 or t.device != ct.device
           for t in (ct, idf, zw, ftable)):
        raise ValueError("aa_forward: expects float32 tensors on one device")
    return C, N


def aa_cols(ct, idf, zw, ftable, shape, T, ranged=False, viewport=None):
    """Per-pixel AA pair analysis of a colour image.

    Args:
      ct: [C, N] colour, channel-major; idf, zw: flat [N] rasterizer id
        and depth; ftable: [7, B*T+1], or [7, T+1] when `ranged`
        (topology._build_tables);
      shape: (B, H, W); T: triangles per image (per table);
      viewport: (y0, full_height) of the band, or None.

    Returns (out, ct, negx, negy, al0, ax0, al1, ax1): out/negx/negy
    [C, N], the residuals [N] (the layout of shade_cols, for
    finish_shade). CPU tensors run the plain twin; CUDA tensors launch
    the kernel or raise.
    """
    if ct.device.type == "cpu":
        return aa_cols_plain(ct, idf, zw, ftable, shape, T, ranged, viewport)
    if ct.device.type != "cuda":
        raise ValueError(f"aa_cols: unsupported device {ct.device}")
    C, N = _check(ct, idf, zw, ftable, shape, T, ranged)
    B, H, W = shape
    RT, fyo, _ = _geometry(shape, T, ranged, viewport)
    ct, idf, zw, ftable = (t.contiguous() for t in (ct, idf, zw, ftable))
    dev = ct.device
    chans = [torch.empty((C, N), dtype=torch.float32, device=dev)
             for _ in range(3)]
    res = [torch.empty((N,), dtype=torch.float32, device=dev)
           for _ in range(4)]
    KERNEL.launch(dev, _build.ptr(ct), _build.ptr(idf), _build.ptr(zw),
                  _build.ptr(ftable), ftable.shape[1],
                  *(_build.ptr(t) for t in chans + res),
                  N, C, T, RT, H, W, 0.5 - 0.5 * W, fyo)
    return (chans[0], ct, chans[1], chans[2], *res)


def aa_cols_plain(ct, idf, zw, ftable, shape, T, ranged=False, viewport=None):
    """Plain PyTorch twin of the AA forward kernel (same arithmetic)."""
    _check(ct, idf, zw, ftable, shape, T, ranged)
    B, H, W = shape
    fx, fy, rofs, bx, by = _pixel_grid(B, H, W, T, ct.device, viewport, ranged)
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


@spanned("nvdr.aa.fwd")
def aa_forward(ct, idf, zw, ftable, shape, T, ranged=False, viewport=None):
    """Antialiased colour [C, N] and the residuals (al0, ax0, al1, ax1)
    flat [N] row-major, as ``antialias_pallas.aa_forward_fused_cols``
    (whose residuals are tile-ordered)."""
    out, _, res = finish_shade(aa_cols(ct, idf, zw, ftable, shape, T, ranged, viewport),
                               shape[2])
    return out, res


# ---------------------------------------------------------------------------
# B8: backward.
# ---------------------------------------------------------------------------

def _check_bwd(dy, ct, idf, vtbl, residuals, shape, T, ranged=False):
    B, H, W = shape
    N = B * H * W
    C = ct.shape[0]
    cols = (T if ranged else B * T) + 1
    if ct.ndim != 2 or ct.shape[1] != N or not 1 <= C <= MAX_C or dy.shape != ct.shape:
        raise ValueError(f"aa_backward: dy and colour must be [C, {N}] with 1 <= C <= "
                         f"{MAX_C}; got {tuple(dy.shape)}, {tuple(ct.shape)}")
    if vtbl.shape != (9, cols):
        raise ValueError(f"aa_backward: vtbl must be [9, {cols}]; got "
                         f"{tuple(vtbl.shape)}")
    if idf.shape != (N,) or any(r.shape != (N,) for r in residuals):
        raise ValueError("aa_backward: idf and the residuals must be flat [N]")
    if any(t.dtype != torch.float32 or t.device != ct.device
           for t in (dy, ct, idf, vtbl, *residuals)):
        raise ValueError("aa_backward: expects float32 tensors on one device")
    return C, N


def aa_backward(dy, ct, idf, vtbl, residuals, shape, T, ranged=False, viewport=None):
    """Antialias backward of a colour image.

    Args:
      dy: [C, N] loss cotangent of the antialiased image; ct: [C, N] the
        colour it was made from; idf: flat [N] rasterizer id channel;
      vtbl: [9, B*T+1] clip-space vertex table (topology._build_tables'
        btable);
      residuals: (al0, ax0, al1, ax1) flat [N] row-major, from
        ``aa_forward``; shape: (B, H, W); T: triangles per image.

    Returns (g_color [C, N], rid2 [2, N] int32 the pairs' table rows,
    gval2 [9, 2N] their position-gradient columns, axis 0 then axis 1,
    zero where a pair is not kept), as
    ``antialias_pallas.aa_backward_fused_cols``. CPU tensors run the plain
    twin; CUDA tensors launch the kernel or raise.
    """
    if ct.device.type == "cpu":
        return aa_backward_plain(dy, ct, idf, vtbl, residuals, shape, T, ranged, viewport)
    if ct.device.type != "cuda":
        raise ValueError(f"aa_backward: unsupported device {ct.device}")
    C, N = _check_bwd(dy, ct, idf, vtbl, residuals, shape, T, ranged)
    B, H, W = shape
    RT, fyo, Hf = _geometry(shape, T, ranged, viewport)
    dy, ct, idf, vtbl = (t.contiguous() for t in (dy, ct, idf, vtbl))
    res = [t.contiguous() for t in residuals]
    dev = ct.device
    gcol = torch.empty((C, N), dtype=torch.float32, device=dev)
    rid2 = torch.empty((2, N), dtype=torch.int32, device=dev)
    gval2 = torch.empty((9, 2 * N), dtype=torch.float32, device=dev)
    BWD_KERNEL.launch(dev, _build.ptr(dy), _build.ptr(ct), _build.ptr(idf),
                      _build.ptr(vtbl), vtbl.shape[1], *(_build.ptr(t) for t in res),
                      _build.ptr(gcol), _build.ptr(rid2), _build.ptr(gval2),
                      N, C, T, RT, H, W, 0.5 - 0.5 * W, fyo, 0.5 * W, 0.5 * Hf)
    return gcol, rid2, gval2


def aa_backward_plain(dy, ct, idf, vtbl, residuals, shape, T, ranged=False, viewport=None):
    """Plain PyTorch twin of the AA backward kernel (same arithmetic;
    antialias_pallas.py:380-404, the neighbours' blends added as
    pipeline_bwd_cuda.pipeline_bwd_plain adds them)."""
    _check_bwd(dy, ct, idf, vtbl, residuals, shape, T, ranged)
    B, H, W = shape
    Hf = H if viewport is None else viewport[1]
    fx, fy, rofs, bx, by = _pixel_grid(B, H, W, T, ct.device, viewport, ranged)
    al0, ax0, al1, ax1 = residuals
    gc = dy
    rid2 = []
    gval2 = []
    for d, (idn, c1, dyn, al, ax) in enumerate(zip(
            _folded(idf, bx, by, W), _folded(ct, bx, by, W), _folded(dy, bx, by, W),
            (al0, al1), (ax0, ax1))):
        pdy = torch.where(al > 0, dy, dyn)
        gc = gc - al * pdy
        di, is_t1 = decode_aux(ax)
        active = al != 0.0
        tsel = torch.where(is_t1, idn, idf).to(torch.int32) - 1
        ok = active & (tsel >= 0) & (tsel < T)
        rid = torch.where(ok, tsel, 0) + rofs
        dd = torch.zeros_like(al)
        for c in range(ct.shape[0]):
            dd = dd + pdy[c] * (c1[c] - ct[c])
        dd = torch.where(active, dd, 0.0)
        keep = ok & (dd != 0.0) & (al.abs() < 0.5)
        t9 = torch.where(keep, vtbl[:, rid.long()], 0.0)
        cols = pair_pos_grad(list(t9), dd, keep, di, is_t1, fx, fy, d, W, Hf)
        rid2.append(rid)
        gval2.append(torch.stack(cols))
    a0m = _roll_next(al0, 1)
    a1m = _roll_next(al1, W)
    vm0 = a0m * torch.where(a0m > 0, _roll_next(dy, 1), dy)
    vm1 = a1m * torch.where(a1m > 0, _roll_next(dy, W), dy)
    gc = gc + vm0 + vm1
    return gc, torch.stack(rid2).to(torch.int32), torch.cat(gval2, dim=1)
