"""Interpolate forward and backward on flat buffers: two CUDA kernels
(torch).

Counterparts of ``nvdiffrast_tpu/ops/interpolate_pallas.py`` together with
the masking glue in front of it (``interpolate._pixel_ids``,
``_flat_ids``, ``pipeline_tex.py:84-93``):

* ``interp_forward`` (kernel ``csrc/interpolate_fwd.cu``, B5
  ``interp_forward_fused``) takes the rasterizer's flat (u, v, idf) and
  bary derivatives and an attribute table, one for all images or one per
  image, and writes the interpolated attributes and their screen
  derivatives;
* ``interp_backward`` (kernel ``csrc/interpolate_bwd.cu``, B6
  ``interp_backward_fused``) gathers the table again and writes the bary
  gradients, the per-pixel attribute-gradient columns and the bary
  derivatives' gradients.

Each launch serves up to ``MAX_A`` attributes; ``interp_forward_plain``
and ``interp_backward_plain`` are the plain PyTorch twins of one launch,
with the same arithmetic.
"""

import ctypes

import torch

from .. import _build
from . import coord

MAX_A = 16  # attributes served by the kernel (interpolate_pallas._MAX_K / 3)

KERNEL = _build.Kernel(
    "nvdr_interp_fwd",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 5 + [ctypes.c_ulonglong])

BWD_KERNEL = _build.Kernel(
    "nvdr_interp_bwd",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 5 + [ctypes.c_ulonglong, ctypes.c_int])


def _check(tbl, u, v, idf, db, diff_list, T=None, hw=0):
    K, cols = tbl.shape
    A = K // 3
    N = u.shape[0]
    if K % 3 or not 1 <= A <= MAX_A:
        raise ValueError(f"interp_forward: tbl must be [3A, T+1] with 1 <= A <= "
                         f"{MAX_A}; got {tuple(tbl.shape)}")
    T = cols - 1 if T is None else T
    if hw < 0 or (hw and (N % hw or (N // hw) * T + 1 != cols)) or (not hw and T + 1 != cols):
        raise ValueError(f"interp_forward: a table of {cols} columns does not fit "
                         f"T={T} and {N} pixels ({hw} per image table)")
    D = len(diff_list)
    if D and db is None:
        raise ValueError("interp_forward: diff_list needs the four db flats")
    if any(not 0 <= j < A for j in diff_list) or D > A:
        raise ValueError(f"interp_forward: diff_list {diff_list} out of range "
                         f"for A={A}")
    flats = (u, v, idf) + (tuple(db) if D else ())
    if any(t.shape != (N,) for t in flats):
        raise ValueError("interp_forward: u, v, idf and db must be flat [N]")
    if any(t.dtype != torch.float32 or t.device != tbl.device
           for t in (tbl,) + flats):
        raise ValueError("interp_forward: expects float32 tensors on one device")
    return A, D, N, T


def interp_forward(tbl, u, v, idf, db, diff_list, T=None, hw=0):
    """Interpolated attributes and their screen derivatives.

    Args:
      tbl: [3A, R+1] attribute table, row k*A + a = channel a of each
        triangle's vertex k, a zero column last (``pipeline._attr_table``):
        one for all images (R = T, hw = 0) or one per image (R = B*T,
        hw = H*W, pixel p takes row (p // hw)*T + t).
      u, v, idf: flat [N] rasterizer buffers.
      db: (dudx, dudy, dvdx, dvdy) flat [N], or None without derivatives.
      diff_list: indices of the attributes to differentiate.
      T: triangles per image (default R); hw: pixels per image of a
        per-image table, 0 for one table.

    Returns (out [A, N], da [2D, N]) with D = len(diff_list). CPU tensors
    run the plain twin; CUDA tensors launch the kernel or raise.
    """
    diff_list = tuple(int(j) for j in diff_list)
    if tbl.device.type == "cpu":
        return interp_forward_plain(tbl, u, v, idf, db, diff_list, T, hw)
    if tbl.device.type != "cuda":
        raise ValueError(f"interp_forward: unsupported device {tbl.device}")
    A, D, N, T = _check(tbl, u, v, idf, db, diff_list, T, hw)
    tbl = tbl.contiguous()
    flats = [t.contiguous() for t in (u, v, idf)]
    dbs = [t.contiguous() for t in db] if D else flats[:1] * 4  # unread at D = 0
    dev = tbl.device
    out = torch.empty((A, N), dtype=torch.float32, device=dev)
    da = torch.empty((2 * D, N), dtype=torch.float32, device=dev)
    packed = sum(j << (4 * i) for i, j in enumerate(diff_list))
    KERNEL.launch(dev, _build.ptr(tbl), tbl.shape[1],
                  *(_build.ptr(t) for t in flats + dbs),
                  _build.ptr(out), _build.ptr(da), N, A, T, hw, D, packed)
    return out, da


def _gathered(tbl, idf, T, hw):
    """(valid [N], g [3A, N]): the pixels with a triangle and their
    table columns (zeros elsewhere)."""
    tid = coord.float_to_triidx(idf) - 1
    valid = (tid >= 0) & (tid < T)
    row = tid
    if hw:
        pix = torch.arange(idf.shape[0], dtype=torch.int32, device=idf.device)
        row = tid + pix // hw * T
    rid = torch.where(valid, row, tbl.shape[1] - 1).long()
    return valid, torch.where(valid, tbl[:, rid], 0.0)


def interp_forward_plain(tbl, u, v, idf, db, diff_list, T=None, hw=0):
    """Plain PyTorch twin of the interpolate forward kernel."""
    diff_list = tuple(int(j) for j in diff_list)
    A, D, N, T = _check(tbl, u, v, idf, db, diff_list, T, hw)
    valid, g = _gathered(tbl, idf, T, hw)
    b0 = torch.where(valid, u, 0.0)
    b1 = torch.where(valid, v, 0.0)
    b2 = torch.where(valid, (1.0 - u) - v, 0.0)
    out = (b0 * g[:A] + b1 * g[A:2 * A]) + b2 * g[2 * A:]
    if not D:
        return out, torch.zeros((0, N), dtype=torch.float32, device=tbl.device)
    ux, uy, vx, vy = (torch.where(valid, t, 0.0) for t in db)
    rows = []
    for j in diff_list:
        dsdu = g[j] - g[2 * A + j]
        dsdv = g[A + j] - g[2 * A + j]
        rows += [ux * dsdu + vx * dsdv, uy * dsdu + vy * dsdv]
    return out, torch.stack(rows)


# ---------------------------------------------------------------------------
# B6: backward.
# ---------------------------------------------------------------------------

def _check_bwd(tbl, u, v, idf, db, gy, gda, diff_list, T, hw, grast, gdb):
    A, D, N, T = _check(tbl, u, v, idf, db, diff_list, T, hw)
    if D > 16:
        raise ValueError(f"interp_backward: {D} differentiated attributes in one "
                         "launch; the kernel takes at most 16")
    if gy.shape != (A, N) or (D and (gda is None or gda.shape != (2 * D, N))):
        raise ValueError(f"interp_backward: gy must be [{A}, {N}] and gda "
                         f"[{2 * D}, {N}]")
    if (grast is not None and grast.shape != (2, N)) or (
            gdb is not None and gdb.shape != (4, N)):
        raise ValueError(f"interp_backward: grast must be [2, {N}], gdb [4, {N}]")
    extra = [t for t in (gy, gda if D else None, grast, gdb) if t is not None]
    if any(t.dtype != torch.float32 or t.device != tbl.device for t in extra):
        raise ValueError("interp_backward: expects float32 tensors on one device")
    return A, D, N, T


def interp_backward(tbl, u, v, idf, db, gy, gda, diff_list, T=None, hw=0,
                    grast=None, gdb=None):
    """Interpolate backward of one launch (up to MAX_A attributes).

    Args:
      tbl, u, v, idf, db, diff_list, T, hw: as ``interp_forward``.
      gy: [A, N] cotangent of the interpolated attributes; gda: [2D, N]
        cotangent of their screen derivatives (None when D = 0).
      grast, gdb: None, or the [2, N] bary and [4, N] db gradients of an
        earlier launch to add to (attributes past MAX_A run as further
        launches; the sums go on in the reference's order).

    Returns (grast [2, N]: the gradients to rast channels 0-1; gval
    [3A, N]: row k*A + a the gradient of vertex k's attribute a per
    pixel, zero where the pixel has no triangle; gdb [4, N] the gradients
    to (dudx, dudy, dvdx, dvdy), or None when D = 0 and no gdb is given).
    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.
    """
    diff_list = tuple(int(j) for j in diff_list)
    if tbl.device.type == "cpu":
        return interp_backward_plain(tbl, u, v, idf, db, gy, gda, diff_list, T, hw,
                                     grast, gdb)
    if tbl.device.type != "cuda":
        raise ValueError(f"interp_backward: unsupported device {tbl.device}")
    A, D, N, T = _check_bwd(tbl, u, v, idf, db, gy, gda, diff_list, T, hw, grast, gdb)
    dev = tbl.device
    tbl, gy = tbl.contiguous(), gy.contiguous()
    flats = [t.contiguous() for t in (u, v, idf)]
    dbs = [t.contiguous() for t in db] if D else flats[:1] * 4  # unread at D = 0
    gda = gda.contiguous() if D else gy  # unread at D = 0
    accumulate = grast is not None
    grast = (torch.empty((2, N), dtype=torch.float32, device=dev) if grast is None
             else grast.clone())
    if gdb is not None:
        gdb = gdb.clone()
    elif D:
        gdb = torch.empty((4, N), dtype=torch.float32, device=dev)
    gval = torch.empty((3 * A, N), dtype=torch.float32, device=dev)
    packed = sum(j << (4 * i) for i, j in enumerate(diff_list))
    BWD_KERNEL.launch(dev, _build.ptr(tbl), tbl.shape[1],
                      *(_build.ptr(t) for t in flats + dbs + [gy, gda, grast, gval]),
                      _build.ptr(grast if gdb is None else gdb), N, A, T, hw, D, packed,
                      int(accumulate))
    return grast, gval, gdb


def interp_backward_plain(tbl, u, v, idf, db, gy, gda, diff_list, T=None, hw=0,
                          grast=None, gdb=None):
    """Plain PyTorch twin of the interpolate backward kernel (same
    arithmetic, interpolate_pallas.py:219-256)."""
    diff_list = tuple(int(j) for j in diff_list)
    A, D, N, T = _check_bwd(tbl, u, v, idf, db, gy, gda, diff_list, T, hw, grast, gdb)
    valid, g = _gathered(tbl, idf, T, hw)
    b0 = torch.where(valid, u, 0.0)
    b1 = torch.where(valid, v, 0.0)
    b2 = torch.where(valid, (1.0 - u) - v, 0.0)
    zero = torch.zeros_like(u)
    gb0, gb1 = (zero, zero) if grast is None else (grast[0], grast[1])
    ga = [None] * (3 * A)
    for a in range(A):
        gb0 = gb0 + gy[a] * (g[a] - g[2 * A + a])
        gb1 = gb1 + gy[a] * (g[A + a] - g[2 * A + a])
        ga[a] = b0 * gy[a]
        ga[A + a] = b1 * gy[a]
        ga[2 * A + a] = b2 * gy[a]
    if D:
        ux, uy, vx, vy = (torch.where(valid, t, 0.0) for t in db)
        gd = [zero] * 4 if gdb is None else list(gdb)
        for jj, j in enumerate(diff_list):
            gdax = gda[2 * jj]
            gday = gda[2 * jj + 1]
            c0 = ux * gdax + uy * gday
            c1 = vx * gdax + vy * gday
            ga[j] = ga[j] + c0
            ga[A + j] = ga[A + j] + c1
            ga[2 * A + j] = ga[2 * A + j] - c0 - c1
            dsdu = g[j] - g[2 * A + j]
            dsdv = g[A + j] - g[2 * A + j]
            gd[0] = gd[0] + gdax * dsdu
            gd[1] = gd[1] + gday * dsdu
            gd[2] = gd[2] + gdax * dsdv
            gd[3] = gd[3] + gday * dsdv
        gdb = torch.where(valid, torch.stack(gd), 0.0)
    return (torch.stack([gb0, gb1]), torch.where(valid, torch.stack(ga), 0.0), gdb)
