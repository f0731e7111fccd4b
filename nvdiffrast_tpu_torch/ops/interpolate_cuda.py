"""Interpolate forward on flat buffers: one CUDA kernel (torch).

Counterpart of ``nvdiffrast_tpu/ops/interpolate_pallas.py``
(``interp_forward_fused``) together with the masking glue in front of it
(``interpolate._flat_ids``, ``pipeline_tex.py:84-93``). The kernel
``csrc/interpolate_fwd.cu`` (``interp_forward``) takes the rasterizer's
flat (u, v, idf) and bary derivatives and a broadcast attribute table,
and writes the interpolated attributes and their screen derivatives;
``interp_forward_plain`` is its plain PyTorch twin with the same
arithmetic.
"""

import ctypes

import torch

from .. import _build
from . import coord

MAX_A = 16  # attributes served by the kernel (interpolate_pallas._MAX_K / 3)

KERNEL = _build.Kernel(
    "nvdr_interp_fwd",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 4 + [ctypes.c_ulonglong])


def _check(tbl, u, v, idf, db, diff_list):
    K, cols = tbl.shape
    A = K // 3
    N = u.shape[0]
    if K % 3 or not 1 <= A <= MAX_A:
        raise ValueError(f"interp_forward: tbl must be [3A, T+1] with 1 <= A <= "
                         f"{MAX_A}; got {tuple(tbl.shape)}")
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
    return A, D, N, cols - 1


def interp_forward(tbl, u, v, idf, db, diff_list):
    """Interpolated attributes and their screen derivatives.

    Args:
      tbl: [3A, T+1] table of broadcast attributes, row k*A + a =
        channel a of each triangle's vertex k, a zero column last
        (``pipeline._attr_table`` with B = 1).
      u, v, idf: flat [N] rasterizer buffers.
      db: (dudx, dudy, dvdx, dvdy) flat [N], or None without derivatives.
      diff_list: indices of the attributes to differentiate.

    Returns (out [A, N], da [2D, N]) with D = len(diff_list). CPU tensors
    run the plain twin; CUDA tensors launch the kernel or raise.
    """
    diff_list = tuple(int(j) for j in diff_list)
    if tbl.device.type == "cpu":
        return interp_forward_plain(tbl, u, v, idf, db, diff_list)
    if tbl.device.type != "cuda":
        raise ValueError(f"interp_forward: unsupported device {tbl.device}")
    A, D, N, T = _check(tbl, u, v, idf, db, diff_list)
    tbl = tbl.contiguous()
    flats = [t.contiguous() for t in (u, v, idf)]
    dbs = [t.contiguous() for t in db] if D else flats[:1] * 4  # unread at D = 0
    dev = tbl.device
    out = torch.empty((A, N), dtype=torch.float32, device=dev)
    da = torch.empty((2 * D, N), dtype=torch.float32, device=dev)
    packed = sum(j << (4 * i) for i, j in enumerate(diff_list))
    KERNEL.launch(dev, _build.ptr(tbl), tbl.shape[1],
                  *(_build.ptr(t) for t in flats + dbs),
                  _build.ptr(out), _build.ptr(da), N, A, T, D, packed)
    return out, da


def interp_forward_plain(tbl, u, v, idf, db, diff_list):
    """Plain PyTorch twin of the interpolate forward kernel."""
    diff_list = tuple(int(j) for j in diff_list)
    A, D, N, T = _check(tbl, u, v, idf, db, diff_list)
    tid = coord.float_to_triidx(idf) - 1
    valid = (tid >= 0) & (tid < T)
    g = torch.where(valid, tbl[:, torch.where(valid, tid, T).long()], 0.0)
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
