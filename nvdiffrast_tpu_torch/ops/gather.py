"""Per-pixel lookup of per-triangle table rows: one CUDA kernel (torch).

Counterpart of ``nvdiffrast_tpu/ops/gather.py`` (``table_take``; its
Pallas kernel ``_take_pallas``). ``table_take`` launches
``csrc/table_take.cu``, one thread per pixel loading its table column;
``table_take_plain`` is its plain PyTorch twin. The rasterize backward
gathers its 9-column clip-space vertex table with it.
"""

import ctypes

import torch

from .. import _build

KERNEL = _build.Kernel(
    "nvdr_table_take",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int])


def _check(tbl_t, rid):
    if tbl_t.ndim != 2 or tbl_t.shape[1] < 1 or tbl_t.dtype != torch.float32:
        raise ValueError("table_take: tbl_t must be a float32 [K, T] table; got "
                         f"{tuple(tbl_t.shape)} {tbl_t.dtype}")
    if rid.ndim != 1 or rid.dtype != torch.int32 or rid.device != tbl_t.device:
        raise ValueError("table_take: rid must be int32 [N] on the table's device")


def table_take(tbl_t, rid):
    """out[k, i] = tbl_t[k, rid[i]]; an id outside [0, T) gives zeros.

    Args:
      tbl_t: [K, T] float32 channel-major table.
      rid: [N] int32 ids.

    Returns [K, N] float32. CPU tensors run the plain twin; CUDA tensors
    launch the kernel or raise.
    """
    if tbl_t.device.type == "cpu":
        return table_take_plain(tbl_t, rid)
    if tbl_t.device.type != "cuda":
        raise ValueError(f"table_take: unsupported device {tbl_t.device}")
    _check(tbl_t, rid)
    tbl_t = tbl_t.contiguous()
    rid = rid.contiguous()
    K, T = tbl_t.shape
    N = rid.shape[0]
    out = torch.empty((K, N), dtype=torch.float32, device=tbl_t.device)
    KERNEL.launch(tbl_t.device, _build.ptr(tbl_t), T, _build.ptr(rid), _build.ptr(out),
                  K, N)
    return out


def table_take_plain(tbl_t, rid):
    """Plain PyTorch twin of the table_take kernel."""
    _check(tbl_t, rid)
    ok = (rid >= 0) & (rid < tbl_t.shape[1])
    return torch.where(ok, tbl_t[:, torch.where(ok, rid, 0).long()], 0.0)
