"""Deterministic sum of pixel columns into table rows: one CUDA kernel
(torch).

Counterpart of ``nvdiffrast_tpu/ops/scatter.py`` (``scatter_add_by_id``;
its Pallas kernel ``_scatter_pallas``): ``out[r, k]`` is the sum of
``vals_t[k, i]`` over the columns i with ``ids[i] == r``; ids outside
[0, R) are dropped. ``scatter_add_by_id`` keys the live columns by id
and stable-sorts them (index glue, ``entries``), then launches
``csrc/scatter_rows.cu``, which sums each row's columns in float64 in
pieces of ``PIECE`` and rounds once: no float atomics, the same bits on
every run. ``scatter_add_by_id_plain`` sums with ``index_add_`` in
float64; the two agree within 1 float32 ulp. The backwards of
``rasterize``, ``interpolate`` and ``antialias`` end in it.
"""

import ctypes

import torch

from .. import _build

KERNEL = _build.Kernel(
    "nvdr_scatter_rows",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4)

PIECE = 256  # entries per piece of a row's segment (csrc/scatter_rows.cu)


def _check(ids, vals_t, num_rows):
    if vals_t.ndim != 2 or vals_t.dtype != torch.float32:
        raise ValueError("scatter_add_by_id: vals_t must be float32 [K, N]; got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    if ids.shape != (vals_t.shape[1],) or ids.dtype != torch.int32 \
            or ids.device != vals_t.device:
        raise ValueError(f"scatter_add_by_id: ids must be int32 [{vals_t.shape[1]}] "
                         "on the device of vals_t")
    if num_rows < 0:
        raise ValueError(f"scatter_add_by_id: num_rows {num_rows} < 0")


def entries(ids, vals_t, num_rows):
    """Index glue of the scatter_rows kernel.

    Returns (codes [M] int32, off [R+1] int32, first [R+1] int32,
    n_pieces): the live columns (id in [0, R) and a non-zero column; a
    zero column adds exactly nothing to a sum that starts at +0) sorted
    stably by id, so each row's columns are in column order; row r holds
    codes[off[r]:off[r+1]], split into pieces of PIECE numbered
    first[r] .. first[r+1]-1.
    """
    live = (ids >= 0) & (ids < num_rows) & (vals_t != 0.0).any(0)
    codes = torch.nonzero(live).squeeze(1)
    keys, order = torch.sort(ids[codes], stable=True)
    rows = torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device)
    off = torch.searchsorted(keys, rows, out_int32=True)
    counts = (off[1:] - off[:-1] + (PIECE - 1)) // PIECE
    first = torch.cat([off.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    return codes[order].to(torch.int32), off, first, int(first[-1])


def scatter_add_by_id(ids, vals_t, num_rows):
    """out[r, k] = sum over i with ids[i] == r of vals_t[k, i].

    Args:
      ids: [N] int32 row ids; ids outside [0, num_rows) are dropped.
      vals_t: [K, N] float32, channel-major.
      num_rows: R.

    Returns [R, K] float32. CPU tensors run the plain twin; CUDA tensors
    launch the kernel or raise.
    """
    if vals_t.device.type == "cpu":
        return scatter_add_by_id_plain(ids, vals_t, num_rows)
    if vals_t.device.type != "cuda":
        raise ValueError(f"scatter_add_by_id: unsupported device {vals_t.device}")
    _check(ids, vals_t, num_rows)
    vals_t = vals_t.contiguous()
    return scatter_entries(*entries(ids, vals_t, num_rows), vals_t)


def scatter_entries(codes, off, first, n_pieces, vals_t):
    """Launch the scatter_rows kernel on entries from ``entries``:
    [R, K] float32."""
    K, N = vals_t.shape
    R = off.shape[0] - 1
    dev = vals_t.device
    partial = torch.empty((max(n_pieces, 1), K), dtype=torch.float64, device=dev)
    out = torch.empty((R, K), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, _build.ptr(codes), _build.ptr(off), _build.ptr(first),
                  _build.ptr(vals_t), _build.ptr(partial), _build.ptr(out), R, n_pieces,
                  N, K)
    return out


def scatter_add_by_id_plain(ids, vals_t, num_rows):
    """Plain PyTorch twin of scatter_add_by_id: index_add_ in float64,
    rounded to float32 once."""
    _check(ids, vals_t, num_rows)
    K = vals_t.shape[0]
    ok = (ids >= 0) & (ids < num_rows)
    acc = torch.zeros((num_rows + 1, K), dtype=torch.float64, device=vals_t.device)
    acc.index_add_(0, torch.where(ok, ids, num_rows).long(), vals_t.T.double())
    return acc[:num_rows].float()
