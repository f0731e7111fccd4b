"""Deterministic sum of pixel columns into table rows: one CUDA kernel
(torch).

Counterpart of ``nvdiffrast_tpu/ops/scatter.py`` (``scatter_add_by_id``;
its Pallas kernel ``_scatter_pallas``): ``out[r, k]`` is the sum of
``vals_t[k, i]`` over the columns i with ``ids[i] == r``; ids outside
[0, R) are dropped. On the card ``scatter_add_by_id`` launches
``csrc/scatter_rows.cu``: each chunk of ``CHUNK`` consecutive columns
sums its own live columns by id in shared memory into float64 partials
(``chunk_partials``), which are sorted by id and added in a fixed order
by the shared ``csrc/segment_sum.cu`` sums (``segments``), rounded
once: no float atomics, the same bits on every run, one host sync (the
partials' count). ``chunk_partials_plain`` is the plain twin of the
partials, bit for bit; ``scatter_add_by_id_plain`` sums with
``index_add_`` in float64; the two agree within 1 float32 ulp. The
backwards of ``rasterize``, ``interpolate`` and ``antialias`` end in it,
and it sums the cube and ``nearest`` texture taps.
"""

import ctypes

import torch

from .. import _build
from . import segments

KERNEL = _build.Kernel(
    "nvdr_scatter_rows",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3)
# The second pass of the same entry: the scratch moved into place, and
# the chunks of more than CAP ids computed again.
COMPACT_KERNEL = _build.Kernel("nvdr_scatter_rows_compact", KERNEL.argtypes,
                               symbol="nvdr_scatter_rows")
SEGMENT_KERNEL = _build.Kernel("nvdr_scatter_rows_segments", segments.SEGMENT_ARGS,
                               symbol="nvdr_segment_starts")
SUM_KERNEL = _build.Kernel("nvdr_scatter_rows_sum", segments.SUM_ARGS,
                           symbol="nvdr_segment_sums")

CHUNK = 256  # consecutive columns a block pre-reduces (csrc/scatter_rows.cu CHUNK)
CAP = 32     # partials a chunk keeps in the first pass's scratch (csrc/scatter_rows.cu CAP)


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


def scatter_add_by_id(ids, vals_t, num_rows):
    """out[r, k] = sum over i with ids[i] == r of vals_t[k, i].

    Args:
      ids: [N] int32 row ids; ids outside [0, num_rows) are dropped.
      vals_t: [K, N] float32, channel-major.
      num_rows: R.

    Returns [R, K] float32. CPU tensors run the plain twin; CUDA tensors
    launch the kernels or raise.
    """
    if vals_t.device.type == "cpu":
        return scatter_add_by_id_plain(ids, vals_t, num_rows)
    if vals_t.device.type != "cuda":
        raise ValueError(f"scatter_add_by_id: unsupported device {vals_t.device}")
    ids, partial, _ = chunk_partials(ids, vals_t, num_rows)
    return segments.row_sums(ids, partial, num_rows, SEGMENT_KERNEL, SUM_KERNEL)


def chunk_tiles(ids, vals_t, num_rows):
    """(launch, chunks, K, cap): the chunks pass of csrc/scatter_rows.cu
    on CUDA tensors, as ``segments.tile_partials`` runs it."""
    _check(ids, vals_t, num_rows)
    K, N = vals_t.shape
    if N >= 2 ** 31 - CHUNK:
        raise ValueError(f"scatter_add_by_id: {N} columns; at most 2**31 - {CHUNK + 1}")
    if num_rows == 0 or K == 0:
        N = 0  # nothing to sum: no chunk
    ids, vals_t = ids.contiguous(), vals_t.contiguous()

    def launch(offsets, counts, id_s, part_s, id_, partial):
        kernel = KERNEL if offsets is None else COMPACT_KERNEL
        kernel.launch(vals_t.device, _build.ptr(ids), _build.ptr(vals_t),
                      *(None if x is None else _build.ptr(x) for x in (
                          offsets, counts, id_s, part_s, id_, partial)), N, K, num_rows)

    return launch, -(-N // CHUNK), K, CAP


def chunk_partials(ids, vals_t, num_rows):
    """The per-chunk pre-reduction on CUDA tensors (csrc/scatter_rows.cu,
    two passes around the one host sync): (id [E] int32, partial [E, K]
    float64, counts [chunks] int32), chunk-major, each chunk's ids
    ascending: chunk c (columns [CHUNK c, CHUNK (c + 1))) holds counts[c]
    partials, the sums of its live columns of one id."""
    return segments.tile_partials(*chunk_tiles(ids, vals_t, num_rows), vals_t.device,
                                  "scatter_add_by_id")


def chunk_partials_plain(ids, vals_t, num_rows):
    """Plain twin of ``chunk_partials``: (id [E], chunk [E], partial [E,
    K] float64, columns [E]) in the kernel's order (chunk, then id), each
    partial the kernel's bit for bit: a chunk's live columns (id in
    [0, R), a non-zero value) of one id, summed as ``segments.run_sums``."""
    _check(ids, vals_t, num_rows)
    live = (ids >= 0) & (ids < num_rows) & (vals_t != 0.0).any(0)
    col = torch.nonzero(live).squeeze(1)
    chunk, id_, partial, n = segments.run_sums(col // CHUNK, ids[col].long(), col % CHUNK,
                                               vals_t[:, col].T)
    return id_, chunk, partial, n


def scatter_add_by_id_plain(ids, vals_t, num_rows):
    """Plain PyTorch twin of scatter_add_by_id: index_add_ in float64,
    rounded to float32 once."""
    _check(ids, vals_t, num_rows)
    K = vals_t.shape[0]
    ok = (ids >= 0) & (ids < num_rows)
    acc = torch.zeros((num_rows + 1, K), dtype=torch.float64, device=vals_t.device)
    acc.index_add_(0, torch.where(ok, ids, num_rows).long(), vals_t.T.double())
    return acc[:num_rows].float()
