"""Deterministic segmented sums shared by the gradient reductions (torch).

The texture gradient (``texture_bwd_cuda``, B13), the render pipeline's
gradient scatter (``pipeline_bwd_cuda.grad_scatter``, B4) and the
standalone ops' row scatter (``scatter.scatter_add_by_id``, B10) reduce
in the same three steps on the card:

1. a tile pass (one block per screen tile or column chunk) groups its
   own entries by row in shared memory and writes one float64 partial
   sum per (row, tile): the first run keeps up to a cap (the kernel's
   CAP) a tile in a scratch, the entry total is read back once (the one
   host sync) to allocate the partials, and the second run moves them
   into place (``csrc/segment_sum.cu`` compact) and computes the tiles of
   more than the cap again (``tile_partials``);
2. the partials are sorted stably by row (``row_sums``);
3. ``csrc/raster_bin.cu``'s segment starts and ``csrc/segment_sum.cu``'s
   sums add each row's partials in sorted order and round once.

``run_sums`` is the plain twin of step 1's arithmetic: the partials of
runs of equal (tile, row) as one warp of a tile pass sums them.
"""

import ctypes

import torch

from .. import _build

# nvdr_segment_starts (csrc/raster_bin.cu): also the rasterizer's binning.
SEGMENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int] + [ctypes.c_void_p] * 4
SUM_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int] * 2


def tile_partials(launch, n_tiles, width, cap, device, what):
    """Run a tile pass twice around the one host sync.

    ``launch(offsets, counts, key_s, part_s, key, partial)`` launches the
    pass: first with offsets None (counts and the scratch of cap slots a
    tile, key_s [n_tiles * cap] int32, part_s [n_tiles * cap, width]
    float64),
    then with the counts' exclusive scan (the partials at their offsets
    of key [E] int32 and partial [E, width] float64). Returns (key,
    partial, counts), tile-major.
    """
    i32 = dict(dtype=torch.int32, device=device)
    counts = torch.empty((n_tiles,), **i32)
    key_s = torch.empty((n_tiles * cap,), **i32)
    part_s = torch.empty((n_tiles * cap, width), dtype=torch.float64, device=device)
    if n_tiles:
        launch(None, counts, key_s, part_s, None, None)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(ends[-1]) if n_tiles else 0  # the one host sync
    if total >= 2 ** 31:
        raise ValueError(f"{what}: {total} partial sums; at most 2**31 - 1")
    key = torch.empty((total,), **i32)
    partial = torch.empty((total, width), dtype=torch.float64, device=device)
    if total:
        launch(ends - counts, counts, key_s, part_s, key, partial)
    return key, partial, counts


def row_sums(key, partial, n_rows, segment_kernel, sum_kernel):
    """out [n_rows, K] float32: each row's partials (key [E] int32,
    partial [E, K] float64) summed in float64 in their stable-sorted
    order and rounded once; 0 for a row without partials."""
    dev = partial.device
    E, K = partial.shape
    out = torch.empty((n_rows, K), dtype=torch.float32, device=dev)
    if n_rows == 0 or K == 0:
        return out
    skey, perm = torch.sort(key, stable=True)
    starts = torch.empty((n_rows + 1,), dtype=torch.int32, device=dev)
    segment_kernel.launch(dev, _build.ptr(skey), E, 0, n_rows, 4, None, None,
                          _build.ptr(starts), None)
    pp = torch.empty((max(E, 1), K), dtype=torch.float64, device=dev)
    sum_kernel.launch(dev, _build.ptr(skey), _build.ptr(perm), E, _build.ptr(starts),
                      _build.ptr(partial), _build.ptr(pp), _build.ptr(out), n_rows, K)
    return out


PIECE = 64  # sorted positions a warp sums (csrc/segment_sum.cuh PIECE)


def _butterfly(x):
    """[..., 32, W] -> [..., W]: segment_sum.cuh warp_sum's order."""
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h, :] + x[..., h:2 * h, :]
    return x[..., 0, :]


def run_sums(tile, key, item, vals):
    """Plain twin of a tile pass's partial sums.

    Entries (tile [M], key [M], item [M] int64, vals [M, W] float32) are
    grouped into runs of equal (tile, key), in the order tile, key, item
    (a stable radix sort over a tile's items). A run is cut into pieces
    of PIECE entries, one warp's each: the piece's entry j goes to lane
    j % 32, which adds it in float64 in turn j // 32 to a sum that starts
    at +0, and the 32 lane sums are added by the butterfly of
    ``csrc/segment_sum.cuh`` warp_sum; a run's piece sums are then added
    in piece order (in a chunk of more than 32 runs ``csrc/scatter_rows.cu``
    gives a run of at most 8 entries to one thread that replays that
    butterfly: the same bits).
    Returns (tile [E], key [E], partial [E, W] float64,
    entries [E] int64), runs by tile, then key: the kernel's partials bit
    for bit, given the same float32 values.
    """
    dev = vals.device
    Wd = vals.shape[1]
    order = torch.argsort(item, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    order = order[torch.argsort(tile[order], stable=True)]
    t, k, v = tile[order], key[order], vals[order].double()
    M = t.shape[0]
    if M == 0:
        return t, k, v, torch.zeros((0,), dtype=torch.int64, device=dev)
    head = torch.ones((M,), dtype=torch.bool, device=dev)
    head[1:] = (t[1:] != t[:-1]) | (k[1:] != k[:-1])
    run = torch.cumsum(head, 0) - 1
    first = torch.nonzero(head).squeeze(1)
    n = torch.diff(torch.cat([first, first.new_tensor([M])]))
    j = torch.arange(M, device=dev) - first[run]
    # Pieces: run r's piece i is global piece pfirst[r] + i.
    npieces = (n + PIECE - 1) // PIECE
    pfirst = torch.cumsum(npieces, 0) - npieces
    piece = pfirst[run] + j // PIECE
    jp = j % PIECE
    P = int(npieces.sum())
    lanes = torch.zeros((P * 32, Wd), dtype=torch.float64, device=dev)
    for m in range(PIECE // 32):
        sel = jp // 32 == m  # one entry a lane per turn: one float64 add each
        lanes.index_add_(0, (piece * 32 + jp % 32)[sel], v[sel])
    sums = _butterfly(lanes.view(P, 32, Wd))
    partial = sums[pfirst].clone()
    for i in range(1, int(npieces.max())):
        more = torch.nonzero(npieces > i).squeeze(1)
        partial[more] = partial[more] + sums[pfirst[more] + i]
    return t[first], k[first], partial, n
