"""The texture gradient's pre-reduced index structure (torch, plain twin;
no GPU needed).

``texture_bwd_cuda.tile_entries_plain`` is the twin of what the
texture_grad kernels build on the card: one float64 partial sum per
(texel, 16x16 screen tile) that a kept tap falls on. For every filter x
boundary x texture count (one, or one per image):

* each texel's entries summed in float64 and rounded once are within 1
  float32 ulp of ``texture_grad_plain`` (float64 ``index_add_`` over the
  taps; the sums differ only in order);
* every kept tap (non-zero weight factors, inside the texture for the
  zero boundary) appears exactly once: the entries' tap counts add up to
  the kept taps, entry by entry;
* the entries are sorted by (texel, tile) without repeats, and a texel no
  kept tap reaches has none.

The inputs (numpy, from a seed) put a third of the pixels on uv = (0, 0)
at level 0 (the unmasked background's hot spot) and spread the rest over
uv in [-0.3, 1.3] and every mip level.
"""

import numpy as np
import pytest
import torch

from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

SHAPE = (2, 20, 37)  # B, H, W: partial tiles on both edges


def _case(filter_mode, D):
    rng = np.random.default_rng(3 + D)
    B, H, W = SHAPE
    N = B * H * W
    tex = torch.from_numpy(rng.random((D, 16, 32, 3), dtype=np.float32))
    levels = [tex] + tx.build_mip_stack(tex)
    meta, n_tex = tx._static_meta(levels)
    u, v = (rng.uniform(-0.3, 1.3, N).astype(np.float32) for _ in range(2))
    fl = rng.uniform(0, len(meta) - 1, N).astype(np.float32)
    hot = rng.random(N) < 1 / 3
    u[hot] = v[hot] = fl[hot] = 0.0
    gc = rng.standard_normal((3, N)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (u, v, fl, gc)]
    return (*t, meta, n_tex, SHAPE, D > 1), filter_mode


@pytest.mark.parametrize("D", [1, 2], ids=["one_texture", "per_image"])
@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-linear"])
def test_tile_entries_twin(filter_mode, boundary_mode, D):
    (u, v, fl, gc, meta, n_tex, shape, per_image), _ = _case(filter_mode, D)
    args = (u, v, fl, gc, meta, n_tex, shape, per_image, boundary_mode, filter_mode)
    texel, tile, partial, count = tb.tile_entries_plain(*args)

    # Per-texel sums within 1 ulp of the float64 index_add_ twin.
    ref = tb.texture_grad_plain(*args)
    got = torch.zeros((n_tex, 3), dtype=torch.float64).index_add_(0, texel, partial).float()
    ulp = torch.from_numpy(np.spacing(np.abs(ref.numpy())))
    assert bool(((got - ref).abs() <= ulp).all())
    assert bool((got[ref == 0] == 0).all())

    # Every kept tap exactly once.
    B, H, W = shape
    ntx, nty, n_tiles = tb._tile_blocks(shape)
    p = torch.arange(B * H * W)
    ptile = ((p // (H * W)) * nty + (p // W) % H // tb.GRAD_TILE) * ntx + p % W // tb.GRAD_TILE
    keys = torch.cat([(t * n_tiles + ptile)[ok & (lwv != 0) & (uw != 0)]
                      for t, lwv, uw, ok in tb.lattice_taps(u, v, fl, meta, shape, per_image,
                                                            boundary_mode, filter_mode)])
    assert int(count.sum()) == keys.shape[0] > 0
    ekeys = texel * n_tiles + tile
    assert bool((ekeys[1:] > ekeys[:-1]).all())
    assert torch.equal(torch.bincount(keys, minlength=int(ekeys.max()) + 1)[ekeys], count)
    assert set(torch.unique(keys).tolist()) == set(ekeys.tolist())
    # The hot spot: the uv = (0, 0) texels gather entries from most tiles.
    assert int(torch.bincount(texel).max()) >= n_tiles // 2
