"""The rasterizer's record setup and the sweep's candidate rule (torch,
plain twins; no GPU needed).

* The sweep evaluates a candidate on a warp's 8x4 pixel block only when
  the candidate's AABB meets the block (``rasterize_cuda.CULL``); the
  twin follows the same rule. Because the AABBs include the coverage
  slop, that rule gives the same bits as evaluating every pixel of the
  tiles the AABB meets (CULL = one 16x16 tile): checked bit for bit,
  unbinned and binned, on tests/test_parity_sweep.py's sliver scenes
  (:166) and escapee triangles (:247) and on the random scene with
  near-plane crossers and duplicate-vertex triangles.
* ``setup_records`` on CPU tensors: the records and AABBs of
  ``build_records``, the tile counts the binning's lists imply, and
  chunk boxes that are the union of each 256-record chunk's AABBs.
"""

import numpy as np
import pytest
import torch

from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc

from _torch_parity import random_scene
from test_parity_sweep import _ESCAPEE_VERTS, _sliver_scene


def _escapee_scene():
    """tests/test_parity_sweep.py:247's triangles on distinct depths."""
    v = np.asarray(_ESCAPEE_VERTS, np.float32).reshape(-1, 3, 4)
    T = v.shape[0]
    v[..., 2] = np.linspace(-0.45, 0.45, T, dtype=np.float32)[:, None] * v[..., 3]
    return v.reshape(1, -1, 4), np.arange(3 * T, dtype=np.int32).reshape(T, 3)


def _scene(case):
    if case == "escapees":
        pos, tri = _escapee_scene()
        res = (256, 256)
    elif case.startswith("sliver"):
        pos, tri = (np.asarray(x) for x in _sliver_scene(int(case[-1])))
        res = (192, 256)
    else:
        pos, tri = random_scene(1, B=2)
        res = (67, 130)
    return torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(tri)), res


def _bits(outs):
    return [o.contiguous().view(torch.int32) for o in outs]


@pytest.mark.parametrize("binned", [False, True], ids=["unbinned", "binned"])
@pytest.mark.parametrize("case", ["sliver0", "sliver1", "escapees", "random"])
def test_warp_block_rule_equals_tile_rule(case, binned, monkeypatch):
    p, t, res = _scene(case)
    rec, aabb = rc.build_records(p, t, res)
    bins = rc.bin_records_plain(aabb, res) if binned else None
    got = rc.rasterize_records_plain(rec, aabb, res, True, emit_zbuf=True, bins=bins)
    assert rc.CULL == (8, 4)
    monkeypatch.setattr(rc, "CULL", (rc.RASTER_TILE, rc.RASTER_TILE))
    ref = rc.rasterize_records_plain(rec, aabb, res, True, emit_zbuf=True, bins=bins)
    assert int((ref[3] > 0).sum()) >= 1
    for x, y in zip(_bits(got), _bits(ref)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["random", "escapees"])
def test_setup_records_cpu_twins(case):
    p, t, res = _scene(case)
    rec, aabb, counts, boxes = rc.setup_records(p, t, res)
    r2, a2 = rc.build_records(p, t, res)
    assert torch.equal(rec.view(torch.int32), r2.view(torch.int32))
    assert torch.equal(aabb.view(torch.int32), a2.view(torch.int32))
    # The counts are the lists' lengths per record.
    start, lst = rc.bin_records_plain(aabb, res)
    S, T, _ = aabb.shape
    ntx, nty = rc._tile_grid(res)
    seg = torch.repeat_interleave(torch.arange(S * ntx * nty), (start[1:] - start[:-1]).long())
    rows = (seg // (ntx * nty)) * T + lst.long()
    assert torch.equal(counts.long(), torch.bincount(rows, minlength=S * T))
    # The chunk boxes: min / max of each chunk's AABBs.
    a = aabb.numpy()
    for s in range(S):
        for c in range(boxes.shape[1]):
            chunk = a[s, c * rc.CHUNK:(c + 1) * rc.CHUNK]
            want = np.concatenate([chunk[:, :2].min(0), chunk[:, 2:].max(0)])
            assert np.array_equal(boxes[s, c].numpy(), want)


def test_setup_records_range_and_viewport_cpu():
    p, t, res = _scene("random")
    rec, aabb, counts, boxes = rc.setup_records(p[0], t, res)
    assert rec.shape == (1, t.shape[0], 16) and boxes.shape == (1, 1, 4)
    r2, a2 = rc.build_records(p[0], t, res)
    assert torch.equal(rec, r2) and torch.equal(aabb, a2)
    band = (20, 40)
    rec, aabb, counts, boxes = rc.setup_records(p, t, band, (20, 67))
    r2, a2 = rc.build_records(p, t, band, (20, 67))
    assert torch.equal(aabb, a2)
    assert torch.equal(counts, rc.tile_counts_plain(a2, band))


def test_setup_records_dispatch():
    p, t, res = _scene("random")
    before = (rc.SETUP_KERNEL.launches, rc.BIN_EMIT_KERNEL.launches,
              rc.BIN_SEGMENT_KERNEL.launches)
    rc.rasterize_fused(p, t, res)
    assert (rc.SETUP_KERNEL.launches, rc.BIN_EMIT_KERNEL.launches,
            rc.BIN_SEGMENT_KERNEL.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        rc.setup_records(p.to("meta"), t.to("meta"), res)
