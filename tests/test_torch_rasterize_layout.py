"""The rasterize op's output layout on the CPU path (plain twins).

The op (``dr.rasterize`` and ``DepthPeeler.rasterize_next_layer``) asks
the sweep for its ``[B, H, W, 4]`` layout, which the kernel writes with
one 16-byte store a pixel and the twin builds by stacking its columns.

* In instance (without and with db), binned, range, viewport and peel
  mode, rast and rast_db are contiguous ``[B, H, W, 4]`` float32 tensors
  equal to the stacked columns of ``rasterize_fused`` (the pipelines'
  planar layout) on the same inputs.
* The op's backward reads the id channel of rast: its ``g_pos`` is bit
  for bit ``raster_pos_grad`` of the planar id column.
"""

import numpy as np
import pytest
import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.rasterize import raster_pos_grad
from nvdiffrast_tpu_torch.ops.topology import vertex_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (24, 32)
MODES = ["instance", "db", "binned", "range", "viewport", "peel"]


def _scene():
    """B = 2 sphere views plus a triangle behind the sphere that covers a
    quarter of each view (so a peeled layer has pixels)."""
    pos, tri, _, _ = sphere_scene(B=2, seed=5)
    V = pos.shape[1]
    big = np.array([[-1.0, -1.0, 0.9, 1.0], [0.4, -1.0, 0.9, 1.0],
                    [-1.0, 0.4, 0.9, 1.0]], np.float32)
    pos = np.concatenate([pos, np.broadcast_to(big, (2, 3, 4))], axis=1)
    tri = np.concatenate([tri, [[V, V + 1, V + 2]]]).astype(np.int32)
    return inputs_from_numpy(pos, tri)


def _run(mode, monkeypatch):
    """(pos leaf, tri, op outputs (rast, rast_db), the planar columns of
    rasterize_fused on the same inputs, grad_db, viewport)."""
    p, t = _scene()
    if mode == "binned":
        monkeypatch.setattr(rc, "BIN_MIN_WORK", 0)
    T = t.shape[0]
    grad_db = mode != "instance"
    ranges = viewport = peel = None
    if mode == "range":
        p = p[1]
        ranges = torch.tensor([[0, T], [10, T - 30]], dtype=torch.int32)
    if mode == "viewport":
        viewport = (8, 40)
    pv = p.clone().requires_grad_()
    if mode == "peel":
        with dr.DepthPeeler(dr.RasterizeCudaContext(), pv, t, RES) as peeler:
            peeler.rasterize_next_layer()
            out = peeler.rasterize_next_layer()
        peel = rc.rasterize_fused(p, t, RES, emit_zbuf=True)[4]
    else:
        out = dr.rasterize(None, pv, t, RES, ranges=ranges, grad_db=grad_db, viewport=viewport)
    cols = rc.rasterize_fused(p, t, RES, ranges=ranges, peel_depth=peel, viewport=viewport,
                              emit_db=True)
    return pv, t, out, cols, grad_db, viewport


@pytest.mark.parametrize("mode", MODES)
def test_rasterize_returns_stacked_columns(mode, monkeypatch):
    _, _, (rast, db), cols, _, _ = _run(mode, monkeypatch)
    for x, c in ((rast, cols[:4]), (db, cols[4:8])):
        assert x.shape == (2,) + RES + (4,)
        assert x.dtype == torch.float32 and x.is_contiguous()
        assert torch.equal(x, torch.stack(c, dim=-1))
    assert int((cols[3] > 0).sum()) > 100


@pytest.mark.parametrize("mode", MODES)
def test_rasterize_backward_reads_the_id_channel(mode, monkeypatch):
    pv, t, (rast, db), cols, grad_db, viewport = _run(mode, monkeypatch)
    rng = np.random.default_rng(3)
    w1, w2 = (torch.from_numpy(rng.standard_normal(rast.shape).astype(np.float32))
              for _ in range(2))
    (g,) = torch.autograd.grad((rast * w1).sum() + (db * w2).sum(), pv)
    N = rast.numel() // 4
    ddb = tuple(w2.reshape(N, 4).T) if grad_db else None
    with torch.no_grad():
        ref = raster_pos_grad(vertex_table(pv, t), t, tuple(pv.shape), cols[3].reshape(N),
                              *w1.reshape(N, 4).T[:2], ddb, RES, viewport)
    assert float(ref.abs().max()) > 0
    assert torch.equal(g, ref)
