"""Port parity: ``DepthPeeler`` (torch, plain twins) vs the JAX package's
in ``impl="pallas_interpret"``.

* tests/test_parity_sweep.py:287's scene (30 random triangles on
  distinct z planes, (67, 96), B = 2), 3 layers: ids bit for bit, the
  other channels within 1e-5; the same with the scene as one 2-D pos in
  range mode (B = 2 windows).
* tests/test_rasterize.py:190's stacked triangles peel to ids (2, 1, 0).
* Each layer's depth strictly grows where a pixel is covered in both.
* The guards of tests/test_rasterize.py:208: ``rasterize`` refused
  while a peeler is active, one active peeler per context, no re-entry
  after exit.
* One peeled layer's gradient of a weighted sum of rast and rast_db to
  pos vs ``jax.grad`` (within 5e-5 of the largest, each vertex row
  within 5e-4 of its largest).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvdiffrast_tpu as jdr
import nvdiffrast_tpu_torch as dr

from _torch_parity import GRAD_RTOL, ROW_RTOL

IMPL = "pallas_interpret"
RES = (67, 96)
LAYERS = 3


def _planes_scene():
    """tests/test_parity_sweep.py:287: B = 2, 30 triangles on z planes."""
    rng = np.random.RandomState(7)
    B, T = 2, 30
    tri = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    pos = rng.uniform(-1, 1, (B, 3 * T, 4)).astype(np.float32)
    pos[..., 3] = 1.0
    z_planes = np.linspace(-0.8, 0.8, T).astype(np.float32)
    for t in range(T):
        pos[:, 3 * t:3 * t + 3, 2] = z_planes[t]
    return pos, tri


def _range_args(pos, tri):
    """The same scene's first view as one 2-D pos, two id windows."""
    return pos[0], np.array([[0, 30], [6, 20]], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_layers(ranged):
    pos, tri = _planes_scene()
    kw = {}
    if ranged:
        pos, ranges = _range_args(pos, tri)
        kw["ranges"] = jnp.asarray(ranges)
    with jdr.DepthPeeler(jdr.RasterizeCudaContext(), jnp.asarray(pos), jnp.asarray(tri), RES,
                         impl=IMPL, **kw) as peeler:
        return [tuple(np.asarray(x) for x in peeler.rasterize_next_layer())
                for _ in range(LAYERS)]


@pytest.mark.parametrize("ranged", [False, True], ids=["instance", "range"])
def test_depth_peeler_matches_jax(ranged):
    pos, tri = _planes_scene()
    kw = {}
    if ranged:
        pos, ranges = _range_args(pos, tri)
        kw["ranges"] = torch.from_numpy(ranges)
    p, t = torch.from_numpy(pos), torch.from_numpy(tri)
    with dr.DepthPeeler(dr.RasterizeCudaContext(), p, t, RES, **kw) as peeler:
        layers = [peeler.rasterize_next_layer() for _ in range(LAYERS)]
    prev = None
    for (rast, db), (ref, ref_db) in zip(layers, _jax_layers(ranged)):
        np.testing.assert_array_equal(rast[..., 3].numpy(), ref[..., 3])
        np.testing.assert_allclose(rast.numpy(), ref, atol=1e-5)
        np.testing.assert_allclose(db.numpy(), ref_db, atol=1e-5)
        assert (ref[..., 3] > 0).sum() > 200
        if prev is not None:
            both = (prev[..., 3] > 0) & (rast[..., 3] > 0)
            assert bool(both.any()) and bool((rast[..., 2][both] > prev[..., 2][both]).all())
        prev = rast
    # Layer 0 is the plain render.
    assert torch.equal(layers[0][0], dr.rasterize(None, p, t, RES, **kw)[0])


def test_depth_peeler_stacked_triangles():
    """tests/test_rasterize.py:190: two stacked triangles peel
    nearest-first, then nothing."""
    pos = torch.tensor(
        [[[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0],
          [-0.5, -0.5, -0.5, 1.0], [0.5, -0.5, -0.5, 1.0], [0.0, 0.5, -0.5, 1.0]]])
    tri = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    with dr.DepthPeeler(dr.RasterizeCudaContext(), pos, tri, (32, 32)) as peeler:
        ids = [int(peeler.rasterize_next_layer()[0][0, 16, 16, 3]) for _ in range(3)]
    assert ids == [2, 1, 0]


def test_depth_peeler_guards():
    pos, tri = (torch.from_numpy(x) for x in _planes_scene())
    ctx = dr.RasterizeCudaContext()
    peeler = dr.DepthPeeler(ctx, pos, tri, (16, 16))
    with peeler:
        with pytest.raises(RuntimeError, match="depth peeling"):
            dr.rasterize(ctx, pos, tri, (16, 16))
        with pytest.raises(RuntimeError, match="multiple depth peelers"):
            with dr.DepthPeeler(ctx, pos, tri, (16, 16)):
                pass
        peeler.rasterize_next_layer()
    assert ctx.active_depth_peeler is None
    dr.rasterize(ctx, pos, tri, (16, 16))  # allowed again after exit
    with pytest.raises(RuntimeError, match="re-enter"):
        with peeler:
            pass
    with pytest.raises(ValueError, match="range mode requires"):
        dr.DepthPeeler(ctx, pos[0], tri, (16, 16))
    with pytest.raises(ValueError):
        dr.DepthPeeler(ctx, pos, tri, (16, 16), grad_db=1)


@functools.lru_cache(maxsize=None)
def _weights():
    rng = np.random.default_rng(1)
    return tuple(rng.standard_normal((2, 2) + RES + (4,)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_layer1_grad():
    pos, tri = _planes_scene()
    w1, w2 = _weights()

    def loss(p):
        with jdr.DepthPeeler(jdr.RasterizeCudaContext(), p, jnp.asarray(tri), RES,
                             impl=IMPL) as peeler:
            peeler.rasterize_next_layer()
            rast, db = peeler.rasterize_next_layer()
        return jnp.sum(rast * w1) + jnp.sum(db * w2)

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(pos)))


def test_peeled_layer_grad_matches_jax():
    pos, tri = _planes_scene()
    w1, w2 = _weights()
    p, t = torch.from_numpy(pos).requires_grad_(), torch.from_numpy(tri)
    with dr.DepthPeeler(dr.RasterizeCudaContext(), p, t, RES) as peeler:
        peeler.rasterize_next_layer()
        rast, db = peeler.rasterize_next_layer()
    loss = (rast * torch.from_numpy(w1)).sum() + (db * torch.from_numpy(w2)).sum()
    got = torch.autograd.grad(loss, p)[0].numpy()
    ref = _jax_layer1_grad()
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= GRAD_RTOL * scale
    g, r = got.reshape(-1, 4), ref.reshape(-1, 4)
    assert not (np.abs(g - r) > ROW_RTOL * np.abs(r).max(1, keepdims=True)).any()
