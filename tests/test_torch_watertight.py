"""The port's rasterizer: watertight coverage and the exact-id scenes.

Properties the JAX suite holds its rasterizers to (tests/test_watertight.py,
tests/test_parity_sweep.py), checked on the port (CPU tensors run the
kernel's plain twin, which equals the kernel bit for bit):

* shared mesh edges cover each pixel exactly once, also through pixel
  centers and across the near-clip boundary; both windings render alike;
  degenerate triangles cover nothing;
* on the tie-free sliver and escapee scenes the ids equal the JAX
  package's bit for bit (its XLA path, which those tests hold equal to
  the Pallas kernel).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops.rasterize import rasterize as jrasterize
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from test_parity_sweep import _ESCAPEE_VERTS, _sliver_scene
from test_watertight import _fan, _nearclip_scene, _strictly_inside


def _ids(pos, tri, res):
    p, t = inputs_from_numpy(pos, tri)
    return rc.rasterize_fused(p, t, res)[3].numpy()


def _coverage_per_tri(pos, tri, res):
    """Each triangle rasterized alone -> [T, B, H, W] masks."""
    return np.stack([_ids(pos, tri[k:k + 1], res) > 0
                     for k in range(tri.shape[0])])


def _flat(verts2):
    n = len(verts2)
    return np.concatenate([verts2, np.zeros((n, 1), np.float32),
                           np.ones((n, 1), np.float32)], axis=1)[None]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("res", [(64, 64), (67, 93)])
def test_fan_watertight(seed, res):
    verts2, tri, ring, _ = _fan(7, np.random.RandomState(seed))
    pos = _flat(verts2)
    H, W = res
    total = _coverage_per_tri(pos, tri, res).sum(axis=0)[0]
    assert total.max() <= 1, "double-covered pixels on shared edges"
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    px, py = np.meshgrid(xs, ys)
    inside = _strictly_inside(px, py, ring, margin=4.0 / min(H, W))
    assert (total[inside] == 1).all(), "dropped pixels inside the fan"
    np.testing.assert_array_equal(_ids(pos, tri, res)[0] > 0, total > 0)


def test_pixel_center_edges_exact():
    H = W = 32
    x0, y0 = 1.0 / W, 1.0 / H  # lines through pixel centers
    quad = np.array([[-0.9, -0.9], [x0, -0.9], [0.9, -0.9],
                     [-0.9, y0], [x0, y0], [0.9, y0],
                     [-0.9, 0.9], [x0, 0.9], [0.9, 0.9]], np.float32)
    tris = []
    for r in range(2):
        for c in range(2):
            a = 3 * r + c
            tris += [[a, a + 1, a + 4], [a, a + 4, a + 3]]
    tri = np.asarray(tris, np.int32)
    total = _coverage_per_tri(_flat(quad), tri, (H, W)).sum(axis=0)[0]
    assert total.max() <= 1
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    px, py = np.meshgrid(xs, ys)
    inside = ((px > -0.9 + 0.1 / W) & (px < 0.9 - 0.1 / W)
              & (py > -0.9 + 0.1 / H) & (py < 0.9 - 0.1 / H))
    assert (total[inside] == 1).all()


def test_winding_invariance():
    verts2, tri, _, _ = _fan(6, np.random.RandomState(3))
    p, t_ccw, t_cw = inputs_from_numpy(_flat(verts2), tri, tri[:, ::-1].copy())
    r1 = [x.numpy() for x in rc.rasterize_fused(p, t_ccw, (48, 48))]
    r2 = [x.numpy() for x in rc.rasterize_fused(p, t_cw, (48, 48))]
    np.testing.assert_array_equal(r1[3], r2[3])
    cov = r1[3] > 0
    # (0, 1, 2) -> (2, 1, 0): new b1 = old b1, new b0 = old 1 - b0 - b1.
    np.testing.assert_allclose(r2[1], r1[1], atol=1e-5)
    np.testing.assert_allclose(r2[0][cov], (1 - r1[0] - r1[1])[cov], atol=1e-5)
    np.testing.assert_allclose(r2[2], r1[2], atol=1e-6)


@pytest.mark.parametrize("rot90", [False, True])
def test_nearclip_shared_edge_watertight(rot90):
    pos, tri = (np.asarray(x) for x in _nearclip_scene(rot90))
    res = (96, 96)
    masks = _coverage_per_tri(pos, tri, res)[:, 0]
    m0, m1 = masks
    assert m0.sum() > 50 and m1.sum() > 50
    assert (masks.sum(axis=0) <= 1).all(), "double cover on the clipped edge"
    hole = ~(m0 | m1)
    for ax in (0, 1):
        crack = hole & ((np.roll(m0, 1, ax) & np.roll(m1, -1, ax))
                        | (np.roll(m1, 1, ax) & np.roll(m0, -1, ax)))
        crack[[0, -1]] = False
        crack[:, [0, -1]] = False
        assert not crack.any(), f"crack along axis {ax}"
    np.testing.assert_array_equal(_ids(pos, tri, res)[0] > 0, m0 | m1)


def test_degenerate_triangle_covers_nothing():
    rng = np.random.RandomState(7)
    v = rng.randn(8, 2).astype(np.float32) * 0.7
    w = (1.0 + np.abs(rng.randn(8)) * 0.5).astype(np.float32)
    pos = np.concatenate([v * w[:, None], np.zeros((8, 1), np.float32),
                          w[:, None]], axis=1)
    pos[6] = 0.5 * (pos[4] + pos[5])  # collinear
    tri = np.array([[0, 0, 1], [2, 3, 3], [4, 6, 5], [1, 1, 1]], np.int32)
    assert (_ids(pos[None], tri, (64, 64)) == 0).all()


def test_shared_edge_exact_negation():
    rng = np.random.RandomState(3)
    T, V = 2000, 700
    pos = rng.randn(1, V, 4).astype(np.float32)
    tri_a = rng.randint(0, V, (T, 3)).astype(np.int32)
    tri_b = np.stack([rng.randint(0, V, (T,)).astype(np.int32),
                      tri_a[:, 2], tri_a[:, 1]], axis=1)
    p, ta, tb = inputs_from_numpy(pos, tri_a, tri_b)
    x, y, _, w = rc._gather_tri_cols(p, ta)
    ea = rc._edge_coeffs_cols(x, y, w)
    x, y, _, w = rc._gather_tri_cols(p, tb)
    eb = rc._edge_coeffs_cols(x, y, w)
    for c in range(3):  # A's edge 0 is (v1, v2), B's is (v2, v1)
        assert torch.equal(ea[0][c], -eb[0][c])


@pytest.mark.parametrize("scene", ["sliver0", "escapee"])
def test_exact_id_scenes_match_jax(scene):
    if scene == "escapee":
        v = np.asarray(_ESCAPEE_VERTS, np.float32).reshape(-1, 3, 4)
        T = v.shape[0]
        v[..., 2] = np.linspace(-0.45, 0.45, T, dtype=np.float32)[:, None] * v[..., 3]
        pos = v.reshape(1, -1, 4)
        tri = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
        res = (256, 256)
    else:
        pos, tri = (np.asarray(x) for x in _sliver_scene(0))
        res = (192, 256)
    ref, _ = jrasterize(None, jnp.asarray(pos), jnp.asarray(tri), res, impl="xla")
    ref_ids = np.asarray(ref[..., 3])
    assert (ref_ids > 0).sum() >= 1
    np.testing.assert_array_equal(_ids(pos, tri, res), ref_ids)
