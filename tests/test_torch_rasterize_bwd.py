"""Port parity: the rasterize op's backward (torch) vs the JAX package,
and the composed rasterize -> interpolate -> antialias chain.

* ``torch.autograd.grad`` of the public ``rasterize`` vs ``jax.grad`` of
  JAX ``rasterize(impl="pallas_interpret")`` of a random-weighted sum of
  rast and rast_db, with grad_db True and False: atol 1e-5 / rtol 1e-4
  (tests/test_pipeline.py's gradient bar). The scene adds to the sphere
  a triangle behind it that fills a quarter of each image: one table row
  with ~400 entries per image. The vertex table gather (kernel B9) and
  the reduction (kernel B10) run their twins here.
* grad_db=False drops the rast_db terms (tests/test_rasterize.py:172).
* The composed chain rasterize -> interpolate -> antialias against the
  port's fused ``render_pipeline`` on the same inputs: the same image
  and g_attr bit for bit, g_pos within 1e-6 of its largest entry (the
  two sum the same per-pixel terms into vertices in other orders).
* Entry checks: CPU tensors run the twins; a non-tensor input goes to
  the GPU or raises; range mode and depth peeling raise
  NotImplementedError.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import rasterize as jr
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import gather as tg
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops import scatter as ts
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (32, 48)


@functools.lru_cache(maxsize=None)
def _scene():
    """B = 2 sphere plus a far triangle covering a quarter of each view,
    and the loss weights of rast and rast_db."""
    pos, tri, attr, cidx = sphere_scene(B=2, seed=2)
    V = pos.shape[1]
    big = np.array([[-1.0, -1.0, 0.9, 1.0], [0.4, -1.0, 0.9, 1.0],
                    [-1.0, 0.4, 0.9, 1.0]], np.float32)
    pos = np.concatenate([pos, np.broadcast_to(big, (2, 3, 4))], axis=1)
    tri = np.concatenate([tri, [[V, V + 1, V + 2]]]).astype(np.int32)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 2) + RES + (4,)).astype(np.float32)
    return pos, tri, w[0], w[1]


@functools.lru_cache(maxsize=None)
def _jax_grads():
    pos, tri, w1, w2 = _scene()

    def make(grad_db):
        def loss(p):
            rast, db = jr.rasterize(None, p, jnp.asarray(tri), RES, grad_db=grad_db,
                                    impl="pallas_interpret")
            return jnp.sum(rast * w1) + jnp.sum(db * w2)
        return jax.grad(loss)

    g = jax.jit(lambda p: (make(True)(p), make(False)(p)))(jnp.asarray(pos))
    return {True: np.asarray(g[0]), False: np.asarray(g[1])}


def _torch_grad(grad_db, w1=None, w2=None):
    pos, tri, sw1, sw2 = _scene()
    w1 = sw1 if w1 is None else w1
    w2 = sw2 if w2 is None else w2
    p, t = inputs_from_numpy(pos, tri)
    p.requires_grad_()
    rast, db = dr.rasterize(None, p, t, RES, grad_db=grad_db)
    loss = (rast * torch.from_numpy(w1)).sum() + (db * torch.from_numpy(w2)).sum()
    g = torch.autograd.grad(loss, p)[0]
    return g.numpy(), rast


@pytest.mark.parametrize("grad_db", [True, False])
def test_rasterize_grads_match_jax(grad_db):
    ref = _jax_grads()[grad_db]
    launches = (rc.DB_KERNEL.launches, tg.KERNEL.launches, ts.KERNEL.launches)
    got, rast = _torch_grad(grad_db)
    assert launches == (rc.DB_KERNEL.launches, tg.KERNEL.launches, ts.KERNEL.launches)
    # The far triangle is drawn where the sphere is not: one hot row.
    big_id = float(_scene()[1].shape[0])
    assert int((rast[..., 3] == big_id).sum()) > 0.15 * rast[..., 3].numel()
    assert np.abs(ref).max() > 0 and np.abs(ref[:, -3:]).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_rasterize_grad_db_flag():
    """grad_db=False drops the rast_db path: the gradient of a loss on
    rast_db alone is zero, and with both terms it is that of rast alone."""
    pos, tri, w1, w2 = _scene()
    zero = np.zeros_like(w1)
    g_db, _ = _torch_grad(True, w1=zero)
    g_nodb, _ = _torch_grad(False, w1=zero)
    assert np.abs(g_db).sum() > 0 and np.abs(g_nodb).sum() == 0
    np.testing.assert_array_equal(_torch_grad(False)[0], _torch_grad(False, w2=zero)[0])


def test_composed_chain_matches_render_pipeline():
    pos, tri, attr, cidx = sphere_scene(B=2, seed=4)
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)

    def chain(pv, av):
        rast, _ = dr.rasterize(None, pv, t, RES, grad_db=False)
        col, _ = dr.interpolate(av, rast, c)
        return dr.antialias(col, rast, pv, t)

    def fused(pv, av):
        return dr.render_pipeline(pv, t, av, RES, attr_idx=c)

    out = []
    for f in (chain, fused):
        pv = p.clone().requires_grad_()
        av = a.clone().requires_grad_()
        img = f(pv, av)
        out.append((img, *torch.autograd.grad((img ** 2).mean(), (pv, av))))
    (img, gp, ga), (rimg, rgp, rga) = out
    assert torch.equal(img, rimg) and torch.equal(ga, rga)
    scale = float(rgp.abs().max())
    assert scale > 0 and float((gp - rgp).abs().max()) <= 1e-6 * scale


def test_rasterize_entry_checks():
    pos, tri, _, _ = _scene()
    p, t = inputs_from_numpy(pos, tri)
    rast, db = dr.rasterize(dr.RasterizeCudaContext(), p, t, RES)
    assert rast.shape == db.shape == (2,) + RES + (4,) and rast.device.type == "cpu"
    ref = rc.rasterize_fused(p, t, RES, emit_db=True)
    for k in range(4):
        assert torch.equal(rast[..., k], ref[k]) and torch.equal(db[..., k], ref[4 + k])
    with pytest.raises(NotImplementedError, match="A.9"):
        dr.rasterize(None, p, t, RES, ranges=torch.tensor([[0, 3]], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="A.9"):
        dr.rasterize(None, p, t, RES, viewport=(0, 64))
    with pytest.raises(NotImplementedError, match="A.9"):
        dr.rasterize(None, p[0], t, RES)
    with pytest.raises(NotImplementedError, match="A.9"):
        dr.DepthPeeler(dr.RasterizeCudaContext(), p, t, RES)
    with pytest.raises(ValueError):
        dr.rasterize(None, p, t, RES, grad_db=1)
    with pytest.raises(TypeError):
        dr.rasterize(object(), p, t, RES)
    ctx = dr.RasterizeCudaContext()
    ctx.active_depth_peeler = object()
    with pytest.raises(RuntimeError, match="depth peeling"):
        dr.rasterize(ctx, p, t, RES)
    if not torch.cuda.is_available():  # a non-tensor pos goes to the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.rasterize(None, pos, t, RES)
