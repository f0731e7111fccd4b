"""Port parity: the antialias op's backward (torch) vs the JAX package.

* ``antialias_cuda.aa_backward`` twin (kernel B8) vs
  ``antialias_pallas.aa_backward_fused_cols`` in interpret mode, on the
  same colour, cotangent, id, table and forward residuals (the JAX
  kernel's, untiled for the port): g_color within 1e-6, the 9 pair
  columns within 1e-6 of each row's largest entry (XLA:CPU contracts some
  products into fma inside the interpret-mode kernel, the port never
  does), the pair rows equal where a pair carries a gradient. On the
  random near-plane scene the column bar is 1e-5 (test_torch_antialias.py's
  bar there): its w columns, -(p2x*gp2x + p2y*gp2y)*w2, cancel at vertices
  near the plane, and the contraction moves them by up to 2.1e-6 of the
  row.
* ``torch.autograd.grad`` of the public ``antialias`` vs ``jax.grad`` of
  JAX ``antialias(impl="pallas_interpret")`` at
  tests/test_antialias_pallas.py's bars: g_pos atol/rtol 1e-4, g_color
  1e-5; ``pos_gradient_boost=3`` gives exactly 3x g_pos, and rast no
  gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import antialias_pallas as jap
from nvdiffrast_tpu.ops.texture_pallas import _tile_order, _tile_unorder
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import antialias_cuda as tac
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import random_scene, sphere_scene

SCENES = {
    "sphere_b2_c3": lambda: sphere_scene(B=2, seed=3)[:2] + ((40, 56), 3),
    "random_b2_c2": lambda: random_scene(2, B=2) + ((37, 50), 2),
}
ROW_RTOL = {"sphere_b2_c3": 1e-6, "random_b2_c2": 1e-5}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(pos, tri, rast [B, H, W, 4], colour [B, H, W, C], dy) as numpy:
    the port's rasterizer, a random colour image and cotangent."""
    pos, tri, (H, W), C = SCENES[name]()
    p, t = inputs_from_numpy(pos, tri)
    rast = np.stack([o.numpy() for o in rc.rasterize_fused(p, t, (H, W))], -1)
    rng = np.random.default_rng(C)
    color = rng.random(rast.shape[:3] + (C,), dtype=np.float32)
    dy = rng.standard_normal(color.shape).astype(np.float32)
    return pos, tri, rast, color, dy


@pytest.mark.parametrize("name", sorted(SCENES))
def test_aa_backward_twin_matches_jax(name):
    pos, tri, rast, color, dy = _scene(name)
    B, H, W, C = color.shape
    N = B * H * W
    T = tri.shape[0]
    ct = color.reshape(N, C).T.copy()
    dyt = dy.reshape(N, C).T.copy()
    idf = rast[..., 3].reshape(N)
    zw = rast[..., 2].reshape(N)
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    ftable, btable, _, _ = jaa._build_tables(jpos, jtri, jbuild(jtri), True, H, W)

    @jax.jit  # the interpret-mode kernels run compiled, faster than eagerly
    def fwd_bwd(dyt, ct, idf, zw, ftable, btable):
        _, res = jap.aa_forward_fused_cols(ct, idf, zw, ftable, T, True, (B, H, W, C),
                                           interpret=True)
        return res, jap.aa_backward_fused_cols(dyt, ct, idf, btable, res, T, True,
                                               (B, H, W, C), interpret=True)

    res, ref = fwd_bwd(*(jnp.asarray(x) for x in (dyt, ct, idf, zw)), ftable, btable)
    r_gc, r_rid2, r_gval2 = (np.asarray(x) for x in ref)

    n_tiled = _tile_order(jnp.zeros(N), B, H, W).shape[0]
    res_rm = [np.asarray(_tile_unorder(r[:n_tiled], B, H, W)) for r in res]
    args = inputs_from_numpy(dyt, ct, idf, np.asarray(btable), *res_rm)
    before = tac.BWD_KERNEL.launches
    gc, rid2, gval2 = tac.aa_backward(*args[:4], tuple(args[4:]), (B, H, W), T)
    assert tac.BWD_KERNEL.launches == before  # CPU tensors run the twin
    assert rid2.shape == (2, N) and rid2.dtype == torch.int32 and gval2.shape == (9, 2 * N)
    np.testing.assert_allclose(gc.numpy(), r_gc, rtol=0, atol=1e-6)
    live = (r_gval2 != 0).any(0)
    assert live.sum() > 20
    np.testing.assert_array_equal(rid2.numpy().reshape(-1)[live], r_rid2[live])
    scale = np.abs(r_gval2).max(1, keepdims=True)
    assert (np.abs(gval2.numpy() - r_gval2) <= ROW_RTOL[name] * scale).all()


def test_aa_backward_checks():
    pos, tri, rast, color, dy = _scene("sphere_b2_c3")
    B, H, W, C = color.shape
    N = B * H * W
    z = torch.zeros(N)
    ct = torch.zeros((C, N))
    vtbl = torch.zeros((9, B * tri.shape[0] + 1))
    with pytest.raises(ValueError, match="unsupported device"):
        tac.aa_backward(ct.to("meta"), ct.to("meta"), z.to("meta"), vtbl.to("meta"),
                        (z.to("meta"),) * 4, (B, H, W), tri.shape[0])
    with pytest.raises(ValueError):  # a table of the wrong size
        tac.aa_backward(ct, ct, z, vtbl[:, 1:], (z,) * 4, (B, H, W), tri.shape[0])
    with pytest.raises(ValueError):  # 9 channels
        tac.aa_backward(torch.zeros((9, N)), torch.zeros((9, N)), z, vtbl, (z,) * 4,
                        (B, H, W), tri.shape[0])


def _jax_grads(name, boost=1.0):
    pos, tri, rast, color, dy = _scene(name)

    def loss(p, c):
        return jnp.sum(jaa.antialias(c, jnp.asarray(rast), p, jnp.asarray(tri),
                                     pos_gradient_boost=boost,
                                     impl="pallas_interpret") * dy)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(pos), jnp.asarray(color))
    return [np.asarray(x) for x in g]


def _torch_grads(name, boost=1.0):
    pos, tri, rast, color, dy = _scene(name)
    p, t, r, c = inputs_from_numpy(pos, tri, rast, color)
    for x in (p, r, c):
        x.requires_grad_()
    out = dr.antialias(c, r, p, t, pos_gradient_boost=boost)
    g = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), (p, c, r),
                            allow_unused=True)
    assert g[2] is None  # rast gets no gradient
    return [x.numpy() for x in g[:2]]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_antialias_grads_match_jax(name):
    ref = _jax_grads(name)
    got = _torch_grads(name)
    assert np.abs(ref[0]).max() > 0
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4, rtol=1e-4, err_msg="g_pos")
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5, rtol=1e-5, err_msg="g_color")


def test_antialias_pos_gradient_boost():
    g1 = _torch_grads("sphere_b2_c3")
    g3 = _torch_grads("sphere_b2_c3", boost=3.0)
    np.testing.assert_array_equal(g3[0], g1[0] * 3.0)
    np.testing.assert_array_equal(g3[1], g1[1])


def test_antialias_forward_and_entry_checks():
    pos, tri, rast, color, dy = _scene("sphere_b2_c3")
    p, t, r, c = inputs_from_numpy(pos, tri, rast, color)
    out = dr.antialias(c, r, p, t, topology_hash=dr.antialias_construct_topology_hash(t))
    assert torch.equal(out, dr.antialias(c, r, p, t))
    assert out.shape == c.shape and not torch.equal(out, c)
    # Range mode: 2-D pos, one table for every image (image b's rows of
    # a range render of its own positions are its instance render).
    for b in range(p.shape[0]):
        assert torch.equal(dr.antialias(c[b:b + 1], r[b:b + 1], p[b], t), out[b:b + 1])
    # A viewport as tall as the image is the full image.
    assert torch.equal(dr.antialias(c, r, p, t, viewport=(0, c.shape[1])), out)
    with pytest.raises(ValueError, match="minibatch"):
        dr.antialias(c, r, p[:1], t)
    with pytest.raises(ValueError, match="mismatch"):
        dr.antialias(c[:, :-1], r, p, t)
    # Past 8 channels the kernels run per group of 8; a channel's image
    # does not depend on the others.
    c9 = torch.cat([c, c, c], -1)
    assert torch.equal(dr.antialias(c9, r, p, t)[..., 6:], out)
    with pytest.raises(TypeError):
        dr.antialias(c, r, p, t, topology_hash=object())
    if not torch.cuda.is_available():  # a non-tensor colour goes to the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.antialias(color, r, p, t)
