"""Port parity for calls the port used to refuse (torch, plain twins) vs
the JAX package: ``antialias`` and ``render_pipeline`` past 8 channels.

* ``antialias`` with C = 9 and 17 runs B7 / B8 in groups of 8 channels;
  each group's pair position gradients add to those before it. JAX
  serves these widths on its XLA path. The image within 1e-6 and the
  gradients at tests/test_antialias_pallas.py's bars (g_pos atol / rtol
  1e-4, g_color 1e-5): the per-group sums round the channel sum once
  per group, a few float32 ulps of a pair's column.
* ``render_pipeline`` with A = 9 and 17 composes rasterize ->
  interpolate -> antialias, as JAX's fallback does: image within 1e-5,
  gradients at tests/test_pipeline.py's bar (atol 1e-5, rtol 1e-4).
The textured repairs are in test_torch_repairs_tex.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import pipeline as jpl
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (16, 16)


@functools.lru_cache(maxsize=None)
def _aa_scene(C):
    pos, tri, _, _ = sphere_scene(B=2, seed=3)
    p, t = inputs_from_numpy(pos, tri)
    rast = np.stack([o.numpy() for o in rc.rasterize_fused(p, t, RES)], -1)
    rng = np.random.default_rng(C)
    color = rng.random(rast.shape[:3] + (C,), dtype=np.float32)
    return pos, tri, rast, color


@pytest.mark.parametrize("C", [9, 17])
def test_antialias_past_8_channels_matches_jax(C):
    pos, tri, rast, color = _aa_scene(C)

    def loss(p, c):
        o = jaa.antialias(c, jnp.asarray(rast), p, jnp.asarray(tri), impl="pallas_interpret")
        return (o ** 2 + 0.1 * o).sum(), o

    (_, ref_img), ref = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(pos), jnp.asarray(color))
    p, c = (torch.tensor(x, requires_grad=True) for x in (pos, color))
    img = dr.antialias(c, torch.from_numpy(rast), p, torch.from_numpy(tri))
    got = torch.autograd.grad((img ** 2 + 0.1 * img).sum(), (p, c))
    assert img.shape == color.shape
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref_img), atol=1e-6)
    assert np.abs(np.asarray(ref[0])).max() > 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=1e-4,
                               err_msg="g_pos")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5, rtol=1e-5,
                               err_msg="g_color")


@pytest.mark.parametrize("A", [9, 17])
def test_render_pipeline_past_8_attributes_matches_jax(A):
    pos, tri, attr, aidx = sphere_scene(B=2, seed=4, A=A)

    def loss(p, a):
        o = jpl.render_pipeline(p, jnp.asarray(tri), a, RES, attr_idx=jnp.asarray(aidx),
                                impl="pallas_interpret")
        return (o ** 2).mean(), o

    (_, ref_img), ref = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(pos), jnp.asarray(attr))
    p, t, a, ai = inputs_from_numpy(pos, tri, attr, aidx)
    p.requires_grad_()
    a.requires_grad_()
    img = dr.render_pipeline(p, t, a, RES, attr_idx=ai)
    got = torch.autograd.grad((img ** 2).mean(), (p, a))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref_img), atol=1e-5)
    for name, g, r in zip(("g_pos", "g_attr"), got, ref):
        assert np.abs(np.asarray(r)).max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
