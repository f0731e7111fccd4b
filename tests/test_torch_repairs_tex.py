"""Port parity: the textured pipeline's composed fallback (torch, plain
twins) vs the JAX package's (``pipeline_tex.py:324-347``): per-image uvs
[B, Vu, 2], a 9-channel texture, 'nearest' and a cube map with [Vu, 3]
direction uvs, each through rasterize -> interpolate -> texture ->
antialias on both sides (JAX's kernels in interpret mode).

JAX's fallback crashes at its default max_mip_level=-1 (its texture()
asserts >= 0), so JAX gets the explicit full level count and the port
keeps -1. Bars: the image within 1e-5 absolute, the gradients of
sum(o**2 + 0.1*o) to pos, uv_attr and tex within 5e-5 of their largest
entry and each row within 5e-4 of its largest
(``_torch_parity.check_textured_grads``). With 9 channels JAX samples on
its XLA path and sums the texture gradient in float32 in its own order;
with the clamp boundary a border texel collects clamped taps of both
signs, whose sum cancels to ~1e-5 of the largest texel row and differs by
up to 1.6e-3 of itself; those texture rows are held to the global bar
(ROADMAP's note on linear texture gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu.ops import pipeline_tex as jpt

from _torch_parity import check_textured_grads, textured_scene

RES = (16, 16)


def _case(name):
    """(pos, tri, uv_attr, tex, kwargs, JAX's max_mip_level)."""
    pos, tri, uv, tex = textured_scene(seed=1)
    rng = np.random.RandomState(11)
    if name == "per_image_uv":
        uv = np.stack([uv, rng.uniform(-0.2, 1.2, uv.shape).astype(np.float32)])
        return pos, tri, uv, tex, dict(filter_mode="linear-mipmap-linear"), 6
    if name == "nine_channels":
        tex = rng.rand(1, 32, 64, 9).astype(np.float32)
        return pos, tri, uv, tex, dict(filter_mode="linear", boundary_mode="clamp"), 0
    if name == "nearest":
        return pos, tri, uv, tex, dict(filter_mode="nearest", boundary_mode="wrap"), 0
    dirs = rng.randn(uv.shape[0], 3).astype(np.float32)
    env = rng.rand(1, 6, 8, 8, 3).astype(np.float32)
    return pos, tri, dirs, env, dict(filter_mode="linear-mipmap-linear",
                                     boundary_mode="cube"), 3


@pytest.mark.parametrize("name", ["per_image_uv", "nine_channels", "nearest", "cube"])
def test_render_pipeline_textured_composed_matches_jax(name):
    pos, tri, uv, tex, kw, jax_max = _case(name)

    def loss(p, u, t):
        o = jpt.render_pipeline_textured(p, jnp.asarray(tri), u, t, RES, max_mip_level=jax_max,
                                         impl="pallas_interpret", **kw)
        return (o ** 2 + 0.1 * o).sum(), o

    (_, ref_img), ref = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (pos, uv, tex)))
    xs = [torch.tensor(x, requires_grad=True) for x in (pos, uv, tex)]
    img = dr.render_pipeline_textured(xs[0], torch.from_numpy(tri), xs[1], xs[2], RES, **kw)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref_img), atol=1e-5, rtol=0)
    got = torch.autograd.grad((img ** 2 + 0.1 * img).sum(), xs)
    if name == "nearest":  # piecewise constant in uv: no uv gradient on either side
        assert np.abs(np.asarray(ref[1])).max() == 0 and got[1].abs().max() == 0
        got, ref = (got[0], got[2]), (ref[0], ref[2])
        ref = (np.asarray(ref[0]), np.ones((1, 1), np.float32), np.asarray(ref[1]))
        got = (got[0], torch.ones(1, 1), got[1])
    check_textured_grads([g.numpy() for g in got], [np.asarray(r) for r in ref],
                         global_only=("g_tex",) if name == "nine_channels" else ())
