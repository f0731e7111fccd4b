"""Port parity: render_pipeline_textured's gradients with
filter_mode='linear' (torch, plain twins) vs ``jax.grad`` of the JAX
package's render_pipeline_textured(filter_mode='linear',
impl="pallas_interpret"), whose flat chain composes the standalone ops'
backwards, as the port does: antialias (B8, B10), the texture, interpolate
(B6, B10) and rasterize (B9, B10).

Loss sum(o**2 + 0.1*o) on the seed-1 textured scene (_torch_parity).

* wrap, one texture, boost 1, end to end: each gradient within 5e-5 of
  its largest entry (tests/test_pipeline_tex.py:68-73) and each row
  within 5e-4 of the row's largest (``check_textured_grads``).
* clamp, a texture per image, boost 2, the chain after the rasterizer fed
  the JAX rasterizer's own buffers (the two rasterizers' u, v differ by a
  few ulps, ROADMAP C, and linear filtering's derivative jumps at texel
  edges): each gradient within 5e-5 of its largest entry, and the
  position and uv rows within 5e-4 of their largest. The texture rows
  are held only to the global bar here: JAX sums per-image texture
  gradients through its generic scatter's bf16 hi/lo split, whose error
  on a border texel that collects the clamped taps of opposite signs
  reaches ~1e-3 of that row (1 row of 4096), while the port sums in
  float64 (within 1 ulp, test_torch_texture_bwd.py).
"""

import numpy as np
import jax.numpy as jnp
import torch

from nvdiffrast_tpu.ops import rasterize_pallas as jrp
from nvdiffrast_tpu_torch.ops import pipeline_tex as tpt
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import (GRAD_RTOL, ROW_RTOL, TEX_RES, _tex_loss, check_textured_grads,
                           textured_grads, textured_grads_jax, textured_scene)


def test_linear_grads_match_jax():
    mode = ("linear", "wrap", 1, 1.0)
    check_textured_grads(textured_grads(*mode), textured_grads_jax(*mode))


def test_linear_chain_on_jax_raster_grads_match_jax():
    mode = ("linear", "clamp", 2, 2.0)
    ref = textured_grads_jax(*mode)
    pos, tri, uv, tex = textured_scene(seed=1, D=2)
    B, T = pos.shape[0], tri.shape[0]
    ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
    outs = jrp.rasterize_fused(jnp.asarray(pos), jnp.asarray(tri), TEX_RES, ranges,
                               emit_db=False, flat=True, interpret=True)
    raster = inputs_from_numpy(*(np.asarray(a).reshape(-1) for a in outs[:4]))
    p, t, a, tx = inputs_from_numpy(pos, tri, uv, tex)
    img, saved, meta = tpt._shade_textured(p, a, tx, t, t, build_opposite_table(t), raster,
                                           TEX_RES, "linear", "clamp", -1)
    img = img.requires_grad_()
    dy = torch.autograd.grad(_tex_loss(img), img)[0]
    got = tpt._ptex_bwd_core(saved, a, t, t, TEX_RES, "linear", "clamp", meta, 2.0,
                             tuple(p.shape), tuple(tx.shape), (True, True, True), dy)
    for name, g, r in zip(("g_pos", "g_uv", "g_tex"), got, ref):
        g = g.numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        scale = np.abs(r).max()
        assert scale > 0 and np.abs(g - r).max() <= GRAD_RTOL * scale, name
        if name != "g_tex":
            g2 = g.reshape(-1, g.shape[-1])
            r2 = r.reshape(-1, r.shape[-1])
            assert (np.abs(g2 - r2) <= ROW_RTOL * np.abs(r2).max(1, keepdims=True)).all(), name
