"""Shared scenes and bars for the port's parity tests (tests/test_torch_*.py).

Scenes are numpy arrays made from a seed; each test hands the same
arrays to the JAX package and to the port.
"""

import numpy as np

from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.utils import camera


def sphere_scene(B=1, seed=0, A=3):
    """tests/test_pipeline.py _scene: uv-sphere 8x12, B random views,
    random vertex attributes. Returns (pos, tri, attr, attr_idx)."""
    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4)
               @ camera.translate(0.05 * b, 0, -3.2)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    attr = rng.standard_normal((B, vtxp.shape[0], A)).astype(np.float32)
    return np.stack(poss), pos_idx, attr, col_idx


def textured_scene(seed=0, B=2, V=50, T=40, D=1):
    """tests/test_pipeline_tex.py _scene: random triangles with
    near-plane crossers, uvs in [-0.2, 1.2], D random 32x64x3 textures.
    Returns (pos, tri, uv, tex)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.6, 1.8, (B, V))
    pos[0, :4, 3] = -0.2  # near-plane crossers
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (V, 2)).astype(np.float32)
    tex = rng.rand(1, 32, 64, 3).astype(np.float32)
    if D > 1:
        tex = np.concatenate([tex, rng.rand(D - 1, 32, 64, 3).astype(np.float32)])
    return pos, tri, uv, tex


def random_scene(seed, B=1, V=64, T=48):
    """tests/test_parity_sweep.py _random_scene: near-plane crossers and
    degenerate triangles. Returns (pos, tri)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.4, 2.5, (B, V))
    k = max(2, V // 10)
    pos[:, :k, 3] = rng.uniform(-0.5, 0.1, (B, k))
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    tri[0] = [3, 3, 7]
    tri[1] = [5, 5, 5]
    return pos, tri


def assert_ids_match_mod_zfights(id_ref, id_got, z_ref, z_got, max_frac=2e-4):
    """The z-fight bar of tests/test_parity_sweep.py: ids equal except
    where two triangles tie in depth (depths within 1e-4 there), on at
    most `max_frac` of the pixels. Returns the mask of agreeing ids."""
    differ = id_ref != id_got
    if differ.any():
        np.testing.assert_allclose(z_got[differ], z_ref[differ], atol=1e-4,
                                   err_msg="id mismatch at non-tied depth")
        assert differ.mean() <= max_frac, (
            f"{differ.sum()} id mismatches — too many even for z-fights")
    return ~differ


TEX_RES = (48, 64)  # resolution of the textured gradient scenes
GRAD_RTOL = 5e-5    # tests/test_pipeline_tex.py:73, of the largest gradient
ROW_RTOL = 5e-4     # per row, of the row's largest gradient


def _tex_loss(o):
    return (o ** 2 + 0.1 * o).sum()


def textured_grads_jax(filter_mode, boundary_mode, D, boost):
    """jax.grad of sum(o**2 + 0.1*o) over the JAX package's
    render_pipeline_textured(impl="pallas_interpret") on the seed-1
    textured scene, jitted (the interpret-mode kernels then run compiled,
    ~2.5x faster than eagerly): (g_pos, g_uv, g_tex) as numpy arrays. JAX
    is imported here, so that files which run without it can import this
    module."""
    import jax
    import jax.numpy as jnp
    from nvdiffrast_tpu.ops import pipeline_tex as jpt

    pos, tri, uv, tex = textured_scene(seed=1, D=D)

    def loss(p, u, t):
        return _tex_loss(jpt.render_pipeline_textured(
            p, jnp.asarray(tri), u, t, TEX_RES, filter_mode=filter_mode,
            boundary_mode=boundary_mode, pos_gradient_boost=boost,
            impl="pallas_interpret"))

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (pos, uv, tex)))
    return tuple(np.asarray(x) for x in g)


def textured_grads(filter_mode, boundary_mode, D, boost, device="cpu"):
    """The port's torch.autograd.grad of the same loss on the same scene."""
    import torch
    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    p, t, a, tx = inputs_from_numpy(*textured_scene(seed=1, D=D), device=device)
    for x in (p, a, tx):
        x.requires_grad_()
    img = dr.render_pipeline_textured(p, t, a, tx, TEX_RES, filter_mode=filter_mode,
                                      boundary_mode=boundary_mode,
                                      pos_gradient_boost=boost)
    return torch.autograd.grad(_tex_loss(img), (p, a, tx))


def check_textured_grads(got, ref):
    """Each gradient within GRAD_RTOL of its largest entry, and each row
    (vertex, uv vertex, texel) within ROW_RTOL of the row's largest."""
    for name, g, r in zip(("g_pos", "g_uv", "g_tex"), got, ref):
        g = np.asarray(g)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= GRAD_RTOL * scale, (name, np.abs(g - r).max(), scale)
        g = g.reshape(-1, g.shape[-1])
        r = r.reshape(-1, r.shape[-1])
        bad = np.abs(g - r) > ROW_RTOL * np.abs(r).max(1, keepdims=True)
        assert not bad.any(), f"{name}: rows {np.nonzero(bad.any(1))[0]}"
