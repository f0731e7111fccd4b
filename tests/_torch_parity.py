"""Shared scenes and bars for the port's parity tests (tests/test_torch_*.py).

Scenes are numpy arrays made from a seed; each test hands the same
arrays to the JAX package and to the port.
"""

import numpy as np
import torch

from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.utils import camera

# One intra-op thread a process. The suite runs six xdist workers on an
# eight-core machine; with torch's default of one thread a core each,
# 48 threads contend for 8 cores, and test_earth_fit_psnr's 50 steps took
# 589-592 s a worker with six at once, against 4.7-5.9 s (same PSNR) with
# one thread each. Every test_torch_*.py imports this module.
torch.set_num_threads(1)


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


def check_textured_grads(got, ref, global_only=()):
    """Each gradient within GRAD_RTOL of its largest entry, and each row
    (vertex, uv vertex, texel) within ROW_RTOL of the row's largest, but
    for the names in `global_only`."""
    for name, g, r in zip(("g_pos", "g_uv", "g_tex"), got, ref):
        g = np.asarray(g)
        assert g.shape == r.shape and np.isfinite(g).all(), name
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= GRAD_RTOL * scale, (name, np.abs(g - r).max(), scale)
        if name in global_only:
            continue
        g = g.reshape(-1, g.shape[-1])
        r = r.reshape(-1, r.shape[-1])
        bad = np.abs(g - r) > ROW_RTOL * np.abs(r).max(1, keepdims=True)
        assert not bad.any(), f"{name}: rows {np.nonzero(bad.any(1))[0]}"


# ---------------------------------------------------------------------------
# The standalone texture op.
# ---------------------------------------------------------------------------

TEX_ARGS = ("tex", "uv", "uv_da", "bias", "mip")


def texture_case(seed=0, B=2, H=12, W=14, th=16, tw=32, C=3, D=1):
    """A 2-D texture case as numpy: tex [D, th, tw, C], uv [B, H, W, 2] in
    [-0.3, 1.3] with texel-edge and out-of-range values, uv_da [B, H, W, 4]
    (non-zero footprints; JAX's level vjp is NaN at zero ones on the CPU)
    and a level bias [B, H, W] over [-1, 7]."""
    rng = np.random.RandomState(seed)
    tex = rng.rand(D, th, tw, C).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (B, H, W, 2)).astype(np.float32)
    uv[0, 0, :6] = [[0.0, 0.0], [1.0, 1.0], [0.5 / tw, 0.5 / th], [-1.0, 2.0],
                    [1 - 0.5 / tw, 0.25], [0.5, 1 - 0.5 / th]]
    uv_da = (rng.randn(B, H, W, 4) * 0.08).astype(np.float32)
    uv_da[np.abs(uv_da) < 1e-3] = 1e-3
    bias = rng.uniform(-1, 7, (B, H, W)).astype(np.float32)
    return dict(tex=tex, uv=uv, uv_da=uv_da, bias=bias)


def texture_jax(args, kw, wrapper_max=None):
    """JAX texture(impl="pallas_interpret") on the arrays of `args` (a
    dict over TEX_ARGS, mip a list), jitted: (image, {name: gradient of
    sum(o**2 + 0.1*o)}). With wrapper_max, the mip stack is a
    TextureMipWrapper built from tex inside the function (max level
    wrapper_max), so its gradient reaches tex."""
    import jax
    import jax.numpy as jnp
    from nvdiffrast_tpu.ops import texture as jtx

    names = [k for k in TEX_ARGS if args.get(k) is not None]

    def f(*xs):
        d = dict(zip(names, xs))
        mip = d.get("mip")
        if wrapper_max is not None:
            mip = jtx.texture_construct_mip(d["tex"], wrapper_max)
        return jtx.texture(d["tex"], d["uv"], d.get("uv_da"), d.get("bias"), mip=mip,
                           impl="pallas_interpret", **kw)

    def fwd_bwd(*xs):
        img, vjp = jax.vjp(f, *xs)
        return img, vjp(2.0 * img + 0.1)

    def conv(a):
        return [jnp.asarray(m) for m in a] if isinstance(a, list) else jnp.asarray(a)

    img, g = jax.jit(fwd_bwd)(*(conv(args[k]) for k in names))
    g = {k: ([np.asarray(m) for m in x] if isinstance(x, list) else np.asarray(x))
         for k, x in zip(names, g)}
    return np.asarray(img), g


def texture_port(args, kw, wrapper_max=None):
    """The port's texture on the same arrays (CPU tensors): (image,
    {name: gradient}) as numpy."""
    import torch
    from nvdiffrast_tpu_torch.ops import texture as tx

    t = {k: ([torch.tensor(m, requires_grad=True) for m in v] if isinstance(v, list)
             else torch.tensor(v, requires_grad=True))
         for k, v in args.items() if v is not None}
    mip = t.get("mip")
    if wrapper_max is not None:
        mip = tx.texture_construct_mip(t["tex"], wrapper_max)
    img = tx.texture(t["tex"], t["uv"], t.get("uv_da"), t.get("bias"), mip=mip, **kw)
    flat = [x for k in TEX_ARGS if k in t for x in (t[k] if k == "mip" else [t[k]])]
    gs = list(torch.autograd.grad((img ** 2 + 0.1 * img).sum(), flat, allow_unused=True))
    out = {}
    for k in TEX_ARGS:
        if k in t:
            n = len(t[k]) if k == "mip" else 1
            part = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                    for g, x in zip(gs[:n], t[k] if k == "mip" else [t[k]])]
            gs = gs[n:]
            out[k] = part if k == "mip" else part[0]
    return img.detach().numpy(), out


def check_texture(args, kw, img_atol=1e-6, rel=5e-5, floor=1e-6, wrapper_max=None):
    """The port against JAX on one texture case: the image within
    img_atol; every gradient row (last axis) within rel of the row's
    largest entry plus floor of the array's largest. The floor is for
    rows that cancel: a clamped or level-blended pixel whose gradient is
    a difference of near-equal texel or slot values, which the 2-D
    kernels (B11's fwd_stash rows in JAX, texture_bwd.cu's re-gathered
    sums in the port) round in another order (up to 1e-3 of such a row,
    under 6e-8 of the array)."""
    ref_img, ref = texture_jax(args, kw, wrapper_max)
    img, got = texture_port(args, kw, wrapper_max)
    assert img.shape == ref_img.shape
    np.testing.assert_allclose(img, ref_img, atol=img_atol, rtol=0)
    for k, r in ref.items():
        for j, (g, rr) in enumerate(zip(got[k] if k == "mip" else [got[k]],
                                        r if k == "mip" else [r])):
            g2 = np.asarray(g).reshape(-1, rr.shape[-1])
            r2 = rr.reshape(g2.shape)
            assert np.isfinite(g2).all(), k
            bar = rel * np.abs(r2).max(1, keepdims=True) + floor * np.abs(r2).max()
            bad = np.abs(g2 - r2) > bar
            assert not bad.any(), (k, j, np.nonzero(bad.any(1))[0][:10],
                                   np.abs(g2 - r2).max())
    return ref
