"""Port parity: cube-map sampling (torch, plain twins) vs the JAX package.

* The cube glue (``ops/texture_cube.py``) against ``texture.py``'s
  ``_cube_faceid``, ``_cube_project``, ``_cube_wrap_texel``,
  ``_cube_uv_da_to_st_da`` and ``texture_pallas.py``'s ``_wrap_corner_2d``
  and ``cube_corner_setup``: face ids, validity and texel ids exactly
  equal; s and t within 2 ulps. The footprint Jacobian: the port writes
  it in closed form, JAX differentiates the projection with ``jax.jvp``
  and XLA:CPU contracts some of its products into fma; where terms
  cancel, single entries differ by many ulps of their own. Held per
  pixel: the port within 4 ulps of the pixel's largest entry from the
  same closed form in float64 (measured 2.1), JAX within 8 (measured 4.7
  from float64, 5.0 from the port).
* The closed-form vjps of the projection and the Jacobian against
  torch.autograd of the same forward in float64, within 1e-10 of scale.
* The B12 twins against ``sample_cube_fused`` / its vjp
  (``_call_cube`` in modes "fwd" and "bwd", interpret mode) with exact
  cube-corner and face-edge directions and every filter: the samples
  within 1e-6 absolute; gs, gt, gfl within 1e-5 of their largest
  entry; the texture gradient within 1e-5 of each texel row's largest
  (JAX sums it through its generic scatter's bf16 hi / lo split, the port
  in float64).
* ``texture(boundary_mode='cube')`` gradients to the map, the directions
  and uv_da against ``jax.grad`` of JAX ``texture(impl=
  "pallas_interpret")``, each row within 5e-5 of its largest entry
  (tests/test_pipeline_tex.py:61's bar, per row).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import texture as jtx
from nvdiffrast_tpu.ops import texture_pallas as jtp
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_cube as tcg
from nvdiffrast_tpu_torch.ops import texture_cube_cuda as tcc

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

FILTERS = ("linear", "linear-mipmap-nearest", "linear-mipmap-linear")


def _cube_case(seed=0, B=2, H=17, W=21, fw=16, C=3, D=1):
    """tests/test_texture_pallas.py's _cube_case with more exact cube-corner
    and face-edge directions: (map [D, 6, fw, fw, C], directions
    [B, H, W, 3], uv_da [B, H, W, 6]) as numpy."""
    rng = np.random.RandomState(seed)
    tex = rng.rand(D, 6, fw, fw, C).astype(np.float32)
    v = rng.randn(B, H, W, 3).astype(np.float32)
    v[0, 0, :8] = [[1, 1, 1], [1, 1, 0], [0, 0, 0], [-1, 1, -1], [0, 1, 1], [1, 0, -1],
                   [-1, -1, 1], [0, -1, 0]]
    uv_da = (rng.randn(B, H, W, 6) * 0.05).astype(np.float32)
    return tex, v, uv_da


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _dirs():
    _, v, da = _cube_case(D=2)
    return v.reshape(-1, 3), da.reshape(-1, 6)


def test_cube_faceid_and_projection_match_jax():
    v, _ = _dirs()
    jx = [jnp.asarray(v[:, i]) for i in range(3)]
    px = [_t(v[:, i]) for i in range(3)]
    jf = jtx._cube_faceid(*jx)
    pf = tcg.cube_faceid(*px)
    for a, b in zip(jf[:4], pf[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    js, jt, jfin = jtx._cube_project(jf, *jx)
    ps, pt, pfin = tcg.cube_project(pf, *px)
    np.testing.assert_array_equal(np.asarray(jfin), pfin.numpy())
    assert not pfin.numpy()[2]  # the zero vector
    assert _ulps(js, ps.numpy()).max() <= 2 and _ulps(jt, pt.numpy()).max() <= 2


def test_cube_footprint_jacobian_matches_jax():
    v, da = _dirs()
    ref = np.asarray(jtx._cube_uv_da_to_st_da(jnp.asarray(v), jnp.asarray(da)))
    got = torch.stack(tcg.cube_st_da(*_t(v.T).unbind(0), _t(da.T)), 1).numpy()
    exact = torch.stack(tcg.cube_st_da(*torch.from_numpy(v.T.astype(np.float64)).unbind(0),
                                       torch.from_numpy(da.T.astype(np.float64))), 1).numpy()
    ulp = np.spacing(np.abs(exact).max(1, keepdims=True).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - exact) <= 4 * ulp).all()
    assert (np.abs(got - ref) <= 8 * ulp).all()
    assert (got[2] == 0).all()  # the zero vector
    # The column form of the fused pipeline, from the same columns.
    cols = jtx._cube_st_da_cols(*(jnp.asarray(v[:, i]) for i in range(3)),
                                [jnp.asarray(da[:, j]) for j in range(6)])
    np.testing.assert_allclose(np.stack([np.asarray(c) for c in cols], 1), ref,
                               atol=1e-6 * np.abs(ref).max())


def test_cube_setup_cpu_runs_the_twin_and_matches_jax():
    """On CPU tensors ``cube_setup`` is its plain twin, and its columns
    match JAX's texture() glue: face and validity exactly, s and t within
    2 ulps, the per-image texture index, and the level of the face
    coordinates' footprint plus a bias, clipped, within 1e-5."""
    v, da = _dirs()
    N, L, w = len(v), 5, 16
    bias = np.random.RandomState(4).uniform(-1, L, N).astype(np.float32)
    args = (_t(v), _t(da), _t(bias), w, L, N // 2, True)
    (s, t, fl, fin, face, tz), d4 = tcc.cube_setup(*args)
    ref_cols, ref_d4 = tcc.cube_setup_plain(*args)
    for a, b in zip((s, t, fl, fin, face, tz, d4), ref_cols + (ref_d4,)):
        assert torch.equal(a, b)
    jv = jnp.asarray(v)
    jf = jtx._cube_faceid(jv[:, 0], jv[:, 1], jv[:, 2])
    js, jt, jfin = jtx._cube_project(jf, jv[:, 0], jv[:, 1], jv[:, 2])
    np.testing.assert_array_equal(np.asarray(jf[0]), face.numpy())
    np.testing.assert_array_equal(np.asarray(jfin), fin.numpy() != 0)
    assert _ulps(js, s.numpy()).max() <= 2 and _ulps(jt, t.numpy()).max() <= 2
    np.testing.assert_array_equal(tz.numpy(), np.arange(N) // (N // 2))
    st_da = jtx._cube_uv_da_to_st_da(jv, jnp.asarray(da))
    jfl = jnp.clip(jtx._mip_level_from_footprint(st_da, float(w), float(w)) + bias, 0.0, L - 1.0)
    np.testing.assert_allclose(fl.numpy(), np.asarray(jfl), rtol=0, atol=1e-5)


SETUP_BAD = {
    "uv_shape": lambda kw: dict(uv=torch.randn(12, 2)),
    "uv_da_shape": lambda kw: dict(uvd=torch.randn(12, 4)),
    "bias_shape": lambda kw: dict(bias=torch.randn(13)),
    "dtype": lambda kw: dict(uv=kw["uv"].double()),
    "device": lambda kw: {k: kw[k].to("meta") for k in ("uv", "uvd", "bias")},
    "devices": lambda kw: dict(bias=kw["bias"].to("meta")),
    "keep_da_without_uv_da": lambda kw: dict(uvd=None),
    "levels": lambda kw: dict(L=0),
    "image_size": lambda kw: dict(hw=5),
}


@pytest.mark.parametrize("case", sorted(SETUP_BAD))
def test_cube_setup_checks_its_arguments(case):
    """``cube_setup`` (the launcher) and its twin raise ValueError on a
    shape, dtype, device (one other than the CPU and CUDA, or two of them),
    level count or image size the kernel does not take."""
    kw = dict(uv=torch.randn(12, 3), uvd=torch.randn(12, 6), bias=torch.randn(12), w=4, L=3,
              hw=6, keep_da=True)
    tcc.cube_setup(**kw)
    for fn in (tcc.cube_setup, tcc.cube_setup_plain):
        with pytest.raises(ValueError):
            fn(**{**kw, **SETUP_BAD[case](kw)})


@pytest.mark.parametrize("w", [1, 2, 5, 8])
def test_cube_wrap_matches_jax(w):
    """Every texel one step around each face, both forms of the wrap."""
    r = np.arange(-1, w + 1)
    face, ix, iy = (a.ravel() for a in np.meshgrid(np.arange(6), r, r, indexing="ij"))
    ref = jtx._cube_wrap_texel(jnp.asarray(face, jnp.int32), jnp.asarray(ix, jnp.int32),
                               jnp.asarray(iy, jnp.int32), w)
    ref2 = jtp._wrap_corner_2d(jnp.asarray(face, jnp.int32), jnp.asarray(ix, jnp.int32),
                               jnp.asarray(iy, jnp.int32), w)
    args = (_t(face).long(), _t(ix).long(), _t(iy).long())
    for got in (tcg.cube_wrap_texel(*args, w), tcg.wrap_corner_2d(*args, w),
                tcg.wrap_corner_2d(*args, torch.full_like(args[0], w))):
        for a, b, c in zip(ref, ref2, got):
            np.testing.assert_array_equal(np.asarray(a), c.numpy())
            np.testing.assert_array_equal(np.asarray(b), c.numpy())


def test_cube_corner_setup_matches_jax():
    v, _ = _dirs()
    jx = [jnp.asarray(v[:, i]) for i in range(3)]
    jf = jtx._cube_faceid(*jx)
    s, t, _ = jtx._cube_project(jf, *jx)
    face = np.asarray(jf[0])
    wl = np.where(np.arange(len(face)) % 3 == 0, 16, np.where(np.arange(len(face)) % 3 == 1,
                                                              4, 1)).astype(np.int32)
    for w in (16, 3, wl):
        ref = jtp.cube_corner_setup(s, t, jnp.asarray(face), jnp.asarray(w) if
                                    isinstance(w, np.ndarray) else w)
        got = tcg.cube_corner_setup(_t(np.asarray(s)), _t(np.asarray(t)), _t(face).long(),
                                    _t(w).long() if isinstance(w, np.ndarray) else w)
        for part in (0, 1, 2):  # rows, columns, validity
            for a, b in zip(ref[part], got[part]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip((ref[3], ref[4]) + tuple(ref[5]), (got[3], got[4]) + tuple(got[5])):
            assert _ulps(a, b.numpy()).max() <= 2


@pytest.mark.parametrize("which", ["project", "st_da"])
def test_cube_vjps_match_autograd(which):
    """The closed-form vjps against torch.autograd of the same forward,
    in float64 (away from the clip's kinks, where autograd has no tie
    rule)."""
    v, da = _dirs()
    rng = np.random.RandomState(3)
    x, y, z = (torch.tensor(v[:, i], dtype=torch.float64, requires_grad=True)
               for i in range(3))
    d = torch.tensor(da.T, dtype=torch.float64, requires_grad=True)
    if which == "project":
        g = [torch.from_numpy(rng.randn(len(v))) for _ in range(2)]
        s, t, fin = tcg.cube_project(tcg.cube_faceid(x, y, z), x, y, z)
        inner = fin & (s > 0) & (s < 1) & (t > 0) & (t < 1)
        ref = torch.autograd.grad((s * g[0] * inner).sum() + (t * g[1] * inner).sum(),
                                  (x, y, z))
        got = tcg.cube_project_vjp(x.detach(), y.detach(), z.detach(), g[0] * inner,
                                   g[1] * inner)
    else:
        g = [torch.from_numpy(rng.randn(len(v))) for _ in range(4)]
        cols = tcg.cube_st_da(x, y, z, d)
        ref = torch.autograd.grad(sum((c * gg).sum() for c, gg in zip(cols, g)), (x, y, z, d))
        gxyz, gd = tcg.cube_st_da_vjp(x.detach(), y.detach(), z.detach(), d.detach(), g)
        got = tuple(gxyz) + (gd,)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10 * float(b.abs().max()))


@functools.lru_cache(maxsize=None)
def _sampler_case():
    """The packed pyramid of two 16x16 cube maps, s, t, finite, face of
    the directions, flevels over every level (integers too), tz and a
    cotangent."""
    tex, v, _ = _cube_case(D=2)
    B, H, W = v.shape[:3]
    N = B * H * W
    levels = [jnp.asarray(tex)] + jtx.build_mip_stack(jnp.asarray(tex), -1, True)
    smeta, n_tex = jtx._static_meta(levels)
    flat, _ = jtx._pack_pyramid(levels, True)
    uv = jnp.asarray(v.reshape(N, 3))
    finfo = jtx._cube_faceid(uv[:, 0], uv[:, 1], uv[:, 2])
    s, t, fin = jtx._cube_project(finfo, uv[:, 0], uv[:, 1], uv[:, 2])
    rng = np.random.RandomState(5)
    L = len(levels)
    fl = rng.uniform(0, L - 1, N).astype(np.float32)
    fl[:20] = np.arange(20) % L
    tz = (np.arange(N) // (H * W)).astype(np.int32)
    dy = rng.randn(3, N).astype(np.float32)
    return (tex, levels, smeta, n_tex, np.asarray(flat), np.asarray(s), np.asarray(t), fl,
            np.asarray(fin), np.asarray(finfo[0]), tz, dy, (B, H, W))


@pytest.mark.parametrize("filter_mode", FILTERS)
def test_cube_twins_match_jax_call_cube(filter_mode):
    (_, levels, smeta, n_tex, flat, s, t, fl, fin, face, tz, dy,
     shape) = _sampler_case()
    L = len(levels)
    cmeta = tuple((off, int(lv.shape[-2]), int(lv.shape[-2]))
                  for (off, _, _), lv in zip(smeta, levels))

    def f(fc, s_, t_, fl_):
        return jtp.sample_cube_fused(fc, s_, t_, fl_, jnp.asarray(fin), jnp.asarray(face),
                                     jnp.asarray(tz), cmeta, L, filter_mode, shape, True)

    out, vjp = jax.vjp(f, jnp.asarray(flat).T, jnp.asarray(s), jnp.asarray(t),
                       jnp.asarray(fl))
    g_flat, gs, gt, gfl = (np.asarray(x) for x in vjp(jnp.asarray(dy)))

    cols = (_t(s), _t(t), _t(fl), _t(fin.astype(np.int32)), _t(face.astype(np.int32)),
            _t(tz))
    pflat = _t(flat)
    got = tcc.sample_cube(pflat, cols, smeta, filter_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-6, rtol=0)
    assert (got.numpy()[:, ~fin] == 0).all()
    for a, b in zip(tcc.cube_bwd(pflat, cols, _t(dy), smeta, filter_mode), (gs, gt, gfl)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * max(np.abs(b).max(), 1e-30))
    gtex = tcc.cube_texture_grad(cols, _t(dy), smeta, n_tex, filter_mode).numpy()
    ref = g_flat.T
    assert (np.abs(gtex - ref) <= 1e-5 * np.abs(ref).max(1, keepdims=True)).all()


def _rows_close(got, ref, rel, what):
    got = np.asarray(got).reshape(-1, ref.shape[-1])
    ref = ref.reshape(got.shape)
    assert np.isfinite(got).all(), what
    bad = np.abs(got - ref) > rel * np.abs(ref).max(1, keepdims=True)
    assert not bad.any(), f"{what}: rows {np.nonzero(bad.any(1))[0][:10]}"


def _loss(o):
    return (o ** 2 + 0.1 * o).sum()


@pytest.mark.parametrize("filter_mode,D", [(f, 1) for f in FILTERS]
                         + [("linear-mipmap-linear", 2)])
def test_cube_texture_grads_match_jax(filter_mode, D):
    tex, v, da = _cube_case(D=D, fw=8, H=16, W=16)
    mip = "mipmap" in filter_mode

    def fwd_bwd(t_, u_, d_):
        img, vjp = jax.vjp(lambda a, b, c: jtx.texture(
            a, b, c if mip else None, filter_mode=filter_mode, boundary_mode="cube",
            impl="pallas_interpret"), t_, u_, d_)
        return img, vjp(2.0 * img + 0.1)  # d/do of sum(o**2 + 0.1*o)

    ref_img, ref = jax.jit(fwd_bwd)(*(jnp.asarray(x) for x in (tex, v, da)))
    xs = [torch.tensor(x, requires_grad=True) for x in (tex, v, da)]
    img = tx.texture(xs[0], xs[1], xs[2] if mip else None, filter_mode=filter_mode,
                     boundary_mode="cube")
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref_img), atol=1e-6, rtol=0)
    got = torch.autograd.grad(_loss(img), xs if mip else xs[:2])
    for name, g, r in zip(("tex", "uv", "uv_da"), got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0 or name == "uv_da", name
        _rows_close(g.numpy(), r, 5e-5, name)
