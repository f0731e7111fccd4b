"""Port parity: the rasterizer's range mode, viewport bands and per-tile
binning (torch, plain twins) vs the JAX package in
``impl="pallas_interpret"``.

* Range mode (2-D pos, ranges [B, 2]) on tests/test_rasterize.py:98's
  two triangles and on a random B = 3 scene with overlapping windows:
  ids bit for bit, u, v, z/w within 1e-4 and rast_db within 1e-3 where
  the ids agree (tests/test_parity_sweep.py's bars); ``torch.autograd.grad``
  of a weighted sum of rast and rast_db to the shared [V, 4] vs
  ``jax.grad`` within 5e-5 of the largest gradient and each vertex row
  within 5e-4 of its largest (tests/_torch_parity.py's bars).
* The composed rasterize -> interpolate([V, A]) -> antialias in range
  mode, forward within 1e-5 and gradients to pos and the attributes
  at the same bars; tests/test_interpolate.py:110's scene.
* Viewport bands: rasterize and antialias bands equal JAX's bands with
  the same viewport (ids bit for bit), the band equals the full
  render's rows bit for bit, and the band's rasterize gradient matches
  ``jax.grad``.
* Binning: the binned twin equals the unbinned twin bit for bit on
  tests/test_parity_sweep.py:84's sphere (forced by ``BIN_MIN_WORK``);
  on the sliver scenes (:166) and the escapee triangles (:247) the
  port's binned ids equal JAX's CSR path bit for bit, but where JAX's
  CPU evaluation contracts an edge function's multiply-adds into fused
  ones and that flips the pixel's coverage (sliver seed 1, one pixel on
  the image border: a1 = 5.96e-8 rounded step by step, 0 or below
  fused). The port's kernel is built with -fmad=false and rounds each
  step, as its twin does.
* ROADMAP C.3: instance mode ignores ``ranges``; ``render_pipeline`` and
  ``render_pipeline_textured`` refuse 2-D pos with JAX's ValueError.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvdiffrast_tpu as jdr
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu.ops import rasterize_pallas as rp
from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.utils import camera

from _torch_parity import GRAD_RTOL, ROW_RTOL, random_scene, sphere_scene
from test_parity_sweep import _ESCAPEE_VERTS, _sliver_scene

IMPL = "pallas_interpret"


# ---------------------------------------------------------------------------
# Scenes (numpy, from seeds).
# ---------------------------------------------------------------------------

def _two_tris():
    """tests/test_rasterize.py:98: two triangles, one per image."""
    pos = np.array([[-0.8, -0.8, 0.0, 1.0], [0.8, -0.8, 0.0, 1.0],
                    [-0.8, 0.8, 0.0, 1.0], [0.8, 0.8, 0.0, 1.0]], np.float32)
    tri = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    return pos, tri, np.array([[0, 1], [1, 1]], np.int32), (32, 32)


def _random_b3():
    """A random scene (near-plane crossers, degenerates) as one 2-D pos,
    B = 3 images with overlapping windows."""
    pos, tri = random_scene(4, B=1, V=64, T=48)
    return pos[0], tri, np.array([[0, 30], [10, 30], [20, 28]], np.int32), (40, 56)


SCENES = {"two_tris": _two_tris, "random_b3": _random_b3}


def _weights(B, res, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, B) + res + (4,)).astype(np.float32)
    return w[0], w[1]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# ---------------------------------------------------------------------------
# Range mode.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_range(name):
    """JAX forward and the gradient of sum(rast*w1) + sum(db*w2) to pos."""
    pos, tri, ranges, res = SCENES[name]()
    w1, w2 = _weights(ranges.shape[0], res)

    def fwd(p):
        return jdr.rasterize(None, p, jnp.asarray(tri), res, ranges=jnp.asarray(ranges),
                             impl=IMPL)

    def loss(p):
        r, db = fwd(p)
        return jnp.sum(r * w1) + jnp.sum(db * w2)

    r, db = jax.jit(fwd)(jnp.asarray(pos))
    g = jax.jit(jax.grad(loss))(jnp.asarray(pos))
    return np.asarray(r), np.asarray(db), np.asarray(g)


def _check_rast(got, ref, got_db, ref_db):
    got, got_db = np.asarray(got), np.asarray(got_db)
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    assert (ref[..., 3] > 0).sum() > 20
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got_db, ref_db, atol=1e-3)


def _check_grad(got, ref):
    got = np.asarray(got)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= GRAD_RTOL * scale
    g, r = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    bad = np.abs(g - r) > ROW_RTOL * np.abs(r).max(1, keepdims=True)
    assert not bad.any(), f"rows {np.nonzero(bad.any(1))[0]}"


@pytest.mark.parametrize("name", list(SCENES))
def test_range_mode_matches_jax(name):
    pos, tri, ranges, res = SCENES[name]()
    ref, ref_db, ref_g = _jax_range(name)
    p, t, rg = _t(pos, tri, ranges)
    p.requires_grad_()
    rast, db = dr.rasterize(None, p, t, res, ranges=rg)
    _check_rast(rast.detach(), ref, db.detach(), ref_db)
    w1, w2 = _weights(ranges.shape[0], res)
    loss = (rast * torch.from_numpy(w1)).sum() + (db * torch.from_numpy(w2)).sum()
    _check_grad(torch.autograd.grad(loss, p)[0], ref_g)


def test_range_mode_equals_instance_renders_of_the_windows(monkeypatch):
    """Image b of a range-mode render is the instance-mode render of
    tri[start:start+count], ids shifted by start, bit for bit (the
    binned sweep too)."""
    pos, tri, ranges, res = _random_b3()
    p, t, rg = _t(pos, tri, ranges)
    for binned, work in ((False, 1 << 62), (True, 0)):
        monkeypatch.setattr(rc, "BIN_MIN_WORK", work)
        got = rc.rasterize_fused(p, t, res, ranges=rg, emit_db=True, emit_zbuf=True)
        for b, (s, c) in enumerate(ranges.tolist()):
            one = rc.rasterize_fused(p[None], t[s:s + c], res, emit_db=True,
                                     emit_zbuf=True)
            ids = torch.where(one[3][0] > 0, one[3][0] + s, 0.0)
            assert torch.equal(got[3][b], ids)
            for k in (0, 1, 2, 4, 5, 6, 7, 8):
                assert torch.equal(got[k][b], one[k][0]), (binned, b, k)


def _range_chain_scene():
    """The random B = 3 scene with [V, 3] attributes."""
    pos, tri, ranges, res = _random_b3()
    attr = np.random.default_rng(3).standard_normal((pos.shape[0], 3)).astype(np.float32)
    return pos, tri, ranges, res, attr


@functools.lru_cache(maxsize=None)
def _jax_range_chain():
    pos, tri, ranges, res, attr = _range_chain_scene()
    jt, jr = jnp.asarray(tri), jnp.asarray(ranges)

    def fwd(p, a):
        rast, _ = jdr.rasterize(None, p, jt, res, ranges=jr, impl=IMPL)
        col, _ = jdr.interpolate(a, rast, jt, impl=IMPL)
        return jdr.antialias(col, rast, p, jt, impl=IMPL)

    img = jax.jit(fwd)(jnp.asarray(pos), jnp.asarray(attr))
    g = jax.jit(jax.grad(lambda p, a: jnp.sum(fwd(p, a) ** 2), argnums=(0, 1)))(
        jnp.asarray(pos), jnp.asarray(attr))
    return np.asarray(img), np.asarray(g[0]), np.asarray(g[1])


def test_range_mode_interpolate_antialias_match_jax():
    pos, tri, ranges, res, attr = _range_chain_scene()
    ref, ref_gp, ref_ga = _jax_range_chain()
    p, t, rg, a = _t(pos, tri, ranges, attr)
    p.requires_grad_()
    a.requires_grad_()
    rast, _ = dr.rasterize(None, p, t, res, ranges=rg)
    col, _ = dr.interpolate(a, rast, t)
    img = dr.antialias(col, rast, p, t)
    np.testing.assert_allclose(img.detach().numpy(), ref, atol=1e-5)
    gp, ga = torch.autograd.grad((img ** 2).sum(), (p, a))
    _check_grad(gp, ref_gp)
    _check_grad(ga, ref_ga)


def test_range_mode_interpolate_scene():
    """tests/test_interpolate.py:110: [V, A] attributes against a
    range-mode rast, values in the vertices' range, and equal to JAX."""
    pos = np.array([[-0.8, -0.8, 0.0, 1.0], [0.8, -0.8, 0.0, 1.0],
                    [-0.8, 0.8, 0.0, 1.0]], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    ranges = np.array([[0, 1]], np.int32)
    attr = np.array([[1.0], [2.0], [3.0]], np.float32)
    jt = jnp.asarray(tri)

    def jinterp(x):
        rast, _ = jdr.rasterize(None, jnp.asarray(pos), jt, (16, 16),
                                ranges=jnp.asarray(ranges), impl=IMPL)
        return jdr.interpolate(x, rast, jt, impl=IMPL)[0]

    jout = jax.jit(jinterp)(jnp.asarray(attr))
    jga = jax.jit(jax.grad(lambda x: jnp.sum(jinterp(x))))(jnp.asarray(attr))
    p, t, rg, a = _t(pos, tri, ranges, attr)
    a.requires_grad_()
    rast, _ = dr.rasterize(None, p, t, (16, 16), ranges=rg)
    out, _ = dr.interpolate(a, rast, t)
    covered = rast[..., 3] > 0
    vals = out[..., 0][covered]
    assert covered.sum() > 50 and (vals >= 1.0 - 1e-5).all() and (vals <= 3.0 + 1e-5).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-6)
    ga = torch.autograd.grad(out.sum(), a)[0]
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5)


# ---------------------------------------------------------------------------
# Viewport bands.
# ---------------------------------------------------------------------------

VP_FULL = (56, 48)   # full image (H, W)
VP_H = 16            # band height
VP_Y0 = [0, 20, 40]  # band tops: the first, a middle and the last rows


@functools.lru_cache(maxsize=None)
def _vp_scene():
    pos, tri, attr, _ = sphere_scene(B=2, seed=7)
    return pos, tri, attr


@functools.lru_cache(maxsize=None)
def _jax_band_fns():
    """JAX's band forward and rasterize gradient, jitted once with the
    band's top y0 traced (the viewport's y0 may be traced in JAX)."""
    pos, tri, attr = _vp_scene()
    jt, res = jnp.asarray(tri), (VP_H, VP_FULL[1])

    def fwd(p, y0):
        vp = (y0, VP_FULL[0])
        rast, db = jdr.rasterize(None, p, jt, res, impl=IMPL, viewport=vp)
        col, _ = jdr.interpolate(jnp.asarray(attr), rast, jt, impl=IMPL)
        return rast, db, jdr.antialias(col, rast, p, jt, impl=IMPL, viewport=vp)

    def loss(p, y0, w1, w2):
        rast, db, _ = fwd(p, y0)
        return jnp.sum(rast * w1) + jnp.sum(db * w2)

    return jax.jit(fwd), jax.jit(jax.grad(loss))


@pytest.mark.parametrize("y0", VP_Y0)
def test_viewport_bands_match_jax(y0):
    pos, tri, attr = _vp_scene()
    res, vp = (VP_H, VP_FULL[1]), (y0, VP_FULL[0])
    w1, w2 = _weights(2, res, seed=y0)
    fwd, grad = _jax_band_fns()
    ref, ref_db, ref_aa = (np.asarray(x) for x in fwd(jnp.asarray(pos), y0))
    ref_g = np.asarray(grad(jnp.asarray(pos), y0, w1, w2))
    p, t, a = _t(pos, tri, attr)
    p.requires_grad_()
    rast, db = dr.rasterize(None, p, t, res, viewport=vp)
    _check_rast(rast.detach(), ref, db.detach(), ref_db)
    # The band is the full render's rows, bit for bit.
    full, full_db = dr.rasterize(None, p.detach(), t, VP_FULL)
    assert torch.equal(rast.detach(), full[:, y0:y0 + VP_H])
    assert torch.equal(db.detach(), full_db[:, y0:y0 + VP_H])
    # Antialias on JAX's band rast (the ids agree; z/w may differ by an
    # ulp, which can flip a pair's triangle choice).
    jrast = torch.from_numpy(np.array(ref))
    col, _ = dr.interpolate(a, jrast, t)
    aa = dr.antialias(col, jrast, p.detach(), t, viewport=vp)
    np.testing.assert_allclose(aa.numpy(), ref_aa, atol=1e-5)
    loss = (rast * torch.from_numpy(w1)).sum() + (db * torch.from_numpy(w2)).sum()
    _check_grad(torch.autograd.grad(loss, p)[0], ref_g)


def test_viewport_antialias_gradients_match_jax():
    pos, tri, attr = _vp_scene()
    res, vp = (VP_H, VP_FULL[1]), (VP_Y0[1], VP_FULL[0])
    jt = jnp.asarray(tri)

    # Both antialias the same (JAX's) band rast, as test_torch_antialias_bwd.
    rast, _ = jdr.rasterize(None, jnp.asarray(pos), jt, res, impl=IMPL, viewport=vp)

    def jloss(p, c):
        return jnp.sum(jdr.antialias(c, rast, p, jt, impl=IMPL, viewport=vp) ** 2)

    color = np.random.default_rng(5).random((2,) + res + (3,), dtype=np.float32)
    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(pos), jnp.asarray(color))
    p, t, c, rast = _t(pos, tri, color, rast)
    p.requires_grad_()
    c.requires_grad_()
    gp, gc = torch.autograd.grad(
        (dr.antialias(c, rast, p, t, viewport=vp) ** 2).sum(), (p, c))
    _check_grad(gp, np.asarray(ref[0]))
    np.testing.assert_allclose(gc.numpy(), np.asarray(ref[1]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Binning.
# ---------------------------------------------------------------------------

def _big_sphere():
    """tests/test_parity_sweep.py:84: uv_sphere(24, 48), ~2.2k triangles."""
    pos_idx, vtxp, _, _ = primitives.uv_sphere(24, 48)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.2)
    return (posw @ mvp.T)[None].astype(np.float32), pos_idx


def test_binned_twin_equals_unbinned(monkeypatch):
    pos, tri = _big_sphere()
    p, t = _t(pos, tri)
    res = (96, 128)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 1 << 62)
    ref = rc.rasterize_fused(p, t, res, emit_db=True, emit_zbuf=True)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 0)
    _, aabb, counts, _ = rc.setup_records(p, t, res)
    assert rc.binned_by_default(1, t.shape[0], res)
    start, lst = rc.bin_records(aabb, res, counts)
    assert start.shape == (48 + 1,) and int(start[-1]) == lst.numel() > t.shape[0]
    got = rc.rasterize_fused(p, t, res, emit_db=True, emit_zbuf=True)
    assert int((got[3] > 0).sum()) > 3000
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_bin_entry_limit(monkeypatch):
    """Lists of MAX_BIN_ENTRIES entries or more (int32 indices) raise
    ValueError, from bin_records and from a binned render."""
    pos, tri = _big_sphere()
    p, t = _t(pos, tri)
    res = (96, 128)
    _, aabb, counts, _ = rc.setup_records(p, t, res)
    n = rc.bin_records(aabb, res, counts)[1].numel()
    monkeypatch.setattr(rc, "MAX_BIN_ENTRIES", n + 1)
    assert rc.bin_records(aabb, res, counts)[1].numel() == n
    monkeypatch.setattr(rc, "MAX_BIN_ENTRIES", n)
    with pytest.raises(ValueError, match="tile list entries"):
        rc.bin_records(aabb, res, counts)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 0)
    with pytest.raises(ValueError, match="tile list entries"):
        rc.rasterize_fused(p, t, res)


def _jax_csr_ids(pos, tri, res):
    """JAX's CSR path (the remap budget shrunk to 0), as its tests force it."""
    orig = rp._REMAP_MAX_ENTRIES
    try:
        rp._REMAP_MAX_ENTRIES = 0
        r, _ = jdr.rasterize(None, jnp.asarray(pos), jnp.asarray(tri), res, impl=IMPL)
    finally:
        rp._REMAP_MAX_ENTRIES = orig
    return np.asarray(r[..., 3])


def _escapee_scene():
    """tests/test_parity_sweep.py:247's triangles on distinct depths."""
    v = np.asarray(_ESCAPEE_VERTS, np.float32).reshape(-1, 3, 4)
    T = v.shape[0]
    zfrac = np.linspace(-0.45, 0.45, T, dtype=np.float32)
    v[..., 2] = zfrac[:, None] * v[..., 3]
    return v.reshape(1, -1, 4), np.arange(3 * T, dtype=np.int32).reshape(T, 3)


def _contraction_flips(rec, k, px, py, res):
    """Whether record k's coverage of pixel (px, py) differs between
    rounding each step of its edge functions, (s0 + s1*fx) + s2*fy, and
    fusing one or both multiply-adds."""
    H, W = res
    f32, f64 = np.float32, np.float64
    fx = f32(f32(px) * f32(2.0 / W) + f32(1.0 / W - 1.0))
    fy = f32(f32(py) * f32(2.0 / H) + f32(1.0 / H - 1.0))
    s = rec[:, k]

    def covered(order):
        ok = True
        for i in (0, 3, 6):
            t = (f32(f64(s[i]) + f64(s[i + 1]) * f64(fx)) if order & 1
                 else f32(s[i] + f32(s[i + 1] * fx)))
            a = (f32(f64(t) + f64(s[i + 2]) * f64(fy)) if order & 2
                 else f32(t + f32(s[i + 2] * fy)))
            tie = s[i + 2] > 0 or (s[i + 2] == 0 and s[i + 1] > 0)
            ok &= bool(a > 0 or (a == 0 and tie))
        return ok

    return any(covered(o) != covered(0) for o in (1, 2, 3))


@pytest.mark.parametrize("case", ["sliver0", "sliver1", "escapees"])
def test_binned_ids_match_jax_csr(case, monkeypatch):
    if case == "escapees":
        pos, tri = _escapee_scene()
        res = (256, 256)
    else:
        pos, tri = (np.asarray(x) for x in _sliver_scene(int(case[-1])))
        res = (192, 256)
    ref = _jax_csr_ids(pos, tri, res)
    p, t = _t(pos, tri)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 1 << 62)
    unbinned = rc.rasterize_fused(p, t, res)[3]
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 0)
    got = rc.rasterize_fused(p, t, res)[3]
    assert (ref > 0).sum() >= 1
    assert torch.equal(got, unbinned)
    rec = rc.build_records(p, t, res)[0][0].T.numpy()
    for b, y, x in np.argwhere(got.numpy() != ref):
        ids = {int(got[b, y, x]) - 1, int(ref[b, y, x]) - 1} - {-1}
        assert any(_contraction_flips(rec, k, x, y, res) for k in ids), (b, y, x)
    assert (got.numpy() != ref).sum() <= (1 if case == "sliver1" else 0)


# ---------------------------------------------------------------------------
# ROADMAP C.3: instance mode ignores ranges; the pipelines refuse 2-D pos.
# ---------------------------------------------------------------------------

def test_instance_mode_ignores_ranges():
    pos, tri, _, _ = sphere_scene(B=1, seed=1)
    p, t = _t(pos, tri)
    ref = dr.rasterize(None, p, t, (16, 16))
    for rg in (torch.tensor([[0, 0]], dtype=torch.int32), np.zeros((3, 5), np.int32)):
        got = dr.rasterize(None, p, t, (16, 16), ranges=rg)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert int((ref[0][..., 3] > 0).sum()) > 50


def test_pipelines_refuse_2d_pos():
    pos, tri, attr, _ = sphere_scene(B=1, seed=1)
    p2, t, a = _t(pos[0], tri, attr[0])
    with pytest.raises(ValueError, match="range mode requires `ranges`"):
        dr.render_pipeline(p2, t, a, (16, 16))
    uv = torch.rand(p2.shape[0], 2)
    tex = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError, match="range mode requires ranges"):
        dr.render_pipeline_textured(p2, t, uv, tex, (16, 16))
    with pytest.raises(ValueError, match="range mode requires"):
        dr.rasterize(None, p2, t, (16, 16))
    with pytest.raises(ValueError, match="ranges"):
        dr.rasterize(None, p2, t, (16, 16), ranges=torch.zeros((2, 3), dtype=torch.int32))
