"""Port parity: render_pipeline_textured's forward (torch, plain twins)
vs the JAX package's render_pipeline_textured(impl="pallas_interpret"),
on the scene of tests/test_pipeline_tex.py:11 (B = 2, 48x64, a random
32x64x3 texture, uvs in [-0.2, 1.2], near-plane crossers); and its
gradients with per-image textures (the other end-to-end gradient case is
in test_torch_pipeline_tex_bwd.py: the two JAX references run on two
workers).

Bars:
* mip filter modes: atol 1e-5 / rtol 1e-5, the JAX suite's own
  (tests/test_pipeline_tex.py:42); for linear-mipmap-nearest the count
  of pixels beyond it (a level flip where the two log2s straddle an
  integer) is held to <= 1e-4 of the pixels, which at this size is none.
* filter_mode='linear' samples the 32x64 base level of a random texture,
  where a uv shift of one texel moves the value by up to 1. The two
  rasterizers' u, v differ by a few ulps (XLA:CPU contracts the JAX
  kernel's edge functions into fma, ROADMAP C), which moves uv by up to
  ~6e-7 and the value by up to ~2e-5: there 1e-5 / 1e-5 holds on all but
  1e-3 of the values and 3e-5 on every value.
* The chain after the rasterizer, fed the JAX rasterizer's own buffers,
  matches JAX within 1e-5 / 1e-5 in all nine filter x boundary cases.

The JAX rasterizer runs once per scene and db flag: its result is reused
by every JAX reference (the pipeline's call is memoized, same inputs).
"""

import functools
from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import pipeline_tex as jpt
from nvdiffrast_tpu.ops import rasterize_pallas as jrp
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import pipeline_tex as tpt
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import (check_textured_grads, textured_grads, textured_grads_jax,
                           textured_scene)

RES = (48, 64)
FILTERS = ("linear", "linear-mipmap-nearest", "linear-mipmap-linear")
BOUNDARIES = ("wrap", "clamp", "zero")
_RASTERIZE = jrp.rasterize_fused  # the JAX kernel, before any memo patch


_scene = textured_scene  # tests/test_pipeline_tex.py _scene


@functools.lru_cache(maxsize=None)
def _jax_raster(emit_db):
    pos, tri, _, _ = _scene()
    B, T = pos.shape[0], tri.shape[0]
    ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
    return _RASTERIZE(jnp.asarray(pos), jnp.asarray(tri), RES, ranges,
                      emit_db=emit_db, flat=True, interpret=True)


def _memo_raster(pos, tri, resolution, ranges, emit_db=True, flat=False,
                 interpret=False, **kw):
    """rasterize_pallas.rasterize_fused for the scene's own call."""
    ref_pos, ref_tri, _, _ = _scene()
    assert flat and interpret and not kw and tuple(resolution) == RES
    assert np.array_equal(np.asarray(pos), ref_pos)
    assert np.array_equal(np.asarray(tri), ref_tri)
    return _jax_raster(bool(emit_db))


@functools.lru_cache(maxsize=None)
def _jax_image(filter_mode, boundary_mode, D=1, max_mip_level=-1):
    pos, tri, uv, tex = _scene(D=D)
    with mock.patch.object(jrp, "rasterize_fused", _memo_raster):
        img = jpt.render_pipeline_textured(
            jnp.asarray(pos), jnp.asarray(tri), jnp.asarray(uv), jnp.asarray(tex),
            RES, filter_mode=filter_mode, boundary_mode=boundary_mode,
            max_mip_level=max_mip_level, impl="pallas_interpret")
    return np.asarray(img)


def _port_image(filter_mode, boundary_mode, D=1, **kw):
    pos, tri, uv, tex = _scene(D=D)
    return dr.render_pipeline_textured(*inputs_from_numpy(pos, tri, uv, tex), RES,
                                       filter_mode=filter_mode,
                                       boundary_mode=boundary_mode, **kw).numpy()


def _beyond(got, ref, atol=1e-5, rtol=1e-5):
    return np.abs(got - ref) > atol + rtol * np.abs(ref)


@pytest.mark.parametrize("boundary_mode", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_render_pipeline_textured_matches_jax(filter_mode, boundary_mode):
    ref = _jax_image(filter_mode, boundary_mode)
    got = _port_image(filter_mode, boundary_mode)
    assert got.shape == ref.shape == (2,) + RES + (3,)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.5
    bad = _beyond(got, ref)
    if filter_mode == "linear":
        assert bad.mean() <= 1e-3, bad.sum()
        np.testing.assert_allclose(got, ref, atol=3e-5)
    elif filter_mode == "linear-mipmap-nearest":
        flips = bad.any(-1).sum()
        assert flips <= 1e-4 * bad[..., 0].size, flips
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("boundary_mode", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_chain_on_jax_raster_matches_jax(filter_mode, boundary_mode):
    """Interpolate, mip level, sampler and antialias, fed the JAX
    rasterizer's buffers, against the JAX pipeline's image."""
    pos, tri, uv, tex = _scene()
    use_mip = "mipmap" in filter_mode
    raster = [np.asarray(a).reshape(-1) for a in _jax_raster(use_mip)]
    raster = raster[:8] if use_mip else raster[:4]
    p, t, a, tx = inputs_from_numpy(pos, tri, uv, tex)
    got = tpt._shade_textured(p, a, tx, t, t, build_opposite_table(t),
                              inputs_from_numpy(*raster), RES, filter_mode,
                              boundary_mode, -1)[0].numpy()
    np.testing.assert_allclose(got, _jax_image(filter_mode, boundary_mode),
                               atol=1e-5, rtol=1e-5)


def test_per_image_textures_and_mip_limit_match_jax():
    """D = B textures (image b samples texture b), and max_mip_level."""
    got = _port_image("linear-mipmap-linear", "wrap", D=2)
    np.testing.assert_allclose(got, _jax_image("linear-mipmap-linear", "wrap", D=2),
                               atol=1e-5, rtol=1e-5)
    assert not np.allclose(got[1], _port_image("linear-mipmap-linear", "wrap")[1])
    got = _port_image("linear-mipmap-linear", "clamp", max_mip_level=2)
    np.testing.assert_allclose(
        got, _jax_image("linear-mipmap-linear", "clamp", max_mip_level=2),
        atol=1e-5, rtol=1e-5)


def test_argument_forms_give_the_same_image():
    pos, tri, uv, tex = _scene()
    p, t, a, tx = inputs_from_numpy(pos, tri, uv, tex)
    base = dr.render_pipeline_textured(p, t, a, tx, RES)
    topo = dr.antialias_construct_topology_hash(t)
    assert torch.equal(dr.render_pipeline_textured(p, t, a, tx, RES,
                                                   topology_hash=topo), base)
    assert torch.equal(dr.render_pipeline_textured(p, t, a[None], tx, RES,
                                                   uv_tri=t), base)


def test_render_pipeline_textured_grads_per_image_textures_match_jax():
    """linear-mipmap-nearest, clamp, D = B = 2 textures, boost 2.5."""
    mode = ("linear-mipmap-nearest", "clamp", 2, 2.5)
    check_textured_grads(textured_grads(*mode), textured_grads_jax(*mode))


def test_error_paths(monkeypatch):
    pos, tri, uv, tex = _scene()
    p, t, a, tx = inputs_from_numpy(pos, tri, uv, tex)
    for grad_arg in range(3):
        args = [p, a, tx]
        args[grad_arg] = args[grad_arg].clone().requires_grad_()
        # Every filter mode records gradients ('linear' through the
        # composed ops' backwards).
        assert dr.render_pipeline_textured(args[0], t, args[1], args[2], (8, 8),
                                           filter_mode="linear").requires_grad
        assert dr.render_pipeline_textured(args[0], t, args[1], args[2],
                                           (8, 8)).requires_grad
        with torch.no_grad():
            dr.render_pipeline_textured(args[0], t, args[1], args[2], (8, 8),
                                        filter_mode="linear")
    with pytest.raises(NotImplementedError, match="A.10"):
        dr.render_pipeline_textured(p, t, a, tx, RES, boundary_mode="cube")
    with pytest.raises(NotImplementedError, match="A.7"):
        dr.render_pipeline_textured(p, t, a, tx, RES, filter_mode="nearest")
    with pytest.raises(ValueError, match="not divisible by 2"):
        dr.render_pipeline_textured(p, t, a, tx[:, :, :60], RES)
    with pytest.raises(ValueError, match="out of range"):
        dr.render_pipeline_textured(p, t + 50, a, tx, RES)
    with pytest.raises(ValueError):  # 3-component uvs
        dr.render_pipeline_textured(p, t, torch.cat([a, a[:, :1]], 1), tx, RES)
    with pytest.raises(ValueError):  # 3 textures for 2 images
        dr.render_pipeline_textured(p, t, a, tx.expand(3, -1, -1, -1), RES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dr.render_pipeline_textured(pos, tri, uv, tex, RES)
