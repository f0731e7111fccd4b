"""The cube texture gradient's per-tile partials (torch, plain twin).

``texture_cube_cuda.cube_tile_partials_plain`` is the twin of what the
cube tiles pass builds on the card: one float64 partial sum per texel a
16x16 screen tile's kept taps fall on. On scenes that hold tiles across
face seams, a tile on a cube corner (the average-of-3 rule), invalid
directions, signed-zero cotangents and tiles of more partials than the
kernel's scratch, for every filter and one or two textures (one per
image, or a random one per pixel):

* each texel's partials summed in float64 and rounded once are within 1
  float32 ulp of a float64 ``np.add.at`` sum of ``cube_grad_entries``'
  taps, and the CPU path (``cube_texture_grad``) is too;
* every kept tap (valid direction, weight != 0) is counted exactly once,
  texel by texel, and the partials lie in the kernel's order (tile, then
  key) with one texel each;
* the twin's row sums match the texture gradient of JAX
  ``sample_cube_fused``'s vjp (``_call_cube`` in interpret mode, the
  generic scatter) within 1e-5 of each texel row's largest entry, the
  bar of ``test_cube_twins_match_jax_call_cube``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.ops import texture_pallas as jtp
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_cube as tcg
from nvdiffrast_tpu_torch.ops import texture_cube_cuda as tcc

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

FILTERS = ("linear", "linear-mipmap-nearest", "linear-mipmap-linear")
SHAPE = (2, 36, 40)  # B, H, W: partial tiles on both edges


def _directions(B, H, W, rng):
    """[B, H, W, 3] directions and [B, H, W, 6] screen derivatives: image 0
    looks at the cube corner (1, 1, 1) through a wide field of view (three
    faces, their seams and the corner), with a disk of zero (invalid)
    directions and four pixels on cube corners; image 1 holds random directions near the base level
    (tiles of many texels)."""
    ys, xs = np.meshgrid(np.linspace(-1.3, 1.3, H), np.linspace(-1.3, 1.3, W), indexing="ij")
    fwd = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    right = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    up = np.cross(right, fwd)
    d0 = fwd + xs[..., None] * right + ys[..., None] * up
    d0[(xs + 0.8) ** 2 + (ys - 0.8) ** 2 < 0.1] = 0.0
    d0[5, 3:7] = [[1, 1, 1], [-1, 1, -1], [1, -1, 1], [-1, -1, -1]]  # on cube corners
    d1 = rng.standard_normal((H, W, 3))
    v = np.stack([d0, d1]).astype(np.float32)[:B]
    da = np.zeros((B, H, W, 6), np.float32)
    da[:, :, :-1, 0::2] = (v[:, :, 1:] - v[:, :, :-1])  # d/dX of x, y, z
    da[:, :-1, :, 1::2] = (v[:, 1:] - v[:, :-1])        # d/dY
    da[1:] = rng.standard_normal(da[1:].shape) * 1e-3   # near the base level
    return v, da


@functools.lru_cache(maxsize=None)
def _case(filter_mode, D, mixed_tz=False):
    """(cols, dy [C, N], meta, n_texels, flat) of a [D, 6, 32, 32, 3] cube
    pyramid sampled at the scene's directions through the texture op's
    forward; with mixed_tz, each pixel reads a random one of two maps (so
    tiles read both)."""
    rng = np.random.default_rng(11 + D + 3 * mixed_tz)
    B, H, W = SHAPE
    N = B * H * W
    tex = torch.from_numpy(rng.random((D, 6, 32, 32, 3), dtype=np.float32))
    v, da = _directions(B, H, W, rng)
    mip = "mipmap" in filter_mode
    spec = (filter_mode, "cube", -1, mip)
    _, saved, meta = tx._texture_fwd(spec, tex, torch.from_numpy(v),
                                     torch.from_numpy(da) if mip else None, None, ())
    flat, cols = saved[0], list(saved[6:])
    if mixed_tz:
        cols[5] = torch.from_numpy(rng.integers(0, D, N).astype(np.int32))
    dy = rng.standard_normal((3, N)).astype(np.float32)
    dy[:, :W] = 0.0    # the first image row: +0 cotangents
    dy[:, W:2 * W] = -0.0  # the second: -0
    return tuple(cols), torch.from_numpy(dy), meta, flat.shape[0], flat


def _float64_sums(cols, dy, meta, n_tex, filter_mode):
    """float64 np.add.at sums of every kept tap of cube_grad_entries, the
    kept taps' ids and the taps' float32 values [C, M]."""
    ids, w = (x.numpy() for x in tcc.cube_grad_entries(cols, meta, filter_mode))
    N = dy.shape[1]
    vals = np.tile(dy.numpy(), (1, len(ids) // N)) * w
    keep = np.tile(cols[3].numpy() != 0, len(ids) // N) & (w != 0)
    acc = np.zeros((n_tex, dy.shape[0]), np.float64)
    np.add.at(acc, ids[keep], vals[:, keep].T.astype(np.float64))
    return acc, ids[keep]


def _within_one_ulp(got, ref64):
    ref = ref64.astype(np.float32)
    got = np.asarray(got)
    assert (np.abs(got.astype(np.float64) - ref64) <= np.spacing(np.abs(ref))).all()
    zero = ref == 0  # +0 where nothing or only signed zeros were added
    assert not np.signbit(got[zero]).any()


@pytest.mark.parametrize("filter_mode,D,mixed_tz", [(f, 1, False) for f in FILTERS]
                         + [("linear-mipmap-linear", 2, False),
                            ("linear-mipmap-nearest", 2, True)])
def test_cube_tile_partials_twin(filter_mode, D, mixed_tz):
    cols, dy, meta, n_tex, _ = _case(filter_mode, D, mixed_tz)
    texel, tile, partial, taps = tcc.cube_tile_partials_plain(cols, dy, meta, filter_mode,
                                                              SHAPE)
    ref64, kept_ids = _float64_sums(cols, dy, meta, n_tex, filter_mode)

    # Per-texel sums within 1 ulp of the float64 sums of the taps, as is
    # the CPU path's gradient.
    order = torch.sort(texel, stable=True)[1]
    got = torch.zeros((n_tex, 3), dtype=torch.float64).index_add_(
        0, texel[order], partial[order]).float()
    _within_one_ulp(got.numpy(), ref64)
    _within_one_ulp(tcc.cube_texture_grad(cols, dy, meta, n_tex, filter_mode).numpy(), ref64)

    # Every kept tap once, texel by texel; the kernel's order (tile, then
    # key) with every partial on one texel of its tile.
    assert int(taps.sum()) == len(kept_ids)
    np.testing.assert_array_equal(
        np.bincount(texel.numpy(), weights=taps.numpy(), minlength=n_tex),
        np.bincount(kept_ids, minlength=n_tex))
    assert bool((tile[1:] >= tile[:-1]).all())
    assert bool((texel >= 0).all()) and bool((texel < n_tex).all())

    # The scene holds what the kernel has to get right.
    counts = torch.bincount(tile)
    assert int(counts.max()) > tcc.CUBE_CAP, "a tile past the scratch"
    fin = cols[3] != 0
    assert bool((~fin).any()), "invalid directions"
    faces = cols[4][fin]
    assert len(torch.unique(faces)) >= 3, "face seams"
    s, t, _, _, face, _ = cols
    ok4 = tcg.cube_corner_setup(s, t, face.long(), 32)[2]
    assert bool((fin & (torch.stack(ok4).min(0)[0] == 0)).any()), "a cube-corner tap"
    if mixed_tz:  # tiles that read both maps
        assert not bool((cols[5] == cols[5][0]).all())


def test_cube_tile_partials_match_jax_call_cube():
    """Image 0 of the trilinear scene (the seams, the corners, the invalid
    disk) on the second of two maps."""
    filter_mode = "linear-mipmap-linear"
    cols, dy, meta, n_tex, flat = _case(filter_mode, 2)
    _, H, W = SHAPE
    cols = tuple(x[:H * W] for x in cols[:5]) + (torch.ones(H * W, dtype=torch.int32),)
    dy = dy[:, :H * W].contiguous()
    s, t, fl, fin, face, tz = (x.numpy() for x in cols)
    L = len(meta)

    def f(fc):
        return jtp.sample_cube_fused(fc, jnp.asarray(s), jnp.asarray(t), jnp.asarray(fl),
                                     jnp.asarray(fin != 0), jnp.asarray(face), jnp.asarray(tz),
                                     tuple(meta), L, filter_mode, (1, H, W), True)

    grad = jax.jit(lambda fc, g: jax.vjp(f, fc)[1](g)[0])
    ref = np.asarray(grad(jnp.asarray(flat.numpy()).T, jnp.asarray(dy.numpy()))).T
    texel, _, partial, _ = tcc.cube_tile_partials_plain(cols, dy, meta, filter_mode,
                                                        (1, H, W))
    got = torch.zeros((n_tex, 3), dtype=torch.float64).index_add_(0, texel, partial).numpy()
    assert np.abs(ref).max() > 0
    assert (np.abs(got - ref) <= 1e-5 * np.abs(ref).max(1, keepdims=True)).all()


@pytest.mark.parametrize("shape", [None, (2, 36, 41), (1, 72)])
def test_cube_tiles_need_the_pixel_shape(shape):
    """The tiles are cut from the pixels' (B, H, W): without it, or with
    one that does not hold the N pixels, the twin refuses the call (as the
    kernels' wrappers do on the card)."""
    cols, dy, meta, _, _ = _case("linear", 1)
    with pytest.raises(ValueError):
        tcc.cube_tile_partials_plain(cols, dy, meta, "linear", shape)
