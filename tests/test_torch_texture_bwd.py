"""Port parity: the texture backward of the textured pipeline (torch, plain
twins) vs the JAX package: texture_pallas._sample_fwd + _sample_bwd in
interpret mode (the lattice scatter for one texture, the generic scatter
for per-image textures), jax.vjp of the mip level and of the pyramid.

Bars, each with its reason:
* texture_bwd (gu, gv, gfl): within 2e-6 of each output's scale. The
  JAX numbers come from the fwd_stash rows, computed inside the
  interpret-mode kernel where XLA:CPU may contract products into fma;
  the port never does.
* texture_grad: within 1 float32 ulp of float64 np.add.at sums of the
  same taps (it sums in float64 and rounds once). JAX's lattice scatter
  sums in float32 on the matrix unit, within 1e-6 of the texel's tap
  magnitudes; its generic scatter splits each term into bf16 hi and lo,
  within 2^-16 of them.
* level_vjp (the mip level's vjp to uv_da): within 4 ulps of jax.vjp on 99.5 % of the entries and
  1e-5 of the pixel's largest gradient on all (XLA:CPU contracts some of
  JAX's products into fma, which shows where terms cancel); exact zeros
  on background pixels (zero footprints; JAX gives NaN there on the CPU)
  and JAX's half gradient at flevel = 0 and L-1.
* The pyramid's vjp: bit for bit (sums of two terms and exact scalings by
  0.25 and 0.5).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import lattice_scatter as jls
from nvdiffrast_tpu.ops import texture as jtx
from nvdiffrast_tpu.ops import texture_pallas as jtp
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

FILTERS = ("linear-mipmap-nearest", "linear-mipmap-linear")
BOUNDARIES = ("wrap", "clamp", "zero")
SHAPE = (2, 16, 24)  # B, H, W of the sampled image
L = 7                # levels of a 32x64 texture


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


@functools.lru_cache(maxsize=None)
def _inputs(D):
    """D textures 32x64x3, uv in [-0.2, 1.2] with edge cases, flevels over
    every level (integers, the top level) and a colour cotangent."""
    B, H, W = SHAPE
    N = B * H * W
    rng = np.random.RandomState(20 + D)
    tex = rng.rand(D, 32, 64, 3).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    u[:8] = [0.0, 1.0, -1.0, 0.5 / 64, 1.0 - 0.5 / 64, 1.2, -0.2, 2.0]
    v[:8] = [1.0, 0.0, 0.5 / 32, -1.0, 1.0 - 0.5 / 32, -0.2, 1.2, 0.25]
    fl = rng.uniform(0, L - 1, N).astype(np.float32)
    fl[8:40] = np.arange(32) % L
    fl[40:48] = 0.0  # background pixels: uv (0, 0) at level 0
    u[40:48] = v[40:48] = 0.0
    gc = rng.standard_normal((3, N)).astype(np.float32)
    return tex, u, v, fl, gc


@functools.lru_cache(maxsize=None)
def _jax_bwd(D, filter_mode, boundary_mode):
    """JAX _sample_fwd (fwd_stash) + _sample_bwd: (flat, meta, g_flat
    [NT, C], gu, gv, gfl)."""
    tex, u, v, fl, gc = _inputs(D)
    B, H, W = SHAPE
    N = B * H * W
    levels = [jnp.asarray(tex)] + jtx.build_mip_stack(jnp.asarray(tex), -1, False)
    smeta, _ = jtx._static_meta(levels)
    flat, _ = jtx._pack_pyramid(levels, False)
    tz = (jnp.arange(N, dtype=jnp.int32) // (H * W) if D > 1
          else jnp.zeros((N,), jnp.int32))

    @jax.jit  # the interpret-mode kernels run compiled, ~2x faster
    def fwd_bwd(flat, u, v, fl, tz, gc):
        _, saved = jtp._sample_fwd(flat.T, u, v, fl, tz, smeta, L, boundary_mode,
                                   filter_mode, SHAPE, True)
        return jtp._sample_bwd(smeta, L, boundary_mode, filter_mode, SHAPE, True,
                               saved, gc)[:4]

    g_flat, gu, gv, gfl = fwd_bwd(flat, *(jnp.asarray(x) for x in (u, v, fl)), tz,
                                  jnp.asarray(gc))
    return (np.asarray(flat), smeta, np.asarray(g_flat).T,
            *(np.asarray(x) for x in (gu, gv, gfl)))


def _port_args(D, filter_mode, boundary_mode):
    flat, smeta, *_ = _jax_bwd(D, filter_mode, boundary_mode)
    tex, u, v, fl, gc = _inputs(D)
    t = inputs_from_numpy(flat, u, v, fl, gc)
    return t, smeta


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("boundary_mode", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_texture_bwd_twin_matches_jax(filter_mode, boundary_mode, D):
    (flat, u, v, fl, gc), smeta = _port_args(D, filter_mode, boundary_mode)
    got = tb.texture_bwd(flat, u, v, fl, gc, smeta, SHAPE, D > 1, boundary_mode,
                         filter_mode)
    ref = _jax_bwd(D, filter_mode, boundary_mode)[3:]
    for name, g, r in zip(("gu", "gv", "gfl"), got, ref):
        g = g.numpy()
        if name == "gfl" and filter_mode == "linear-mipmap-nearest":
            assert not g.any() and not r.any()
            continue
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6 * scale, err_msg=name)
    # Both slots run at the top level: gfl = -val + val = 0 there.
    top = fl.numpy() >= L - 1
    assert top.any() and not got[2].numpy()[top].any()


def _f64_grad(D, filter_mode, boundary_mode):
    """float64 np.add.at of the taps, expanded with the JAX package's
    lattice_setup_sep and numpy. Returns (sum, sum of |taps|)."""
    flat, smeta, *_ = _jax_bwd(D, filter_mode, boundary_mode)
    tex, u, v, fl, gc = _inputs(D)
    B, H, W = SHAPE
    N = B * H * W
    l0, l1, frac = (np.asarray(x) for x in jtp.level_weights(jnp.asarray(fl), L,
                                                             filter_mode))
    if filter_mode == "linear-mipmap-linear":
        slots = ((l0, np.float32(1.0) - frac), (l1, frac))
    else:
        slots = ((l0, np.ones_like(frac)),)
    offs, hs, ws = (np.array([m[i] for m in smeta]) for i in range(3))
    tz = np.arange(N) // (H * W) if D > 1 else np.zeros(N, np.int64)
    acc = np.zeros((flat.shape[0], 3))
    mag = np.zeros_like(acc)
    for lsel, lw in slots:
        hl, wl = hs[lsel], ws[lsel]
        jun, jvn, *w4 = (np.asarray(x) for x in jls.lattice_setup_sep(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(hl, jnp.int32),
            jnp.asarray(wl, jnp.int32), boundary_mode))
        uws, vws = w4[:2], w4[2:]
        for dv in (0, 1):
            for du in (0, 1):
                r = jvn.astype(np.int64) - 1 + dv
                c = jun.astype(np.int64) - 1 + du
                if boundary_mode == "wrap":
                    r, c = r % hl, c % wl
                elif boundary_mode == "clamp":
                    r, c = np.clip(r, 0, hl - 1), np.clip(c, 0, wl - 1)
                ok = (r >= 0) & (r < hl) & (c >= 0) & (c < wl)
                vals = ((lw * vws[dv]) * gc) * uws[du]  # float32, [3, N]
                tex_id = offs[lsel] + tz * hl * wl + r * wl + c
                np.add.at(acc, tex_id[ok], vals.T[ok].astype(np.float64))
                np.add.at(mag, tex_id[ok], np.abs(vals.T[ok]).astype(np.float64))
    return acc, mag


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("boundary_mode", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_texture_grad_twin_matches_f64_and_jax(filter_mode, boundary_mode, D):
    (flat, u, v, fl, gc), smeta = _port_args(D, filter_mode, boundary_mode)
    got = tb.texture_grad(u, v, fl, gc, smeta, flat.shape[0], SHAPE, D > 1,
                          boundary_mode, filter_mode).numpy()
    ref, mag = _f64_grad(D, filter_mode, boundary_mode)
    assert got.shape == ref.shape and np.abs(ref).max() > 1
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert (np.abs(got - ref) <= ulp).all()
    jax_g = _jax_bwd(D, filter_mode, boundary_mode)[2]
    rel = 1e-6 if D == 1 else 2.0 ** -16
    assert (np.abs(jax_g - ref) <= rel * mag + 1e-30).all()
    # Texels no tap reaches stay exactly zero.
    assert ((mag == 0) <= (got == 0)).all()


def test_texture_grad_entries_and_dispatch():
    """The kernel's index structure, the per-tile pre-reduced entries of
    the plain twin, holds every tap with a non-zero weight factor once:
    one entry per (texel, 16x16 tile) the kept taps fall on, sorted, with
    the taps' count and their float64 sum; the wrapper runs the twin on
    CPU tensors without touching the kernels."""
    (flat, u, v, fl, gc), smeta = _port_args(2, "linear-mipmap-linear", "zero")
    n_tex = flat.shape[0]
    N = u.shape[0]
    args = (u, v, fl, gc, smeta, n_tex, SHAPE, True, "zero", "linear-mipmap-linear")
    texel, tile, partial, count = tb.tile_entries_plain(*args)
    taps = tb.lattice_taps(u, v, fl, smeta, SHAPE, True, "zero", "linear-mipmap-linear")
    B, H, W = SHAPE
    p = torch.arange(N)
    ntx, nty = -(-W // tb.GRAD_TILE), -(-H // tb.GRAD_TILE)
    ptile = ((p // (H * W)) * nty + (p // W) % H // tb.GRAD_TILE) * ntx + p % W // tb.GRAD_TILE
    keys, vals = [], []
    for t, lwv, uw, ok in taps:
        keep = ok & (lwv != 0) & (uw != 0)
        keys.append((t * nty * ntx * B + ptile)[keep])
        vals.append(((lwv * gc) * uw).T[keep].double())
    keys = torch.cat(keys)
    n_kept = keys.shape[0]
    assert 0 < n_kept <= 8 * N and int(count.sum()) == n_kept
    ekeys = texel * (nty * ntx * B) + tile
    assert bool((ekeys[1:] > ekeys[:-1]).all())  # sorted, unique
    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    assert torch.equal(uk, ekeys) and torch.equal(cnt, count)
    want = torch.zeros_like(partial).index_add_(0, inv, torch.cat(vals))
    np.testing.assert_allclose(partial.numpy(), want.numpy(), rtol=1e-12, atol=1e-300)
    before = (tb.GRAD_KERNEL.launches, tb.GRAD_COMPACT_KERNEL.launches,
              tb.GRAD_SUM_KERNEL.launches, tb.BWD_KERNEL.launches)
    tb.texture_grad(*args)
    tb.texture_bwd(flat, u, v, fl, gc, smeta, SHAPE, True, "zero", "linear-mipmap-linear")
    assert (tb.GRAD_KERNEL.launches, tb.GRAD_COMPACT_KERNEL.launches,
            tb.GRAD_SUM_KERNEL.launches, tb.BWD_KERNEL.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tb.texture_grad(u.to("meta"), v.to("meta"), fl.to("meta"), gc.to("meta"),
                        *args[4:])
    with pytest.raises(ValueError):  # cotangent of the wrong channel count
        tb.texture_bwd(flat, u, v, fl, gc[:2], smeta, SHAPE, True, "zero",
                       "linear-mipmap-linear")


def _footprints():
    """uv pixel derivatives of a 32x64 texture: random, zero (background),
    and ones that land exactly on flevel 0 and L-1, and on the floor."""
    rng = np.random.default_rng(1)
    n = 3000
    da = (rng.standard_normal((4, n)) * 10.0 ** rng.uniform(-3, 0, (4, n))).astype(np.float32)
    da[:, :130] = 0.0            # background pixels, then the ties
    da[0, 110:120] = 1.0 / 64    # |dsdx| = 1: flevel exactly 0
    da[0, 120:130] = 1.0         # dsdx = 64: flevel exactly 6 = L - 1
    x = np.float32(1e-19)
    while x * x != np.float32(1e-38):  # A = B = 1e-38, C = 0: the floor
        x = np.nextafter(x, np.float32(1), dtype=np.float32)
    da[:, 130:140] = 0.0
    da[0, 130:140] = x / 64
    da[3, 130:140] = x / 32
    gfl = rng.standard_normal(n).astype(np.float32)
    return da, gfl


def test_mip_level_vjp_matches_jax():
    da, gfl = _footprints()
    tw, th = jnp.float32(64.0), jnp.float32(32.0)

    def flv(d4):
        return jnp.clip(jtx._mip_level_from_footprint_cols(
            d4[0], d4[1], d4[2], d4[3], tw, th), 0.0, float(L - 1))

    cols = tuple(jnp.asarray(d) for d in da)
    fl_ref, vjp = jax.vjp(flv, cols)
    ref = np.stack([np.asarray(x) for x in vjp(jnp.asarray(gfl))[0]])
    got = tx.level_vjp(torch.from_numpy(da), torch.from_numpy(gfl), 32, 64, L)[0].numpy()
    fl_ref = np.asarray(fl_ref)
    assert (fl_ref[110:120] == 0).all() and (fl_ref[120:130] == L - 1).all()
    # Zero footprints: the port gives exact zeros. JAX's vjp gives NaN
    # there on the CPU: XLA flushes the 1e-38 floor (a float32 subnormal)
    # to 0, and its log's derivative divides 0 by 0.
    assert np.isfinite(got).all()
    assert not got[:, :110].any() and not got[:, 130:140].any()
    floorish = np.zeros(da.shape[1], bool)
    floorish[:110] = floorish[130:140] = True
    assert np.isfinite(ref[:, ~floorish]).all()
    ref[:, floorish] = 0.0
    # Half the gradient at the clip's ties, as jax.grad of jnp.clip.
    full = np.asarray(jax.vjp(lambda d4: jtx._mip_level_from_footprint_cols(
        d4[0], d4[1], d4[2], d4[3], tw, th), cols)[1](jnp.asarray(gfl))[0][0])
    np.testing.assert_allclose(got[0, 110:130], 0.5 * full[110:130], rtol=1e-6)
    live = (fl_ref > 0) & (fl_ref < L - 1)
    assert 0.2 < live.mean() < 0.9
    # Bit for bit but for a few entries where terms cancel (XLA:CPU
    # contracts some of JAX's products into fma): those stay within 1e-5
    # of the pixel's largest gradient.
    ulps = _ulps(got, ref)
    assert (ulps <= 4).mean() >= 0.995, np.bincount(ulps.ravel())
    scale = np.abs(ref).max(0, keepdims=True)
    assert (np.abs(got - ref) <= 1e-5 * scale).all()


@pytest.mark.parametrize("case", ["bias", "footprint_bias", "strided", "strided_bias"])
def test_mip_level_vjp_bias_and_strided_match_jax(case):
    """level_vjp with mip_level_bias (alone or with the footprint) and on
    texture()'s transposed [N, 4] view of uv_da, against jax.vjp of JAX
    texture()'s level (the footprint plus the bias, clipped;
    texture.py:744-757), at test_mip_level_vjp_matches_jax's bars. The
    strided view changes no bit of the contiguous call's gradients."""
    da, gfl = _footprints()
    n = da.shape[1]
    bias = np.random.default_rng(3).uniform(-2.0, L + 1.0, n).astype(np.float32)
    bias[140:200] = np.repeat([0.0, L - 1.0, -0.0, -1.0, L + 2.0, 2.5], 10)
    use_da, use_bias = case != "bias", "bias" in case
    tw, th = jnp.float32(64.0), jnp.float32(32.0)

    def flv(d4, b):
        fl = (jtx._mip_level_from_footprint_cols(d4[0], d4[1], d4[2], d4[3], tw, th)
              if use_da else jnp.zeros(n, jnp.float32))
        return jnp.clip(fl + b if use_bias else fl, 0.0, float(L - 1))

    cols = tuple(jnp.asarray(d) for d in da)
    fl_ref, vjp = jax.vjp(flv, cols, jnp.asarray(bias))
    ref_da, ref_b = vjp(jnp.asarray(gfl))
    d = torch.from_numpy(np.ascontiguousarray(da.T)).T if "strided" in case else (
        torch.from_numpy(da))
    b = torch.from_numpy(bias) if use_bias else None
    g_da, g_b = tx.level_vjp(d if use_da else None, torch.from_numpy(gfl), 32, 64, L, b)
    assert (g_da is None) != use_da and (g_b is None) != use_bias
    fl_ref = np.asarray(fl_ref)
    assert (fl_ref == 0).any() and (fl_ref == L - 1).any()
    if use_bias:
        # The bias's gradient is gfl through the clip's ties: exact, but
        # where the footprint's level (within 4 ulps of JAX's) decides a tie.
        got_b, want_b = g_b.numpy(), np.asarray(ref_b)
        same = got_b == want_b
        assert same.all() if not use_da else same.mean() >= 0.995
    if not use_da:
        return
    got = g_da.numpy()
    ref = np.stack([np.asarray(x) for x in ref_da])
    # Zero footprints: exact zeros in the port, NaN in JAX's vjp on the CPU
    # (test_mip_level_vjp_matches_jax).
    assert np.isfinite(got).all()
    assert not got[:, :110].any() and not got[:, 130:140].any()
    ref[:, :110] = ref[:, 130:140] = 0.0
    assert np.isfinite(ref).all()
    ulps = _ulps(got, ref)
    assert (ulps <= 4).mean() >= 0.995, np.bincount(ulps.ravel())
    scale = np.abs(ref).max(0, keepdims=True)
    assert (np.abs(got - ref) <= 1e-5 * scale).all()
    if "strided" in case:
        dense = tx.level_vjp(torch.from_numpy(da), torch.from_numpy(gfl), 32, 64, L, b)
        for x, y in zip((g_da, g_b), dense):
            assert (x is None and y is None) or torch.equal(x.view(torch.int32),
                                                            y.view(torch.int32))


@pytest.mark.parametrize("size,D,max_level", [
    ((32, 64), 1, -1), ((16, 8), 2, -1), ((1, 8), 1, -1), ((32, 64), 2, 2)])
def test_pyramid_vjp_matches_jax(size, D, max_level):
    rng = np.random.default_rng(2)
    tex = rng.random((D,) + size + (3,), dtype=np.float32)

    def pyramid(t):
        return jtx._pack_pyramid([t] + jtx.build_mip_stack(t, max_level, False), False)[0]

    flat, vjp = jax.vjp(pyramid, jnp.asarray(tex))
    g_flat = rng.standard_normal(flat.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g_flat))
    levels = [torch.from_numpy(tex)] + tx.build_mip_stack(torch.from_numpy(tex), max_level)
    meta, n = tx._static_meta(levels)
    assert n == flat.shape[0]
    got = tx.pyramid_vjp(torch.from_numpy(g_flat), meta, D, 3)
    assert got.shape == tex.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
