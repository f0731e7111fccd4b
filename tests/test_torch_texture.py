"""Port parity: texture glue (mip pyramid, packing, mip level) and the
sampler's plain twin vs the JAX package (texture.py; texture_pallas
sample_fused in interpret mode).

Bars: mip levels within 1e-6 (a 2x2 mean in another summation order);
level metadata equal; the footprint mip level within 2 ulps (XLA:CPU may
contract the footprint's products into fma); the sampler within 1e-5 on
texel values in [0, 1], given the same (u, v, flevel) bits.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import texture as jtx
from nvdiffrast_tpu.ops import texture_pallas as jtp
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_cuda as tc
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

FILTERS = ("linear", "linear-mipmap-nearest", "linear-mipmap-linear")
BOUNDARIES = ("wrap", "clamp", "zero")
SHAPE = (2, 16, 24)  # B, H, W of the sampled image


@pytest.mark.parametrize("size,D,max_level", [
    ((32, 64), 1, -1), ((16, 8), 2, -1), ((32, 64), 2, 2), ((1, 8), 1, -1),
    ((12, 20), 1, 1)])
def test_mip_stack_and_meta_match_jax(size, D, max_level):
    tex = np.random.default_rng(0).random((D,) + size + (3,), dtype=np.float32)
    ref = jtx.build_mip_stack(jnp.asarray(tex), max_level, False)
    got = tx.build_mip_stack(torch.from_numpy(tex), max_level)
    assert [tuple(a.shape) for a in got] == [a.shape for a in ref]
    if max_level >= 0:
        assert len(got) <= max_level
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    levels = [torch.from_numpy(tex)] + got
    jlevels = [jnp.asarray(tex)] + ref
    assert tx._static_meta(levels) == jtx._static_meta(jlevels)
    flat, _ = jtx._pack_pyramid(jlevels, False)
    np.testing.assert_allclose(tx._pack_pyramid(levels).numpy(), np.asarray(flat),
                               atol=1e-6)


def test_odd_size_raises_like_jax():
    for size in ((12, 20), (3, 8), (32, 6)):
        with pytest.raises(ValueError) as ref:
            jtx._mip_shapes(*size, -1)
        with pytest.raises(ValueError) as got:
            tx._mip_shapes(*size, -1)
        assert str(got.value) == str(ref.value)
    assert tx._mip_shapes(12, 20, 2) == jtx._mip_shapes(12, 20, 2)
    assert len(tx._mip_shapes(1 << 20, 1, -1)) == tx.MAX_MIP_LEVEL + 1


def test_mode_checks():
    tx.check_modes("linear-mipmap-linear", "wrap")
    tx.check_modes("linear", "cube")
    tx.check_modes("nearest", "wrap")
    with pytest.raises(ValueError):
        tx.check_modes("bilinear", "wrap")
    with pytest.raises(ValueError):
        tx.check_modes("linear", "mirror")


def test_mip_level_within_2_ulps():
    rng = np.random.default_rng(1)
    n = 4000
    da = (rng.standard_normal((4, n)) * 10.0 ** rng.uniform(-5, 0, (4, n))).astype(np.float32)
    da[:, :100] = 0.0            # background pixels: -inf before the clip
    da[0, 100:200] = np.nan      # NaN -> level 0
    ref = np.asarray(jnp.clip(jtx._mip_level_from_footprint_cols(
        *(jnp.asarray(d) for d in da), jnp.float32(64.0), jnp.float32(32.0)), 0.0, 6.0))
    got = tx.mip_level(torch.from_numpy(da), 32, 64, 7).numpy()
    assert (got[:200] == 0).all() and (ref[:200] == 0).all()
    assert 0 < (got > 0).mean() < 1
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert (np.abs(got - ref) <= 2 * ulp).all(), np.abs(got - ref).max()


def _level_columns():
    """test_mip_level_within_2_ulps' footprints da [4, n] (random, zero,
    NaN) and a bias [n] on 0, on 6 = L-1, below and above them, as numpy."""
    rng = np.random.default_rng(1)
    n = 4000
    da = (rng.standard_normal((4, n)) * 10.0 ** rng.uniform(-5, 0, (4, n))).astype(np.float32)
    da[:, :100] = 0.0
    da[0, 100:200] = np.nan
    bias = np.random.default_rng(2).uniform(-2.0, 8.0, n).astype(np.float32)
    bias[200:260] = np.repeat([0.0, 6.0, -0.0, -1.0, 9.0, 3.5], 10)
    return da, bias


@pytest.mark.parametrize("case", ["bias", "footprint_bias", "strided", "strided_bias"])
def test_mip_level_bias_and_strided_within_2_ulps(case):
    """The twin with mip_level_bias (alone or with the footprint) and with
    texture()'s transposed [N, 4] view of uv_da, against JAX's level in
    texture() (texture.py:744-757): the footprint plus the bias, clipped.
    The footprint's bar is test_mip_level_within_2_ulps' (2 of its
    ulps); a bias adds one rounding on each side, and where it cancels
    the footprint the footprint's ulps are many of the sum's."""
    da, bias = _level_columns()
    use_bias = "bias" in case
    use_da = case != "bias"
    fp = (jtx._mip_level_from_footprint_cols(*(jnp.asarray(d) for d in da), jnp.float32(64.0),
                                             jnp.float32(32.0))
          if use_da else jnp.zeros(da.shape[1], jnp.float32))
    ref = np.asarray(jnp.clip(fp + jnp.asarray(bias) if use_bias else fp, 0.0, 6.0))
    d = torch.from_numpy(np.ascontiguousarray(da.T)).T if "strided" in case else (
        torch.from_numpy(da))
    assert "strided" not in case or d.stride() == (1, 4)
    got = tx.mip_level(d if use_da else None, 32, 64, 7,
                       torch.from_numpy(bias) if use_bias else None).numpy()
    assert 0 < (got == 0).mean() < 1 and 0 < ((got > 0) & (got < 6)).mean() < 1
    fp = np.asarray(fp)
    bar = 2 * np.spacing(np.abs(np.where(np.isfinite(fp), fp, 0.0)))  # -inf: zero footprints
    if use_bias:
        bar = bar + np.spacing(np.abs(ref))
    assert (np.abs(got - ref) <= bar).all(), np.abs(got - ref).max()
    if "strided" in case:  # the layout changes no bit
        dense = tx.mip_level(torch.from_numpy(da), 32, 64, 7,
                             torch.from_numpy(bias) if use_bias else None).numpy()
        assert np.array_equal(got.view(np.int32), dense.view(np.int32))


def test_mip_level_cpu_tensors_take_the_twins(monkeypatch):
    """CPU tensors never reach the kernels' launchers: mip_level and
    level_vjp return their plain twins' results."""
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(tx, "launch_mip_level", refuse)
    monkeypatch.setattr(tx, "launch_level_vjp", refuse)
    da, bias = (torch.from_numpy(a) for a in _level_columns())
    gfl = torch.linspace(-1.0, 1.0, da.shape[1])
    before = (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches)
    for d, b in ((da, None), (da.T.contiguous().T, bias), (None, bias)):
        assert torch.equal(tx.mip_level(d, 32, 64, 7, b), tx.mip_level_plain(d, 32, 64, 7, b))
        got = tx.level_vjp(d, gfl, 32, 64, 7, b)
        ref = tx.level_vjp_plain(d, gfl, 32, 64, 7, b)
        for g, r in zip(got, ref):
            assert (g is None and r is None) or torch.equal(g.nan_to_num(7.0), r.nan_to_num(7.0))
    assert (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches) == before


_N = 16
_BAD_LEVEL_ARGS = {
    "float64 da": ("fwd", torch.zeros(4, _N, dtype=torch.float64), None, None, "float32"),
    "da of 3 rows": ("fwd", torch.zeros(3, _N), None, None, r"\[4, N\]"),
    "flat da": ("fwd", torch.zeros(4 * _N), None, None, r"\[4, N\]"),
    "bias of another length": ("fwd", torch.zeros(4, _N), torch.zeros(_N + 1), None, "flat"),
    "float64 bias": ("fwd", None, torch.zeros(_N, dtype=torch.float64), None, "float32"),
    "neither da nor bias": ("fwd", None, None, None, "needs da or bias"),
    "gfl of another length": ("vjp", torch.zeros(4, _N), None, torch.zeros(_N - 1), "flat"),
    "gfl [1, N]": ("vjp", torch.zeros(4, _N), None, torch.zeros(1, _N), "flat"),
    "float64 gfl": ("vjp", torch.zeros(4, _N), None, torch.zeros(_N, dtype=torch.float64),
                    "float32"),
    "meta tensors": ("vjp", torch.zeros(4, _N, device="meta"), None,
                     torch.zeros(_N, device="meta"), "unsupported device"),
}


@pytest.mark.parametrize("case", list(_BAD_LEVEL_ARGS))
def test_mip_level_wrappers_refuse_bad_columns(case):
    kind, da, bias, gfl, match = _BAD_LEVEL_ARGS[case]
    with pytest.raises(ValueError, match=match):
        if kind == "fwd":
            tx.mip_level(da, 32, 64, 7, bias)
        else:
            tx.level_vjp(da, gfl, 32, 64, 7, bias)


def test_mip_level_launchers_need_cuda_tensors():
    da, gfl = torch.zeros(4, _N), torch.zeros(_N)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tc.launch_mip_level(da, None, 32, 64, 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tc.launch_level_vjp(da, gfl, None, 32, 64, 7)


@functools.lru_cache(maxsize=None)
def _inputs(D):
    """A 32x64x3 texture pyramid (D textures) and per-pixel uv in
    [-0.2, 1.2] with flevels spread over the levels (exact integers and
    the top level included), as numpy arrays."""
    B, H, W = SHAPE
    N = B * H * W
    rng = np.random.RandomState(D)
    tex = rng.rand(D, 32, 64, 3).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    u[:8] = [0.0, 1.0, -1.0, 0.5 / 64, 1.0 - 0.5 / 64, 1.2, -0.2, 2.0]
    v[:8] = [1.0, 0.0, 0.5 / 32, -1.0, 1.0 - 0.5 / 32, -0.2, 1.2, 0.25]
    L = 7
    fl = rng.uniform(0, L - 1, N).astype(np.float32)
    fl[8:40] = np.arange(32) % L
    return tex, u, v, fl


@functools.lru_cache(maxsize=None)
def _jax_sample(D, filter_mode, boundary_mode):
    tex, u, v, fl = _inputs(D)
    B, H, W = SHAPE
    N = B * H * W
    levels = [jnp.asarray(tex)]
    if "mipmap" in filter_mode:
        levels += jtx.build_mip_stack(levels[0], -1, False)
    smeta, _ = jtx._static_meta(levels)
    flat, _ = jtx._pack_pyramid(levels, False)
    tz = (jnp.arange(N, dtype=jnp.int32) // (H * W) if D > 1
          else jnp.zeros((N,), jnp.int32))
    out = jtp.sample_fused(flat.T, jnp.asarray(u), jnp.asarray(v),
                           jnp.asarray(fl) if len(levels) > 1 else jnp.zeros(N),
                           tz, smeta, len(levels), boundary_mode, filter_mode,
                           SHAPE, True)
    return np.asarray(flat), smeta, np.asarray(out)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("boundary_mode", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_sample_twin_matches_jax(filter_mode, boundary_mode, D):
    flat, smeta, ref = _jax_sample(D, filter_mode, boundary_mode)
    tex, u, v, fl = _inputs(D)
    L = len(smeta)
    if L == 1:
        fl = np.zeros_like(fl)
    # The port's own pyramid and packing give the same layout.
    levels = [torch.from_numpy(tex)]
    if L > 1:
        levels += tx.build_mip_stack(levels[0])
    assert tx._static_meta(levels)[0] == smeta
    flat_t, u_t, v_t, fl_t = inputs_from_numpy(flat, u, v, fl)
    got = tc.sample(flat_t, u_t, v_t, fl_t, smeta, SHAPE, D > 1, boundary_mode,
                    filter_mode)
    assert got.shape == ref.shape == (3, u.shape[0])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert np.abs(ref).max() > 0.5
    if boundary_mode == "zero":
        assert (ref == 0).any() and (got.numpy() == 0).any()


def test_sample_device_dispatch_and_checks():
    tex, u, v, fl = _inputs(1)
    levels = [torch.from_numpy(tex)] + tx.build_mip_stack(torch.from_numpy(tex))
    meta, n = tx._static_meta(levels)
    flat = tx._pack_pyramid(levels)
    assert flat.shape == (n, 3)
    args = (flat, *inputs_from_numpy(u, v, fl), meta, SHAPE, False)
    before = tc.KERNEL.launches
    got = tc.sample(*args, "wrap", "linear-mipmap-linear")
    assert torch.equal(got, tc.sample_plain(*args, "wrap", "linear-mipmap-linear"))
    assert tc.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tc.sample(flat.to("meta"), *(a.to("meta") for a in args[1:4]), *args[4:],
                  "wrap", "linear")
    with pytest.raises(ValueError):  # texture 1 of a one-texture pyramid
        tc.sample(flat, *args[1:5], SHAPE, True, "wrap", "linear")
    with pytest.raises(ValueError):
        tc.sample(*args, "cube", "linear")
