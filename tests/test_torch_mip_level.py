"""The mip level kernels (``csrc/mip_level.cu``: ``texture.mip_level`` and
``texture.level_vjp`` on CUDA tensors) against their plain twins
(``mip_level_plain``, ``level_vjp_plain``) run on the same CUDA tensors,
bit for bit; and the textured pipeline and ``texture()`` with the kernels
against the same calls with the twins patched in, bit for bit.

Marked `cuda`; each test skips where torch sees no CUDA device. No JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mip_level.py
"""

import numpy as np
import pytest
import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_cuda as tc

from _torch_parity import textured_scene

pytestmark = pytest.mark.cuda

L = 7            # levels of a 32x64 texture
TH, TW = 32, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the GPU)")
    return torch.device("cuda", 0)


def _same_bits(got, ref):
    """NaN at the same entries, the same bits everywhere else."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan), int((torch.isnan(got) != nan).sum())
    a, b = got[~nan], ref[~nan]
    differ = a.view(torch.int32) != b.view(torch.int32)
    assert not bool(differ.any()), (int(differ.sum()), a[differ][:4].tolist(),
                                    b[differ][:4].tolist())


def _columns(n, seed=0):
    """(da [4, n], gfl [n], bias [n]) as numpy. Random footprints over six
    decades, then the special entries first: zero footprints (the 1e-38
    floor), a footprint whose major axis squared is the floor itself,
    levels exactly 0 and L-1 (the clip's ties), NaN and inf derivatives,
    biases on 0, on L-1, negative, past L-1 and NaN, and cotangents 0, -0
    and inf."""
    rng = np.random.default_rng(seed)
    da = (rng.standard_normal((4, n)) * 10.0 ** rng.uniform(-4, 1, (4, n))).astype(np.float32)
    bias = rng.uniform(-2.0, L + 1.0, n).astype(np.float32)
    gfl = rng.standard_normal(n).astype(np.float32)
    x = np.float32(1e-19)
    while x * x != np.float32(1e-38):
        x = np.nextafter(x, np.float32(1), dtype=np.float32)
    special = np.zeros((4, 96), np.float32)                 # 0-15: zero footprints
    special[0, 16:24] = x / TW                              # the floor exactly
    special[3, 16:24] = x / TH
    special[0, 24:40] = 1.0 / TW                            # flevel 0
    special[0, 40:56] = 1.0                                 # flevel L-1
    special[1, 56:64] = np.nan
    special[2, 64:72] = np.inf
    special[:, 72:80] = np.inf                              # inf - inf in l2n
    special[0, 80:96] = rng.uniform(0.01, 0.1, 16)
    sbias = np.array([0.0, float(L - 1), -0.0, -1.5, L + 3.0, np.nan, 0.5, 2.0] * 12, np.float32)
    k = min(n, 96)
    da[:, :k] = special[:, :k]
    bias[:k] = sbias[:k]
    gfl[80:84] = [0.0, -0.0, np.inf, -1.0][:max(0, min(n, 84) - 80)]
    return da, gfl, bias


def _case(dev, n, case):
    """(da on the card: a [4, n] stream, or a transposed [n, 4] view for
    `strided`, or None for `bias`; gfl; bias or None)."""
    da, gfl, bias = (torch.from_numpy(a).to(dev) for a in _columns(n, seed=n))
    if "strided" in case:
        da = da.T.contiguous().T                      # strides (1, 4)
        assert n < 2 or da.stride() == (1, 4)
    return (None if case == "bias" else da), gfl, (bias if "bias" in case else None)


CASES = ["footprint", "footprint_strided", "bias", "footprint_bias", "footprint_strided_bias"]


@pytest.mark.parametrize("n", [0, 1, 255, 257, 70_001])
@pytest.mark.parametrize("case", CASES)
def test_mip_level_kernel_matches_twin(dev, n, case):
    da, _, bias = _case(dev, n, case)
    before = tc.LEVEL_KERNEL.launches
    got = tx.mip_level(da, TH, TW, L, bias)
    ref = tx.mip_level_plain(da, TH, TW, L, bias)
    torch.cuda.synchronize()
    assert tc.LEVEL_KERNEL.launches == before + (n > 0)
    _same_bits(got, ref)
    if n > 1000:
        assert bool((got == 0).any()) and bool((got == L - 1).any())
        assert bool(((got > 0) & (got < L - 1)).float().mean() > 0.1)


@pytest.mark.parametrize("n", [0, 1, 255, 257, 70_001])
@pytest.mark.parametrize("case", CASES)
def test_level_vjp_kernel_matches_twin(dev, n, case):
    da, gfl, bias = _case(dev, n, case)
    before = tc.LEVEL_VJP_KERNEL.launches
    got = tx.level_vjp(da, gfl, TH, TW, L, bias)
    ref = tx.level_vjp_plain(da, gfl, TH, TW, L, bias)
    torch.cuda.synchronize()
    assert tc.LEVEL_VJP_KERNEL.launches == before + (n > 0)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            _same_bits(g, r)
    if n > 1000 and da is not None:
        assert float(got[0][:, 100:].abs().max()) > 0
        assert not bool(got[0][:, :16].any())          # zero footprints pass nothing


def test_level_kernels_without_bias_or_footprint_refuse(dev):
    gfl = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="needs da or bias"):
        tx.mip_level(None, TH, TW, L)
    with pytest.raises(ValueError, match="needs da or bias"):
        tx.level_vjp(None, gfl, TH, TW, L)
    with pytest.raises(ValueError, match="one device"):
        tx.level_vjp(gfl.cpu().expand(4, 8), gfl, TH, TW, L)


def _pipeline_step(dev, res=(96, 128)):
    """A textured fwd+bwd (linear-mipmap-linear): (image, g_pos, g_uv, g_tex)."""
    pos, tri, uv, tex = (torch.as_tensor(x, device=dev) for x in textured_scene(seed=3, B=2))

    def step():
        xs = [x.clone().requires_grad_() for x in (pos, uv, tex)]
        img = dr.render_pipeline_textured(xs[0], tri, xs[1], xs[2], res)
        return (img.detach(),) + torch.autograd.grad((img ** 2).mean(), xs)

    return step


def _twins_in(monkeypatch):
    """Route texture.py's level calls to the plain twins (on the card)."""
    monkeypatch.setattr(tx, "launch_mip_level",
                        lambda da, bias, h, w, L: tx.mip_level_plain(da, h, w, L, bias))
    monkeypatch.setattr(tx, "launch_level_vjp",
                        lambda da, gfl, bias, h, w, L: tx.level_vjp_plain(da, gfl, h, w, L, bias))


def test_textured_pipeline_launches_each_level_kernel_once(dev):
    pos, tri, uv, tex = (torch.as_tensor(x, device=dev) for x in textured_scene(seed=3, B=2))
    xs = [x.clone().requires_grad_() for x in (pos, uv, tex)]
    fwd, bwd = tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches
    img = dr.render_pipeline_textured(xs[0], tri, xs[1], xs[2], (96, 128))
    assert (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches) == (fwd + 1, bwd)
    torch.autograd.grad((img ** 2).mean(), xs)
    torch.cuda.synchronize()
    assert (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches) == (fwd + 1, bwd + 1)


def test_textured_pipeline_kernels_equal_twins(dev, monkeypatch):
    step = _pipeline_step(dev)
    got = step()
    _twins_in(monkeypatch)
    before = (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches)
    ref = step()
    torch.cuda.synchronize()
    assert (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches) == before
    for g, r in zip(got, ref):
        _same_bits(g, r)
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.parametrize("cube", [False, True], ids=["2d", "cube"])
@pytest.mark.parametrize("inputs", ["uv_da", "uv_da_bias", "bias"])
def test_texture_op_kernels_equal_twins(dev, monkeypatch, cube, inputs):
    """texture() forward and backward, with uv_da (2-D: the [N, 4] view
    of uv_da; cube: the face derivatives) and / or mip_level_bias."""
    rng = np.random.RandomState(6)
    B, H, W = 2, 24, 40
    tex = rng.rand(1, 6, 16, 16, 3) if cube else rng.rand(2, 32, 64, 3)
    uv = rng.randn(B, H, W, 3) if cube else rng.uniform(-0.2, 1.2, (B, H, W, 2))
    uv_da = rng.randn(B, H, W, 6 if cube else 4) * 10.0 ** rng.uniform(-3, -0.5, (B, H, W, 1))
    bias = rng.uniform(-1, 5, (B, H, W))
    use = {"uv_da": (True, False), "uv_da_bias": (True, True), "bias": (False, True)}[inputs]

    def run():
        xs = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
              for a in (tex, uv, uv_da, bias)]
        img = dr.texture(xs[0], xs[1], xs[2] if use[0] else None, xs[3] if use[1] else None,
                         boundary_mode="cube" if cube else "wrap",
                         filter_mode="linear-mipmap-linear")
        used = xs[:2] + [x for x, u in zip(xs[2:], use) if u]
        return (img.detach(),) + torch.autograd.grad((img ** 2).sum(), used)

    fwd, bwd = tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches
    got = run()
    assert (tc.LEVEL_KERNEL.launches, tc.LEVEL_VJP_KERNEL.launches) == (fwd + 1, bwd + 1)
    _twins_in(monkeypatch)
    ref = run()
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _same_bits(g, r)
    assert float(got[-1].abs().max()) > 0
