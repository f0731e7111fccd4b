"""Port parity: the earth texture-fitting model (torch, plain twins) vs
the JAX package's (nvdiffrast_tpu.models.fit_earth), and the image
helpers and primitives it uses.

* ``utils.image``: bilinear_downsample within 1e-6 of JAX's XLA
  convolution (the port filters rows then columns elementwise); psnr
  equal within 1e-5 dB.
* The same seed gives the same initial texture and cameras;
  ``set_params`` carries the JAX model's texture across.
* First step, with and without mipmaps: the loss within rtol 1e-5 and its
  texture gradient within 5e-5 of its largest entry and each texel row
  within 5e-4 of the row's largest (``_torch_parity.check_textured_grads``'
  bars). The JAX model runs its XLA rasterizer on the CPU, whose u and v
  differ from the Pallas rule's by a few ulps; that moves the taps of
  texels that only a silhouette pixel reaches by up to 2.2e-4 of their
  row.
* Convergence at tests/test_models.py's bar: texture PSNR > 10 dB after
  50 steps at res 32, ref 64, tex 32x64, max mip level 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrast_tpu.models import fit_earth as jfe
from nvdiffrast_tpu.models import primitives as jprim
from nvdiffrast_tpu.utils import image as jim
from nvdiffrast_tpu_torch.models import primitives
from nvdiffrast_tpu_torch.models.fit_earth import EarthFitModel
from nvdiffrast_tpu_torch.utils import image

from _torch_parity import GRAD_RTOL, ROW_RTOL


def test_image_helpers_and_texture_match_jax():
    x = np.random.RandomState(0).rand(2, 16, 24, 3).astype(np.float32)
    for steps in (1, 2):
        np.testing.assert_allclose(image.bilinear_downsample(torch.from_numpy(x), steps).numpy(),
                                   np.asarray(jim.bilinear_downsample(x, steps)), atol=1e-6)
    assert image.psnr(torch.from_numpy(x), torch.from_numpy(x[::-1].copy())) == pytest.approx(
        jim.psnr(x, x[::-1]), abs=1e-5)
    assert image.psnr(torch.from_numpy(x), torch.from_numpy(x)) == float("inf")
    np.testing.assert_array_equal(primitives.checkerboard_texture(32, 64),
                                  jprim.checkerboard_texture(32, 64))


@pytest.mark.parametrize("enable_mip", [True, False])
def test_earth_first_step_matches_jax(enable_mip):
    kw = dict(res=32, ref_res=64, tex_res=(32, 64), enable_mip=enable_mip, max_mip_level=4,
              seed=0)
    jm = jfe.EarthFitModel(**kw)
    m = EarthFitModel(**kw, device="cpu")
    np.testing.assert_array_equal(m.params.detach().numpy(), np.asarray(jm.params))
    tex = np.random.RandomState(1).rand(32, 64, 3).astype(np.float32)
    m.set_params(tex)
    mtx = m.random_mvp()
    np.testing.assert_array_equal(mtx, jm.random_mvp())

    def jloss(p):
        ref = jfe.render(mtx, jm.vtx_pos, jm.pos_idx, jm.vtx_uv, jm.uv_idx, jm.tex_ref, 64,
                         True, 4)
        ref = jim.bilinear_downsample(ref)
        img = jfe.render(mtx, jm.vtx_pos, jm.pos_idx, jm.vtx_uv, jm.uv_idx, p, 32,
                         enable_mip, 4)
        return jnp.mean((img - ref) ** 2)

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(tex))
    loss = m.loss(mtx)
    (g,) = torch.autograd.grad(loss, [m.params])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    r = np.asarray(ref_g).reshape(-1, 3)
    err = np.abs(g.numpy().reshape(r.shape) - r)
    assert np.abs(r).max() > 0
    assert err.max() <= GRAD_RTOL * np.abs(r).max()
    bad = err > ROW_RTOL * np.abs(r).max(1, keepdims=True)
    assert not bad.any(), np.nonzero(bad.any(1))[0][:10]


def test_earth_fit_psnr():
    m = EarthFitModel(res=32, ref_res=64, tex_res=(32, 64), max_mip_level=4, seed=0,
                      device="cpu")
    p0 = m.texture_psnr()
    for _ in range(50):
        m.step()
    p = m.texture_psnr()
    assert p > 10.0, f"earth texture PSNR {p:.2f} dB (bar 10.0, from {p0:.2f})"
