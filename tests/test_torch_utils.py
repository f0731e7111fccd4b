"""Port parity: numpy scene helpers, input conversion, log level and the
image and quaternion helpers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.models import primitives as jprim
from nvdiffrast_tpu.utils import camera as jcam
from nvdiffrast_tpu.utils import image as jimg
from nvdiffrast_tpu.utils import log as jlog
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.models import primitives as tprim
from nvdiffrast_tpu_torch.utils import camera as tcam
from nvdiffrast_tpu_torch.utils import image as timg
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)


@pytest.mark.parametrize("lat_lon", [(8, 12), (32, 64)])
def test_uv_sphere_identical(lat_lon):
    for a, b in zip(tprim.uv_sphere(*lat_lon), jprim.uv_sphere(*lat_lon)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_camera_matrices_identical():
    np.testing.assert_array_equal(tcam.projection(x=0.4), jcam.projection(x=0.4))
    np.testing.assert_array_equal(tcam.translate(0.1, -0.2, -3.5),
                                  jcam.translate(0.1, -0.2, -3.5))
    for seed in range(3):
        a = tcam.random_rotation_translation(0.2, np.random.default_rng(seed))
        b = jcam.random_rotation_translation(0.2, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        r = a[:3, :3].astype(np.float64)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)


def test_inputs_from_numpy():
    pos = jnp.ones((1, 3, 4), jnp.float32)  # a JAX array is read-only
    tri = np.array([[0, 1, 2]], np.int64)
    p, t, none, a = inputs_from_numpy(pos, tri, None, np.zeros((3, 2)))
    assert p.dtype == torch.float32 and p.shape == (1, 3, 4)
    assert t.dtype == torch.int32 and t.tolist() == [[0, 1, 2]]
    assert none is None and a.dtype == torch.float32
    assert p.device.type == "cpu"
    with pytest.raises(TypeError):
        inputs_from_numpy(np.array(["x"]))


def test_log_level_convention():
    assert dr.get_log_level() == jlog.get_log_level() == 1
    try:
        dr.set_log_level(0)
        assert dr.get_log_level() == 0
        with pytest.raises(ValueError):
            dr.set_log_level(4)
    finally:
        dr.set_log_level(1)


def test_inputs_from_numpy_carries_texture_and_uvs_exactly():
    """The bench textured scene's inputs: a [1, 512, 512, 3] texture and
    [V, 2] spherical uvs reach the port bit for bit."""
    tex = np.random.RandomState(0).rand(1, 512, 512, 3).astype(np.float32)
    _, vtxp, _, _ = tprim.uv_sphere(32, 64)
    uv = np.stack([np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi], axis=1)
    t, u = inputs_from_numpy(jnp.asarray(tex), uv)  # a JAX array and float64
    assert t.shape == (1, 512, 512, 3) and t.dtype == torch.float32
    assert u.shape == (vtxp.shape[0], 2) and u.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy().view(np.int32), tex.view(np.int32))
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  uv.astype(np.float32).view(np.int32))
    assert t.is_contiguous() and u.is_contiguous()


def test_q_scale_small_takes_rng_as_the_reference():
    q = jcam.q_rnd(np.random.default_rng(3))
    for scale in (0.0, 0.25, 1.0):
        ref = jcam.q_scale_small(q, scale, rng=np.random.default_rng(0))
        got = tcam.q_scale_small(q, scale, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tcam.q_scale_small(q, scale), ref)


def _test_image():
    """A 5x7x3 image with values below 0, above 1 and on the rounding
    boundaries, so clipping and rounding both show."""
    x = np.random.default_rng(4).uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    x[0, :4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0
    return x


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_image_writes_the_reference_bytes(tmp_path, as_tensor):
    from PIL import Image

    x = _test_image()
    jimg.save_image(tmp_path / "ref.png", x)
    arg = torch.from_numpy(x).requires_grad_() if as_tensor else x
    timg.save_image(tmp_path / "got.png", arg)
    ref = np.asarray(Image.open(tmp_path / "ref.png"))
    got = np.asarray(Image.open(tmp_path / "got.png"))
    assert got.dtype == np.uint8 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, ref)


def test_display_image_returns_a_bool_without_a_display(monkeypatch):
    from PIL import Image, ImageShow

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(ImageShow, "_viewers", [])  # no viewer to start
    x = _test_image()
    for arg in (x, torch.from_numpy(x)):
        got = timg.display_image(arg, title="t")
        assert isinstance(got, bool) and got == jimg.display_image(x, title="t")

    def refuse(*args, **kwargs):
        raise OSError("no display")

    monkeypatch.setattr(Image.Image, "show", refuse)
    assert timg.display_image(x) is False and jimg.display_image(x) is False
