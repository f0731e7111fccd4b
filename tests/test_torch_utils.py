"""Port parity: numpy scene helpers, input conversion and log level."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.models import primitives as jprim
from nvdiffrast_tpu.utils import camera as jcam
from nvdiffrast_tpu.utils import log as jlog
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.models import primitives as tprim
from nvdiffrast_tpu_torch.utils import camera as tcam
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy


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
