"""Port parity: tri-id codec and pixel transform (torch vs JAX, bitwise)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import coord as jcoord
from nvdiffrast_tpu_torch.ops import coord as tcoord

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

_SPECIAL = [0, 1, 2, 1000, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
            (1 << 24) + 7, 123456789, jcoord.MAX_TRIANGLE_ID]


def _ids(seed):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([
        np.asarray(_SPECIAL, np.int64),
        rng.integers(0, 1 << 24, 500),
        rng.integers(1 << 24, jcoord.MAX_TRIANGLE_ID + 1, 500)])
    return ids.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_triidx_to_float_bitwise(seed):
    ids = _ids(seed)
    ref = np.asarray(jcoord.triidx_to_float(jnp.asarray(ids)))
    out = tcoord.triidx_to_float(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_float_to_triidx_roundtrip(seed):
    ids = _ids(seed)
    enc = np.array(jcoord.triidx_to_float(jnp.asarray(ids)))
    ref = np.asarray(jcoord.float_to_triidx(jnp.asarray(enc)))
    out = tcoord.float_to_triidx(torch.from_numpy(enc)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, ids)
    assert tcoord.MAX_TRIANGLE_ID == jcoord.MAX_TRIANGLE_ID


@pytest.mark.parametrize("hw", [(1, 1), (48, 64), (67, 130), (2048, 2048)])
def test_pixel_scale_offset(hw):
    assert tcoord.pixel_scale_offset(*hw) == jcoord.pixel_scale_offset(*hw)


@pytest.mark.parametrize("height,width", [(1, 1), (7, 13), (2048, 2048)])
def test_pixel_centers_bitwise(height, width):
    fx, fy = tcoord.pixel_centers(height, width)
    jfx, jfy = jcoord.pixel_centers(height, width)
    assert fx.shape == (width,) and fy.shape == (height,) and fx.dtype == torch.float32
    np.testing.assert_array_equal(fx.numpy().view(np.int32), np.asarray(jfx).view(np.int32))
    np.testing.assert_array_equal(fy.numpy().view(np.int32), np.asarray(jfy).view(np.int32))
