"""Port parity: interpolate forward twin (attribute table, masking, bary
combine, attribute derivatives) vs the JAX package's flat interpolate
(interpolate._interp_flat_fwd: the masking glue + interpolate_pallas
interp_forward_fused in interpret mode).

Bar: atol 1e-6 / rtol 1e-5 on identical inputs (the same expressions;
XLA:CPU may contract a product and a sum into fma).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import interpolate as jint
from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
from nvdiffrast_tpu_torch.ops import pipeline as tpl
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (24, 40)


@functools.lru_cache(maxsize=None)
def _raster(B):
    """Flat (u, v, idf, dudx, dudy, dvdx, dvdy) of the port's rasterizer on
    a sphere scene, plus a few out-of-range ids, as numpy arrays."""
    pos, tri, _, _ = sphere_scene(B=B, seed=7)
    p, t = inputs_from_numpy(pos, tri)
    outs = [o.reshape(-1).numpy().copy()
            for o in rc.rasterize_fused(p, t, RES, emit_db=True)]
    u, v, _, idf, *db = outs
    idf[:3] = [tri.shape[0] + 1, tri.shape[0] + 5, 0.0]  # invalid ids
    return tri, (u, v, idf, *db)


CASES = [  # (B, A, diff_list)
    (1, 2, (0, 1)),   # the textured pipeline: uv, both differentiated
    (2, 2, (0, 1)),
    (2, 5, (3, 1)),   # a subset, out of order
    (1, 3, ()),       # no derivatives
    (2, 16, tuple(range(16))),
]


@pytest.mark.parametrize("B,A,diff_list", CASES)
def test_interp_forward_twin_matches_jax(B, A, diff_list):
    tri, (u, v, idf, *db) = _raster(B)
    attr = np.random.default_rng(A).standard_normal((int(tri.max()) + 1, A)).astype(np.float32)
    D = len(diff_list)
    ref_out, ref_da = jint._interp_flat_fwd(
        jnp.asarray(attr), jnp.asarray(u), jnp.asarray(v), jnp.asarray(idf),
        jnp.asarray(tri), jnp.asarray(np.stack(db[:2])), jnp.asarray(np.stack(db[2:])),
        diff_list, "pallas_interpret")[0]
    a, t, *flats = inputs_from_numpy(attr, tri, u, v, idf, *db)
    tbl = tpl._attr_table(a, t, 1, tri.shape[0])
    assert tbl.shape == (3 * A, tri.shape[0] + 1)
    out, da = ic.interp_forward(tbl, *flats[:3], tuple(flats[3:]) if D else None,
                                diff_list)
    assert out.shape == (A, u.shape[0]) and da.shape == (2 * D, u.shape[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(da.numpy(), np.asarray(ref_da), atol=1e-6, rtol=1e-5)
    assert (out.numpy()[:, :3] == 0).all()  # invalid ids interpolate to zero
    if D:
        assert np.abs(ref_da).max() > 0


def test_interp_device_dispatch_and_checks():
    tri, (u, v, idf, *db) = _raster(1)
    attr = np.zeros((int(tri.max()) + 1, 2), np.float32)
    a, t, *flats = inputs_from_numpy(attr, tri, u, v, idf, *db)
    tbl = tpl._attr_table(a, t, 1, tri.shape[0])
    before = ic.KERNEL.launches
    got = ic.interp_forward(tbl, *flats[:3], tuple(flats[3:]), (0, 1))
    ref = ic.interp_forward_plain(tbl, *flats[:3], tuple(flats[3:]), (0, 1))
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert ic.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ic.interp_forward(tbl.to("meta"), *(f.to("meta") for f in flats[:3]), None, ())
    with pytest.raises(ValueError):  # derivatives without db
        ic.interp_forward(tbl, *flats[:3], None, (0,))
    with pytest.raises(ValueError):  # attribute index out of range
        ic.interp_forward(tbl, *flats[:3], tuple(flats[3:]), (2,))
    with pytest.raises(ValueError):  # 17 attributes
        ic.interp_forward(torch.zeros((51, tbl.shape[1])), *flats[:3], None, ())
