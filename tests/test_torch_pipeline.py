"""Port parity: fused interpolate + antialias shade and the forward render
path (torch) vs the JAX package's Pallas kernels in interpret mode.

Bars: the shade_fwd twin within 1e-5 of pipeline_pallas.shade_fwd on
identical inputs; the whole forward within 1e-4 of
render_pipeline(impl="pallas_interpret") at pixels whose own and
neighbour ids agree (the rasterizers may pick other winners only at
z-fights, tests/test_parity_sweep.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import pipeline as jpl
from nvdiffrast_tpu.ops import pipeline_pallas as jpp
from nvdiffrast_tpu.ops import rasterize_pallas as jrp
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import antialias as taa
from nvdiffrast_tpu_torch.ops import pipeline as tpl
from nvdiffrast_tpu_torch.ops import pipeline_cuda as tpc
from nvdiffrast_tpu_torch.ops import rasterize_cuda as trc
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table as tbuild
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import assert_ids_match_mod_zfights, sphere_scene

RES = (48, 64)
IMPL = "pallas_interpret"


def _jax_raster(pos, tri):
    B, T = pos.shape[0], tri.shape[0]
    ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
    outs = jrp.rasterize_fused(jnp.asarray(pos), jnp.asarray(tri), RES, ranges,
                               interpret=True, flat=True, emit_db=False)
    return [np.asarray(o) for o in outs[:4]]


@functools.lru_cache(maxsize=None)
def _scene_and_raster(B, seed):
    """A sphere scene and its JAX raster buffers, shared by the fixtures."""
    scene = sphere_scene(B=B, seed=seed)
    return scene, _jax_raster(*scene[:2])


@pytest.fixture(scope="module")
def shade_case():
    """B=2 sphere: JAX raster buffers, tables and shade_fwd outputs."""
    (pos, tri, attr, cidx), raster = _scene_and_raster(2, 2)
    B, T = pos.shape[0], tri.shape[0]
    H, W = RES
    N = B * H * W
    u, v, zw, idf = (x.reshape(N) for x in raster)
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    atbl, _ = jpl._attr_table(jnp.asarray(attr), jnp.asarray(cidx), True, B, T)
    ftable, _, _, _ = jaa._build_tables(jpos, jtri, jbuild(jtri), True, H, W)
    fx, fy, rofs, bx, by = jaa._pixel_grid(B, H, W, T, True)
    out, c0, res = jpp.shade_fwd(atbl, ftable, *(jnp.asarray(x) for x in (u, v, zw, idf)),
                                 fx, fy, rofs, bx, by, attr.shape[-1], T, W,
                                 interpret=True)
    return {"scene": (pos, tri, attr, cidx), "flat": (u, v, zw, idf),
            "atbl": np.asarray(atbl), "ftable": np.asarray(ftable),
            "ref": [np.asarray(out), np.asarray(c0)] + [np.asarray(r) for r in res]}


def test_shade_fwd_twin_matches_jax(shade_case):
    T = shade_case["scene"][1].shape[0]
    atbl, ftable, *flat = inputs_from_numpy(shade_case["atbl"], shade_case["ftable"],
                                            *shade_case["flat"])
    out, c0, (al0, ax0, al1, ax1) = tpc.shade_fwd(atbl, ftable, *flat, RES, T)
    r_out, r_c0, r_al0, r_ax0, r_al1, r_ax1 = shade_case["ref"]
    np.testing.assert_allclose(out.numpy(), r_out, atol=1e-5)
    np.testing.assert_allclose(c0.numpy(), r_c0, atol=1e-5)
    for al, ax, r_al, r_ax in ((al0, ax0, r_al0, r_ax0), (al1, ax1, r_al1, r_ax1)):
        np.testing.assert_allclose(al.numpy(), r_al, atol=1e-5)
        # The edge/side residual is consumed only where alpha != 0.
        live = r_al != 0
        np.testing.assert_array_equal(ax.numpy()[live], r_ax[live])
    assert (r_al0 != 0).sum() + (r_al1 != 0).sum() > 20, "too few AA pairs"


def test_tables_match_jax(shade_case):
    pos, tri, attr, cidx = shade_case["scene"]
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    B = pos.shape[0]
    atbl = tpl._attr_table(a, c, B, t.shape[0])
    np.testing.assert_array_equal(atbl.numpy(), shade_case["atbl"])
    ftable, btable, R, T = taa._build_tables(p, t, tbuild(t), *RES)
    assert (R, T) == (B * tri.shape[0], tri.shape[0])
    ref = shade_case["ftable"]
    np.testing.assert_allclose(ftable.numpy()[:6], ref[:6], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(ftable.numpy()[6], ref[6])  # silhouette bits


def test_shade_cols_device_dispatch(shade_case):
    T = shade_case["scene"][1].shape[0]
    args = inputs_from_numpy(shade_case["atbl"], shade_case["ftable"], *shade_case["flat"])
    before = tpc.KERNEL.launches
    got = tpc.shade_cols(*args, RES, T)
    ref = tpc.shade_cols_plain(*args, RES, T)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert tpc.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tpc.shade_cols(*(x.to("meta") for x in args), RES, T)
    with pytest.raises(ValueError):
        tpc.shade_cols(*args, (RES[0], RES[1] + 1), T)


def _neighbour_agree(id_ref, id_got):
    """Pixels whose own id and all four neighbours' ids agree."""
    same = id_ref == id_got
    pad = np.pad(same, ((0, 0), (1, 1), (1, 1)), constant_values=True)
    return (same & pad[:, :-2, 1:-1] & pad[:, 2:, 1:-1]
            & pad[:, 1:-1, :-2] & pad[:, 1:-1, 2:])


@pytest.fixture(scope="module", params=[1, 2])
def render_case(request):
    B = request.param
    (pos, tri, attr, cidx), raster = _scene_and_raster(B, B)
    ref = jpl.render_pipeline(jnp.asarray(pos), jnp.asarray(tri), jnp.asarray(attr),
                              RES, attr_idx=jnp.asarray(cidx), impl=IMPL)
    return {"scene": (pos, tri, attr, cidx), "ref": np.asarray(ref),
            "raster": raster}


def test_render_pipeline_matches_jax(render_case):
    pos, tri, attr, cidx = render_case["scene"]
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    out = dr.render_pipeline(p, t, a, RES, attr_idx=c)
    assert out.shape == (pos.shape[0],) + RES + (attr.shape[-1],)
    _, _, zw, ids = (x.numpy() for x in trc.rasterize_fused(p, t, RES))
    _, _, ref_zw, ref_ids = render_case["raster"]
    assert_ids_match_mod_zfights(ref_ids, ids, ref_zw, zw)
    agree = _neighbour_agree(ref_ids, ids)
    ref = render_case["ref"]
    np.testing.assert_allclose(out.numpy()[agree], ref[agree], atol=1e-4)
    assert np.abs(ref).sum() > 0


def test_render_pipeline_topology_and_broadcast(render_case):
    """JAX op_table via TopologyHashWrapper, broadcast [V, A] attributes
    and attr_idx=None all give the same image."""
    pos, tri, attr, cidx = render_case["scene"]
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    base = dr.render_pipeline(p, t, a, RES, attr_idx=c)
    topo = dr.TopologyHashWrapper(np.asarray(jbuild(jnp.asarray(tri))))
    assert torch.equal(dr.render_pipeline(p, t, a, RES, attr_idx=c,
                                          topology_hash=topo), base)
    a1 = a[:1]
    tiled = dr.render_pipeline(p, t, a1.expand(p.shape[0], -1, -1).contiguous(),
                               RES, attr_idx=c)
    assert torch.equal(dr.render_pipeline(p, t, a1, RES, attr_idx=c), tiled)
    assert torch.equal(dr.render_pipeline(p, t, a1[0], RES, attr_idx=c), tiled)
    # uv_sphere's attribute topology is its position topology.
    assert np.array_equal(cidx, tri)
    assert torch.equal(dr.render_pipeline(p, t, a[..., :2], RES),
                       dr.render_pipeline(p, t, a[..., :2], RES, attr_idx=c))


def test_render_pipeline_argument_checks():
    pos, tri, attr, cidx = sphere_scene(B=2, seed=4, A=9)
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    with pytest.raises(NotImplementedError):
        dr.render_pipeline(p, t, a, RES, attr_idx=c)  # 9 channels
    with pytest.raises(ValueError):
        dr.render_pipeline(p, t, a[..., :3], RES, attr_idx=c[:-1])
    with pytest.raises(ValueError):
        dr.render_pipeline(p, t, torch.cat([a, a])[..., :3], RES, attr_idx=c)
