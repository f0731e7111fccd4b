"""The port's mesh-derived tables (``nvdiffrast_tpu_torch.ops.topology``):
the opposite-vertex table bit for bit with JAX's, the wrapper at every
entry that takes one, the index range check, and the clip-space (x, y,
w) vertex table and its reverse against the list-index expressions they
replace."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops.antialias import (
    TopologyHashWrapper, antialias_construct_topology_hash)
from nvdiffrast_tpu_torch.ops.topology import (_build_tables, _corner_table, _vertex_sum,
                                               vertex_pos_grad, vertex_table)
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table as tbuild

from _torch_parity import random_scene, sphere_scene, textured_scene


def _random_mesh(seed, V=40, T=120):
    """Random triangles plus duplicate, degenerate and non-manifold ones."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, V, (T, 3)).astype(np.int32)
    tri[0] = [3, 3, 7]            # repeated vertex
    tri[1] = [5, 5, 5]            # fully degenerate
    tri[2] = tri[10]              # duplicate triangle
    tri[3] = tri[11][::-1]        # duplicate, opposite winding
    tri[4:8] = [[0, 1, 2], [1, 0, 9], [0, 1, 12], [1, 0, 15]]  # 4 on one edge
    return tri


def _check(tri, num_vertices=None):
    ref = np.asarray(jbuild(jnp.asarray(tri), num_vertices))
    out = tbuild(torch.from_numpy(tri), num_vertices)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    return ref


@pytest.mark.parametrize("lat_lon", [(8, 12), (32, 64)])
def test_opposite_table_sphere(lat_lon):
    tri = primitives.uv_sphere(*lat_lon)[0]
    ref = _check(tri)
    assert (ref >= 0).mean() > 0.8  # closed apart from the uv seam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_opposite_table_random(seed):
    _check(_random_mesh(seed))


def test_opposite_table_num_vertices():
    tri = _random_mesh(3)
    tri[20] = [0, 1, 45]  # index beyond num_vertices
    _check(tri, num_vertices=40)


def test_topology_wrapper_accepts_jax_table():
    tri = primitives.uv_sphere(8, 12)[0]
    ref = np.asarray(jbuild(jnp.asarray(tri)))
    wrapped = TopologyHashWrapper(ref)
    assert wrapped.op_table.dtype == torch.int32
    np.testing.assert_array_equal(wrapped.op_table.numpy(), ref)
    built = antialias_construct_topology_hash(torch.from_numpy(tri))
    assert torch.equal(built.op_table, wrapped.op_table)


def _entry_call(entry):
    """call(topology_hash) rendering one small scene through `entry`."""
    res = (16, 20)
    if entry == "render_pipeline_textured":
        pos, tri, uv, tex = (torch.as_tensor(x) for x in textured_scene(seed=1, B=1))
        return tri, lambda h: dr.render_pipeline_textured(pos, tri, uv, tex, res,
                                                          topology_hash=h)
    pos, tri, attr, aidx = (torch.as_tensor(x) for x in sphere_scene(B=1, seed=2))
    if entry == "render_pipeline":
        return tri, lambda h: dr.render_pipeline(pos, tri, attr, res, attr_idx=aidx,
                                                 topology_hash=h)
    rast, _ = dr.rasterize(None, pos, tri, res)
    color, _ = dr.interpolate(attr, rast, aidx)
    return tri, lambda h: dr.antialias(color, rast, pos, tri, topology_hash=h)


@pytest.mark.parametrize("entry", ["render_pipeline", "render_pipeline_textured", "antialias"])
def test_entries_take_the_wrapper_or_build_the_table(entry):
    tri, call = _entry_call(entry)
    with pytest.raises(TypeError, match=f"{entry}: topology_hash"):
        call(tbuild(tri))  # the bare table is not a wrapper
    built = call(None)
    assert built.abs().sum() > 0
    assert torch.equal(call(antialias_construct_topology_hash(tri)).view(torch.int32),
                       built.view(torch.int32))


@pytest.mark.parametrize("case", ["out_of_range", "tri_twice"])
def test_uv_tri_range_check(case):
    pos, tri, uv, tex = (torch.as_tensor(x) for x in textured_scene(seed=2, B=1))
    V = pos.shape[1]
    if case == "out_of_range":
        with pytest.raises(ValueError, match="render_pipeline_textured: uv_tri indices out of"):
            dr.render_pipeline_textured(pos, tri, uv[:int(tri.max())], tex, (8, 8))
        return
    # uv_tri is tri, checked against the positions' and then the uvs'
    # vertex count: both pass, and a smaller uv count still raises.
    uv2 = torch.cat([uv, uv[:7]])
    for u in (uv2, uv, uv2):
        img = dr.render_pipeline_textured(pos, tri, u[:V], tex, (8, 8))
        assert torch.equal(img, dr.render_pipeline_textured(pos, tri, u[:V], tex, (8, 8),
                                                            uv_tri=tri.clone()))
        dr.render_pipeline_textured(pos, tri, u, tex, (8, 8), uv_tri=tri)
    with pytest.raises(ValueError, match="uv_tri indices out of range"):
        dr.render_pipeline_textured(pos, tri, uv[:int(tri.max())], tex, (8, 8), uv_tri=tri)


@pytest.mark.parametrize("ranged", [False, True])
def test_vertex_tables_equal_the_list_index(ranged):
    """The (x, y, w) tables and g_pos's (x, y, w) -> [.., 4] bit for bit
    with the Python list index they replaced (kept here as the
    reference)."""
    pos, tri = (torch.as_tensor(x) for x in random_scene(4, B=2))
    if ranged:
        pos = pos[0]
    ref = pos[..., tri.long(), :][..., [0, 1, 3]].reshape(-1, 9).T
    ref = torch.cat([ref, ref.new_zeros((9, 1))], dim=1).view(torch.int32)
    assert torch.equal(vertex_table(pos, tri).view(torch.int32), ref)
    btable = _build_tables(pos, tri, tbuild(tri), 24, 32)[1]
    assert torch.equal(btable.view(torch.int32), ref)

    B, V = (1,) + tuple(pos.shape[:1]) if ranged else tuple(pos.shape[:2])
    rows = torch.randn((B * tri.shape[0], 9), generator=torch.Generator().manual_seed(5))
    ref = torch.zeros((B, V, 4))
    ref[..., [0, 1, 3]] = _vertex_sum(rows.reshape(B, -1, 3), _corner_table(tri, V))
    got = vertex_pos_grad(rows, tri, tuple(pos.shape))
    assert torch.equal(got.view(torch.int32), ref.reshape(pos.shape).view(torch.int32))
