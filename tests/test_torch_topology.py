"""Port parity: opposite-vertex table (torch vs JAX, bitwise)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
from nvdiffrast_tpu_torch.ops.antialias import (
    TopologyHashWrapper, antialias_construct_topology_hash)
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table as tbuild

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)


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
