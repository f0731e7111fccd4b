"""Device meshes over torch.distributed ranks.

Counterpart of ``nvdiffrast_tpu/parallel/mesh.py``. In torch a mesh is
of ranks, one device a rank (``DeviceMesh``); each named axis has its
own process group. Every rank of the job must build the same meshes in
the same order: building one is a collective.
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world_size():
    if not dist.is_initialized():
        raise RuntimeError("parallel: no torch.distributed process group; call "
                           "parallel.multihost.initialize() (or init_process_group) first")
    return dist.get_world_size()


def make_mesh(shape=None, axis_names=("dp", "sp"), device_type="cuda"):
    """A mesh over every rank of the job.

    Args:
      shape: tuple matching axis_names; None = all ranks on the first
        axis.
      axis_names: mesh axis names; by convention "dp" = data parallel
        (minibatch), "sp" = spatial (image rows).
      device_type: "cuda" or "cpu", the device of each rank.

    Returns a ``DeviceMesh``; rank r sits at the r-th entry of the shape
    in row-major order. Raises ValueError when the shape does not hold
    the world size.
    """
    n = _world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def mesh_of(grid, axis_names, device_type="cuda"):
    """A mesh of the ranks laid out as the integer tensor `grid` (a
    subset of the ranks, or a transposed layout)."""
    _world_size()
    return DeviceMesh(device_type, torch.as_tensor(grid, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def default_mesh(n_devices=None, device_type="cuda"):
    """A (dp, sp) mesh over the first `n_devices` ranks (default: all):
    batch-major, with sp = 4, else 2, where the count divides and exceeds
    it, else 1."""
    world = _world_size()
    n = world if n_devices is None else int(n_devices)
    sp = 1
    for cand in (4, 2):
        if n % cand == 0 and n > cand:
            sp = cand
            break
    if n == world:
        return make_mesh((n // sp, sp), ("dp", "sp"), device_type)
    if not 0 < n < world:
        raise ValueError(f"default_mesh: {n} devices of {world} ranks")
    return mesh_of(torch.arange(n).reshape(n // sp, sp), ("dp", "sp"), device_type)
