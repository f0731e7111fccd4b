"""Multi-process and multi-host start on torch.distributed.

Counterpart of ``nvdiffrast_tpu/parallel/multihost.py``. One process a
rank and one device a rank; ``torchrun`` (or any launcher that sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``) starts them:

    torchrun --nnodes 2 --nproc-per-node 8 ... train.py

    from nvdiffrast_tpu_torch.parallel import multihost, shard_map_train_step
    multihost.initialize()                    # env-driven
    mesh = multihost.pod_mesh(dp_over_hosts=True)
    step = shard_map_train_step(loss, opt, mesh)

Every op of the package runs on one rank's own device as it does alone;
only the dp gradient sums and the sp one-row AA halos cross ranks
(``collectives``). The dp sums are O(params) a step; the halo is
latency-bound, so ``pod_mesh`` keeps sp inside a host (hosts on the
slowest-varying axis).
"""

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import make_mesh, mesh_of


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device_type="cuda", timeout_s=None):
    """Start the default process group (idempotent).

    A no-op where it already runs, and in a single-process environment:
    no argument given and neither ``MASTER_ADDR`` nor a ``WORLD_SIZE``
    above 1 in the environment. Otherwise it starts the group with
    ``init_method`` (default ``env://``: torchrun's variables), and raises
    if that fails: a silent single-process fallback in a multi-process job
    would be N independent jobs.

    backend: default "nccl" for device_type "cuda", "gloo" for "cpu".
    On "cuda" the rank's device is set first: ``LOCAL_RANK`` (else the
    rank) modulo the visible device count.
    """
    if dist.is_initialized():
        return
    env = os.environ
    configured = (init_method is not None or world_size is not None or rank is not None
                  or "MASTER_ADDR" in env or int(env.get("WORLD_SIZE", "1")) > 1)
    if not configured:
        return
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: device_type 'cuda' but torch sees "
                               "no CUDA device; pass device_type='cpu' to run on the CPU")
        local = int(env.get("LOCAL_RANK", rank if rank is not None else env.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=None if timeout_s is None else datetime.timedelta(seconds=timeout_s))


def pod_mesh(axis_names=("dp", "sp"), dp_over_hosts=True, device_type="cuda"):
    """Global mesh of hosts x local ranks (``LOCAL_WORLD_SIZE`` ranks a
    host; one host where it is unset).

    dp_over_hosts=True: axis 0 ("dp") runs over hosts, axis 1 ("sp") over
    the ranks of a host, so the dp gradient sums cross hosts once a step
    and the latency-bound sp halos stay inside a host. False: the names
    reversed over the transposed grid, as the JAX package builds it.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host < 1 or n % per_host:
        raise ValueError(f"pod_mesh: {n} ranks in hosts of LOCAL_WORLD_SIZE={per_host}")
    shape = (n // per_host, per_host)
    if dp_over_hosts:
        return make_mesh(shape, axis_names, device_type)
    return mesh_of(torch.arange(n).reshape(shape).T, tuple(reversed(axis_names)),
                   device_type)


def local_batch_slice(global_batch, mesh, dp_axis="dp"):
    """(start, size) of this rank's shard of a dp-sharded global batch,
    from its coordinate on the dp axis; (0, 0) for a rank outside the
    mesh."""
    n_dp = mesh.size(mesh.mesh_dim_names.index(dp_axis))
    per = int(global_batch) // n_dp
    coord = mesh.get_coordinate()
    if coord is None:
        return 0, 0
    return coord[mesh.mesh_dim_names.index(dp_axis)] * per, per
