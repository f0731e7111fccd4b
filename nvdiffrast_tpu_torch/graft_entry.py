"""Entry points: the flagship forward step and the multi-rank dry run.

Counterparts of the repository's ``__graft_entry__.entry`` and
``dryrun_multichip``. Both run on the card unless the caller asks for the
CPU (``device="cpu"``, ``device_type="cpu"``).
"""

import json
import os
import tempfile

import numpy as np
import torch

H_DRY, W_DRY = 16, 16  # the dry run's image (tiny shapes, as the JAX one)
SP_ROWS = 8            # rows a rank holds in the dry run's row bands
RANK_TIMEOUT_S = 600   # a collective waiting longer fails the dry run


def entry(device="cuda"):
    """Forward step of the flagship pipeline: rasterize -> interpolate
    (with uv derivatives) -> texture (trilinear mipmaps) -> antialias on a
    textured uv-sphere at 256^2 (the earth workload plus antialiasing).

    Returns (fn, example_args): fn(*example_args) renders the antialiased
    textured image [1, 256, 256, 3] on the device of the arguments.
    """
    from .models import primitives
    from .ops.antialias import antialias
    from .ops.interpolate import interpolate
    from .ops.rasterize import rasterize
    from .ops.texture import texture
    from .utils import camera

    dev = torch.device(device)
    pos_idx, vtxp, uv_idx, vtxu = primitives.uv_sphere(16, 32)
    tex = primitives.checkerboard_texture(64, 128)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    tri = torch.as_tensor(pos_idx, device=dev)
    uvi = torch.as_tensor(uv_idx, device=dev)

    def fn(pos_clip, uv, tex):
        rast, rast_db = rasterize(None, pos_clip, tri, (256, 256))
        texc, texd = interpolate(uv[None], rast, uvi, rast_db=rast_db, diff_attrs="all")
        color = texture(tex[None], texc, texd, filter_mode="linear-mipmap-linear",
                        max_mip_level=6)
        color = color * torch.clamp(rast[..., -1:], 0, 1)
        return antialias(color, rast, pos_clip, tri)

    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos_clip = (posw @ mvp.T)[None].astype(np.float32)
    example_args = tuple(torch.as_tensor(x, device=dev) for x in (pos_clip, vtxu, tex))
    return fn, example_args


def dryrun_multichip(n_devices, device_type="cuda"):
    """Start `n_devices` ranks and run, in each, one step of each
    multi-rank path at tiny shapes:

    * the textured data-parallel training step (``shard_map_train_step``,
      Adam, one view a rank, the texture as the parameter);
    * the row-band textured training step (one image split into
      ``SP_ROWS``-row bands, ``antialias_sp``, the texture's gradient
      summed over the bands);
    * the row-band forward, each band held against the same rows of a
      single-process render (within 1e-4).

    Ranks rendezvous through a file in a temporary directory. On "cuda"
    the kernels are built here first, then the ranks load them; the
    backend is nccl where torch sees a card for every rank, else gloo
    (ranks sharing a card; NCCL refuses that). Raises if a rank fails: a
    non-finite loss, a mismatch, or an error. Returns each rank's results
    (losses, the forward's largest error and, on "cuda", its kernels'
    launch counts), in rank order.
    """
    import torch.multiprocessing as mp

    n = int(n_devices)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device_type 'cuda' but torch sees no "
                               "CUDA device; pass device_type='cpu' to run on the CPU")
        from . import _build

        _build.library()
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, args=(n, tmp, device_type, backend), nprocs=n, join=True)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def _dryrun_rank(rank, n, tmp, device_type, backend):
    import torch.distributed as dist

    from . import _build
    from .parallel import multihost

    if device_type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    multihost.initialize(init_method="file://" + os.path.join(tmp, "store"), world_size=n,
                         rank=rank, backend=backend, device_type=device_type,
                         timeout_s=RANK_TIMEOUT_S)
    try:
        _build.reset_launches()
        out = _dryrun_steps(rank, n, device_type)
        out["launches"] = _build.launch_counts()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _dryrun_steps(rank, n, device_type):
    from .models import primitives
    from .ops.antialias import antialias, antialias_construct_topology_hash
    from .ops.interpolate import interpolate
    from .ops.rasterize import rasterize
    from .ops.texture import texture
    from .parallel import antialias_sp, make_mesh, replicated, shard_map_train_step
    from .parallel.collectives import Axis, all_reduce_sum
    from .utils import camera

    dev = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    pos_idx, vtxp, uv_idx, vtxu = primitives.uv_sphere(6, 12)
    tri = torch.as_tensor(pos_idx, device=dev)
    uvi = torch.as_tensor(uv_idx, device=dev)
    uv = torch.as_tensor(vtxu, device=dev)
    tex0 = torch.as_tensor(primitives.checkerboard_texture(8, 16), device=dev)
    rng = np.random.RandomState(0)
    mv = camera.translate(0, 0, -3.5) @ camera.random_rotation_translation(0.25, rng)
    mvp = camera.projection(x=0.4) @ mv
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos_one = torch.as_tensor((posw @ mvp.T)[None].astype(np.float32), device=dev)
    topo = antialias_construct_topology_hash(tri)

    def shade(tex, pos_clip, size, viewport=None, aa=None):
        rast, rast_db = rasterize(None, pos_clip, tri, size, viewport=viewport)
        texc, texd = interpolate(uv[None], rast, uvi, rast_db=rast_db, diff_attrs="all")
        color = texture(tex[None], texc, texd, filter_mode="linear-mipmap-linear")
        color = color * torch.clamp(rast[..., -1:], 0, 1)
        if aa is None:
            return antialias(color, rast, pos_clip, tri, topology_hash=topo)
        return aa(color, rast)

    # Data parallel: one view a rank (the same view on each), grads
    # averaged over dp.
    dp_mesh = make_mesh((n,), ("dp",), device_type)
    tex = tex0.clone().requires_grad_()
    opt = torch.optim.Adam([tex], lr=1e-2)
    step = shard_map_train_step(
        lambda pos_clip: torch.mean(shade(tex, pos_clip, (H_DRY, W_DRY)) ** 2), opt, dp_mesh)
    dp_loss = float(step(pos_one))
    if not np.isfinite(dp_loss):
        raise AssertionError("multichip dry run: data-parallel step's loss is not finite")

    # Row bands: one image of SP_ROWS rows a rank, the texture's gradient
    # summed over the bands.
    sp_mesh = make_mesh((n,), ("sp",), device_type)
    sp = Axis(sp_mesh, "sp")
    Hsp = SP_ROWS * n
    vp = (sp.index * SP_ROWS, Hsp)
    tex3 = tex0.clone().requires_grad_()
    opt3 = torch.optim.Adam([tex3], lr=1e-2)
    band = shade(replicated(sp_mesh, "sp", tex3)[0], pos_one, (SP_ROWS, W_DRY), vp,
                 aa=lambda c, r: antialias_sp(c, r, pos_one, tri, sp_mesh, Hsp,
                                              topology_hash=topo))
    band_loss = torch.sum(band ** 2) / (Hsp * W_DRY)
    opt3.zero_grad()
    band_loss.backward()
    opt3.step()
    sp_loss = float(all_reduce_sum([band_loss.detach().reshape(1)], sp.group)[0])
    if not np.isfinite(sp_loss):
        raise AssertionError("multichip dry run: row-band step's loss is not finite")

    # The row-band forward against the same rows of a single-process render.
    with torch.no_grad():
        rast, _ = rasterize(None, pos_one, tri, (SP_ROWS, W_DRY), grad_db=False, viewport=vp)
        img, _ = interpolate(uv[None], rast, uvi)
        out_sp = antialias_sp(img, rast, pos_one, tri, sp_mesh, Hsp, topology_hash=topo)
        rast_f, _ = rasterize(None, pos_one, tri, (Hsp, W_DRY), grad_db=False)
        img_f, _ = interpolate(uv[None], rast_f, uvi)
        out_f = antialias(img_f, rast_f, pos_one, tri, topology_hash=topo)
    err = float((out_sp - out_f[:, vp[0]:vp[0] + SP_ROWS]).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"multichip dry run: row band {sp.index} differs from the "
                             f"single-process render by {err}")
    return {"rank": rank, "dp_loss": dp_loss, "sp_loss": sp_loss, "sp_err": err}
