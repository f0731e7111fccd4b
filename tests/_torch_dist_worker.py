"""One rank of tests/test_torch_parallel.py's gloo job (CPU, no JAX).

Run as: python tests/_torch_dist_worker.py --rank R --world 4 --dir D
(with LOCAL_WORLD_SIZE=2: two "hosts" of two ranks). The ranks meet
through a file store in D and each writes D/rank{R}.json and
D/rank{R}.npz:

  * meshes: make_mesh((2, 2)) and its ValueError, default_mesh,
    pod_mesh both ways, local_batch_slice;
  * the row-band render (make_sp_render, 4 bands of 32x48, B = 2): this
    rank's band, its rast rows, and the gradients of
    sum((img - 0.3)**2) to pos and the colours (summed over the bands);
  * two SGD steps of shard_map_train_step over the (2, 2) mesh's dp axis
    (its batch slice of 4 views), the colours as the parameter.

``global_steps`` is the single-process step the tests hold it to.
"""

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SP_RES = (32, 48)   # the row-band image: 4 bands of 8 rows
SP_TARGET = 0.3     # loss sum((img - 0.3)**2), tests/test_spatial.py's
DP_RES = 16         # the dp step's images
DP_LR = 1e-2
DP_TARGET = 0.25    # loss mean((img - 0.25)**2), tests/_mh_worker.py's
DP_STEPS = 2


def sp_scene(B=2, seed=3):
    """tests/test_spatial.py _scene(B=2, seed=3): uv-sphere 8x12, B
    random views, vertex colours. Returns (pos, tri, col, col_idx)."""
    from nvdiffrast_tpu_torch.models import primitives
    from nvdiffrast_tpu_torch.utils import camera

    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4) @ camera.translate(0.1 * b, -0.05, -3.3)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    return np.stack(poss), pos_idx, (vtxp * 0.5 + 0.5).astype(np.float32), col_idx


def dp_scene():
    """tests/_mh_worker.py build_scene: uv-sphere 8x12, a global batch of
    4 slightly scaled views. Returns (pos_idx, col_idx, vtxc, batch)."""
    from nvdiffrast_tpu_torch.models import primitives
    from nvdiffrast_tpu_torch.utils import camera

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    vtxc = (vtxp * 0.5 + 0.5).astype(np.float32)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    base = (posw @ mvp.T).astype(np.float32)
    batch = np.stack([base * (1.0 + 1e-3 * i) for i in range(4)])
    return pos_idx, col_idx, vtxc, batch


def dp_loss_fn(col, tri, cidx, res=DP_RES):
    """batch -> mean((antialias(interpolate(col)) - 0.25)**2) (the JAX
    worker's loss)."""
    import nvdiffrast_tpu_torch as dr

    def loss(pos_clip):
        rast, _ = dr.rasterize(None, pos_clip, tri, (res, res), grad_db=False)
        img, _ = dr.interpolate(col[None], rast, cidx)
        img = dr.antialias(img, rast, pos_clip, tri)
        return torch.mean((img - DP_TARGET) ** 2)

    return loss


@functools.lru_cache(maxsize=None)
def global_steps(res=DP_RES):
    """The single-process global step: DP_STEPS SGD steps on the whole
    batch of dp_scene. Returns (colours, losses)."""
    pos_idx, col_idx, vtxc, batch = dp_scene()
    col = torch.from_numpy(vtxc.copy()).requires_grad_()
    opt = torch.optim.SGD([col], lr=DP_LR)
    loss_fn = dp_loss_fn(col, torch.from_numpy(pos_idx), torch.from_numpy(col_idx), res)
    losses = []
    for _ in range(DP_STEPS):
        opt.zero_grad()
        loss = loss_fn(torch.from_numpy(batch))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return col.detach().numpy(), losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch.parallel import (default_mesh, make_mesh, make_sp_render,
                                               multihost, shard_map_train_step)

    multihost.initialize(init_method="file://" + os.path.join(args.dir, "store"),
                         world_size=args.world, rank=args.rank, device_type="cpu",
                         timeout_s=120)
    res, arrays = {}, {}

    mesh = make_mesh((2, 2), device_type="cpu")
    res["mesh"] = {"names": list(mesh.mesh_dim_names), "ranks": mesh.mesh.tolist(),
                   "coord": list(mesh.get_coordinate())}
    try:
        make_mesh((3,), ("dp",), device_type="cpu")
    except ValueError as e:
        res["mesh_error"] = str(e)
    dm = default_mesh(device_type="cpu")
    res["default_mesh"] = {"names": list(dm.mesh_dim_names), "ranks": dm.mesh.tolist()}
    pods = {}
    for over in (True, False):
        pm = multihost.pod_mesh(dp_over_hosts=over, device_type="cpu")
        pods[str(over)] = {"names": list(pm.mesh_dim_names), "ranks": pm.mesh.tolist(),
                           "coord": list(pm.get_coordinate()),
                           "slice": list(multihost.local_batch_slice(8, pm))}
    res["pod_mesh"] = pods

    # Row bands over 4 ranks.
    pos, tri, col, cidx = sp_scene()
    sp_mesh = make_mesh((4,), ("sp",), device_type="cpu")
    render = make_sp_render(sp_mesh, tri, cidx, SP_RES)
    hb = SP_RES[0] // 4
    k = sp_mesh.get_coordinate()[0]
    p = torch.from_numpy(pos).requires_grad_()
    c = torch.from_numpy(col).requires_grad_()
    band = render(p, c)
    loss = torch.sum((band - SP_TARGET) ** 2)
    loss.backward()
    rast, _ = dr.rasterize(None, torch.from_numpy(pos), torch.from_numpy(tri), (hb, SP_RES[1]),
                           grad_db=False, viewport=(k * hb, SP_RES[0]))
    arrays.update(band=band.detach().numpy(), rast=rast.numpy(), g_pos=p.grad.numpy(),
                  g_col=c.grad.numpy())

    # Data parallel over the (2, 2) mesh's dp axis.
    pos_idx, col_idx, vtxc, batch = dp_scene()
    tri_t, cidx_t = torch.from_numpy(pos_idx), torch.from_numpy(col_idx)
    colp = torch.from_numpy(vtxc.copy()).requires_grad_()
    opt = torch.optim.SGD([colp], lr=DP_LR)
    step = shard_map_train_step(dp_loss_fn(colp, tri_t, cidx_t), opt, mesh)
    start, size = multihost.local_batch_slice(batch.shape[0], mesh)
    res["dp_slice"] = [start, size]
    res["dp_losses"] = [float(step(torch.from_numpy(batch[start:start + size])))
                        for _ in range(DP_STEPS)]
    arrays["dp_col"] = colp.detach().numpy()

    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
