"""envphong_cube on the program: the scene and the call into the port.

nvdiffrast's envphong sample (a cube-map environment and a Phong term
fitted through per-pixel reflection vectors) at its published map size,
6 x 512 x 512 x 3, on a 30,720-triangle sphere with radial normals; the
learned map and Phong terms are those of ``EnvPhongFitModel``. A batch of
views is one call of the port's batched ``render_refl`` and ``shade``
(``nvdiffrast_tpu_torch.models.fit_envphong``): one ``rasterize`` with
rast_db, one ``interpolate`` of per-view vectors with ``diff_attrs='all'``,
one cube-map ``texture``.
"""

import numpy as np
import torch

from perfbench import scene as sc


def build(config, seed, device):
    """{"arrays", "inputs", "params"} as in sphere_vcolor.build; the arrays
    also hold the projection and the light the reference reads."""
    m, e, cam = config["mesh"], config["env"], config["camera"]
    tri, vtx, _, _ = sc.uv_sphere(m["n_lat"], m["n_lon"])
    normals = (vtx / np.linalg.norm(vtx, axis=1, keepdims=True)).astype(np.float32)
    proj = sc.projection(x=cam["projection_x"])
    light = np.random.default_rng([int(seed), 17]).normal(size=3)
    light = (light / np.linalg.norm(light)).astype(np.float32)
    g = sc.generator(seed, device, 3)
    env = torch.rand((e["faces"], e["width"], e["width"], e["channels"]), generator=g,
                     device=device)
    params = {"env": env.requires_grad_(),
              "phong": torch.tensor(config["phong_init"], dtype=torch.float32,
                                    device=device).requires_grad_()}
    dev = dict(device=device)
    inputs = {"tri": torch.as_tensor(tri, **dev), "pos": torch.as_tensor(vtx, **dev),
              "normals": torch.as_tensor(normals, **dev),
              "proj_inv": torch.as_tensor(np.linalg.inv(proj.astype(np.float64))
                                          .astype(np.float32), **dev),
              "light": torch.as_tensor(light, **dev)}
    return {"arrays": {"tri": tri, "pos": vtx, "normals": normals, "proj": proj,
                       "light": light},
            "inputs": inputs, "params": params, "config": config}


def cameras(proj_inv, views, light):
    """Per-view camera positions [B, 3] and light directions [B, 3] in
    object space, from the views [B, 4, 4] with no host sync: mv =
    P^-1 mvp, campos = -R^T t, ldir = R^T l."""
    mv = torch.matmul(proj_inv, views)
    rt = mv[:, :3, :3].transpose(1, 2)
    campos = -torch.matmul(rt, mv[:, :3, 3:])[..., 0]
    return campos, torch.matmul(rt, light)


def render(scene, params, views, resolution):
    """[B, H, W, 3] images of the batch: the port's batched envphong
    render_refl and shade."""
    from nvdiffrast_tpu_torch.models.fit_envphong import render_refl, shade

    inp = scene["inputs"]
    campos, ldir = cameras(inp["proj_inv"], views, inp["light"])
    refl, refld, mask = render_refl(views, campos, inp["pos"], inp["tri"], inp["normals"],
                                    resolution)
    phong = params["phong"]
    return shade(params["env"], phong[:3], phong[3], refl, refld, ldir, mask)
