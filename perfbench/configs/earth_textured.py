"""earth_textured on the program: the scene and the call into the port.

The earth sample's texture fit at its atlas size (2048x1536, trilinear,
wrap, max_mip_level 9) on uv_sphere(128, 256); learnable object-space
positions and texture; a batch of views is one
``nvdiffrast_tpu_torch.render_pipeline_textured`` call, no topology_hash.
"""

import torch

from perfbench import scene as sc


def build(config, seed, device):
    """{"arrays", "inputs", "params"} as in sphere_vcolor.build."""
    m, t = config["mesh"], config["texture"]
    tri, vtx, uv_idx, uv = sc.uv_sphere(m["n_lat"], m["n_lon"])
    g = sc.generator(seed, device, 2)
    tex = torch.rand((1, t["height"], t["width"], t["channels"]), generator=g, device=device)
    params = {"pos": torch.as_tensor(vtx, device=device).clone().requires_grad_(),
              "tex": tex.requires_grad_()}
    inputs = {"tri": torch.as_tensor(tri, device=device),
              "uv_idx": torch.as_tensor(uv_idx, device=device),
              "uv": torch.as_tensor(uv, device=device)}
    return {"arrays": {"tri": tri, "uv_idx": uv_idx, "uv": uv}, "inputs": inputs,
            "params": params, "config": config}


def clip_positions(pos, views):
    posw = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return torch.matmul(posw, views.transpose(1, 2))


def render(scene, params, views, resolution):
    """[B, H, W, C] images of the batch: the port's fused textured pipeline."""
    import nvdiffrast_tpu_torch as dr

    inp, cfg = scene["inputs"], scene["config"]
    return dr.render_pipeline_textured(
        clip_positions(params["pos"], views), inp["tri"], inp["uv"], params["tex"],
        resolution, uv_tri=inp["uv_idx"], filter_mode=cfg["filter_mode"],
        boundary_mode=cfg["boundary_mode"], max_mip_level=cfg["max_mip_level"])
