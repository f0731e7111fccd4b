"""sphere_vcolor on the program: the scene and the call into the port.

The scene of bench.py's headline line (uv_sphere(32, 64), vertex
colours) with learnable object-space positions and colours; a batch of
views is one ``nvdiffrast_tpu_torch.render_pipeline`` call, no
topology_hash, as bench.py and the samples call it.
"""

import torch

from perfbench import scene as sc


def build(config, seed, device):
    """{"arrays": the mesh as numpy, "inputs": device tensors the calls
    read, "params": learnable float32 leaves}; all from the seed."""
    m = config["mesh"]
    tri, vtx, col_idx, _ = sc.uv_sphere(m["n_lat"], m["n_lon"])
    g = sc.generator(seed, device, 1)
    col = torch.rand((vtx.shape[0], config["channels"]), generator=g, device=device)
    params = {"pos": torch.as_tensor(vtx, device=device).clone().requires_grad_(),
              "col": col.requires_grad_()}
    inputs = {"tri": torch.as_tensor(tri, device=device),
              "col_idx": torch.as_tensor(col_idx, device=device)}
    return {"arrays": {"tri": tri, "col_idx": col_idx}, "inputs": inputs, "params": params}


def clip_positions(pos, views):
    """[B, V, 4] clip-space positions of object-space pos [V, 3] under
    views [B, 4, 4]."""
    posw = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    return torch.matmul(posw, views.transpose(1, 2))


def render(scene, params, views, resolution):
    """[B, H, W, C] images of the batch: the port's fused pipeline."""
    import nvdiffrast_tpu_torch as dr

    inp = scene["inputs"]
    return dr.render_pipeline(clip_positions(params["pos"], views), inp["tri"],
                              params["col"], resolution, attr_idx=inp["col_idx"])
