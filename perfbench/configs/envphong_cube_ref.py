"""envphong_cube's plain reference: one view through rasterize with bary
derivatives and interpolation of ``perfbench/ref/render.py`` and the
cube-map sampler of ``perfbench/ref/cube.py``, then the Phong term and the
white background. Imports torch and the reference alone.

Each view follows nvdiffrast's envphong sample: per-vertex reflection
vectors r = v - 2 n (n . v) of the view vectors v = pos - campos,
normalised; their interpolation and screen derivatives; per-pixel
normalisation r / sqrt(|r|^2 + 1e-8); the cube map sampled trilinearly
at r with the level from the derivatives; plus phong_rgb * max(0, -l .
r) ** phong_exp; 1 where no triangle covers the pixel. Departures from
the sample, as the configuration's ``assumed`` states them: the camera
position and light come from the view matrix (campos = -R^T t of P^-1
mvp, l fixed in camera space), and nothing is clamped after the step.

It runs in float64 by default (``geom`` for the camera, coverage and
barycentrics, ``data`` for everything after them), so it needs no TF32
setting: float64 matrix products never run in TF32.
"""

import torch

from perfbench.ref import cube as CB
from perfbench.ref import render as R


def mesh(arrays, device):
    """The mesh, normals, projection and camera-space light as the
    reference reads them."""
    return {"tri": torch.as_tensor(arrays["tri"], dtype=torch.int64, device=device),
            "pos": torch.as_tensor(arrays["pos"], device=device),
            "normals": torch.as_tensor(arrays["normals"], device=device),
            "proj": torch.as_tensor(arrays["proj"], device=device),
            "light": torch.as_tensor(arrays["light"], device=device)}


def prepare(m, params, config, data):
    """The cube map's per-face pyramid, shared by the step's views."""
    levels = CB.pyramid(params["env"].to(data), config["max_mip_level"])
    return {f"level{i}": lv for i, lv in enumerate(levels)}


def render_view(m, params, shared, view, resolution, config, geom, data):
    """[H*W, 3] image of one view; differentiable in params and shared."""
    H, W = resolution
    N = H * W
    levels = [shared[f"level{i}"] for i in range(len(shared))]
    view = view.to(geom)
    mv = torch.linalg.solve(m["proj"].to(geom), view)
    rt = mv[:3, :3].T
    campos = -(rt @ mv[:3, 3])
    light = rt @ m["light"].to(geom)
    pos = m["pos"].to(geom)
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1) @ view.T
    tid, _ = R.raster(clip, m["tri"], H, W)
    pix, b, (dbdx, dbdy) = R.bary(clip, m["tri"], tid, H, W, True)

    n = m["normals"].to(data)
    v = pos.to(data) - campos.to(data)
    r = v - 2.0 * n * (n * v).sum(1, keepdim=True)
    r = r / (r * r).sum(1, keepdim=True).sqrt()
    g = R.gather_rows(r, m["tri"][tid[pix]])           # [M, 3 vertices, 3]
    refl = (b.to(data)[..., None] * g).sum(1)
    ddx = (dbdx.to(data)[..., None] * g).sum(1)
    ddy = (dbdy.to(data)[..., None] * g).sum(1)
    refl = refl / ((refl * refl).sum(1, keepdim=True) + 1e-8).sqrt()

    fl = CB.level(refl, ddx, ddy, levels[0].shape[1], len(levels))
    color = CB.sample(levels, refl, fl)
    phong = params["phong"].to(data)
    ldotr = (-light.to(data) * refl).sum(1, keepdim=True)
    color = color + phong[:3] * torch.maximum(torch.zeros_like(ldotr), ldotr) ** phong[3]
    img = torch.full((N, color.shape[1]), config["background"], dtype=color.dtype,
                     device=color.device)
    return img.index_put((pix,), color)
