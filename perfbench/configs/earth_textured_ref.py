"""earth_textured's plain reference: one view through rasterize with
bary derivatives, uv interpolation, the mip pyramid and trilinear
sampling, and antialias of ``perfbench/ref/render.py``. Imports torch
and the reference alone."""

import torch

from perfbench.ref import render as R


def mesh(arrays, device):
    tri = torch.as_tensor(arrays["tri"], dtype=torch.int64, device=device)
    return {"tri": tri,
            "atri": torch.as_tensor(arrays["uv_idx"], dtype=torch.int64, device=device),
            "uv": torch.as_tensor(arrays["uv"], device=device),
            "op": R.topology(tri)}


def prepare(m, params, config, data):
    """The texture's mip pyramid, shared by the step's views."""
    levels = R.pyramid(params["tex"][0].to(data), config["max_mip_level"])
    return {f"level{i}": lv for i, lv in enumerate(levels)}


def render_view(m, params, shared, view, resolution, config, geom, data):
    H, W = resolution
    N = H * W
    levels = [shared[f"level{i}"] for i in range(len(shared))]
    th, tw = levels[0].shape[:2]
    pos = params["pos"].to(geom)
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1) @ view.to(geom).T
    tid, depth = R.raster(clip.detach(), m["tri"], H, W)
    pix, b, db = R.bary(clip, m["tri"], tid, H, W, True)
    uv = m["uv"].to(data)
    uv_c = R.interpolate(uv, m["atri"], tid, pix, b.to(data), N)
    da = R.uv_derivatives(uv, m["atri"], tid, pix, tuple(d.to(data) for d in db))
    fl = R.mip_level(da, float(th), float(tw), len(levels))
    # An empty pixel samples uv (0, 0) at level 0, as the program's
    # sampler does: one sample, whose gradient sums every empty pixel's.
    color = R.sample(levels, uv_c[pix], fl)
    empty = R.sample(levels, uv_c.new_zeros((1, 2)), fl.new_zeros(1))
    covered = torch.zeros(N, dtype=torch.bool, device=pix.device).index_fill(0, pix, True)
    full = color.new_zeros((N, color.shape[1])).index_put((pix,), color)
    color = torch.where(covered[:, None], full, empty)
    return R.antialias(color, tid, depth, clip, m["tri"], m["op"], H, W)
