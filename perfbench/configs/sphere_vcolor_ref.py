"""sphere_vcolor's plain reference: one view through rasterize,
interpolate and antialias of ``perfbench/ref/render.py``. Imports torch
and the reference alone."""

import torch

from perfbench.ref import render as R


def mesh(arrays, device):
    """The mesh as the reference reads it, its topology worked out here."""
    tri = torch.as_tensor(arrays["tri"], dtype=torch.int64, device=device)
    return {"tri": tri, "atri": torch.as_tensor(arrays["col_idx"], dtype=torch.int64,
                                                device=device),
            "op": R.topology(tri)}


def prepare(m, params, config, data):
    """Per-step tensors shared by the views (none here)."""
    return {}


def render_view(m, params, shared, view, resolution, config, geom, data):
    """[H*W, C] image of one view; differentiable in params."""
    H, W = resolution
    pos = params["pos"].to(geom)
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1) @ view.to(geom).T
    tid, depth = R.raster(clip.detach(), m["tri"], H, W)
    pix, b, _ = R.bary(clip, m["tri"], tid, H, W, False)
    color = R.interpolate(params["col"].to(data), m["atri"], tid, pix, b.to(data), H * W)
    return R.antialias(color, tid, depth, clip, m["tri"], m["op"], H, W)
