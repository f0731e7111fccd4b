"""Texture fitting with and without mipmaps (the earth workload).

Counterpart of ``nvdiffrast_tpu.models.fit_earth``: learn a texture from
renders of a uv-sphere against a supersampled reference (rendered at
``ref_res`` with mipmaps, then downsampled), comparing mip-aware sampling
(trilinear, with uv derivatives from interpolate's ``diff_attrs``) with
plain bilinear. The target texture is procedural
(``primitives.checkerboard_texture``); the metric is the texture's PSNR.
The same cameras from ``np.random.RandomState(seed)``, the same loss,
Adam with the reference's learning-rate decay, the texture clipped to
[0, 1] after each step.
"""

import numpy as np
import torch

from ..ops.interpolate import interpolate
from ..ops.rasterize import rasterize
from ..ops.texture import texture
from ..utils import camera
from ..utils.image import bilinear_downsample, psnr
from . import primitives


def render(mtx, pos, pos_idx, uv, uv_idx, tex, resolution, enable_mip, max_mip_level):
    """[1, res, res, C] render of the textured sphere under `mtx`, zero on
    the background."""
    pos_clip = camera.transform_pos(mtx, pos)
    rast_out, rast_out_db = rasterize(None, pos_clip, pos_idx, (resolution, resolution))
    if enable_mip:
        texc, texd = interpolate(uv[None], rast_out, uv_idx, rast_db=rast_out_db,
                                 diff_attrs="all")
        color = texture(tex[None], texc, texd, filter_mode="linear-mipmap-linear",
                        max_mip_level=max_mip_level)
    else:
        texc, _ = interpolate(uv[None], rast_out, uv_idx)
        color = texture(tex[None], texc, filter_mode="linear")
    return color * torch.clamp(rast_out[..., -1:], 0, 1)


class EarthFitModel:
    """Learn a texture from sphere renders; metric = texture PSNR."""

    def __init__(self, res=128, ref_res=256, tex_res=(128, 256), enable_mip=True,
                 max_mip_level=9, lr=1e-2, seed=0, device="cuda"):
        self.device = torch.device(device)
        pos_idx, vtxp, uv_idx, vtxu = primitives.uv_sphere(24, 48)
        self.pos_idx = torch.as_tensor(pos_idx, device=self.device)
        self.uv_idx = torch.as_tensor(uv_idx, device=self.device)
        self.vtx_pos = torch.as_tensor(vtxp, device=self.device)
        self.vtx_uv = torch.as_tensor(vtxu, device=self.device)
        self.tex_ref = torch.as_tensor(primitives.checkerboard_texture(*tex_res),
                                       device=self.device)
        self.res = int(res)
        self.ref_res = int(ref_res)
        self.enable_mip = bool(enable_mip)
        self.max_mip_level = max_mip_level
        self.rng = np.random.RandomState(seed)
        self.params = torch.full(self.tex_ref.shape, 0.2, dtype=torch.float32,
                                 device=self.device, requires_grad=True)
        self.opt = torch.optim.Adam([self.params], lr=lr)
        # Learning-rate decay of the reference (earth.py): lr * 0.1**(step/20000).
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda step: 0.1 ** (step / 20000.0))
        self.downsample_steps = int(np.log2(self.ref_res // self.res))

    def set_params(self, tex):
        """Load a texture array (e.g. the JAX model's ``params``)."""
        with torch.no_grad():
            self.params.copy_(torch.from_numpy(np.array(tex, np.float32)))

    def random_mvp(self):
        rot = camera.random_rotation_translation(0.25, self.rng)
        mv = camera.translate(0, 0, -3.5) @ rot
        return (camera.projection(x=0.4) @ mv).astype(np.float32)

    def loss(self, mtx):
        """Mean squared error of the current texture's render against the
        downsampled reference under `mtx` (differentiable in the texture)."""
        with torch.no_grad():
            ref = render(mtx, self.vtx_pos, self.pos_idx, self.vtx_uv, self.uv_idx,
                         self.tex_ref, self.ref_res, True, self.max_mip_level)
            ref = bilinear_downsample(ref, self.downsample_steps)
        img = render(mtx, self.vtx_pos, self.pos_idx, self.vtx_uv, self.uv_idx,
                     self.params, self.res, self.enable_mip, self.max_mip_level)
        return torch.mean((img - ref) ** 2)

    def texture_psnr(self):
        return psnr(self.params.detach(), self.tex_ref)

    def step(self):
        loss = self.loss(self.random_mvp())
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.sched.step()
        with torch.no_grad():
            self.params.clamp_(0.0, 1.0)
        return loss.item()

    def fit(self, max_iter=1000, log_interval=0):
        for it in range(max_iter):
            loss = self.step()
            if log_interval and it % log_interval == 0:
                print(f"iter={it} loss={loss:.6f} psnr={self.texture_psnr():.2f}")
        return self.texture_psnr()
