"""Cube-map environment and Phong BRDF fitting (the envphong workload).

Counterpart of ``nvdiffrast_tpu.models.fit_envphong``: per-pixel
reflection vectors interpolated with their screen derivatives
(``diff_attrs='all'``), trilinear seamless cube-map sampling (kernel B12)
and a learned Phong term, fitted to renders of a procedural environment
(``primitives.procedural_cubemap``) on an icosphere. The same cameras and
lights from ``np.random.RandomState(seed)``, the same loss, Adam, the
map clipped to [0, 1] after each step.
"""

import numpy as np
import torch

from ..ops.interpolate import interpolate
from ..ops.rasterize import rasterize
from ..ops.texture import texture
from ..utils import camera
from ..utils.trace import spanned
from . import primitives


def _vertex_normals(tri, vtx):
    """Area-weighted vertex normals (for a sphere these are radial)."""
    v = vtx[tri]  # [T, 3, 3]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = np.zeros_like(vtx)
    for k in range(3):
        np.add.at(out, tri[:, k], n)
    out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-12
    return out.astype(np.float32)


@spanned("nvdr.envphong.refl")
def render_refl(mvp, campos, pos, pos_idx, normals, res):
    """Rasterize and return the interpolated, normalised reflection
    vectors [B, H, W, 3], their screen derivatives [B, H, W, 6] and the
    background mask [B, H, W, 1].

    One view (mvp [4, 4], campos [3]; B = 1) or a batch of B views (mvp
    [B, 4, 4], campos [B, 3]): per-view vertex reflection vectors, one
    ``rasterize`` of the B views and one ``interpolate`` of the per-view
    vectors. res is the square image's side or (H, W)."""
    H, W = (res, res) if isinstance(res, int) else (int(res[0]), int(res[1]))
    viewvec = pos[None, :, :3] - campos.reshape(-1, 1, 3)
    reflvec = viewvec - 2.0 * normals * torch.sum(normals * viewvec, -1, keepdim=True)
    reflvec = reflvec / torch.sum(reflvec ** 2, -1, keepdim=True) ** 0.5
    posw = torch.cat([pos[:, :3], torch.ones_like(pos[:, :1])], dim=1)
    if mvp.ndim == 2:  # the one-view product, so one-view callers keep their bits
        pos_clip = (posw @ mvp.T)[None]
    else:
        pos_clip = torch.matmul(posw, mvp.transpose(1, 2))
    rast_out, rast_out_db = rasterize(None, pos_clip, pos_idx, (H, W))
    refl, refld = interpolate(reflvec, rast_out, pos_idx, rast_db=rast_out_db,
                              diff_attrs="all")
    refl = refl / (torch.sum(refl ** 2, -1, keepdim=True) + 1e-8) ** 0.5
    mask = rast_out[..., -1:] == 0
    return refl, refld, mask


@spanned("nvdr.envphong.shade")
def shade(env, phong_rgb, phong_exp, refl, refld, ldir, mask):
    """Environment lookup plus a Phong highlight; 1 on the background.
    ldir is one light direction [3] or one a view [B, 3]."""
    color = texture(env[None], refl, uv_da=refld, filter_mode="linear-mipmap-linear",
                    boundary_mode="cube")
    ldotr = torch.sum(-ldir.reshape(-1, 1, 1, 3) * refl, -1, keepdim=True)
    color = color + phong_rgb * torch.maximum(torch.zeros_like(ldotr), ldotr) ** phong_exp
    return torch.where(mask, 1.0, color)


class EnvPhongFitModel:
    """Learn an environment cube map and Phong parameters."""

    def __init__(self, res=128, env_res=32, subdiv=2, lr=1e-2, seed=0, device="cuda"):
        self.device = torch.device(device)
        tri, vtx = primitives.icosphere(subdiv)
        self.pos_idx = torch.as_tensor(tri, device=self.device)
        self.pos = torch.as_tensor(vtx, device=self.device)
        self.normals = torch.as_tensor(_vertex_normals(tri, vtx), device=self.device)
        self.env_ref = torch.as_tensor(primitives.procedural_cubemap(env_res),
                                       device=self.device)
        self.phong_rgb_ref = torch.tensor([1.0, 0.8, 0.6], device=self.device)
        self.phong_exp_ref = 25.0
        self.res = int(res)
        self.rng = np.random.RandomState(seed)
        self.params = {
            "env": torch.full(self.env_ref.shape, 0.5, dtype=torch.float32,
                              device=self.device, requires_grad=True),
            # rgb + exponent (envphong.py phong_var[:3], [3]).
            "phong": torch.tensor([1.0, 1.0, 1.0, 10.0], device=self.device,
                                  requires_grad=True),
        }
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr)

    def set_params(self, params):
        """Load {"env": [6, r, r, 3], "phong": [4]} arrays (e.g. the JAX
        model's ``params``)."""
        with torch.no_grad():
            for k, v in params.items():
                self.params[k].copy_(torch.from_numpy(np.array(v, np.float32)))

    def random_view(self):
        rot = camera.random_rotation_translation(0.25, self.rng)
        mv = camera.translate(0, 0, -3.5) @ rot
        mvp = (camera.projection(x=0.4) @ mv).astype(np.float32)
        campos = np.linalg.inv(mv)[:3, 3].astype(np.float32)
        ldir = self.rng.normal(size=[3])
        ldir /= np.linalg.norm(ldir) + 1e-8
        return mvp, campos, ldir.astype(np.float32)

    def loss(self, mvp, campos, ldir):
        """Mean squared error of the current parameters' shading against the
        reference's for one view (differentiable in the parameters)."""
        mvp, campos, ldir = (torch.as_tensor(x, device=self.device) for x in (mvp, campos, ldir))
        with torch.no_grad():
            refl, refld, mask = render_refl(mvp, campos, self.pos, self.pos_idx,
                                            self.normals, self.res)
            ref_img = shade(self.env_ref, self.phong_rgb_ref, self.phong_exp_ref, refl,
                            refld, ldir, mask)
        p = self.params
        img = shade(p["env"], p["phong"][:3], p["phong"][3], refl, refld, ldir, mask)
        return torch.mean((img - ref_img) ** 2)

    def metrics(self):
        """(env RMSE, phong rgb RMSE, exponent relative error)."""
        with torch.no_grad():
            p = self.params
            env_rmse = float(torch.sqrt(torch.mean((p["env"] - self.env_ref) ** 2)))
            rgb_rmse = float(torch.sqrt(torch.mean((p["phong"][:3] - self.phong_rgb_ref) ** 2)))
            exp_rel = float(abs(p["phong"][3] - self.phong_exp_ref) / self.phong_exp_ref)
        return env_rmse, rgb_rmse, exp_rel

    def step(self):
        loss = self.loss(*self.random_view())
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            self.params["env"].clamp_(0.0, 1.0)
        return loss.item()

    def fit(self, max_iter=1000, log_interval=0):
        for it in range(max_iter):
            loss = self.step()
            if log_interval and it % log_interval == 0:
                e, r, x = self.metrics()
                print(f"iter={it} loss={loss:.6f} env_rmse={e:.4f} rgb_rmse={r:.4f} "
                      f"exp_rel={x:.4f}")
        return self.metrics()
