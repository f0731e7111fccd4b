"""Pose fitting from rendered colour.

Counterpart of ``nvdiffrast_tpu.models.fit_pose``: recover a cube's
orientation quaternion with the reference's two phases (fit_pose.py:76-103),
a random search around the best pose, then gradient descent that relies
on the antialias position gradients. The target and initial poses and
the search's draws come from ``np.random.RandomState(seed)`` as there.
The metric is the angular error in degrees.
"""

import numpy as np
import torch

from ..ops.antialias import antialias
from ..ops.interpolate import interpolate
from ..ops.rasterize import rasterize
from ..utils import camera
from . import primitives


def render(mvp, q, pos, pos_idx, col, col_idx, resolution):
    """[1, H, W, 3] image of the cube rotated by quaternion `q` [4]."""
    mtx = mvp @ camera.q_to_mtx(q)
    pos_clip = camera.transform_pos(mtx, pos)
    rast_out, _ = rasterize(None, pos_clip, pos_idx, (resolution, resolution))
    color, _ = interpolate(col[None], rast_out, col_idx)
    return antialias(color, rast_out, pos_clip, pos_idx)


class PoseFitModel:
    """Two-phase pose fitting; metric = quaternion angle error (deg)."""

    def __init__(self, resolution=64, lr_base=0.01, nr_base=1.0, nr_falloff=1e-4,
                 grad_phase_start=0.5, seed=0, device="cuda"):
        pos_idx, vtxp, col_idx, vtxc = primitives.cube_continuous()
        self.device = torch.device(device)
        self.pos_idx = torch.as_tensor(pos_idx, device=self.device)
        self.col_idx = torch.as_tensor(col_idx, device=self.device)
        self.vtx_pos = torch.as_tensor(vtxp, device=self.device)
        self.vtx_col = torch.as_tensor(vtxc, device=self.device)
        self.resolution = int(resolution)
        self.lr_base = lr_base
        self.nr_base = nr_base
        self.nr_falloff = nr_falloff
        self.grad_phase_start = grad_phase_start
        self.rng = np.random.RandomState(seed)
        proj = camera.projection(x=0.4)
        mv = camera.translate(0, 0, -3.5)
        self.mvp = torch.as_tensor((proj @ mv).astype(np.float32), device=self.device)
        self.pose_target = camera.q_rnd(self.rng)
        self.pose_init = camera.q_rnd(self.rng)
        self.pose_opt = self._q(self.pose_init / np.linalg.norm(self.pose_init))
        with torch.no_grad():
            self.target_img = self._render(self._q(self.pose_target))

    def _q(self, q):
        return torch.as_tensor(np.asarray(q, np.float32), device=self.device)

    def _render(self, q):
        return render(self.mvp, q, self.vtx_pos, self.pos_idx, self.vtx_col,
                      self.col_idx, self.resolution)

    def loss(self, q):
        """Mean squared error of the render under `q` against the target
        (differentiable in q)."""
        return torch.mean((self.target_img - self._render(q)) ** 2)

    def loss_grad(self, q):
        q = q.detach().clone().requires_grad_()
        return torch.autograd.grad(self.loss(q), q)[0]

    def angle_error(self):
        return camera.q_angle_deg(self.pose_opt.cpu().numpy(), self.pose_target)

    def fit(self, max_iter=300, log_interval=0):
        pose_best = self.pose_opt.clone()
        with torch.no_grad():
            loss_best = float(self.loss(pose_best))
        for it in range(max_iter):
            noise = self.nr_base * self.nr_falloff ** (it / max_iter)
            if it < self.grad_phase_start * max_iter:
                # Random search phase: jitter the best pose.
                q = self._q(camera.q_scale_small(camera.q_rnd(self.rng), noise))
                cand = camera.q_mul(q, pose_best)
                cand = cand / torch.linalg.norm(cand)
                with torch.no_grad():
                    loss = float(self.loss(cand))
                if loss < loss_best:
                    pose_best = cand
                    loss_best = loss
                self.pose_opt = pose_best
            else:
                # Gradient phase, constant learning rate.
                g = self.loss_grad(self.pose_opt)
                q = self.pose_opt - self.lr_base * g
                self.pose_opt = q / torch.linalg.norm(q)
                with torch.no_grad():
                    loss = float(self.loss(self.pose_opt))
                if loss < loss_best:
                    pose_best = self.pose_opt
                    loss_best = loss
            if log_interval and it % log_interval == 0:
                print(f"iter={it} loss={loss_best:.6f} angle={self.angle_error():.3f} deg")
        self.pose_opt = pose_best
        return self.angle_error()
