"""Cube fitting: vertex positions and colours from low-resolution renders.

Counterpart of ``nvdiffrast_tpu.models.fit_cube``: the same initial
parameters and cameras from ``np.random.RandomState(seed)``, the same
loss (mean squared error against a render of the reference cube from a
random view), Adam with the reference's learning-rate ramp. Each step
renders through the composable ops ``rasterize``, ``interpolate`` and
``antialias``; the antialias position gradients are what make
convergence possible at 4-16 px.
"""

import numpy as np
import torch

from ..ops.antialias import antialias, antialias_construct_topology_hash
from ..ops.interpolate import interpolate
from ..ops.rasterize import rasterize
from ..utils import camera
from . import primitives


def render(mtx, pos, pos_idx, col, col_idx, resolution, topo=None):
    """[H, W, 3] image of vertices `pos` [V, 3] coloured by `col` [V, 3]
    under the 4x4 matrix `mtx`."""
    pos_clip = camera.transform_pos(mtx, pos)
    rast_out, _ = rasterize(None, pos_clip, pos_idx, (resolution, resolution))
    color, _ = interpolate(col[None], rast_out, col_idx)
    color = antialias(color, rast_out, pos_clip, pos_idx, topology_hash=topo)
    return color[0]


class CubeFitModel:
    """Vertex position / colour optimisation against a reference cube."""

    def __init__(self, resolution=16, discontinuous=False, seed=0, lr=1e-2,
                 device="cuda"):
        make = primitives.cube_discontinuous if discontinuous else primitives.cube_continuous
        pos_idx, vtxp, col_idx, vtxc = make()
        self.device = torch.device(device)
        self.pos_idx = torch.as_tensor(pos_idx, device=self.device)
        self.col_idx = torch.as_tensor(col_idx, device=self.device)
        self.vtx_pos = torch.as_tensor(vtxp, device=self.device)
        self.vtx_col = torch.as_tensor(vtxc, device=self.device)
        self.resolution = int(resolution)
        self.rng = np.random.RandomState(seed)
        self.params = {
            "pos": self._param(vtxp + self.rng.uniform(-0.5, 0.5, size=vtxp.shape)),
            "col": self._param(self.rng.uniform(0.0, 1.0, size=vtxc.shape)),
        }
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr)
        # Learning-rate ramp of the reference (cube.py:91).
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda step: max(0.01, 10.0 ** (-step * 0.0005)))
        self.topo = antialias_construct_topology_hash(self.pos_idx)

    def _param(self, x):
        return torch.tensor(np.asarray(x, np.float32), device=self.device,
                            requires_grad=True)

    def set_params(self, params):
        """Load {"pos": [V, 3], "col": [V, 3]} arrays (e.g. the JAX model's
        ``params``) into the parameters."""
        with torch.no_grad():
            for k, v in params.items():
                self.params[k].copy_(torch.from_numpy(np.array(v, np.float32)))

    def random_mvp(self):
        rot = camera.random_rotation_translation(0.25, self.rng)
        mv = camera.translate(0, 0, -3.5) @ rot
        return (camera.projection(x=0.4) @ mv).astype(np.float32)

    def loss(self, mtx):
        """Mean squared error of the current cube's render against the
        reference's under `mtx` (differentiable in the parameters)."""
        with torch.no_grad():
            target = render(mtx, self.vtx_pos, self.pos_idx, self.vtx_col, self.col_idx,
                            self.resolution, self.topo)
        img = render(mtx, self.params["pos"], self.pos_idx, self.params["col"],
                     self.col_idx, self.resolution, self.topo)
        return torch.mean((img - target) ** 2)

    def geometric_error(self):
        """Mean distance of the vertices from the +-0.5 cube surface (the
        reference's convergence metric, cube.py:108)."""
        p = self.params["pos"].detach()
        return float(torch.mean(torch.sum((p.abs() - 0.5) ** 2, dim=1) ** 0.5))

    def step(self):
        loss = self.loss(self.random_mvp())
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.sched.step()
        return loss.item()

    def fit(self, max_iter=1000, log_interval=0):
        for it in range(max_iter):
            loss = self.step()
            if log_interval and it % log_interval == 0:
                print(f"iter={it} loss={loss:.6f} err={self.geometric_error():.6f}")
        return self.geometric_error()
