"""What the training kinds share: the scene, its views and targets from
the seed, the timed step, the first steps that set-up drives through it,
and the reference's view of those steps."""

import numpy as np
import torch

from perfbench import harness, scene as sc
from perfbench.ref import train as ref_train

N_BATCHES = 4096  # batches drawn ahead; the window cycles through them


class Fitting:
    """The training object: scene, parameters, optimizer and feed of one
    rank, built from the seed. ``step(k)`` is the window's own call."""

    def __init__(self, cell, seed, device, stream=0):
        cfg, trf = cell.config, cell.traffic
        self.cell = cell
        self.resolution = tuple(trf["resolution"])
        H, W = self.resolution
        self.B = trf["views_per_step"]
        P = trf["pool"]
        self.scene = cell.config_module.build(cfg, seed, device)
        rng = np.random.default_rng([int(seed), 3, stream])
        self.views = torch.as_tensor(sc.view_matrices(cfg["camera"], P, rng), device=device)
        self.targets = sc.smooth_targets(P, H, W, cfg["channels"], seed * 7 + stream, device)
        self.batches = sc.batch_order(seed * 5 + stream, P, self.B, N_BATCHES)
        self.order = torch.as_tensor(self.batches, device=device)
        self.params = self.scene["params"]
        opt = cfg["optimizer"]
        self.opt = torch.optim.Adam(
            [{"params": [p], "lr": opt["lr"][k]} for k, p in self.params.items()],
            betas=tuple(opt["betas"]), eps=opt["eps"])
        self.params0 = {k: p.detach().clone() for k, p in self.params.items()}

    def loss(self, k, keep=None, syncs=None):
        """Forward and loss of batch k (the port's call inside `syncs`)."""
        idx = self.order[k % N_BATCHES]
        with harness.sync_counter(syncs):
            img = self.cell.config_module.render(self.scene, self.params, self.views[idx],
                                                 self.resolution)
        if keep is not None:
            keep.append(img.detach().clone())
        return torch.nn.functional.mse_loss(img, self.targets[idx])

    def step(self, k, keep=None, syncs=None):
        """One step: forward, loss, backward, Adam; ends with the loss read."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(k, keep, syncs)
        with harness.sync_counter(syncs):
            loss.backward()
        self.opt.step()
        return loss.item()

    def first_steps(self, step, n):
        """Drive `step` (the window's call) through steps 0..n-1 and keep
        what the check compares: losses, the first step's images and its
        gradient as Adam holds it, the parameters after step n."""
        keep = []
        losses = [step(0, keep)]
        b1 = self.cell.config["optimizer"]["betas"][0]
        grad1 = {k: (self.opt.state[p]["exp_avg"].detach().clone() / (1 - b1)
                     if "exp_avg" in self.opt.state[p] else torch.zeros_like(p.detach()))
                 for k, p in self.params.items()}
        losses += [step(k) for k in range(1, n)]
        return {"losses": losses, "grad1": grad1, "params0": self.params0,
                "params": {k: p.detach().clone() for k, p in self.params.items()},
                "images1": keep[0]}

    def shapes(self, ranks=1):
        return shapes(self.cell.config, self.scene, self.B, self.resolution, ranks)

    def release(self):
        """Free the program's state; keep the inputs the reference reads."""
        self.opt = None
        self.params = None
        self.scene = {"arrays": self.scene["arrays"]}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def shapes(config, scene, B, resolution, ranks=1):
    """What the roofline arithmetic reads: the cell's shapes."""
    H, W = resolution
    arrays = scene["arrays"]
    return {"B": B, "H": H, "W": W, "C": config["channels"], "ranks": ranks,
            "T": int(arrays["tri"].shape[0]),
            "params": {k: list(p.shape) for k, p in scene["params"].items()},
            "uv_vertices": int(arrays["uv"].shape[0]) if "uv" in arrays else 0}


def reference(cell, fit, n_steps, device, allreduce=None, n_ranks=1,
              geom=torch.float64, data=torch.float64, master=torch.float64):
    """The reference's record of the first n_steps of `fit` (its inputs
    and initial parameters, its batches), in the record's layout."""
    ref = cell.ref_module
    mesh = ref.mesh(fit.scene["arrays"], device)
    rec = ref_train.follow(ref, mesh, fit.params0, cell.config, fit.batches[:n_steps],
                           fit.views, fit.targets, fit.resolution, geom, data, master,
                           allreduce=allreduce, n_ranks=n_ranks)
    rec["params0"] = fit.params0
    return rec
