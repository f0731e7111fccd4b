"""The reference's training steps: views rendered one at a time by a
configuration's plain reference, the mean squared error against the
targets, autograd, and Adam written out (torch.optim.Adam's update).

Imports torch alone; ``allreduce`` (a callable summing a list of tensors
over the ranks in place, or None) lets each rank follow its own shard of
a data-parallel step.
"""

import math

import torch


def follow(ref, mesh, params0, config, batches, views, targets, resolution, geom, data,
           master, allreduce=None, n_ranks=1, keep_first_images=True):
    """Follow len(batches) steps from params0 ({name: tensor}).

    batches: per step, the pool indices of its views; views [P, 4, 4] and
    targets [P, H, W, C] on the device. The loss of a step is the mean
    over its views' pixels and channels (over the ranks' with allreduce).

    Returns {"losses": [float], "grad1": {name: the first step's
    gradient}, "params": {name: after the last step}, "images1": [B, H,
    W, C] float64 of the first step or None}.
    """
    opt = config["optimizer"]
    b1, b2 = opt["betas"]
    eps = opt["eps"]
    params = {k: v.detach().to(master).clone().requires_grad_() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    H, W = resolution
    losses, grad1, images1 = [], None, None
    for step, idx in enumerate(batches):
        for p in params.values():
            p.grad = None
        shared = ref.prepare(mesh, params, config, data)
        leaves = {k: s.detach().requires_grad_() for k, s in shared.items()}
        count = len(idx) * H * W * targets.shape[-1]
        total = torch.zeros((), dtype=master, device=views.device)
        imgs = []
        for i in idx:
            img = ref.render_view(mesh, params, leaves, views[i], resolution, config, geom,
                                  data)
            err = img.to(master) - targets[i].reshape(H * W, -1).to(master)
            loss = (err * err).sum() / count
            loss.backward()
            total += loss.detach()
            if step == 0 and keep_first_images:
                imgs.append(img.detach().to(torch.float64).reshape(H, W, -1))
            del img, err, loss
        if leaves:
            names = [k for k in leaves if leaves[k].grad is not None]
            torch.autograd.backward([shared[k] for k in names],
                                    [leaves[k].grad for k in names])
        grads = [params[k].grad if params[k].grad is not None
                 else torch.zeros_like(params[k]) for k in params]
        if allreduce is not None:
            allreduce([total.reshape(1)] + grads)
            total = total / n_ranks
            grads = [g / n_ranks for g in grads]
        losses.append(float(total))
        if step == 0:
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
            images1 = torch.stack(imgs) if imgs else None
        t = step + 1
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[k], denom, value=-opt["lr"][k] / (1 - b1 ** t))
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()}, "images1": images1}


def render_views(ref, mesh, params, config, idx, views, resolution, geom, data):
    """Forward only: [len(idx), H, W, C] float64 images of the given views."""
    H, W = resolution
    with torch.no_grad():
        p = {k: v.detach().to(torch.float64) for k, v in params.items()}
        shared = ref.prepare(mesh, p, config, data)
        return torch.stack([ref.render_view(mesh, p, shared, views[i], resolution, config,
                                            geom, data).reshape(H, W, -1).to(torch.float64)
                            for i in idx])
