"""Data-parallel training step.

Counterpart of ``nvdiffrast_tpu/parallel/shard.py``'s
``shard_map_train_step``. Each rank runs the whole single-device
pipeline, kernels included, on its own shard of the minibatch; the
parameters' gradients and the loss are averaged over the dp axis (one
collective a step) before the optimizer steps, so every rank keeps the
same parameters.

Left out, as decided for the port: the GSPMD-constraint API
``render_shardings``, ``shard_pipeline`` and ``sharded_train_step``.
Eager PyTorch has no sharding constraints; this step and the row bands
of ``spatial`` cover what they did.
"""

from .collectives import Axis, all_reduce_sum


def shard_map_train_step(loss_fn, optimizer, mesh, dp_axis="dp"):
    """Build a data-parallel training step.

    Args:
      loss_fn: batch -> scalar mean loss over this rank's shard,
        differentiable in the optimizer's parameters.
      optimizer: a ``torch.optim.Optimizer`` holding the parameters, the
        same initial values on every rank.
      mesh: a ``DeviceMesh`` with the axis `dp_axis`.

    Returns step(batch) -> the loss averaged over dp (a 0-d tensor). The
    gradients are averaged, not summed: each rank's loss is a mean over
    its own shard, so with equal shards the gradient of the global mean
    loss is the mean of the ranks' gradients.
    """
    axis = Axis(mesh, dp_axis)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch):
        optimizer.zero_grad()
        loss = loss_fn(batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else p.detach().new_zeros(p.shape)
                 for p in params]
        sums = all_reduce_sum([loss.detach().reshape(1)] + grads, axis.group)
        for p, g in zip(params, sums[1:]):
            p.grad = g / axis.size
        optimizer.step()
        return sums[0][0] / axis.size

    return step
