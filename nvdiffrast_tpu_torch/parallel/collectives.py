"""The collective layer of the parallel package: halo exchanges and
gradient sums over one axis of a mesh, on torch.distributed.

JAX's ``shard_map`` sums the gradients of replicated inputs over an axis
by itself and transposes each ``ppermute`` in its AD; eager PyTorch does
neither. Here each is written out:

* ``shift`` sends a tensor one step along an axis, cyclically (one
  ``batch_isend_irecv`` with the send and the receive posted together);
  ``Shift`` is it as a ``torch.autograd.Function`` whose backward sends
  the cotangent the other way, along the inverse permutation. Every rank
  runs every exchange, even where its result is masked, so every rank
  builds the same graph and the autograd engine runs the exchanges in the
  same order everywhere: a skipped or reordered exchange would deadlock.
* ``all_reduce_sum`` sums a list of tensors over an axis in one
  collective (one flat buffer); ``SumGrads`` is the identity whose
  backward sums the gradients over the axis: what ``shard_map``'s AD does
  for an input every rank of the axis holds the same copy of.

Backends: with ``nccl`` the tensors go as they are, on the card. With
``gloo`` a CUDA tensor is staged through host memory, and only there
(gloo's point-to-point calls take CPU tensors): this is how two ranks
share one GPU, which NCCL refuses. The pixels are still computed on the
card by the kernels; only the one-row halos and the gradient sums cross
host memory. Any other backend raises ValueError.
"""

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..utils.trace import span, spanned


class Axis:
    """One named axis of a ``DeviceMesh`` as this rank sees it: its
    process group, this rank's index along it, its size and the global
    ranks along it (``ranks[index]`` is this rank)."""

    def __init__(self, mesh, name):
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        dim = mesh.mesh_dim_names.index(name)
        sel = list(coord)
        sel[dim] = slice(None)
        self.group = mesh.get_group(name)
        self.ranks = [int(r) for r in mesh.mesh[tuple(sel)].tolist()]
        self.index = int(coord[dim])
        self.size = len(self.ranks)


def _staged(group, device):
    """True where a tensor on `device` must cross host memory for the
    group's backend."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return False
    if backend == "gloo":
        return device.type != "cpu"
    raise ValueError(f"parallel: unsupported torch.distributed backend {backend!r} "
                     "(nccl or gloo)")


def _to_host(x):
    with span("nvdr.sync.gloo_to_host"):
        return x.cpu()


def _to_device(x, device):
    with span("nvdr.sync.gloo_to_device"):  # from pageable host memory
        return x.to(device)


@spanned("nvdr.collective.shift")
def shift(x, axis, step, tag):
    """The tensor of the rank `step` places further along `axis`
    (cyclically): this rank sends `x` to ranks[(index - step) % size] and
    receives from ranks[(index + step) % size]."""
    k, n = axis.index, axis.size
    x = x.contiguous()
    staged = _staged(axis.group, x.device)
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(k - step) % n], axis.group, tag),
           dist.P2POp(dist.irecv, recv, axis.ranks[(k + step) % n], axis.group, tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _to_device(recv, x.device) if staged else recv


BACKWARD_TAG = 64  # added to an exchange's tag for its transpose


class Shift(torch.autograd.Function):
    """``shift`` with its transpose as the backward: the cotangent goes
    `step` places back, under the exchange's tag plus BACKWARD_TAG."""

    @staticmethod
    def forward(ctx, x, axis, step, tag):
        ctx.meta = (axis, step, tag)
        return shift(x, axis, step, tag)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        axis, step, tag = ctx.meta
        return shift(g, axis, -step, tag + BACKWARD_TAG), None, None, None


@spanned("nvdr.collective.all_reduce")
def all_reduce_sum(tensors, group):
    """The sums over `group` of float tensors of one dtype and device, in
    one collective; returns new tensors shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = _staged(group, flat.device)
    buf = _to_host(flat) if staged else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        buf = _to_device(buf, flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class SumGrads(torch.autograd.Function):
    """Identity on tensors every rank of an axis holds the same copy of;
    backward sums their gradients over the axis (one collective)."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        return (None, *all_reduce_sum(gs, ctx.axis.group))


def replicated(mesh, axis_name, *xs):
    """`xs` as one band's inputs: the same tensors, whose gradients are
    summed over the mesh axis `axis_name` in backward (``shard_map``'s AD
    for replicated inputs). Returns a tuple, one tensor per input."""
    return SumGrads.apply(Axis(mesh, axis_name), *xs)
