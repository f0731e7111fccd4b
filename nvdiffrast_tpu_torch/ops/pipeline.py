"""Fused rasterize -> interpolate -> antialias render, forward (torch).

Counterpart of ``nvdiffrast_tpu/ops/pipeline.py``. ``render_pipeline``
renders ``antialias(interpolate(attr, rast, attr_idx)[0], rast, pos,
tri)`` with two kernels: the rasterizer (``rasterize_cuda``) and the
fused interpolate + antialias shade (``pipeline_cuda.shade_fwd``), with
plain tensor glue around them. It runs on the device of ``pos``: CPU
tensors take the plain PyTorch twins, CUDA tensors the kernels.

Forward only: gradients (the ``pipeline_bwd`` and
``pipeline_grad_scatter`` kernels) are the next item of ROADMAP.md.
"""

import numpy as np
import torch

from .antialias import TopologyHashWrapper, _build_tables
from .pipeline_cuda import MAX_A, shade_fwd
from .rasterize_cuda import rasterize_fused
from .topology import build_opposite_table

_NO_GRAD_MSG = (
    "render_pipeline: gradients are not ported yet. The backward kernels "
    "pipeline_bwd and pipeline_grad_scatter (ROADMAP.md, queue A item 1 "
    "and queue B items 3-4) come next; call under torch.no_grad() or "
    "pass tensors that do not require grad.")


def _attr_table(attr, atri, B, T):
    """[3A, B*T + 1] attribute table (dummy zero column last).

    Row k*A + a holds channel a of the triangle's vertex k. Broadcast
    attributes ([V, A] or [1, V, A]) are tiled over the B images so all
    gathers share the row offset b*T.
    """
    A = attr.shape[-1]
    atri = atri.long()
    if attr.ndim == 3 and attr.shape[0] != 1:
        tbl = attr[:, atri].reshape(-1, 3 * A).T  # [3A, B*T]
    else:
        a2d = attr[0] if attr.ndim == 3 else attr
        tbl = a2d[atri].reshape(-1, 3 * A).T  # [3A, T]
        if B > 1:
            tbl = tbl.repeat(1, B)
    zcol = torch.zeros((3 * A, 1), dtype=torch.float32, device=attr.device)
    return torch.cat([tbl, zcol], dim=1).contiguous()


def _pipeline_fwd_core(pos, attr, tri, atri, op_table, resolution):
    """Forward core: (color [B, H, W, A], saved) where saved holds the
    per-pixel buffers and residuals the backward will consume."""
    H, W = resolution
    B = pos.shape[0]
    T = tri.shape[0]
    A = attr.shape[-1]
    N = B * H * W

    u, v, zw, idf = rasterize_fused(pos, tri, resolution)
    b0f = u.reshape(N)
    b1f = v.reshape(N)
    zwf = zw.reshape(N)
    idff = idf.reshape(N)

    atbl = _attr_table(attr, atri, B, T)
    ftable, _btable, _R, _T = _build_tables(pos, tri, op_table, H, W)
    out_cols, c0, res = shade_fwd(atbl, ftable, b0f, b1f, zwf, idff,
                                  resolution, T)
    color = out_cols.T.reshape(B, H, W, A)
    return color, (b0f, b1f, idff, c0, res)


def render_pipeline(pos, tri, attr, resolution, attr_idx=None,
                    topology_hash=None):
    """Render the fused rasterize + interpolate + antialias pipeline.

    Equivalent to::

        rast, _ = rasterize(None, pos, tri, resolution, grad_db=False)
        color, _ = interpolate(attr, rast, attr_idx or tri)
        out = antialias(color, rast, pos, tri, topology_hash)

    Args:
        pos: [minibatch, num_vertices, 4] float32 clip-space positions
            (a tensor; its device is where the render runs).
        tri: [num_triangles, 3] int32.
        attr: [minibatch or 1, num_vertices_attr, A] or
            [num_vertices_attr, A] float32 vertex attributes, A <= 8.
        resolution: (height, width).
        attr_idx: triangle tensor for the attribute topology (defaults
            to `tri`; must have the same number of triangles).
        topology_hash: optional TopologyHashWrapper for `tri`.

    Returns:
        Antialiased color image [minibatch, height, width, A].
    """
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(np.asarray(pos, np.float32))
    dev = pos.device
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    attr = torch.as_tensor(attr, dtype=torch.float32, device=dev)
    atri = tri if attr_idx is None else torch.as_tensor(
        attr_idx, dtype=torch.int32, device=dev)
    resolution = tuple(int(x) for x in resolution)

    if torch.is_grad_enabled() and (pos.requires_grad or attr.requires_grad):
        raise NotImplementedError(_NO_GRAD_MSG)
    if pos.ndim != 3:
        raise NotImplementedError(
            "render_pipeline: only instance mode ([minibatch, V, 4] pos) "
            "is ported")
    if atri.shape[0] != tri.shape[0]:
        raise ValueError(
            f"render_pipeline: attr_idx triangle count {atri.shape[0]} "
            f"must match tri {tri.shape[0]}")
    if attr.ndim not in (2, 3) or (attr.ndim == 3
                                   and attr.shape[0] not in (1, pos.shape[0])):
        raise ValueError(
            "render_pipeline: attr must be [minibatch or 1, V, A] or [V, A]; "
            f"got {tuple(attr.shape)}")
    A = attr.shape[-1]
    if not 1 <= A <= MAX_A:
        raise NotImplementedError(
            f"render_pipeline: {A} attribute channels; the fused kernel "
            f"serves 1 to {MAX_A}")

    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("render_pipeline: topology_hash must be a "
                            "TopologyHashWrapper")
        op_table = topology_hash.op_table.to(dev)
    else:
        op_table = build_opposite_table(tri)

    color, _ = _pipeline_fwd_core(pos, attr, tri, atri, op_table, resolution)
    return color
