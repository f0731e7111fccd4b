"""Spatial (row-band) parallelism: one large image across ranks.

Counterpart of ``nvdiffrast_tpu/parallel/spatial.py``. Each rank of the
"sp" axis holds the whole geometry and runs the whole single-device
pipeline, kernels included, on its own band of rows, through the ops'
``viewport=(y0, full_height)``: a band's ``rast`` and ``rast_db`` are bit
for bit the same rows of a single-process render.

rasterize, interpolate and texture are pixel-local, so they split for
free. antialias couples vertically adjacent pixels: pairs inside a band
run in the op itself (band edges fold as image borders), and the one row
of pairs across each band boundary runs in ``aa_boundary``, fed by a
one-row halo from the rank below; the part of its blend that belongs to
the neighbour's row goes back down.

Collectives (``collectives``), each a ``torch.autograd.Function`` whose
backward is the exchange along the inverse permutation:

* the halo: the next band's first colour and rast row, one message up
  (``HALO_TAG``); backward sends the colour cotangent down;
* the delta: the neighbour's share of the blend, one message down
  (``DELTA_TAG``); backward sends its cotangent up.

Both are cyclic on every rank; the last band masks its boundary pass
(``active``) and never skips an exchange, so every rank builds the same
graph. The gradients of the replicated inputs (positions, colours) are
summed over sp by ``collectives.replicated`` where a band takes them in.
Per step: B x W x (C + 4) and B x W x C floats each way forward, as many
backward, against the band's B x H/n x W pixels kept on its device.

Each rank sums its own rows' position gradients (float64 inside the
reductions) and the ranks' float32 partials are then summed, so images
and gradients are not bit for bit a single-process run's; they agree
within 1e-5.
"""

import torch
from torch.autograd.function import once_differentiable

from ..ops.antialias import (TopologyHashWrapper, _build_tables, antialias,
                             decode_aux, pair_alpha, pair_ids, pair_pos_grad)
from ..ops.gather import table_take
from ..ops.rasterize import xyw_rows_to_vertices
from ..ops.scatter import scatter_add_by_id
from ..ops.topology import build_opposite_table
from .collectives import Axis, Shift, replicated

HALO_TAG = 1   # the next band's first row, sent up
DELTA_TAG = 2  # the neighbour's share of the blend, sent down


# ---------------------------------------------------------------------------
# Boundary pass: the one row of vertical pixel pairs across a band
# boundary; the in-band pass's math (antialias, d = 1) on explicit top
# and bottom rows.
# ---------------------------------------------------------------------------

def _pixels(B, W, T, y0row, full_height, instance_mode, device):
    """(row offset of each pixel's table, fx, fy) of one image row."""
    N = B * W
    pix = torch.arange(N, dtype=torch.int32, device=device)
    rofs = (pix // W) * T if instance_mode else torch.zeros_like(pix)
    fx = (pix % W).to(torch.float32) + (0.5 - 0.5 * W)
    fy = torch.full((N,), y0row, dtype=torch.int32, device=device).to(torch.float32) \
        + (0.5 - 0.5 * full_height)
    return rofs, fx, fy


class _BoundaryFn(torch.autograd.Function):
    """aa_boundary with its hand-written backward (spatial.py:75-189 of
    the JAX package): gradients to the two colour rows and pos; the rast
    rows get none."""

    @staticmethod
    def forward(ctx, ctop, cbot, pos, rtop, rbot, tri, op_table, y0row, active,
                full_height, boost):
        B, W, C = ctop.shape
        N = B * W
        instance_mode = pos.ndim > 2
        ftable, btable, R, T = _build_tables(pos, tri, op_table, full_height, W)
        rofs, fx, fy = _pixels(B, W, T, y0row, full_height, instance_mode, ctop.device)
        tid, is_t1, act = pair_ids(rtop.reshape(N, 4)[:, 3], rbot.reshape(N, 4)[:, 3],
                                   rtop.reshape(N, 4)[:, 2], rbot.reshape(N, 4)[:, 2], T)
        act = act & bool(active)
        t7 = table_take(ftable, tid + rofs)
        alpha, di = pair_alpha([t7[k] for k in range(7)], fx, fy, is_t1, act, 1)

        ct = ctop.reshape(N, C)
        cb = cbot.reshape(N, C)
        apos = (alpha > 0)[:, None]
        contrib = alpha[:, None] * (cb - ct)
        dtop = torch.where(apos, contrib, 0.0).reshape(B, W, C)
        dbot = torch.where(apos, 0.0, contrib).reshape(B, W, C)
        aux = di.to(torch.float32) + 4.0 * is_t1.to(torch.float32)
        ctx.save_for_backward(ct, cb, rtop, rbot, tri, btable, alpha, aux)
        ctx.meta = (tuple(pos.shape), y0row, full_height, boost, R, T)
        return dtop, dbot

    @staticmethod
    @once_differentiable
    def backward(ctx, gtop_d, gbot_d):
        ct, cb, rtop, rbot, tri, btable, alpha, aux = ctx.saved_tensors
        pos_shape, y0row, full_height, boost, R, T = ctx.meta
        N, C = ct.shape
        B, W = rtop.shape[:2]
        instance_mode = len(pos_shape) > 2
        rofs, fx, fy = _pixels(B, W, T, y0row, full_height, instance_mode, ct.device)

        di, is_t1 = decode_aux(aux)
        act = alpha != 0.0
        idf = torch.where(is_t1, rbot.reshape(N, 4)[:, 3], rtop.reshape(N, 4)[:, 3])
        tsel = idf.to(torch.int32) - 1
        ok = act & (tsel >= 0) & (tsel < T)
        rid = torch.where(ok, tsel, 0) + rofs

        # v = alpha * pdy; g_ctop -= v, g_cbot += v (antialias.cu:449-462).
        apos = (alpha > 0)[:, None]
        pdy = torch.where(apos, gtop_d.reshape(N, C), gbot_d.reshape(N, C))
        v = alpha[:, None] * pdy
        g_ctop = (-v).reshape(B, W, C) if ctx.needs_input_grad[0] else None
        g_cbot = v.reshape(B, W, C) if ctx.needs_input_grad[1] else None
        g_pos = None
        if ctx.needs_input_grad[2]:
            dd = torch.where(act, torch.sum(pdy * (cb - ct), dim=1), 0.0)
            keep = ok & (dd != 0.0) & (alpha.abs() < 0.5)
            t9 = table_take(btable, rid)
            cols = pair_pos_grad([t9[k] for k in range(9)], dd, keep, di, is_t1, fx, fy,
                                 1, W, full_height)
            gtab = scatter_add_by_id(rid, torch.stack(cols), R)
            g_pos = xyw_rows_to_vertices(gtab, tri, pos_shape)
            if boost != 1.0:
                g_pos = g_pos * boost
        return (g_ctop, g_cbot, g_pos) + (None,) * 8


def aa_boundary(ctop, cbot, rtop, rbot, pos, tri, op_table, y0row, active, full_height,
                boost=1.0):
    """Blend deltas of one row of vertical pixel pairs across a band
    boundary.

    ctop, cbot: [B, W, C] colour rows (the band's last row, the next
    band's first row); rtop, rbot: [B, W, 4] their rast rows; pos [B, V,
    4] (instance mode) or [V, 4] (range mode); tri, op_table [T, 3];
    y0row: full-image index of the top row (an int); active: False gives
    zeros (the last band); full_height: the full image's height.

    Returns (dtop, dbot) [B, W, C]: the deltas to add to the top and the
    bottom row. Differentiable with respect to ctop, cbot and pos (times
    `boost`). Its table lookup is kernel B9 (``table_take``), the sum of
    its position-gradient rows kernel B10 (``scatter_add_by_id``).
    """
    return _BoundaryFn.apply(ctop, cbot, pos, rtop, rbot, tri, op_table, int(y0row),
                             bool(active), int(full_height), float(boost))


# ---------------------------------------------------------------------------
# antialias over a row band.
# ---------------------------------------------------------------------------

def antialias_sp(color, rast, pos, tri, mesh, full_height, topology_hash=None,
                 pos_gradient_boost=1.0, sp_axis="sp"):
    """Antialias this rank's row band of an image split over `sp_axis`.

    color/rast: [B, Hband, W, *], rank k of the axis holding rows [k
    Hband, (k + 1) Hband); pos/tri: the whole geometry, the same on every
    rank (sum its gradients over the axis with ``replicated`` where the
    band takes it in). The in-band pairs run in ``antialias`` under a
    viewport; the cross-band pairs in ``aa_boundary`` on a one-row halo.
    Returns this rank's rows of the single-process antialias of the full
    image, within float32 rounding.
    """
    axis = Axis(mesh, sp_axis)
    Hband = color.shape[1]
    y0 = axis.index * Hband
    tri = torch.as_tensor(tri, dtype=torch.int32, device=color.device)
    if topology_hash is not None:
        if not isinstance(topology_hash, TopologyHashWrapper):
            raise TypeError("antialias_sp: topology_hash must be a TopologyHashWrapper")
    else:
        topology_hash = TopologyHashWrapper(build_opposite_table(tri))
    out = antialias(color, rast, pos, tri, topology_hash=topology_hash,
                    pos_gradient_boost=pos_gradient_boost, viewport=(y0, full_height))
    if axis.size == 1:
        return out
    op_table = topology_hash.op_table.to(color.device)
    C = color.shape[-1]

    # Rank k receives row 0 of rank k + 1 (cyclic; the last band masks).
    halo = Shift.apply(torch.cat([color[:, 0], rast[:, 0].detach()], -1), axis, 1, HALO_TAG)
    dtop, dbot = aa_boundary(color[:, -1], halo[..., :C], rast[:, -1], halo[..., C:], pos,
                             tri, op_table, y0 + Hband - 1, axis.index < axis.size - 1,
                             full_height, boost=pos_gradient_boost)
    # The neighbour-row share goes back down one rank.
    dbot_recv = Shift.apply(dbot, axis, -1, DELTA_TAG)
    out = out.clone()
    out[:, -1] += dtop
    out[:, 0] += dbot_recv
    return out


def make_sp_render(mesh, tri, col_idx, resolution, sp_axis="sp"):
    """Row-band colour renderer: rasterize (viewport) + interpolate +
    ``antialias_sp``, one image split into bands over `sp_axis`.

    Returns render(pos [B, V, 4], col [V, C]) -> this rank's band [B, H /
    n, W, C] (rank k: rows [k H / n, (k + 1) H / n)). pos and col are the
    same on every rank; their gradients are summed over the axis, so each
    rank's are those of the whole image's loss when the loss is the sum
    of the bands' terms.
    """
    from ..ops.interpolate import interpolate
    from ..ops.rasterize import rasterize

    axis = Axis(mesh, sp_axis)
    H, W = (int(x) for x in resolution)
    if H % axis.size:
        raise ValueError(f"make_sp_render: H={H} not divisible by {sp_axis}={axis.size}")
    Hband = H // axis.size
    dev = torch.device(mesh.device_type)
    tri = torch.as_tensor(tri, dtype=torch.int32).to(dev)
    cidx = torch.as_tensor(col_idx, dtype=torch.int32).to(dev)
    topo = TopologyHashWrapper(build_opposite_table(tri))

    def render(pos, col):
        pos, col = replicated(mesh, sp_axis, pos, col)
        rast, _ = rasterize(None, pos, tri, (Hband, W), grad_db=False,
                            viewport=(axis.index * Hband, H))
        img, _ = interpolate(col[None], rast, cidx)
        return antialias_sp(img, rast, pos, tri, mesh, H, topology_hash=topo,
                            sp_axis=sp_axis)

    return render
