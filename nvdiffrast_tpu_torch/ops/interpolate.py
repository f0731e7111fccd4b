"""Differentiable attribute interpolation (torch).

Counterpart of ``nvdiffrast_tpu/ops/interpolate.py``: ``interpolate`` is
a ``torch.autograd.Function``. Its forward runs kernel B5
(``interpolate_cuda.interp_forward``), its backward kernel B6
(``interpolate_cuda.interp_backward``) and then the reduction of the
per-pixel attribute gradients to triangle rows (``scatter``, kernel B10)
and the deterministic triangle -> vertex sums
(``topology.vertex_attr_grad``).
Attributes past the kernels' 16 run as further chunks of 16 through the
same kernels. The bary gradients land in rast channels 0-1 (2-3 stay
zero) and, with ``diff_attrs``, the db gradients in ``rast_db``.
"""

import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import spanned
from .interpolate_cuda import MAX_A, interp_backward, interp_forward
from .rasterize import as_device_tensor, pixel_rows
from .scatter import scatter_add_by_id
from .topology import _attr_table, vertex_attr_grad


def _chunks(A, diff_list):
    """(a0, a1, [(jj, j - a0), ...]) for each run of MAX_A attributes:
    the diff_list entries jj whose attribute j lies in [a0, a1)."""
    for a0 in range(0, A, MAX_A):
        a1 = min(A, a0 + MAX_A)
        yield a0, a1, [(jj, j - a0) for jj, j in enumerate(diff_list) if a0 <= j < a1]


def _sub_table(tbl, A, a0, a1):
    """Rows of attributes [a0, a1) of a [3A, R+1] table, same layout."""
    if (a0, a1) == (0, A):
        return tbl
    return torch.cat([tbl[k * A + a0:k * A + a1] for k in range(3)])


def interp_forward_flat(tbl, u, v, idf, db, diff_list, T, hw):
    """interp_forward over any number of attributes: (out [A, N],
    da [2D, N]), chunks of MAX_A through the kernel."""
    A = tbl.shape[0] // 3
    if A <= MAX_A:
        return interp_forward(tbl, u, v, idf, db, diff_list, T, hw)
    outs = []
    das = [None] * len(diff_list)
    for a0, a1, sub in _chunks(A, diff_list):
        out, da = interp_forward(_sub_table(tbl, A, a0, a1), u, v, idf, db,
                                 [j for _, j in sub], T, hw)
        outs.append(out)
        for i, (jj, _) in enumerate(sub):
            das[jj] = da[2 * i:2 * i + 2]
    da = torch.cat(das) if das else u.new_zeros((0, u.shape[0]))
    return torch.cat(outs), da


def interp_backward_flat(tbl, u, v, idf, db, gy, gda, diff_list, T, hw):
    """interp_backward over any number of attributes: (grast [2, N],
    gval [3A, N], gdb [4, N] or None); chunks after the first add to the
    first's bary and db gradients."""
    A = tbl.shape[0] // 3
    if A <= MAX_A:
        return interp_backward(tbl, u, v, idf, db, gy, gda, diff_list, T, hw)
    grast = None
    gdb = u.new_zeros((4, u.shape[0])) if diff_list else None
    parts = []
    for a0, a1, sub in _chunks(A, diff_list):
        sub_gda = (torch.cat([gda[2 * jj:2 * jj + 2] for jj, _ in sub]) if sub
                   else None)
        grast, gval, gdb = interp_backward(
            _sub_table(tbl, A, a0, a1), u, v, idf, db, gy[a0:a1], sub_gda,
            [j for _, j in sub], T, hw, grast, gdb)
        parts.append(gval.reshape(3, a1 - a0, -1))
    return grast, torch.cat(parts, dim=1).reshape(3 * A, -1), gdb


def _split_rast(rast, rast_db, D):
    N = rast.shape[0] * rast.shape[1] * rast.shape[2]
    flats = rast.reshape(N, 4).T
    db = tuple(rast_db.reshape(N, 4).T) if D else None
    return flats[0], flats[1], flats[3], db


class _InterpolateFn(torch.autograd.Function):
    """interpolate with its hand-written backward."""

    @staticmethod
    def forward(ctx, attr, rast, rast_db, tri, diff_list):
        B, H, W, _ = rast.shape
        A = attr.shape[-1]
        T = tri.shape[0]
        D = len(diff_list)
        per_image = attr.ndim == 3 and attr.shape[0] != 1
        hw = H * W if per_image else 0
        tbl = _attr_table(attr, tri, B if per_image else 1, T)
        u, v, idf, db = _split_rast(rast, rast_db, D)
        out, da = interp_forward_flat(tbl, u, v, idf, db, diff_list, T, hw)
        ctx.save_for_backward(tbl, tri, rast, rast_db if D else None)
        ctx.meta = (diff_list, hw, tuple(attr.shape))
        ctx.set_materialize_grads(False)
        return (out.T.reshape(B, H, W, A), da.T.reshape(B, H, W, 2 * D))

    @staticmethod
    @once_differentiable
    @spanned("nvdr.interpolate.bwd")
    def backward(ctx, gy, gda):
        tbl, tri, rast, rast_db = ctx.saved_tensors
        diff_list, hw, attr_shape = ctx.meta
        B, H, W, _ = rast.shape
        N = B * H * W
        A = attr_shape[-1]
        D = len(diff_list)
        T = tri.shape[0]
        gy = rast.new_zeros((A, N)) if gy is None else gy.reshape(N, A).T.contiguous()
        if D:
            gda = (rast.new_zeros((2 * D, N)) if gda is None
                   else gda.reshape(N, 2 * D).T.contiguous())
        u, v, idf, db = _split_rast(rast, rast_db, D)
        grast, gval, gdb = interp_backward_flat(tbl, u, v, idf, db, gy,
                                                gda if D else None, diff_list, T, hw)
        g_attr = None
        if ctx.needs_input_grad[0]:
            rows = tbl.shape[1] - 1
            rid = pixel_rows(idf, T, hw, rows)
            g_attr = vertex_attr_grad(scatter_add_by_id(rid, gval, rows), tri, attr_shape,
                                      rows // T)
        g_rast = None
        if ctx.needs_input_grad[1]:
            z = torch.zeros_like(grast)
            g_rast = torch.cat([grast, z]).T.reshape(B, H, W, 4)
        g_db = None
        if D and ctx.needs_input_grad[2]:
            g_db = gdb.T.reshape(B, H, W, 4)
        return g_attr, g_rast, g_db, None, None


@spanned("nvdr.interpolate")
def interpolate(attr, rast, tri, rast_db=None, diff_attrs=None):
    """Interpolate vertex attributes.

    Args:
        attr: [minibatch, V, A] (one table per image), [1, V, A] or
            [V, A] (one table for all images) float32 attributes.
        rast: [minibatch, H, W, 4] output of ``rasterize``. A tensor runs
            on its device (CPU tensors on the plain twins); anything else
            is put on the default CUDA device, and raises RuntimeError
            where there is none.
        tri: [T, 3] int32 triangles.
        rast_db: [minibatch, H, W, 4] second output of ``rasterize``;
            needed with ``diff_attrs``.
        diff_attrs: None, 'all', or a list of attribute indices (negative
            ones count from the end) whose screen derivatives to compute.

    Returns:
        (out [minibatch, H, W, A], out_da [minibatch, H, W, 2D]) with
        (dA/dX, dA/dY) pairs; out_da is zero-width without diff_attrs.
        Differentiable with respect to attr, rast (channels 0-1) and
        rast_db.
    """
    rast = as_device_tensor(rast, "interpolate")
    dev = rast.device
    attr = torch.as_tensor(attr, dtype=torch.float32, device=dev)
    tri = torch.as_tensor(tri, dtype=torch.int32, device=dev)
    if rast.ndim != 4 or rast.shape[-1] != 4:
        raise ValueError("interpolate: rast must be float32 [minibatch, H, W, 4]; "
                         f"got {tuple(rast.shape)}")
    B = rast.shape[0]
    if attr.ndim not in (2, 3) or (attr.ndim == 3 and attr.shape[0] not in (1, B)):
        raise ValueError("interpolate: attr must be [minibatch or 1, V, A] or [V, A]; "
                         f"got {tuple(attr.shape)}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"interpolate: tri must be [T, 3]; got {tuple(tri.shape)}")
    A = attr.shape[-1]
    if diff_attrs is None:
        diff_list = ()
    elif diff_attrs == "all":
        diff_list = tuple(range(A))
    else:
        diff_list = tuple(int(j) + (A if int(j) < 0 else 0) for j in diff_attrs)
        if any(not 0 <= j < A for j in diff_list):
            raise ValueError(f"interpolate: diff_attrs {list(diff_attrs)} out of "
                             f"range for {A} attributes")
    if diff_list and rast_db is None:
        raise ValueError("interpolate: diff_attrs requires rast_db")
    if diff_list:
        rast_db = torch.as_tensor(rast_db, dtype=torch.float32, device=dev)
        if rast_db.shape != rast.shape:
            raise ValueError(f"interpolate: rast_db must be {tuple(rast.shape)}; got "
                             f"{tuple(rast_db.shape)}")
    else:
        rast_db = None
    return _InterpolateFn.apply(attr, rast, rast_db, tri, diff_list)
