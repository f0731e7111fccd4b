"""What the ops derive from a mesh's index tensors (torch).

The one owner of the decisions about ``tri``, ``uv_tri`` and
``attr_idx``: the opposite-vertex table and its wrapper
(``TopologyHashWrapper``), the index range check, the per-triangle
tables the kernels gather from (attributes, clip-space vertices, the
antialias screen table) and the triangle-corner -> vertex sums of the
gradients. The entry modules import these from here; this module imports
none of them.

``build_opposite_table`` is ``nvdiffrast_tpu/ops/topology.py``'s table
bit for bit: all 3T directed edges are sorted by their canonical (vmin,
vmax) key, and per edge group the first two distinct opposing vertices
are kept. For triangle t and local edge e (e=0: {v1,v2} opp v0; e=1:
{v2,v0} opp v1; e=2: {v0,v1} opp v2), op[t, e] is the opposing vertex
of the other triangle sharing that edge, or -1 for a boundary or
silhouette candidate.
"""

import weakref

import torch

from ..utils.trace import span, spanned

_INT32_MAX = 2147483647


@spanned("nvdr.topology")
def build_opposite_table(tri, num_vertices=None):
    """Compute op[T, 3] opposing-vertex indices (-1 = none).

    Args:
      tri: [T, 3] int32 triangle vertex indices.
      num_vertices: optional count for corrupt-index rejection.

    Returns:
      [T, 3] int32 on tri's device.
    """
    tri = torch.as_tensor(tri, dtype=torch.int32)
    dev = tri.device
    T = tri.shape[0]
    if T == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    # Degenerate and negative-index triangles have no neighbours.
    ok = (v0 != v1) & (v1 != v2) & (v2 != v0)
    ok &= (v0 >= 0) & (v1 >= 0) & (v2 >= 0)
    if num_vertices is not None:
        ok &= (v0 < num_vertices) & (v1 < num_vertices) & (v2 < num_vertices)

    # Directed edge slots: slot = 3*t + e.
    ea = torch.stack([v1, v2, v0], dim=1).reshape(-1)
    eb = torch.stack([v2, v0, v1], dim=1).reshape(-1)
    vn = torch.stack([v0, v1, v2], dim=1).reshape(-1)  # own opposing vertex
    okf = ok.repeat_interleave(3)

    # Invalid slots get a sentinel key that groups them at the end.
    kmin = torch.where(okf, torch.minimum(ea, eb), _INT32_MAX)
    kmax = torch.where(okf, torch.maximum(ea, eb), _INT32_MAX)

    # Lexicographic sort on (kmin, kmax, vn): successive stable sorts
    # from the last key to the first.
    n = 3 * T
    order = torch.sort(vn, stable=True).indices
    order = order[torch.sort(kmax[order], stable=True).indices]
    order = order[torch.sort(kmin[order], stable=True).indices]
    kmin_s, kmax_s, vn_s, ok_s = kmin[order], kmax[order], vn[order], okf[order]

    idx = torch.arange(n, device=dev)
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    new_group[1:] = (kmin_s[1:] != kmin_s[:-1]) | (kmax_s[1:] != kmax_s[:-1])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1

    # Group start via a running max of the flagged positions.
    start = torch.cummax(torch.where(new_group, idx, 0), 0).values
    p0 = vn_s[start]  # smallest opposing vertex in the group

    # The first vn differing from p0 sits at start + count(vn == p0).
    eq0 = (vn_s == p0).to(torch.int32)
    n_eq0 = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, gid, eq0)
    gsize = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, gid, torch.ones_like(eq0))
    p1_pos = start + n_eq0[gid]
    has_p1 = p1_pos < start + gsize[gid]
    p1 = torch.where(has_p1, vn_s[torch.clamp(p1_pos, max=n - 1)], -1)

    # Each slot's partner is the stored vertex that is not its own.
    op = torch.where(p0 == vn_s, p1, torch.where(p1 == vn_s, p0, -1))
    op = torch.where(ok_s, op, -1).to(torch.int32)

    table = torch.empty(n, dtype=torch.int32, device=dev)
    table[order] = op
    return table.reshape(T, 3)


class TopologyHashWrapper:
    """Opaque topology table: op[T, 3] int32 opposite vertices.

    Accepts a tensor, or the JAX package's ``op_table`` as a numpy array
    (the same table; see ``build_opposite_table``), which is copied.
    """

    def __init__(self, op_table):
        if not isinstance(op_table, torch.Tensor):
            op_table = torch.tensor(op_table, dtype=torch.int32)
        self.op_table = torch.as_tensor(op_table, dtype=torch.int32)


def antialias_construct_topology_hash(tri):
    """Topology table for a triangle tensor [T, 3] int32."""
    return TopologyHashWrapper(build_opposite_table(tri))


def opposite_table(topology_hash, tri, what):
    """op[T, 3] of `tri` on its device: the table of `topology_hash`, or
    one built from `tri` when it is None. Anything else raises TypeError
    naming the entry `what`."""
    if topology_hash is None:
        return build_opposite_table(tri)
    if not isinstance(topology_hash, TopologyHashWrapper):
        raise TypeError(f"{what}: topology_hash must be a TopologyHashWrapper")
    return topology_hash.op_table.to(tri.device)


# Device index tensors found in range: (id, bound) -> (weak reference,
# version counter, storage address). The check reads the range back to
# the host (a sync); a tensor that is still the same object on the same
# storage, unmodified since (torch's in-place writes bump _version),
# needs no new one against the same bound. One tensor checked against
# two bounds (uv_tri is tri) keeps an entry for each.
_CHECKED = {}


def check_indices(idx, bound, what, site):
    """Raise ValueError, its message starting with `what`, unless every
    index of idx lies in [0, bound); the two reads are the spans
    ``nvdr.sync.<site>_min`` and ``_max``.

    A device tensor is checked once and then trusted while it keeps its
    version and storage: indices written into it by other means than
    torch ops (a foreign kernel, DLPack, ctypes) are not seen, and must
    not be written while it is in use. The setup kernel still makes a
    triangle with an index outside [0, V) invalid, but the torch gathers
    of the tables and the backward index with the indices unchecked."""
    if not idx.numel():
        return
    key = (id(idx), bound)
    seen = _CHECKED.get(key)
    if (idx.device.type != "cpu" and seen is not None and seen[0]() is idx
            and seen[1:] == (idx._version, idx.data_ptr())):
        return
    lo, hi = torch.aminmax(idx)
    with span(f"nvdr.sync.{site}_min"):
        lo = int(lo)
    with span(f"nvdr.sync.{site}_max"):
        hi = int(hi)
    if lo < 0 or hi >= bound:
        raise ValueError(f"{what} out of range [0, {bound}): min {lo}, max {hi}")
    if idx.device.type != "cpu":
        if len(_CHECKED) >= 64:
            _CHECKED.clear()
        _CHECKED[key] = (weakref.ref(idx), idx._version, idx.data_ptr())


# ---------------------------------------------------------------------------
# Per-triangle tables: column b*T + t holds triangle t of image b, a zero
# column last (the row of pixels without a triangle).
# ---------------------------------------------------------------------------

@spanned("nvdr.attr_table")
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


def vertex_table(pos, tri):
    """[9, B*T+1] (instance mode) or [9, T+1] (range mode, pos [V, 4])
    clip-space (x, y, w) of each triangle's vertices, row 3*k + c for
    vertex k, a zero column last."""
    tv = pos[..., tri.long(), :]
    tbl = torch.cat([tv[..., :2], tv[..., 3:]], dim=-1).reshape(-1, 9).T
    return torch.cat([tbl, tbl.new_zeros((9, 1))], dim=1).contiguous()


def _same_sign(a, b):
    # Sign-BIT comparison on the int32 bitcast: +0.0 and -0.0 differ.
    return (a.view(torch.int32) ^ b.view(torch.int32)) >= 0


@spanned("nvdr.aa.tables")
def _build_tables(pos, tri, op_table, H, W):
    """Per-triangle antialias tables (channel-major) + a dummy zero
    column (antialias.py:312-401 of the JAX package).

    pos [B, V, 4] (instance mode) or [V, 4] (range mode: one table),
    tri/op_table [T, 3]; H: the full image height under a viewport.
    Returns (ftable [7, B*T+1], btable [9, B*T+1], R = B*T, T), B = 1 in
    range mode. ftable holds each triangle's screen vertices (SX*3,
    SY*3) and its wing-sign bitmask: the silhouette test is
    pixel-independent, so it is evaluated once per triangle. btable is
    the clip (x, y, w) ``vertex_table``.
    """
    T = tri.shape[0]
    btable = vertex_table(pos, tri)
    R = btable.shape[1] - 1
    # Each edge's opposite vertex, the triangle's own where it has none:
    # [3 vertices, 4, R].
    ov = torch.where(op_table >= 0, op_table, tri).long()
    o = pos[..., ov, :].reshape(R, 3, 4).permute(1, 2, 0)
    xh = 0.5 * W
    yh = 0.5 * H

    def screen(x, y, w):  # screen (x, y) of the 3 vertices, [3, R] each
        iw = 1.0 / w
        return x * iw * xh, y * iw * yh

    sx, sy = screen(btable[0:9:3, :R], btable[1:9:3, :R], btable[2:9:3, :R])
    ox, oy = screen(o[:, 0], o[:, 1], o[:, 3])

    bb = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0])
    a0 = (sx[1] - ox[0]) * (sy[2] - oy[0]) - (sx[2] - ox[0]) * (sy[1] - oy[0])
    a1 = (sx[2] - ox[1]) * (sy[0] - oy[1]) - (sx[0] - ox[1]) * (sy[2] - oy[1])
    a2 = (sx[0] - ox[2]) * (sy[1] - oy[2]) - (sx[1] - ox[2]) * (sy[0] - oy[2])
    sbits = (_same_sign(a0, bb).to(torch.float32)
             + 2.0 * _same_sign(a1, bb).to(torch.float32)
             + 4.0 * _same_sign(a2, bb).to(torch.float32))

    ftable = torch.cat([sx, sy, sbits[None]])
    return torch.cat([ftable, ftable.new_zeros((7, 1))], dim=1), btable, R, T


# ---------------------------------------------------------------------------
# Triangle-corner rows -> vertex rows (the gradients' deterministic sums).
# ---------------------------------------------------------------------------

def _corner_table(idx, V):
    """[V, D] corner ids 3*t + k of each vertex, ascending, padded with
    3T (a zero row of `_vertex_sum`); D is the largest vertex degree."""
    flat = idx.reshape(-1).long()
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    # On the card bincount reads the ids' min and max back: two syncs.
    with span("nvdr.sync.corner_count_min"), span("nvdr.sync.corner_count_max"):
        counts = torch.bincount(flat, minlength=V)
    with span("nvdr.sync.corner_degree"):
        D = int(counts.max()) if n else 0
    slot = torch.arange(D, device=idx.device)
    pos = (torch.cumsum(counts, 0) - counts)[:, None] + slot
    has = slot < counts[:, None]
    return torch.where(has, order[pos.clamp(max=max(n - 1, 0))], n)


def _vertex_sum(rows, corners):
    """Triangle-corner rows [B, 3T, F] -> vertex rows [B, V, F].

    A gather and a dense sum over each vertex's corners: no scatter and
    no atomics, so the result is the same on every run and device.
    """
    zero = rows.new_zeros((rows.shape[0], 1, rows.shape[2]))
    return torch.cat([rows, zero], dim=1)[:, corners].sum(2)


@spanned("nvdr.vertex_sums")
def vertex_attr_grad(ga, atri, attr_shape, B):
    """Triangle-corner attribute rows [B*T, 3A] -> the gradient shaped
    like attr; broadcast attributes sum the batch first."""
    T = atri.shape[0]
    A = attr_shape[-1]
    ga = ga.reshape(B, 3 * T, A)
    acorners = _corner_table(atri, attr_shape[-2])
    if len(attr_shape) == 2 or attr_shape[0] == 1:  # broadcast attributes
        return _vertex_sum(ga.sum(0, keepdim=True), acorners).reshape(attr_shape)
    return _vertex_sum(ga, acorners)


@spanned("nvdr.vertex_sums")
def vertex_pos_grad(gt, tri, pos_shape, gaa=None, boost=1.0):
    """Triangle-corner clip-space rows [B*T, 9] (x, y, w of each vertex)
    -> g_pos pos_shape, [B, V, 4] or, in range mode, [V, 4]; z gets
    none. With antialias rows gaa [B*T, 9] both share one corner table
    and one vertex sum, and the antialias part is times boost."""
    B, V = (1, pos_shape[0]) if len(pos_shape) == 2 else pos_shape[:2]
    rows = gt.reshape(B, 3 * tri.shape[0], 3)
    if gaa is not None:
        rows = torch.cat([rows, gaa.reshape(rows.shape)], dim=2)
    gv = _vertex_sum(rows, _corner_table(tri, V))
    if gaa is not None:
        g_aa = gv[..., 3:] * boost if boost != 1.0 else gv[..., 3:]
        gv = gv[..., :3] + g_aa
    z = gv.new_zeros(gv.shape[:-1] + (1,))
    return torch.cat([gv[..., :2], z, gv[..., 2:]], dim=-1).reshape(pos_shape)
