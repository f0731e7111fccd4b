"""Cube-map sampler, forward and backward: two CUDA kernels (torch).

Counterpart of ``nvdiffrast_tpu/ops/texture_pallas.py``'s ``_call_cube``
(B12; kernel body ``_build_cube_kernel``) in its modes:

* ``sample_cube`` (kernel ``csrc/texture_cube.cu``, ``cube_fwd``):
  seamless cube-map samples [C, N] of the flat-packed 6-face pyramid at
  per-pixel face coordinates (s, t), mip level, validity, face and
  texture index, with the linear, linear-mipmap-nearest and
  linear-mipmap-linear filters: corners that fall off a face wrap to the
  neighbour face, a missing cube-corner texel takes the average of the
  other three, an invalid direction gives zeros;
* ``cube_bwd`` (kernel ``cube_bwd``): the gradients (gs, gt, gfl) of the
  samples to s, t and the level from the colour cotangent.

``sample_cube_plain`` and ``cube_bwd_plain`` are their plain PyTorch
twins with the same arithmetic. The texture gradient is no kernel of its
own, as in the JAX package (``_sample_cube_bwd``): ``cube_grad_entries``
recomputes each tap's texel and effective weight, and
``scatter.scatter_add_by_id`` (B10, ``csrc/scatter_rows.cu``) sums them.
The seam wrap sends corners to other faces, so the lattice reduction of
the 2-D texture (B13) does not apply.

CPU tensors run the twins; CUDA tensors launch the kernels or raise.
"""

import ctypes

import torch

from .. import _build
from .scatter import scatter_add_by_id
from .texture_cube import cube_corner_setup
from .texture_cuda import FILTER, MAX_C, MAX_LEVELS, level_weights

FWD_KERNEL = _build.Kernel(
    "nvdr_texture_cube_fwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4)

BWD_KERNEL = _build.Kernel(
    "nvdr_texture_cube_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4)


def _check(flat, cols, meta, filter_mode, dy=None):
    s, t, flevel, finite, face, tz = cols
    n_tex, C = flat.shape
    N = s.shape[0]
    L = len(meta)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sample_cube: {C} channels; the sampler serves 1 to {MAX_C}")
    if not 1 <= L <= MAX_LEVELS or filter_mode not in FILTER:
        raise ValueError(f"sample_cube: {L} levels, filter {filter_mode!r}")
    if any(x.shape != (N,) for x in cols):
        raise ValueError(f"sample_cube: s, t, flevel, finite, face, tz must be flat [{N}]")
    if any(x.dtype != torch.float32 for x in (flat, s, t, flevel)) or any(
            x.dtype != torch.int32 for x in (finite, face, tz)):
        raise ValueError("sample_cube: float32 pyramid, s, t, flevel; int32 finite, face, tz")
    if any(x.device != flat.device for x in cols):
        raise ValueError("sample_cube: tensors on several devices")
    if n_tex * C >= 2 ** 31:
        raise ValueError("sample_cube: pyramid of 2**31 floats or more")
    for off, h, w in meta:
        if h != w or off < 0 or off + 6 * w * w > n_tex:
            raise ValueError(f"sample_cube: level ({off}, {h}, {w}) outside the "
                             f"{n_tex}-texel pyramid or not square")
    if dy is not None and (dy.shape != (C, N) or dy.dtype != torch.float32
                           or dy.device != flat.device):
        raise ValueError(f"cube_bwd: dy must be float32 [{C}, {N}] on the pyramid's device")
    return C, N, L


def _args(flat, cols, meta):
    m = (ctypes.c_int * (3 * len(meta)))(*(x for lev in meta for x in lev))
    return ([_build.ptr(flat)] + [_build.ptr(x) for x in cols],
            ctypes.cast(m, ctypes.c_void_p))


def sample_cube(flat, cols, meta, filter_mode):
    """Cube-map samples [C, N].

    Args:
      flat: [n_texels, C] texel-major pyramid of [D, 6, w, w, C] levels
        (texture._pack_pyramid).
      cols: (s, t, flevel, finite, face, tz), flat [N]: face coordinates
        in [0, 1] and level (float32; flevel unread by 'linear'), the
        validity, face and texture index (int32).
      meta: ((offset, w, w), ...) per level (texture._static_meta).
    """
    if flat.device.type == "cpu":
        return sample_cube_plain(flat, cols, meta, filter_mode)
    if flat.device.type != "cuda":
        raise ValueError(f"sample_cube: unsupported device {flat.device}")
    flat = flat.contiguous()
    cols = tuple(x.contiguous() for x in cols)
    C, N, L = _check(flat, cols, meta, filter_mode)
    out = torch.empty((C, N), dtype=torch.float32, device=flat.device)
    ptrs, m = _args(flat, cols, meta)
    FWD_KERNEL.launch(flat.device, *ptrs, _build.ptr(out), m, N, C, L, FILTER[filter_mode])
    return out


def cube_bwd(flat, cols, dy, meta, filter_mode):
    """(gs, gt, gfl) flat [N]: gradients of ``sample_cube`` to s, t and
    flevel from the cotangent dy [C, N]."""
    if flat.device.type == "cpu":
        return cube_bwd_plain(flat, cols, dy, meta, filter_mode)
    if flat.device.type != "cuda":
        raise ValueError(f"cube_bwd: unsupported device {flat.device}")
    flat, dy = flat.contiguous(), dy.contiguous()
    cols = tuple(x.contiguous() for x in cols)
    C, N, L = _check(flat, cols, meta, filter_mode, dy)
    out = torch.empty((3, N), dtype=torch.float32, device=flat.device)
    ptrs, m = _args(flat, cols, meta)
    BWD_KERNEL.launch(flat.device, *ptrs, _build.ptr(dy), _build.ptr(out), m, N, C, L,
                      FILTER[filter_mode])
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

def _level_taps(flat, s, t, face, tz, lev, meta):
    """Corners of the per-pixel level `lev`: (q, ok4, fu, fv, w4, ids,
    wl) with q the four corner texels [C, N] and ids their rows of the
    pyramid."""
    offs = torch.tensor([m[0] for m in meta], dtype=torch.int64, device=s.device)
    ws = torch.tensor([m[2] for m in meta], dtype=torch.int64, device=s.device)
    wl = ws[lev]
    rows4, cols4, ok4, fu, fv, w4 = cube_corner_setup(s, t, face.long(), wl)
    base = offs[lev] + tz.long() * (6 * wl * wl)
    ids = [base + r * wl + c for r, c in zip(rows4, cols4)]
    q = [flat[i].T for i in ids] if flat is not None else None
    return q, ok4, fu, fv, w4, ids, wl


def _fill_corners(q, ok4):
    """The average-of-3 rule: a missing corner takes the mean of the
    valid ones."""
    n_ok = torch.clamp(((ok4[0] + ok4[1]) + ok4[2]) + ok4[3], min=1.0)
    avg = (((ok4[0] * q[0] + ok4[1] * q[1]) + ok4[2] * q[2]) + ok4[3] * q[3]) / n_ok
    return [torch.where(ok > 0, qk, avg) for qk, ok in zip(q, ok4)]


def sample_cube_plain(flat, cols, meta, filter_mode):
    """Plain PyTorch twin of the cube_fwd kernel (same arithmetic)."""
    C, N, L = _check(flat, cols, meta, filter_mode)
    s, t, flevel, finite, face, tz = cols
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    fin = finite != 0

    def term(lev):
        wgt = (torch.where(lev == l0, 1.0 - frac, 0.0)
               + torch.where(lev == l1, frac, 0.0))
        q, ok4, _, _, w4, _, _ = _level_taps(flat, s, t, face, tz, lev, meta)
        qq = _fill_corners(q, ok4)
        val = ((w4[0] * qq[0] + w4[1] * qq[1]) + w4[2] * qq[2]) + w4[3] * qq[3]
        return torch.where(fin, wgt * val, 0.0)

    out = torch.zeros((C, N), dtype=torch.float32, device=flat.device) + term(l0)
    if filter_mode == "linear-mipmap-linear":
        out = out + torch.where(l1 != l0, term(l1), 0.0)
    return out


def cube_bwd_plain(flat, cols, dy, meta, filter_mode):
    """Plain PyTorch twin of the cube_bwd kernel (same arithmetic)."""
    C, N, L = _check(flat, cols, meta, filter_mode, dy)
    s, t, flevel, finite, face, tz = cols
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    fin = finite != 0

    def term(lev):
        on0, on1 = lev == l0, lev == l1
        wgt = torch.where(on0, 1.0 - frac, 0.0) + torch.where(on1, frac, 0.0)
        q, ok4, fu, fv, w4, _, wl = _level_taps(flat, s, t, face, tz, lev, meta)
        qq = _fill_corners(q, ok4)
        dqu = (1.0 - fv) * (qq[1] - qq[0]) + fv * (qq[3] - qq[2])
        dqv = (1.0 - fu) * (qq[2] - qq[0]) + fu * (qq[3] - qq[1])
        val = ((w4[0] * qq[0] + w4[1] * qq[1]) + w4[2] * qq[2]) + w4[3] * qq[3]
        gu = torch.zeros_like(s)
        gv = torch.zeros_like(s)
        gl = torch.zeros_like(s)
        for c in range(C):
            gu = gu + dy[c] * dqu[c]
            gv = gv + dy[c] * dqv[c]
            gl = gl + dy[c] * val[c]
        wf = wl.to(torch.float32)
        dwdf = on1.to(torch.float32) - on0.to(torch.float32)
        return (torch.where(fin, wgt * gu * wf, 0.0), torch.where(fin, wgt * gv * wf, 0.0),
                torch.where(fin, dwdf * gl, 0.0))

    g = [torch.zeros_like(s) + x for x in term(l0)]
    if filter_mode == "linear-mipmap-linear":
        g = [a + torch.where(l1 != l0, b, 0.0) for a, b in zip(g, term(l1))]
    return tuple(g)


# ---------------------------------------------------------------------------
# Gradient of the pyramid.
# ---------------------------------------------------------------------------

def cube_grad_entries(cols, meta, filter_mode):
    """The texture-gradient taps of every pixel (``_sample_cube_bwd``):
    (ids [S*4*N] int32, w [S*4*N] float32) for S mip slots, slot-major
    then corner-major. A tap adds w * dy to texel id; the effective
    weight folds in the average-of-3 rule,

        w_eff[j] = w_j ok_j + ok_j / n_ok * sum_i w_i (1 - ok_i),

    times the validity and the slot's level weight. Invalid pixels have
    zero weights, which the scatter's live filter drops."""
    s, t, flevel, finite, face, tz = cols
    L = len(meta)
    l0, l1, frac = level_weights(flevel, L, filter_mode)
    if filter_mode == "linear-mipmap-linear":
        slots = ((l0, 1.0 - frac), (l1, frac))
    else:
        slots = ((l0, torch.ones_like(frac)),)
    fin = finite.to(torch.float32)
    ids, wts = [], []
    for lsel, lw in slots:
        _, ok4, _, _, w4, ids4, _ = _level_taps(None, s, t, face, tz, lsel, meta)
        inv_w = ((w4[0] * (1.0 - ok4[0]) + w4[1] * (1.0 - ok4[1]))
                 + w4[2] * (1.0 - ok4[2])) + w4[3] * (1.0 - ok4[3])
        n_ok = torch.clamp(((ok4[0] + ok4[1]) + ok4[2]) + ok4[3], min=1.0)
        for k in range(4):
            w_eff = (w4[k] * ok4[k] + ok4[k] / n_ok * inv_w) * fin
            ids.append(ids4[k])
            wts.append(w_eff * lw)
    return torch.cat(ids).to(torch.int32), torch.cat(wts)


def cube_texture_grad(cols, dy, meta, n_texels, filter_mode):
    """Gradient of the packed cube pyramid [n_texels, C] from dy [C, N]:
    the taps of ``cube_grad_entries`` summed by B10 (float64 sums in a
    fixed order on the card; the plain twin's index_add_ on the CPU)."""
    ids, w = cube_grad_entries(cols, meta, filter_mode)
    vals = (dy.repeat(1, w.shape[0] // dy.shape[1]) * w).contiguous()
    return scatter_add_by_id(ids, vals, n_texels)
