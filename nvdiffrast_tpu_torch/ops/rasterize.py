"""Rasterize helpers shared by the port's rasterizer (torch).

Counterparts of parts of ``nvdiffrast_tpu/ops/rasterize.py``: the
correctly-rounded edge coefficient product, the near-plane epsilon, the
context class and the argument checks of instance mode. The rasterizer
itself is ``rasterize_cuda.rasterize_fused``.
"""

import torch

# Triangles are clipped against w >= _W_CLIP_EPS (near plane guard).
_W_CLIP_EPS = 1e-9


class RasterizeCudaContext:
    """Stateless rasterizer context, kept for API parity.

    All state lives in tensors; the object only carries the device and
    the active depth peeler slot of the reference's API.
    """

    def __init__(self, device=None):
        self.device = device
        self.active_depth_peeler = None


def _dop(a, b, c, d):
    """Correctly-rounded f32 difference of products fl(a*b - c*d).

    Both f32 products are exact in f64 (24+24 <= 53 mantissa bits), so
    the single f64 subtraction rounds once and the f64->f32 convert
    rounds again, deterministically, as the JAX package does. The two
    triangles sharing an edge see bitwise opposite coefficients, and a
    bitwise-duplicate (x, y, w) vertex pair gets exact zeros.
    """
    a, b, c, d = (t.to(torch.float64) for t in (a, b, c, d))
    return (a * b - c * d).to(torch.float32)


def _check_rasterize_args(pos, tri, resolution):
    """Shape, dtype and index checks of instance mode.

    Raises ValueError for a malformed call and NotImplementedError for
    range mode (2-D pos), which this port does not have yet.
    """
    if pos.ndim == 2:
        raise NotImplementedError(
            "rasterize: range mode (2-D pos) is not ported yet; pass "
            "[minibatch, num_vertices, 4] positions")
    if pos.ndim != 3 or pos.shape[-1] != 4 or pos.shape[-2] == 0:
        raise ValueError(
            "rasterize: pos must be [minibatch, num_vertices, 4]; "
            f"got {tuple(pos.shape)}")
    if pos.dtype != torch.float32:
        raise ValueError(f"rasterize: pos must be float32; got {pos.dtype}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(
            f"rasterize: tri must be [num_triangles, 3]; got {tuple(tri.shape)}")
    if tri.dtype != torch.int32:
        raise ValueError(f"rasterize: tri must be int32; got {tri.dtype}")
    if tri.shape[0] >= (1 << 24):
        raise ValueError(
            f"rasterize: triangle count {tri.shape[0]} exceeds the 2**24 "
            "capacity limit")
    h, w = resolution
    if h <= 0 or w <= 0:
        raise ValueError(f"rasterize: invalid resolution {resolution}")
    if tri.numel():
        tmin, tmax = (int(x) for x in torch.aminmax(tri))
        v = pos.shape[-2]
        if tmin < 0 or tmax >= v:
            raise ValueError(
                f"rasterize: triangle indices out of range [0, {v}): "
                f"min {tmin}, max {tmax}")
