"""Clip->pixel transforms and the triangle-ID codec (torch).

Counterpart of ``nvdiffrast_tpu/ops/coord.py``, bit for bit:

* pixel ``(px, py)`` has its center at clip ``f = s * p + o`` with
  ``xs=2/W, xo=1/W-1, ys=2/H, yo=1/H-1``;
* triangle IDs (1-based, 0 = empty) live in a float32 channel. IDs up
  to 2^24 are plain floats; larger ones map to unique float32 bit
  patterns. The largest round-trippable ID is 889,192,447.
"""

import torch

MAX_TRIANGLE_ID = 889192447

# IDs <= this value are represented exactly as plain float32.
_EXACT_ID_LIMIT = 0x01000000  # 16777216

_BIG_ID_BIAS = 0x4A800000


def pixel_scale_offset(height, width):
    """Return (xs, xo, ys, yo) mapping pixel index -> clip-space coordinate."""
    xs = 2.0 / float(width)
    xo = 1.0 / float(width) - 1.0
    ys = 2.0 / float(height)
    yo = 1.0 / float(height) - 1.0
    return xs, xo, ys, yo


def triidx_to_float(idx):
    """Encode int32 triangle IDs (1-based, 0 = empty) as float32."""
    idx = torch.as_tensor(idx, dtype=torch.int32)
    small = idx.to(torch.float32)
    big = (idx + _BIG_ID_BIAS).view(torch.float32)
    return torch.where(idx <= _EXACT_ID_LIMIT, small, big)


def float_to_triidx(x):
    """Decode float32-encoded triangle IDs back to int32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    # Values <= 2^24 are exact integers; larger encodings are bitcasts.
    # The cast of a bitcast value is out of int32 range and discarded.
    small = torch.where(x <= 16777216.0, x, 0.0).to(torch.int32)
    big = x.view(torch.int32) - _BIG_ID_BIAS
    return torch.where(x <= 16777216.0, small, big)
