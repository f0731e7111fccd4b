"""Image helpers of the models and samples (torch): bilinear 2x
downsample, PSNR, save and display.

Counterparts of ``nvdiffrast_tpu/utils/image.py``'s
``bilinear_downsample``, ``psnr``, ``save_image`` and ``display_image``.
"""

import math

import numpy as np
import torch

_TAPS = (0.125, 0.375, 0.375, 0.125)  # [1, 3, 3, 1] / 8


def _down_axis(x, dim):
    """One axis of the 2x downsample: zero-pad by one texel on each side,
    then out[i] = sum_k taps[k] * x[2i - 1 + k]."""
    pad = [0, 0] * (x.ndim - 1 - dim) + [1, 1]
    xp = torch.nn.functional.pad(x, pad)
    even = 2 * torch.arange(x.shape[dim] // 2, device=x.device)
    out = None
    for k, w in enumerate(_TAPS):
        term = w * xp.index_select(dim, even + k)
        out = term if out is None else out + term
    return out


def bilinear_downsample(x, steps=1):
    """2x bilinear downsample of an NHWC image with the reference's 4x4
    [1, 3, 3, 1] kernel (stride 2, zero padding 1), ``steps`` times.

    The kernel is separable, so each step filters the rows, then the
    columns, with elementwise float32 arithmetic (no convolution library,
    whose float32 path may run in TF32 on the GPU)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    for _ in range(steps):
        x = _down_axis(_down_axis(x, x.ndim - 3), x.ndim - 2)
    return x


def psnr(a, b, peak=1.0):
    """Peak signal-to-noise ratio of a against b in dB (inf if equal)."""
    mse = float(torch.mean((torch.as_tensor(a) - torch.as_tensor(b)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def _to_uint8(x):
    """An HWC (or HW) image in [0, 1], tensor or array, as uint8: rounded
    to the nearest of 256 levels and clipped."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.rint(np.asarray(x) * 255.0)
    return np.clip(x, 0, 255).astype(np.uint8)


def save_image(fn, x):
    """Write the image x (values in [0, 1]) to the file fn through PIL."""
    from PIL import Image

    Image.fromarray(_to_uint8(x)).save(fn)


def display_image(x, title=None):
    """Show the image x in PIL's viewer. Returns True if it was shown, and
    False where that fails (no display, no viewer)."""
    try:
        from PIL import Image

        Image.fromarray(_to_uint8(x)).show(title=title)
        return True
    except Exception:
        return False
