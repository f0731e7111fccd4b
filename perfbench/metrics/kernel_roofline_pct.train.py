"""kernel_roofline_pct.train: the least time a training step could take
over its device time (the sum of its device kernels' durations,
torch.profiler), in %. In the data-parallel cell: a rank's step (its
own views, parameters and optimizer) over rank 0's device time a step,
NCCL's kernels included.

The least time is the larger of the step's bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (one H100 SXM, NVIDIA's data sheet);
at these shapes the bytes bound it. Counted, whatever implements the
step: the mesh (triangle and attribute indices, positions), the view
matrices, the attributes, uvs and texture, each read once; the image
written once, its target and its cotangent read once; each gradient
written once; Adam's read of parameter, gradient and both moments and
its write of parameter and moments. Not counted: any intermediate
(rast, pixel streams, mip levels, tables), which a fused kernel could
keep on chip. Operations: 5 a pixel channel (the loss and its
cotangent) and 12 a parameter (Adam). Frozen: a later PR adds a new
metric rather than change this arithmetic.
"""

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12


def step_bytes(s):
    """Bytes a step must move, from the cell's shapes (per rank)."""
    numel = {k: _prod(v) for k, v in s["params"].items()}
    n_params = sum(numel.values())
    pixels = s["B"] * s["H"] * s["W"] * s["C"]
    mesh = 2 * s["T"] * 3 * 4 + s["uv_vertices"] * 2 * 4 + s["B"] * 16 * 4
    return mesh + 4 * n_params + 3 * 4 * pixels + 4 * n_params + 28 * n_params


def step_flops(s):
    n_params = sum(_prod(v) for v in s["params"].values())
    return 5 * s["B"] * s["H"] * s["W"] * s["C"] + 12 * n_params


def least_seconds(s):
    return max(step_bytes(s) / PEAK_BYTES_S, step_flops(s) / PEAK_FLOPS_S)


def _prod(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def read(t):
    if t["kind"] not in ("train", "dp") or t["trace"] is None:
        return None
    us = sum(e - s for _, s, e, kernel in t["trace"]["device"] if kernel)
    if not us:
        return None
    return 100.0 * least_seconds(t["shapes"]) / (us * 1e-6 / t["steps"])
