"""kernel_roofline_pct.render: the least time a forward call could take
over its device time (the sum of its device kernels' durations,
torch.profiler), in %.

The least time is the larger of the call's bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (one H100 SXM); the bytes bound it.
Counted: the mesh (triangle and attribute indices, positions), the view
matrices, the attributes, uvs and texture, each read once, and the image
written once. Not counted: intermediates (rast, pixel streams, mip
levels, tables) and the benchmark's per-view sums. Operations: 1 a
pixel channel. Frozen, as kernel_roofline_pct.train.
"""

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12


def call_bytes(s):
    n_params = sum(_prod(v) for v in s["params"].values())
    mesh = 2 * s["T"] * 3 * 4 + s["uv_vertices"] * 2 * 4 + s["B"] * 16 * 4
    return mesh + 4 * n_params + 4 * s["B"] * s["H"] * s["W"] * s["C"]


def call_flops(s):
    return s["B"] * s["H"] * s["W"] * s["C"]


def least_seconds(s):
    return max(call_bytes(s) / PEAK_BYTES_S, call_flops(s) / PEAK_FLOPS_S)


def _prod(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def read(t):
    if t["kind"] != "render" or t["trace"] is None:
        return None
    us = sum(e - s for _, s, e, kernel in t["trace"]["device"] if kernel)
    if not us:
        return None
    return 100.0 * least_seconds(t["shapes"]) / (us * 1e-6 / t["steps"])
