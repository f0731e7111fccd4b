"""device_ops_per_step.train: device kernels a training step launches,
from torch.profiler over the profiled steady steps (a count; rank 0's
in the data-parallel cell, NCCL's kernels included)."""


def read(t):
    if t["kind"] not in ("train", "dp") or t["trace"] is None:
        return None
    n = sum(1 for *_, kernel in t["trace"]["device"] if kernel)
    return n / t["steps"] if n else None
