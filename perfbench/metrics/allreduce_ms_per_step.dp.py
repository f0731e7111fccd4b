"""allreduce_ms_per_step.dp: device time of the NCCL kernels a step on
rank 0 (the gradient and loss all-reduce), from torch.profiler."""


def read(t):
    if t["kind"] != "dp" or t["trace"] is None:
        return None
    us = sum(e - s for name, s, e, kernel in t["trace"]["device"]
             if kernel and "nccl" in name.lower())
    return us / 1e3 / t["steps"] if us else None
