"""device_idle_pct.train: share of the profiled window of training
steps that no device activity (kernel, copy or set) covers, in % (rank
0's in the data-parallel cell)."""

from perfbench import harness


def read(t):
    if t["kind"] not in ("train", "dp") or t["trace"] is None or not t["trace"]["device"]:
        return None
    w0, w1 = t["trace"]["window_us"]
    return 100.0 * (1.0 - harness.busy_us(t["trace"]) / (w1 - w0))
