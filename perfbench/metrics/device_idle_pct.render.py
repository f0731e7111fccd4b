"""device_idle_pct.render: share of the profiled window of forward calls
that no device activity covers, in %."""

from perfbench import harness


def read(t):
    if t["kind"] != "render" or t["trace"] is None or not t["trace"]["device"]:
        return None
    w0, w1 = t["trace"]["window_us"]
    return 100.0 * (1.0 - harness.busy_us(t["trace"]) / (w1 - w0))
