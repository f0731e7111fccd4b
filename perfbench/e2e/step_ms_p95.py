"""step_ms_p95: the 95th percentile of the time of every step in the
window, from its dispatch to the read of its loss (rank 0's steps in
the data-parallel cell)."""

from perfbench import harness


def read(m):
    if m["kind"] not in ("train", "dp") or len(m["step_s"]) < 2:
        return None
    return harness.quantile(m["step_s"], 95) * 1e3
