"""sync_idle_ms_per_step.train: the part of ``port_idle_ms_per_step.train``
whose innermost port span is a host sync (``nvdr.sync.*``): the device
drained and then waiting while the port's host reads a device value
back, per training step (rank 0's in the data-parallel cell). Gaps are
put down by ``port_idle_ms_per_step.train``'s rule: to the innermost
``nvdr.`` span in flight when the gap begins."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")


def read(t):
    return _spans.idle_ms(t, ("train", "dp"), _spans.SYNC)
