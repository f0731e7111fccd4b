"""sync_idle_ms_per_call.render: the part of
``port_idle_ms_per_call.render`` whose innermost port span is a host
sync (``nvdr.sync.*``), per forward call. Gaps are put down by
``port_idle_ms_per_step.train``'s rule: to the innermost ``nvdr.`` span
in flight when the gap begins."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")


def read(t):
    return _spans.idle_ms(t, ("render",), _spans.SYNC)
