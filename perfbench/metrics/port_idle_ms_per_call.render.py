"""port_idle_ms_per_call.render: milliseconds a forward call in which the
device sits idle while the port's host code runs: the idle gaps put down
to a port span by ``port_idle_ms_per_step.train``'s rule (each gap to the
innermost ``nvdr.`` span in flight when it begins), summed, per call."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")


def read(t):
    return _spans.idle_ms(t, ("render",))
