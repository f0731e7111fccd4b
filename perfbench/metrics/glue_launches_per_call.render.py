"""glue_launches_per_call.render: kernel launches a forward call that the
port's Python launches as PyTorch ops, counted as
``glue_launches_per_step.train`` counts them: launch runtime events whose
innermost port span exists and is not a ``nvdr.kernel.*`` span."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")


def read(t):
    return _spans.glue_launches(t, ("render",))
