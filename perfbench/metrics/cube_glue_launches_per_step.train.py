"""cube_glue_launches_per_step.train: kernel launches a training step that
the port's Python launches inside its cube-map stages: the PyTorch
kernels of the face selection, projection, footprint Jacobian and their
vjps, and the glue around the cube sampler and its gradient.

Counted as ``glue_launches_per_step.train`` counts (the host's
kernel-launch runtime events, put down to the innermost port span at the
launch's start by ``port_idle_ms_per_step.train``'s rule), restricted to
launches whose innermost port span is a cube stage (``nvdr.tex.cube.*``),
so never the port's own kernels (``nvdr.kernel.*``). A trace without a
cube span (a program that has none, or a cell without cube maps) reads
None, as does one without device activity or port spans."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")

CUBE = "nvdr.tex.cube."
KINDS = ("train", "dp")


def cube_traced(t):
    """Whether `t` is a trace of a training kind with device activity and
    at least one cube-stage span."""
    return _spans.traced(t, KINDS) and any(
        name.startswith(CUBE) for name, _, _ in t["trace"]["host"])


def read(t):
    if not cube_traced(t):
        return None
    starts = sorted(s for name, s, _ in t["trace"]["host"] if name.startswith(_spans.LAUNCHES))
    n = sum(1 for name in _spans.innermost(t["trace"], starts)
            if name is not None and name.startswith(CUBE))
    return n / t["steps"]
