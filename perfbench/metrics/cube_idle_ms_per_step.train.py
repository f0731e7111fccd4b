"""cube_idle_ms_per_step.train: milliseconds a training step in which the
device sits idle while the port's cube-map stages run on the host: the
idle gaps that ``port_idle_ms_per_step.train``'s rule puts down to a
``nvdr.tex.cube.*`` span (the innermost port span in flight when the gap
begins; a host sync inside a cube stage has its own ``nvdr.sync.*`` span
and counts in ``sync_idle_ms_per_step.train`` instead). A trace without
a cube span reads None (``cube_glue_launches_per_step.train``)."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")
_cube = harness.load_module(harness.HERE / "metrics" / "cube_glue_launches_per_step.train.py")


def read(t):
    if not _cube.cube_traced(t):
        return None
    return _spans.idle_ms(t, _cube.KINDS, _cube.CUBE)
