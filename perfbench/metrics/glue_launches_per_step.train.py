"""glue_launches_per_step.train: kernel launches a training step that the
port's Python launches as PyTorch ops (rank 0's in the data-parallel cell).

Counted: the host's kernel-launch runtime events (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel*``) whose innermost port span
(``port_idle_ms_per_step.train``'s rule, at the launch's start) exists
and is not a ``nvdr.kernel.*`` span. So the port's own kernels, and the
benchmark's loss, optimizer and loss read, which run outside every port
span, are left out."""

from perfbench import harness

_spans = harness.load_module(harness.HERE / "metrics" / "port_idle_ms_per_step.train.py")


def read(t):
    return _spans.glue_launches(t, ("train", "dp"))
