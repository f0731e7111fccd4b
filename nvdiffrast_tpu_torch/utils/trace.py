"""Spans of the port on torch.profiler's clock.

A span marks a stretch of the port's host code: an op's entry, a stage
of its glue, a kernel launch, a host sync, a collective. While a
torch.profiler is active, ``span(name)`` enters
``torch.profiler.record_function(name)``, so the span lands in the
profiler's trace beside the device activities, on the same clock
(``export_chrome_trace``, ``key_averages``); otherwise it is a shared
no-op context and costs one profiler-enabled check. Nothing else
switches the spans on.

Names start with ``nvdr.``:

* ``nvdr.<op>`` and ``nvdr.<op>.bwd``: a public op's call and its
  autograd backward;
* ``nvdr.<stage>``: a stage of an op's glue (``nvdr.raster.setup``,
  ``nvdr.tex.grad``, ...);
* ``nvdr.kernel.<name>``: one launch of a kernel of ``csrc/``, named as
  its ``_build.Kernel``;
* ``nvdr.sync.<site>``: one statement that blocks the host until the
  device has caught up (a read of a device value, a copy from pageable
  host memory);
* ``nvdr.collective.<name>``: a torch.distributed collective of
  ``parallel/``.

No span name is the name of a device activity: the profiler mirrors a
labelled range on the device's timeline under the range's name.
"""

import contextlib
import functools

import torch

# The cheapest check torch offers of whether a profiler is recording
# (a C function: ~0.06 us a call on a CPU core).
profiling = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


def span(name):
    """A context that records `name` while a torch.profiler is active,
    and the shared no-op context otherwise."""
    if not profiling():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name):
    """Decorator: the whole function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap
