"""port_idle_ms_per_step.train: milliseconds a training step in which the
device sits idle while the port's host code runs (rank 0's in the
data-parallel cell).

The rule: an idle gap is a stretch of the profiled window that no device
activity (kernel, copy or set) covers, as ``harness.breakdown`` finds
them. Each gap is put down to the innermost span of the port (a host
range whose name starts with ``nvdr.``) in flight when the gap begins:
of the spans with start <= gap start < end, the one that started last
(``harness.breakdown``'s rule, restricted to the port's spans). This
metric sums the gaps put down to a port span, over the profiled steps,
per step. A gap that begins outside every port span (at the window's
start, in the benchmark's loss, optimizer or loss read) is not counted.
A trace without device activity, or without any port span (a program
that has none), reads None.

The other span readers (``sync_idle_*``, ``glue_launches_*``,
``port_idle_ms_per_call.render``) use this file's functions.
"""

PORT = "nvdr."
SYNC = "nvdr.sync."
KERNEL = "nvdr.kernel."
# Host events of a kernel launch: cudaLaunchKernel*, cuLaunchKernel*.
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def gaps(trace):
    """[(start, end)] in us: the idle gaps of the window, as
    ``harness.breakdown`` finds them."""
    w0, w1 = trace["window_us"]
    spans = sorted((s, t) for _, s, t, _ in trace["device"])
    out, end = [], w0
    for s, t in spans + [(w1, w1)]:
        if s > end:
            out.append((end, s))
        end = max(end, t)
    return out


def innermost(trace, points):
    """For each of the ascending `points` (us), the name of the port span
    in flight there that started last (a nested span starting with its
    parent counts as the later one), or None."""
    spans = sorted(((s, -t, name) for name, s, t in trace["host"] if name.startswith(PORT)))
    out, active, i = [], [], 0
    for x in points:
        while i < len(spans) and spans[i][0] <= x:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if -sp[1] > x]
        out.append(active[-1][2] if active else None)
    return out


def idle_by_span(trace):
    """{innermost port span: summed idle us} over the window."""
    gs = gaps(trace)
    out = {}
    for (g0, g1), name in zip(gs, innermost(trace, [g0 for g0, _ in gs])):
        if name is not None:
            out[name] = out.get(name, 0.0) + (g1 - g0)
    return out


def traced(t, kinds):
    """Whether `t` is a trace of one of `kinds` with device activity and
    port spans."""
    return (t["kind"] in kinds and t["trace"] is not None and bool(t["trace"]["device"])
            and any(name.startswith(PORT) for name, _, _ in t["trace"]["host"]))


def idle_ms(t, kinds, prefix=PORT):
    """Idle ms per profiled step or call put down to spans named
    `prefix`..., or None (``traced``)."""
    if not traced(t, kinds):
        return None
    us = sum(v for k, v in idle_by_span(t["trace"]).items() if k.startswith(prefix))
    return us * 1e-3 / t["steps"]


def glue_launches(t, kinds):
    """Kernel launches per profiled step or call that start inside a port
    span and outside every ``nvdr.kernel.*`` span: the PyTorch kernels the
    port's Python launches, or None (``traced``)."""
    if not traced(t, kinds):
        return None
    starts = sorted(s for name, s, _ in t["trace"]["host"] if name.startswith(LAUNCHES))
    n = sum(1 for name in innermost(t["trace"], starts)
            if name is not None and not name.startswith(KERNEL))
    return n / t["steps"]


def read(t):
    return idle_ms(t, ("train", "dp"))
