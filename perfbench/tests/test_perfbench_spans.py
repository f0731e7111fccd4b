"""The span readers (``port_idle_*``, ``sync_idle_*``, ``glue_launches_*``)
on hand-built traces worked out by hand, and on the tiny CPU checkout.

    python -m pytest perfbench/tests/test_perfbench_spans.py -q
"""

import json

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_cpu import _python

READERS = ["port_idle_ms_per_step.train", "sync_idle_ms_per_step.train",
           "glue_launches_per_step.train", "port_idle_ms_per_call.render",
           "sync_idle_ms_per_call.render", "glue_launches_per_call.render"]


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


# A window of 1,000 us, two steps. The device is busy over [100, 120),
# [300, 400), [600, 700) and [900, 1000), so the idle gaps are [0, 100)
# (the window's start: no port span), [120, 300) (begins inside
# nvdr.sync.bin_total, itself inside nvdr.render_pipeline: port and
# sync, 180 us), [400, 600) (inside nvdr.render_pipeline alone: port,
# 200 us) and [700, 900) (inside the benchmark's aten::mse_loss: neither).
# Launches: at 60 and 450 (cudaLaunchKernelExC) and 455 (cuLaunchKernel)
# inside nvdr.render_pipeline: glue; at 72 inside nvdr.kernel.nvdr_x: the
# port's own kernel; at 660 outside every port span: the benchmark's.
HOST = [("perfbench.window", 0, 1000), ("nvdr.render_pipeline", 50, 500),
        ("cudaLaunchKernel", 60, 62), ("nvdr.kernel.nvdr_x", 70, 80),
        ("cudaLaunchKernel", 72, 74), ("nvdr.sync.bin_total", 110, 200),
        ("aten::_local_scalar_dense", 111, 199), ("cudaLaunchKernelExC", 450, 452),
        ("cuLaunchKernel", 455, 456), ("aten::mse_loss", 650, 800),
        ("cudaLaunchKernel", 660, 661)]
DEVICE = [("k", 100, 120, True), ("k", 300, 400, True), ("Memcpy DtoH", 600, 700, False),
          ("k", 900, 1000, True)]


def _trace(kind, host=HOST, device=DEVICE):
    return {"kind": kind, "steps": 2,
            "trace": {"window_us": (0, 1000), "device": list(device), "host": list(host),
                      "calls": 2}}


@pytest.mark.parametrize("kind,suffix", [("train", "per_step.train"), ("dp", "per_step.train"),
                                         ("render", "per_call.render")])
def test_readers_by_hand(kind, suffix):
    t = _trace(kind)
    assert _metric(f"port_idle_ms_{suffix}").read(t) == pytest.approx((180 + 200) / 1e3 / 2)
    assert _metric(f"sync_idle_ms_{suffix}").read(t) == pytest.approx(180 / 1e3 / 2)
    assert _metric(f"glue_launches_{suffix}").read(t) == pytest.approx(3 / 2)


def test_gaps_and_their_spans_by_hand():
    m = _metric("port_idle_ms_per_step.train")
    t = _trace("train")["trace"]
    assert m.gaps(t) == [(0, 100), (120, 300), (400, 600), (700, 900)]
    assert m.idle_by_span(t) == {"nvdr.sync.bin_total": 180, "nvdr.render_pipeline": 200}
    assert m.innermost(t, [0, 72, 120, 450, 700]) == [
        None, "nvdr.kernel.nvdr_x", "nvdr.sync.bin_total", "nvdr.render_pipeline", None]


def test_gap_outside_port_spans_counts_for_neither():
    """Gaps at the window's start and inside a non-port op read 0, not
    the gaps' 300 us."""
    host = [h for h in HOST if h[0] in ("perfbench.window", "aten::mse_loss")]
    host.append(("nvdr.render_pipeline", 5000, 6000))  # the program has spans, elsewhere
    t = _trace("train", host)
    assert _metric("port_idle_ms_per_step.train").read(t) == 0.0
    assert _metric("sync_idle_ms_per_step.train").read(t) == 0.0
    assert _metric("glue_launches_per_step.train").read(t) == 0.0


def test_nested_spans_starting_together_go_to_the_inner():
    """Two sync spans on one statement (bincount's two reads) start
    together: the gap goes to the shorter, inner one."""
    m = _metric("port_idle_ms_per_step.train")
    host = [("nvdr.vertex_sums", 100, 400), ("nvdr.sync.corner_count_min", 110, 300),
            ("nvdr.sync.corner_count_max", 110, 290)]
    t = {"window_us": (0, 400), "device": [("k", 0, 120, True), ("k", 200, 400, True)],
         "host": host}
    assert m.idle_by_span(t) == {"nvdr.sync.corner_count_max": 80}


def test_no_port_spans_or_no_device_reads_none():
    """The parent's program has no spans; a CPU run has no device
    activity: every reader returns None and raises nothing."""
    plain = [h for h in HOST if not h[0].startswith("nvdr.")]
    for name in READERS:
        kind = "render" if name.endswith(".render") else "train"
        m = _metric(name)
        assert m.read(_trace(kind, plain)) is None
        assert m.read(_trace(kind, device=[])) is None
        other = "train" if kind == "render" else "render"
        assert m.read(_trace(other)) is None
        assert m.read({"kind": kind, "trace": None, "steps": 2}) is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("perfbench_spans_checkout"))


def test_tiny_checkout_finds_the_six_entries(checkout):
    """Each tiny cell lists the new entries of its kind; a --trace 1 CPU
    run completes (no device activity: the readers report nothing); the
    profiled CPU steps hold the port's spans, and with device intervals
    laid over their window each reader reads a number."""
    p = _python(checkout, """
        import json, sys
        sys.path.insert(0, '.')
        from perfbench import harness, run, training
        names = %r
        out = {}
        for cell in ('tiny.vcolor.train', 'tiny.earth.train', 'tiny.earth.render', 'tiny.earth.dp'):
            out[cell] = sorted(m['name'] for m in harness.Cell(cell).per_layer
                               if m['name'] in names)
        line = run.main(['--workload', 'tiny.earth.train', '--seed', '2147483659',
                         '--seconds', '0.3', '--trace', '1'], device='cpu')
        out['line'] = sorted(line['metrics'])
        cell = harness.Cell('tiny.earth.train')
        fit = training.Fitting(cell, 5, 'cpu')
        fit.step(0)
        ks = iter(range(1, 10))
        trace = harness.profile_calls(lambda: fit.step(next(ks)), 2)
        w0, w1 = trace['window_us']
        # Busy over every other tenth of the window.
        trace['device'] = [('k', w0 + (w1 - w0) * i / 10, w0 + (w1 - w0) * (i + 1) / 10, True)
                           for i in range(0, 10, 2)]
        t = {'kind': 'train', 'trace': trace, 'steps': 2}
        out['spans'] = sorted({h[0] for h in trace['host'] if h[0].startswith('nvdr.')})
        out['read'] = {n: cell.layer_reader(n).read(t) for n in names if n.endswith('.train')}
        print('OUT ' + json.dumps(out))
        """ % (READERS,))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1][len("OUT "):])
    train = sorted(n for n in READERS if n.endswith(".train"))
    render = sorted(n for n in READERS if n.endswith(".render"))
    for cell in ("tiny.vcolor.train", "tiny.earth.train", "tiny.earth.dp"):
        assert out[cell] == train
    assert out["tiny.earth.render"] == render
    assert not set(out["line"]) & set(READERS)
    assert {"nvdr.render_pipeline_textured", "nvdr.render_pipeline_textured.bwd",
            "nvdr.sync.uv_range_min", "nvdr.tex.grad"} <= set(out["spans"])
    assert out["read"]["port_idle_ms_per_step.train"] > 0
    assert 0 <= out["read"]["sync_idle_ms_per_step.train"] <= \
        out["read"]["port_idle_ms_per_step.train"]
    # The CPU's "launches" are aten ops, not runtime events: none counted.
    assert out["read"]["glue_launches_per_step.train"] == 0
