"""The port's spans (``nvdiffrast_tpu_torch.utils.trace``) on the CPU path.

Under torch.profiler the render pipelines' forward and backward emit
their entry spans, with each stage span nested inside its entry or
``.bwd`` span; with no profiler active no span enters
``record_function`` and each costs one profiler-enabled check; every
span name starts with ``nvdr.``; the host-sync sites the CPU path passes
appear once for each pass through them.
"""

import contextlib
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch import _build
from nvdiffrast_tpu_torch.utils import trace

from _torch_parity import sphere_scene, textured_scene

RES = (24, 32)


def _vcolor_step():
    pos, tri, attr, aidx = (torch.as_tensor(x) for x in sphere_scene(B=2, seed=1))

    def step():
        p, a = pos.clone().requires_grad_(), attr.clone().requires_grad_()
        img = dr.render_pipeline(p, tri, a, RES, attr_idx=aidx)
        torch.autograd.grad((img ** 2).mean(), (p, a))

    return step


def _textured_step():
    pos, tri, uv, tex = (torch.as_tensor(x) for x in textured_scene(seed=3, B=2))

    def step():
        xs = [x.clone().requires_grad_() for x in (pos, uv, tex)]
        img = dr.render_pipeline_textured(xs[0], tri, xs[1], xs[2], RES)
        torch.autograd.grad((img ** 2).mean(), xs)

    return step


# entry: (its forward stages, its backward stages, host syncs a step by site)
PIPELINES = {
    "render_pipeline": (
        _vcolor_step,
        {"nvdr.topology", "nvdr.raster.setup", "nvdr.raster.sweep", "nvdr.attr_table",
         "nvdr.aa.tables", "nvdr.shade"},
        {"nvdr.pipeline_bwd", "nvdr.grad_scatter", "nvdr.vertex_sums"},
        # tri's range (CPU tensors are checked on every call); two vertex
        # sums (pos, attr), each with bincount's two reads and the degree.
        {"nvdr.sync.tri_range_min": 1, "nvdr.sync.tri_range_max": 1,
         "nvdr.sync.corner_count_min": 2, "nvdr.sync.corner_count_max": 2,
         "nvdr.sync.corner_degree": 2}),
    "render_pipeline_textured": (
        _textured_step,
        {"nvdr.topology", "nvdr.raster.setup", "nvdr.raster.sweep", "nvdr.tex.pyramid",
         "nvdr.attr_table", "nvdr.interp", "nvdr.tex.level", "nvdr.tex.sample",
         "nvdr.aa.tables", "nvdr.aa.fwd"},
        {"nvdr.aa.bwd", "nvdr.tex.grad", "nvdr.tex.pyramid_vjp", "nvdr.tex.bwd",
         "nvdr.tex.level_vjp", "nvdr.attr_table", "nvdr.raster.grad", "nvdr.grad_scatter",
         "nvdr.vertex_sums"},
        # The entry checks tri and rasterize_fused again (on the card the
        # second check is skipped for a tensor already checked).
        {"nvdr.sync.tri_range_min": 2, "nvdr.sync.tri_range_max": 2,
         "nvdr.sync.uv_range_min": 1, "nvdr.sync.uv_range_max": 1,
         "nvdr.sync.corner_count_min": 2, "nvdr.sync.corner_count_max": 2,
         "nvdr.sync.corner_degree": 2}),
}


def _spans(step):
    """[(name, start, end)] of the port's spans in one profiled step."""
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("nvdr.")]


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.mark.parametrize("entry", sorted(PIPELINES))
def test_entry_spans_hold_their_stages(entry):
    make, fwd, bwd, _ = PIPELINES[entry]
    spans = _spans(make())
    entries = [s for s in spans if s[0] == f"nvdr.{entry}"]
    bwds = [s for s in spans if s[0] == f"nvdr.{entry}.bwd"]
    assert len(entries) == 1 and len(bwds) == 1, spans
    assert entries[0][2] <= bwds[0][1]
    for names, outer in ((fwd, entries[0]), (bwd, bwds[0])):
        inner = {s[0] for s in spans if _inside(s, outer) and s is not outer}
        assert names <= inner, names - inner
    # Every span of the step lies inside the forward's or the backward's.
    for s in spans:
        assert _inside(s, entries[0]) or _inside(s, bwds[0]), s


@pytest.mark.parametrize("entry", sorted(PIPELINES))
def test_sync_sites_once_a_pass(entry):
    make, _, _, sites = PIPELINES[entry]
    got = {}
    for name, _, _ in _spans(make()):
        if name.startswith("nvdr.sync."):
            got[name] = got.get(name, 0) + 1
    assert got == sites


@pytest.fixture
def counted(monkeypatch):
    """(checks, entered): the profiler-enabled checks the spans make, and
    the names that enter record_function."""
    checks, entered = [0], []
    real_check, real_rf = trace.profiling, torch.profiler.record_function

    def check():
        checks[0] += 1
        return real_check()

    def record_function(name, *args):
        entered.append(name)
        return real_rf(name, *args)

    monkeypatch.setattr(trace, "profiling", check)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return checks, entered


@pytest.mark.parametrize("entry", sorted(PIPELINES))
def test_spans_off_cost_one_check(entry, counted):
    """With no profiler active no span enters record_function, and each
    makes one check: as many as the spans a profiled step enters."""
    checks, entered = counted
    step = PIPELINES[entry][0]()
    step()
    checks[0] = 0
    step()
    assert entered == []
    off = checks[0]
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert off > 0 and len(entered) == off
    assert all(name.startswith("nvdr.") for name in entered), entered


def test_span_names_start_with_nvdr():
    """Every span the package names, in code and for each kernel, starts
    with ``nvdr.``, and no name is shared by a span and a kernel."""
    pkg = pathlib.Path(trace.__file__).resolve().parents[1]
    names = set()
    for path in pkg.rglob("*.py"):
        names |= set(re.findall(r"\bspan(?:ned)?\(f?\"([^\"]+)\"", path.read_text()))
    assert len(names) > 30
    assert all(n.startswith("nvdr.") for n in names), sorted(names)
    kernels = [k.span for k in _build.KERNELS]
    assert kernels and all(n.startswith("nvdr.kernel.") for n in kernels)
    assert not names & set(kernels)


def test_span_is_shared_noop_when_off():
    assert not trace.profiling()
    assert trace.span("nvdr.a") is trace.span("nvdr.b")
    assert isinstance(trace.span("nvdr.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.profiling()
        with trace.span("nvdr.test.outer"):
            trace.spanned("nvdr.test.inner")(lambda: None)()
    got = [e.name for e in prof.events() if e.name.startswith("nvdr.test.")]
    assert got == ["nvdr.test.outer", "nvdr.test.inner"]
