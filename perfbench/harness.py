"""What every cell shares: finding a cell's files by name, the measured
window, the profiled steps and their reading, the import check, and the
result line.

A cell is a workload of ``BENCHMARK.json``. Its configuration is the
JSON file the entry names, with ``configs/<config>.py`` (the scene and
the call into the program) and ``configs/<config>_ref.py`` (the plain
reference) beside it; its traffic is ``traffic/<traffic>.json``, whose
``kind`` names the step kind ``kinds/<kind>.py``; each metric is read by
``e2e/<name>.py`` or ``metrics/<name>.py``; the limits of its checks are
``limits/<workload>.json``. Adding a cell, a mix or a metric adds files.
"""

import importlib.util
import json
import math
import os
import pathlib
import statistics
import sys
import time
import warnings
from contextlib import contextmanager

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nvdiffrast_tpu")


class BenchError(RuntimeError):
    """The run cannot go on; no result is printed."""


def load_module(path):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    path = pathlib.Path(path).resolve()
    if not path.is_file():
        raise BenchError(f"no file {path}")
    name = "perfbench_" + str(path.relative_to(HERE).with_suffix("")).replace(
        "/", "__").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with everything found by its names."""

    def __init__(self, workload, bench_path=None, here=None):
        self.here = pathlib.Path(here or HERE)
        bench = load_json(bench_path or self.here.parent / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(self.here.parent / self.config_entry["file"])
        cfg_file = self.here.parent / self.config_entry["file"]
        self.config_module = load_module(cfg_file.with_suffix(".py"))
        self.ref_module = load_module(cfg_file.with_name(cfg_file.stem + "_ref.py"))
        self.traffic = load_json(self.here / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = load_module(self.here / "kinds" / f"{self.traffic['kind']}.py")
        self.chips = int(self.entry["chips"])
        limits_file = self.here / "limits" / f"{workload}.json"
        self.limits = load_json(limits_file) if limits_file.is_file() else {}
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def e2e_reader(self, name):
        return load_module(self.here / "e2e" / f"{name}.py")

    def layer_reader(self, name):
        return load_module(self.here / "metrics" / f"{name}.py")


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold, compared
    whole (``nvdiffrast_tpu_torch`` is not ``nvdiffrast_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quantile(values, q):
    """The q-th percentile (0-100) of all values, linear between ranks."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def timed_window(step, seconds, clock=time.perf_counter):
    """Run step(k) for k = 0, 1, ... until `seconds` have passed; each
    step ends with its own read of the result. Returns (start, end, step
    times [s], step results)."""
    start = clock()
    times, results = [], []
    k = 0
    while True:
        t0 = clock()
        results.append(step(k))
        t1 = clock()
        times.append(t1 - t0)
        k += 1
        if t1 - start >= seconds:
            return start, t1, times, results


@contextmanager
def sync_counter(counts):
    """Count host synchronisations (torch's sync debug mode) inside the
    block into counts[0]; a no-op where counts is None or off the card."""
    import torch

    if counts is None or not torch.cuda.is_available():
        yield
        return
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts[0] += sum("synchroniz" in str(w.message) for w in caught)


def profile_calls(fn, n):
    """torch.profiler over n calls of fn() inside one labelled range.

    Returns the trace as plain data: the window (start, end) in us,
    device activities [(name, start, end)] (kernels, copies, sets) with
    a flag for kernels, and host ops [(name, start, end)]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("perfbench.window"):
            for _ in range(n):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    window, device, host = None, [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A labelled host range (record_function, the optimizer's) is
            # mirrored on the device's timeline; it is no device work.
            if getattr(e, "is_user_annotation", False) or e.name in host_names:
                continue
            kernel = not e.name.startswith(("Memcpy", "Memset"))
            device.append((e.name, s, t, kernel))
        elif e.name == "perfbench.window":
            window = (s, t)
        else:
            host.append((e.name, s, t))
    return {"window_us": window, "device": device, "host": host, "calls": n}


def busy_us(trace):
    """Microseconds of the window that some device activity covers."""
    w0, w1 = trace["window_us"]
    spans = sorted((max(s, w0), min(t, w1)) for _, s, t, _ in trace["device"])
    busy, end = 0.0, w0
    for s, t in spans:
        if t <= end:
            continue
        busy += t - max(s, end)
        end = t
    return busy


def short_name(name, width=160):
    """A kernel's name without its parameter list, at most `width` long."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width].rstrip()


def breakdown(trace, top=10):
    """The device operations with the most time, and the longest idle
    gaps, each named after the innermost host op in flight when it began."""
    tot = {}
    for name, s, t, _ in trace["device"]:
        name = short_name(name)
        tot[name] = tot.get(name, 0.0) + (t - s) * 1e-6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = trace["window_us"]
    spans = sorted((s, t) for _, s, t, _ in trace["device"])
    gaps, end = [], w0
    for s, t in spans + [(w1, w1)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        inner = [(s, name) for name, s, t in trace["host"]
                 if s <= g0 < t and name != "perfbench.window"]
        label = max(inner)[1] if inner else "(no host op)"
        out.append([label, (g1 - g0) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}


def device_info(torch, chips, name=True):
    """The result's device record; raises without the devices the cell
    asks for. name=False leaves the name to a rank (the reporting process
    then starts no CUDA context of its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise BenchError(f"this cell needs {chips} CUDA device(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if name else None,
            "count": chips}


def finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(cell, numbers):
    """{name: {"value", "limit"}} of each number compared, and whether all
    hold. A number with no limit fails, as does one that is not finite."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        good = limit is not None and finite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return checks, ok


def result_line(cell, measured, trace_data, checks, correct, device, attempted, failed):
    """The last line of standard output: the contract's keys, then the
    numbers compared beside their limits."""
    metrics = {}
    if trace_data is None:
        for m in cell.end_to_end:
            v = cell.e2e_reader(m["name"]).read(measured)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.layer_reader(m["name"]).read(trace_data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if trace_data is not None and trace_data.get("breakdown") is not None:
        line["breakdown"] = trace_data["breakdown"]
    line["checks"] = checks
    return line


def log(msg):
    """A progress line on standard error (the run's phases and their seconds)."""
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def emit(line):
    """Print the checks on standard error, then the result line last."""
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def cache_dirs():
    """Keep every kernel cache inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".perfbench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".perfbench_cache" / "torch_ext")
