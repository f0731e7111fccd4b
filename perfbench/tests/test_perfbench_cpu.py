"""CPU tests of the benchmark harness (the port's plain twins, tiny cells).

    python -m pytest perfbench/tests -q

Each tiny run goes through ``run.main`` in a subprocess whose working
directory is a throwaway checkout (``tiny.py``): this benchmark's files,
the package, and tiny cells added as new files and entries.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from perfbench.tests import tiny

REPO = tiny.REPO
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
FORBIDDEN = {"jax", "jaxlib", "flax", "nvdiffrast_tpu"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("perfbench_checkout"))


def _python(cwd, code, timeout=600):
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def run_cpu(cwd, workload, seed=2147483659, seconds=0.5, trace=0, fault=None):
    """(result line, loaded top-level module names) of one CPU run."""
    p = _python(cwd, f"""
        import json, sys
        sys.path.insert(0, '.')
        from perfbench import run
        line = run.main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds',
                         '{seconds}', '--trace', '{trace}'], device='cpu', fault={fault!r})
        print('MODULES ' + json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
        """)
    assert p.returncode == 0, p.stderr[-4000:]
    out = p.stdout.strip().splitlines()
    mods = json.loads(out[-1][len("MODULES "):])
    return json.loads(out[-2]), mods


@pytest.mark.parametrize("workload", ["tiny.vcolor.train", "tiny.earth.train",
                                      "tiny.earth.render", "tiny.earth.dp"])
def test_tiny_cell_runs_correct_without_jax(checkout, workload):
    line, mods = run_cpu(checkout, workload)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert not FORBIDDEN & set(mods)
    # The data-parallel kind's ranks, not the process that reports, run the port.
    assert ("nvdiffrast_tpu_torch" in mods) != workload.endswith(".dp")


def test_result_line_keys_and_trace_switch(checkout):
    """One last JSON line with the contract's keys (checks last); trace 0
    reports the cell's end-to-end metrics, trace 1 its per-layer ones."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]
           if "tiny.earth.train" in m.get("workloads", ["tiny.earth.train"])}
    line0, _ = run_cpu(checkout, "tiny.earth.train", trace=0)
    line1, _ = run_cpu(checkout, "tiny.earth.train", trace=1)
    for line in (line0, line1):
        assert set(line) <= CONTRACT_KEYS
        assert list(line)[-1] == "checks"
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
    assert set(line0["metrics"]) == e2e - {"peak_mem_gib"}   # no device memory on the CPU
    assert "breakdown" not in line0 and "busy_s" not in line0["device"]
    assert not set(line1["metrics"]) & e2e
    assert {"busy_s", "window_s"} <= set(line1["device"])
    assert set(line1["breakdown"]) == {"device_ops", "idle_gaps"}


def test_seed_and_seconds(checkout):
    """The same seed gives the same inputs and checks; a longer window
    makes more steps; a seed past 32 bits is taken."""
    a, _ = run_cpu(checkout, "tiny.vcolor.train", seed=2 ** 31 + 12345, seconds=0.3)
    b, _ = run_cpu(checkout, "tiny.vcolor.train", seed=2 ** 31 + 12345, seconds=1.5)
    c, _ = run_cpu(checkout, "tiny.vcolor.train", seed=7, seconds=0.3)
    assert a["checks"] == b["checks"]
    assert a["checks"] != c["checks"]
    assert b["attempted"] > a["attempted"]


@pytest.mark.parametrize("workload,fault", [
    ("tiny.earth.train", "frozen"), ("tiny.earth.train", "half_batch"),
    ("tiny.earth.train", "altered"), ("tiny.earth.train", "control"),
    ("tiny.vcolor.train", "control"),
    ("tiny.earth.render", "stale"), ("tiny.earth.render", "half_batch"),
    ("tiny.earth.render", "altered"), ("tiny.earth.render", "control")])
def test_fault_makes_run_incorrect(checkout, workload, fault):
    """With the timed path broken underneath, or the reference in bfloat16
    in the program's place, `correct` comes out false."""
    line, _ = run_cpu(checkout, workload, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_dp_faults_make_runs_incorrect(checkout):
    """Each fault of the data-parallel kind, in one process group of two
    gloo ranks: `correct` comes out false, the sound job true."""
    p = _python(checkout, """
        import json, sys, time
        sys.path.insert(0, '.')
        from perfbench import harness, run
        cell = harness.Cell('tiny.earth.dp')
        args = run.parse(['--workload', 'tiny.earth.dp', '--seed', '0', '--seconds', '0.3'])
        args.jobs = [(5, None), (5, 'frozen'), (5, 'half_batch'), (5, 'altered'),
                     (5, 'no_exchange'), (5, 'control')]
        for (seed, fault), res in zip(args.jobs, cell.kind.run(cell, args,
                                                              time.perf_counter(), 'cpu')):
            checks, ok = harness.judge(cell, res['numbers'])
            print(json.dumps([fault, ok, checks]))
        """)
    assert p.returncode == 0, p.stderr[-4000:]
    rows = [json.loads(x) for x in p.stdout.strip().splitlines()[-6:]]
    assert rows[0][:2] == [None, True]
    for fault, ok, checks in rows[1:]:
        assert ok is False, (fault, checks)
    assert dict((r[0], r[2]) for r in rows)["no_exchange"]["rank_gap"]["value"] > 0


def test_discovery_by_name(checkout, tmp_path):
    """A configuration, a traffic mix and a per-layer metric that exist
    only as new files (and entries) are found and run."""
    root = tiny.make_checkout(tmp_path / "c")
    pb = root / "perfbench"
    (pb / "traffic" / "train.odd.json").write_text(json.dumps(dict(
        json.loads((pb / "traffic" / "train.tiny.json").read_text()),
        resolution=[24, 36], views_per_step=3)))
    cfg = json.loads((pb / "configs" / "tiny_vcolor.json").read_text())
    cfg.update(name="odd_vcolor", channels=5)
    (pb / "configs" / "odd_vcolor.json").write_text(json.dumps(cfg))
    for suffix in (".py", "_ref.py"):
        (pb / "configs" / f"odd_vcolor{suffix}").write_text(
            (pb / "configs" / f"tiny_vcolor{suffix}").read_text())
    (pb / "metrics" / "steps_profiled.odd.py").write_text(
        "def read(t):\n    return float(t['steps'])\n")
    (pb / "limits" / "odd.cell.json").write_text(json.dumps(tiny.TINY_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="odd_vcolor",
                                 file="perfbench/configs/odd_vcolor.json"))
    bench["workloads"].append({"name": "odd.cell", "config": "odd_vcolor",
                               "traffic": "train.odd", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_profiled.odd", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "train_mpix_s",
                               "workloads": ["odd.cell"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.vcolor.train" in m["workloads"]:
            m["workloads"].append("odd.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = run_cpu(root, "odd.cell", trace=1)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["steps_profiled.odd"]["value"] == 2.0


def test_reference_imports_torch_alone(checkout):
    """The plain reference (its modules and a render through it) loads
    neither JAX nor the JAX package nor anything of the port."""
    p = _python(checkout, """
        import json, sys
        sys.path.insert(0, '.')
        import torch
        from perfbench import harness, scene
        from perfbench.ref import render, train
        for name in ('sphere_vcolor', 'earth_textured'):
            ref = harness.load_module(f'perfbench/configs/{name}_ref.py')
        tri, vtx, uv_idx, uv = scene.uv_sphere(4, 8)
        m = ref.mesh({'tri': tri, 'uv_idx': uv_idx, 'uv': uv}, 'cpu')
        cfg = json.load(open('perfbench/configs/tiny_earth.json'))
        params = {'pos': torch.as_tensor(vtx, dtype=torch.float64),
                  'tex': torch.rand(1, 24, 32, 3, dtype=torch.float64)}
        view = torch.as_tensor(scene.view_matrices(cfg['camera'], 1,
                                                   __import__('numpy').random.default_rng(1)))[0]
        img = ref.render_view(m, params, ref.prepare(m, params, cfg, torch.float64), view,
                              (16, 20), cfg, torch.float64, torch.float64)
        assert img.shape == (320, 3) and float(img.abs().sum()) > 0
        print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
        """)
    assert p.returncode == 0, p.stderr[-4000:]
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not (FORBIDDEN | {"nvdiffrast_tpu_torch"}) & mods


def test_command_refuses_without_card_or_package(checkout, tmp_path):
    """The command prints no result and exits non-zero without the CUDA
    devices a cell asks for, and in a directory with only BENCHMARK.json
    and perfbench/ (no package to measure)."""
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "vcolor.train.2048x8", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device(s); torch sees 0" in p.stderr, p.stderr[-2000:]
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((checkout / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(checkout / "perfbench", bare / "perfbench")
    q = _python(bare, """
        import sys
        sys.path.insert(0, '.')
        from perfbench import run
        run.main(['--workload', 'tiny.vcolor.train', '--seed', '1', '--seconds', '0.3'],
                 device='cpu')
        """)
    assert q.returncode != 0 and "{" not in q.stdout
    assert "nvdiffrast_tpu_torch" in q.stderr


def test_forbidden_names_compared_whole():
    from perfbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["nvdiffrast_tpu_torch_extra"] = sys
        sys.modules["jaxtyping"] = sys
        assert not set(harness.forbidden_modules()) & {"nvdiffrast_tpu", "jax"} or \
            "jax" in saved or "nvdiffrast_tpu" in saved
        sys.modules["nvdiffrast_tpu.ops"] = sys
        assert "nvdiffrast_tpu" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
