"""The envphong fit on the port's batched path, the benchmark's plain
reference of it, its cube-stage spans and its cell (CPU, plain twins).

* ``models.fit_envphong``'s ``render_refl`` and ``shade`` over B views
  give the bits of B one-view calls.
* The benchmark's call (``perfbench/configs/envphong_cube.py``) against
  its float64 reference (``envphong_cube_ref.py``, ``perfbench/ref/cube.py``)
  at 2 views of 40x48 with a 6x16x16x3 map and its full pyramid: image,
  map gradient and Phong gradient within the bars below, which the
  reference itself misses with its data path in bfloat16; the
  reference's cube-corner rule, in float64 and bfloat16.
* A tiny envphong cell through ``perfbench/run.py`` in a throwaway
  checkout: ``correct`` true, and false under the ``altered`` fault.
* Every ``nvdr.tex.cube.*`` and ``nvdr.envphong.*`` span under
  torch.profiler, and the two cube metrics on a trace built by hand.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.models.fit_envphong import render_refl, shade
from perfbench import harness
from perfbench import scene as sc
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_cpu import run_cpu

CFG = harness.load_module(tiny.REPO / "perfbench" / "configs" / "envphong_cube.py")
REF = harness.load_module(tiny.REPO / "perfbench" / "configs" / "envphong_cube_ref.py")
SMALL = {"mesh": {"kind": "uv_sphere", "n_lat": 12, "n_lon": 16},
         "env": {"faces": 6, "width": 16, "channels": 3}}
RES = (40, 48)
SEED = 2 ** 31 + 77

# Bars of the port (float32, plain twins) against the float64 reference.
# Image: largest absolute difference 1e-5. Values lie in [0, ~2] (texels
# in [0, 1] plus the Phong term); a pixel is ~20 float32 operations deep
# from the barycentrics to the blend (read 2.1e-6); bfloat16 data reads
# 6e-2. Gradients: the relative norm of the difference, 1e-5. The map's
# gradient sums float32 tap products in float64 and rounds once per
# texel (read 1.8e-6), the Phong terms' sums over ~1,000 pixels in
# float32 (read 3.2e-7); bfloat16 data reads 4.6e-2 and 2.0e-2.
IMAGE_BAR = 1e-5
GRAD_BAR = 1e-5


def _config():
    cfg = json.loads((tiny.REPO / "perfbench" / "configs" / "envphong_cube.json").read_text())
    cfg.update(SMALL)
    return cfg


def _scene(B=2):
    cfg = _config()
    scene = CFG.build(cfg, SEED, "cpu")
    views = torch.as_tensor(sc.view_matrices(cfg["camera"], B, np.random.default_rng(3)))
    return cfg, scene, views


def test_batched_calls_equal_per_view_calls():
    _, scene, views = _scene(B=3)
    inp, p = scene["inputs"], scene["params"]
    campos, ldir = CFG.cameras(inp["proj_inv"], views, inp["light"])
    args = (inp["pos"], inp["tri"], inp["normals"], RES)
    with torch.no_grad():
        batch = render_refl(views, campos, *args)
        img = shade(p["env"], p["phong"][:3], p["phong"][3], *batch[:2], ldir, batch[2])
        for i in range(3):
            one = render_refl(views[i], campos[i], *args)
            for x, y in zip(batch, one):
                assert torch.equal(x[i:i + 1], y)
            img1 = shade(p["env"], p["phong"][:3], p["phong"][3], *one[:2], ldir[i], one[2])
            assert torch.equal(img[i:i + 1], img1)
    assert batch[0].shape == (3,) + RES + (3,) and batch[1].shape == (3,) + RES + (6,)
    assert 0.2 < float((~batch[2]).float().mean()) < 0.8


def _reference(cfg, scene, views, target, geom, data):
    m = REF.mesh(scene["arrays"], "cpu")
    p = {k: v.detach().to(torch.float64).requires_grad_() for k, v in scene["params"].items()}
    shared = REF.prepare(m, p, cfg, data)
    img = torch.stack([REF.render_view(m, p, shared, v, RES, cfg, geom, data).reshape(
        RES + (3,)) for v in views]).to(torch.float64)
    return img.detach(), torch.autograd.grad(((img - target) ** 2).sum(),
                                             (p["env"], p["phong"]))


def _rel(a, b):
    return float((a.to(torch.float64) - b).norm() / b.norm())


def test_port_matches_float64_reference_and_bfloat16_fails():
    cfg, scene, views = _scene()
    p = scene["params"]
    img = CFG.render(scene, p, views, RES)
    target = torch.rand(img.shape, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
    g_env, g_phong = torch.autograd.grad(((img.to(torch.float64) - target) ** 2).sum(),
                                         (p["env"], p["phong"]))
    assert p["env"].shape == (6, 16, 16, 3)
    ref_img, (r_env, r_phong) = _reference(cfg, scene, views, target, torch.float64,
                                           torch.float64)
    covered = (ref_img != 1.0).any(-1)
    assert 0.2 < float(covered.double().mean()) < 0.8
    gaps = (float((img.detach().double() - ref_img).abs().max()), _rel(g_env, r_env),
            _rel(g_phong, r_phong))
    assert gaps[0] <= IMAGE_BAR and gaps[1] <= GRAD_BAR and gaps[2] <= GRAD_BAR, gaps
    low_img, (l_env, l_phong) = _reference(cfg, scene, views, target, torch.float32,
                                           torch.bfloat16)
    low = (float((low_img - ref_img).abs().max()), _rel(l_env, r_env), _rel(l_phong, r_phong))
    assert low[0] > IMAGE_BAR or low[1] > GRAD_BAR or low[2] > GRAD_BAR, low


def test_reference_cube_corner():
    """At the cube corner (1, 1, 1) the reference's bilinear lookup at level
    0 is the mean of the three faces' corner texels (+x (0, 0), +y (w-1,
    w-1), +z (w-1, 0) as (x, y)); in bfloat16, where s * w rounds past the
    face's last texel, it stays finite (its corners are found in float64)."""
    from perfbench.ref import cube as CB

    env = torch.rand((6, 512, 512, 3), generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    d = torch.tensor([[1.0, 1.0, 1.0]], dtype=torch.float64) / 3 ** 0.5
    got = CB.sample(CB.pyramid(env, -1), d, torch.zeros(1, dtype=torch.float64))
    want = (env[0, 0, 0] + env[2, 511, 511] + env[4, 0, 511]) / 3
    assert torch.allclose(got[0], want, rtol=0, atol=1e-12)
    low = CB.pyramid(env.to(torch.bfloat16), -1)
    for x in ([0.5781, -0.5781, -0.5781], [-0.5781, -0.5781, 0.5781]):
        out = CB.sample(low, torch.tensor([x], dtype=torch.bfloat16),
                        torch.tensor([0.7], dtype=torch.bfloat16))
        assert torch.isfinite(out).all()


def _envphong_checkout(root):
    """tiny.make_checkout plus a tiny envphong cell, added as new files and
    entries beside the real cell's."""
    root = tiny.make_checkout(root)
    cfgs = root / "perfbench" / "configs"
    (cfgs / "tiny_envphong.json").write_text(json.dumps(dict(_config(), name="tiny_envphong")))
    for suffix in (".py", "_ref.py"):
        (cfgs / f"tiny_envphong{suffix}").write_text(
            (cfgs / f"envphong_cube{suffix}").read_text())
    (root / "perfbench" / "limits" / "tiny.envphong.train.json").write_text(
        json.dumps(tiny.TINY_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    real = next(c for c in bench["configs"] if c["name"] == "envphong_cube")
    bench["configs"].append(dict(real, name="tiny_envphong",
                                 file="perfbench/configs/tiny_envphong.json"))
    bench["workloads"].append({"name": "tiny.envphong.train", "config": "tiny_envphong",
                               "traffic": "train.tiny", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "envphong.train.2048x8" in m.get("workloads", ()):
            m["workloads"].append("tiny.envphong.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _envphong_checkout(tmp_path_factory.mktemp("envphong_checkout"))


@pytest.mark.parametrize("fault,correct", [(None, True), ("altered", False)])
def test_tiny_envphong_cell(checkout, fault, correct):
    line, mods = run_cpu(checkout, "tiny.envphong.train", fault=fault)
    assert line["correct"] is correct, line["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "image_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "nvdiffrast_tpu_torch" in mods and not {"jax", "nvdiffrast_tpu"} & set(mods)
    if not correct:
        assert any(c["value"] > c["limit"] for c in line["checks"].values())


CUBE_SPANS = {"nvdr.envphong.refl", "nvdr.envphong.shade", "nvdr.tex.cube.project",
              "nvdr.tex.cube.da", "nvdr.tex.cube.sample", "nvdr.tex.cube.grads",
              "nvdr.tex.cube.project_vjp", "nvdr.tex.cube.da_vjp"}


def test_cube_spans_under_profiler():
    """The envphong step emits the model's and the forward's cube spans and
    the map gradient's; a lookup whose directions and derivatives take
    gradients adds the two vjp spans, and nearest filtering the projection."""
    _, scene, views = _scene()
    p = scene["params"]
    uv = torch.nn.functional.normalize(torch.randn(1, 4, 5, 3), dim=-1).requires_grad_()
    uv_da = (0.01 * torch.randn(1, 4, 5, 6)).requires_grad_()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = CFG.render(scene, p, views, RES)
        torch.autograd.grad(img.square().mean(), (p["env"], p["phong"]))
        out = dr.texture(p["env"].detach()[None], uv, uv_da=uv_da,
                         filter_mode="linear-mipmap-linear", boundary_mode="cube")
        torch.autograd.grad(out.sum(), (uv, uv_da))
    with profile(activities=[ProfilerActivity.CPU]) as near:
        dr.texture(p["env"].detach()[None], uv.detach(), filter_mode="nearest",
                   boundary_mode="cube")
    names = {e.name for e in prof.events()}
    assert CUBE_SPANS <= names, CUBE_SPANS - names
    assert "nvdr.tex.cube.project" in {e.name for e in near.events()}


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


# A window of 1,000 us, two steps. The device is busy over [0, 100),
# [150, 250), [300, 360), [420, 520) and [600, 1000). Gaps: [100, 150)
# begins inside nvdr.tex.cube.project (cube, 50 us); [250, 300) inside
# nvdr.tex.cube.sample (cube, 50 us); [360, 420) inside the sync span
# nested in nvdr.tex.cube.grads (a sync's, not the cube's); [520, 600)
# inside nvdr.texture alone (the port's, not the cube's). Launches: 70
# and 80 in the projection, 250 in the sampler span and 460 in the
# gradient span are cube glue (4); 215 inside nvdr.kernel.* is the
# port's own kernel, 550 is the entry's glue and 900 the benchmark's.
HOST = [("perfbench.window", 0, 1000), ("nvdr.texture", 50, 600),
        ("nvdr.tex.cube.project", 60, 200), ("cudaLaunchKernel", 70, 71),
        ("cudaLaunchKernel", 80, 81), ("nvdr.tex.cube.sample", 205, 300),
        ("nvdr.kernel.nvdr_texture_cube_fwd", 210, 230), ("cudaLaunchKernel", 215, 216),
        ("cudaLaunchKernel", 250, 251), ("nvdr.tex.cube.grads", 300, 500),
        ("nvdr.sync.partials.cube_texture_grad", 350, 450), ("cuLaunchKernel", 460, 461),
        ("cudaLaunchKernelExC", 550, 551), ("aten::mse_loss", 880, 950),
        ("cudaLaunchKernel", 900, 901)]
DEVICE = [("k", 0, 100, True), ("k", 150, 250, True), ("k", 300, 360, True),
          ("Memcpy DtoH", 420, 520, False), ("k", 600, 1000, True)]


def _trace(kind="train", host=HOST, device=DEVICE):
    return {"kind": kind, "steps": 2,
            "trace": {"window_us": (0, 1000), "device": list(device), "host": list(host),
                      "calls": 2}}


def test_cube_metrics_by_hand():
    launches = _metric("cube_glue_launches_per_step.train")
    idle = _metric("cube_idle_ms_per_step.train")
    assert launches.read(_trace()) == pytest.approx(4 / 2)
    assert idle.read(_trace()) == pytest.approx((50 + 50) / 1e3 / 2)
    assert idle.read(_trace("dp")) == pytest.approx(0.05)
    assert _metric("port_idle_ms_per_step.train").read(_trace()) == \
        pytest.approx((50 + 50 + 60 + 80) / 1e3 / 2)
    # No cube span (the parent's program, or a cell without cube maps), no
    # device activity, another kind or no trace: None, and nothing raised.
    plain = [h for h in HOST if not h[0].startswith("nvdr.tex.cube.")]
    for m in (launches, idle):
        assert m.read(_trace(host=plain)) is None
        assert m.read(_trace(device=[])) is None
        assert m.read(_trace("render")) is None
        assert m.read({"kind": "train", "trace": None, "steps": 2}) is None
