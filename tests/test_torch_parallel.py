"""The port's parallel layer on torch.distributed, on the CPU with gloo.

One module-scoped fixture starts 4 ranks once (tests/_torch_dist_worker.py,
subprocesses meeting through a file store under tmp_path, so parallel
test workers never share a port; LOCAL_WORLD_SIZE=2 makes two "hosts")
and, while they run, ``graft_entry.dryrun_multichip(4, "cpu")`` (it
starts its own 4 ranks); the tests read what each wrote:

* meshes: make_mesh((2, 2)) and its ValueError, default_mesh, pod_mesh
  as 2 hosts x 2 both ways, local_batch_slice disjoint and covering;
* the row-band render of 4 bands at 32x48, B = 2, against the port's
  single-process render: rast bit for bit, the image within 1e-5, the
  cross-band pairs firing; the gradients of sum((img - 0.3)**2) to pos
  and the colours within 1e-5 (tests/test_spatial.py's bars), the same
  on every rank;
* two SGD steps of shard_map_train_step over the dp axis against the
  single-process global step, within 1e-6 of the parameter's largest
  entry, the updates within 1e-5 of the largest update.

Also the dry run's results (finite losses, each band within 1e-4 of the
single-process render) and ``multihost.initialize`` in this process (a
no-op without a job, an error, not a fallback, with a broken one). The
single-process step is held to JAX's ``shard_map_train_step`` in
tests/test_torch_parallel_boundary.py, beside the other JAX comparisons,
so that this file compiles no JAX program.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parity  # noqa: F401  (one intra-op thread a process)
import _torch_dist_worker as worker
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.graft_entry import dryrun_multichip
from nvdiffrast_tpu_torch.parallel import multihost

WORLD = 4
_JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """([(json, arrays)] of the 4 ranks, the dry run's results)."""
    d = tmp_path_factory.mktemp("torch_dist")
    env = {k: v for k, v in os.environ.items() if k not in _JOB_ENV}
    env.update(LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker.__file__, "--rank", str(r), "--world",
                               str(WORLD), "--dir", str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        dry = dryrun_multichip(WORLD, "cpu")
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    got = []
    for r in range(WORLD):
        with open(d / f"rank{r}.json") as f:
            js = json.load(f)
        got.append((js, dict(np.load(d / f"rank{r}.npz"))))
    return got, dry


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def test_make_mesh(ranks):
    for r, (js, _) in enumerate(ranks):
        m = js["mesh"]
        assert m["names"] == ["dp", "sp"] and m["ranks"] == [[0, 1], [2, 3]]
        assert m["coord"] == [r // 2, r % 2]
        assert js["mesh_error"] == "mesh shape (3,) does not match 4 ranks"


def test_default_mesh(ranks):
    # 4 ranks: sp = 2 (4 does not exceed 4), dp = 2.
    for js, _ in ranks:
        assert js["default_mesh"] == {"names": ["dp", "sp"], "ranks": [[0, 1], [2, 3]]}


def test_pod_mesh(ranks):
    for r, (js, _) in enumerate(ranks):
        over = js["pod_mesh"]["True"]
        assert over["names"] == ["dp", "sp"] and over["ranks"] == [[0, 1], [2, 3]]
        assert over["coord"] == [r // 2, r % 2]  # dp = host, sp = local rank
        within = js["pod_mesh"]["False"]
        assert within["names"] == ["sp", "dp"] and within["ranks"] == [[0, 2], [1, 3]]
        assert within["coord"] == [r % 2, r // 2]


def test_local_batch_slice(ranks):
    for over in ("True", "False"):
        slices = {tuple(js["pod_mesh"][over]["slice"]) for js, _ in ranks}
        assert slices == {(0, 4), (4, 4)}  # one per dp index, disjoint, covering 8
    dp = sorted({tuple(js["dp_slice"]) for js, _ in ranks})
    assert dp == [(0, 2), (2, 2)]


def _single_process_render(pos, tri, col, cidx, res):
    """The port's render of the full image: (rast, un-antialiased image,
    image)."""
    rast, _ = dr.rasterize(None, pos, tri, res, grad_db=False)
    img, _ = dr.interpolate(col[None], rast, cidx)
    return rast, img, dr.antialias(img, rast, pos, tri)


def test_sp_render_matches_single_process(ranks):
    pos, tri, col, cidx = (torch.from_numpy(x) for x in worker.sp_scene())
    H, W = worker.SP_RES
    hb = H // WORLD
    with torch.no_grad():
        rast, img, ref = _single_process_render(pos, tri, col, cidx, (H, W))
    for k, (_, arr) in enumerate(ranks):
        rows = slice(k * hb, (k + 1) * hb)
        np.testing.assert_array_equal(arr["rast"], rast[:, rows].numpy())
        np.testing.assert_allclose(arr["band"], ref[:, rows].numpy(), atol=1e-5, rtol=1e-5)
    # The cross-band pairs fire: rows at band edges differ from the
    # un-antialiased image.
    d = (img - ref).abs().sum(-1).numpy()
    edges = [k * hb + o for k in range(1, WORLD) for o in (-1, 0)]
    assert (d[:, edges] > 0).any()


def test_sp_gradients_match_single_process(ranks):
    pos, tri, col, cidx = (torch.from_numpy(x) for x in worker.sp_scene())
    p, c = pos.clone().requires_grad_(), col.clone().requires_grad_()
    out = _single_process_render(p, tri, c, cidx, worker.SP_RES)[2]
    gp, gc = torch.autograd.grad(torch.sum((out - worker.SP_TARGET) ** 2), (p, c))
    assert float(gp.abs().sum()) > 0
    for _, arr in ranks:
        np.testing.assert_allclose(arr["g_pos"], gp.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(arr["g_col"], gc.numpy(), atol=1e-5, rtol=1e-5)
        # Every rank holds the same summed gradients.
        np.testing.assert_array_equal(arr["g_pos"], ranks[0][1]["g_pos"])
        np.testing.assert_array_equal(arr["g_col"], ranks[0][1]["g_col"])


def test_dp_step_matches_single_process(ranks):
    ref, ref_losses = worker.global_steps()
    start = worker.dp_scene()[2]
    moved = np.abs(ref - start).max()
    assert moved > 0  # the steps moved the colours
    for js, arr in ranks:
        assert (np.abs(arr["dp_col"] - ref) <= 1e-6 * np.abs(ref).max()).all()
        # The updates themselves (4e-4 at most, so the bar above alone
        # would pass any small gradient): within 1e-5 of the largest.
        assert (np.abs((arr["dp_col"] - start) - (ref - start)) <= 1e-5 * moved).all()
        np.testing.assert_allclose(js["dp_losses"], ref_losses, rtol=1e-6)


def test_dryrun_multichip_cpu(runs):
    out = runs[1]
    assert [r["rank"] for r in out] == list(range(WORLD))
    for r in out:
        assert np.isfinite(r["dp_loss"]) and np.isfinite(r["sp_loss"]) and r["sp_err"] < 1e-4
        assert r["launches"] == {}  # CPU tensors run the plain twins
    # The losses are means / sums over the ranks: the same on each.
    assert len({(r["dp_loss"], r["sp_loss"]) for r in out}) == 1


def test_initialize_noop_and_no_fallback(monkeypatch):
    for k in _JOB_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device_type="cpu")
    assert not dist.is_initialized()  # no job: nothing to start
    # A job is configured (torchrun's variables) but cannot start: an
    # error, never a silent single process.
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        multihost.initialize(device_type="cpu")
    assert not dist.is_initialized()
