"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Marked `cuda`; each test skips where torch sees no CUDA device. This
file imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nvdiffrast_tpu_torch.ops import pipeline as pl
from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops.antialias import _build_tables
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import random_scene, sphere_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the GPU)")
    return torch.device("cuda", 0)


SCENES = [
    ("sphere_b1", lambda: sphere_scene(B=1, seed=1)[:2] + ((48, 64),)),
    ("sphere_b2", lambda: sphere_scene(B=2, seed=2)[:2] + ((130, 96),)),
    ("random_b2", lambda: random_scene(1, B=2) + ((67, 130),)),
]


@pytest.mark.parametrize("name,make", SCENES, ids=[s[0] for s in SCENES])
def test_rasterize_kernel_matches_twin(dev, name, make):
    pos, tri, res = make()
    p, t = inputs_from_numpy(pos, tri, device=dev)
    rec, aabb = rc.build_records(p, t, res)
    before = rc.KERNEL.launches
    got = rc.rasterize_records(rec, aabb, res)
    ref = rc.rasterize_records_plain(rec, aabb, res)
    torch.cuda.synchronize()
    assert rc.KERNEL.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # The card's prepass + twin equals the CPU path.
    cpu = rc.rasterize_fused(p.cpu(), t.cpu(), res)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("seed,B,T,res", [
    (10, 1, 600, (192, 256)),   # 3 record batches, the last one partial
    (11, 3, 257, (33, 47)),     # one record past a batch, odd image
    (12, 2, 1000, (130, 1030)),
])
def test_rasterize_kernel_random_stress(dev, seed, B, T, res):
    pos, tri = random_scene(seed, B=B, V=300, T=T)
    p, t = inputs_from_numpy(pos, tri, device=dev)
    rec, aabb = rc.build_records(p, t, res)
    got = rc.rasterize_records(rec, aabb, res)
    ref = rc.rasterize_records_plain(rec, aabb, res)
    assert int((got[3] > 0).sum()) > 100
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_shade_kernel_matches_twin(dev):
    pos, tri, attr, cidx = sphere_scene(B=2, seed=5, A=5)
    res = (48, 64)
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx, device=dev)
    B, T = pos.shape[0], tri.shape[0]
    n = B * res[0] * res[1]
    flat = [x.reshape(n) for x in rc.rasterize_fused(p, t, res)]
    ftable = _build_tables(p, t, build_opposite_table(t), *res)[0]
    args = (pl._attr_table(a, c, B, T), ftable, *flat, res, T)
    before = pc.KERNEL.launches
    got = pc.shade_cols(*args)
    ref = pc.shade_cols_plain(*args)
    torch.cuda.synchronize()
    assert pc.KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert int((got[4] != 0).sum()) > 10


def test_render_pipeline_gpu_matches_cpu(dev):
    pos, tri, attr, cidx = sphere_scene(B=2, seed=6)
    res = (64, 80)
    args = inputs_from_numpy(pos, tri, attr, cidx)
    cpu = pl.render_pipeline(*args[:3], res, attr_idx=args[3])
    gpu = pl.render_pipeline(*(x.to(dev) for x in args[:3]), res,
                             attr_idx=args[3].to(dev))
    again = pl.render_pipeline(*(x.to(dev) for x in args[:3]), res,
                               attr_idx=args[3].to(dev))
    assert torch.equal(gpu, again)
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-5)
