"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Marked `cuda`; each test skips where torch sees no CUDA device. This
file imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nvdiffrast_tpu_torch.ops import pipeline as pl
from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
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


def _with_attr(pos, tri, res, seed, A=3):
    attr = np.random.default_rng(seed).standard_normal(
        (pos.shape[0], pos.shape[1], A)).astype(np.float32)
    return pos, tri, attr, tri, res


BWD_SCENES = [
    ("sphere_b1", lambda: sphere_scene(B=1, seed=1) + ((48, 64),)),
    ("sphere_b2_a5", lambda: sphere_scene(B=2, seed=2, A=5) + ((130, 96),)),
    ("random_b2", lambda: _with_attr(*random_scene(1, B=2), (67, 130), seed=3)),
]


def rows_close(got, ref, rel):
    """Each row of `got` within rel * max|row of ref| (all-zero rows exact)."""
    scale = ref.abs().amax(1, keepdim=True)
    return bool(((got - ref).abs() <= rel * scale).all())


@pytest.mark.parametrize("name,make", BWD_SCENES, ids=[s[0] for s in BWD_SCENES])
def test_backward_kernels_match_twins(dev, name, make):
    pos, tri, attr, cidx, res = make()
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx, device=dev)
    T = t.shape[0]
    _, saved = pl._pipeline_fwd_core(p, a, t, c, build_opposite_table(t), res)
    b0, b1, idf, c0, al0, ax0, al1, ax1, atbl, vtbl = saved
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(c0.shape)).astype(np.float32) * 1e-3).to(dev)
    args = (atbl, vtbl, idf, c0, dy, (al0, ax0, al1, ax1), res, T)
    before = pb.BWD_KERNEL.launches, pb.SCATTER_KERNEL.launches
    got = pb.pipeline_bwd(*args)
    ref = pb.pipeline_bwd_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    gs, dd2, rid2 = got
    assert int((dd2 != 0).sum()) > 10

    sargs = (pl.own_rows(idf, T, res), gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, res)
    got = pb.grad_scatter(*sargs)
    again = pb.grad_scatter(*sargs)
    ref = pb.grad_scatter_plain(*sargs)
    torch.cuda.synchronize()
    assert (pb.BWD_KERNEL.launches, pb.SCATTER_KERNEL.launches) == (
        before[0] + 1, before[1] + 2)
    for x, y, z in zip(got, again, ref):
        assert torch.equal(x, y)
        assert rows_close(x, z, 1e-6)
        assert x.abs().max() > 0


def _grads(dev, pos, tri, attr, cidx, res):
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx, device=dev)
    p.requires_grad_()
    a.requires_grad_()
    img = pl.render_pipeline(p, t, a, res, attr_idx=c, pos_gradient_boost=2.0)
    return torch.autograd.grad((img ** 2).mean(), (p, a))


def test_render_pipeline_grads_gpu_repeatable_and_match_cpu(dev):
    pos, tri, attr, cidx = sphere_scene(B=2, seed=6)
    res = (64, 80)
    gpu = _grads(dev, pos, tri, attr, cidx, res)
    again = _grads(dev, pos, tri, attr, cidx, res)
    cpu = _grads("cpu", pos, tri, attr, cidx, res)
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        g = g.cpu()
        # Same rasterizer, shade and per-pixel backward bits; only the
        # float64 sum order of the scatter and the vertex sums differ.
        assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert float(ref.abs().max()) > 0
