"""The port's CUDA kernels against their plain PyTorch twins, on a GPU.

Marked `cuda`; each test skips where torch sees no CUDA device. This
file imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import antialias_cuda as ac
from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
from nvdiffrast_tpu_torch.ops import pipeline as pl
from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
from nvdiffrast_tpu_torch.ops import texture as tx
from nvdiffrast_tpu_torch.ops import texture_cuda as tc
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


# ---------------------------------------------------------------------------
# The textured forward's kernels: all bit for bit with their twins.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,make", SCENES, ids=[s[0] for s in SCENES])
def test_rasterize_db_kernel_matches_twin(dev, name, make):
    pos, tri, res = make()
    p, t = inputs_from_numpy(pos, tri, device=dev)
    rec, aabb = rc.build_records(p, t, res)
    before = rc.DB_KERNEL.launches
    got = rc.rasterize_records(rec, aabb, res, emit_db=True)
    ref = rc.rasterize_records_plain(rec, aabb, res, emit_db=True)
    plain = rc.rasterize_records(rec, aabb, res)
    torch.cuda.synchronize()
    assert rc.DB_KERNEL.launches == before + 1
    assert len(got) == 8
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for a, b in zip(got[:4], plain):  # the db variant shades identically
        assert torch.equal(a, b)
    assert float(got[4].abs().max()) > 0


def _textured_scene(dev, B, seed):
    """A sphere scene with spherical uvs: (pos, tri, uv) on `dev`."""
    from nvdiffrast_tpu_torch.models import primitives
    pos, tri, _, _ = sphere_scene(B=B, seed=seed)
    _, vtxp, _, _ = primitives.uv_sphere(8, 12)
    uv = np.stack([np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi], axis=1)
    return inputs_from_numpy(pos, tri, uv.astype(np.float32), device=dev)


@pytest.mark.parametrize("B,A,diff_list", [(1, 2, (0, 1)), (2, 5, (3, 1)),
                                           (2, 3, ()), (1, 16, tuple(range(16)))])
def test_interp_kernel_matches_twin(dev, B, A, diff_list):
    p, t, _ = _textured_scene(dev, B, seed=B)
    flat = [x.reshape(-1) for x in rc.rasterize_fused(p, t, (48, 64), emit_db=True)]
    attr = torch.from_numpy(np.random.default_rng(A).standard_normal(
        (int(t.max()) + 1, A)).astype(np.float32)).to(dev)
    tbl = pl._attr_table(attr, t, 1, t.shape[0])
    u, v, _, idf, *db = flat
    args = (tbl, u, v, idf, tuple(db) if diff_list else None, diff_list)
    before = ic.KERNEL.launches
    got = ic.interp_forward(*args)
    ref = ic.interp_forward_plain(*args)
    torch.cuda.synchronize()
    assert ic.KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-nearest",
                                         "linear-mipmap-linear"])
def test_texture_kernel_matches_twin(dev, filter_mode, boundary_mode, D):
    B, H, W = 2, 40, 72
    N = B * H * W
    rng = np.random.RandomState(D)
    tex = torch.from_numpy(rng.rand(D, 32, 64, 3).astype(np.float32)).to(dev)
    levels = [tex] + (tx.build_mip_stack(tex) if "mipmap" in filter_mode else [])
    meta, _ = tx._static_meta(levels)
    flat = tx._pack_pyramid(levels)
    u, v = (torch.from_numpy(rng.uniform(-0.2, 1.2, N).astype(np.float32)).to(dev)
            for _ in range(2))
    u[:4] = torch.tensor([0.0, 1.0, -1.0, 1.0 - 0.5 / 64])
    fl = torch.from_numpy(rng.uniform(0, len(meta) - 1, N).astype(np.float32)).to(dev)
    fl[4:12] = torch.arange(8.0).clamp(max=len(meta) - 1)
    args = (flat, u, v, fl, meta, (B, H, W), D > 1, boundary_mode, filter_mode)
    before = tc.KERNEL.launches
    got = tc.sample(*args)
    ref = tc.sample_plain(*args)
    torch.cuda.synchronize()
    assert tc.KERNEL.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name,make,C", [
    ("sphere_b1", SCENES[0][1], 3), ("sphere_b2", SCENES[1][1], 5),
    ("random_b2", SCENES[2][1], 1)], ids=["sphere_b1_c3", "sphere_b2_c5", "random_b2_c1"])
def test_aa_kernel_matches_twin(dev, name, make, C):
    pos, tri, res = make()
    p, t = inputs_from_numpy(pos, tri, device=dev)
    B, T = pos.shape[0], tri.shape[0]
    n = B * res[0] * res[1]
    _, _, zw, idf = (x.reshape(n) for x in rc.rasterize_fused(p, t, res))
    ct = torch.from_numpy(np.random.default_rng(C).random((C, n), dtype=np.float32)).to(dev)
    ftable = _build_tables(p, t, build_opposite_table(t), *res)[0]
    args = (ct, idf, zw, ftable, (B,) + res, T)
    before = ac.KERNEL.launches
    got = ac.aa_cols(*args)
    ref = ac.aa_cols_plain(*args)
    torch.cuda.synchronize()
    assert ac.KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert int((got[4] != 0).sum()) > 10


@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-nearest",
                                         "linear-mipmap-linear"])
def test_render_pipeline_textured_gpu_matches_cpu(dev, filter_mode):
    res = (64, 80)
    p, t, a = _textured_scene("cpu", 2, seed=9)
    tex = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 64, 3).astype(np.float32))
    cpu = dr.render_pipeline_textured(p, t, a, tex, res, filter_mode=filter_mode)
    with torch.no_grad():
        gpu = dr.render_pipeline_textured(p.to(dev), t.to(dev), a.to(dev), tex.to(dev),
                                          res, filter_mode=filter_mode)
        again = dr.render_pipeline_textured(p.to(dev), t.to(dev), a.to(dev), tex.to(dev),
                                            res, filter_mode=filter_mode)
    assert torch.equal(gpu, again)
    # The card's log2 may differ from the CPU's by an ulp: a mip level can
    # flip where flevel sits on an integer (linear-mipmap-nearest).
    bad = ((gpu.cpu() - cpu).abs() > 1e-5).any(-1)
    assert int(bad.sum()) <= max(1, 1e-4 * bad.numel())


# ---------------------------------------------------------------------------
# The textured backward's kernels.
# ---------------------------------------------------------------------------

def _texture_case(dev, D, L_hot=0):
    """A 32x64x3 pyramid (D textures), B = 2 images of 40x72 pixels with
    uv in [-0.2, 1.2] and flevels over every level; the first L_hot
    pixels of each image sample uv (0, 0) at level 0 (a hot spot)."""
    B, H, W = 2, 40, 72
    N = B * H * W
    rng = np.random.RandomState(10 + D)
    tex = torch.from_numpy(rng.rand(D, 32, 64, 3).astype(np.float32)).to(dev)
    levels = [tex] + tx.build_mip_stack(tex)
    meta, n_tex = tx._static_meta(levels)
    flat = tx._pack_pyramid(levels)
    u, v = (rng.uniform(-0.2, 1.2, N).astype(np.float32) for _ in range(2))
    fl = rng.uniform(0, len(meta) - 1, N).astype(np.float32)
    fl[4:12] = np.arange(8.0).clip(max=len(meta) - 1)
    for b in range(B):
        s = slice(b * H * W, b * H * W + L_hot)
        u[s] = v[s] = fl[s] = 0.0
    gc = rng.standard_normal((3, N)).astype(np.float32)
    return (flat, *inputs_from_numpy(u, v, fl, gc, device=dev)), meta, n_tex, (B, H, W)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
@pytest.mark.parametrize("filter_mode", ["linear-mipmap-nearest", "linear-mipmap-linear"])
def test_texture_bwd_kernel_matches_twin(dev, filter_mode, boundary_mode, D):
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb
    (flat, u, v, fl, gc), meta, _, shape = _texture_case(dev, D)
    args = (flat, u, v, fl, gc, meta, shape, D > 1, boundary_mode, filter_mode)
    before = tb.BWD_KERNEL.launches
    got = tb.texture_bwd(*args)
    ref = tb.texture_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tb.BWD_KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("D,boundary_mode,filter_mode,hot", [
    (1, "wrap", "linear-mipmap-linear", 2000), (2, "zero", "linear-mipmap-linear", 0),
    (1, "clamp", "linear-mipmap-nearest", 0), (2, "wrap", "linear-mipmap-nearest", 1500)])
def test_texture_grad_kernel_matches_twin(dev, D, boundary_mode, filter_mode, hot):
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb
    (flat, u, v, fl, gc), meta, n_tex, shape = _texture_case(dev, D, hot)
    args = (u, v, fl, gc, meta, n_tex, shape, D > 1, boundary_mode, filter_mode)
    before = tb.GRAD_KERNEL.launches
    got = tb.texture_grad(*args)
    again = tb.texture_grad(*args)
    ref = tb.texture_grad_plain(*args)
    torch.cuda.synchronize()
    assert tb.GRAD_KERNEL.launches == before + 2
    assert torch.equal(got, again)
    # float64 sums in two orders, each rounded once: within 1 ulp.
    ulp = torch.from_numpy(np.spacing(np.abs(ref.cpu().numpy()))).to(dev)
    assert bool(((got - ref).abs() <= ulp).all())
    if hot:  # the hot texels' segments span many pieces
        _, off, _, _ = tb.grad_entries(u, v, fl, meta, n_tex, shape, D > 1,
                                       boundary_mode, filter_mode)
        assert int((off[1:] - off[:-1]).max()) > 4 * tb.PIECE


def _textured_bwd_case(dev, B, seed):
    """Forward saved state of render_pipeline_textured on a sphere scene
    with spherical uvs, with seeded cotangents for the backward kernels."""
    from nvdiffrast_tpu_torch.ops import pipeline_tex as ptx
    p, t, a = _textured_scene(dev, B, seed)
    tex = torch.from_numpy(np.random.RandomState(seed).rand(1, 32, 64, 3).astype(
        np.float32)).to(dev)
    res = (48, 64)
    _, saved, meta = ptx._ptex_fwd_core(p, a, tex, t, t, build_opposite_table(t), res,
                                        "linear-mipmap-linear", "wrap", -1)
    return p, t, a, saved, res


@pytest.mark.parametrize("B", [1, 2])
def test_interp_raster_bwd_tex_kernel_matches_twin(dev, B):
    from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as ptb
    p, t, a, saved, res = _textured_bwd_case(dev, B, seed=B)
    T = t.shape[0]
    idf, db, vtbl = saved[2], saved[3:7], saved[-1]
    N = idf.shape[0]
    rng = np.random.default_rng(B)
    gu, gv = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
              for _ in range(2))
    gda4 = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32)).to(dev)
    args = (pl._attr_table(a, t, B, T), vtbl, idf, gu, gv, gda4, torch.stack(db), res, T)
    before = ptb.KERNEL.launches
    got = ptb.interp_raster_bwd_tex(*args)
    ref = ptb.interp_raster_bwd_tex_plain(*args)
    torch.cuda.synchronize()
    assert ptb.KERNEL.launches == before + 1
    assert torch.equal(got, ref)
    assert float(got[2:11].abs().max()) > 0


@pytest.mark.parametrize("B", [1, 2])
def test_grad_scatter_da4_kernel_matches_twin(dev, B):
    from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as ptb
    p, t, a, saved, res = _textured_bwd_case(dev, B, seed=4 + B)
    T = t.shape[0]
    u, v, idf = saved[:3]
    color, al0, ax0, al1, ax1, vtbl = saved[-6:]
    N = idf.shape[0]
    rng = np.random.default_rng(B)
    dy = torch.from_numpy(rng.standard_normal((3, N)).astype(np.float32) * 1e-3).to(dev)
    _, dd2, rid2 = ptb.aa_bwd_slim(dy, color, idf, (al0, ax0, al1, ax1), (B,) + res, T)
    gs = torch.from_numpy(rng.standard_normal((11, N)).astype(np.float32)).to(dev)
    da4 = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32)).to(dev)
    live = (idf > 0).float()
    gs, da4 = gs * live, da4 * live
    sargs = (pl.own_rows(idf, T, res), gs, dd2, rid2, u, v, ax0, ax1, vtbl, res)
    before = pb.SCATTER_KERNEL.launches
    got = pb.grad_scatter(*sargs, da4=da4)
    again = pb.grad_scatter(*sargs, da4=da4)
    ref = pb.grad_scatter_plain(*sargs, da4=da4)
    torch.cuda.synchronize()
    assert pb.SCATTER_KERNEL.launches == before + 2
    assert int((dd2 != 0).sum()) > 10
    for x, y, z in zip(got, again, ref):
        assert torch.equal(x, y)
        assert rows_close(x, z, 1e-6)
        assert x.abs().max() > 0


@pytest.mark.parametrize("filter_mode,boundary_mode,D", [
    ("linear-mipmap-linear", "wrap", 1), ("linear-mipmap-nearest", "zero", 2)])
def test_render_pipeline_textured_grads_gpu_repeatable_and_match_cpu(
        dev, filter_mode, boundary_mode, D):
    from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pbk
    from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as ptb
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb
    res = (64, 80)
    p, t, a = _textured_scene("cpu", 2, seed=9)
    tex = torch.from_numpy(np.random.RandomState(0).rand(D, 32, 64, 3).astype(np.float32))

    def grads(device):
        xs = [x.to(device).requires_grad_() for x in (p, a, tex)]
        img = dr.render_pipeline_textured(xs[0], t.to(device), xs[1], xs[2], res,
                                          filter_mode=filter_mode,
                                          boundary_mode=boundary_mode,
                                          pos_gradient_boost=2.0)
        return torch.autograd.grad(img.square().mean(), xs)

    kernels = (tb.BWD_KERNEL, tb.GRAD_KERNEL, ptb.KERNEL, pbk.SCATTER_KERNEL)
    before = [k.launches for k in kernels]
    gpu = grads(dev)
    again = grads(dev)
    cpu = grads("cpu")
    torch.cuda.synchronize()
    assert all(k.launches == n + 2 for k, n in zip(kernels, before))
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        # The kernels equal their twins but for float64 sum orders; a mip
        # level may flip where the card's log2 differs by an ulp.
        assert float((g.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        assert float(ref.abs().max()) > 0


# ---------------------------------------------------------------------------
# The standalone ops' backward kernels (B6, B8, B9, B10) and the ops.
# ---------------------------------------------------------------------------

def _ulp_close(got, ref64):
    """Each float32 value within 1 ulp of the float64 reference."""
    ref = ref64.float()
    ulp = torch.from_numpy(np.spacing(ref.abs().cpu().numpy())).to(got.device)
    return bool(((got.double() - ref64).abs() <= ulp.double()).all())


@pytest.mark.parametrize("K,T,N", [(9, 300, 5000), (48, 17, 100001)])
def test_table_take_kernel_matches_twin(dev, K, T, N):
    from nvdiffrast_tpu_torch.ops import gather as tg
    rng = np.random.RandomState(K)
    tbl = torch.from_numpy(rng.randn(K, T).astype(np.float32)).to(dev)
    rid = torch.from_numpy(rng.randint(-2, T + 2, N).astype(np.int32)).to(dev)
    before = tg.KERNEL.launches
    got = tg.table_take(tbl, rid)
    ref = tg.table_take_plain(tbl, rid)
    torch.cuda.synchronize()
    assert tg.KERNEL.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("K,R,N,hot", [(9, 40, 1 << 15, 0), (48, 300, 5000, 0),
                                       (3, 8, 400000, 300000)])
def test_scatter_rows_kernel_within_one_ulp(dev, K, R, N, hot):
    from nvdiffrast_tpu_torch.ops import scatter as ts
    rng = np.random.RandomState(K)
    ids = rng.randint(-3, R + 3, N).astype(np.int32)
    if hot:
        ids[rng.choice(N, hot, replace=False)] = 1
    vals = rng.randn(K, N).astype(np.float32)
    vals[:, rng.rand(N) < 0.1] = 0.0
    ti, tv = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    before = ts.KERNEL.launches
    got = ts.scatter_add_by_id(ti, tv, R)
    again = ts.scatter_add_by_id(ti, tv, R)
    torch.cuda.synchronize()
    assert ts.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    ok = (ids >= 0) & (ids < R)
    acc = np.zeros((R, K), np.float64)
    np.add.at(acc, ids[ok], vals[:, ok].T.astype(np.float64))
    assert _ulp_close(got, torch.from_numpy(acc).to(dev))


def _op_scene(dev, B=2, seed=3, res=(64, 80)):
    pos, tri, attr, cidx = sphere_scene(B=B, seed=seed)
    return inputs_from_numpy(pos, tri, attr, cidx, device=dev) + (res,)


@pytest.mark.parametrize("per_image,A,diff_list", [(True, 3, ()), (False, 5, (3, 1)),
                                                   (True, 16, tuple(range(16)))])
def test_interp_bwd_kernel_matches_twin(dev, per_image, A, diff_list):
    p, t, _, c, res = _op_scene(dev)
    B, T, N = p.shape[0], t.shape[0], p.shape[0] * res[0] * res[1]
    rng = np.random.default_rng(A)
    attr = torch.from_numpy(rng.standard_normal((B if per_image else 1, p.shape[1], A))
                            .astype(np.float32)).to(dev)
    outs = rc.rasterize_fused(p, t, res, emit_db=True)
    u, v, _, idf, *db = (o.reshape(N) for o in outs)
    tbl = pl._attr_table(attr, c, B if per_image else 1, T)
    D = len(diff_list)
    gy = torch.from_numpy(rng.standard_normal((A, N)).astype(np.float32)).to(dev)
    gda = torch.from_numpy(rng.standard_normal((2 * D, N)).astype(np.float32)).to(dev)
    args = (tbl, u, v, idf, tuple(db) if D else None, gy, gda if D else None, diff_list, T,
            res[0] * res[1] if per_image else 0)
    before = ic.BWD_KERNEL.launches
    got = ic.interp_backward(*args)
    ref = ic.interp_backward_plain(*args)
    torch.cuda.synchronize()
    assert ic.BWD_KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("B,C", [(1, 3), (2, 5)])
def test_aa_bwd_kernel_matches_twin(dev, B, C):
    p, t, _, _, res = _op_scene(dev, B=B, seed=B)
    T, N = t.shape[0], B * res[0] * res[1]
    _, _, zw, idf = (o.reshape(N) for o in rc.rasterize_fused(p, t, res))
    rng = np.random.default_rng(C)
    ct = torch.from_numpy(rng.random((C, N), dtype=np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((C, N)).astype(np.float32)).to(dev)
    ftable, vtbl, _, _ = _build_tables(p, t, build_opposite_table(t), *res)
    _, res4 = ac.aa_forward(ct, idf, zw, ftable, (B,) + res, T)
    before = ac.BWD_KERNEL.launches
    got = ac.aa_backward(dy, ct, idf, vtbl, res4, (B,) + res, T)
    ref = ac.aa_backward_plain(dy, ct, idf, vtbl, res4, (B,) + res, T)
    torch.cuda.synchronize()
    assert ac.BWD_KERNEL.launches == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert int((got[2] != 0).any(0).sum()) > 10


def test_composed_ops_grads_gpu_repeatable_and_match_cpu(dev):
    from nvdiffrast_tpu_torch.ops import gather as tg
    from nvdiffrast_tpu_torch.ops import scatter as ts
    p, t, a, c, res = _op_scene(dev, seed=6)

    def grads(device):
        pv = p.to(device).requires_grad_()
        av = a.to(device).requires_grad_()
        tt, cc = t.to(device), c.to(device)
        rast, db = dr.rasterize(None, pv, tt, res)
        col, da = dr.interpolate(av, rast, cc, rast_db=db, diff_attrs="all")
        img = dr.antialias(col, rast, pv, tt, pos_gradient_boost=2.0)
        return torch.autograd.grad(img.square().mean() + 0.1 * da.square().mean(), (pv, av))

    kernels = (rc.DB_KERNEL, ic.KERNEL, ic.BWD_KERNEL, ac.KERNEL, ac.BWD_KERNEL, tg.KERNEL,
               ts.KERNEL)
    before = [k.launches for k in kernels]
    gpu = grads(dev)
    again = grads(dev)
    cpu = grads("cpu")
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kernels, before))
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        assert float((g.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert float(ref.abs().max()) > 0


def test_render_pipeline_textured_linear_grads_gpu_match_cpu(dev):
    res = (64, 80)
    p, t, a = _textured_scene("cpu", 2, seed=9)
    tex = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 64, 3).astype(np.float32))

    def grads(device):
        xs = [x.to(device).requires_grad_() for x in (p, a, tex)]
        img = dr.render_pipeline_textured(xs[0], t.to(device), xs[1], xs[2], res,
                                          filter_mode="linear", boundary_mode="wrap")
        return torch.autograd.grad(img.square().mean(), xs)

    gpu = grads(dev)
    again = grads(dev)
    cpu = grads("cpu")
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        assert float((g.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_cube_fit_converges_on_gpu(dev):
    from nvdiffrast_tpu_torch.models.fit_cube import CubeFitModel
    m = CubeFitModel(resolution=16, seed=0, device=dev)
    for _ in range(150):
        m.step()
    assert m.geometric_error() < 0.08
