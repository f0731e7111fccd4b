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
    setup = rc.setup_records(p, t, res)
    rec, aabb = setup[:2]
    before = rc.KERNEL.launches
    got = rc.rasterize_records(setup, res)
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
    setup = rc.setup_records(p, t, res)
    rec, aabb = setup[:2]
    got = rc.rasterize_records(setup, res)
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


def _partials_equal(got, ref):
    """Kernel partials (key, partial, counts) equal the twin's (key,
    tile, partial, entries) bit for bit, in the same order."""
    key, part, counts = got
    rkey, rtile, rpart, _ = ref
    tile = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device),
                                   counts.long())
    return (torch.equal(key.long(), rkey.long()) and torch.equal(tile, rtile)
            and torch.equal(part.view(torch.int64), rpart.view(torch.int64)))


def _bwd_scatter_args(dev, pos, tri, attr, cidx, res, seed=4):
    """grad_scatter's inputs from a render's saved state and a seeded dy."""
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx, device=dev)
    T = t.shape[0]
    _, saved = pl._pipeline_fwd_core(p, a, t, c, build_opposite_table(t), res)
    b0, b1, idf, c0, al0, ax0, al1, ax1, atbl, vtbl = saved
    dy = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(c0.shape)).astype(np.float32) * 1e-3).to(dev)
    gs, dd2, rid2 = pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, (al0, ax0, al1, ax1), res, T)
    return (pl.own_rows(idf, T, res), gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, res)


@pytest.mark.parametrize("name,make", BWD_SCENES, ids=[s[0] for s in BWD_SCENES])
def test_grad_scatter_partials_match_twin(dev, name, make):
    """B4's per-tile partials equal tile_partials_plain bit for bit."""
    sargs = _bwd_scatter_args(dev, *make())
    got = pb.scatter_partials(*sargs)
    assert _partials_equal(got, pb.tile_partials_plain(*sargs))
    assert got[0].shape[0] < int((sargs[1] != 0).any(0).sum() + (sargs[2] != 0).sum())


def _quad(res):
    """Two triangles past the frame: one row feeds every pixel of its half."""
    pos = np.array([[[-1.2, -1.2, 0.0, 1.0], [1.2, -1.2, 0.0, 1.0], [-1.2, 1.2, 0.0, 1.0],
                     [1.2, 1.2, 0.0, 1.0]]], np.float32)
    tri = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    attr = np.random.default_rng(1).standard_normal((1, 4, 3)).astype(np.float32)
    return pos, tri, attr, tri, res


@pytest.mark.parametrize("da4", [False, True])
def test_grad_scatter_hot_row_quad(dev, da4):
    """A quad filling 256^2: each triangle's row takes an entry from
    every pixel of its half, spread over the tiles' partials; within the
    twin's bar, repeatable, partials equal to the twin's."""
    sargs = _bwd_scatter_args(dev, *_quad((256, 256)))
    extra = {}
    if da4:
        N = sargs[0].shape[0]
        rng = np.random.default_rng(3)
        live = (sargs[1][0] != 0).float()
        gs = torch.from_numpy(rng.standard_normal((11, N)).astype(np.float32)).to(dev) * live
        extra["da4"] = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32)).to(
            dev) * live
        sargs = (sargs[0], gs) + sargs[2:]
    got = pb.grad_scatter(*sargs, **extra)
    again = pb.grad_scatter(*sargs, **extra)
    ref = pb.grad_scatter_plain(*sargs, **extra)
    for x, y, z in zip(got, again, ref):
        assert torch.equal(x, y)
        assert rows_close(x, z, 1e-6)
    part = pb.scatter_partials(*sargs, **extra)
    assert _partials_equal(part, pb.tile_partials_plain(*sargs, **extra))
    assert int(torch.bincount(part[0].long()).max()) >= 128  # a partial from every tile


def _crowded_scatter(dev, res, R, seed=7):
    """Random rows per pixel: every 16x16 tile holds more rows than the
    scratch's slots (the kernel's second pass)."""
    rng = np.random.default_rng(seed)
    H, W = res
    N = H * W
    gs = rng.standard_normal((12, N)).astype(np.float32)
    gs[:, rng.random(N) < 0.2] = 0.0
    dd2 = (rng.standard_normal((2, N)) * (rng.random((2, N)) < 0.1)).astype(np.float32)
    ax = (rng.integers(0, 3, (2, N)) + 4 * rng.integers(0, 2, (2, N))).astype(np.float32)
    vtbl = rng.uniform(-1, 1, (9, R + 1)).astype(np.float32)
    vtbl[2::3] = rng.uniform(0.5, 2.0, (3, R + 1))
    t = inputs_from_numpy(rng.integers(0, R, N).astype(np.int32), gs, dd2,
                          rng.integers(0, R, (2, N)).astype(np.int32),
                          rng.uniform(0, 0.5, N).astype(np.float32),
                          rng.uniform(0, 0.5, N).astype(np.float32), ax[0], ax[1], vtbl,
                          device=dev)
    return tuple(t) + (res,)


def test_grad_scatter_crowded_tiles(dev):
    sargs = _crowded_scatter(dev, (100, 90), 5000)
    part = pb.scatter_partials(*sargs)
    assert int((part[2] > pb.SCATTER_CAP).sum()) > 10
    assert _partials_equal(part, pb.tile_partials_plain(*sargs))
    got = pb.grad_scatter(*sargs)
    for x, y, z in zip(got, pb.grad_scatter(*sargs), pb.grad_scatter_plain(*sargs)):
        assert torch.equal(x, y)
        assert rows_close(x, z, 1e-6)


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
    setup = rc.setup_records(p, t, res)
    rec, aabb = setup[:2]
    before = rc.DB_KERNEL.launches
    got = rc.rasterize_records(setup, res, emit_db=True)
    ref = rc.rasterize_records_plain(rec, aabb, res, emit_db=True)
    plain = rc.rasterize_records(setup, res)
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
    if hot:  # whole tiles on uv = (0, 0): their hot texels collect an entry from each
        texel, _, counts = tb.grad_tile_entries(*args)
        assert int(torch.bincount(texel.long()).max()) >= 4
        assert int((counts == 0).sum()) < counts.numel()


@pytest.mark.parametrize("boundary_mode,filter_mode,D", [
    ("wrap", "linear-mipmap-linear", 1), ("zero", "linear", 2),
    ("clamp", "linear-mipmap-linear", 2)])
def test_texture_grad_entries_match_twin(dev, boundary_mode, filter_mode, D):
    """The kernels' per-tile entries, merged by (texel, tile), equal the
    plain twin's (float64 partials to rounding); a 512^2 frame that is
    mostly background gives the uv = (0, 0) texels more than 32 x 16
    entries each, the texels pass's whole-warp path."""
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as tb
    rng = np.random.default_rng(5)
    B, H, W = 2 if D > 1 else 1, 512, 512
    N = B * H * W
    tex = torch.from_numpy(rng.random((D, 64, 64, 3), dtype=np.float32)).to(dev)
    levels = [tex] + tx.build_mip_stack(tex)
    meta, n_tex = tx._static_meta(levels)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    disk = np.tile((xx ** 2 + yy ** 2 < 0.2).reshape(-1), B)
    u = np.where(disk, np.tile(xx.reshape(-1), B) * 0.6 + 0.5, 0.0).astype(np.float32)
    v = np.where(disk, np.tile(yy.reshape(-1), B) * 0.6 + 0.5, 0.0).astype(np.float32)
    fl = np.where(disk, rng.uniform(0, 2.5, N), 0.0).astype(np.float32)
    gc = rng.standard_normal((3, N)).astype(np.float32)
    u, v, fl, gc = inputs_from_numpy(u, v, fl, gc, device=dev)
    args = (u, v, fl, gc, meta, n_tex, (B, H, W), D > 1, boundary_mode, filter_mode)
    got = tb.texture_grad(*args)
    ref = tb.texture_grad_plain(*args)
    assert torch.equal(got, tb.texture_grad(*args))
    ulp = torch.from_numpy(np.spacing(np.abs(ref.cpu().numpy()))).to(dev)
    assert bool(((got - ref).abs() <= ulp).all())
    texel, part, counts = tb.grad_tile_entries(*args)
    tt, tl, tp, _ = tb.tile_entries_plain(*args)
    n_tiles = counts.numel()
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts.long())
    uk, inv = torch.unique(texel.long() * n_tiles + tile, return_inverse=True)
    merged = torch.zeros((uk.numel(), 3), dtype=torch.float64, device=dev).index_add_(0, inv, part)
    assert torch.equal(uk, tt * n_tiles + tl)
    assert bool(((merged - tp).abs() <= 1e-10 * tp.abs() + 1e-300).all())
    assert int(torch.bincount(texel.long()).max()) > 32 * 16


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


def _chunk_case(kind, seed=11):
    """B10 inputs: coherent ids in runs along the columns (pixel order),
    random ids (nothing to reduce in a chunk), a hot row, or short runs
    (1 to 8 columns, the one-thread sums) with signed zeros among the
    values."""
    rng = np.random.RandomState(seed)
    K, R, N = 9, 3000, 300000
    if kind in ("coherent", "short"):
        ids = np.repeat(np.where(rng.rand(N) < 0.3, -1, rng.randint(0, R, N)),
                        rng.randint(1, 41 if kind == "coherent" else 9, N))[:N]
    else:
        ids = rng.randint(-3, R + 3, N)
        if kind == "hot":
            ids[rng.rand(N) < 0.7] = 1
    vals = rng.randn(K, N).astype(np.float32)
    vals[:, rng.rand(N) < 0.1] = 0.0
    if kind == "short":
        vals[rng.rand(K, N) < 0.2] = -0.0
    return ids.astype(np.int32), vals, R


@pytest.mark.parametrize("kind", ["coherent", "random", "hot", "short"])
def test_scatter_rows_partials_match_twin(dev, kind):
    """B10's per-chunk partials equal chunk_partials_plain bit for bit;
    the sums are repeatable and within 1 ulp of float64."""
    from nvdiffrast_tpu_torch.ops import scatter as ts
    ids, vals, R = _chunk_case(kind)
    ti, tv = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    part = ts.chunk_partials(ti, tv, R)
    assert _partials_equal(part, ts.chunk_partials_plain(ti, tv, R))
    if kind == "random":
        assert int((part[2] > ts.CAP).sum()) > 100  # the second pass
    got = ts.scatter_add_by_id(ti, tv, R)
    assert torch.equal(got, ts.scatter_add_by_id(ti, tv, R))
    ok = (ids >= 0) & (ids < R)
    acc = np.zeros((R, vals.shape[0]), np.float64)
    np.add.at(acc, ids[ok], vals[:, ok].T.astype(np.float64))
    assert _ulp_close(got, torch.from_numpy(acc).to(dev))


def test_gradient_reductions_sync_at_most_once(dev):
    """grad_scatter (plain and da4) and scatter_add_by_id each read one
    number back to the host (the partials' count), no more."""
    import warnings
    from nvdiffrast_tpu_torch.ops import scatter as ts
    sargs = _bwd_scatter_args(dev, *sphere_scene(B=1, seed=1), (48, 64))
    N = sargs[0].shape[0]
    gs2 = torch.cat([sargs[1][:2], sargs[1][3:]])
    da4 = torch.ones((4, N), device=dev) * (sargs[1][0] != 0)
    ids, vals, R = _chunk_case("coherent")
    ti, tv = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    calls = [lambda: pb.grad_scatter(*sargs),
             lambda: pb.grad_scatter(sargs[0], gs2, *sargs[2:], da4=da4),
             lambda: ts.scatter_add_by_id(ti, tv, R)]
    for fn in calls:
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
        assert len(syncs) <= 1, syncs


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


# ---------------------------------------------------------------------------
# Cube maps (B12), the texture op, the repairs and the models on the ops.
# ---------------------------------------------------------------------------

def _cube_cols(dev, B=2, H=40, W=72, fw=16, D=2, seed=0):
    """(flat, meta, cols, n_texels) of a random cube pyramid and random
    directions with exact cube-corner and face-edge ones, on `dev`."""
    from nvdiffrast_tpu_torch.ops import texture_cube as tcg

    rng = np.random.RandomState(seed)
    tex = torch.from_numpy(rng.rand(D, 6, fw, fw, 3).astype(np.float32)).to(dev)
    levels = [tex] + tx.build_mip_stack(tex, -1, True)
    meta, n_tex = tx._static_meta(levels)
    N = B * H * W
    v = torch.from_numpy(rng.randn(N, 3).astype(np.float32)).to(dev)
    v[:6] = torch.tensor([[1, 1, 1], [1, 1, 0], [0, 0, 0], [-1, 1, -1], [0, 1, 1],
                          [1, 0, -1]], dtype=torch.float32)
    x, y, z = v.unbind(1)
    finfo = tcg.cube_faceid(x, y, z)
    s, t, fin = tcg.cube_project(finfo, x, y, z)
    fl = torch.from_numpy(rng.uniform(0, len(meta) - 1, N).astype(np.float32)).to(dev)
    fl[6:14] = torch.arange(8.0).clamp(max=len(meta) - 1)
    tz = torch.arange(N, device=dev) // (H * W) if D > 1 else torch.zeros(N, device=dev)
    cols = (s, t, fl) + tuple(a.to(torch.int32) for a in (fin, finfo[0], tz))
    return tx._pack_pyramid(levels), meta, cols, n_tex


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-nearest",
                                         "linear-mipmap-linear"])
def test_cube_kernels_match_twins(dev, filter_mode, D):
    from nvdiffrast_tpu_torch.ops import texture_cube_cuda as tcc

    flat, meta, cols, _ = _cube_cols(dev, D=D, seed=D)
    dy = torch.randn((3, cols[0].shape[0]), generator=torch.Generator().manual_seed(D)).to(dev)
    f0, b0 = tcc.FWD_KERNEL.launches, tcc.BWD_KERNEL.launches
    got = tcc.sample_cube(flat, cols, meta, filter_mode)
    gb = tcc.cube_bwd(flat, cols, dy, meta, filter_mode)
    ref = tcc.sample_cube_plain(flat, cols, meta, filter_mode)
    rb = tcc.cube_bwd_plain(flat, cols, dy, meta, filter_mode)
    torch.cuda.synchronize()
    assert (tcc.FWD_KERNEL.launches, tcc.BWD_KERNEL.launches) == (f0 + 1, b0 + 1)
    assert torch.equal(got, ref)
    for a, b in zip(gb, rb):
        assert torch.equal(a, b)
    # The card's glue + twin equals the CPU path.
    cpu = tcc.sample_cube(flat.cpu(), tuple(c.cpu() for c in cols), meta, filter_mode)
    assert torch.equal(got.cpu(), cpu)


def test_cube_texture_grad_within_one_ulp(dev):
    from nvdiffrast_tpu_torch.ops import texture_cube_cuda as tcc

    flat, meta, cols, n_tex = _cube_cols(dev, seed=3)
    dy = torch.randn((3, cols[0].shape[0]), generator=torch.Generator().manual_seed(3)).to(dev)
    got = tcc.cube_texture_grad(cols, dy, meta, n_tex, "linear-mipmap-linear")
    again = tcc.cube_texture_grad(cols, dy, meta, n_tex, "linear-mipmap-linear")
    ref = tcc.cube_texture_grad(tuple(c.cpu() for c in cols), dy.cpu(), meta, n_tex,
                                "linear-mipmap-linear")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ulp = torch.from_numpy(np.spacing(ref.abs().numpy()))
    assert bool(((got.cpu() - ref).abs() <= ulp).all())


@pytest.mark.parametrize("case", ["cube", "cube9", "2d_mip", "2d_bias", "2d_nearest"])
def test_texture_op_gpu_matches_cpu(dev, case):
    rng = np.random.RandomState(5)
    B, H, W = 2, 24, 40
    cube = case.startswith("cube")
    C = 9 if case == "cube9" else 3
    tex = rng.rand(1, 6, 16, 16, C) if cube else rng.rand(2, 32, 64, C)
    uv = rng.randn(B, H, W, 3) if cube else rng.uniform(-0.2, 1.2, (B, H, W, 2))
    uv_da = rng.randn(B, H, W, 6 if cube else 4) * 0.05
    bias = rng.uniform(-1, 5, (B, H, W))
    kw = dict(boundary_mode="cube" if cube else "clamp",
              filter_mode="nearest" if case == "2d_nearest" else "linear-mipmap-linear")

    def run(device):
        xs = [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=True)
              for a in (tex, uv, uv_da, bias)]
        img = dr.texture(xs[0], xs[1], xs[2], xs[3] if case == "2d_bias" else None, **kw)
        used = xs if case == "2d_bias" else xs[:3]
        return (img.detach(),) + torch.autograd.grad((img ** 2).sum(), used)

    gpu = run(dev)
    again = run(dev)
    cpu = run("cpu")
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        assert bool(torch.isfinite(g).all())
        assert float((g.cpu() - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1e-30)


def test_repairs_gpu_match_cpu(dev):
    """C > 8 antialias and render_pipeline, and the textured fallback (per-
    image uvs, cube) on the card against the CPU path."""
    pos, tri, attr, aidx = sphere_scene(B=2, seed=4, A=9)
    p, t, a, c = inputs_from_numpy(pos, tri, attr, aidx)
    rng = np.random.RandomState(2)
    uv2 = torch.from_numpy(rng.rand(2, attr.shape[1], 2).astype(np.float32))
    env = torch.from_numpy(rng.rand(1, 6, 8, 8, 3).astype(np.float32))
    dirs = torch.from_numpy(rng.randn(attr.shape[1], 3).astype(np.float32))
    tex = torch.from_numpy(rng.rand(1, 32, 64, 3).astype(np.float32))
    res = (48, 64)

    def grads(device):
        xs = [x.to(device).requires_grad_() for x in (p, a, uv2, dirs, tex, env)]
        td, cd = t.to(device), c.to(device)
        imgs = [dr.render_pipeline(xs[0], td, xs[1], res, attr_idx=cd),
                dr.render_pipeline_textured(xs[0], td, xs[2], xs[4], res, uv_tri=cd),
                dr.render_pipeline_textured(xs[0], td, xs[3], xs[5], res, uv_tri=cd,
                                            boundary_mode="cube")]
        loss = sum((i ** 2).mean() for i in imgs)
        return [i.detach() for i in imgs] + list(torch.autograd.grad(loss, xs))

    gpu = grads(dev)
    again = grads(dev)
    cpu = grads("cpu")
    for g, h, ref in zip(gpu, again, cpu):
        assert torch.equal(g, h)
        assert float((g.cpu() - ref).abs().max()) <= 5e-5 * max(float(ref.abs().max()), 1e-30)


def test_earth_and_envphong_fit_on_gpu(dev):
    from nvdiffrast_tpu_torch.models.fit_earth import EarthFitModel
    from nvdiffrast_tpu_torch.models.fit_envphong import EnvPhongFitModel

    m = EarthFitModel(res=32, ref_res=64, tex_res=(32, 64), max_mip_level=4, seed=0,
                      device=dev)
    for _ in range(50):
        m.step()
    assert m.texture_psnr() > 10.0
    e = EnvPhongFitModel(res=32, env_res=8, subdiv=1, seed=0, device=dev)
    for _ in range(150):
        e.step()
    assert e.metrics()[0] < 0.03


# ---------------------------------------------------------------------------
# The rest of the rasterizer: peel, range mode, viewport bands, binning.
# ---------------------------------------------------------------------------

def _modes_scene(dev):
    """B = 2 sphere views plus a random scene's triangles behind them, at
    67x130: (pos [2, V, 4], tri, res) on `dev`."""
    pos, tri, _, _ = sphere_scene(B=2, seed=4)
    rpos, rtri = random_scene(5, B=2, V=80, T=120)
    V = pos.shape[1]
    pos = np.concatenate([pos, rpos], axis=1)
    tri = np.concatenate([tri, rtri + V]).astype(np.int32)
    return (*inputs_from_numpy(pos, tri, device=dev), (67, 130))


@pytest.mark.parametrize("mode", ["peel", "range", "band", "binned", "binned_range",
                                  "binned_peel", "binned_band", "binned_ordered"])
def test_rasterize_mode_kernels_match_twin(dev, mode, monkeypatch):
    p, t, res = _modes_scene(dev)
    T = t.shape[0]
    kw, kernel = {}, {"peel": rc.PEEL_KERNEL, "range": rc.RANGE_KERNEL,
                      "band": rc.BAND_KERNEL, "binned_range": rc.RANGE_KERNEL,
                      "binned_peel": rc.PEEL_KERNEL,
                      "binned_band": rc.BAND_KERNEL}.get(mode, rc.BINNED_KERNEL)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 0 if mode.startswith("binned") else 1 << 62)
    pos = p
    if "range" in mode:
        pos = p[0]
        kw["ranges"] = torch.tensor([[0, T], [40, 90], [T - 130, 130]], dtype=torch.int32,
                                    device=dev)
    if "peel" in mode:
        kw["peel"] = rc.rasterize_fused(p, t, res, emit_zbuf=True)[4]
    if mode == "binned_ordered":  # the longest lists first
        monkeypatch.setattr(rc, "ORDER_MIN_ENTRIES", 0)
    viewport = (20, 97) if "band" in mode else None
    setup = rc.setup_records(pos, t, res, viewport)
    rec, aabb = setup[:2]
    before = kernel.launches
    got = rc.rasterize_records(setup, res, True, viewport=viewport, emit_zbuf=True, **kw)
    ref = rc.rasterize_records_plain(rec, aabb, res, True, viewport=viewport,
                                     emit_zbuf=True, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert len(got) == 9 and int((got[3] > 0).sum()) > 500
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["instance", "sphere", "range", "viewport"])
def test_setup_kernel_matches_build_records(dev, mode):
    """The record setup kernel against its plain twin bit for bit: the
    random scene's near-plane crossers and duplicate-vertex triangles in
    instance, range (2-D pos) and viewport mode, and a sphere; also the
    tile counts and chunk boxes."""
    if mode == "sphere":
        p, t = inputs_from_numpy(*sphere_scene(B=2, seed=4)[:2], device=dev)
        res = (130, 96)
    else:
        p, t, res = _modes_scene(dev)
    viewport = (20, 97) if mode == "viewport" else None
    pos = p[0] if mode == "range" else p
    before = rc.SETUP_KERNEL.launches
    rec, aabb, counts, boxes = rc.setup_records(pos, t, res, viewport)
    r2, a2 = rc.build_records(pos, t, res, viewport)
    torch.cuda.synchronize()
    assert rc.SETUP_KERNEL.launches == before + 1
    assert torch.equal(rec.view(torch.int32), r2.view(torch.int32))
    assert torch.equal(aabb.view(torch.int32), a2.view(torch.int32))
    assert torch.equal(counts, rc.tile_counts_plain(a2, res))
    assert torch.equal(boxes.view(torch.int32), rc.chunk_boxes_plain(a2).view(torch.int32))
    if mode != "sphere":  # the random scene holds culled triangles
        assert bool((r2[..., 15] >= 1e29).any())


@pytest.mark.parametrize("binned", [False, True])
def test_rasterize_forward_runs_setup_kernel_and_syncs_at_most_once(dev, binned,
                                                                     monkeypatch):
    """On the card the forward never runs build_records, launches the
    setup kernel once, and synchronizes with the host at most once
    (binned: the list total; unbinned: none once tri has been checked)."""
    import warnings
    p, t, res = _modes_scene(dev)
    monkeypatch.setattr(rc, "BIN_MIN_WORK", 0 if binned else 1 << 62)

    def no_twin(*a, **k):
        raise AssertionError("build_records ran on the CUDA path")

    monkeypatch.setattr(rc, "build_records", no_twin)
    rc.rasterize_fused(p, t, res)  # checks tri once
    torch.cuda.synchronize()
    before = rc.SETUP_KERNEL.launches
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc.rasterize_fused(p, t, res, emit_db=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert rc.SETUP_KERNEL.launches == before + 1
    assert len(syncs) == (1 if binned else 0), [str(w.message) for w in syncs]


def test_bin_kernels_match_twin(dev):
    p, t, res = _modes_scene(dev)
    rec, aabb, counts, _ = rc.setup_records(p, t, res)
    before = (rc.BIN_SEGMENT_KERNEL.launches, rc.BIN_EMIT_KERNEL.launches)
    got = rc.bin_records(aabb, res, counts)
    ref = rc.bin_records_plain(aabb, res)
    torch.cuda.synchronize()
    assert (rc.BIN_SEGMENT_KERNEL.launches, rc.BIN_EMIT_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert got[1].numel() > t.shape[0]


def test_bin_entry_limit_on_card(dev, monkeypatch):
    p, t, res = _modes_scene(dev)
    _, aabb, counts, _ = rc.setup_records(p, t, res)
    monkeypatch.setattr(rc, "MAX_BIN_ENTRIES", rc.bin_records(aabb, res, counts)[1].numel())
    with pytest.raises(ValueError, match="tile list entries"):
        rc.bin_records(aabb, res, counts)


def test_sweep_and_binning_need_the_setup_outputs(dev):
    """On the card nothing recomputes the setup kernel's outputs: the
    unbinned sweep without the chunk boxes and the binning without the
    tile counts raise ValueError."""
    p, t, res = _modes_scene(dev)
    rec, aabb, counts, boxes = rc.setup_records(p, t, res)
    with pytest.raises(ValueError, match="chunk boxes"):
        rc.launch_records(rec, aabb, res)
    with pytest.raises(ValueError, match="tile counts"):
        rc.bin_records(aabb, res, None)
    with pytest.raises(ValueError, match="tile counts"):
        rc.bin_records(aabb, res, counts[:-1])
    with pytest.raises(ValueError, match="chunk boxes"):
        rc.rasterize_records((rec, aabb, counts, None), res)


@pytest.mark.parametrize("mode", ["range", "band"])
def test_aa_mode_kernels_match_twins(dev, mode):
    p, t, res = _modes_scene(dev)
    T = t.shape[0]
    B, C = 2, 3
    ranged = mode == "range"
    viewport = (20, 97) if mode == "band" else None
    pos = p[0] if ranged else p
    kw = {"ranges": torch.tensor([[0, T], [40, 90]], dtype=torch.int32, device=dev)} \
        if ranged else {}
    _, _, zw, idf = (x.reshape(-1) for x in rc.rasterize_fused(pos, t, res, viewport=viewport,
                                                                **kw))
    N = idf.numel()
    rng = np.random.default_rng(7)
    ct = torch.from_numpy(rng.random((C, N), dtype=np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((C, N)).astype(np.float32)).to(dev)
    Hf = res[0] if viewport is None else viewport[1]
    ftable, vtbl, _, _ = _build_tables(pos, t, build_opposite_table(t), Hf, res[1])
    geo = ((B,) + res, T, ranged, viewport)
    got = ac.aa_cols(ct, idf, zw, ftable, *geo)
    ref = ac.aa_cols_plain(ct, idf, zw, ftable, *geo)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert int((got[4] != 0).sum()) > 10
    _, res4 = ac.aa_forward(ct, idf, zw, ftable, *geo)
    got = ac.aa_backward(dy, ct, idf, vtbl, res4, *geo)
    ref = ac.aa_backward_plain(dy, ct, idf, vtbl, res4, *geo)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_depth_peeler_and_range_mode_gpu_match_cpu(dev):
    p, t, res = _modes_scene("cpu")
    T = t.shape[0]
    ranges = torch.tensor([[0, T], [40, 90]], dtype=torch.int32)

    def run(device):
        pv = p.to(device).requires_grad_()
        tt = t.to(device)
        loss = 0.0
        with dr.DepthPeeler(dr.RasterizeCudaContext(), pv, tt, res) as peeler:
            for _ in range(3):
                rast, db = peeler.rasterize_next_layer()
                loss = loss + (rast[..., :2] ** 2).sum() + db.sum()
        p2 = pv[0]
        rast, _ = dr.rasterize(None, p2, tt, res, ranges=ranges.to(device))
        loss = loss + (rast[..., :2] ** 2).sum()
        return [x.cpu() for x in (rast, *torch.autograd.grad(loss, pv))]

    gpu, cpu = run(dev), run("cpu")
    assert torch.equal(gpu[0], cpu[0])
    scale = float(cpu[1].abs().max())
    assert scale > 0 and float((gpu[1] - cpu[1]).abs().max()) <= 1e-5 * scale
