"""Port parity: the backward of render_pipeline (torch) vs the JAX package.

The same numpy inputs go to the JAX package (Pallas kernels in interpret
mode) and to the port. Bars, each with its reason:

* ``pair_pos_grad`` / ``decode_aux``: within 1 float32 ulp (both are the
  same elementwise f32 expressions; eager JAX fuses nothing).
* ``pipeline_bwd`` twin vs ``pipeline_pallas.pipeline_bwd``: gs and dd2
  within 1e-6 at a loss-gradient scale of dy (1e-3): XLA:CPU contracts
  some products into fma inside the interpret-mode kernel, the port
  never does, so a few ulps differ; rid2 equal where dd2 != 0.
* ``grad_scatter`` twin: within 1 float32 ulp of float64 ``np.add.at``
  sums of the same expanded rows (it sums in float64 and rounds once).
  The JAX kernel is held only to its bf16 hi/lo split, 2^-16 of the sum
  of the terms' magnitudes.
* The whole slice: ``torch.autograd.grad`` of mean(img**2) vs
  ``jax.grad`` at tests/test_pipeline.py's bar (atol 1e-5, rtol 1e-4),
  and per vertex row within 5e-4 of the row's largest entry: the JAX
  sums carry the 2^-16 hi/lo error per term, which cancellation inside
  one vertex's sum lifts to ~2e-4 of the row on these scenes.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import pipeline as jpl
from nvdiffrast_tpu.ops import pipeline_pallas as jpp
from nvdiffrast_tpu.ops import rasterize_pallas as jrp
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import antialias as taa
from nvdiffrast_tpu_torch.ops import pipeline as tpl
from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as tpb
from nvdiffrast_tpu_torch.ops import rasterize_cuda as trc
from nvdiffrast_tpu_torch.ops import topology as ttp
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import sphere_scene

RES = (48, 64)
IMPL = "pallas_interpret"
DY_SCALE = 1e-3  # |d mean(img**2) / d img| at this size is 1e-4 .. 1e-3
ROW_RTOL = 5e-4


def _ulps(a, b):
    """Distance in float32 ulps (same-sign values; zeros of either sign)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _jax_raster(pos, tri):
    B, T = pos.shape[0], tri.shape[0]
    ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
    outs = jrp.rasterize_fused(jnp.asarray(pos), jnp.asarray(tri), RES, ranges,
                               interpret=True, flat=True, emit_db=False)
    return [np.asarray(o) for o in outs[:4]]


@pytest.fixture(scope="module")
def bwd_case():
    """B=2 sphere: JAX raster buffers, tables, shade_fwd residuals, a
    seeded dy, and the JAX pipeline_bwd and pipeline_grad_scatter outputs."""
    pos, tri, attr, cidx = sphere_scene(B=2, seed=2)
    B, T, A = pos.shape[0], tri.shape[0], attr.shape[-1]
    H, W = RES
    N = B * H * W
    u, v, zw, idf = (x.reshape(N) for x in _jax_raster(pos, tri))
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    atbl, _ = jpl._attr_table(jnp.asarray(attr), jnp.asarray(cidx), True, B, T)
    ftable, vtbl, R, _ = jaa._build_tables(jpos, jtri, jbuild(jtri), True, H, W)
    fx, fy, rofs, bx, by = jaa._pixel_grid(B, H, W, T, True)
    flat = [jnp.asarray(x) for x in (u, v, zw, idf)]
    _, c0, res = jpp.shade_fwd(atbl, ftable, *flat, fx, fy, rofs, bx, by, A, T,
                               W, interpret=True)
    dy = (np.random.default_rng(0).standard_normal((A, N)) * DY_SCALE).astype(np.float32)
    gs, dd2, rid2 = jpp.pipeline_bwd(
        atbl, vtbl, flat[0], flat[1], flat[3], fx, fy, rofs, bx, by,
        list(jnp.asarray(dy)), list(c0), res, A, T, W, H, 2.0 / W, 2.0 / H,
        interpret=True)
    tid0 = idf.astype(np.int32) - 1
    valid = (tid0 >= 0) & (tid0 < T)
    rid0 = (np.where(valid, tid0, 0) + np.asarray(rofs)).astype(np.int32)
    gt, gaa = jpp.pipeline_grad_scatter(
        jnp.asarray(rid0), gs, dd2, rid2, flat[0], flat[1], res[1], res[3],
        vtbl[:, :R], A, R, W, H, interpret=True)
    return {"T": T, "R": R, "flat": (u, v, idf), "dy": dy, "rid0": rid0,
            "atbl": np.asarray(atbl), "vtbl": np.asarray(vtbl),
            "fx": np.asarray(fx), "fy": np.asarray(fy),
            "c0": np.asarray(c0), "res": [np.asarray(r) for r in res],
            "bwd": [np.asarray(x) for x in (gs, dd2, rid2)],
            "scatter": [np.asarray(gt), np.asarray(gaa)]}


def _bwd_args(case):
    idf = case["flat"][2]
    t = inputs_from_numpy(case["atbl"], case["vtbl"], idf, case["c0"],
                          case["dy"], *case["res"])
    return t[:5], tuple(t[5:])


def _scatter_args(case):
    u, v, _ = case["flat"]
    gs, dd2, rid2 = case["bwd"]
    res = case["res"]
    return inputs_from_numpy(case["rid0"], gs, dd2, rid2, u, v, res[1], res[3],
                             case["vtbl"])


def test_decode_aux_matches_jax(bwd_case):
    aux = np.concatenate([bwd_case["res"][1], bwd_case["res"][3],
                          np.array([0, 1, 2, 4, 5, 6], np.float32)])
    jdi, jt1 = jaa.decode_aux(jnp.asarray(aux))
    tdi, tt1 = taa.decode_aux(torch.from_numpy(aux))
    np.testing.assert_array_equal(tdi.numpy(), np.asarray(jdi))
    np.testing.assert_array_equal(tt1.numpy(), np.asarray(jt1))


@pytest.mark.parametrize("d", [0, 1])
def test_pair_pos_grad_matches_jax(bwd_case, d):
    """On the scene's live pairs and on random pairs (all edges, sides,
    masked-off entries and near-degenerate edges)."""
    _, dd2, rid2 = bwd_case["bwd"]
    act = dd2[d] != 0
    assert act.sum() > 20
    rng = np.random.default_rng(10 + d)
    n = 4096
    t9 = bwd_case["vtbl"][:, rid2[d][act]]
    rnd = rng.uniform(-1.5, 1.5, (9, n)).astype(np.float32)
    rnd[2::3] = rng.uniform(0.3, 2.0, (3, n))
    rnd[:, :64] = rnd[:, 64:128] + np.float32(1e-7)  # near-duplicate rows
    t9 = np.concatenate([t9, rnd], axis=1)
    aux = np.concatenate([bwd_case["res"][1 + 2 * d][act],
                          rng.integers(0, 3, n) + 4.0 * rng.integers(0, 2, n)])
    aux = aux.astype(np.float32)
    dd = np.concatenate([dd2[d][act], rng.standard_normal(n)]).astype(np.float32)
    ok = np.concatenate([np.ones(act.sum(), bool), rng.random(n) < 0.8])
    fx = np.concatenate([bwd_case["fx"][act], rng.uniform(-30, 30, n)]).astype(np.float32)
    fy = np.concatenate([bwd_case["fy"][act], rng.uniform(-20, 20, n)]).astype(np.float32)
    H, W = RES

    jdi, jt1 = jaa.decode_aux(jnp.asarray(aux))
    ref = jaa.pair_pos_grad(list(jnp.asarray(t9)), jnp.asarray(dd), jnp.asarray(ok),
                            jdi, jt1, jnp.asarray(fx), jnp.asarray(fy), d, W, H)
    tdi, tt1 = taa.decode_aux(torch.from_numpy(aux))
    got = taa.pair_pos_grad(list(torch.from_numpy(t9)), torch.from_numpy(dd),
                            torch.from_numpy(ok), tdi, tt1, torch.from_numpy(fx),
                            torch.from_numpy(fy), d, W, H)
    ref = np.stack([np.asarray(x) for x in ref])
    got = torch.stack(got).numpy()
    assert _ulps(got, ref).max() <= 1
    assert np.count_nonzero(ref) > 1000


def test_pipeline_bwd_twin_matches_jax(bwd_case):
    args, res = _bwd_args(bwd_case)
    T = bwd_case["T"]
    gs, dd2, rid2 = tpb.pipeline_bwd(*args, res, RES, T)
    r_gs, r_dd2, r_rid2 = bwd_case["bwd"]
    assert gs.shape == r_gs.shape and rid2.dtype == torch.int32
    np.testing.assert_allclose(gs.numpy(), r_gs, rtol=0, atol=1e-6)
    alpha = np.stack([res[0].numpy(), res[2].numpy()])
    live = alpha != 0
    np.testing.assert_allclose(dd2.numpy()[live], r_dd2[live], rtol=0, atol=1e-6)
    assert not dd2.numpy()[~live].any()
    np.testing.assert_array_equal(dd2.numpy() != 0, r_dd2 != 0)
    kept = r_dd2 != 0
    np.testing.assert_array_equal(rid2.numpy()[kept], r_rid2[kept])
    assert kept.sum() > 50 and np.abs(r_gs).max() > 0


def test_pipeline_bwd_device_dispatch(bwd_case):
    args, res = _bwd_args(bwd_case)
    T = bwd_case["T"]
    before = tpb.BWD_KERNEL.launches
    got = tpb.pipeline_bwd(*args, res, RES, T)
    ref = tpb.pipeline_bwd_plain(*args, res, RES, T)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert tpb.BWD_KERNEL.launches == before
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tpb.pipeline_bwd(*meta, tuple(x.to("meta") for x in res), RES, T)
    with pytest.raises(ValueError):
        tpb.pipeline_bwd(*args, res, (RES[0], RES[1] + 1), T)
    with pytest.raises(ValueError):
        tpb.pipeline_bwd(*args[:3], args[3][:2], args[4][:2], res, RES, T)


def _f64_sums(case):
    """float64 np.add.at of the expanded rows, the expansion done by
    numpy (bary outer product) and by the JAX package (pair_pos_grad).
    Returns ((gt, |gt| terms), (gaa, |gaa| terms))."""
    u, v, _ = case["flat"]
    gs, dd2, rid2 = case["bwd"]
    R, H, W = case["R"], *RES
    A = gs.shape[0] - 9
    live = (gs != 0).any(0)
    g = gs[:, live]
    bb = [u[live], v[live], np.float32(1.0) - u[live] - v[live]]
    own = np.concatenate([b * g[:A] for b in bb] + [g[A:]]).T.astype(np.float64)
    gt = np.zeros((R, 3 * A + 9))
    gt_abs = np.zeros_like(gt)
    np.add.at(gt, case["rid0"][live], own)
    np.add.at(gt_abs, case["rid0"][live], np.abs(own))
    gaa = np.zeros((R, 9))
    gaa_abs = np.zeros_like(gaa)
    for d in (0, 1):
        act = dd2[d] != 0
        rid = rid2[d][act]
        di, is_t1 = jaa.decode_aux(jnp.asarray(case["res"][1 + 2 * d][act]))
        cols = jaa.pair_pos_grad(list(jnp.asarray(case["vtbl"][:, rid])),
                                 jnp.asarray(dd2[d][act]), jnp.ones(rid.shape, bool),
                                 di, is_t1, jnp.asarray(case["fx"][act]),
                                 jnp.asarray(case["fy"][act]), d, W, H)
        vals = np.stack([np.asarray(c) for c in cols], 1).astype(np.float64)
        np.add.at(gaa, rid, vals)
        np.add.at(gaa_abs, rid, np.abs(vals))
    return (gt, gt_abs), (gaa, gaa_abs)


def test_grad_scatter_twin_matches_f64_and_jax(bwd_case):
    gt, gaa = tpb.grad_scatter(*_scatter_args(bwd_case), RES)
    refs = _f64_sums(bwd_case)
    for name, got, jax_out, (ref, ref_abs) in zip(
            ("gt", "gaa"), (gt, gaa), bwd_case["scatter"], refs):
        got = got.numpy()
        assert got.shape == ref.shape and np.abs(ref).max() > 0
        # The port: float64 sums rounded once, within 1 float32 ulp.
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(got - ref) <= ulp).all(), name
        # JAX: bf16 hi/lo terms, 2^-16 of the terms' magnitudes.
        assert (np.abs(jax_out - ref) <= 2.0 ** -16 * ref_abs + 1e-30).all(), name


def test_grad_scatter_device_dispatch(bwd_case):
    args = _scatter_args(bwd_case)
    before = tpb.SCATTER_KERNEL.launches
    got = tpb.grad_scatter(*args, RES)
    ref = tpb.grad_scatter_plain(*args, RES)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert tpb.SCATTER_KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tpb.grad_scatter(*(x.to("meta") for x in args), RES)
    with pytest.raises(ValueError):
        tpb.grad_scatter(args[0], args[1][:, :-1], *args[2:], RES)
    with pytest.raises(ValueError):
        tpb.grad_scatter(args[0].long(), *args[1:], RES)
    # da4 runs for uv attributes (A = 2): zero terms change no bit; with
    # A = 3 it raises.
    da4 = torch.zeros((4, args[0].shape[0]))
    gs2 = torch.cat([args[1][:2], args[1][3:]])
    args2 = (args[0], gs2, *args[2:])
    assert all(torch.equal(x, y) for x, y in zip(
        tpb.grad_scatter(*args2, RES, da4=da4), tpb.grad_scatter(*args2, RES)))
    assert tpb.SCATTER_KERNEL.launches == before
    with pytest.raises(ValueError, match="da4"):
        tpb.grad_scatter(*args, RES, da4=da4)


def _partial_rows(row, partial, R):
    """Each row's partials added in float64, rounded to float32 once."""
    return torch.zeros((R, partial.shape[1]), dtype=torch.float64).index_add_(
        0, row.long(), partial).float()


def test_tile_partials_twin_sums_to_rows_and_jax(bwd_case):
    """Kernel B4's per-tile structure (plain twin): every live entry in
    exactly one (row, 16x16 tile) partial, tiles ascending and rows
    ascending within a tile; the partials' row sums within 1 ulp of
    float64 np.add.at sums, and JAX's pipeline_grad_scatter within its
    2^-16 bar of them."""
    args = _scatter_args(bwd_case)
    rid0, gs, dd2, rid2 = args[:4]
    R = bwd_case["R"]
    A = gs.shape[0] - 9
    row, tile, part, n = tpb.tile_partials_plain(*args, RES)
    assert part.shape == (row.shape[0], 3 * A + 18) and part.dtype == torch.float64
    order = tile * R + row
    assert bool((order[1:] > order[:-1]).all())
    live = int((gs != 0).any(0).sum() + (dd2 != 0).sum())
    assert int(n.sum()) == live and int((n > 1).sum()) > 0
    assert row.shape[0] < live  # the tiles reduce
    got = _partial_rows(row, part, R)
    for name, g, jax_out, (ref, ref_abs) in zip(
            ("gt", "gaa"), (got[:, :3 * A + 9], got[:, 3 * A + 9:]), bwd_case["scatter"],
            _f64_sums(bwd_case)):
        g = g.numpy()
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(g - ref) <= ulp).all(), name
        assert (np.abs(jax_out - g) <= 2.0 ** -16 * ref_abs + ulp).all(), name


def _synthetic_scatter(seed, res, R, hot=False, da4=False):
    """grad_scatter inputs drawn from a seed: random rows per pixel (so a
    16x16 tile holds more rows than the kernel's scratch keeps), or one
    row for every pixel (hot); sparse AA pairs with valid aux codes."""
    rng = np.random.default_rng(seed)
    H, W = res
    N = 2 * H * W
    A = 2 if da4 else 3
    rid0 = np.zeros(N, np.int32) if hot else rng.integers(0, R, N).astype(np.int32)
    gs = rng.standard_normal((A + 9, N)).astype(np.float32)
    gs[:, rng.random(N) < 0.2] = 0.0
    dd2 = (rng.standard_normal((2, N)) * (rng.random((2, N)) < 0.1)).astype(np.float32)
    rid2 = (np.zeros((2, N)) if hot else rng.integers(0, R, (2, N))).astype(np.int32)
    b0, b1 = (rng.uniform(0, 0.5, N).astype(np.float32) for _ in range(2))
    ax0, ax1 = ((rng.integers(0, 3, N) + 4 * rng.integers(0, 2, N)).astype(np.float32)
                for _ in range(2))
    vtbl = rng.uniform(-1, 1, (9, R + 1)).astype(np.float32)
    vtbl[2::3] = rng.uniform(0.5, 2.0, (3, R + 1))
    extra = [rng.standard_normal((4, N)).astype(np.float32)] if da4 else []
    return inputs_from_numpy(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, *extra)


@pytest.mark.parametrize("hot,da4", [(False, False), (True, False), (False, True),
                                     (True, True)])
def test_tile_partials_twin_hot_row_and_crowded_tiles(hot, da4):
    """A row fed by every pixel (one partial a tile, split over tiles),
    and tiles of more rows than the scratch's SCATTER_CAP (the kernel's second
    pass): the partials' row sums within B4's bar (1e-6 of each row's
    largest value) of grad_scatter_plain."""
    res, R = (40, 36), 300
    *args, da = _synthetic_scatter(7 + hot + 2 * da4, res, R, hot, da4) + ((None,) * (1 - da4))
    row, tile, part, n = tpb.tile_partials_plain(*args, res, da4=da)
    K = 3 * (args[1].shape[0] - 9) + 9
    got = _partial_rows(row, part, R)
    gt, gaa = tpb.grad_scatter_plain(*args, res, da4=da)
    for g, ref in ((got[:, :K], gt), (got[:, K:], gaa)):
        scale = ref.abs().amax(1, keepdim=True)
        assert bool(((g - ref).abs() <= 1e-6 * scale).all())
    counts = torch.bincount(tile, minlength=int(tile.max()) + 1)
    if hot:
        assert set(row.tolist()) == {0} and int(n.max()) > 4 * 32  # lanes take turns
    else:
        assert int(counts.max()) > tpb.SCATTER_CAP


def test_vertex_sum_is_a_dense_fixed_order_sum():
    rng = np.random.default_rng(3)
    V, T, F = 40, 70, 5
    idx = torch.from_numpy(rng.integers(0, V - 3, (T, 3)).astype(np.int32))  # 3 unused
    rows = torch.from_numpy(rng.standard_normal((2, 3 * T, F)).astype(np.float32))
    corners = ttp._corner_table(idx, V)
    got = ttp._vertex_sum(rows, corners)
    ref = torch.zeros((2, V, F), dtype=torch.float64).index_add_(
        1, idx.reshape(-1).long(), rows.double())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert not got[:, V - 3:].any()
    assert torch.equal(ttp._vertex_sum(rows, ttp._corner_table(idx, V)), got)


def _grads(pos, tri, attr, cidx, boost):
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    p.requires_grad_()
    a.requires_grad_()
    img = dr.render_pipeline(p, t, a, RES, attr_idx=c, pos_gradient_boost=boost)
    return torch.autograd.grad((img ** 2).mean(), (p, a))


@functools.lru_cache(maxsize=None)
def _jax_grads(B, boost, broadcast):
    pos, tri, attr, cidx = sphere_scene(B=B, seed=7 + B + 10 * broadcast)
    if broadcast:
        attr = attr[0]

    def loss(p, a):
        img = jpl.render_pipeline(p, jnp.asarray(tri), a, RES,
                                  attr_idx=jnp.asarray(cidx), impl=IMPL,
                                  pos_gradient_boost=boost)
        return jnp.mean(img ** 2)

    # Jitted: the interpret-mode kernels then run compiled, ~2x faster.
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(pos), jnp.asarray(attr))
    return (pos, tri, attr, cidx), tuple(np.asarray(x) for x in g)


def _check_grads(got, ref, name):
    assert np.abs(ref).sum() > 0, name
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4, err_msg=name)
    got = got.reshape(-1, got.shape[-1])
    ref = ref.reshape(-1, ref.shape[-1])
    scale = np.abs(ref).max(1, keepdims=True)
    bad = np.abs(got - ref) > ROW_RTOL * scale
    assert not bad.any(), f"{name}: vertex rows {np.nonzero(bad.any(1))[0]}"


@pytest.mark.parametrize("B,boost,broadcast", [(1, 1.0, False), (2, 2.5, False),
                                               (2, 1.0, True)])
def test_render_pipeline_grads_match_jax(B, boost, broadcast):
    (pos, tri, attr, cidx), (r_pos, r_attr) = _jax_grads(B, boost, broadcast)
    # Same ids from both rasterizers, so both differentiate one image.
    p, t = inputs_from_numpy(pos, tri)
    ids = trc.rasterize_fused(p, t, RES)[3].numpy()
    np.testing.assert_array_equal(ids, _jax_raster(pos, tri)[3])
    g_pos, g_attr = _grads(pos, tri, attr, cidx, boost)
    assert g_pos.shape == pos.shape and g_attr.shape == attr.shape
    _check_grads(g_pos.numpy(), r_pos, "g_pos")
    _check_grads(g_attr.numpy(), r_attr, "g_attr")


def test_render_pipeline_grads_repeatable_and_selective():
    pos, tri, attr, cidx = sphere_scene(B=2, seed=5)
    first = _grads(pos, tri, attr, cidx, 1.5)
    again = _grads(pos, tri, attr, cidx, 1.5)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    # One input at a time; the other gets no gradient.
    p, t, a, c = inputs_from_numpy(pos, tri, attr, cidx)
    a.requires_grad_()
    dr.render_pipeline(p, t, a, RES, attr_idx=c,
                       pos_gradient_boost=1.5).square().mean().backward()
    assert p.grad is None and torch.equal(a.grad, first[1])
    p.requires_grad_()
    a = a.detach()
    dr.render_pipeline(p, t, a, RES, attr_idx=c,
                       pos_gradient_boost=1.5).square().mean().backward()
    assert torch.equal(p.grad, first[0])
    with torch.no_grad():
        out = dr.render_pipeline(p, t, a, RES, attr_idx=c)
    assert not out.requires_grad and torch.isfinite(out).all()


def test_render_pipeline_numpy_input_runs_on_the_card():
    """Non-tensor pos goes to the default CUDA device, never silently to
    the CPU; without a card it raises."""
    pos, tri, attr, cidx = sphere_scene(B=1, seed=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dr.render_pipeline(pos, tri, attr, RES, attr_idx=cidx)
        return
    out = dr.render_pipeline(pos, tri, attr, RES, attr_idx=cidx)
    assert out.device.type == "cuda"
