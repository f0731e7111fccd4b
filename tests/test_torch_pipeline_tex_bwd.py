"""Port parity: the backward of render_pipeline_textured (torch, plain
twins) vs the JAX package (pipeline_tex_pallas and pipeline_pallas in
interpret mode), on tests/test_pipeline_tex.py's scenes (B = 2, 48x64).

Bars, each with its reason:
* interp_raster_bwd_tex twin: JAX's own (tests/test_pipeline_tex.py:
  218-231): the masked (gu, gv) rows exact, the 9 position rows within
  2e-5 and the 4 da rows within 1e-6 of each row's scale (XLA:CPU
  contracts some of the interpret kernel's products into fma, amplified
  by the 1/(at + 1e-6) pole); zeros off the triangles.
* aa_bwd_slim vs aa_bwd_slim_cols: within 1e-6 at a cotangent scale of
  1e-3 (XLA may contract its products into fma); rid2 equal where dd2
  is not zero.
* grad_scatter with da4: within 1 float32 ulp of float64 np.add.at sums
  of the same expanded rows; JAX's bf16 hi/lo scatter within 2^-16 of
  the terms' magnitudes (ROADMAP C).
* The slice: torch.autograd.grad vs jax.grad of sum(o**2 + 0.1*o), each
  gradient within 5e-5 of its largest entry (tests/test_pipeline_tex.py:
  73) and each row within 5e-4 of the row's (_torch_parity).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nvdiffrast_tpu.ops import antialias as jaa
from nvdiffrast_tpu.ops import pipeline as jpl
from nvdiffrast_tpu.ops import pipeline_pallas as jpp
from nvdiffrast_tpu.ops import pipeline_tex_pallas as jptp
from nvdiffrast_tpu.ops import rasterize_pallas as jrp
from nvdiffrast_tpu.ops import texture_pallas as jtp
from nvdiffrast_tpu.ops.topology import build_opposite_table as jbuild
import nvdiffrast_tpu_torch as dr
from nvdiffrast_tpu_torch.ops import antialias_cuda as tac
from nvdiffrast_tpu_torch.ops import pipeline as tpl
from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as tpb
from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as tptb
from nvdiffrast_tpu_torch.ops.antialias import _build_tables
from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

from _torch_parity import (TEX_RES, check_textured_grads, textured_grads,
                           textured_grads_jax, textured_scene)

RES = TEX_RES
DY_SCALE = 1e-3


@pytest.fixture(scope="module")
def case():
    """Seed-7 scene: JAX raster buffers with db, seeded cotangents, the
    tables, the port's AA residuals of a random colour, and the JAX
    outputs of interp_raster_bwd_tex, aa_bwd_slim_cols and
    pipeline_grad_scatter(da4=...) on them (each JAX segment jitted: the
    interpret-mode kernels then run compiled)."""
    pos, tri, uv, _ = textured_scene(seed=7)
    B, T = pos.shape[0], tri.shape[0]
    H, W = RES
    N = B * H * W
    jpos, jtri = jnp.asarray(pos), jnp.asarray(tri)
    rng = np.random.RandomState(11)
    gu, gv = (rng.randn(N).astype(np.float32) for _ in range(2))
    gda4 = rng.randn(4, N).astype(np.float32)
    c0 = rng.rand(3, N).astype(np.float32)
    dy = (rng.randn(3, N) * DY_SCALE).astype(np.float32)
    atbl, _ = jpl._attr_table(jnp.asarray(uv), jtri, True, B, T)
    _, vtbl, R, _ = jaa._build_tables(jpos, jtri, jbuild(jtri), True, H, W)
    pix = jnp.arange(N, dtype=jnp.int32)
    rofs = (pix // (H * W)) * T
    fxc = (pix % W).astype(jnp.float32) * (2.0 / W) + (1.0 / W - 1.0)
    fyc = ((pix // W) % H).astype(jnp.float32) * (2.0 / H) + (1.0 / H - 1.0)

    @jax.jit
    def raster_and_b14(jpos, gu, gv, gda4):
        ranges = jnp.broadcast_to(jnp.array([[0, T]], jnp.int32), (B, 2))
        outs = [a.reshape(N) for a in jrp.rasterize_fused(
            jpos, jtri, RES, ranges, emit_db=True, flat=True, interpret=True)[:8]]
        out15 = jptp.interp_raster_bwd_tex(
            atbl, vtbl, outs[3], outs[0], outs[1], gu, gv, gda4, jnp.stack(outs[4:]),
            rofs, fxc, fyc, T, 2.0 / W, 2.0 / H, interpret=True)
        return outs, out15

    outs, out15 = raster_and_b14(jpos, *(jnp.asarray(x) for x in (gu, gv, gda4)))
    u, v, zw, idf, *db = (np.asarray(a) for a in outs)

    # AA residuals of the colour c0 (the port's forward; JAX takes them
    # tile-ordered).
    p, t, tc0, tidf, tzw = inputs_from_numpy(pos, tri, c0, idf, zw)
    ftable = _build_tables(p, t, build_opposite_table(t), H, W)[0]
    res = tac.aa_forward(tc0, tidf, tzw, ftable, (B, H, W), T)[1]
    res = [r.numpy() for r in res]
    tid0 = idf.astype(np.int32) - 1
    valid = (tid0 >= 0) & (tid0 < T)
    rid0 = (np.where(valid, tid0, 0) + np.asarray(rofs)).astype(np.int32)

    @jax.jit
    def slim_and_scatter(dy, c0, idf, res, rid0, out15, u, v):
        jres = tuple(jtp._tile_order(r, B, H, W, fill=0.0) for r in res)
        gc, dd2, rid2, ax2 = jptp.aa_bwd_slim_cols(dy, c0, idf, jres, T, B, H, W)
        gt, gaa = jpp.pipeline_grad_scatter(
            rid0, out15[:11], dd2, rid2, u, v, ax2[0], ax2[1], vtbl[:, :R], 2, R, W, H,
            da4=out15[11:15], interpret=True)
        return (gc, dd2, rid2, ax2), (gt, gaa)

    (gc, dd2, rid2, ax2), (gt, gaa) = slim_and_scatter(
        *(jnp.asarray(x) for x in (dy, c0, idf)), tuple(jnp.asarray(r) for r in res),
        jnp.asarray(rid0), out15, jnp.asarray(u), jnp.asarray(v))
    return {"scene": (pos, tri, uv), "T": T, "R": R, "valid": valid, "rid0": rid0,
            "flat": (u, v, idf), "db": np.stack(db), "g": (gu, gv, gda4),
            "c0": c0, "dy": dy, "res": res, "atbl": np.asarray(atbl),
            "vtbl": np.asarray(vtbl),
            "pixel": [np.asarray(x) for x in jaa._pixel_grid(B, H, W, T, True)[:2]],
            "out15": np.asarray(out15),
            "slim": [np.asarray(x) for x in (gc, dd2, rid2, ax2)],
            "scatter": [np.asarray(gt), np.asarray(gaa)]}


def _b14_args(case):
    pos, tri, uv = case["scene"]
    B, T = pos.shape[0], case["T"]
    p, t, a = inputs_from_numpy(pos, tri, uv)
    atbl = tpl._attr_table(a, t, B, T)
    vtbl = _build_tables(p, t, build_opposite_table(t), *RES)[1]
    _, _, idf = case["flat"]
    return (atbl, vtbl, *inputs_from_numpy(idf, *case["g"], case["db"]), RES, T)


def test_interp_raster_bwd_tex_twin_matches_jax(case):
    args = _b14_args(case)
    np.testing.assert_array_equal(args[0].numpy(), case["atbl"])
    np.testing.assert_array_equal(args[1].numpy(), case["vtbl"])
    got = tptb.interp_raster_bwd_tex(*args).numpy()
    ref = case["out15"]
    assert got.shape == ref.shape == (15, case["valid"].size)
    np.testing.assert_array_equal(got[:2], ref[:2])
    for k in range(2, 15):
        scale = max(np.abs(ref[k]).max(), 1e-6)
        bar = 2e-5 if k < 11 else 1e-6
        assert np.abs(got[k] - ref[k]).max() <= bar * scale, k
    assert not got[:, ~case["valid"]].any()
    assert case["valid"].mean() > 0.2 and np.abs(ref[2:11]).max() > 0


def test_interp_raster_bwd_tex_device_dispatch(case):
    args = _b14_args(case)
    before = tptb.KERNEL.launches
    got = tptb.interp_raster_bwd_tex(*args)
    assert torch.equal(got, tptb.interp_raster_bwd_tex_plain(*args))
    assert tptb.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tptb.interp_raster_bwd_tex(*(x.to("meta") for x in args[:7]), *args[7:])
    with pytest.raises(ValueError):
        tptb.interp_raster_bwd_tex(*args[:5], args[5][:2], *args[6:])
    with pytest.raises(ValueError):
        tptb.interp_raster_bwd_tex(*args[:7], (RES[0] + 1, RES[1]), args[8])


def test_aa_bwd_slim_matches_jax(case):
    B, H, W = 2, *RES
    _, _, idf = case["flat"]
    dy, c0, tidf, *res = inputs_from_numpy(case["dy"], case["c0"], idf, *case["res"])
    gc, dd2, rid2 = tptb.aa_bwd_slim(dy, c0, tidf, tuple(res), (B, H, W), case["T"])
    r_gc, r_dd2, r_rid2, r_ax2 = case["slim"]
    assert rid2.dtype == torch.int32
    np.testing.assert_allclose(gc.numpy(), r_gc, rtol=0, atol=1e-6 * DY_SCALE)
    np.testing.assert_allclose(dd2.numpy(), r_dd2, rtol=0, atol=1e-6 * DY_SCALE)
    kept = r_dd2 != 0
    np.testing.assert_array_equal(dd2.numpy() != 0, kept)
    np.testing.assert_array_equal(rid2.numpy()[kept], r_rid2[kept])
    np.testing.assert_array_equal(np.stack([case["res"][1], case["res"][3]])[kept],
                                  r_ax2[kept])
    assert kept.sum() > 20 and not np.array_equal(r_gc, case["dy"])


def _scatter_args(case):
    u, v, _ = case["flat"]
    r_gc, dd2, rid2, _ = case["slim"]
    res = case["res"]
    out15 = case["out15"]
    return inputs_from_numpy(case["rid0"], out15[:11], dd2, rid2, u, v, res[1], res[3],
                             case["vtbl"], out15[11:])


def _f64_sums(case):
    """float64 np.add.at of the expanded rows: the bary outer product with
    the da terms (numpy) and pair_pos_grad (the JAX package). Returns
    ((gt, |gt| terms), (gaa, |gaa| terms))."""
    rid0, gs, dd2, rid2, u, v, ax0, ax1, vtbl, da4 = (x.numpy() for x in _scatter_args(case))
    R, (H, W) = case["R"], RES
    live = (gs != 0).any(0) | (da4 != 0).any(0)
    g = gs[:, live]
    bb0, bb1 = u[live], v[live]
    bb2 = np.float32(1.0) - bb0 - bb1
    c0, c1 = da4[:2, live], da4[2:, live]
    own = np.concatenate([bb0 * g[:2] + c0, bb1 * g[:2] + c1, bb2 * g[:2] - c0 - c1,
                          g[2:]]).T.astype(np.float64)
    gt = np.zeros((R, 15))
    gt_abs = np.zeros_like(gt)
    np.add.at(gt, rid0[live], own)
    np.add.at(gt_abs, rid0[live], np.abs(own))
    gaa = np.zeros((R, 9))
    gaa_abs = np.zeros_like(gaa)
    for d, ax in enumerate((ax0, ax1)):
        act = dd2[d] != 0
        rid = rid2[d][act]
        di, is_t1 = jaa.decode_aux(jnp.asarray(ax[act]))
        cols = jaa.pair_pos_grad(list(jnp.asarray(vtbl[:, rid])), jnp.asarray(dd2[d][act]),
                                 jnp.ones(rid.shape, bool), di, is_t1,
                                 *(jnp.asarray(f[act]) for f in case["pixel"]), d, W, H)
        vals = np.stack([np.asarray(c) for c in cols], 1).astype(np.float64)
        np.add.at(gaa, rid, vals)
        np.add.at(gaa_abs, rid, np.abs(vals))
    return (gt, gt_abs), (gaa, gaa_abs)


def test_grad_scatter_da4_twin_matches_f64_and_jax(case):
    *args, vtbl, da4 = _scatter_args(case)
    gt, gaa = tpb.grad_scatter(*args, vtbl, RES, da4=da4)
    refs = _f64_sums(case)
    for name, got, jax_out, (ref, ref_abs) in zip(("gt", "gaa"), (gt, gaa),
                                                  case["scatter"], refs):
        got = got.numpy()
        assert got.shape == ref.shape and np.abs(ref).max() > 0, name
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(got - ref) <= ulp).all(), name
        assert (np.abs(jax_out - ref) <= 2.0 ** -16 * ref_abs + 1e-30).all(), name
    # The da terms move the uv rows: without them the sums differ.
    assert not torch.equal(tpb.grad_scatter(*args, vtbl, RES)[0][:, :6], gt[:, :6])


def test_tile_partials_da4_twin_sums_to_rows_and_jax(case):
    """Kernel B4's per-tile partials with the da4 terms (plain twin):
    every live entry (gs or da4 column non-zero, or a kept AA pair) in
    one (row, tile) partial; their row sums within 1 ulp of float64
    np.add.at sums and JAX's pipeline_grad_scatter(da4=...) within its
    2^-16 bar."""
    *args, vtbl, da4 = _scatter_args(case)
    R = case["R"]
    row, tile, part, n = tpb.tile_partials_plain(*args, vtbl, RES, da4=da4)
    gs, dd2 = args[1], args[2]
    live = int(((gs != 0).any(0) | (da4 != 0).any(0)).sum() + (dd2 != 0).sum())
    assert int(n.sum()) == live and row.shape[0] < live
    got = torch.zeros((R, 24), dtype=torch.float64).index_add_(0, row, part).float()
    for name, g, jax_out, (ref, ref_abs) in zip(("gt", "gaa"), (got[:, :15], got[:, 15:]),
                                                case["scatter"], _f64_sums(case)):
        g = g.numpy()
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(g - ref) <= ulp).all(), name
        assert (np.abs(jax_out - g) <= 2.0 ** -16 * ref_abs + ulp).all(), name


def test_render_pipeline_textured_grads_match_jax():
    """linear-mipmap-linear, wrap, one texture, no boost."""
    mode = ("linear-mipmap-linear", "wrap", 1, 1.0)
    check_textured_grads(textured_grads(*mode), textured_grads_jax(*mode))


def test_render_pipeline_textured_grads_repeatable_and_selective():
    pos, tri, uv, tex = textured_scene(seed=3, D=2)
    p, t, a, tx = inputs_from_numpy(pos, tri, uv, tex)

    def grads(*args):
        for x in args:
            x.requires_grad_()
        img = dr.render_pipeline_textured(p, t, a, tx, RES, boundary_mode="zero",
                                          pos_gradient_boost=1.5)
        out = torch.autograd.grad(img.square().mean(), args)
        for x in args:
            x.requires_grad_(False)
        return out

    first = grads(p, a, tx)
    again = grads(p, a, tx)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(bool(x.abs().max() > 0) for x in first)
    # One input at a time: each equals its part of the full run.
    for i, x in enumerate((p, a, tx)):
        (g,) = grads(x)
        assert torch.equal(g, first[i])
    with torch.no_grad():
        out = dr.render_pipeline_textured(p, t, a, tx, RES)
    assert not out.requires_grad
