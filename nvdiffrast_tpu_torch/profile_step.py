"""Where the time of one training step of render_pipeline goes, on a GPU.

    python -m nvdiffrast_tpu_torch.profile_step [--res 2048] [--steps 16]
        [--textured | --ops | --cube | --reductions]

The bench scene (uv-sphere 32x64, 3,968 triangles, vertex colours,
A = 3, B = 1, camera projection(x=0.4) @ translate(0, 0, -3.5)). One
step is render_pipeline's forward, mean(img**2) and the backward to pos
and the colours. With --textured a step is instead render_pipeline_textured
on bench.py's textured line (a 512x512x3 texture from rand seed 0,
spherical uvs, linear-mipmap-linear, wrap), forward, mean(img**2) and the
backward to pos, the uvs and the texture. With --ops it is the composed
standalone ops, rasterize -> interpolate -> antialias, on the bench scene,
forward, mean(img**2) and the backward to pos and the colours. With
--cube it is one EnvPhongFitModel-shaped step: rasterize and interpolate
the bench sphere's reflection vectors with their screen derivatives, a
seamless trilinear lookup in procedural_cubemap(512) (10 levels) plus a
Phong highlight, mean squared error against the reference map's image,
and the backward to the map and the Phong parameters.
With --reductions it times no step but the gradient reductions B4
(``grad_scatter``) and B10 (``scatter_add_by_id``) in all, glue included,
on calls no step above makes: B4 on the bench scene with seeded da4
columns (the textured chain's call, A = 2), on a quad of two triangles
filling the frame (each row fed by half the pixels), with and without
da4, and on uv_sphere(512, 1024) (1,046,528 triangles); B10 on the bench
scene's own-pixel rows with seeded K = 9 columns, on a hot row (every
other covered pixel on row 0), on random ids (nothing to reduce within a
chunk) and on the cube taps of --cube. Each case prints the median over
5 windows of the mean CUDA-event time of a call (a host sync inside a
call counts, as in a step), the device time and device ops of a call
(torch.profiler: the host's share around the sync left out) and the
host syncs of one call. That mode
calls only entry points that the package has had since commit 54206d4
(the reductions and what feeds them), so this file copied into an older
checkout's package times that checkout's reductions.
Prints:
  1. ms/step from a host-clock window (16 vs 48 steps, synchronised);
  2. each stage of the step run alone and synchronised, mean of 20;
  3. torch.profiler over --steps steps: device kernels and device time
     per step, the device's busy share of the profiled window, and the
     kernels with the most device time;
  4. peak device memory of one step.
Every line carries the card's nvidia-smi name and power limit.
"""

import argparse
import subprocess
import time

import numpy as np
import torch

from .models import primitives
from .ops import antialias as aa
from .ops import antialias_cuda as ac
from .ops import gather
from .ops import interpolate_cuda as ic
from .ops import pipeline as pl
from .ops import pipeline_bwd_cuda as pb
from .ops import pipeline_cuda as pc
from .ops import pipeline_tex as ptx
from .ops import pipeline_tex_bwd_cuda as ptb
from .ops import rasterize as ra
from .ops import rasterize_cuda as rc
from .ops import scatter
from .ops import texture as tx
from .ops import texture_bwd_cuda as tb
from .ops import texture_cuda as tc
from .ops.antialias import _build_tables
from .ops.interpolate import interpolate
from .ops.topology import build_opposite_table
from .utils import camera


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _timed(fn, iters):
    """Mean synchronised host-clock ms of fn() over `iters` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _event_ms(fn, iters):
    """Median over 5 windows of the mean CUDA-event ms of `iters` calls."""
    fn()
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return sorted(times)[2]


def _device_ms(fn, iters):
    """(device ms, device ops) of one fn(): torch.profiler's device
    events over `iters` calls, so host time around a sync is left out."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters,
            len(kernels) / iters)


def host_syncs(fn):
    """Host synchronisations during one fn() after a warm one (torch's
    sync debug mode)."""
    import warnings

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def quad_scene():
    """(pos [1, 4, 4], tri [2, 3], col [1, 4, 3]) numpy: two triangles past
    the frame (colours from seed 1), so each triangle's row takes an entry
    from every pixel of its half."""
    pos = np.array([[[-1.2, -1.2, 0.0, 1.0], [1.2, -1.2, 0.0, 1.0], [-1.2, 1.2, 0.0, 1.0],
                     [1.2, 1.2, 0.0, 1.0]]], np.float32)
    tri = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    col = np.random.default_rng(1).random((1, 4, 3)).astype(np.float32)
    return pos, tri, col


def scatter_args(pos, tri, attr, attr_idx, res):
    """grad_scatter's arguments from render_pipeline's saved forward state
    on (pos, tri, attr, attr_idx) at res, with dy the gradient of
    mean(img**2)."""
    T, A = tri.shape[0], attr.shape[-1]
    color, saved = pl._pipeline_fwd_core(pos, attr, tri, attr_idx, build_opposite_table(tri),
                                         res)
    b0, b1, idf, c0, al0, ax0, al1, ax1, atbl, vtbl = saved
    color = color.requires_grad_()
    dy = torch.autograd.grad((color ** 2).mean(), color)[0].reshape(-1, A).T.contiguous()
    gs, dd2, rid2 = pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, (al0, ax0, al1, ax1), res, T)
    return (pl.own_rows(idf, T, res), gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, res)


def with_da4(sargs, seed):
    """scatter_args as the textured chain makes the call (A = 2, da4
    [4, N]): seeded gs and da4 columns on the pixels whose colour row is
    live. Returns (sargs, da4)."""
    N = sargs[0].shape[0]
    rng = np.random.default_rng(seed)
    live = (sargs[1][0] != 0).float()
    gs = torch.from_numpy(rng.standard_normal((11, N)).astype(np.float32)).to(live.device)
    da4 = torch.from_numpy(rng.standard_normal((4, N)).astype(np.float32)).to(live.device)
    return (sargs[0], gs * live) + sargs[2:], da4 * live


def _window_ms(step):
    """chip_smoke.window_ms: (48 - 16 steps) window difference, per step."""
    for _ in range(4):
        step()
    torch.cuda.synchronize()

    def window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t1 = window(16)
    return (window(48) - t1) / 32 * 1e3


def _training(pos, tri, cidx, col, res):
    """(step, stages) of a render_pipeline training step."""
    from .ops import segments

    dev = pos.device

    def step():
        p = pos.detach().requires_grad_()
        c = col.detach().requires_grad_()
        img = pl.render_pipeline(p, tri, c, res, attr_idx=cidx)
        return torch.autograd.grad((img ** 2).mean(), (p, c))

    H, W = res
    T = tri.shape[0]
    N = H * W
    op = build_opposite_table(tri)
    setup = rc.setup_records(pos, tri, res)
    u, v, zw, idf = (x.reshape(N) for x in rc.rasterize_records(setup, res))
    atbl = pl._attr_table(col, cidx, 1, T)
    ftable, vtbl, _, _ = _build_tables(pos, tri, op, H, W)
    cols = pc.shade_cols(atbl, ftable, u, v, zw, idf, res, T)
    _, c0, resid = pc.finish_shade(cols, W)
    dy = torch.full((3, N), 1e-7, device=dev)
    gs, dd2, rid2 = pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, resid, res, T)
    rid0 = pl.own_rows(idf, T, res)
    sargs = (rid0, gs, dd2, rid2, u, v, resid[1], resid[3], vtbl, res)
    srow, spart, _ = pb.scatter_partials(*sargs)
    gt, gaa = pb.grad_scatter(*sargs)
    rows = torch.cat([gt[:, 9:].reshape(1, 3 * T, 3), gaa.reshape(1, 3 * T, 3)], 2)
    return step, [
        ("fwd: topology table", lambda: build_opposite_table(tri)),
        ("fwd: raster setup kernel", lambda: rc.setup_records(pos, tri, res)),
        ("fwd: rasterize kernel", lambda: rc.rasterize_records(setup, res)),
        ("fwd: attr + AA tables", lambda: (pl._attr_table(col, cidx, 1, T),
                                           _build_tables(pos, tri, op, H, W))),
        ("fwd: shade_fwd kernel", lambda: pc.shade_cols(atbl, ftable, u, v, zw, idf, res, T)),
        ("fwd: neighbour adds", lambda: pc.finish_shade(cols, W)),
        ("bwd: pipeline_bwd kernel",
         lambda: pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, resid, res, T)),
        ("bwd: own rows", lambda: pl.own_rows(idf, T, res)),
        ("bwd: grad_scatter per-tile partials (2 passes, 1 sync)",
         lambda: pb.scatter_partials(*sargs)),
        ("bwd: grad_scatter row sums (sort, segments, sums)",
         lambda: segments.row_sums(srow, spart, T, pb.SCATTER_SEGMENT_KERNEL,
                                   pb.SCATTER_SUM_KERNEL)),
        ("bwd: grad_scatter in all", lambda: pb.grad_scatter(*sargs)),
        ("bwd: vertex sums", lambda: pl._vertex_sum(rows, pl._corner_table(tri, pos.shape[1]))),
    ]


def _ops(pos, tri, cidx, col, res):
    """(step, stages) of a training step of the composed standalone ops."""
    dev = pos.device

    def step():
        p = pos.detach().requires_grad_()
        c = col.detach().requires_grad_()
        rast, _ = ra.rasterize(None, p, tri, res, grad_db=False)
        color, _ = interpolate(c, rast, cidx)
        img = aa.antialias(color, rast, p, tri)
        return torch.autograd.grad((img ** 2).mean(), (p, c))

    H, W = res
    T = tri.shape[0]
    N = H * W
    op = build_opposite_table(tri)
    setup = rc.setup_records(pos, tri, res)
    outs = rc.rasterize_records(setup, res, emit_db=True)
    u, v, zw, idf = (x.reshape(N) for x in outs[:4])
    atbl = pl._attr_table(col, cidx, 1, T)
    ct, _ = ic.interp_forward(atbl, u, v, idf, None, ())
    ftable, vtbl, _, _ = _build_tables(pos, tri, op, H, W)
    cols = ac.aa_cols(ct, idf, zw, ftable, (1, H, W), T)
    _, _, res4 = pc.finish_shade(cols, W)
    dy = torch.full((3, N), 1e-7, device=dev)
    gcol, rid2, gval2 = ac.aa_backward(dy, ct, idf, vtbl, res4, (1, H, W), T)
    rid2 = rid2.reshape(-1)
    grast, gval, _ = ic.interp_backward(atbl, u, v, idf, None, gcol, None, (), T, 0)
    rid_a = ra.pixel_rows(idf, T, 0, T)
    g9, rid9 = ra.raster_grad_rows(vtbl, idf, grast[0], grast[1], None, res, T)
    gt9 = scatter.scatter_add_by_id(rid9, g9, T)
    gt_aa = scatter.scatter_add_by_id(rid2, gval2, T)
    gt_a = scatter.scatter_add_by_id(rid_a, gval, T)

    return step, [
        ("fwd: topology table", lambda: build_opposite_table(tri)),
        ("fwd: raster setup kernel", lambda: rc.setup_records(pos, tri, res)),
        ("fwd: rasterize kernel (db)", lambda: rc.rasterize_records(setup, res, emit_db=True)),
        ("fwd: rast, rast_db images", lambda: (torch.stack(outs[:4], -1),
                                               torch.stack(outs[4:], -1))),
        ("fwd: attr table", lambda: pl._attr_table(col, cidx, 1, T)),
        ("fwd: interp_fwd kernel", lambda: ic.interp_forward(atbl, u, v, idf, None, ())),
        ("fwd: AA table", lambda: _build_tables(pos, tri, op, H, W)),
        ("fwd: aa_fwd kernel", lambda: ac.aa_cols(ct, idf, zw, ftable, (1, H, W), T)),
        ("fwd: neighbour adds", lambda: pc.finish_shade(cols, W)),
        ("bwd: aa_bwd kernel", lambda: ac.aa_backward(dy, ct, idf, vtbl, res4, (1, H, W), T)),
        ("bwd: AA pairs' scatter_rows (2 chunk passes, 1 sync, row sums)",
         lambda: scatter.scatter_add_by_id(rid2, gval2, T)),
        ("bwd: interp_bwd kernel",
         lambda: ic.interp_backward(atbl, u, v, idf, None, gcol, None, (), T, 0)),
        ("bwd: attribute scatter_rows", lambda: scatter.scatter_add_by_id(rid_a, gval, T)),
        ("bwd: table_take kernel", lambda: gather.table_take(vtbl, rid9)),
        ("bwd: raster rows (glue, table_take included)",
         lambda: ra.raster_grad_rows(vtbl, idf, grast[0], grast[1], None, res, T)),
        ("bwd: raster scatter_rows per-chunk partials (2 passes, 1 sync)",
         lambda: scatter.chunk_partials(rid9, g9, T)),
        ("bwd: raster scatter_rows in all", lambda: scatter.scatter_add_by_id(rid9, g9, T)),
        ("bwd: vertex sums", lambda: (ra.xyw_rows_to_vertices(gt9, tri, tuple(pos.shape)),
                                      ra.xyw_rows_to_vertices(gt_aa, tri, tuple(pos.shape)),
                                      pl.vertex_attr_grad(gt_a, cidx, tuple(col.shape), 1))),
    ]


def _textured(pos, tri, cidx, vtxp, res):
    """(step, stages) of a render_pipeline_textured training step."""
    dev = pos.device
    uv = torch.as_tensor(np.stack(
        [np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
         np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi], axis=1),
        dtype=torch.float32, device=dev)
    tex = torch.as_tensor(np.random.RandomState(0).rand(1, 512, 512, 3),
                          dtype=torch.float32, device=dev)
    mode = ("linear-mipmap-linear", "wrap")

    def step():
        xs = [x.detach().requires_grad_() for x in (pos, uv, tex)]
        img = ptx.render_pipeline_textured(xs[0], tri, xs[1], xs[2], res, uv_tri=cidx,
                                           filter_mode=mode[0], boundary_mode=mode[1])
        return torch.autograd.grad((img ** 2).mean(), xs)

    H, W = res
    T = tri.shape[0]
    N = H * W
    op = build_opposite_table(tri)
    setup = rc.setup_records(pos, tri, res)
    u, v, zw, idf, *db = (x.reshape(N) for x in
                          rc.rasterize_records(setup, res, emit_db=True))
    levels = [tex] + tx.build_mip_stack(tex)
    meta, _ = tx._static_meta(levels)
    flat = tx._pack_pyramid(levels)
    utbl = pl._attr_table(uv, cidx, 1, T)
    uvc, da = ic.interp_forward(utbl, u, v, idf, tuple(db), (0, 1))
    fl = tx.mip_level(da, 512, 512, len(levels))
    color = tc.sample(flat, uvc[0], uvc[1], fl, meta, (1, H, W), False, *mode[::-1])
    ftable, _, _, _ = _build_tables(pos, tri, op, H, W)
    cols = ac.aa_cols(color, idf, zw, ftable, (1, H, W), T)

    def pyramid():
        lv = [tex] + tx.build_mip_stack(tex)
        return tx._static_meta(lv), tx._pack_pyramid(lv)

    # The backward's inputs, from the saved forward state.
    _, saved, _ = ptx._ptex_fwd_core(pos, uv, tex, tri, cidx, op, res, *mode, -1)
    res4, vtbl = saved[12:16], saved[16]
    shape = (1, H, W)
    dy = torch.full((3, N), 1e-7, device=dev)
    gc, dd2, rid2 = ptb.aa_bwd_slim(dy, color, idf, res4, shape, T)
    bwd_args = (flat, uvc[0], uvc[1], fl, gc, meta, shape, False, *mode[::-1])
    gu, gv, gfl = tb.texture_bwd(*bwd_args)
    grad_args = (uvc[0], uvc[1], fl, gc, meta, flat.shape[0], shape, False, *mode[::-1])
    g_flat = tb.texture_grad(*grad_args)
    gda4 = tx.level_vjp(da, gfl, 512, 512, len(levels))[0]
    atbl = pl._attr_table(uv, cidx, 1, T)
    db4 = torch.stack(db)
    out15 = ptb.interp_raster_bwd_tex(atbl, vtbl, idf, gu, gv, gda4, db4, res, T)
    rid0 = pl.own_rows(idf, T, res)
    sargs = (rid0, out15[:11], dd2, rid2, u, v, res4[1], res4[3], vtbl, res)
    gt, gaa = pb.grad_scatter(*sargs, da4=out15[11:])

    return step, [
        ("topology table", lambda: build_opposite_table(tri)),
        ("raster setup kernel", lambda: rc.setup_records(pos, tri, res)),
        ("rasterize kernel (db)", lambda: rc.rasterize_records(setup, res, emit_db=True)),
        ("mip pyramid + packing", pyramid),
        ("uv table", lambda: pl._attr_table(uv, cidx, 1, T)),
        ("interp_fwd kernel", lambda: ic.interp_forward(utbl, u, v, idf, tuple(db), (0, 1))),
        ("mip level", lambda: tx.mip_level(da, 512, 512, len(levels))),
        ("texture_fwd kernel",
         lambda: tc.sample(flat, uvc[0], uvc[1], fl, meta, (1, H, W), False, *mode[::-1])),
        ("AA table", lambda: _build_tables(pos, tri, op, H, W)),
        ("aa_fwd kernel", lambda: ac.aa_cols(color, idf, zw, ftable, (1, H, W), T)),
        ("neighbour adds + NHWC", lambda: pc.finish_shade(cols, W)[0].T.reshape(1, H, W, 3)),
        ("bwd: slim AA (glue)", lambda: ptb.aa_bwd_slim(dy, color, idf, res4, shape, T)),
        ("bwd: texture_bwd kernel", lambda: tb.texture_bwd(*bwd_args)),
        ("bwd: texture_grad per-tile entries (2 passes, 1 sync)",
         lambda: tb.grad_tile_entries(*grad_args)),
        ("bwd: texture_grad in all", lambda: tb.texture_grad(*grad_args)),
        ("bwd: pyramid vjp", lambda: tx.pyramid_vjp(g_flat, meta, 1, 3)),
        ("bwd: mip-level vjp", lambda: tx.level_vjp(da, gfl, 512, 512, len(levels))[0]),
        ("bwd: interp_raster_bwd_tex kernel",
         lambda: ptb.interp_raster_bwd_tex(atbl, vtbl, idf, gu, gv, gda4, db4, res, T)),
        ("bwd: grad_scatter per-tile partials (da4; 2 passes, 1 sync)",
         lambda: pb.scatter_partials(*sargs, da4=out15[11:])),
        ("bwd: grad_scatter in all (da4)", lambda: pb.grad_scatter(*sargs, da4=out15[11:])),
        ("bwd: vertex sums", lambda: (
            pl.vertex_pos_grad(gt[:, 6:], gaa, tri, tuple(pos.shape), 1.0),
            pl.vertex_attr_grad(gt[:, :6], cidx, tuple(uv.shape), 1))),
    ]


def _reflections(pos, tri, vtxp, res):
    """directions() -> (d, dd, mask): the bench sphere's reflection
    vectors at each pixel, their screen derivatives and the empty pixels."""
    normals = vtxp / np.linalg.norm(vtxp, axis=1, keepdims=True)
    view = vtxp - np.array([0.0, 0.0, 3.5], np.float32)
    refl = view - 2.0 * normals * (normals * view).sum(1, keepdims=True)
    refl = torch.as_tensor(refl / np.linalg.norm(refl, axis=1, keepdims=True),
                           dtype=torch.float32, device=pos.device)

    def directions():
        with torch.no_grad():
            rast, rast_db = ra.rasterize(None, pos, tri, res, grad_db=True)
            d, dd = interpolate(refl, rast, tri, rast_db, diff_attrs="all")
            d = d / (torch.sum(d ** 2, -1, keepdim=True) + 1e-8) ** 0.5
            return d, dd, rast[..., -1:] == 0

    return directions


def _cube_taps(env, d, dd):
    """(ids, vals, flat, cols, meta): B10's input in the backward of a
    seamless trilinear lookup of map env at directions (d, dd), dy 1e-7:
    the texel taps of every pixel (``cube_grad_entries``)."""
    from .ops import texture_cube_cuda as tcc

    spec = ("linear-mipmap-linear", "cube", -1, True)
    N = d.shape[1] * d.shape[2]
    _, saved, meta = tx._texture_fwd(spec, env[None], d, dd, None, ())
    flat, cols = saved[0], tuple(saved[6:])
    dy = torch.full((3, N), 1e-7, device=d.device)
    ids, w = tcc.cube_grad_entries(cols, meta, "linear-mipmap-linear")
    vals = (dy.repeat(1, w.shape[0] // N) * w).contiguous()
    return ids, vals, flat, cols, meta


def _cube(pos, tri, vtxp, res):
    """(step, stages) of an envphong-shaped step with a 512^2 cube map."""
    from .models.fit_envphong import shade
    from .ops import texture_cube as tcg
    from .ops import texture_cube_cuda as tcc

    dev = pos.device
    env_ref = torch.as_tensor(primitives.procedural_cubemap(512), device=dev)
    env = torch.full_like(env_ref, 0.5)
    phong = torch.tensor([1.0, 1.0, 1.0, 10.0], device=dev)
    ldir = torch.tensor([0.3, -0.8, 0.52], device=dev)
    rgb_ref = torch.tensor([1.0, 0.8, 0.6], device=dev)
    directions = _reflections(pos, tri, vtxp, res)

    def step():
        d, dd, mask = directions()
        with torch.no_grad():
            ref = shade(env_ref, rgb_ref, 25.0, d, dd, ldir, mask)
        e = env.detach().requires_grad_()
        ph = phong.detach().requires_grad_()
        img = shade(e, ph[:3], ph[3], d, dd, ldir, mask)
        return torch.autograd.grad(((img - ref) ** 2).mean(), (e, ph))

    d, dd, _ = directions()
    N = d.shape[1] * d.shape[2]
    ids, vals, flat, cols, meta = _cube_taps(env, d, dd)
    g_flat = scatter.scatter_add_by_id(ids, vals, flat.shape[0])
    uvf = d.reshape(N, 3)
    return step, [
        ("fwd: rasterize + interpolate (directions)", directions),
        ("fwd: mip pyramid", lambda: tx.build_mip_stack(env[None], -1, True)),
        ("fwd: cube glue (face, s, t, footprint, level)",
         lambda: (tcg.cube_project(tcg.cube_faceid(*uvf.unbind(1)), *uvf.unbind(1)),
                  tcg.cube_st_da(*uvf.unbind(1), dd.reshape(N, 6).T))),
        ("fwd: cube_fwd kernel", lambda: tcc.sample_cube(flat, cols, meta,
                                                         "linear-mipmap-linear")),
        ("bwd: cube taps (glue)", lambda: tcc.cube_grad_entries(cols, meta,
                                                                "linear-mipmap-linear")),
        ("bwd: scatter_rows per-chunk partials (2 passes, 1 sync)",
         lambda: scatter.chunk_partials(ids, vals, flat.shape[0])),
        ("bwd: scatter_rows in all", lambda: scatter.scatter_add_by_id(ids, vals, flat.shape[0])),
        ("bwd: pyramid vjp", lambda: tx.pyramid_vjp(g_flat, meta, 6, 3)),
    ]


def _clip(vtxp, dev):
    """[1, V, 4] clip-space positions of the bench camera."""
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    return torch.as_tensor((posw @ mvp.T)[None], dtype=torch.float32, device=dev)


def _reductions(pos, tri, cidx, col, vtxp, res):
    """[(case, fn, iters)]: the B4 and B10 calls of --reductions."""
    dev = pos.device
    T = tri.shape[0]
    N = res[0] * res[1]
    sargs = scatter_args(pos, tri, col, cidx, res)
    dargs, da4 = with_da4(sargs, 6)
    qp, qt, qa = (torch.as_tensor(x, device=dev) for x in quad_scene())
    qargs = scatter_args(qp, qt, qa, qt, res)
    qdargs, qda4 = with_da4(qargs, 6)
    big_idx, big_vtx, _, _ = primitives.uv_sphere(512, 1024)
    btri = torch.as_tensor(big_idx, dtype=torch.int32, device=dev)
    bargs = scatter_args(_clip(big_vtx, dev), btri,
                         torch.as_tensor(big_vtx * 0.5 + 0.5, device=dev), btri, res)
    # B10 on the covered pixels' own rows; an empty pixel (own row 0, a
    # zero gs column) gets row T, which is dropped.
    live = (sargs[1] != 0).any(0)
    rows = torch.where(live, sargs[0], T)
    rng = np.random.default_rng(11)
    g9 = torch.from_numpy(rng.standard_normal((9, N)).astype(np.float32)).to(dev)
    g9 = g9 * live
    hot = torch.where(live & (torch.arange(N, device=dev) % 2 == 0), 0, rows)
    rnd = torch.from_numpy(rng.integers(0, T, N).astype(np.int32)).to(dev)
    d, dd, _ = _reflections(pos, tri, vtxp, res)()
    env = torch.full((6, 512, 512, 3), 0.5, device=dev)
    ids, vals, flat = _cube_taps(env, d, dd)[:3]
    return [
        ("B4 bench", lambda: pb.grad_scatter(*sargs), 20),
        ("B4 da4 bench (seeded columns)", lambda: pb.grad_scatter(*dargs, da4=da4), 20),
        ("B4 quad", lambda: pb.grad_scatter(*qargs), 20),
        ("B4 da4 quad", lambda: pb.grad_scatter(*qdargs, da4=qda4), 20),
        ("B4 1M triangles", lambda: pb.grad_scatter(*bargs), 10),
        ("B10 own-pixel rows (K = 9)", lambda: scatter.scatter_add_by_id(rows, g9, T), 20),
        ("B10 hot row", lambda: scatter.scatter_add_by_id(hot.to(torch.int32), g9, T), 20),
        ("B10 random ids", lambda: scatter.scatter_add_by_id(rnd, g9, T), 20),
        ("B10 cube taps", lambda: scatter.scatter_add_by_id(ids, vals, flat.shape[0]), 10),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--textured", action="store_true",
                    help="profile a render_pipeline_textured step instead")
    ap.add_argument("--ops", action="store_true",
                    help="profile a step of the composed rasterize, interpolate and "
                         "antialias ops instead")
    ap.add_argument("--cube", action="store_true",
                    help="profile an envphong-shaped cube-map step instead")
    ap.add_argument("--reductions", action="store_true",
                    help="time the gradient reductions B4 and B10 alone instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = _card()
    res = (args.res, args.res)

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(32, 64)
    pos = _clip(vtxp, dev)
    tri = torch.as_tensor(pos_idx, dtype=torch.int32, device=dev)
    cidx = torch.as_tensor(col_idx, dtype=torch.int32, device=dev)
    col = torch.as_tensor(vtxp * 0.5 + 0.5, dtype=torch.float32, device=dev)
    if args.reductions:
        for case, fn, iters in _reductions(pos, tri, cidx, col, vtxp, res):
            dev_ms, dev_ops = _device_ms(fn, iters)
            print(f"[r] {case} {args.res}^2: in all {_event_ms(fn, iters):.4f} ms, device "
                  f"time {dev_ms:.4f} ms in {dev_ops:.0f} device ops, {host_syncs(fn)} host "
                  f"sync(s) a call ({card})", flush=True)
        return
    if args.textured:
        what = "textured fwd+bwd"
        step, stages = _textured(pos, tri, cidx, vtxp, res)
    elif args.cube:
        what = "envphong-shaped cube-map fwd+bwd"
        step, stages = _cube(pos, tri, vtxp, res)
    elif args.ops:
        what = "composed ops fwd+bwd"
        step, stages = _ops(pos, tri, cidx, col, res)
    else:
        what = "fwd+bwd"
        step, stages = _training(pos, tri, cidx, col, res)

    step_ms = _window_ms(step)
    print(f"[1] {what} {args.res}^2: {step_ms:.3f} ms/step, "
          f"{args.res ** 2 / 1e3 / step_ms:.2f} Mpix/s ({card})", flush=True)

    # -- 2. stages, each alone and synchronised ------------------------------
    total = 0.0
    for name, fn in stages:
        ms = _timed(fn, 20)
        total += ms
        print(f"[2] {name}: {ms:.3f} ms", flush=True)
    print(f"[2] whole step: {_timed(step, 20):.3f} ms", flush=True)
    print(f"[2] sum of the stages: {total:.3f} ms ({card})", flush=True)

    # -- 3. torch.profiler ---------------------------------------------------
    from torch.profiler import DeviceType, ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"[3] profiled {args.steps} steps: {len(kernels) / args.steps:.1f} device "
          f"ops and {dev_us / 1e3 / args.steps:.3f} ms device time per step; window "
          f"{wall * 1e3 / args.steps:.3f} ms/step, busy "
          f"{dev_us / 1e6 / wall * 100:.1f} % ({card})", flush=True)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[3]   {t / 1e3 / args.steps:8.3f} ms/step  {n / args.steps:5.1f}x  {name[:90]}")

    # -- 4. peak memory ------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[4] peak device memory of one step above its inputs: {peak / 2 ** 20:.1f} MiB "
          f"({card})", flush=True)


if __name__ == "__main__":
    main()
