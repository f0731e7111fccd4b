"""Where the time of one training step of render_pipeline goes, on a GPU.

    python -m nvdiffrast_tpu_torch.profile_step [--res 2048] [--steps 16] [--textured | --ops]

The bench scene (uv-sphere 32x64, 3,968 triangles, vertex colours,
A = 3, B = 1, camera projection(x=0.4) @ translate(0, 0, -3.5)). One
step is render_pipeline's forward, mean(img**2) and the backward to pos
and the colours. With --textured a step is instead render_pipeline_textured
on bench.py's textured line (a 512x512x3 texture from rand seed 0,
spherical uvs, linear-mipmap-linear, wrap), forward, mean(img**2) and the
backward to pos, the uvs and the texture. With --ops it is the composed
standalone ops, rasterize -> interpolate -> antialias, on the bench scene,
forward, mean(img**2) and the backward to pos and the colours.
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
    rec, aabb = rc.build_records(pos, tri, res)
    u, v, zw, idf = (x.reshape(N) for x in rc.rasterize_records(rec, aabb, res))
    atbl = pl._attr_table(col, cidx, 1, T)
    ftable, vtbl, _, _ = _build_tables(pos, tri, op, H, W)
    cols = pc.shade_cols(atbl, ftable, u, v, zw, idf, res, T)
    _, c0, resid = pc.finish_shade(cols, W)
    dy = torch.full((3, N), 1e-7, device=dev)
    gs, dd2, rid2 = pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, resid, res, T)
    rid0 = pl.own_rows(idf, T, res)
    codes, off = pb._entries(rid0, gs, dd2, rid2, T)
    flats = (u, v, resid[1], resid[3])
    gt, gaa = pb.scatter_entries(codes, off, gs, dd2, flats, vtbl, res)
    rows = torch.cat([gt[:, 9:].reshape(1, 3 * T, 3), gaa.reshape(1, 3 * T, 3)], 2)
    return step, [
        ("fwd: topology table", lambda: build_opposite_table(tri)),
        ("fwd: raster prepass", lambda: rc.build_records(pos, tri, res)),
        ("fwd: rasterize kernel", lambda: rc.rasterize_records(rec, aabb, res)),
        ("fwd: attr + AA tables", lambda: (pl._attr_table(col, cidx, 1, T),
                                           _build_tables(pos, tri, op, H, W))),
        ("fwd: shade_fwd kernel", lambda: pc.shade_cols(atbl, ftable, u, v, zw, idf, res, T)),
        ("fwd: neighbour adds", lambda: pc.finish_shade(cols, W)),
        ("bwd: pipeline_bwd kernel",
         lambda: pb.pipeline_bwd(atbl, vtbl, idf, c0, dy, resid, res, T)),
        ("bwd: own rows", lambda: pl.own_rows(idf, T, res)),
        ("bwd: entry sort (index glue)", lambda: pb._entries(rid0, gs, dd2, rid2, T)),
        ("bwd: grad_scatter kernel",
         lambda: pb.scatter_entries(codes, off, gs, dd2, flats, vtbl, res)),
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
    rec, aabb = rc.build_records(pos, tri, res)
    outs = rc.rasterize_records(rec, aabb, res, emit_db=True)
    u, v, zw, idf = (x.reshape(N) for x in outs[:4])
    atbl = pl._attr_table(col, cidx, 1, T)
    ct, _ = ic.interp_forward(atbl, u, v, idf, None, ())
    ftable, vtbl, _, _ = _build_tables(pos, tri, op, H, W)
    cols = ac.aa_cols(ct, idf, zw, ftable, (1, H, W), T)
    _, _, res4 = pc.finish_shade(cols, W)
    dy = torch.full((3, N), 1e-7, device=dev)
    gcol, rid2, gval2 = ac.aa_backward(dy, ct, idf, vtbl, res4, (1, H, W), T)
    aa_ent = scatter.entries(rid2.reshape(-1), gval2, T)
    grast, gval, _ = ic.interp_backward(atbl, u, v, idf, None, gcol, None, (), T, 0)
    rid_a = ra.pixel_rows(idf, T, 0, T)
    in_ent = scatter.entries(rid_a, gval, T)
    g9, rid9 = ra.raster_grad_rows(vtbl, idf, grast[0], grast[1], None, res, T)
    ra_ent = scatter.entries(rid9, g9, T)
    gt9 = scatter.scatter_entries(*ra_ent, g9)
    gt_aa = scatter.scatter_entries(*aa_ent, gval2)
    gt_a = scatter.scatter_entries(*in_ent, gval)

    return step, [
        ("fwd: topology table", lambda: build_opposite_table(tri)),
        ("fwd: raster prepass", lambda: rc.build_records(pos, tri, res)),
        ("fwd: rasterize kernel (db)", lambda: rc.rasterize_records(rec, aabb, res,
                                                                    emit_db=True)),
        ("fwd: rast, rast_db images", lambda: (torch.stack(outs[:4], -1),
                                               torch.stack(outs[4:], -1))),
        ("fwd: attr table", lambda: pl._attr_table(col, cidx, 1, T)),
        ("fwd: interp_fwd kernel", lambda: ic.interp_forward(atbl, u, v, idf, None, ())),
        ("fwd: AA table", lambda: _build_tables(pos, tri, op, H, W)),
        ("fwd: aa_fwd kernel", lambda: ac.aa_cols(ct, idf, zw, ftable, (1, H, W), T)),
        ("fwd: neighbour adds", lambda: pc.finish_shade(cols, W)),
        ("bwd: aa_bwd kernel", lambda: ac.aa_backward(dy, ct, idf, vtbl, res4, (1, H, W), T)),
        ("bwd: AA pairs' entries (index glue)",
         lambda: scatter.entries(rid2.reshape(-1), gval2, T)),
        ("bwd: AA pairs' scatter_rows kernel", lambda: scatter.scatter_entries(*aa_ent, gval2)),
        ("bwd: interp_bwd kernel",
         lambda: ic.interp_backward(atbl, u, v, idf, None, gcol, None, (), T, 0)),
        ("bwd: attribute entries (index glue)", lambda: scatter.entries(rid_a, gval, T)),
        ("bwd: attribute scatter_rows kernel", lambda: scatter.scatter_entries(*in_ent, gval)),
        ("bwd: table_take kernel", lambda: gather.table_take(vtbl, rid9)),
        ("bwd: raster rows (glue, table_take included)",
         lambda: ra.raster_grad_rows(vtbl, idf, grast[0], grast[1], None, res, T)),
        ("bwd: raster entries (index glue)", lambda: scatter.entries(rid9, g9, T)),
        ("bwd: raster scatter_rows kernel", lambda: scatter.scatter_entries(*ra_ent, g9)),
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
    rec, aabb = rc.build_records(pos, tri, res)
    u, v, zw, idf, *db = (x.reshape(N) for x in
                          rc.rasterize_records(rec, aabb, res, emit_db=True))
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
    entries = tb.grad_entries(uvc[0], uvc[1], fl, meta, flat.shape[0], shape, False,
                              *mode[::-1])
    g_flat = tb.grad_from_entries(*entries, uvc[0], uvc[1], fl, gc, meta, shape, False,
                                  *mode[::-1])
    gda4 = tx.mip_level_vjp(da, gfl, 512, 512, len(levels))
    atbl = pl._attr_table(uv, cidx, 1, T)
    db4 = torch.stack(db)
    out15 = ptb.interp_raster_bwd_tex(atbl, vtbl, idf, gu, gv, gda4, db4, res, T)
    rid0 = pl.own_rows(idf, T, res)
    codes, off = pb._entries(rid0, out15[:11], dd2, rid2, T, out15[11:])
    flats = (u, v, res4[1], res4[3])
    gt, gaa = pb.scatter_entries(codes, off, out15[:11], dd2, flats, vtbl, res, out15[11:])

    return step, [
        ("topology table", lambda: build_opposite_table(tri)),
        ("raster prepass", lambda: rc.build_records(pos, tri, res)),
        ("rasterize kernel (db)", lambda: rc.rasterize_records(rec, aabb, res, emit_db=True)),
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
        ("bwd: texture_grad index glue (keys, sort)", lambda: tb.grad_entries(
            uvc[0], uvc[1], fl, meta, flat.shape[0], shape, False, *mode[::-1])),
        ("bwd: texture_grad kernel", lambda: tb.grad_from_entries(
            *entries, uvc[0], uvc[1], fl, gc, meta, shape, False, *mode[::-1])),
        ("bwd: pyramid vjp", lambda: tx.pyramid_vjp(g_flat, meta, 1, 3)),
        ("bwd: mip-level vjp", lambda: tx.mip_level_vjp(da, gfl, 512, 512, len(levels))),
        ("bwd: interp_raster_bwd_tex kernel",
         lambda: ptb.interp_raster_bwd_tex(atbl, vtbl, idf, gu, gv, gda4, db4, res, T)),
        ("bwd: entry sort (index glue)",
         lambda: pb._entries(rid0, out15[:11], dd2, rid2, T, out15[11:])),
        ("bwd: grad_scatter kernel (da4)", lambda: pb.scatter_entries(
            codes, off, out15[:11], dd2, flats, vtbl, res, out15[11:])),
        ("bwd: vertex sums", lambda: (
            pl.vertex_pos_grad(gt[:, 6:], gaa, tri, tuple(pos.shape), 1.0),
            pl.vertex_attr_grad(gt[:, :6], cidx, tuple(uv.shape), 1))),
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = _card()
    res = (args.res, args.res)

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(32, 64)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    pos = torch.as_tensor((posw @ mvp.T)[None], dtype=torch.float32, device=dev)
    tri = torch.as_tensor(pos_idx, dtype=torch.int32, device=dev)
    cidx = torch.as_tensor(col_idx, dtype=torch.int32, device=dev)
    col = torch.as_tensor(vtxp * 0.5 + 0.5, dtype=torch.float32, device=dev)
    if args.textured:
        what = "textured fwd+bwd"
        step, stages = _textured(pos, tri, cidx, vtxp, res)
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
