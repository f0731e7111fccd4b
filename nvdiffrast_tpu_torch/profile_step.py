"""Where the time of one training step of render_pipeline goes, on a GPU.

    python -m nvdiffrast_tpu_torch.profile_step [--res 2048] [--steps 16]

The bench scene (uv-sphere 32x64, 3,968 triangles, vertex colours,
A = 3, B = 1, camera projection(x=0.4) @ translate(0, 0, -3.5)). One
step is render_pipeline's forward, mean(img**2) and the backward to pos
and the colours. Prints:
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
from .ops import pipeline as pl
from .ops import pipeline_bwd_cuda as pb
from .ops import pipeline_cuda as pc
from .ops import rasterize_cuda as rc
from .ops.antialias import _build_tables
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
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

    def step():
        p = pos.detach().requires_grad_()
        c = col.detach().requires_grad_()
        img = pl.render_pipeline(p, tri, c, res, attr_idx=cidx)
        return torch.autograd.grad((img ** 2).mean(), (p, c))

    step_ms = _window_ms(step)
    print(f"[1] fwd+bwd {args.res}^2: {step_ms:.3f} ms/step, "
          f"{args.res ** 2 / 1e3 / step_ms:.2f} Mpix/s ({card})", flush=True)

    # -- 2. stages, each alone and synchronised ------------------------------
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
    stages = [
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
        ("whole step", step),
    ]
    total = 0.0
    for name, fn in stages:
        ms = _timed(fn, 20)
        total += ms if name != "whole step" else 0.0
        print(f"[2] {name}: {ms:.3f} ms", flush=True)
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
