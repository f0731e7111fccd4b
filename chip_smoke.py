#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (nvdiffrast_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's kernels from nvdiffrast_tpu_torch/csrc, then:
  1. device: prints the card (nvidia-smi name and power limit) and the
     build time;
  2. rasterizer kernel against its plain PyTorch twin on the card
     (uv-sphere at 256^2 and 512^2, B = 1 and 2; random adversarial
     scene at 67x130, B = 2), held to the z-fight parity bar;
  3. shade_fwd kernel against its twin on the card, on the same
     rasterizer buffers at 2048^2, B = 1, within 1e-5 absolute;
  4. the slice: render_pipeline forward on the bench scene (uv-sphere
     32x64, 2048^2, A = 3): 8 requests with perturbed cameras and one
     B = 2 render, each finite, plausibly covered and bitwise
     repeatable, through both kernels (launch counts), plus a small
     render held against the CPU path; then the forward's time per
     frame and Mpix/s, and the twins' at 512^2;
  5. the backward kernels against their twins on the card, at 2048^2 on
     the bench scene with dy from the forward's real loss mean(img**2):
     pipeline_bwd bit for bit, grad_scatter within 1e-6 of each row's
     largest entry; their times, and index_add_ over the expanded rows
     as the scatter's library yardstick;
  6. the training slice: gradients of mean(render_pipeline(...)**2) to
     pos and the vertex colours at 2048^2, finite, non-zero, bitwise
     repeatable, B = 2 equal to two B = 1 runs, at 256^2 within 1e-5 of
     the largest gradient of the CPU path; all four kernels launched;
     the fwd+bwd step's ms and Mpix/s; then 5 Adam steps fitting the
     colours and a pose offset to a target render, the loss falling;
  7. the textured forward's kernels against their twins on the card, at
     2048^2 on the bench textured scene (bench.py:90-119: a 512x512x3
     texture from rand seed 0, spherical uvs, linear-mipmap-linear,
     wrap): the rasterizer's db variant, interpolate, the texture sampler
     and antialias, each bit for bit, with their times; F.grid_sample on
     the base level (linear filter, clamp) as the sampler's library
     yardstick;
  8. the textured slice: render_pipeline_textured on 8 perturbed views
     and one B = 2 render, finite, plausibly covered, bitwise repeatable,
     B = 2 equal to two B = 1 renders, through all four kernels (launch
     counts), a 256^2 render held against the CPU path; its ms/frame and
     Mpix/s;
  9. the textured backward's kernels against their twins at 2048^2 on
     the bench textured scene, with dy from mean(img**2): texture_bwd and
     interp_raster_bwd_tex bit for bit, texture_grad within 1 ulp and
     grad_scatter with da4 within 1e-6 of each row's largest entry; their
     times, grid_sample's backward (to the grid, to the input) and
     index_add_ as library yardsticks;
 10. the textured training slice: gradients of mean(img**2) to pos, uv
     and the texture on the 8 views, finite, bitwise repeatable, B = 2
     g_pos equal to two B = 1 runs, at 256^2 within the CPU tests' bars
     of the CPU path; all eight textured kernels launched; the fwd+bwd
     step's ms, Mpix/s and peak memory; 5 Adam steps fitting the texture
     and a pose offset, the loss falling.
 11. the standalone ops' backward kernels against their twins at 2048^2
     on the bench scene, each fed the cotangent of the stage after it
     (dy of mean(img**2)): aa_bwd, interp_bwd and table_take bit for bit,
     scatter_rows within 1 ulp of its float64 twin and bitwise repeatable
     on the rasterize backward's rows and with a hot row of every other
     covered pixel; their times, index_select and index_add_ as yardsticks;
 12. the composed ops' training slice, rasterize -> interpolate ->
     antialias, gradients of mean(img**2) to pos and the colours on the 8
     views: finite, non-zero, bitwise repeatable, B = 2 equal to two B = 1
     runs, equal to render_pipeline's within the bars, at 256^2 within
     1e-5 of the CPU path; all seven kernels launched; ms/step, peak
     memory, launches per step; then render_pipeline_textured with
     filter_mode='linear', fwd + bwd, the same checks;
 13. CubeFitModel(16) for 150 steps (error < 0.08) and
     PoseFitModel(64).fit(300) (angle < 2 degrees) on the card, their
     ms per step.
It prints one JSON line of per-kernel results (with each kernel's
bound: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s) and, last, the device line. Any failed
check raises, so the exit code is not 0. Without a CUDA device, or
without the package beside it, it fails at once.
"""

import json
import os
import subprocess
import sys
import time

RES = 2048
RASTER_SIZES = (256, 512)  # sphere scenes of phase 2
SMALL = 256                # GPU vs CPU render of phase 4
TWIN_RES = 512             # forward with the plain twins, phase 4
ZFIGHT_FRAC = 2e-4   # tests/test_parity_sweep.py: mismatched ids on <= 2e-4 of pixels
ZFIGHT_DEPTH = 1e-4  # ... with depths within 1e-4 there
RASTER_ATOL = 1e-4   # u, v, z/w where ids agree
SHADE_ATOL = 1e-5
SCATTER_ROW_RTOL = 1e-6  # grad_scatter vs twin: float64 sums, order differs
GRAD_CPU_RTOL = 1e-5     # GPU vs CPU gradients, of the largest gradient
ADAM_STEPS = 5
TEX_SIZE = 512
FILTER = "linear-mipmap-linear"  # bench.py's textured line
BOUNDARY = "wrap"
TEX_CPU_ATOL = 1e-5  # textured GPU vs CPU render, per pixel
TEX_GRAD_RTOL = 5e-5  # textured GPU vs CPU gradients: the CPU tests' bars
TEX_ROW_RTOL = 5e-4   # (tests/_torch_parity.py), of the largest / the row's
CUBE_STEPS = 150    # tests/test_models.py: cube error < 0.08 after 150 steps
CUBE_BAR = 0.08
POSE_ITERS = 300    # pose angle < 2 degrees after 300 iterations
POSE_BAR = 2.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3 rate and float32 peak
F32_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sphere_scene(cams):
    """Bench scene (bench.py:55-64): uv-sphere 32x64, vertex colours
    vtx*0.5+0.5, one clip-space position set per camera matrix."""
    import numpy as np
    from nvdiffrast_tpu_torch.models import primitives

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(32, 64)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos = np.stack([(posw @ m.T).astype(np.float32) for m in cams])
    col = (vtxp * 0.5 + 0.5).astype(np.float32)
    return pos, pos_idx, col, col_idx


def sphere_uv():
    """bench.py:96-98: spherical uv of the bench sphere's vertices."""
    import numpy as np
    from nvdiffrast_tpu_torch.models import primitives

    _, vtxp, _, _ = primitives.uv_sphere(32, 64)
    return np.stack([np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
                     np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi],
                    axis=1).astype(np.float32)


def bench_texture():
    """bench.py:93-94: rand(1, 512, 512, 3), seed 0."""
    import numpy as np

    return np.random.RandomState(0).rand(1, TEX_SIZE, TEX_SIZE, 3).astype(np.float32)


def cameras(n, seed):
    """n perturbed views of the bench camera (the first unperturbed)."""
    import numpy as np
    from nvdiffrast_tpu_torch.utils import camera

    rng = np.random.RandomState(seed)
    base = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    return [base] + [base @ camera.random_rotation_translation(0.15, rng)
                     for _ in range(n - 1)]


def random_scene(seed, B, V=64, T=48):
    """tests/test_parity_sweep.py _random_scene: near-plane crossers and
    degenerate triangles."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.4, 2.5, (B, V))
    k = max(2, V // 10)
    pos[:, :k, 3] = rng.uniform(-0.5, 0.1, (B, k))
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    tri[0] = [3, 3, 7]
    tri[1] = [5, 5, 5]
    return pos, tri


def cuda_ms(torch, fn, iters):
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def window_ms(torch, step, argsets):
    """bench._measure: difference of two synchronised host-clock windows
    (16 vs 48 steps over varying inputs), per step, in ms."""
    for i in range(4):
        step(*argsets[i % len(argsets)])
    torch.cuda.synchronize()

    def window(iters):
        t0 = time.perf_counter()
        for i in range(iters):
            step(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t1 = window(16)
    t2 = window(48)
    return max(t2 - t1, 1e-9) / 32 * 1e3


def equal_or_raise(got, ref, what):
    """Kernel outputs bit for bit with the twin's; returns the max |err|
    (0.0)."""
    import torch

    for i, (x, y) in enumerate(zip(got, ref)):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: output {i} differs from its twin")
    return 0.0


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rows_close(got, ref, rel):
    """Each row of `got` within rel * max|row of ref| (zero rows exact).
    Returns the largest error over that row scale."""
    scale = ref.abs().amax(1, keepdim=True)
    err = (got - ref).abs()
    if not bool((err <= rel * scale).all()):
        raise AssertionError(f"rows differ beyond {rel} of their scale")
    return float((err / scale.clamp(min=1e-30)).max())


def zfight_check(ref, got, what):
    """Rasterizer outputs (u, v, zw, idf) held to the z-fight bar.
    Returns (max |err| where ids agree, mismatched ids)."""
    differ = ref[3] != got[3]
    n_diff = int(differ.sum())
    if n_diff:
        zerr = float((ref[2][differ] - got[2][differ]).abs().max())
        if zerr > ZFIGHT_DEPTH:
            raise AssertionError(f"{what}: id mismatch at non-tied depth ({zerr})")
        if n_diff > ZFIGHT_FRAC * differ.numel():
            raise AssertionError(f"{what}: {n_diff} id mismatches")
    same = ~differ
    err = max(float((a[same] - b[same]).abs().max()) for a, b in zip(ref[:3], got[:3]))
    if not err <= RASTER_ATOL:
        raise AssertionError(f"{what}: u/v/zw differ by {err}")
    return err, n_diff


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch import _build
    from nvdiffrast_tpu_torch.ops import gather, scatter
    from nvdiffrast_tpu_torch.ops import rasterize as ra
    from nvdiffrast_tpu_torch.ops import antialias_cuda as ac
    from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
    from nvdiffrast_tpu_torch.ops import pipeline as pl
    from nvdiffrast_tpu_torch.ops import pipeline_tex as ptx
    from nvdiffrast_tpu_torch.ops import texture as tx
    from nvdiffrast_tpu_torch.ops import texture_cuda as tc
    from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
    from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
    from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as ptb
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as txb
    from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
    from nvdiffrast_tpu_torch.ops.antialias import _build_tables, pair_ids
    from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    card = card_line()
    log(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("    ptxas:", line.strip())

    # -- 2. rasterizer kernel vs twin ----------------------------------------
    raster_err = 0.0
    scenes = []
    for res in RASTER_SIZES:
        for B in (1, 2):
            pos, tri, _, _ = sphere_scene(cameras(B, seed=res + B))
            scenes.append((f"sphere {res}^2 B={B}", pos, tri, (res, res)))
    pos, tri = random_scene(1, B=2)
    scenes.append(("random 67x130 B=2", pos, tri, (67, 130)))
    for what, pos, tri, res in scenes:
        p, t = inputs_from_numpy(pos, tri, device=dev)
        rec, aabb = rc.build_records(p, t, res)
        got = rc.rasterize_records(rec, aabb, res)
        ref = rc.rasterize_records_plain(rec, aabb, res)
        torch.cuda.synchronize()
        err, n_diff = zfight_check(ref, got, what)
        raster_err = max(raster_err, err)
        cover = float((got[3] > 0).float().mean())
        log(f"[2] rasterize {what}: max|err| {err:.3g}, id mismatches {n_diff}, "
            f"covered {cover:.3f}")

    # Bench scene at 2048^2: kernel vs twin, and their times.
    pos, tri, col, cidx = sphere_scene(cameras(1, seed=0))
    p, t, a, c = inputs_from_numpy(pos, tri, col, cidx, device=dev)
    res = (RES, RES)
    rec, aabb = rc.build_records(p, t, res)
    got = rc.rasterize_records(rec, aabb, res)
    ref = rc.rasterize_records_plain(rec, aabb, res)
    err, n_diff = zfight_check(ref, got, f"sphere {RES}^2 B=1")
    raster_err = max(raster_err, err)
    log(f"[2] rasterize sphere {RES}^2 B=1: max|err| {err:.3g}, id mismatches {n_diff}")
    raster_ms = cuda_ms(torch, lambda: rc.rasterize_records(rec, aabb, res), 20)
    raster_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(rec, aabb, res), 3)
    log(f"[2] rasterize {RES}^2: kernel {raster_ms:.3f} ms, twin {raster_plain_ms:.3f} ms "
        f"({card})")

    # -- 3. shade_fwd kernel vs twin (same raster buffers, 2048^2) ------------
    N = RES * RES
    T = tri.shape[0]
    b0f, b1f, zwf, idff = (x.reshape(N) for x in got)
    atbl = pl._attr_table(a, c, 1, T)
    ftable, _, _, _ = _build_tables(p, t, build_opposite_table(t), RES, RES)
    args = (atbl, ftable, b0f, b1f, zwf, idff, res, T)
    kc = pc.shade_cols(*args)
    pcs = pc.shade_cols_plain(*args)
    torch.cuda.synchronize()
    shade_err = max(float((x - y).abs().max()) for x, y in zip(kc, pcs))
    if not shade_err <= SHADE_ATOL:
        raise AssertionError(f"shade_fwd kernel vs twin: max|err| {shade_err}")
    n_pairs = int((kc[4] != 0).sum() + (kc[6] != 0).sum())
    log(f"[3] shade_fwd {RES}^2: max|err| {shade_err:.3g} over 8 outputs, "
        f"{n_pairs} AA pairs with alpha != 0")
    shade_ms = cuda_ms(torch, lambda: pc.shade_cols(*args), 50)
    shade_plain_ms = cuda_ms(torch, lambda: pc.shade_cols_plain(*args), 5)
    log(f"[3] shade_fwd {RES}^2: kernel {shade_ms:.3f} ms, twin {shade_plain_ms:.3f} ms ({card})")

    # -- 4. the slice: render_pipeline forward --------------------------------
    cams = cameras(8, seed=1)
    pos8, tri8, col8, cidx8 = sphere_scene(cams)
    _, t8, a8, c8 = inputs_from_numpy(pos8[:1], tri8, col8, cidx8, device=dev)
    reqs = [inputs_from_numpy(pos8[i:i + 1], device=dev)[0] for i in range(8)]
    pos2 = inputs_from_numpy(pos8[:2], device=dev)[0]
    for k in (rc.KERNEL, pc.KERNEL):
        k.launches = 0
    with torch.no_grad():
        imgs = []
        for view in reqs:
            img = pl.render_pipeline(view, t8, a8, res, attr_idx=c8)
            again = pl.render_pipeline(view, t8, a8, res, attr_idx=c8)
            imgs.append((img, again))
        img2 = pl.render_pipeline(pos2, t8, a8, res, attr_idx=c8)
        torch.cuda.synchronize()
    launches = {"rasterize": rc.KERNEL.launches, "shade_fwd": pc.KERNEL.launches}
    log(f"[4] launches during the slice: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for i, (img, again) in enumerate(imgs):
        if img.shape != (1, RES, RES, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"request {i}: bad output {tuple(img.shape)}")
        if not torch.equal(img, again):
            raise AssertionError(f"request {i}: not bitwise repeatable")
        cover = float((img.abs().sum(-1) > 0).float().mean())
        if not 0.2 <= cover <= 0.7:
            raise AssertionError(f"request {i}: implausible coverage {cover}")
        log(f"[4] request {i}: covered {cover:.4f}, mean colour "
            f"{[round(float(x), 5) for x in img.mean((0, 1, 2))]}")
    if img2.shape != (2, RES, RES, 3) or not bool(torch.isfinite(img2).all()):
        raise AssertionError("B=2 render: bad output")
    for b in range(2):
        if not torch.equal(img2[b:b + 1], imgs[b][0]):
            raise AssertionError(f"B=2 render: image {b} differs from its B=1 render")
    log("[4] B=2 render: both images equal their B=1 renders bitwise")

    # The card's render against the CPU path (plain twins) on a small input.
    small = (SMALL, SMALL)
    with torch.no_grad():
        gpu = pl.render_pipeline(reqs[3], t8, a8, small, attr_idx=c8).cpu()
        cpu = pl.render_pipeline(reqs[3].cpu(), t8.cpu(), a8.cpu(), small,
                                 attr_idx=c8.cpu())
    bad = (gpu - cpu).abs().amax(-1) > RASTER_ATOL
    if int(bad.sum()) > ZFIGHT_FRAC * bad.numel():
        raise AssertionError(f"GPU vs CPU render: {int(bad.sum())} pixels differ")
    log(f"[4] {SMALL}^2 render, GPU vs CPU path: max|err| "
        f"{float((gpu - cpu).abs().max()):.3g}, pixels over {RASTER_ATOL}: {int(bad.sum())}")

    # Throughput: kernel path at 2048^2, twin path at 512^2.
    def fwd(view):
        with torch.no_grad():
            return pl.render_pipeline(view, t8, a8, res, attr_idx=c8)

    fwd_ms = window_ms(torch, fwd, [(view,) for view in reqs])
    mpix = RES * RES / 1e6 / (fwd_ms / 1e3)
    log(f"[4] render_pipeline fwd {RES}^2 (kernels): {fwd_ms:.3f} ms/frame, "
        f"{mpix:.2f} Mpix/s ({card})")

    tres = (TWIN_RES, TWIN_RES)
    op8 = build_opposite_table(t8)

    def twin_fwd(view):
        rec_, aabb_ = rc.build_records(view, t8, tres)
        u, v, zw, idf = rc.rasterize_records_plain(rec_, aabb_, tres)
        n = tres[0] * tres[1]
        ft, _, _, _ = _build_tables(view, t8, op8, *tres)
        cols = pc.shade_cols_plain(pl._attr_table(a8, c8, 1, T), ft, u.reshape(n),
                                   v.reshape(n), zw.reshape(n), idf.reshape(n), tres, T)
        return pc.finish_shade(cols, tres[1])

    twin_ms = window_ms(torch, twin_fwd, [(view,) for view in reqs])
    twin_mpix = tres[0] * tres[1] / 1e6 / (twin_ms / 1e3)
    log(f"[4] forward with plain twins, {TWIN_RES}^2: {twin_ms:.3f} ms/frame, "
        f"{twin_mpix:.2f} Mpix/s ({card})")

    # -- 5. backward kernels vs twins (2048^2, dy of mean(img**2)) ------------
    A = a.shape[-1]
    color, saved = pl._pipeline_fwd_core(p, a, t, c, build_opposite_table(t), res)
    b0, b1, idf, c0, al0, ax0, al1, ax1, atbl_s, vtbl = saved
    color = color.requires_grad_()
    dimg = torch.autograd.grad((color ** 2).mean(), color)[0]
    dy = dimg.reshape(N, A).T.contiguous()
    bargs = (atbl_s, vtbl, idf, c0, dy, (al0, ax0, al1, ax1), res, T)
    kb = pb.pipeline_bwd(*bargs)
    tb = pb.pipeline_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for x, y in zip(kb, tb):
        if not torch.equal(x, y):
            raise AssertionError("pipeline_bwd kernel differs from its twin")
    bwd_err = 0.0
    gs, dd2, rid2 = kb
    n_dd = int((dd2 != 0).sum())
    log(f"[5] pipeline_bwd {RES}^2: equal to its twin bit for bit; {n_dd} AA pairs "
        f"with dd != 0, max|gs| {float(gs.abs().max()):.3g}")
    bwd_ms = cuda_ms(torch, lambda: pb.pipeline_bwd(*bargs), 50)
    bwd_plain_ms = cuda_ms(torch, lambda: pb.pipeline_bwd_plain(*bargs), 5)
    log(f"[5] pipeline_bwd {RES}^2: kernel {bwd_ms:.3f} ms, twin {bwd_plain_ms:.3f} ms ({card})")

    R = vtbl.shape[1] - 1
    rid0 = pl.own_rows(idf, T, res)
    sargs = (rid0, gs, dd2, rid2, b0, b1, ax0, ax1, vtbl, res)
    ks = pb.grad_scatter(*sargs)
    ks2 = pb.grad_scatter(*sargs)
    ts = pb.grad_scatter_plain(*sargs)
    torch.cuda.synchronize()
    scatter_err = 0.0
    for x, y, z in zip(ks, ks2, ts):
        if not torch.equal(x, y):
            raise AssertionError("grad_scatter kernel not repeatable")
        rows_close(x, z, SCATTER_ROW_RTOL)
        scatter_err = max(scatter_err, float((x - z).abs().max()))
    codes, off = pb._entries(rid0, gs, dd2, rid2, R)
    flats = (b0, b1, ax0, ax1)
    n_own = int((codes < N).sum())
    n_aa = codes.shape[0] - n_own
    log(f"[5] grad_scatter {RES}^2: {n_own} own-pixel and {n_aa} AA entries over "
        f"{R} rows; max|err| vs twin {scatter_err:.3g} (bar {SCATTER_ROW_RTOL} x row max)")
    scatter_ms = cuda_ms(torch, lambda: pb.scatter_entries(codes, off, gs, dd2, flats,
                                                           vtbl, res), 50)
    entries_ms = cuda_ms(torch, lambda: pb._entries(rid0, gs, dd2, rid2, R), 20)
    scatter_plain_ms = cuda_ms(torch, lambda: pb.grad_scatter_plain(*sargs), 3)
    (orow, own), (arow, aav) = pb.expand_rows(*sargs)
    orow, arow = orow.long(), arow.long()
    zgt = torch.zeros((R, own.shape[1]), dtype=torch.float32, device=dev)
    zgaa = torch.zeros((R, 9), dtype=torch.float32, device=dev)
    scatter_lib_ms = cuda_ms(torch, lambda: (zgt.index_add_(0, orow, own),
                                             zgaa.index_add_(0, arow, aav)), 50)
    log(f"[5] grad_scatter {RES}^2: kernel {scatter_ms:.3f} ms + index glue (sort) "
        f"{entries_ms:.3f} ms, twin {scatter_plain_ms:.3f} ms, index_add_ over the "
        f"expanded rows {scatter_lib_ms:.3f} ms ({card})")

    # -- 6. the training slice: fwd + bwd at 2048^2 ----------------------------
    def grads(view, colour, size):
        pv = view.detach().clone().requires_grad_()
        cv = colour.detach().clone().requires_grad_()
        img = pl.render_pipeline(pv, t8, cv, size, attr_idx=c8)
        # Per-image mean, summed over the batch (= mean(img**2) at B = 1).
        loss = (img ** 2).mean(dim=(1, 2, 3)).sum()
        return torch.autograd.grad(loss, (pv, cv))

    for k in (rc.KERNEL, pc.KERNEL, pb.BWD_KERNEL, pb.SCATTER_KERNEL):
        k.launches = 0
    g1 = [grads(reqs[i], a8, res) for i in range(2)]
    again = grads(reqs[0], a8, res)
    col2 = a8.expand(2, -1, -1).contiguous()  # per-image colours: per-image gradients
    g2 = grads(pos2, col2, res)
    torch.cuda.synchronize()
    train_launches = {"rasterize": rc.KERNEL.launches, "shade_fwd": pc.KERNEL.launches,
                      "pipeline_bwd": pb.BWD_KERNEL.launches,
                      "grad_scatter": pb.SCATTER_KERNEL.launches}
    log(f"[6] launches during the training slice: {train_launches}")
    if min(train_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {train_launches}")
    for i, (gp, gc) in enumerate(g1):
        for name, g in (("pos", gp), ("col", gc)):
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"view {i}: {name} gradient not finite or all zero")
    for x, y in zip(g1[0], again):
        if not torch.equal(x, y):
            raise AssertionError("gradients not bitwise repeatable")
    for b in range(2):
        if not (torch.equal(g2[0][b], g1[b][0][0]) and torch.equal(g2[1][b], g1[b][1])):
            raise AssertionError(f"B=2 gradients of image {b} differ from its B=1 run")
    log(f"[6] gradients finite, non-zero, bitwise repeatable; B=2 equal to two B=1 "
        f"runs bit for bit; max|g_pos| {float(g1[0][0].abs().max()):.3g}, "
        f"max|g_col| {float(g1[0][1].abs().max()):.3g}")

    gpu_g = [g.cpu() for g in grads(reqs[3], a8, small)]
    cpu_g = grads(reqs[3].cpu(), a8.cpu(), small)
    for name, x, y in zip(("pos", "col"), gpu_g, cpu_g):
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        if not (scale > 0 and err <= GRAD_CPU_RTOL * scale):
            raise AssertionError(f"{SMALL}^2 {name} gradient, GPU vs CPU: {err} of {scale}")
        log(f"[6] {SMALL}^2 {name} gradient, GPU vs CPU path: max|err| {err:.3g} "
            f"(max|g| {scale:.3g}, bar {GRAD_CPU_RTOL} x max|g|)")

    step_ms = window_ms(torch, lambda view: grads(view, a8, res), [(v,) for v in reqs])
    step_mpix = RES * RES / 1e6 / (step_ms / 1e3)
    log(f"[6] render_pipeline fwd+bwd {RES}^2 (kernels): {step_ms:.3f} ms/step, "
        f"{step_mpix:.2f} Mpix/s ({card})")

    # A few Adam steps: colours and a pose offset fit a target render.
    from nvdiffrast_tpu_torch.models import primitives
    from nvdiffrast_tpu_torch.utils import camera
    _, vtxp, _, _ = primitives.uv_sphere(32, 64)
    vtx = torch.as_tensor(vtxp, dtype=torch.float32, device=dev)
    mvp = torch.as_tensor(camera.projection(x=0.4) @ camera.translate(0, 0, -3.5),
                          dtype=torch.float32, device=dev)

    def clip(offset):
        posw = torch.cat([vtx + offset, torch.ones_like(vtx[:, :1])], dim=1)
        return (posw @ mvp.T)[None]

    gen = torch.Generator().manual_seed(5)
    zero = torch.zeros(3, device=dev)
    with torch.no_grad():
        target = pl.render_pipeline(clip(zero), t8, a8, res, attr_idx=c8)
    colour = (a8 + 0.2 * torch.randn(a8.shape, generator=gen).to(dev)).requires_grad_()
    offset = (0.05 * torch.randn(3, generator=gen).to(dev)).requires_grad_()
    opt = torch.optim.Adam([colour, offset], lr=0.02)
    losses = []
    kernels_of_path = (rc.KERNEL, pc.KERNEL, pb.BWD_KERNEL, pb.SCATTER_KERNEL)
    for k in kernels_of_path:
        k.launches = 0
    for _ in range(ADAM_STEPS):
        img = pl.render_pipeline(clip(offset), t8, colour, res, attr_idx=c8)
        loss = ((img - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_launches = {k.name: k.launches for k in kernels_of_path}
    log(f"[6] Adam fit, {ADAM_STEPS} steps at {RES}^2: loss {losses}; launches {fit_launches}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Adam fit: the loss did not fall: {losses}")
    if min(fit_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {fit_launches}")

    # -- 7. the textured forward's kernels vs twins (2048^2, bench scene) ----
    uvs = sphere_uv()
    tex_np = bench_texture()
    tpos, ttri, _, tcidx = sphere_scene(cameras(1, seed=0))
    p, t, tu, tuv, ttex = inputs_from_numpy(tpos, ttri, tcidx, uvs, tex_np, device=dev)
    trec, taabb = rc.build_records(p, t, res)
    got = rc.rasterize_records(trec, taabb, res, emit_db=True)
    ref = rc.rasterize_records_plain(trec, taabb, res, emit_db=True)
    torch.cuda.synchronize()
    db_err = equal_or_raise(got, ref, "rasterize db")
    equal_or_raise(got[:4], rc.rasterize_records(trec, taabb, res), "rasterize db vs no db")
    log(f"[7] rasterize with db {RES}^2: equal to its twin bit for bit (8 outputs), "
        f"u, v, zw, id equal to the kernel without db; max|dudx| "
        f"{float(got[4].abs().max()):.3g}")
    db_ms = cuda_ms(torch, lambda: rc.rasterize_records(trec, taabb, res, emit_db=True), 20)
    db_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(trec, taabb, res,
                                                                    emit_db=True), 3)
    log(f"[7] rasterize with db {RES}^2: kernel {db_ms:.3f} ms, twin {db_plain_ms:.3f} ms "
        f"({card})")

    u, v, zw, idf, *db = (x.reshape(N) for x in got)
    utbl = pl._attr_table(tuv, tu, 1, T)
    iargs = (utbl, u, v, idf, tuple(db), (0, 1))
    uv, da = ic.interp_forward(*iargs)
    interp_err = equal_or_raise((uv, da), ic.interp_forward_plain(*iargs), "interp_fwd")
    interp_ms = cuda_ms(torch, lambda: ic.interp_forward(*iargs), 50)
    interp_plain_ms = cuda_ms(torch, lambda: ic.interp_forward_plain(*iargs), 5)
    log(f"[7] interp_fwd {RES}^2: equal to its twin bit for bit; kernel {interp_ms:.3f} ms, "
        f"twin {interp_plain_ms:.3f} ms ({card})")

    levels = [ttex] + tx.build_mip_stack(ttex)
    meta, n_texels = tx._static_meta(levels)
    L = len(levels)
    flat = tx._pack_pyramid(levels)
    flevel = tx.mip_level(da, TEX_SIZE, TEX_SIZE, L)
    sargs = (flat, uv[0], uv[1], flevel, meta, (1, RES, RES), False, BOUNDARY, FILTER)
    color = tc.sample(*sargs)
    tex_err = equal_or_raise((color,), (tc.sample_plain(*sargs),), "texture_fwd")
    l0 = flevel.floor().clamp(0, L - 1)
    n_two = int(((l0 < L - 1) & (flevel > l0)).sum())  # pixels that blend two levels
    log(f"[7] texture_fwd {RES}^2 ({FILTER}, {BOUNDARY}, {L} levels, {n_texels} texels): "
        f"equal to its twin bit for bit; {n_two} pixels blend two levels, flevel in "
        f"[{float(flevel.min()):.3f}, {float(flevel.max()):.3f}]")
    tex_ms = cuda_ms(torch, lambda: tc.sample(*sargs), 50)
    tex_plain_ms = cuda_ms(torch, lambda: tc.sample_plain(*sargs), 5)
    # Library yardstick: grid_sample computes the sampler's function for
    # filter 'linear' with 'clamp' (border padding, align_corners=False).
    largs = (flat[:TEX_SIZE * TEX_SIZE], uv[0], uv[1], flevel, meta[:1], (1, RES, RES),
             False, "clamp", "linear")
    lin = tc.sample(*largs)
    base = ttex.permute(0, 3, 1, 2).contiguous()
    grid = (uv.T.reshape(1, RES, RES, 2) * 2.0 - 1.0).contiguous()

    def library_sample():
        return F.grid_sample(base, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    gs_err = float((library_sample().reshape(3, N) - lin).abs().max())
    lin_ms = cuda_ms(torch, lambda: tc.sample(*largs), 50)
    tex_lib_ms = cuda_ms(torch, library_sample, 50)
    log(f"[7] texture_fwd {RES}^2: kernel {tex_ms:.3f} ms, twin {tex_plain_ms:.3f} ms; "
        f"linear+clamp: kernel {lin_ms:.3f} ms, F.grid_sample {tex_lib_ms:.3f} ms "
        f"(max|diff| {gs_err:.3g}) ({card})")

    ftable_t, _, _, _ = _build_tables(p, t, build_opposite_table(t), RES, RES)
    aargs = (color, idf, zw, ftable_t, (1, RES, RES), T)
    acols = ac.aa_cols(*aargs)
    aa_err = equal_or_raise(acols, ac.aa_cols_plain(*aargs), "aa_fwd")
    log(f"[7] aa_fwd {RES}^2: equal to its twin bit for bit; "
        f"{int((acols[4] != 0).sum() + (acols[6] != 0).sum())} AA pairs with alpha != 0")
    aa_ms = cuda_ms(torch, lambda: ac.aa_cols(*aargs), 50)
    aa_plain_ms = cuda_ms(torch, lambda: ac.aa_cols_plain(*aargs), 5)
    log(f"[7] aa_fwd {RES}^2: kernel {aa_ms:.3f} ms, twin {aa_plain_ms:.3f} ms ({card})")
    # Pairs with work (a triangle and another id across): the pair analysis
    # runs on these; borders fold onto the pixel itself.
    img_id = idf.reshape(RES, RES)
    n_active = 0
    for q in (torch.cat([img_id[:, 1:], img_id[:, -1:]], 1),
              torch.cat([img_id[1:], img_id[-1:]], 0)):
        n_active += int(pair_ids(idf, q.reshape(N), zw, zw, T)[2].sum())

    # -- 8. the textured slice: render_pipeline_textured forward -------------
    tkernels = (rc.DB_KERNEL, ic.KERNEL, tc.KERNEL, ac.KERNEL)

    def render_tex(view, size=res, tex=ttex):
        with torch.no_grad():
            return ptx.render_pipeline_textured(view, t8, tuv, tex, size, uv_tri=c8,
                                                filter_mode=FILTER, boundary_mode=BOUNDARY)

    for k in tkernels:
        k.launches = 0
    timgs = [(render_tex(view), render_tex(view)) for view in reqs]
    timg2 = render_tex(pos2)
    torch.cuda.synchronize()
    tex_launches = {k.name: k.launches for k in tkernels}
    log(f"[8] launches during the textured slice: {tex_launches}")
    if min(tex_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the textured path never launched: {tex_launches}")
    for i, (img, again) in enumerate(timgs):
        if img.shape != (1, RES, RES, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"textured request {i}: bad output {tuple(img.shape)}")
        if not torch.equal(img, again):
            raise AssertionError(f"textured request {i}: not bitwise repeatable")
        # Background pixels sample the texture at uv = (0, 0): one colour,
        # that of the corner pixel, which the sphere never covers.
        cover = float((img != img[:, :1, :1]).any(-1).float().mean())
        if not 0.2 <= cover <= 0.7:
            raise AssertionError(f"textured request {i}: implausible coverage {cover}")
        log(f"[8] textured request {i}: covered {cover:.4f}, mean colour "
            f"{[round(float(x), 5) for x in img.mean((0, 1, 2))]}")
    if timg2.shape != (2, RES, RES, 3) or not bool(torch.isfinite(timg2).all()):
        raise AssertionError("textured B=2 render: bad output")
    for b in range(2):
        if not torch.equal(timg2[b:b + 1], timgs[b][0]):
            raise AssertionError(f"textured B=2 render: image {b} differs from its B=1 render")
    log("[8] textured B=2 render: both images equal their B=1 renders bitwise")

    # The card's textured render against the CPU path on a small input.
    gpu = render_tex(reqs[3], small).cpu()
    with torch.no_grad():
        cpu = ptx.render_pipeline_textured(reqs[3].cpu(), t8.cpu(), tuv.cpu(), ttex.cpu(),
                                           small, uv_tri=c8.cpu(), filter_mode=FILTER,
                                           boundary_mode=BOUNDARY)
    bad = (gpu - cpu).abs().amax(-1) > TEX_CPU_ATOL
    if int(bad.sum()) > ZFIGHT_FRAC * bad.numel():
        raise AssertionError(f"textured GPU vs CPU render: {int(bad.sum())} pixels differ")
    log(f"[8] {SMALL}^2 textured render, GPU vs CPU path: max|err| "
        f"{float((gpu - cpu).abs().max()):.3g}, pixels over {TEX_CPU_ATOL}: {int(bad.sum())}")

    tex_fwd_ms = window_ms(torch, render_tex, [(view,) for view in reqs])
    tex_mpix = RES * RES / 1e6 / (tex_fwd_ms / 1e3)
    log(f"[8] render_pipeline_textured fwd {RES}^2 (kernels): {tex_fwd_ms:.3f} ms/frame, "
        f"{tex_mpix:.2f} Mpix/s ({card})")

    # -- 9. the textured backward's kernels vs twins (2048^2, bench scene) ---
    shape1 = (1, RES, RES)
    C = 3
    timg, tsaved, tmeta = ptx._ptex_fwd_core(p, tuv, ttex, t, tu, build_opposite_table(t),
                                             res, FILTER, BOUNDARY, -1)
    u9, v9, idf9, *db9 = tsaved[:7]
    uv9, da9, fl9, flat9, color9, al0, ax0, al1, ax1, vtbl9 = tsaved[7:]
    timg = timg.requires_grad_()
    dy9 = torch.autograd.grad((timg ** 2).mean(), timg)[0].reshape(N, C).T.contiguous()
    gc9, dd9, rid9 = ptb.aa_bwd_slim(dy9, color9, idf9, (al0, ax0, al1, ax1), shape1, T)

    bargs9 = (flat9, uv9[0], uv9[1], fl9, gc9, tmeta, shape1, False, BOUNDARY, FILTER)
    gu9, gv9, gfl9 = txb.texture_bwd(*bargs9)
    texbwd_err = equal_or_raise((gu9, gv9, gfl9), txb.texture_bwd_plain(*bargs9), "texture_bwd")
    texbwd_ms = cuda_ms(torch, lambda: txb.texture_bwd(*bargs9), 50)
    texbwd_plain_ms = cuda_ms(torch, lambda: txb.texture_bwd_plain(*bargs9), 5)
    # Library yardstick: grid_sample's backward (bilinear, border, not
    # align_corners) computes both gradients for filter 'linear' with
    # 'clamp' on the base level: to the grid (here du = 2 dgrid_x) and to
    # the input.
    base = ttex.permute(0, 3, 1, 2).contiguous()
    grid = (uv9.T.reshape(1, RES, RES, 2) * 2.0 - 1.0).contiguous()
    gout = gc9.reshape(1, C, RES, RES).contiguous()

    def library_bwd(mask):
        return torch.ops.aten.grid_sampler_2d_backward(gout, base, grid, 0, 1, False, mask)

    lbargs = (flat9[:TEX_SIZE * TEX_SIZE], uv9[0], uv9[1], fl9, gc9, tmeta[:1], shape1, False,
              "clamp", "linear")
    lgu = txb.texture_bwd(*lbargs)[0]
    gs_bwd_diff = float((library_bwd([False, True])[1][..., 0].reshape(N) * 2.0 - lgu).abs().max())
    lin_bwd_ms = cuda_ms(torch, lambda: txb.texture_bwd(*lbargs), 50)
    texbwd_lib_ms = cuda_ms(torch, lambda: library_bwd([False, True]), 50)
    log(f"[9] texture_bwd {RES}^2: equal to its twin bit for bit; max|gu| "
        f"{float(gu9.abs().max()):.3g}, max|gfl| {float(gfl9.abs().max()):.3g}; kernel "
        f"{texbwd_ms:.3f} ms, twin {texbwd_plain_ms:.3f} ms; linear+clamp: kernel "
        f"{lin_bwd_ms:.3f} ms, grid_sample backward to the grid {texbwd_lib_ms:.3f} ms "
        f"(max|du diff| {gs_bwd_diff:.3g}) ({card})")

    n_tex9 = flat9.shape[0]
    gargs9 = (uv9[0], uv9[1], fl9, gc9, tmeta, n_tex9, shape1, False, BOUNDARY, FILTER)
    gtex9 = txb.texture_grad(*gargs9)
    gtex9b = txb.texture_grad(*gargs9)
    gtex_ref = txb.texture_grad_plain(*gargs9)
    torch.cuda.synchronize()
    if not torch.equal(gtex9, gtex9b):
        raise AssertionError("texture_grad kernel not repeatable")
    ulp = torch.from_numpy(np.spacing(gtex_ref.abs().cpu().numpy())).to(dev)
    if not bool(((gtex9 - gtex_ref).abs() <= ulp).all()):
        raise AssertionError("texture_grad kernel beyond 1 ulp of its twin")
    texgrad_err = float((gtex9 - gtex_ref).abs().max())
    ent9 = txb.grad_entries(uv9[0], uv9[1], fl9, tmeta, n_tex9, shape1, False, BOUNDARY, FILTER)
    n_taps = int(ent9[0].shape[0])
    hot = int((ent9[1][1:] - ent9[1][:-1]).max())
    log(f"[9] texture_grad {RES}^2 ({n_tex9} texels): within 1 ulp of its twin (max|err| "
        f"{texgrad_err:.3g}), bitwise repeatable; {n_taps} taps in {ent9[3]} pieces, the "
        f"busiest texel {hot} taps")
    texgrad_ms = cuda_ms(torch, lambda: txb.grad_from_entries(
        *ent9, uv9[0], uv9[1], fl9, gc9, tmeta, shape1, False, BOUNDARY, FILTER), 20)
    texgrad_glue_ms = cuda_ms(torch, lambda: txb.grad_entries(
        uv9[0], uv9[1], fl9, tmeta, n_tex9, shape1, False, BOUNDARY, FILTER), 10)
    texgrad_plain_ms = cuda_ms(torch, lambda: txb.texture_grad_plain(*gargs9), 3)
    lgargs = (uv9[0], uv9[1], fl9, gc9, tmeta[:1], TEX_SIZE * TEX_SIZE, shape1, False,
              "clamp", "linear")
    lin_grad_ms = cuda_ms(torch, lambda: txb.texture_grad(*lgargs), 10)
    texgrad_lib_ms = cuda_ms(torch, lambda: library_bwd([True, False]), 20)
    log(f"[9] texture_grad {RES}^2: kernel {texgrad_ms:.3f} ms + index glue (keys, sort) "
        f"{texgrad_glue_ms:.3f} ms, twin {texgrad_plain_ms:.3f} ms; linear+clamp: kernel with "
        f"glue {lin_grad_ms:.3f} ms, grid_sample backward to the input {texgrad_lib_ms:.3f} ms "
        f"({card})")

    gda9 = tx.mip_level_vjp(da9, gfl9, TEX_SIZE, TEX_SIZE, len(tmeta))
    iargs9 = (pl._attr_table(tuv, tu, 1, T), vtbl9, idf9, gu9, gv9, gda9, torch.stack(db9),
              res, T)
    out15 = ptb.interp_raster_bwd_tex(*iargs9)
    b14_err = equal_or_raise((out15,), (ptb.interp_raster_bwd_tex_plain(*iargs9),),
                             "interp_raster_bwd_tex")
    n_valid9 = int((idf9 > 0).sum())
    b14_ms = cuda_ms(torch, lambda: ptb.interp_raster_bwd_tex(*iargs9), 50)
    b14_plain_ms = cuda_ms(torch, lambda: ptb.interp_raster_bwd_tex_plain(*iargs9), 5)
    log(f"[9] interp_raster_bwd_tex {RES}^2: equal to its twin bit for bit; "
        f"{n_valid9} covered pixels, max|pos col| {float(out15[2:11].abs().max()):.3g}; "
        f"kernel {b14_ms:.3f} ms, twin {b14_plain_ms:.3f} ms ({card})")

    R9 = vtbl9.shape[1] - 1
    sargs9 = (pl.own_rows(idf9, T, res), out15[:11], dd9, rid9, u9, v9, ax0, ax1, vtbl9, res)
    da4 = out15[11:]
    ks9 = pb.grad_scatter(*sargs9, da4=da4)
    ks9b = pb.grad_scatter(*sargs9, da4=da4)
    ts9 = pb.grad_scatter_plain(*sargs9, da4=da4)
    torch.cuda.synchronize()
    da4_err = 0.0
    for x, y, z in zip(ks9, ks9b, ts9):
        if not torch.equal(x, y):
            raise AssertionError("grad_scatter (da4) kernel not repeatable")
        rows_close(x, z, SCATTER_ROW_RTOL)
        da4_err = max(da4_err, float((x - z).abs().max()))
    codes9, off9 = pb._entries(sargs9[0], out15[:11], dd9, rid9, R9, da4)
    flats9 = (u9, v9, ax0, ax1)
    n_own9 = int((codes9 < N).sum())
    n_aa9 = codes9.shape[0] - n_own9
    da4_ms = cuda_ms(torch, lambda: pb.scatter_entries(codes9, off9, out15[:11], dd9, flats9,
                                                       vtbl9, res, da4), 50)
    da4_plain_ms = cuda_ms(torch, lambda: pb.grad_scatter_plain(*sargs9, da4=da4), 3)
    (orow, own), (arow, aav) = pb.expand_rows(*sargs9, da4=da4)
    orow, arow = orow.long(), arow.long()
    zgt = torch.zeros((R9, own.shape[1]), dtype=torch.float32, device=dev)
    zgaa = torch.zeros((R9, 9), dtype=torch.float32, device=dev)
    da4_lib_ms = cuda_ms(torch, lambda: (zgt.index_add_(0, orow, own),
                                         zgaa.index_add_(0, arow, aav)), 50)
    log(f"[9] grad_scatter with da4 {RES}^2: {n_own9} own-pixel and {n_aa9} AA entries; "
        f"max|err| vs twin {da4_err:.3g} (bar {SCATTER_ROW_RTOL} x row max); kernel "
        f"{da4_ms:.3f} ms, twin {da4_plain_ms:.3f} ms, index_add_ {da4_lib_ms:.3f} ms ({card})")

    # -- 10. the textured training slice: fwd + bwd at 2048^2 -----------------
    tbwd_kernels = (txb.BWD_KERNEL, txb.GRAD_KERNEL, ptb.KERNEL, pb.SCATTER_KERNEL)

    def tgrads(view, size=res, uvs_=tuv, tex=ttex, boost=1.0):
        xs = [x.detach().clone().requires_grad_() for x in (view, uvs_, tex)]
        img = ptx.render_pipeline_textured(xs[0], t8.to(view.device), xs[1], xs[2], size,
                                           uv_tri=c8.to(view.device),
                                           filter_mode=FILTER, boundary_mode=BOUNDARY,
                                           pos_gradient_boost=boost)
        # Per-image mean, summed over the batch (= mean(img**2) at B = 1).
        return torch.autograd.grad((img ** 2).mean(dim=(1, 2, 3)).sum(), xs)

    for k in tkernels + tbwd_kernels:
        k.launches = 0
    tg = [tgrads(view) for view in reqs]
    ttrain_launches = {k.name: k.launches for k in tkernels + tbwd_kernels}
    log(f"[10] launches during the textured training slice (8 views): {ttrain_launches}")
    if min(ttrain_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the textured path never launched: {ttrain_launches}")
    tagain = tgrads(reqs[0])
    tg2 = tgrads(pos2)
    torch.cuda.synchronize()
    for i, gs_ in enumerate(tg):
        for name, g in zip(("pos", "uv", "tex"), gs_):
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"textured view {i}: {name} gradient not finite or zero")
    for x, y in zip(tg[0], tagain):
        if not torch.equal(x, y):
            raise AssertionError("textured gradients not bitwise repeatable")
    for b in range(2):
        if not torch.equal(tg2[0][b], tg[b][0][0]):
            raise AssertionError(f"textured B=2 g_pos of image {b} differs from its B=1 run")
    log(f"[10] textured gradients finite, non-zero, bitwise repeatable (g_tex included); "
        f"B=2 g_pos equal to two B=1 runs bit for bit; max|g_pos| "
        f"{float(tg[0][0].abs().max()):.3g}, max|g_uv| {float(tg[0][1].abs().max()):.3g}, "
        f"max|g_tex| {float(tg[0][2].abs().max()):.3g}")

    # The card's gradients against the CPU path, at the CPU tests' bars.
    gpu_g = [g.cpu() for g in tgrads(reqs[3], small, boost=2.0)]
    cpu_g = tgrads(reqs[3].cpu(), small, tuv.cpu(), ttex.cpu(), boost=2.0)
    for name, x, y in zip(("pos", "uv", "tex"), gpu_g, cpu_g):
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        xr, yr = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        row_err = float(((xr - yr).abs() / yr.abs().amax(1, keepdim=True).clamp(
            min=1e-30)).max())
        if not (scale > 0 and err <= TEX_GRAD_RTOL * scale and row_err <= TEX_ROW_RTOL):
            raise AssertionError(f"{SMALL}^2 textured {name} gradient, GPU vs CPU: {err} of "
                                 f"{scale}, row {row_err}")
        log(f"[10] {SMALL}^2 textured {name} gradient, GPU vs CPU path: max|err| {err:.3g} "
            f"(max|g| {scale:.3g}, bar {TEX_GRAD_RTOL} x max|g|), worst row {row_err:.3g} "
            f"of its max (bar {TEX_ROW_RTOL})")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tgrads(reqs[1])
    torch.cuda.synchronize()
    tex_step_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    tex_step_ms = window_ms(torch, tgrads, [(view,) for view in reqs])
    tex_step_mpix = RES * RES / 1e6 / (tex_step_ms / 1e3)
    log(f"[10] render_pipeline_textured fwd+bwd {RES}^2 (kernels): {tex_step_ms:.3f} ms/step, "
        f"{tex_step_mpix:.2f} Mpix/s; peak memory of a step above its inputs "
        f"{tex_step_mib:.1f} MiB ({card})")

    # A few Adam steps: the texture and a pose offset fit a target render.
    with torch.no_grad():
        ttarget = ptx.render_pipeline_textured(clip(zero), t8, tuv, ttex, res, uv_tri=c8,
                                               filter_mode=FILTER, boundary_mode=BOUNDARY)
    tex_fit = (ttex + 0.2 * torch.randn(ttex.shape, generator=gen).to(dev)).requires_grad_()
    offset = (0.05 * torch.randn(3, generator=gen).to(dev)).requires_grad_()
    opt = torch.optim.Adam([tex_fit, offset], lr=0.02)
    tlosses = []
    for k in tkernels + tbwd_kernels:
        k.launches = 0
    for _ in range(ADAM_STEPS):
        img = ptx.render_pipeline_textured(clip(offset), t8, tuv, tex_fit, res, uv_tri=c8,
                                           filter_mode=FILTER, boundary_mode=BOUNDARY)
        loss = ((img - ttarget) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        tlosses.append(loss.item())
    torch.cuda.synchronize()
    tfit_launches = {k.name: k.launches for k in tkernels + tbwd_kernels}
    log(f"[10] textured Adam fit, {ADAM_STEPS} steps at {RES}^2: loss {tlosses}; launches "
        f"{tfit_launches}")
    if not tlosses[-1] < tlosses[0]:
        raise AssertionError(f"textured Adam fit: the loss did not fall: {tlosses}")
    if min(tfit_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the textured path never launched: {tfit_launches}")

    # -- 11. the standalone ops' backward kernels vs twins (2048^2) -----------
    # Real inputs: the composed ops' forward on the bench scene, dy of
    # mean(img**2), and each stage's cotangent from the stage after it.
    p, t, a, c = inputs_from_numpy(*sphere_scene(cameras(1, seed=0)), device=dev)
    shape1 = (1, RES, RES)
    routs = rc.rasterize_fused(p, t, res, emit_db=True)
    u11, v11, zw11, idf11 = (x.reshape(N) for x in routs[:4])
    atbl11 = pl._attr_table(a, c, 1, T)
    ct11, _ = ic.interp_forward(atbl11, u11, v11, idf11, None, ())
    ftable11, vtbl11, _, _ = _build_tables(p, t, build_opposite_table(t), RES, RES)
    aimg, res11 = ac.aa_forward(ct11, idf11, zw11, ftable11, shape1, T)
    aimg = aimg.requires_grad_()
    dy11 = torch.autograd.grad((aimg ** 2).mean(), aimg)[0].contiguous()

    aargs = (dy11, ct11, idf11, vtbl11, res11, shape1, T)
    gcol11, rid2_11, gval2_11 = ac.aa_backward(*aargs)
    aabwd_err = equal_or_raise((gcol11, rid2_11, gval2_11), ac.aa_backward_plain(*aargs),
                               "aa_bwd")
    n_kept = int((gval2_11 != 0).any(0).sum())
    aabwd_ms = cuda_ms(torch, lambda: ac.aa_backward(*aargs), 50)
    aabwd_plain_ms = cuda_ms(torch, lambda: ac.aa_backward_plain(*aargs), 5)
    log(f"[11] aa_bwd {RES}^2: equal to its twin bit for bit; {n_kept} pairs kept with a "
        f"position gradient; kernel {aabwd_ms:.3f} ms, twin {aabwd_plain_ms:.3f} ms ({card})")

    iargs11 = (atbl11, u11, v11, idf11, None, gcol11, None, (), T, 0)
    grast11, gval11, _ = ic.interp_backward(*iargs11)
    ibwd_err = equal_or_raise(ic.interp_backward(*iargs11)[:2],
                              ic.interp_backward_plain(*iargs11)[:2], "interp_bwd")
    ibwd_ms = cuda_ms(torch, lambda: ic.interp_backward(*iargs11), 50)
    ibwd_plain_ms = cuda_ms(torch, lambda: ic.interp_backward_plain(*iargs11), 5)
    log(f"[11] interp_bwd {RES}^2 (A = {A}, no derivatives): equal to its twin bit for "
        f"bit; kernel {ibwd_ms:.3f} ms, twin {ibwd_plain_ms:.3f} ms ({card})")

    R11 = vtbl11.shape[1] - 1  # = T at B = 1
    rid11 = ra.pixel_rows(idf11, T, RES * RES, T)
    take = gather.table_take(vtbl11, rid11)
    take_err = equal_or_raise((take,), (gather.table_take_plain(vtbl11, rid11),), "table_take")
    rid11l = rid11.long()
    take_ms = cuda_ms(torch, lambda: gather.table_take(vtbl11, rid11), 50)
    take_plain_ms = cuda_ms(torch, lambda: gather.table_take_plain(vtbl11, rid11), 5)
    take_lib_ms = cuda_ms(torch, lambda: torch.index_select(vtbl11, 1, rid11l), 50)
    log(f"[11] table_take {RES}^2 (K = 9): equal to its twin bit for bit; kernel "
        f"{take_ms:.3f} ms, twin {take_plain_ms:.3f} ms, index_select {take_lib_ms:.3f} ms "
        f"({card})")

    # B10 on the rasterize backward's rows (its main use), then a hot row.
    g9, rid9 = ra.raster_grad_rows(vtbl11, idf11, grast11[0], grast11[1], None, res, T)

    def ulp_check(got, ref, what):
        ulp = torch.from_numpy(np.spacing(ref.abs().cpu().numpy())).to(dev)
        if not bool(((got - ref).abs() <= ulp).all()):
            raise AssertionError(f"{what}: beyond 1 ulp of its float64 twin")
        return float((got - ref).abs().max())

    srows = scatter.scatter_add_by_id(rid9, g9, R11)
    if not torch.equal(srows, scatter.scatter_add_by_id(rid9, g9, R11)):
        raise AssertionError("scatter_rows not bitwise repeatable")
    scatter_rows_err = ulp_check(srows, scatter.scatter_add_by_id_plain(rid9, g9, R11),
                                 "scatter_rows")
    ent11 = scatter.entries(rid9, g9, R11)
    n_live = int(ent11[0].shape[0])
    # Every other covered pixel on row 0: one triangle with ~0.9 M entries.
    even = torch.arange(N, device=dev) % 2 == 0
    hot_ids = torch.where((rid9 < R11) & even, 0, rid9).to(torch.int32)
    hot = scatter.scatter_add_by_id(hot_ids, g9, R11)
    if not torch.equal(hot, scatter.scatter_add_by_id(hot_ids, g9, R11)):
        raise AssertionError("scatter_rows (hot row) not bitwise repeatable")
    hot_err = ulp_check(hot, scatter.scatter_add_by_id_plain(hot_ids, g9, R11),
                        "scatter_rows (hot row)")
    hot_n = int(scatter.entries(hot_ids, g9, R11)[1][1])
    srows_ms = cuda_ms(torch, lambda: scatter.scatter_entries(*ent11, g9), 50)
    sglue_ms = cuda_ms(torch, lambda: scatter.entries(rid9, g9, R11), 20)
    srows_plain_ms = cuda_ms(torch, lambda: scatter.scatter_add_by_id_plain(rid9, g9, R11), 5)
    live9 = rid9 < R11
    lrow, lval = rid9[live9].long(), g9[:, live9].T.contiguous()
    zrows = torch.zeros((R11, 9), dtype=torch.float32, device=dev)
    srows_lib_ms = cuda_ms(torch, lambda: zrows.index_add_(0, lrow, lval), 50)
    log(f"[11] scatter_rows {RES}^2 (rasterize backward rows, K = 9): {n_live} live "
        f"entries over {R11} rows, within 1 ulp of its float64 twin (max|err| "
        f"{scatter_rows_err:.3g}), bitwise repeatable; hot row of {hot_n} entries within "
        f"1 ulp (max|err| {hot_err:.3g}); kernel {srows_ms:.3f} ms + index glue "
        f"{sglue_ms:.3f} ms, twin {srows_plain_ms:.3f} ms, index_add_ {srows_lib_ms:.3f} ms "
        f"({card})")

    # -- 12. the composed ops' training step: fwd + bwd at 2048^2 -------------
    op_kernels = (rc.DB_KERNEL, ic.KERNEL, ac.KERNEL, ic.BWD_KERNEL, ac.BWD_KERNEL,
                  gather.KERNEL, scatter.KERNEL)

    def ops_grads(view, colour, size):
        pv = view.detach().clone().requires_grad_()
        cv = colour.detach().clone().requires_grad_()
        rast, _ = dr.rasterize(None, pv, t8, size, grad_db=False)
        col_img, _ = dr.interpolate(cv, rast, c8)
        img = dr.antialias(col_img, rast, pv, t8)
        loss = (img ** 2).mean(dim=(1, 2, 3)).sum()
        return (img.detach(),) + torch.autograd.grad(loss, (pv, cv))

    for k in op_kernels:
        k.launches = 0
    og = [ops_grads(view, a8, res) for view in reqs]
    torch.cuda.synchronize()
    ops_launches = {k.name: k.launches for k in op_kernels}
    log(f"[12] launches during the composed ops' training slice (8 views): {ops_launches}")
    if min(ops_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the ops' path never launched: {ops_launches}")
    oagain = ops_grads(reqs[0], a8, res)
    og2 = ops_grads(pos2, a8.expand(2, -1, -1).contiguous(), res)
    for i, (_, gp, gc_) in enumerate(og):
        for name, g in (("pos", gp), ("col", gc_)):
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"ops view {i}: {name} gradient not finite or all zero")
    for x, y in zip(og[0], oagain):
        if not torch.equal(x, y):
            raise AssertionError("ops gradients not bitwise repeatable")
    for b in range(2):
        if not (torch.equal(og2[1][b], og[b][1][0]) and torch.equal(og2[2][b], og[b][2])):
            raise AssertionError(f"ops B=2 gradients of image {b} differ from its B=1 run")
    fused = grads(reqs[0], a8, res)
    with torch.no_grad():
        fimg = pl.render_pipeline(reqs[0], t8, a8, res, attr_idx=c8)
    ops_vs_fused = [float((og[0][0] - fimg).abs().max())]
    for x, y in zip(og[0][1:], fused):
        ops_vs_fused.append(float((x - y).abs().max()) / float(y.abs().max()))
    if not (ops_vs_fused[0] <= SHADE_ATOL and max(ops_vs_fused[1:]) <= GRAD_CPU_RTOL):
        raise AssertionError(f"ops vs render_pipeline: {ops_vs_fused}")
    log(f"[12] ops gradients finite, non-zero, bitwise repeatable; B=2 equal to two B=1 "
        f"runs bit for bit; against render_pipeline on the same view: image max|err| "
        f"{ops_vs_fused[0]:.3g}, g_pos and g_col max|err| {ops_vs_fused[1]:.3g} and "
        f"{ops_vs_fused[2]:.3g} of their largest (bars {SHADE_ATOL}, {GRAD_CPU_RTOL})")
    gpu_g = [g.cpu() for g in ops_grads(reqs[3], a8, small)[1:]]
    cpu_g = ops_grads(reqs[3].cpu(), a8.cpu(), small)[1:]
    for name, x, y in zip(("pos", "col"), gpu_g, cpu_g):
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        if not (scale > 0 and err <= GRAD_CPU_RTOL * scale):
            raise AssertionError(f"{SMALL}^2 ops {name} gradient, GPU vs CPU: {err} of {scale}")
        log(f"[12] {SMALL}^2 ops {name} gradient, GPU vs CPU path: max|err| {err:.3g} "
            f"(max|g| {scale:.3g}, bar {GRAD_CPU_RTOL} x max|g|)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for k in op_kernels:
        k.launches = 0
    ops_grads(reqs[1], a8, res)
    torch.cuda.synchronize()
    ops_step_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    per_step = {k.name: k.launches for k in op_kernels}
    ops_step_ms = window_ms(torch, lambda view: ops_grads(view, a8, res), [(v,) for v in reqs])
    log(f"[12] composed ops fwd+bwd {RES}^2 (kernels): {ops_step_ms:.3f} ms/step, "
        f"{RES * RES / 1e3 / ops_step_ms:.2f} Mpix/s; peak memory of a step above its "
        f"inputs {ops_step_mib:.1f} MiB; launches per step {per_step} ({card})")

    # The same for render_pipeline_textured(filter_mode='linear').
    lin_kernels = (rc.KERNEL, ic.KERNEL, tc.KERNEL, ac.KERNEL, ac.BWD_KERNEL, txb.BWD_KERNEL,
                   txb.GRAD_KERNEL, ic.BWD_KERNEL, gather.KERNEL, scatter.KERNEL)

    def lgrads(view, size=res, uvs_=tuv, tex=ttex):
        xs = [x.detach().clone().requires_grad_() for x in (view, uvs_, tex)]
        img = ptx.render_pipeline_textured(xs[0], t8.to(view.device), xs[1], xs[2], size,
                                           uv_tri=c8.to(view.device), filter_mode="linear",
                                           boundary_mode=BOUNDARY)
        return torch.autograd.grad((img ** 2).mean(dim=(1, 2, 3)).sum(), xs)

    for k in lin_kernels:
        k.launches = 0
    lg = [lgrads(view) for view in reqs]
    torch.cuda.synchronize()
    lin_launches = {k.name: k.launches for k in lin_kernels}
    log(f"[12] launches during the linear textured training slice (8 views): {lin_launches}")
    if min(lin_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the linear path never launched: {lin_launches}")
    lagain = lgrads(reqs[0])
    for i, gs_ in enumerate(lg):
        for name, g in zip(("pos", "uv", "tex"), gs_):
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"linear view {i}: {name} gradient not finite or zero")
    for x, y in zip(lg[0], lagain):
        if not torch.equal(x, y):
            raise AssertionError("linear textured gradients not bitwise repeatable")
    gpu_g = [g.cpu() for g in lgrads(reqs[3], small)]
    cpu_g = lgrads(reqs[3].cpu(), small, tuv.cpu(), ttex.cpu())
    for name, x, y in zip(("pos", "uv", "tex"), gpu_g, cpu_g):
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        if not (scale > 0 and err <= TEX_GRAD_RTOL * scale):
            raise AssertionError(f"{SMALL}^2 linear {name} gradient, GPU vs CPU: {err} of "
                                 f"{scale}")
        log(f"[12] {SMALL}^2 linear textured {name} gradient, GPU vs CPU path: max|err| "
            f"{err:.3g} (max|g| {scale:.3g}, bar {TEX_GRAD_RTOL} x max|g|)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    lgrads(reqs[1])
    torch.cuda.synchronize()
    lin_step_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    lin_step_ms = window_ms(torch, lgrads, [(view,) for view in reqs])
    log(f"[12] render_pipeline_textured(linear) fwd+bwd {RES}^2 (kernels): "
        f"{lin_step_ms:.3f} ms/step, {RES * RES / 1e3 / lin_step_ms:.2f} Mpix/s; peak "
        f"memory of a step above its inputs {lin_step_mib:.1f} MiB ({card})")

    # -- 13. the fitting models on the card -----------------------------------
    from nvdiffrast_tpu_torch.models.fit_cube import CubeFitModel
    from nvdiffrast_tpu_torch.models.fit_pose import PoseFitModel

    for k in op_kernels:
        k.launches = 0
    cube = CubeFitModel(resolution=16, seed=0, device=dev)
    e0 = cube.geometric_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CUBE_STEPS):
        cube.step()
    torch.cuda.synchronize()
    cube_ms = (time.perf_counter() - t0) / CUBE_STEPS * 1e3
    cube_err = cube.geometric_error()
    cube_launches = {k.name: k.launches for k in op_kernels}
    log(f"[13] CubeFitModel(16): geometric error {e0:.4f} -> {cube_err:.4f} after "
        f"{CUBE_STEPS} steps (bar {CUBE_BAR}), {cube_ms:.3f} ms/step; launches "
        f"{cube_launches} ({card})")
    if not cube_err < CUBE_BAR or min(cube_launches.values()) <= 0:
        raise AssertionError(f"cube fit: error {cube_err}, launches {cube_launches}")
    pose = PoseFitModel(resolution=64, seed=0, device=dev)
    a0 = pose.angle_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    angle = pose.fit(POSE_ITERS)
    torch.cuda.synchronize()
    pose_ms = (time.perf_counter() - t0) / POSE_ITERS * 1e3
    log(f"[13] PoseFitModel(64): angle {a0:.3f} -> {angle:.4f} deg after {POSE_ITERS} "
        f"iterations (bar {POSE_BAR}), {pose_ms:.3f} ms/iteration ({card})")
    if not angle < POSE_BAR:
        raise AssertionError(f"pose fit: {angle} deg")

    # Bounds: bytes each input read once and each output written once, over
    # 3.35 TB/s; float32 operations counted from the kernels' sources, over
    # 67 TFLOP/s. The larger is the bound.
    f32 = 4
    # Fragments: pixels of each triangle's screen AABB inside the image.
    span_x = aabb[..., 2].clamp(max=RES - 1) - aabb[..., 0].clamp(min=0) + 1
    span_y = aabb[..., 3].clamp(max=RES - 1) - aabb[..., 1].clamp(min=0) + 1
    frag = float((span_x.clamp(min=0) * span_y.clamp(min=0)).sum())
    raster_bound = bound(rec.numel() * f32 + aabb.numel() * f32 + 4 * N * f32, 34 * frag)
    shade_bound = bound((atbl.numel() + ftable.numel() + 4 * N + (4 * A + 4) * N) * f32,
                        (120 + 21 * A) * N)
    bwd_bound = bound((atbl_s.numel() + vtbl.numel() + (5 + 2 * A) * N + (A + 13) * N) * f32,
                      (80 + 20 * A) * N)
    scatter_bound = bound((n_own * (A + 9 + 3) + n_aa * 3 + 9 * (R + 1) + (R + 1)
                           + R * (3 * A + 18)) * f32,
                          n_own * (6 * A + 11) + n_aa * 60)
    # Textured forward (bench textured scene, one frame): the db variant
    # writes 8 images; interpolate reads 7 flats and the uv table, writes
    # uv and 4 derivatives; the sampler reads u, v, flevel and the
    # pyramid once and writes C channels, ~(30 + 8C) operations per level
    # read; antialias reads colour, id and depth and the AA table, writes
    # out, negx, negy and 4 residuals, ~80 operations per active pair.
    db_bound = bound(trec.numel() * f32 + taabb.numel() * f32 + 8 * N * f32, 34 * frag)
    interp_bound = bound((utbl.numel() + 7 * N + 6 * N) * f32, 30 * N)
    tex_bound = bound((3 * N + n_texels * C + C * N) * f32, (N + n_two) * (30 + 8 * C))
    aa_bound = bound((ftable_t.numel() + (C + 2) * N + (3 * C + 4) * N) * f32,
                     20 * N + 80 * n_active)
    # Textured backward: texture_bwd reads u, v, flevel, C cotangents and
    # the pyramid, writes 3 rows, both slots for every pixel, ~(40 + 14C)
    # operations each; texture_grad reads the same pixel streams and
    # writes the pyramid's gradient, ~(30 + 3C) operations a tap kept;
    # interp_raster_bwd_tex reads the id of every pixel, 10 more rows of
    # each covered one and the tables, writes 15 rows, ~220 operations a
    # covered pixel; grad_scatter with da4 as phase 5's, with 4 more floats
    # an own-pixel entry.
    texbwd_bound = bound(((3 + C + 3) * N + n_tex9 * C) * f32, 2 * N * (40 + 14 * C))
    texgrad_bound = bound(((3 + C) * N + n_tex9 * C) * f32, n_taps * (30 + 3 * C))
    b14_bound = bound((iargs9[0].numel() + vtbl9.numel() + 16 * N + 10 * n_valid9) * f32,
                      220 * n_valid9)
    da4_bound = bound((n_own9 * (2 + 9 + 3 + 4) + n_aa9 * 3 + 9 * (R9 + 1) + (R9 + 1)
                       + R9 * (6 + 18)) * f32, n_own9 * (6 * 2 + 11 + 8) + n_aa9 * 60)

    # Standalone ops' backward: aa_bwd reads dy, colour (own and
    # neighbours'), id and 4 residuals, writes g_color, 2 rows and the dense
    # 18 pair columns, ~20 operations a pixel and ~60 a kept pair;
    # interp_bwd reads u, v, id, A cotangents and the table, writes 2 + 3A
    # rows, ~10A operations a pixel; table_take reads the ids and the table,
    # writes 9 rows; scatter_rows reads each live entry's code and 9 values
    # and the segment tables, writes [R, 9], 9 float64 adds an entry.
    aabwd_bound = bound((vtbl11.numel() + (2 * A + 5) * N + (A + 20) * N) * f32,
                        20 * N + 60 * n_kept)
    ibwd_bound = bound((atbl11.numel() + (3 + A) * N + (2 + 3 * A) * N) * f32, 10 * A * N)
    take_bound = bound((vtbl11.numel() + N + 9 * N) * f32, 0)
    srows_bound = bound((n_live * 10 + 2 * (R11 + 1) + R11 * 9) * f32, 9 * n_live)

    def entry(name, route, source, replaces, launches, err, ms, plain_ms, bnd, lib):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}

    kernels = [
        entry("rasterize", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039", fit_launches[rc.KERNEL.name],
              raster_err, raster_ms, raster_plain_ms, raster_bound, None),
        entry("shade_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/shade_fwd.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:74", fit_launches[pc.KERNEL.name],
              shade_err, shade_ms, shade_plain_ms, shade_bound, None),
        entry("pipeline_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/pipeline_bwd.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:254", fit_launches[pb.BWD_KERNEL.name],
              bwd_err, bwd_ms, bwd_plain_ms, bwd_bound, None),
        entry("grad_scatter", "cuda", "nvdiffrast_tpu_torch/csrc/grad_scatter.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535", fit_launches[pb.SCATTER_KERNEL.name],
              scatter_err, scatter_ms, scatter_plain_ms, scatter_bound, scatter_lib_ms),
        entry("rasterize_db", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039", tex_launches[rc.DB_KERNEL.name],
              db_err, db_ms, db_plain_ms, db_bound, None),
        entry("interp_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/interpolate_fwd.cu",
              "nvdiffrast_tpu/ops/interpolate_pallas.py:84", tex_launches[ic.KERNEL.name],
              interp_err, interp_ms, interp_plain_ms, interp_bound, None),
        entry("texture_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_fwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", tex_launches[tc.KERNEL.name],
              tex_err, tex_ms, tex_plain_ms, tex_bound, tex_lib_ms),
        entry("aa_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/aa_fwd.cu",
              "nvdiffrast_tpu/ops/antialias_pallas.py:149", tex_launches[ac.KERNEL.name],
              aa_err, aa_ms, aa_plain_ms, aa_bound, None),
        entry("texture_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_bwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", ttrain_launches[txb.BWD_KERNEL.name],
              texbwd_err, texbwd_ms, texbwd_plain_ms, texbwd_bound, texbwd_lib_ms),
        entry("texture_grad", "cuda", "nvdiffrast_tpu_torch/csrc/texture_grad.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179", ttrain_launches[txb.GRAD_KERNEL.name],
              texgrad_err, texgrad_ms, texgrad_plain_ms, texgrad_bound, texgrad_lib_ms),
        entry("interp_raster_bwd_tex", "cuda",
              "nvdiffrast_tpu_torch/csrc/interp_raster_bwd_tex.cu",
              "nvdiffrast_tpu/ops/pipeline_tex_pallas.py:113", ttrain_launches[ptb.KERNEL.name],
              b14_err, b14_ms, b14_plain_ms, b14_bound, None),
        entry("grad_scatter_da4", "cuda", "nvdiffrast_tpu_torch/csrc/grad_scatter.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535",
              ttrain_launches[pb.SCATTER_KERNEL.name], da4_err, da4_ms, da4_plain_ms,
              da4_bound, da4_lib_ms),
        entry("interp_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/interpolate_bwd.cu",
              "nvdiffrast_tpu/ops/interpolate_pallas.py:163", ops_launches[ic.BWD_KERNEL.name],
              ibwd_err, ibwd_ms, ibwd_plain_ms, ibwd_bound, None),
        entry("aa_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/aa_bwd.cu",
              "nvdiffrast_tpu/ops/antialias_pallas.py:306", ops_launches[ac.BWD_KERNEL.name],
              aabwd_err, aabwd_ms, aabwd_plain_ms, aabwd_bound, None),
        entry("table_take", "cuda", "nvdiffrast_tpu_torch/csrc/table_take.cu",
              "nvdiffrast_tpu/ops/gather.py:33", ops_launches[gather.KERNEL.name],
              take_err, take_ms, take_plain_ms, take_bound, take_lib_ms),
        entry("scatter_rows", "cuda", "nvdiffrast_tpu_torch/csrc/scatter_rows.cu",
              "nvdiffrast_tpu/ops/scatter.py:84", ops_launches[scatter.KERNEL.name],
              scatter_rows_err, srows_ms, srows_plain_ms, srows_bound, srows_lib_ms),
    ]
    for k in kernels:
        log(f"[bound] {k['name']}: {k['bound_ms']:.4f} ms by {k['bound_by']}; kernel "
            f"{k['ms']:.4f} ms ({k['bound_ms'] / k['ms'] * 100:.1f} % of the bound)")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
