#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (nvdiffrast_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's kernels from nvdiffrast_tpu_torch/csrc, then:
  1. device: prints the card (nvidia-smi name and power limit) and the
     build time;
  2. the record setup kernel against build_records bit for bit (records,
     AABBs, tile counts, chunk boxes) and the rasterizer kernel against
     its plain PyTorch twin on the card (uv-sphere at 256^2 and 512^2,
     B = 1 and 2; random adversarial scene at 67x130, B = 2; bench scene
     at 2048^2 bit for bit), held to the z-fight parity bar; the setup,
     the sweep and the forward's times beside the earlier design's, and the forward's
     host syncs (none unbinned);
  3. shade_fwd kernel against its twin on the card, on the same
     rasterizer buffers at 2048^2, B = 1, within 1e-5 absolute;
  4. the slice: render_pipeline forward on the bench scene (uv-sphere
     32x64, 2048^2, A = 3): 8 requests with perturbed cameras and one
     B = 2 render, each finite, plausibly covered and bitwise
     repeatable, through the setup kernel (once a forward), the sweep
     and shade_fwd (launch counts), plus a small
     render held against the CPU path; then the forward's time per
     frame and Mpix/s, and the twins' at 512^2;
  5. the backward kernels against their twins on the card, at 2048^2 on
     the bench scene with dy from the forward's real loss mean(img**2):
     pipeline_bwd bit for bit, grad_scatter within 1e-6 of each row's
     largest entry, bitwise repeatable, at most one host sync, its stages
     timed (the tiles pass, scan, sync, compact, sort, segment starts,
     sums) with the second run's partials equal to the first run's
     scratch and the segment starts to searchsorted's; its per-tile
     partials bit for bit with tile_partials_plain at 256^2 (plain and
     da4); a quad of two triangles filling 2048^2 (the hot row), with and
     without da4; their times, and index_add_ over the expanded rows as
     the scatter's library yardstick;
  6. the training slice: gradients of mean(render_pipeline(...)**2) to
     pos and the vertex colours at 2048^2, finite, non-zero, bitwise
     repeatable, B = 2 equal to two B = 1 runs, at 256^2 within 1e-5 of
     the largest gradient of the CPU path; all four kernels launched;
     the fwd+bwd step's ms and Mpix/s; then 5 Adam steps fitting the
     colours and a pose offset to a target render, the loss falling;
  7. the textured forward's kernels against their twins on the card, at
     2048^2 on the bench textured scene (bench.py:90-119: a 512x512x3
     texture from rand seed 0, spherical uvs, linear-mipmap-linear,
     wrap): the setup kernel, the rasterizer's db variant, interpolate,
     the mip level, the texture sampler and antialias, each bit for bit,
     with their times; the sampler in linear, clamp, base level (the function
     F.grid_sample computes) against F.grid_sample;
  8. the textured slice: render_pipeline_textured on 8 perturbed views
     and one B = 2 render, finite, plausibly covered, bitwise repeatable,
     B = 2 equal to two B = 1 renders, through all four kernels (launch
     counts), a 256^2 render held against the CPU path; its ms/frame and
     Mpix/s;
  9. the textured backward's kernels against their twins at 2048^2 on
     the bench textured scene, with dy from mean(img**2): texture_bwd,
     the mip level's vjp and interp_raster_bwd_tex bit for bit (texture_bwd also in every filter
     x boundary instantiation at C = 1, 3, 4, one texture or one per
     image, at 256^2 and at an odd 131x67, B = 2, with NaN and far
     uvs; its times, and its yardstick's, also by device time after
     phase 16),
     texture_grad within 1 ulp,
     bitwise repeatable, its per-tile entries equal to their twin's and
     at most one host sync (also on zero / clamp / per-image cases at
     256^2), grad_scatter with da4 within 1e-6 of each row's largest
     entry and at most one host sync; their times (texture_grad and
     grad_scatter stage by stage beside the earlier designs'), and
     in linear, clamp, base level texture_bwd and texture_grad against
     grid_sample's backward (to the grid, to the input), index_add_ as
     the scatter's yardstick;
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
     on the rasterize backward's rows, with a hot row of every other
     covered pixel and on random ids, at most one host sync, its stages
     timed, its per-chunk partials bit for bit with chunk_partials_plain
     on 65,536 columns (rows and random ids); their times, index_select
     and index_add_ as yardsticks;
 12. the composed ops' training slice, rasterize -> interpolate ->
     antialias, gradients of mean(img**2) to pos and the colours on the 8
     views: finite, non-zero, bitwise repeatable, B = 2 equal to two B = 1
     runs, equal to render_pipeline's within the bars, at 256^2 within
     1e-5 of the CPU path; all seven kernels launched; ms/step, peak
     memory, launches per step; then render_pipeline_textured with
     filter_mode='linear', fwd + bwd, the same checks;
 13. CubeFitModel(16) for 150 steps (error < 0.08) and
     PoseFitModel(64).fit(300) (angle < 2 degrees) on the card, their
     ms per step;
 14. B12, the cube sampler and the cube texture gradient, against their
     twins at 2048^2 on the bench sphere's 8 views, reflection vectors
     (interpolate with diff_attrs='all') as directions into
     procedural_cubemap(512), 10 levels, linear-mipmap-linear: cube_fwd
     and cube_bwd's (gs, gt, gfl) (16x16 tiles) bit for bit, the tiles
     pass's (texel, tile) partials bit for bit with
     cube_tile_partials_plain, the gradient within 1 ulp of the float64
     sums of the taps (+0 where they are), bitwise repeatable, one host
     sync; the joint pass texture() runs ((gs, gt, gfl) and the
     partials in one run) bit for bit with cube_bwd_plain and with the
     texture-only run, its stages timed, beside the earlier design (the
     taps' glue and B10) on the same inputs (no PyTorch call samples
     cube maps); then
     texture(boundary_mode='cube') fwd + bwd on the 8 views: all five
     kernels launched and scatter_rows never, bitwise repeatable,
     ms/step, peak memory, a 256^2 view within the CPU bars of the CPU
     path;
 15. the repaired calls (antialias at 17 channels, render_pipeline at 9,
     render_pipeline_textured with per-image uvs, 9 channels, 'nearest'
     and a cube map) at 64^2, B = 2: finite, bitwise repeatable, within
     the CPU bars of the CPU path; the 2-D texture op fwd + bwd at 2048^2;
     EnvPhongFitModel at the sample's defaults (300 steps: env RMSE and
     loss fall) and at the test size (150 steps, RMSE < 0.03);
     EarthFitModel at the sample's defaults (200 steps: PSNR rises) and
     at the test size (50 steps, PSNR > 10 dB); ms per step;
 16. the rest of the rasterizer at 2048^2, the setup kernel against
     build_records bit for bit on each scene: DepthPeeler on four
     concentric bench spheres (15,872 triangles, B = 2, 4 layers;
     fwd + bwd through interpolate and antialias finite and bitwise
     repeatable, each layer's kernel bit for bit with its twin, layer 0
     with plain rasterize, depth strictly growing); range mode (the
     spheres as one 2-D pos, B = 8, image b drawing sphere b mod 4: the
     kernel bit for bit with its twin and with the instance render of
     each window, the composed fwd + bwd repeatable, 256^2 within 1e-5
     of the CPU path); the bench render as four 512-row viewport bands
     (rast and rast_db bit for bit the full render's rows, antialias
     away from the folded band edges, band gradients within 1e-6 of the
     full render's restricted to the band); the bench scene binned
     against unbinned; uv_sphere(512, 1024) (1,046,528 triangles): the
     binned kernel bit for bit with the unbinned one and with its twin
     (also at uv_sphere(128, 320)), the forward split (setup, binning
     glue stage by stage, the kernel in longest-list-first and in grid
     order) beside the earlier design's, one host sync, render_pipeline fwd + bwd
     ms/step and peak memory, and its grad_scatter call (tiles of more
     rows than the scratch) within 1e-6 of each row's largest, timed;
 17. parallel (nvdiffrast_tpu_torch.parallel): two ranks sharing the card
     over gloo (halos and gradient sums through host memory). The bench
     scene at 2048^2 split into two 1,024-row bands by make_sp_render,
     fwd + bwd of mean(img**2): each band's rast bit for bit with the
     single-process render's rows, the image and the gradients (each
     vertex row, of its largest) within 1e-5, the cross-band pairs firing,
     B9 and B10 launched by the boundary pass; one SGD step of
     shard_map_train_step on the bench textured scene, a view a rank, the
     texture and a position offset as parameters, within 1e-6 of each
     parameter's largest entry of the single-process B = 2 step; the
     ranks' launch counts over both steps; graft_entry.dryrun_multichip(2,
     "cuda"); ms a step, the boundary pass's ms, the halo bytes (two ranks
     on one card: not a scaling figure); B9 and B10 at the boundary's
     shapes against their twins, timed.
With ``--ranks N`` (a machine with N cards) it runs phase 17 alone, one
rank a card over nccl: the multi-card check of the collectives.
It prints one JSON line of per-kernel results (with each kernel's
bound: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s; grad_scatter, grad_scatter_da4,
scatter_rows and texture_cube_bwd also carry all_ms, the whole
reduction with its glue, and its bound) and, last, the device line. Any
failed check raises, so the exit code is not 0. Without a CUDA device,
or without the package beside it, it fails at once.
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
CUBE_SIZE = 512     # phase 14: procedural_cubemap(512), 10 levels
REPAIR_RES = 64     # phase 15: the C.1 / C.2 calls, GPU vs CPU
ENV_STEPS = 300     # EnvPhongFitModel at the sample's defaults
ENV_BAR = 0.03      # tests/test_models.py: env RMSE < 0.03 at the test size
EARTH_STEPS = 200   # EarthFitModel at the sample's defaults
EARTH_BAR = 10.0    # tests/test_models.py: PSNR > 10 dB at the test size
PEEL_SCALES = (1.0, 0.8, 0.6, 0.4)  # phase 16: four concentric bench spheres
PEEL_LAYERS = 4
RANGE_B = 8          # range-mode images, image b drawing sphere b mod 4
VP_BANDS = 4         # 512-row viewport bands of the 2048^2 bench render
VP_GRAD_RTOL = 1e-6  # band gradients vs the full render's restricted to the band
BIG_SPHERE = (512, 1024)  # 1,046,528 triangles (benchmarks/profile_bigmesh.py's largest)
MID_SPHERE = (128, 320)   # 81,280 triangles: the binned kernel against its twin
# Times of the earlier designs, printed beside this run's as "before": the
# rasterizer and the texture gradient (PERF.md section 6 at commit
# cbbd73c), the gradient scatters B4 and B10 (PERF.md section 6 at commit
# 54206d4; the quad, 1 M, hot-row, random-id and cube-tap calls from
# `profile_step --reductions` on that commit, whose cases are like these),
# the cube sampler and the cube texture gradient (PERF.md sections 5 and 6
# at commit 91a76fc: its kernels, and the taps' glue and B10 in
# `profile_step --cube`); NVIDIA H100 80GB HBM3 at 700 W.
BEFORE_MS = {"raster": "0.299", "raster_db": "0.324", "prepass": "5.0-7.4",
          "peel": "0.363", "range": "0.622 (binned)", "band": "0.095",
          "binned_1M": "2.446", "glue_1M": "0.419", "prepass_1M": "3.469-7.212",
          "bin_glue_bench": "0.22-0.44", "texgrad": "0.311 + 6.421 glue",
          "grad_scatter": "kernel 0.188 + entry sort 0.5-0.8",
          "grad_scatter_da4": "kernel 0.191 + entry sort 0.5-0.8",
          "grad_scatter_quad": "69.5-69.6 (one warp a triangle row)",
          "grad_scatter_quad_da4": "69.9-70.1 (one warp a triangle row)",
          "grad_scatter_1M": "1.91-1.96",
          "scatter_rows": "kernel 0.063 + index glue 0.52-0.60 (PERF.md section 5)",
          "scatter_rows_hot": "0.65-0.91", "scatter_rows_random": "0.79-0.81",
          "scatter_rows_cube": "3.89-3.93", "cube_fwd": "0.0785", "cube_bwd": "0.0885",
          "cube_grad": "20.7-20.9 + 3.7-3.9 device ms (profile_step --cube)"}
SP_RANKS = 2        # phase 17: two ranks sharing the card over gloo
SP_RTOL = 1e-5      # row bands vs the single process (tests/test_spatial.py's bar)
DP_LR = 1.0         # phase 17's SGD step: large enough that the update shows
DP_RTOL = 1e-6      # the dp step vs the single-process step, of each parameter's largest
DP_UPDATE_RTOL = 1e-5  # ... and its update, of the largest update
PARALLEL_STEPS = 10  # steps timed in each phase-17 rank
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


def bits_equal(x, y):
    """Bit for bit (NaN and signed zeros included)."""
    import torch

    return x.shape == y.shape and torch.equal(x.contiguous().view(torch.int32),
                                              y.contiguous().view(torch.int32))


def setup_equal_or_raise(rc, p, t, res, viewport, what):
    """The record setup kernel against build_records (and the tile counts
    and chunk boxes against their twins), bit for bit; returns the setup
    (rec, aabb, counts, boxes) and the max |err| of rec and aabb."""
    rec, aabb, counts, boxes = rc.setup_records(p, t, res, viewport)
    r2, a2 = rc.build_records(p, t, res, viewport)
    if not (bits_equal(rec, r2) and bits_equal(aabb, a2)
            and bits_equal(counts, rc.tile_counts_plain(a2, res))
            and bits_equal(boxes, rc.chunk_boxes_plain(a2))):
        raise AssertionError(f"{what}: setup kernel differs from build_records")
    log(f"[setup] {what}: setup kernel = build_records bit for bit ({rec.shape[0]} x "
        f"{rec.shape[1]} records, {int((r2[..., 15] < 1e29).sum())} valid)")
    err = max(float((rec - r2).abs().max()), float((aabb - a2).abs().max()))
    return (rec, aabb, counts, boxes), err


def texgrad_check(torch, np, txb, args, what):
    """texture_grad on the card: within 1 float32 ulp of its twin, bitwise
    repeatable, and its per-tile entries, merged by (texel, tile), equal to
    the plain twin's. Returns (max |err| of the gradient, entries, kept
    taps, max |err| of the merged entries, the same over the entries of
    tiles past the scratch's GRAD_CAP)."""
    got = txb.texture_grad(*args)
    again = txb.texture_grad(*args)
    ref = txb.texture_grad_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"texture_grad {what}: not bitwise repeatable")
    ulp = torch.from_numpy(np.spacing(ref.abs().cpu().numpy())).to(ref.device)
    if not bool(((got - ref).abs() <= ulp).all()):
        raise AssertionError(f"texture_grad {what}: beyond 1 ulp of its twin")
    texel, part, counts = txb.grad_tile_entries(*args)
    tt, tl, tp, tc = txb.tile_entries_plain(*args)
    n_tiles = counts.numel()
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=ref.device), counts.long())
    uk, inv = torch.unique(texel.long() * n_tiles + tile, return_inverse=True)
    merged = torch.zeros_like(tp).index_add_(0, inv, part)
    if not (torch.equal(uk, tt * n_tiles + tl)
            and bool(((merged - tp).abs() <= 1e-10 * tp.abs() + 1e-300).all())):
        raise AssertionError(f"texture_grad {what}: entries differ from the twin's")
    diff = (merged - tp).abs()
    over = (counts > txb.GRAD_CAP)[tl]
    ent_err = float(diff.max()) if diff.numel() else 0.0
    over_err = float(diff[over].max()) if bool(over.any()) else 0.0
    err = float((got - ref).abs().max())
    log(f"[9] texture_grad {what}: within 1 ulp of its twin (max|err| {err:.3g}), bitwise "
        f"repeatable; {texel.numel()} entries (the twin's {tt.numel()}) for {int(tc.sum())} "
        f"kept taps, {int((counts > txb.GRAD_CAP).sum())} tiles over {txb.GRAD_CAP}; the "
        f"busiest texel {int(torch.bincount(texel.long()).max())} entries; merged entries "
        f"within {ent_err:.3g} of the twin's ({over_err:.3g} in the tiles over the cap)")
    return err, texel.numel(), int(tc.sum()), ent_err, over_err


def texgrad_case(torch, np, tx, dev, boundary, filter_mode, D):
    """A 256^2, B = 2 texture-gradient case: a 64x64x3 texture (one, or one
    per image), uv over a disk and (0, 0) around it, flevels in [0, 2.5]."""
    rng = np.random.default_rng(9 + D)
    B, H, W = 2, SMALL, SMALL
    N = B * H * W
    tex = torch.from_numpy(rng.random((D, 64, 64, 3), dtype=np.float32)).to(dev)
    meta, n_tex = tx._static_meta([tex] + tx.build_mip_stack(tex))
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    disk = np.tile((xx ** 2 + yy ** 2 < 0.5).reshape(-1), B)
    u = np.where(disk, np.tile(xx.reshape(-1), B) * 0.7 + 0.5, 0.0).astype(np.float32)
    v = np.where(disk, np.tile(yy.reshape(-1), B) * 0.7 + 0.5, 0.0).astype(np.float32)
    fl = np.where(disk, rng.uniform(0, 2.5, N), 0.0).astype(np.float32)
    gc = rng.standard_normal((3, N)).astype(np.float32)
    ins = [torch.from_numpy(x).to(dev) for x in (u, v, fl, gc)]
    return (*ins, meta, n_tex, (B, H, W), D > 1, boundary, filter_mode)


def texbwd_instances(torch, np, tx, txb, dev):
    """texture_bwd against texture_bwd_plain bit for bit in every filter x
    boundary instantiation at C in (1, 3, 4), one texture and one per
    image (D = B = 2), at 256^2 (whole CTAs) and 131 x 67 (a partial last
    CTA): a 64x128xC texture, uv in [-0.3, 1.3] with NaNs and values in
    [-5, 5], flevels over every level. Returns the number of cases."""
    n = 0
    for C in (1, 3, 4):
        for D in (1, 2):
            rng = np.random.default_rng(100 * C + D)
            tex = torch.from_numpy(rng.random((D, 64, 128, C), dtype=np.float32)).to(dev)
            levels = [tex] + tx.build_mip_stack(tex)
            meta, _ = tx._static_meta(levels)
            flat = tx._pack_pyramid(levels)
            for B, H, W in ((2, SMALL, SMALL), (2, 131, 67)):
                N = B * H * W
                u, v = (rng.uniform(-0.3, 1.3, N).astype(np.float32) for _ in range(2))
                u[::5] = rng.uniform(-5, 5, u[::5].shape)
                u[::7] = np.nan
                v[::11] = np.nan
                fl = rng.uniform(-0.5, len(meta) - 0.5, N).astype(np.float32)
                gc = rng.standard_normal((C, N)).astype(np.float32)
                ins = [torch.from_numpy(x).to(dev) for x in (u, v, fl, gc)]
                for filt in ("linear", "linear-mipmap-nearest", "linear-mipmap-linear"):
                    fm = (flat[:D * 64 * 128], meta[:1]) if filt == "linear" else (flat, meta)
                    for bnd in ("wrap", "clamp", "zero"):
                        args = (fm[0], *ins, fm[1], (B, H, W), D > 1, bnd, filt)
                        got = txb.texture_bwd(*args)
                        ref = txb.texture_bwd_plain(*args)
                        for x, y in zip(got, ref):
                            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                                raise AssertionError(
                                    f"texture_bwd {filt} {bnd} C={C} D={D} {B}x{H}x{W}: "
                                    "differs from texture_bwd_plain")
                        n += 1
    return n


def reduction_stages(torch, dev, tiles, n_rows, seg_kernel, sum_kernel):
    """CUDA-event times (ms) of a gradient reduction's stages (ops/segments.py:
    the tile pass's first run, the scan, the one sync, the second run
    (compact + the tiles over the cap), the stable sort, the segment starts,
    the sums) on one call's inputs, `tiles` = (launch, n_tiles, width,
    cap) of the module's tile pass. Checks two stages: the compacted partials
    against the first run's scratch slots (bit for bit or raise) and the
    segment starts against searchsorted (equal or raise). Returns (times,
    (compact max|err|, segments max|err|), (key, partial, counts))."""
    from nvdiffrast_tpu_torch import _build

    launch, n_tiles, width, cap = tiles
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    ks = torch.empty((n_tiles * cap,), dtype=torch.int32, device=dev)
    ps = torch.empty((n_tiles * cap, width), dtype=torch.float64, device=dev)

    def pass1():
        launch(None, counts, ks, ps, None, None)

    pass1()
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    offs = ends - counts
    E = int(ends[-1])
    key = torch.empty((E,), dtype=torch.int32, device=dev)
    part = torch.empty((E, width), dtype=torch.float64, device=dev)

    def pass2():
        launch(offs, counts, ks, ps, key, part)

    pass2()
    cl = counts.long()
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), cl)
    direct = (cl <= cap)[tile_of]
    src = (tile_of * cap + torch.arange(E, device=dev) - offs[tile_of])[direct]
    if not (torch.equal(key[direct], ks[src])
            and torch.equal(part[direct].view(torch.int64), ps[src].view(torch.int64))):
        raise AssertionError("compact: partials differ from the scratch slots")
    compact_err = float((part[direct] - ps[src]).abs().max()) if bool(direct.any()) else 0.0
    skey, perm = torch.sort(key, stable=True)
    starts = torch.empty((n_rows + 1,), dtype=torch.int32, device=dev)

    def seg():
        seg_kernel.launch(dev, _build.ptr(skey), E, 0, n_rows, 4, None, None,
                          _build.ptr(starts), None)

    seg()
    ref_starts = torch.searchsorted(skey, torch.arange(n_rows + 1, dtype=torch.int32,
                                                       device=dev))
    seg_err = float((starts.long() - ref_starts).abs().max())
    if seg_err != 0.0:
        raise AssertionError("segment starts differ from searchsorted")
    pp = torch.empty((max(E, 1), width), dtype=torch.float64, device=dev)
    out = torch.empty((n_rows, width), dtype=torch.float32, device=dev)

    def sums():
        sum_kernel.launch(dev, _build.ptr(skey), _build.ptr(perm), E, _build.ptr(starts),
                          _build.ptr(part), _build.ptr(pp), _build.ptr(out), n_rows, width)

    return {"tiles pass 1": cuda_ms(torch, pass1, 20),
            "scan": cuda_ms(torch, lambda: torch.cumsum(counts, 0, dtype=torch.int64), 20),
            "sync": cuda_ms(torch, lambda: int(ends[-1]), 20),
            "pass 2 (compact, tiles over the cap)": cuda_ms(torch, pass2, 20),
            "stable sort": cuda_ms(torch, lambda: torch.sort(key, stable=True), 20),
            "segment starts": cuda_ms(torch, seg, 20),
            "sums": cuda_ms(torch, sums, 20)}, (compact_err, seg_err), (key, part, counts)


def partials_equal_or_raise(torch, got, ref, cap, what):
    """A tile pass's partials (key, partial, counts) against its plain
    twin's (key, tile, partial, entries), bit for bit and in order (cap:
    the tile pass's scratch slots); raises where they differ."""
    key, part, counts = got
    rkey, rtile, rpart, _ = ref
    tile = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device),
                                   counts.long())
    if not (torch.equal(key.long(), rkey.long()) and torch.equal(tile, rtile)
            and torch.equal(part.view(torch.int64), rpart.view(torch.int64))):
        raise AssertionError(f"{what}: partials differ from the twin's")
    log(f"[partials] {what}: {key.numel()} partials equal the twin's bit for bit "
        f"({int((counts > cap).sum())} tiles past the scratch of {cap})")


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



def entry(name, route, source, replaces, launches, err, ms, plain_ms, bnd, lib,
          all_ms=None, all_bnd=None, **device):
    """One kernel's entry of the JSON line."""
    e = {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}
    if all_ms is not None:  # the whole reduction: its glue and every stage
        e.update(all_ms=all_ms, all_bound_ms=all_bnd[0], all_bound_by=all_bnd[1])
    e.update(device)  # device time a call (torch.profiler), where measured
    return e


def four_spheres(cams):
    """Four concentric bench spheres (uv_sphere(32, 64) scaled 1.0, 0.8,
    0.6, 0.4; 15,872 triangles) under the given cameras: (pos [B, 4V, 4],
    tri, vertex colours [4V, 3], the triangle offset of each sphere)."""
    import numpy as np
    from nvdiffrast_tpu_torch.models import primitives

    pos_idx, vtxp, _, _ = primitives.uv_sphere(32, 64)
    V, T = vtxp.shape[0], pos_idx.shape[0]
    verts = np.concatenate([vtxp * s for s in PEEL_SCALES])
    tri = np.concatenate([pos_idx + k * V for k in range(len(PEEL_SCALES))]).astype(np.int32)
    posw = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    pos = np.stack([(posw @ m.T).astype(np.float32) for m in cams])
    col = (verts * 0.5 + 0.5).astype(np.float32)
    return pos, tri, col, [k * T for k in range(len(PEEL_SCALES))]


def big_sphere(rows, cols):
    """uv_sphere(rows, cols) under the bench camera, vertex colours."""
    import numpy as np
    from nvdiffrast_tpu_torch.models import primitives

    pos_idx, vtxp, _, _ = primitives.uv_sphere(rows, cols)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos = (posw @ cameras(1, 0)[0].T).astype(np.float32)[None]
    return pos, pos_idx.astype(np.int32), (vtxp * 0.5 + 0.5).astype(np.float32)


def frag_count(aabb, H, W):
    """Fragments the kernel must evaluate: each record's AABB pixels inside
    the image, summed over the records [..., 4] given."""
    sx = aabb[..., 2].clamp(max=W - 1) - aabb[..., 0].clamp(min=0) + 1
    sy = aabb[..., 3].clamp(max=H - 1) - aabb[..., 1].clamp(min=0) + 1
    return float((sx.clamp(min=0) * sy.clamp(min=0)).sum())


def phase16(dev, card, entry):
    """The rest of the rasterizer: depth peeling, range mode, viewport
    bands and per-tile binning for big meshes. Returns the kernels' JSON
    entries."""
    import numpy as np
    import torch
    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch import _build
    from nvdiffrast_tpu_torch.ops import antialias_cuda as ac
    from nvdiffrast_tpu_torch.ops import gather, scatter
    from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
    from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
    from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
    from nvdiffrast_tpu_torch.ops import rasterize as ra
    from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
    from nvdiffrast_tpu_torch.profile_step import host_syncs, scatter_args
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    res = (RES, RES)
    f32 = 4
    t_phase = time.perf_counter()
    raster_kernels = (rc.KERNEL, rc.DB_KERNEL, rc.BINNED_KERNEL, rc.PEEL_KERNEL,
                      rc.RANGE_KERNEL, rc.BAND_KERNEL, rc.SETUP_KERNEL, rc.BIN_EMIT_KERNEL,
                      rc.BIN_SEGMENT_KERNEL)
    op_kernels = raster_kernels + (ic.KERNEL, ac.KERNEL, ic.BWD_KERNEL, ac.BWD_KERNEL,
                                   gather.KERNEL, scatter.KERNEL, scatter.COMPACT_KERNEL,
                                   scatter.SEGMENT_KERNEL, scatter.SUM_KERNEL)

    def reset():
        for k in op_kernels:
            k.launches = 0

    def counts():
        return {k.name: k.launches for k in op_kernels if k.launches}

    def check_grads(gs, what):
        for name, g in gs:
            if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
                raise AssertionError(f"{what}: {name} gradient not finite or all zero")

    # -- 16a. depth peeling: four spheres, B = 2, 4 layers ---------------------
    pos, tri, col, starts = four_spheres(cameras(2, seed=16))
    p, t, a = inputs_from_numpy(pos, tri, col, device=dev)
    T4 = t.shape[0]

    def peel_step(pv, av):
        pv = pv.detach().clone().requires_grad_()
        av = av.detach().clone().requires_grad_()
        loss, layers = 0.0, []
        with dr.DepthPeeler(dr.RasterizeCudaContext(), pv, t, res) as peeler:
            for _ in range(PEEL_LAYERS):
                rast, db = peeler.rasterize_next_layer()
                img_c, _ = dr.interpolate(av, rast, t)
                img = dr.antialias(img_c, rast, pv, t)
                loss = loss + (img ** 2).mean()
                layers.append((rast.detach(), db.detach()))
        return layers, torch.autograd.grad(loss, (pv, av))

    reset()
    layers, pg = peel_step(p, a)
    torch.cuda.synchronize()
    peel_launches = counts()
    log(f"[16] launches during the peeling slice (B=2, {PEEL_LAYERS} layers): {peel_launches}")
    if rc.PEEL_KERNEL.launches != PEEL_LAYERS - 1:
        raise AssertionError(f"peel kernel launched {rc.PEEL_KERNEL.launches} times")
    check_grads(zip(("pos", "col"), pg), "peeling")
    layers2, pg2 = peel_step(p, a)
    for x, y in zip(pg + tuple(r for l_ in layers for r in l_),
                    pg2 + tuple(r for l_ in layers2 for r in l_)):
        if not torch.equal(x, y):
            raise AssertionError("peeling: not bitwise repeatable")
    plain = dr.rasterize(None, p, t, res)
    equal_or_raise(layers[0], plain, "peel layer 0 vs rasterize")
    # Each layer's kernel against its twin, on the previous layer's zbuf.
    (rec, aabb, pcounts, pboxes), _ = setup_equal_or_raise(rc, p, t, res, None,
                                                           f"peel scene {RES}^2 B=2")
    bins = rc.bin_records(aabb, res, pcounts)
    prev, peel_in, peel_err = None, None, 0.0
    for k in range(PEEL_LAYERS):
        got = rc.launch_records(rec, aabb, res, True, peel=prev, emit_zbuf=True, bins=bins)
        ref = rc.rasterize_records_plain(rec, aabb, res, True, peel=prev, emit_zbuf=True)
        peel_err = max(peel_err, equal_or_raise(got, ref, f"peel layer {k} kernel vs twin"))
        equal_or_raise(rc.launch_records(rec, aabb, res, True, peel=prev, emit_zbuf=True,
                                         boxes=pboxes), ref,
                       f"peel layer {k} unbinned kernel vs twin")
        equal_or_raise(got[:8], tuple(x for r in layers[k] for x in r.unbind(-1)),
                       f"peel layer {k} kernel vs DepthPeeler")
        covered = int((got[3] > 0).sum())
        if prev is not None:
            both = (got[3] > 0) & (prev_ids > 0)
            if not bool((got[8][both] > prev[both]).all()):
                raise AssertionError(f"peel layer {k}: depth does not grow")
            log(f"[16] peel layer {k}: {covered} covered pixels, depth grows strictly on "
                f"the {int(both.sum())} covered in layer {k - 1} too; kernel = twin bit for bit")
            if k == 1:
                peel_in = prev
        prev, prev_ids = got[8], got[3]
    # The peel kernel in the sweep the binning rule picks for this scene, the
    # other one beside it.
    binned_peel = rc.binned_by_default(2, T4, res)
    sweeps = {"binned": {"bins": bins}, "unbinned": {"boxes": pboxes}}
    peel_ms, peel_other_ms = (cuda_ms(torch, lambda kw=sweeps[k]: rc.launch_records(
        rec, aabb, res, True, peel=peel_in, emit_zbuf=True, **kw), 20)
        for k in (("binned", "unbinned") if binned_peel else ("unbinned", "binned")))
    peel_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(
        rec, aabb, res, True, peel=peel_in, emit_zbuf=True), 2)
    layer0_ms = cuda_ms(torch, lambda: rc.launch_records(rec, aabb, res, True,
                                                         emit_zbuf=True, bins=bins), 20)
    peeler_ms = window_ms(torch, lambda: peel_step(p, a), [()])
    log(f"[16] peeling {RES}^2 B=2, T={T4}: kernel {peel_ms:.3f} ms a peeled layer "
        f"{'binned' if binned_peel else 'unbinned'}, the rule's sweep ("
        f"{'unbinned' if binned_peel else 'binned'}: {peel_other_ms:.3f}; before: "
        f"{BEFORE_MS['peel']} binned), "
        f"{layer0_ms:.3f} ms layer 0 (plain rasterize's sweep), twin {peel_plain_ms:.3f} ms; "
        f"{PEEL_LAYERS}-layer fwd+bwd step {peeler_ms:.3f} ms ({card})")
    n_peel = frag_count(aabb, RES, RES)
    peel_bound = bound((rec.numel() + aabb.numel() + 2 * RES * RES * (1 + 9)) * f32,
                       40 * n_peel)

    # -- 16b. range mode: one 2-D pos, B = 8, image b draws sphere b mod 4 ------
    p2 = p[0].contiguous()
    ranges = torch.tensor([[starts[b % 4], T4 // 4] for b in range(RANGE_B)],
                          dtype=torch.int32, device=dev)
    (rec1, aabb1, rcounts, rboxes), _ = setup_equal_or_raise(
        rc, p2, t, res, None, f"range scene {RES}^2 (2-D pos)")
    bins1 = rc.bin_records(aabb1, res, rcounts)
    got = rc.launch_records(rec1, aabb1, res, True, ranges=ranges, emit_zbuf=True,
                            bins=bins1)
    ref = rc.rasterize_records_plain(rec1, aabb1, res, True, ranges=ranges, emit_zbuf=True)
    range_err = equal_or_raise(got, ref, "range kernel vs twin")
    equal_or_raise(rc.launch_records(rec1, aabb1, res, True, ranges=ranges, emit_zbuf=True,
                                     boxes=rboxes), ref, "range unbinned kernel vs twin")
    for b in range(4):
        s0 = starts[b]
        one = rc.rasterize_fused(p2[None], t[s0:s0 + T4 // 4], res, emit_db=True,
                                 emit_zbuf=True)
        ids = torch.where(one[3][0] > 0, one[3][0] + s0, 0.0)
        for bb in (b, b + 4):
            if not torch.equal(got[3][bb], ids):
                raise AssertionError(f"range image {bb}: ids differ from the instance render")
            equal_or_raise([got[k][bb] for k in (0, 1, 2, 4, 5, 6, 7, 8)],
                           [one[k][0] for k in (0, 1, 2, 4, 5, 6, 7, 8)],
                           f"range image {bb} vs the instance render")
    log(f"[16] range mode {RES}^2 B={RANGE_B}: kernel = twin bit for bit; each image equals "
        f"the instance render of its window (ids shifted by start), bit for bit")
    range_ms = cuda_ms(torch, lambda: rc.launch_records(
        rec1, aabb1, res, True, ranges=ranges, bins=bins1), 20)
    range_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(
        rec1, aabb1, res, True, ranges=ranges), 2)
    range_unbinned_ms = cuda_ms(torch, lambda: rc.launch_records(
        rec1, aabb1, res, True, ranges=ranges, boxes=rboxes), 20)
    range_fwd_ms = cuda_ms(torch, lambda: rc.rasterize_fused(p2, t, res, ranges=ranges,
                                                             emit_db=True), 20)
    n_range = sum(frag_count(aabb1[0, s:s + T4 // 4], RES, RES)
                  for s in (starts[b % 4] for b in range(RANGE_B)))
    range_bound = bound((rec1.numel() + aabb1.numel() + 2 * RANGE_B
                         + 8 * RANGE_B * RES * RES) * f32, 34 * n_range)

    def range_step(pv, av, size, rg):
        pv = pv.detach().clone().requires_grad_()
        av = av.detach().clone().requires_grad_()
        rast, _ = dr.rasterize(None, pv, t.to(pv.device), size, ranges=rg)
        img_c, _ = dr.interpolate(av, rast, t.to(pv.device))
        img = dr.antialias(img_c, rast, pv, t.to(pv.device))
        return torch.autograd.grad((img ** 2).mean(), (pv, av))

    reset()
    rg1 = range_step(p2, a, res, ranges)
    torch.cuda.synchronize()
    range_launches = counts()
    log(f"[16] launches during the range-mode slice: {range_launches}")
    for k in (rc.RANGE_KERNEL, ic.KERNEL, ac.KERNEL, ic.BWD_KERNEL, ac.BWD_KERNEL,
              gather.KERNEL, scatter.KERNEL):
        if k.launches <= 0:
            raise AssertionError(f"range mode: {k.name} never launched")
    check_grads(zip(("pos", "col"), rg1), "range mode")
    for x, y in zip(rg1, range_step(p2, a, res, ranges)):
        if not torch.equal(x, y):
            raise AssertionError("range mode gradients not bitwise repeatable")
    gpu_g = [g.cpu() for g in range_step(p2, a, (SMALL, SMALL), ranges)]
    cpu_g = range_step(p2.cpu(), a.cpu(), (SMALL, SMALL), ranges.cpu())
    for name, x, y in zip(("pos", "col"), gpu_g, cpu_g):
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        if not (scale > 0 and err <= GRAD_CPU_RTOL * scale):
            raise AssertionError(f"{SMALL}^2 range {name} gradient, GPU vs CPU: {err} of {scale}")
        log(f"[16] {SMALL}^2 range-mode {name} gradient, GPU vs CPU path: max|err| {err:.3g} "
            f"(max|g| {scale:.3g}, bar {GRAD_CPU_RTOL} x max|g|)")
    range_step_ms = window_ms(torch, lambda: range_step(p2, a, res, ranges), [()])
    log(f"[16] range mode {RES}^2 B={RANGE_B}: binned kernel {range_ms:.3f} ms (before: "
        f"{BEFORE_MS['range']}), unbinned {range_unbinned_ms:.3f} ms, twin {range_plain_ms:.3f} "
        f"ms; rasterize_fused {range_fwd_ms:.3f} ms; composed fwd+bwd {range_step_ms:.3f} "
        f"ms/step ({card})")

    # -- 16c. viewport bands: the bench render as four 512-row bands ------------
    bpos, btri, bcol, bcidx = sphere_scene(cameras(1, seed=0))
    bp, bt, ba, bc = inputs_from_numpy(bpos, btri, bcol, bcidx, device=dev)
    rng = np.random.default_rng(16)
    w1, w2 = (torch.from_numpy(rng.standard_normal((1, RES, RES, 4)).astype(np.float32))
              .to(dev) for _ in range(2))
    full, full_db = dr.rasterize(None, bp, bt, res)
    fcol, _ = dr.interpolate(ba, full, bc)
    faa = dr.antialias(fcol, full, bp, bt)
    band_h = RES // VP_BANDS
    reset()
    band_out = []
    for k in range(VP_BANDS):
        y0 = k * band_h
        vp = (y0, RES)
        pv = bp.detach().clone().requires_grad_()
        rast, db = dr.rasterize(None, pv, bt, (band_h, RES), viewport=vp)
        bcol_img, _ = dr.interpolate(ba, rast, bc)
        aa = dr.antialias(bcol_img, rast, pv, bt, viewport=vp)
        sl = slice(y0, y0 + band_h)
        loss = (rast * w1[:, sl]).sum() + (db * w2[:, sl]).sum()
        band_out.append((rast.detach(), db.detach(), aa.detach(),
                         torch.autograd.grad(loss, pv)[0]))
    torch.cuda.synchronize()
    band_launches = counts()
    log(f"[16] launches during the viewport slice ({VP_BANDS} bands): {band_launches}")
    if rc.BAND_KERNEL.launches != VP_BANDS:
        raise AssertionError(f"band kernel launched {rc.BAND_KERNEL.launches} times")
    band_gerr = 0.0
    for k, (rast, db, aa, g) in enumerate(band_out):
        sl = slice(k * band_h, (k + 1) * band_h)
        equal_or_raise((rast, db), (full[:, sl], full_db[:, sl]), f"band {k} vs full render")
        # Away from the band's folded top and bottom rows.
        inner = slice(k * band_h + 1, (k + 1) * band_h - 1)
        equal_or_raise((aa[:, 1:-1],), (faa[:, inner],), f"band {k} antialias vs full rows")
        mask = torch.zeros_like(w1)
        mask[:, sl] = 1.0
        pv = bp.detach().clone().requires_grad_()
        fr, fdb = dr.rasterize(None, pv, bt, res)
        gref = torch.autograd.grad((fr * w1 * mask).sum() + (fdb * w2 * mask).sum(), pv)[0]
        err = float((g - gref).abs().max()) / float(gref.abs().max())
        if not err <= VP_GRAD_RTOL:
            raise AssertionError(f"band {k} gradient vs the full render's: {err} of scale")
        band_gerr = max(band_gerr, err)
    log(f"[16] viewport: each band's rast and rast_db equal the full render's rows bit for "
        f"bit; antialias equals them away from the folded band edges; band gradients within "
        f"{band_gerr:.3g} of scale of the full render's restricted to the band (bar "
        f"{VP_GRAD_RTOL})")
    vsetup, _ = setup_equal_or_raise(rc, bp, bt, (band_h, RES), (band_h, RES),
                                     f"viewport band rows {band_h}-{2 * band_h - 1}")
    vrec, vaabb, _, vboxes = vsetup
    vgot = rc.rasterize_records(vsetup, (band_h, RES), True, viewport=(band_h, RES))
    vref = rc.rasterize_records_plain(vrec, vaabb, (band_h, RES), True, viewport=(band_h, RES))
    band_err = equal_or_raise(vgot, vref, "band kernel vs twin")
    band_ms = cuda_ms(torch, lambda: rc.launch_records(
        vrec, vaabb, (band_h, RES), True, viewport=(band_h, RES), boxes=vboxes), 20)
    band_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(
        vrec, vaabb, (band_h, RES), True, viewport=(band_h, RES)), 3)
    full_rec, full_aabb, _, full_boxes = rc.setup_records(bp, bt, res)
    full_ms = cuda_ms(torch, lambda: rc.launch_records(full_rec, full_aabb, res, True,
                                                       boxes=full_boxes), 20)
    band_bound = bound((vrec.numel() + vaabb.numel() + 8 * band_h * RES) * f32,
                       34 * frag_count(vaabb, band_h, RES))
    log(f"[16] band kernel (rows {band_h}-{2 * band_h - 1}): {band_ms:.3f} ms (before: "
        f"{BEFORE_MS['band']}), twin "
        f"{band_plain_ms:.3f} ms; the full {RES}^2 render's db kernel {full_ms:.3f} ms ({card})")

    # Binned against unbinned on scenes around the rule of BIN_MIN_WORK, in
    # turns: the bench scene at 256^2 and 2048^2 (B = 1 and 2), the peel
    # scene (B = 2).
    for what, cp, ct, size in (("bench", bp, bt, SMALL), ("bench", bp, bt, RES),
                               ("bench", torch.cat([bp, p[1:, :bp.shape[1]]]), bt, RES),
                               ("peel", p, t, RES)):
        sres = (size, size)
        srec_, saabb_, scounts_, sboxes_ = rc.setup_records(cp, ct, sres)
        runs = {"unbinned": lambda: rc.launch_records(srec_, saabb_, sres, boxes=sboxes_),
                "binned": lambda: rc.launch_records(srec_, saabb_, sres,
                                                    bins=rc.bin_records(saabb_, sres,
                                                                        scounts_))}
        equal_or_raise(runs["binned"](), runs["unbinned"](), f"{what} {size}^2 binned vs unbinned")
        ev_ms = {k: [] for k in runs}
        wall_ms = {k: [] for k in runs}
        for name in ("unbinned", "binned", "binned", "unbinned"):
            ev_ms[name].append(round(cuda_ms(torch, runs[name], 20), 4))
            wall_ms[name].append(round(window_ms(torch, runs[name], [()]), 4))
        sbins_ = rc.bin_records(saabb_, sres, scounts_)
        kern_ms = cuda_ms(torch, lambda: rc.launch_records(srec_, saabb_, sres, bins=sbins_), 20)
        sglue_ms = cuda_ms(torch, lambda: rc.bin_records(saabb_, sres, scounts_), 20)
        tests = cp.shape[0] * ct.shape[0] * (-(-size // 16)) ** 2
        log(f"[16] binning rule, {what} scene {size}^2 B={cp.shape[0]} (T={ct.shape[0]}, "
            f"{tests} AABB tests unbinned, {sbins_[1].numel()} list entries): CUDA events "
            f"unbinned {ev_ms['unbinned']} ms, binned with its glue {ev_ms['binned']} ms "
            f"(kernel alone {kern_ms:.4f}, binning glue {sglue_ms:.4f}; bench glue before: "
            f"{BEFORE_MS['bin_glue_bench']}); host clock a call unbinned {wall_ms['unbinned']}, "
            f"binned {wall_ms['binned']} ms ({card})")
    # A peeled layer of the peel scene end to end through rasterize_fused
    # (setup kernel; binned, also the binning glue and its host sync; the peel
    # sweep), either sweep forced, in turns: what DepthPeeler pays a layer.
    rule = rc.BIN_MIN_WORK
    forced = {"unbinned": 1 << 62, "binned": 0}

    def peel_fwd():
        return rc.rasterize_fused(p, t, res, peel_depth=peel_in, emit_db=True, emit_zbuf=True)

    try:
        outs = {}
        for name, work in forced.items():
            rc.BIN_MIN_WORK = work
            outs[name] = peel_fwd()
        equal_or_raise(outs["binned"], outs["unbinned"], "peeled layer binned vs unbinned")
        pev_ms = {k: [] for k in forced}
        pwall_ms = {k: [] for k in forced}
        for name in ("unbinned", "binned", "binned", "unbinned"):
            rc.BIN_MIN_WORK = forced[name]
            pev_ms[name].append(round(cuda_ms(torch, peel_fwd, 20), 4))
            pwall_ms[name].append(round(window_ms(torch, peel_fwd, [()]), 4))
    finally:
        rc.BIN_MIN_WORK = rule
    log(f"[16] a peeled layer through rasterize_fused, peel scene {RES}^2 B=2 (the rule "
        f"picks {'binned' if rc.binned_by_default(2, T4, res) else 'unbinned'}): CUDA events "
        f"unbinned {pev_ms['unbinned']} ms, binned {pev_ms['binned']} ms; host clock a call "
        f"unbinned {pwall_ms['unbinned']}, binned {pwall_ms['binned']} ms; binned = unbinned "
        f"bit for bit ({card})")

    # -- 16d. big mesh: uv_sphere(512, 1024), 1,046,528 triangles ---------------
    mpos, mtri, mcol = big_sphere(*BIG_SPHERE)
    mp, mt, ma = inputs_from_numpy(mpos, mtri, mcol, device=dev)
    TM = mt.shape[0]
    (mrec, maabb, mcounts, mboxes), setup_err = setup_equal_or_raise(rc, mp, mt, res, None,
                                                                     f"1M sphere {RES}^2")
    mbins = rc.bin_records(maabb, res, mcounts)
    before = rc.KERNEL.launches, rc.BINNED_KERNEL.launches
    mb = rc.launch_records(mrec, maabb, res, bins=mbins)
    mu = rc.launch_records(mrec, maabb, res, boxes=mboxes)
    torch.cuda.synchronize()
    if (rc.KERNEL.launches, rc.BINNED_KERNEL.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError("big mesh: one launch each expected")
    equal_or_raise(mb, mu, f"binned vs unbinned kernel at T={TM}")
    cover = float((mb[3] > 0).float().mean())
    lens = mbins[0][1:] - mbins[0][:-1]
    log(f"[16] T={TM} at {RES}^2: binned kernel = unbinned kernel bit for bit "
        f"({mbins[1].numel()} list entries, the longest list {int(lens.max())}, "
        f"covered {cover:.4f})")
    mbin_ms = cuda_ms(torch, lambda: rc.launch_records(mrec, maabb, res, bins=mbins), 10)
    order_min = rc.ORDER_MIN_ENTRIES
    rc.ORDER_MIN_ENTRIES = 1 << 62
    mbin_unordered_ms = cuda_ms(torch, lambda: rc.launch_records(mrec, maabb, res, bins=mbins),
                                10)
    rc.ORDER_MIN_ENTRIES = order_min
    munbin_ms = cuda_ms(torch, lambda: rc.launch_records(mrec, maabb, res, boxes=mboxes), 5)
    prepass_ms = cuda_ms(torch, lambda: rc.setup_records(mp, mt, res), 20)
    prepass_plain_ms = cuda_ms(torch, lambda: rc.build_records(mp, mt, res), 3)
    glue_ms = cuda_ms(torch, lambda: rc.bin_records(maabb, res, mcounts), 10)
    fwd_big_ms = cuda_ms(torch, lambda: rc.rasterize_fused(mp, mt, res), 10)
    n_sync_big = host_syncs(lambda: rc.rasterize_fused(mp, mt, res))
    if n_sync_big != 1:
        raise AssertionError(f"the binned 1M forward synced {n_sync_big} times")
    n_big = mrec.shape[1]
    ntile = RES // 16
    ends = torch.cumsum(mcounts, 0, dtype=torch.int64)
    offs = ends - mcounts
    n_keys = int(ends[-1])
    nseg = ntile * ntile
    seg_t = torch.empty((n_keys,), dtype=torch.int16 if nseg <= 2 ** 15 else torch.int32,
                        device=dev)
    kbytes = seg_t.element_size()
    rec_at = torch.empty((n_keys,), dtype=torch.int32, device=dev)
    emit_ms = cuda_ms(torch, lambda: rc.BIN_EMIT_KERNEL.launch(
        dev, _build.ptr(maabb), _build.ptr(offs), n_big, TM, ntile, ntile, kbytes,
        _build.ptr(seg_t), _build.ptr(rec_at)), 20)
    sseg, sperm = torch.sort(seg_t, stable=True)
    sort_ms = cuda_ms(torch, lambda: torch.sort(seg_t, stable=True), 10)
    tstart = torch.empty((nseg + 1,), dtype=torch.int32, device=dev)
    tlist = torch.empty((n_keys,), dtype=torch.int32, device=dev)
    seg_ms = cuda_ms(torch, lambda: rc.BIN_SEGMENT_KERNEL.launch(
        dev, _build.ptr(sseg), n_keys, 0, nseg, kbytes, _build.ptr(sperm), _build.ptr(rec_at),
        _build.ptr(tstart), _build.ptr(tlist)), 20)
    bins_plain_ms = cuda_ms(torch, lambda: rc.bin_records_plain(maabb, res), 2)
    bins_err = equal_or_raise(rc.bin_records_plain(maabb, res), mbins, "bin kernels vs twin")
    seg_err = max(bins_err, equal_or_raise((tstart, tlist), mbins,
                                           "segment starts kernel vs the lists"))
    log(f"[16] T={TM} forward split: setup kernel {prepass_ms:.4f} ms (the torch prepass before: "
        f"{BEFORE_MS['prepass_1M']}; its twin build_records {prepass_plain_ms:.3f}), binning "
        f"glue {glue_ms:.3f} ms (before: {BEFORE_MS['glue_1M']}; bin_emit {emit_ms:.4f}, sort of "
        f"{n_keys} int{8 * kbytes} segments (stable) {sort_ms:.4f}, segment starts "
        f"{seg_ms:.4f}, twin {bins_plain_ms:.3f}), binned kernel {mbin_ms:.3f} ms with its "
        f"longest-list-first order (before: {BEFORE_MS['binned_1M']}; in grid order "
        f"{mbin_unordered_ms:.3f}); the unbinned kernel {munbin_ms:.3f} ms; rasterize_fused "
        f"{fwd_big_ms:.3f} ms with {n_sync_big} host sync ({card})")
    # The binned kernel against its twin at uv_sphere(128, 320).
    spos, stri, _ = big_sphere(*MID_SPHERE)
    sp, st = inputs_from_numpy(spos, stri, device=dev)
    srec, saabb, scounts, _ = rc.setup_records(sp, st, res)
    sbins = rc.bin_records(saabb, res, scounts)
    sgot = rc.launch_records(srec, saabb, res, bins=sbins)
    sref = rc.rasterize_records_plain(srec, saabb, res)
    binned_err = equal_or_raise(sgot, sref, f"binned kernel vs twin at T={st.shape[0]}")
    binned_mid_ms = cuda_ms(torch, lambda: rc.launch_records(srec, saabb, res, bins=sbins), 20)
    # The twin at 1 M triangles: one timed call, held to the kernel too.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    mref = rc.rasterize_records_plain(mrec, maabb, res)
    ev[1].record()
    torch.cuda.synchronize()
    binned_plain_ms = ev[0].elapsed_time(ev[1])
    binned_err = max(binned_err, equal_or_raise(mb, mref, f"binned kernel vs twin at T={TM}"))
    del mref
    log(f"[16] binned kernel = twin bit for bit at T={st.shape[0]} (kernel "
        f"{binned_mid_ms:.3f} ms) and at T={TM} (twin {binned_plain_ms:.3f} ms, one call) "
        f"({card})")

    def big_step():
        pv = mp.detach().clone().requires_grad_()
        av = ma.detach().clone().requires_grad_()
        img = dr.render_pipeline(pv, mt, av, res)
        return torch.autograd.grad((img ** 2).mean(), (pv, av))

    big_kernels = (pc.KERNEL, pb.BWD_KERNEL, pb.SCATTER_KERNEL, pb.SCATTER_COMPACT_KERNEL,
                   pb.SCATTER_SEGMENT_KERNEL, pb.SCATTER_SUM_KERNEL)
    reset()
    for k in big_kernels:
        k.launches = 0
    g_big = big_step()
    torch.cuda.synchronize()
    big_launches = dict(counts(), **{k.name: k.launches for k in big_kernels})
    log(f"[16] launches during the 1M-triangle render_pipeline step: {big_launches}")
    for k in (rc.SETUP_KERNEL, rc.BINNED_KERNEL, rc.BIN_EMIT_KERNEL,
              rc.BIN_SEGMENT_KERNEL) + big_kernels:
        if k.launches <= 0:
            raise AssertionError(f"1M-triangle step: {k.name} never launched")
    check_grads(zip(("pos", "col"), g_big), "1M-triangle step")
    for x, y in zip(g_big, big_step()):
        if not torch.equal(x, y):
            raise AssertionError("1M-triangle gradients not bitwise repeatable")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    big_step()
    torch.cuda.synchronize()
    big_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    big_ms = window_ms(torch, big_step, [()])
    log(f"[16] render_pipeline fwd+bwd T={TM} {RES}^2: {big_ms:.3f} ms/step, peak memory of a "
        f"step above its inputs {big_mib:.1f} MiB ({card})")
    # B4 on the 1M-triangle render: most tiles hold more rows than the scratch.
    margs = scatter_args(mp, mt, ma, mt, res)
    mgot = pb.grad_scatter(*margs)
    for x, y, z in zip(mgot, pb.grad_scatter(*margs), pb.grad_scatter_plain(*margs)):
        if not torch.equal(x, y):
            raise AssertionError("1M-triangle grad_scatter not repeatable")
        rows_close(x, z, SCATTER_ROW_RTOL)
    mpart = pb.scatter_partials(*margs)[2]
    big_b4_ms = cuda_ms(torch, lambda: pb.grad_scatter(*margs), 10)
    log(f"[16] grad_scatter T={TM} {RES}^2: within {SCATTER_ROW_RTOL} x row max of the twin, "
        f"repeatable; {int(mpart.sum())} partials, {int((mpart > pb.SCATTER_CAP).sum())} of "
        f"{mpart.numel()} tiles past the scratch; in all {big_b4_ms:.3f} ms (before: "
        f"{BEFORE_MS['grad_scatter_1M']}) ({card})")
    n_big_frag = frag_count(maabb, RES, RES)
    binned_bound = bound((mrec.numel() + mbins[0].numel() + mbins[1].numel()
                          + 4 * RES * RES) * f32, 34 * n_big_frag)
    # The setup reads pos (16 bytes a vertex) and tri (12 bytes a triangle)
    # once and writes a record, an AABB and a count a triangle and a box a
    # chunk, ~400 float operations a triangle; the emit reads an AABB and an
    # offset a record and writes the keys; the segment starts read the
    # sorted keys and write the starts and the list.
    setup_bound = bound(mp.numel() * f32 + TM * 12 + n_big * (64 + 16 + 4)
                        + mboxes.numel() * f32, 400 * n_big)
    emit_bound = bound(n_big * (16 + 8) + n_keys * (kbytes + 4), 0)
    segments_bound = bound(n_keys * (kbytes + 8 + 4 + 4) + (nseg + 1) * 4, 0)
    log(f"[16] phase 16 took {time.perf_counter() - t_phase:.1f} s")

    return [
        entry("rasterize_peel", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039", peel_launches[rc.PEEL_KERNEL.name],
              peel_err, peel_ms, peel_plain_ms, peel_bound, None),
        entry("rasterize_range", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039",
              range_launches[rc.RANGE_KERNEL.name], range_err, range_ms, range_plain_ms,
              range_bound, None),
        entry("rasterize_band", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039", band_launches[rc.BAND_KERNEL.name],
              band_err, band_ms, band_plain_ms, band_bound, None),
        entry("rasterize_binned", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039",
              big_launches[rc.BINNED_KERNEL.name], binned_err, mbin_ms, binned_plain_ms,
              binned_bound, None),
        entry("raster_setup", "cuda", "nvdiffrast_tpu_torch/csrc/raster_setup.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1090",
              big_launches[rc.SETUP_KERNEL.name], setup_err, prepass_ms, prepass_plain_ms,
              setup_bound, None),
        entry("bin_segments", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:527",
              big_launches[rc.BIN_SEGMENT_KERNEL.name], seg_err, seg_ms, bins_plain_ms,
              segments_bound, None),
        entry("bin_emit", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:494",
              big_launches[rc.BIN_EMIT_KERNEL.name], bins_err, emit_ms, bins_plain_ms,
              emit_bound, None),
    ]



# -- 17. parallel: row bands and data parallelism in two ranks --------------------

def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_ms(dev, fn, iters):
    """ms a call: CUDA events on the card. (The host clock on the CPU only
    serves a rehearsal of phase 17's ranks there; main() runs the phase
    on the card.)"""
    import torch

    if dev.type == "cuda":
        return cuda_ms(torch, fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _step_ms(dev, fn, iters):
    """Synchronised host-clock ms a step after two warm ones (each rank
    runs the same steps: they meet in the collectives)."""
    for _ in range(2):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def textured_loss(view, off, tex, tri, uv, uv_tri, size):
    """mean(img**2) of render_pipeline_textured on the bench textured scene
    (phase 17's data-parallel step), the positions moved by `off`."""
    from nvdiffrast_tpu_torch.ops import pipeline_tex as ptx

    img = ptx.render_pipeline_textured(view + off, tri, uv, tex, size, uv_tri=uv_tri,
                                       filter_mode=FILTER, boundary_mode=BOUNDARY)
    return (img ** 2).mean()


def _phase17_sp(rank, n, tmp, dev, res):
    """The row-band step in one rank: the bench scene split into n bands
    through make_sp_render, fwd + bwd of mean(img**2) (each rank's band
    sum over the whole image's pixel count) to pos and the colours."""
    import numpy as np
    import torch
    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch import _build
    from nvdiffrast_tpu_torch.ops import gather, scatter
    from nvdiffrast_tpu_torch.parallel import make_mesh, make_sp_render, spatial
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    pos, tri, col, cidx = sphere_scene(cameras(1, seed=0))
    p, t, a, c = inputs_from_numpy(pos, tri, col, cidx, device=dev)
    mesh = make_mesh((n,), ("sp",), dev.type)
    render = make_sp_render(mesh, t, c, (res, res))
    hb = res // n
    ntot = res * res * a.shape[-1]

    def step(grad=True):
        pv = p.detach().clone().requires_grad_(grad)
        cv = a.detach().clone().requires_grad_(grad)
        band = render(pv, cv)
        if not grad:
            return band
        return (band.detach(),) + torch.autograd.grad((band ** 2).sum() / ntot, (pv, cv))

    step()
    # The boundary pass, watched: its B9 / B10 launches and its inputs.
    orig = (spatial.aa_boundary, spatial.table_take, spatial.scatter_add_by_id)
    seen = {"take": 0, "scatter": 0}

    def take(tbl, rid):
        k0 = gather.KERNEL.launches
        out = orig[1](tbl, rid)
        seen["take"] += gather.KERNEL.launches - k0
        seen.setdefault("take_args", (tbl, rid))
        return out

    def scat(ids, vals, num_rows):
        k0 = scatter.KERNEL.launches
        out = orig[2](ids, vals, num_rows)
        seen["scatter"] += scatter.KERNEL.launches - k0
        seen.setdefault("scatter_args", (ids, vals, num_rows))
        return out

    def boundary(*args, **kw):
        seen.setdefault("args", (args, kw))
        return orig[0](*args, **kw)

    spatial.aa_boundary, spatial.table_take, spatial.scatter_add_by_id = boundary, take, scat
    try:
        _build.reset_launches()
        band, gp, gc = step()
        _sync(dev)
        launches = _build.launch_counts()
    finally:
        spatial.aa_boundary, spatial.table_take, spatial.scatter_add_by_id = orig
    rast, _ = dr.rasterize(None, p, t, (hb, res), grad_db=False, viewport=(rank * hb, res))
    for name, x in (("band", band), ("rast", rast), ("gpos", gp), ("gcol", gc)):
        np.save(os.path.join(tmp, f"sp{rank}_{name}.npy"), x.cpu().numpy())

    sp_ms = _step_ms(dev, step, PARALLEL_STEPS)
    with torch.no_grad():
        sp_fwd_ms = _step_ms(dev, lambda: step(False), PARALLEL_STEPS)

    # The boundary pass alone (fwd + bwd, no collective) and its two
    # kernels at the shapes it gives them, against their plain versions.
    bargs, bkw = seen["args"]
    ct0, cb0, rt0, rb0, pos0 = (x.detach() for x in bargs[:5])
    gdelta = torch.ones_like(ct0)

    def bstep():
        ct, cb, pv = (x.clone().requires_grad_() for x in (ct0, cb0, pos0))
        out = orig[0](ct, cb, rt0, rb0, pv, *bargs[5:], **bkw)
        return torch.autograd.grad(out, (ct, cb, pv), (gdelta, gdelta))

    bnd_ms = _timed_ms(dev, bstep, 20)
    tbl, rid = seen["take_args"]
    got = gather.table_take(tbl, rid)
    if not bits_equal(got, gather.table_take_plain(tbl, rid)):
        raise AssertionError("table_take at the band boundary differs from its twin")
    ids, vals, num_rows = seen["scatter_args"]
    sgot = scatter.scatter_add_by_id(ids, vals, num_rows)
    sref = scatter.scatter_add_by_id_plain(ids, vals, num_rows)
    ulp = torch.from_numpy(np.spacing(sref.abs().cpu().numpy())).to(dev)
    if not bool(((sgot - sref).abs() <= ulp).all()):
        raise AssertionError("scatter_rows at the band boundary beyond 1 ulp of its twin")
    rows = torch.zeros((num_rows + 1, vals.shape[0]), dtype=torch.float32, device=dev)
    okid = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows).long()
    kern = {
        "take_ms": _timed_ms(dev, lambda: gather.table_take(tbl, rid), 50),
        "take_plain_ms": _timed_ms(dev, lambda: gather.table_take_plain(tbl, rid), 20),
        "take_lib_ms": _timed_ms(dev, lambda: torch.index_select(tbl, 1, rid.long()), 50),
        "scatter_ms": _timed_ms(dev, lambda: scatter.scatter_add_by_id(ids, vals, num_rows),
                                50),
        "scatter_plain_ms": _timed_ms(
            dev, lambda: scatter.scatter_add_by_id_plain(ids, vals, num_rows), 20),
        "scatter_lib_ms": _timed_ms(dev, lambda: rows.index_add_(0, okid, vals.T), 50),
        "scatter_err": float((sgot - sref).abs().max()),
        "take_shape": [list(tbl.shape), rid.shape[0]],
        "scatter_shape": [list(vals.shape), num_rows],
    }
    return {"sp_ms": sp_ms, "sp_fwd_ms": sp_fwd_ms, "bnd_ms": bnd_ms, "sp_launches": launches,
            "bnd_take": seen["take"], "bnd_scatter": seen["scatter"], **kern}


def _phase17_dp(rank, n, tmp, dev, res):
    """The data-parallel step in one rank: one view of the bench textured
    scene a rank, one SGD step of shard_map_train_step on the texture and
    a position offset."""
    import numpy as np
    import torch
    from nvdiffrast_tpu_torch import _build
    from nvdiffrast_tpu_torch.parallel import make_mesh, multihost, shard_map_train_step
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    pos, tri, _, cidx = sphere_scene(cameras(n, seed=17))
    p, t, c, uv, tex0 = inputs_from_numpy(pos, tri, cidx, sphere_uv(), bench_texture(),
                                          device=dev)
    mesh = make_mesh((n,), ("dp",), dev.type)
    tex = tex0.clone().requires_grad_()
    off = torch.zeros_like(p[0]).requires_grad_()
    opt = torch.optim.SGD([tex, off], lr=DP_LR)
    step = shard_map_train_step(lambda v: textured_loss(v, off, tex, t, uv, c, (res, res)),
                                opt, mesh)
    start, size = multihost.local_batch_slice(n, mesh)
    view = p[start:start + size]
    _build.reset_launches()
    loss = float(step(view))
    _sync(dev)
    launches = _build.launch_counts()
    np.save(os.path.join(tmp, f"dp{rank}_tex.npy"), tex.detach().cpu().numpy())
    np.save(os.path.join(tmp, f"dp{rank}_off.npy"), off.detach().cpu().numpy())
    return {"dp_loss": loss, "dp_launches": launches,
            "dp_ms": _step_ms(dev, lambda: step(view), PARALLEL_STEPS)}


def _phase17_rank(rank, n, tmp, device_type, res, backend):
    """One rank of phase 17 (started by torch.multiprocessing.spawn),
    meeting the others through a file store in `tmp`; results to
    tmp/rank{rank}.json and .npy."""
    import torch
    import torch.distributed as dist
    from nvdiffrast_tpu_torch.parallel import multihost

    multihost.initialize(init_method="file://" + os.path.join(tmp, "store"), world_size=n,
                         rank=rank, backend=backend, device_type=device_type, timeout_s=900)
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    try:
        out = _phase17_sp(rank, n, tmp, dev, res)
        out.update(_phase17_dp(rank, n, tmp, dev, res))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase17_ranks(n, tmp, device_type, res, backend="gloo"):
    """Start phase 17's n ranks and return their results, in rank order."""
    import torch.multiprocessing as mp

    mp.spawn(_phase17_rank, args=(n, tmp, device_type, res, backend), nprocs=n, join=True)
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase17_check(ranks, tmp, dev, res):
    """Phase 17's ranks against the single process on the same device:
    the bands' rast bit for bit, the image and the gradients within
    SP_RTOL (the gradients of each vertex row, of the row's largest), the
    cross-band pairs firing; the dp step's parameters within DP_RTOL of
    their largest entries. Returns the single-process steps (sp, dp) as
    functions for timing, and the largest errors."""
    import numpy as np
    import torch
    import nvdiffrast_tpu_torch as dr
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    n = len(ranks)
    hb = res // n
    pos, tri, col, cidx = sphere_scene(cameras(1, seed=0))
    p, t, a, c = inputs_from_numpy(pos, tri, col, cidx, device=dev)

    def sp_single():
        pv = p.detach().clone().requires_grad_()
        cv = a.detach().clone().requires_grad_()
        rast, _ = dr.rasterize(None, pv, t, (res, res), grad_db=False)
        img, _ = dr.interpolate(cv[None], rast, c)
        out = dr.antialias(img, rast, pv, t)
        return (rast.detach(), img.detach(), out.detach()) + torch.autograd.grad(
            (out ** 2).mean(), (pv, cv))

    rast, img, out, gp, gc = sp_single()
    load = lambda name: torch.from_numpy(np.load(os.path.join(tmp, name))).to(dev)  # noqa: E731
    img_err = grad_err = 0.0
    for r in range(n):
        rows = slice(r * hb, (r + 1) * hb)
        if not bits_equal(load(f"sp{r}_rast.npy"), rast[:, rows]):
            raise AssertionError(f"band {r}'s rast differs from the single-process rows")
        img_err = max(img_err, float((load(f"sp{r}_band.npy") - out[:, rows]).abs().max()))
        for name, ref in (("gpos", gp), ("gcol", gc)):
            got = load(f"sp{r}_{name}.npy")
            grad_err = max(grad_err, rows_close(got.reshape(-1, ref.shape[-1]),
                                                ref.reshape(-1, ref.shape[-1]), SP_RTOL))
    if not img_err <= SP_RTOL:
        raise AssertionError(f"row bands' image differs by {img_err}")
    edges = [r * hb + o for r in range(1, n) for o in (-1, 0)]
    fired = int(((img - out).abs().sum(-1)[:, edges] > 0).sum())
    if not fired:
        raise AssertionError("no cross-band antialias pair fired")

    dpos, dtri, _, dcidx = sphere_scene(cameras(n, seed=17))
    dp_, dt, dc, duv, dtex = inputs_from_numpy(dpos, dtri, dcidx, sphere_uv(),
                                               bench_texture(), device=dev)

    def dp_single():
        tex = dtex.clone().requires_grad_()
        off = torch.zeros_like(dp_[0]).requires_grad_()
        opt = torch.optim.SGD([tex, off], lr=DP_LR)
        opt.zero_grad()
        textured_loss(dp_, off, tex, dt, duv, dc, (res, res)).backward()
        opt.step()
        return tex.detach(), off.detach()

    tex1, off1 = dp_single()
    dp_err = upd_err = 0.0
    for r in range(n):
        for name, ref, start in (("tex", tex1, dtex), ("off", off1, torch.zeros_like(off1))):
            got = load(f"dp{r}_{name}.npy")
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            # The update itself, of the largest update: the bar above alone
            # would pass a wrong gradient whose step is small.
            step_ = float((ref - start).abs().max())
            uerr = float(((got - start) - (ref - start)).abs().max()) / max(step_, 1e-30)
            if not (err <= DP_RTOL and uerr <= DP_UPDATE_RTOL and step_ > 0):
                raise AssertionError(f"dp rank {r} {name}: {err} of its largest entry, "
                                     f"{uerr} of the largest update ({step_})")
            dp_err, upd_err = max(dp_err, err), max(upd_err, uerr)
    return sp_single, dp_single, img_err, grad_err, (dp_err, upd_err), fired


def phase17(dev, card, entry, n=SP_RANKS, backend="gloo"):
    """Row bands and data parallelism in n ranks, held against the single
    process on the card; then the dry run. By default two ranks share the
    card over gloo (halos and gradient sums through host memory); with
    ``--ranks`` one rank a card over nccl. Returns the kernels' JSON
    entries (B9, B10 at the band boundary)."""
    import tempfile
    import torch
    from nvdiffrast_tpu_torch import graft_entry
    from nvdiffrast_tpu_torch.ops import antialias_cuda as ac
    from nvdiffrast_tpu_torch.ops import gather, scatter
    from nvdiffrast_tpu_torch.ops import interpolate_cuda as ic
    from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
    from nvdiffrast_tpu_torch.ops import pipeline_tex_bwd_cuda as ptb
    from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
    from nvdiffrast_tpu_torch.ops import texture_bwd_cuda as txb
    from nvdiffrast_tpu_torch.ops import texture_cuda as tc

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    label = (f"{n} ranks sharing one {kind} over gloo, halos through host memory: not a "
             "scaling figure") if backend == "gloo" else f"{n} ranks on {n} {kind} over {backend}"
    with tempfile.TemporaryDirectory() as tmp:
        ranks = phase17_ranks(n, tmp, "cuda", RES, backend)
        sp_single, dp_single, img_err, grad_err, dp_err, fired = phase17_check(
            ranks, tmp, dev, RES)
    sp_paths = (rc.BAND_KERNEL, rc.SETUP_KERNEL, ic.KERNEL, ac.KERNEL, gather.KERNEL,
                ic.BWD_KERNEL, ac.BWD_KERNEL, scatter.KERNEL, scatter.SUM_KERNEL)
    dp_paths = (rc.SETUP_KERNEL, rc.DB_KERNEL, ic.KERNEL, tc.KERNEL, ac.KERNEL,
                txb.BWD_KERNEL, txb.GRAD_KERNEL, txb.GRAD_SUM_KERNEL, ptb.KERNEL,
                pb.SCATTER_KERNEL, pb.SCATTER_SUM_KERNEL)
    for r, res_ in enumerate(ranks):
        log(f"[17] rank {r} launches, row-band step: {res_['sp_launches']}; data-parallel "
            f"step: {res_['dp_launches']}; the boundary pass's table_take "
            f"{res_['bnd_take']}, scatter_rows {res_['bnd_scatter']}")
        for what, ks, got in (("row-band", sp_paths, res_["sp_launches"]),
                              ("data-parallel", dp_paths, res_["dp_launches"])):
            missing = [k.name for k in ks if not got.get(k.name)]
            if missing:
                raise AssertionError(f"rank {r}'s {what} step never launched {missing}")
        if not (res_["bnd_take"] > 0 and res_["bnd_scatter"] > 0):
            raise AssertionError(f"rank {r}'s boundary pass launched no B9 or B10")
    log(f"[17] row bands ({n} x {RES // n} rows of the bench scene at {RES}^2): "
        f"rast bit for bit with the single process, image within {img_err:.3g}, gradients "
        f"within {grad_err:.3g} of each vertex row's largest (bar {SP_RTOL}); {fired} "
        f"boundary pixels changed by the cross-band pairs")
    log(f"[17] data parallel ({n} views of the bench textured scene, SGD lr {DP_LR} on "
        f"the texture and a position offset): within {dp_err[0]:.3g} of each parameter's "
        f"largest entry of the single-process B = {n} step (bar {DP_RTOL}), the "
        f"updates within {dp_err[1]:.3g} of the largest update (bar {DP_UPDATE_RTOL})")
    r0 = ranks[0]
    B, C, V = 1, 3, sphere_scene(cameras(1, 0))[0].shape[1]
    halo = 2 * (B * RES * (C + 4) + B * RES * C) * 4  # two exchanges each way
    allreduce = V * (4 + C) * 4
    sp_single_ms = _step_ms(dev, sp_single, PARALLEL_STEPS)
    dp_single_ms = _step_ms(dev, dp_single, PARALLEL_STEPS)
    log(f"[17] {label}: row-band step (fwd + bwd) {r0['sp_ms']:.3f} ms, forward "
        f"{r0['sp_fwd_ms']:.3f} ms, the boundary pass (fwd + bwd) {r0['bnd_ms']:.4f} ms; "
        f"single process on the card, whole image {sp_single_ms:.3f} ms; halos {halo} bytes "
        f"a step a rank, the gradient sum {allreduce} bytes; data-parallel step "
        f"{r0['dp_ms']:.3f} ms, single process B = {n} {dp_single_ms:.3f} ms ({card})")
    dry = graft_entry.dryrun_multichip(n, "cuda")
    for r in dry:
        if not r["launches"]:
            raise AssertionError(f"dry run rank {r['rank']} launched no kernel")
    log(f"[17] dryrun_multichip({n}, 'cuda'): losses dp {dry[0]['dp_loss']:.6f}, sp "
        f"{dry[0]['sp_loss']:.6f}, bands within {max(r['sp_err'] for r in dry):.3g} of the "
        f"single process; {sum(dry[0]['launches'].values())} launches in rank 0")
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s")

    f32 = 4
    (tk, tn), tr = r0["take_shape"]
    (sk, sn), srows = r0["scatter_shape"]
    take_bound = bound((tk * tn + tr + tk * tr) * f32, 0)
    scatter_bound = bound((sn + sk * sn + srows * sk) * f32, sk * sn)
    log(f"[17] at the band boundary ({tr} pixels): table_take {r0['take_ms']:.4f} ms (twin "
        f"{r0['take_plain_ms']:.4f}, index_select {r0['take_lib_ms']:.4f}); scatter_rows "
        f"{r0['scatter_ms']:.4f} ms (twin {r0['scatter_plain_ms']:.4f}, index_add_ "
        f"{r0['scatter_lib_ms']:.4f}) ({card})")
    return [
        entry("table_take_band_boundary", "cuda", "nvdiffrast_tpu_torch/csrc/table_take.cu",
              "nvdiffrast_tpu/ops/gather.py:33", r0["bnd_take"], 0.0, r0["take_ms"],
              r0["take_plain_ms"], take_bound, r0["take_lib_ms"]),
        entry("scatter_rows_band_boundary", "cuda", "nvdiffrast_tpu_torch/csrc/scatter_rows.cu",
              "nvdiffrast_tpu/ops/scatter.py:84", r0["bnd_scatter"], r0["scatter_err"],
              r0["scatter_ms"], r0["scatter_plain_ms"], scatter_bound, r0["scatter_lib_ms"]),
    ]


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch + CUDA port.")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run phase 17 alone with one rank a card over nccl, on a machine "
                         "with at least this many cards (default: every phase, one card)")
    args = ap.parse_args()

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
    from nvdiffrast_tpu_torch.profile_step import _device_ms as device_ms
    from nvdiffrast_tpu_torch.profile_step import host_syncs, quad_scene, scatter_args, with_da4
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
    if args.ranks:
        if torch.cuda.device_count() < args.ranks:
            raise RuntimeError(f"--ranks {args.ranks}: torch sees {torch.cuda.device_count()} "
                               "cards")
        kernels = phase17(dev, card, entry, args.ranks, "nccl")
        log(card)
        log(json.dumps({"kernels": kernels}))
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
        return 0

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
        setup = setup_equal_or_raise(rc, p, t, res, None, what)[0]
        rec, aabb = setup[:2]
        got = rc.rasterize_records(setup, res)
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
    recs = setup_equal_or_raise(rc, p, t, res, None, f"sphere {RES}^2 B=1")[0]
    rec, aabb = recs[:2]
    T0 = t.shape[0]
    got = rc.rasterize_records(recs, res)
    ref = rc.rasterize_records_plain(rec, aabb, res)
    err, n_diff = zfight_check(ref, got, f"sphere {RES}^2 B=1")
    equal_or_raise(got, ref, f"rasterize sphere {RES}^2 B=1 kernel vs twin")
    raster_err = max(raster_err, err)
    log(f"[2] rasterize sphere {RES}^2 B=1: equal to its twin bit for bit, max|err| {err:.3g}, "
        f"id mismatches {n_diff}")
    raster_ms = cuda_ms(torch, lambda: rc.launch_records(rec, aabb, res, boxes=recs[3]), 20)
    raster_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(rec, aabb, res), 3)
    setup_ms = cuda_ms(torch, lambda: rc.setup_records(p, t, res), 50)
    setup_plain_ms = cuda_ms(torch, lambda: rc.build_records(p, t, res), 5)
    fwd_ms = cuda_ms(torch, lambda: rc.rasterize_fused(p, t, res), 20)
    n_sync = host_syncs(lambda: rc.rasterize_fused(p, t, res))
    if n_sync != int(rc.binned_by_default(1, T0, res)):
        raise AssertionError(f"the rasterize forward synced {n_sync} times")
    log(f"[2] rasterize {RES}^2: sweep kernel {raster_ms:.3f} ms (before: {BEFORE_MS['raster']}), "
        f"twin {raster_plain_ms:.3f} ms; setup kernel {setup_ms:.4f} ms, its twin "
        f"build_records {setup_plain_ms:.3f} ms (the torch prepass before: "
        f"{BEFORE_MS['prepass']}); "
        f"rasterize_fused (setup + sweep) {fwd_ms:.3f} ms, {n_sync} host syncs ({card})")

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
    for k in (rc.KERNEL, pc.KERNEL, rc.SETUP_KERNEL):
        k.launches = 0
    with torch.no_grad():
        imgs = []
        for view in reqs:
            img = pl.render_pipeline(view, t8, a8, res, attr_idx=c8)
            again = pl.render_pipeline(view, t8, a8, res, attr_idx=c8)
            imgs.append((img, again))
        img2 = pl.render_pipeline(pos2, t8, a8, res, attr_idx=c8)
        torch.cuda.synchronize()
    launches = {"raster_setup": rc.SETUP_KERNEL.launches, "rasterize": rc.KERNEL.launches,
                "shade_fwd": pc.KERNEL.launches}
    log(f"[4] launches during the slice: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if rc.SETUP_KERNEL.launches != 2 * len(reqs) + 1:
        raise AssertionError("the record setup kernel did not run once a forward")
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
    n_own = int(pb._own_live(gs, None).sum())
    n_aa = int((dd2 != 0).sum())
    log(f"[5] grad_scatter {RES}^2: {n_own} own-pixel and {n_aa} AA entries over "
        f"{R} rows; max|err| vs twin {scatter_err:.3g} (bar {SCATTER_ROW_RTOL} x row max)")
    st5, (gcompact_err, gseg_err), (_, _, gcounts) = reduction_stages(
        torch, dev, pb.scatter_tiles(*sargs), R, pb.SCATTER_SEGMENT_KERNEL,
        pb.SCATTER_SUM_KERNEL)
    n_part = int(gcounts.sum())
    scatter_ms = st5["tiles pass 1"]
    partials_plain_ms = cuda_ms(torch, lambda: pb.tile_partials_plain(*sargs), 1)
    scatter_all_ms = cuda_ms(torch, lambda: pb.grad_scatter(*sargs), 20)
    scatter_plain_ms = cuda_ms(torch, lambda: pb.grad_scatter_plain(*sargs), 3)
    n_sync5 = host_syncs(lambda: pb.grad_scatter(*sargs))
    if n_sync5 > 1:
        raise AssertionError(f"grad_scatter synced with the host {n_sync5} times")
    (orow, own), (arow, aav) = pb.expand_rows(*sargs)
    orow, arow = orow.long(), arow.long()
    zgt = torch.zeros((R, own.shape[1]), dtype=torch.float32, device=dev)
    zgaa = torch.zeros((R, 9), dtype=torch.float32, device=dev)
    scatter_lib_ms = cuda_ms(torch, lambda: (zgt.index_add_(0, orow, own),
                                             zgaa.index_add_(0, arow, aav)), 50)
    log(f"[5] grad_scatter {RES}^2: {n_part} (row, tile) partials; in all "
        f"{scatter_all_ms:.3f} ms (before: {BEFORE_MS['grad_scatter']}), {n_sync5} host sync; "
        "stages " + ", ".join(f"{k} {v:.4f}" for k, v in st5.items())
        + f" ms; twin {scatter_plain_ms:.3f} ms, index_add_ over the expanded rows "
        f"{scatter_lib_ms:.3f} ms ({card})")
    # The partials against their twin at a small shape, plain and da4.
    small_args = scatter_args(p, t, a, c, (SMALL, SMALL))
    partials_equal_or_raise(torch, pb.scatter_partials(*small_args),
                            pb.tile_partials_plain(*small_args), pb.SCATTER_CAP,
                            f"grad_scatter {SMALL}^2")
    sda, sda4 = with_da4(small_args, 5)
    partials_equal_or_raise(torch, pb.scatter_partials(*sda, da4=sda4),
                            pb.tile_partials_plain(*sda, da4=sda4), pb.SCATTER_CAP,
                            f"grad_scatter da4 {SMALL}^2")
    # The hot row: a quad filling the frame, with and without da4.
    qp, qt, qa = inputs_from_numpy(*quad_scene(), device=dev)
    qargs = scatter_args(qp, qt, qa, qt, res)
    quad_ms = {}
    qda, qda4 = with_da4(qargs, 6)
    for what, qa_, qkw in (("quad", qargs, {}), ("quad da4", qda, {"da4": qda4})):
        got = pb.grad_scatter(*qa_, **qkw)
        again = pb.grad_scatter(*qa_, **qkw)
        ref = pb.grad_scatter_plain(*qa_, **qkw)
        for x, y, z in zip(got, again, ref):
            if not torch.equal(x, y):
                raise AssertionError(f"grad_scatter {what}: not repeatable")
            rows_close(x, z, SCATTER_ROW_RTOL)
        qrow = pb.scatter_partials(*qa_, **qkw)[0]
        quad_ms[what] = cuda_ms(torch, lambda: pb.grad_scatter(*qa_, **qkw), 20)
        log(f"[5] grad_scatter {what} {RES}^2 (2 triangles fill the frame): within "
            f"{SCATTER_ROW_RTOL} x row max of the twin, repeatable; the rows' partials "
            f"{torch.bincount(qrow.long()).tolist()}; in all {quad_ms[what]:.3f} ms "
            f"(before: {BEFORE_MS['grad_scatter_' + what.replace(' ', '_')]}) ({card})")

    # -- 6. the training slice: fwd + bwd at 2048^2 ----------------------------
    def grads(view, colour, size):
        pv = view.detach().clone().requires_grad_()
        cv = colour.detach().clone().requires_grad_()
        img = pl.render_pipeline(pv, t8, cv, size, attr_idx=c8)
        # Per-image mean, summed over the batch (= mean(img**2) at B = 1).
        loss = (img ** 2).mean(dim=(1, 2, 3)).sum()
        return torch.autograd.grad(loss, (pv, cv))

    b4_kernels = (pb.SCATTER_KERNEL, pb.SCATTER_COMPACT_KERNEL, pb.SCATTER_SEGMENT_KERNEL,
                  pb.SCATTER_SUM_KERNEL)
    for k in (rc.SETUP_KERNEL, rc.KERNEL, pc.KERNEL, pb.BWD_KERNEL) + b4_kernels:
        k.launches = 0
    g1 = [grads(reqs[i], a8, res) for i in range(2)]
    again = grads(reqs[0], a8, res)
    col2 = a8.expand(2, -1, -1).contiguous()  # per-image colours: per-image gradients
    g2 = grads(pos2, col2, res)
    torch.cuda.synchronize()
    train_launches = {"raster_setup": rc.SETUP_KERNEL.launches,
                      "rasterize": rc.KERNEL.launches, "shade_fwd": pc.KERNEL.launches,
                      "pipeline_bwd": pb.BWD_KERNEL.launches,
                      **{k.name: k.launches for k in b4_kernels}}
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
    kernels_of_path = (rc.SETUP_KERNEL, rc.KERNEL, pc.KERNEL, pb.BWD_KERNEL) + b4_kernels
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
    if fit_launches[rc.SETUP_KERNEL.name] != ADAM_STEPS:
        raise AssertionError("the record setup kernel did not run once a forward")

    # -- 7. the textured forward's kernels vs twins (2048^2, bench scene) ----
    uvs = sphere_uv()
    tex_np = bench_texture()
    tpos, ttri, _, tcidx = sphere_scene(cameras(1, seed=0))
    p, t, tu, tuv, ttex = inputs_from_numpy(tpos, ttri, tcidx, uvs, tex_np, device=dev)
    tsetup = setup_equal_or_raise(rc, p, t, res, None, f"textured bench {RES}^2")[0]
    trec, taabb, _, tboxes = tsetup
    got = rc.rasterize_records(tsetup, res, emit_db=True)
    ref = rc.rasterize_records_plain(trec, taabb, res, emit_db=True)
    torch.cuda.synchronize()
    db_err = equal_or_raise(got, ref, "rasterize db")
    equal_or_raise(got[:4], rc.rasterize_records(tsetup, res), "rasterize db vs no db")
    log(f"[7] rasterize with db {RES}^2: equal to its twin bit for bit (8 outputs), "
        f"u, v, zw, id equal to the kernel without db; max|dudx| "
        f"{float(got[4].abs().max()):.3g}")
    db_ms = cuda_ms(torch, lambda: rc.launch_records(trec, taabb, res, True, boxes=tboxes), 20)
    db_plain_ms = cuda_ms(torch, lambda: rc.rasterize_records_plain(trec, taabb, res,
                                                                    emit_db=True), 3)
    log(f"[7] rasterize with db {RES}^2: kernel {db_ms:.3f} ms (before: {BEFORE_MS['raster_db']}), "
        f"twin {db_plain_ms:.3f} ms ({card})")

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
    largs7 = (da, TEX_SIZE, TEX_SIZE, L)
    flevel = tx.mip_level(*largs7)
    level_err = equal_or_raise((flevel,), (tx.mip_level_plain(*largs7),), "mip_level")
    level_ms = cuda_ms(torch, lambda: tx.mip_level(*largs7), 50)
    level_plain_ms = cuda_ms(torch, lambda: tx.mip_level_plain(*largs7), 5)
    log(f"[7] mip_level {RES}^2: equal to its twin bit for bit; kernel {level_ms:.4f} ms, "
        f"twin {level_plain_ms:.3f} ms ({card})")
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
    lin_err = equal_or_raise((lin,), (tc.sample_plain(*largs),), "texture_fwd linear+clamp")
    lin_ms = cuda_ms(torch, lambda: tc.sample(*largs), 50)
    lin_plain_ms = cuda_ms(torch, lambda: tc.sample_plain(*largs), 5)
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
    tkernels = (rc.SETUP_KERNEL, rc.DB_KERNEL, ic.KERNEL, tc.LEVEL_KERNEL, tc.KERNEL,
                ac.KERNEL)

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
    n_inst9 = texbwd_instances(torch, np, tx, txb, dev)
    log(f"[9] texture_bwd: {n_inst9} cases (3 filters x 3 boundaries, C in 1, 3, 4, one "
        f"texture or one per image, {SMALL}^2 and 131x67, B = 2, NaN and far uvs) equal "
        "to texture_bwd_plain bit for bit")
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
    lin_bwd_err = equal_or_raise(txb.texture_bwd(*lbargs), txb.texture_bwd_plain(*lbargs),
                                 "texture_bwd linear+clamp")
    lin_bwd_ms = cuda_ms(torch, lambda: txb.texture_bwd(*lbargs), 50)
    lin_bwd_plain_ms = cuda_ms(torch, lambda: txb.texture_bwd_plain(*lbargs), 5)
    texbwd_lib_ms = cuda_ms(torch, lambda: library_bwd([False, True]), 50)
    log(f"[9] texture_bwd {RES}^2: equal to its twin bit for bit; max|gu| "
        f"{float(gu9.abs().max()):.3g}, max|gfl| {float(gfl9.abs().max()):.3g}; kernel "
        f"{texbwd_ms:.4f} ms, twin {texbwd_plain_ms:.3f} ms; linear+clamp: kernel "
        f"{lin_bwd_ms:.4f} ms, grid_sample backward to the grid {texbwd_lib_ms:.4f} ms "
        f"(max|du diff| {gs_bwd_diff:.3g}) ({card})")

    n_tex9 = flat9.shape[0]
    gargs9 = (uv9[0], uv9[1], fl9, gc9, tmeta, n_tex9, shape1, False, BOUNDARY, FILTER)
    texgrad_err, n_ent9, n_taps, ent_err9, over_err9 = texgrad_check(
        torch, np, txb, gargs9, f"bench textured {RES}^2")
    for case, (bnd, filt, D) in (("zero", ("zero", FILTER, 1)), ("clamp", ("clamp", "linear", 1)),
                                 ("per-image", ("wrap", FILTER, 2))):
        texgrad_check(torch, np, txb, texgrad_case(torch, np, tx, dev, bnd, filt, D),
                      f"{case} {SMALL}^2 B=2 ({bnd}, {filt}, D={D})")
    st9, (compact_err9, seg_err9), _ = reduction_stages(
        torch, dev, txb.grad_tiles(*gargs9[:5], *gargs9[6:]), n_tex9, txb.GRAD_SEGMENT_KERNEL,
        txb.GRAD_SUM_KERNEL)
    log(f"[9] texture_grad stages {RES}^2: the compacted entries equal the first pass's "
        f"scratch slots bit for bit (max|err| {compact_err9:.3g}; the tiles over the cap "
        f"within {over_err9:.3g} of the twin after merging), the segment starts equal "
        f"searchsorted's (max|err| {seg_err9:.3g})")
    texgrad_ms = st9["tiles pass 1"]
    texgrad_all_ms = cuda_ms(torch, lambda: txb.texture_grad(*gargs9), 20)
    texgrad_plain_ms = cuda_ms(torch, lambda: txb.texture_grad_plain(*gargs9), 3)
    lgargs = (uv9[0], uv9[1], fl9, gc9, tmeta[:1], TEX_SIZE * TEX_SIZE, shape1, False,
              "clamp", "linear")
    lin_grad_err, n_ent_lin, n_taps_lin = texgrad_check(torch, np, txb, lgargs,
                                                        f"linear+clamp {RES}^2")[:3]
    lin_grad_ms = cuda_ms(torch, lambda: txb.texture_grad(*lgargs), 10)
    lin_grad_plain_ms = cuda_ms(torch, lambda: txb.texture_grad_plain(*lgargs), 3)
    entries_plain_ms = cuda_ms(torch, lambda: txb.tile_entries_plain(*gargs9), 3)
    texgrad_lib_ms = cuda_ms(torch, lambda: library_bwd([True, False]), 20)
    n_sync9 = host_syncs(lambda: txb.texture_grad(*gargs9))
    if n_sync9 > 1:
        raise AssertionError(f"texture_grad synced with the host {n_sync9} times")
    log(f"[9] texture_grad {RES}^2: {texgrad_all_ms:.3f} ms in all "
        f"(before: {BEFORE_MS['texgrad']} ms), {n_sync9} host sync; stages "
        + ", ".join(f"{k} {v:.4f}" for k, v in st9.items())
        + f" ms; twin {texgrad_plain_ms:.3f} ms; linear+clamp: all {lin_grad_ms:.3f} ms, "
        f"grid_sample backward to the input {texgrad_lib_ms:.3f} ms ({card})")

    vargs9 = (da9, gfl9, TEX_SIZE, TEX_SIZE, len(tmeta))
    gda9, gbias9 = tx.level_vjp(*vargs9)
    if gbias9 is not None:
        raise AssertionError("level_vjp without a bias returned a bias gradient")
    vjp_err = equal_or_raise((gda9,), (tx.level_vjp_plain(*vargs9)[0],), "level_vjp")
    vjp_ms = cuda_ms(torch, lambda: tx.level_vjp(*vargs9), 50)
    vjp_plain_ms = cuda_ms(torch, lambda: tx.level_vjp_plain(*vargs9), 5)
    log(f"[9] level_vjp {RES}^2: equal to its twin bit for bit; max|g_da| "
        f"{float(gda9.abs().max()):.3g}; kernel {vjp_ms:.4f} ms, twin {vjp_plain_ms:.3f} ms "
        f"({card})")
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
    n_own9 = int(pb._own_live(out15[:11], da4).sum())
    n_aa9 = int((dd9 != 0).sum())
    st9s, _, (_, _, gcounts9) = reduction_stages(
        torch, dev, pb.scatter_tiles(*sargs9, da4=da4), R9, pb.SCATTER_SEGMENT_KERNEL,
        pb.SCATTER_SUM_KERNEL)
    n_part9 = int(gcounts9.sum())
    da4_ms = st9s["tiles pass 1"]
    da4_all_ms = cuda_ms(torch, lambda: pb.grad_scatter(*sargs9, da4=da4), 20)
    da4_plain_ms = cuda_ms(torch, lambda: pb.grad_scatter_plain(*sargs9, da4=da4), 3)
    n_sync9s = host_syncs(lambda: pb.grad_scatter(*sargs9, da4=da4))
    if n_sync9s > 1:
        raise AssertionError(f"grad_scatter (da4) synced with the host {n_sync9s} times")
    (orow, own), (arow, aav) = pb.expand_rows(*sargs9, da4=da4)
    orow, arow = orow.long(), arow.long()
    zgt = torch.zeros((R9, own.shape[1]), dtype=torch.float32, device=dev)
    zgaa = torch.zeros((R9, 9), dtype=torch.float32, device=dev)
    da4_lib_ms = cuda_ms(torch, lambda: (zgt.index_add_(0, orow, own),
                                         zgaa.index_add_(0, arow, aav)), 50)
    log(f"[9] grad_scatter with da4 {RES}^2: {n_own9} own-pixel and {n_aa9} AA entries, "
        f"{n_part9} partials; max|err| vs twin {da4_err:.3g} (bar {SCATTER_ROW_RTOL} x row "
        f"max); in all {da4_all_ms:.3f} ms (before: {BEFORE_MS['grad_scatter_da4']}), "
        f"{n_sync9s} host sync; stages " + ", ".join(f"{k} {v:.4f}" for k, v in st9s.items())
        + f" ms; twin {da4_plain_ms:.3f} ms, index_add_ {da4_lib_ms:.3f} ms ({card})")

    # -- 10. the textured training slice: fwd + bwd at 2048^2 -----------------
    tbwd_kernels = (txb.BWD_KERNEL, txb.GRAD_KERNEL, txb.GRAD_COMPACT_KERNEL,
                    txb.GRAD_SEGMENT_KERNEL, txb.GRAD_SUM_KERNEL, ptb.KERNEL,
                    tc.LEVEL_VJP_KERNEL) + b4_kernels

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
    n_live = int(((rid9 >= 0) & (rid9 < R11) & (g9 != 0).any(0)).sum())
    # Every other covered pixel on row 0: one triangle with ~0.9 M entries.
    even = torch.arange(N, device=dev) % 2 == 0
    hot_ids = torch.where((rid9 < R11) & even, 0, rid9).to(torch.int32)
    hot = scatter.scatter_add_by_id(hot_ids, g9, R11)
    if not torch.equal(hot, scatter.scatter_add_by_id(hot_ids, g9, R11)):
        raise AssertionError("scatter_rows (hot row) not bitwise repeatable")
    hot_err = ulp_check(hot, scatter.scatter_add_by_id_plain(hot_ids, g9, R11),
                        "scatter_rows (hot row)")
    hot_n = int(((hot_ids == 0) & (g9 != 0).any(0)).sum())
    # Random ids: nothing to reduce within a chunk.
    rnd_ids = torch.from_numpy(np.random.default_rng(11).integers(0, R11, N).astype(
        np.int32)).to(dev)
    rnd = scatter.scatter_add_by_id(rnd_ids, g9, R11)
    if not torch.equal(rnd, scatter.scatter_add_by_id(rnd_ids, g9, R11)):
        raise AssertionError("scatter_rows (random ids) not bitwise repeatable")
    rnd_err = ulp_check(rnd, scatter.scatter_add_by_id_plain(rnd_ids, g9, R11),
                        "scatter_rows (random ids)")
    rnd_all_ms = cuda_ms(torch, lambda: scatter.scatter_add_by_id(rnd_ids, g9, R11), 10)
    hot_all_ms = cuda_ms(torch, lambda: scatter.scatter_add_by_id(hot_ids, g9, R11), 20)
    # The partials against their twin on 65,536 columns across the sphere,
    # coherent and random.
    mid = slice(N // 2 - 32768, N // 2 + 32768)
    for what, ids_ in (("raster rows", rid9[mid]), ("random ids", rnd_ids[mid])):
        vals_ = g9[:, mid].contiguous()
        partials_equal_or_raise(torch, scatter.chunk_partials(ids_, vals_, R11),
                                scatter.chunk_partials_plain(ids_, vals_, R11), scatter.CAP,
                                f"scatter_rows {what}, 65,536 columns")
    st11, (scompact_err, sseg_err), (_, _, scounts) = reduction_stages(
        torch, dev, scatter.chunk_tiles(rid9, g9, R11), R11, scatter.SEGMENT_KERNEL,
        scatter.SUM_KERNEL)
    n_part11 = int(scounts.sum())
    n_inrange11 = int(((rid9 >= 0) & (rid9 < R11)).sum())
    srows_ms = st11["tiles pass 1"]
    chunks_plain_ms = cuda_ms(torch, lambda: scatter.chunk_partials_plain(rid9, g9, R11), 1)
    srows_all_ms = cuda_ms(torch, lambda: scatter.scatter_add_by_id(rid9, g9, R11), 20)
    srows_plain_ms = cuda_ms(torch, lambda: scatter.scatter_add_by_id_plain(rid9, g9, R11), 5)
    n_sync11 = host_syncs(lambda: scatter.scatter_add_by_id(rid9, g9, R11))
    if n_sync11 > 1:
        raise AssertionError(f"scatter_rows synced with the host {n_sync11} times")
    live9 = rid9 < R11
    lrow, lval = rid9[live9].long(), g9[:, live9].T.contiguous()
    zrows = torch.zeros((R11, 9), dtype=torch.float32, device=dev)
    srows_lib_ms = cuda_ms(torch, lambda: zrows.index_add_(0, lrow, lval), 50)
    log(f"[11] scatter_rows {RES}^2 (rasterize backward rows, K = 9): {n_live} live "
        f"columns over {R11} rows, {n_part11} (id, chunk) partials; within 1 ulp of its "
        f"float64 twin (max|err| {scatter_rows_err:.3g}), bitwise repeatable; hot row of "
        f"{hot_n} columns within 1 ulp (max|err| {hot_err:.3g}), in all {hot_all_ms:.3f} ms "
        f"(before: {BEFORE_MS['scatter_rows_hot']}); random ids within 1 ulp (max|err| "
        f"{rnd_err:.3g}), in all {rnd_all_ms:.3f} ms (before: {BEFORE_MS['scatter_rows_random']}); "
        f"in all {srows_all_ms:.3f} ms (before: {BEFORE_MS['scatter_rows']}), {n_sync11} "
        "host sync; stages " + ", ".join(f"{k} {v:.4f}" for k, v in st11.items())
        + f" ms; twin {srows_plain_ms:.3f} ms, index_add_ {srows_lib_ms:.3f} ms ({card})")

    # -- 12. the composed ops' training step: fwd + bwd at 2048^2 -------------
    b10_kernels = (scatter.KERNEL, scatter.COMPACT_KERNEL, scatter.SEGMENT_KERNEL,
                   scatter.SUM_KERNEL)
    op_kernels = (rc.DB_KERNEL, ic.KERNEL, ac.KERNEL, ic.BWD_KERNEL, ac.BWD_KERNEL,
                  gather.KERNEL) + b10_kernels

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

    # -- 14. B12, the cube sampler, vs its twins (2048^2, 8 views) -------------
    # Reflection vectors of the bench sphere (seen from the bench camera's
    # position) interpolated with their screen derivatives act as the
    # directions; the map is procedural_cubemap(512), 10 levels.
    from nvdiffrast_tpu_torch.models import primitives
    from nvdiffrast_tpu_torch.ops import texture_cube_cuda as tcc

    _, vtx_np, _, _ = primitives.uv_sphere(32, 64)
    normals = vtx_np / np.linalg.norm(vtx_np, axis=1, keepdims=True)
    view_np = vtx_np - np.array([0.0, 0.0, 3.5], np.float32)
    refl_np = view_np - 2.0 * normals * (normals * view_np).sum(1, keepdims=True)
    refl_np = (refl_np / np.linalg.norm(refl_np, axis=1, keepdims=True)).astype(np.float32)
    (rvec,) = inputs_from_numpy(refl_np, device=dev)
    env_np = primitives.procedural_cubemap(CUBE_SIZE)[None]
    (env,) = inputs_from_numpy(env_np, device=dev)
    cube_spec = ("linear-mipmap-linear", "cube", -1, True)

    def refl_dirs(view, size=res):
        with torch.no_grad():
            rast, rast_db = dr.rasterize(None, view, t8.to(view.device), size, grad_db=True)
            return dr.interpolate(rvec.to(view.device), rast, t8.to(view.device), rast_db,
                                  diff_attrs="all")

    dirs = [refl_dirs(view) for view in reqs]
    _, csaved, cmeta = tx._texture_fwd(cube_spec, env, *dirs[0], None, ())
    cflat, ccols = csaved[0], tuple(csaved[6:])
    n_ctex = cflat.shape[0]
    cshape = (1, RES, RES)
    cimg = tcc.sample_cube(cflat, ccols, cmeta, FILTER, cshape)
    cube_fwd_err = equal_or_raise((cimg,), (tcc.sample_cube_plain(cflat, ccols, cmeta, FILTER),),
                                  "cube_fwd")
    cdy = (2.0 * cimg / cimg.numel()).contiguous()  # d mean(img**2) / d img
    cgs = tcc.cube_bwd(cflat, ccols, cdy, cmeta, FILTER, cshape)
    cgs_plain = tcc.cube_bwd_plain(cflat, ccols, cdy, cmeta, FILTER)
    equal_or_raise(cgs, cgs_plain, "cube_bwd")
    cfin = ccols[3] != 0
    cl0 = ccols[2].floor().clamp(0, len(cmeta) - 1)
    n_cvalid = int(cfin.sum())
    n_creads = n_cvalid + int((cfin & (cl0 < len(cmeta) - 1) & (ccols[2] > cl0)).sum())
    log(f"[14] cube_fwd, cube_bwd {RES}^2 ({FILTER}, {len(cmeta)} levels, {n_ctex} texels): "
        f"equal to their twins bit for bit; {n_cvalid} valid directions, {n_creads} level "
        f"reads, flevel in [{float(ccols[2].min()):.3f}, {float(ccols[2].max()):.3f}]")
    cube_fwd_ms = cuda_ms(torch, lambda: tcc.sample_cube(cflat, ccols, cmeta, FILTER, cshape),
                          50)
    cube_fwd_plain_ms = cuda_ms(torch, lambda: tcc.sample_cube_plain(cflat, ccols, cmeta,
                                                                     FILTER), 3)
    cube_bwd_ms = cuda_ms(torch, lambda: tcc.cube_bwd(cflat, ccols, cdy, cmeta, FILTER, cshape),
                          50)
    cube_bwd_plain_ms = cuda_ms(torch, lambda: tcc.cube_bwd_plain(cflat, ccols, cdy, cmeta,
                                                                  FILTER), 3)
    log(f"[14] cube_fwd {RES}^2 (16x16 tiles): kernel {cube_fwd_ms:.4f} ms (before: "
        f"{BEFORE_MS['cube_fwd']}), twin {cube_fwd_plain_ms:.3f} ms; cube_bwd, (gs, gt, gfl) "
        f"alone: kernel {cube_bwd_ms:.4f} ms (before: {BEFORE_MS['cube_bwd']}), twin "
        f"{cube_bwd_plain_ms:.3f} ms; no PyTorch call samples cube maps, so no library "
        f"yardstick ({card})")
    # The texture gradient: the tiles pass's partials against their twin,
    # the result against the float64 sums of the taps; the joint pass that
    # texture()'s backward runs ((gs, gt, gfl) and the partials in one
    # run) against both twins; its stages, and the earlier design (the
    # taps' glue and B10) on the same inputs.
    cargs = (ccols, cdy, cmeta, n_ctex, FILTER, cshape)
    cgrad = tcc.cube_texture_grad(*cargs)
    cg3, cgj = tcc.cube_grads(cflat, ccols, cdy, cmeta, n_ctex, FILTER, cshape)
    cube_bwd_err = equal_or_raise(cg3, cgs_plain, "cube tiles pass, (gs, gt, gfl)")
    if not bits_equal(cgj, cgrad):
        raise AssertionError("cube tiles pass: the joint run's texture gradient differs")
    cids, cw = tcc.cube_grad_entries(ccols, cmeta, FILTER)
    cvals = (cdy.repeat(1, cw.shape[0] // N) * cw).contiguous()
    cref = scatter.scatter_add_by_id_plain(cids, cvals, n_ctex)
    if not bits_equal(cgrad, tcc.cube_texture_grad(*cargs)):
        raise AssertionError("cube texture gradient not bitwise repeatable")
    cube_grad_err = ulp_check(cgrad, cref, "cube texture gradient")
    if bool(torch.signbit(cgrad[cref == 0]).any()):
        raise AssertionError("cube texture gradient: -0 where the float64 sum is +0")
    cpart = tcc.cube_tile_partials(ccols, cdy, cmeta, FILTER, cshape)
    partials_equal_or_raise(torch, cpart, tcc.cube_tile_partials_plain(
        ccols, cdy, cmeta, FILTER, cshape), tcc.CUBE_CAP, f"cube tiles pass {RES}^2")
    n_ctaps = int((cw != 0).sum())
    n_cpart = cpart[0].numel()
    n_sync14 = host_syncs(lambda: tcc.cube_texture_grad(*cargs))
    if n_sync14 > 1:
        raise AssertionError(f"cube texture gradient synced with the host {n_sync14} times")
    cuv = torch.empty((3, N), dtype=torch.float32, device=dev)
    ctiles = tcc.cube_tiles(cflat, ccols, cdy, cmeta, FILTER, cshape, cuv)  # the joint pass
    st14, (compact_err14, seg_err14), _ = reduction_stages(
        torch, dev, ctiles, n_ctex, tcc.GRAD_SEGMENT_KERNEL, tcc.GRAD_SUM_KERNEL)
    equal_or_raise(tuple(cuv), cgs_plain, "cube tiles pass (stages), (gs, gt, gfl)")
    cgrad_ms = cuda_ms(torch, lambda: tcc.cube_texture_grad(*cargs), 20)
    cjoint_ms = cuda_ms(torch, lambda: tcc.cube_grads(cflat, ccols, cdy, cmeta, n_ctex, FILTER,
                                                      cshape), 20)
    cparts_plain_ms = cuda_ms(torch, lambda: tcc.cube_tile_partials_plain(
        ccols, cdy, cmeta, FILTER, cshape), 2)

    def taps_then(sum_fn):  # the taps' glue, then a sum of the taps by texel
        ids, w = tcc.cube_grad_entries(ccols, cmeta, FILTER)
        return sum_fn(ids, (cdy.repeat(1, w.shape[0] // N) * w).contiguous(), n_ctex)

    cgrad_plain_ms = cuda_ms(torch, lambda: taps_then(scatter.scatter_add_by_id_plain), 3)
    cold_ms = cuda_ms(torch, lambda: taps_then(scatter.scatter_add_by_id), 3)
    log(f"[14] cube tiles pass {RES}^2: {n_ctaps} kept taps into {n_cpart} (texel, tile) "
        f"partials ({int((cpart[2] > 0).sum())} tiles with taps, at most {int(cpart[2].max())} "
        f"partials a tile, {int((cpart[2] > tcc.CUBE_CAP).sum())} past the scratch of "
        f"{tcc.CUBE_CAP}); the gradient within 1 ulp of the float64 sums of the taps (max|err| "
        f"{cube_grad_err:.3g}), bitwise repeatable, {n_sync14} host sync; the joint run's "
        f"(gs, gt, gfl) equal cube_bwd_plain's and its gradient the texture-only run's, bit "
        f"for bit; the compacted partials equal the scratch (max|err| {compact_err14:.3g}), "
        f"the segment starts searchsorted's (max|err| {seg_err14:.3g})")
    log(f"[14] cube gradients {RES}^2, the joint pass as texture() runs it: in all "
        f"{cjoint_ms:.4f} ms, stages " + ", ".join(f"{k} {v:.4f}" for k, v in st14.items())
        + f" ms; the texture gradient alone {cgrad_ms:.4f} ms (before, the taps' glue and "
        f"B10: {BEFORE_MS['cube_grad']}; in this run {cold_ms:.3f} ms), with (gs, gt, gfl) "
        f"alone {cgrad_ms + cube_bwd_ms:.4f} ms apart; partials twin {cparts_plain_ms:.3f} "
        f"ms, float64 index_add_ twin {cgrad_plain_ms:.3f} ms ({card})")

    # The cube texture op, fwd + bwd (gradients to the map, uv and uv_da)
    # on the 8 views: the main path of B12. B10 leaves it.
    cube_kernels = (tcc.FWD_KERNEL, tcc.BWD_KERNEL, tcc.GRAD_COMPACT_KERNEL,
                    tcc.GRAD_SEGMENT_KERNEL, tcc.GRAD_SUM_KERNEL)

    def cube_step(uv, uv_da, tex=env):
        xs = [x.detach().clone().requires_grad_() for x in (tex, uv, uv_da)]
        img = dr.texture(xs[0], xs[1], xs[2], filter_mode=FILTER, boundary_mode="cube")
        return (img.detach(),) + torch.autograd.grad((img ** 2).mean(), xs)

    for k in cube_kernels + b10_kernels:
        k.launches = 0
    cg = [cube_step(*d) for d in dirs]
    torch.cuda.synchronize()
    cube_launches = {k.name: k.launches for k in cube_kernels + b10_kernels}
    log(f"[14] launches during the cube texture slice (8 views): {cube_launches}")
    if min(cube_launches[k.name] for k in cube_kernels) <= 0:
        raise AssertionError(f"a kernel of the cube path never launched: {cube_launches}")
    if any(cube_launches[k.name] for k in b10_kernels):
        raise AssertionError(f"scatter_rows launched on the cube path: {cube_launches}")
    for x, y in zip(cg[0], cube_step(*dirs[0])):
        if not bits_equal(x, y):
            raise AssertionError("cube texture gradients not bitwise repeatable")
    for i, out in enumerate(cg):
        if not all(bool(torch.isfinite(x).all()) for x in out) or not bool(
                (out[1] != 0).any()):
            raise AssertionError(f"cube view {i}: output or map gradient not finite / zero")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cube_step(*dirs[1])
    torch.cuda.synchronize()
    cube_step_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    cube_step_ms = window_ms(torch, cube_step, dirs)
    log(f"[14] texture(cube) fwd+bwd {RES}^2 (kernels): {cube_step_ms:.3f} ms/step; peak "
        f"memory of a step above its inputs {cube_step_mib:.1f} MiB ({card})")
    # The card's cube path against the CPU path on a small view.
    sdirs = refl_dirs(reqs[3], small)
    gpu_c = [x.cpu() for x in cube_step(*sdirs)]
    cpu_c = cube_step(*(d.cpu() for d in sdirs), tex=env.cpu())
    for name, x, y in zip(("image", "map", "uv", "uv_da"), gpu_c, cpu_c):
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        if not err <= TEX_GRAD_RTOL * max(scale, 1e-30):
            raise AssertionError(f"{SMALL}^2 cube {name}, GPU vs CPU: {err} of {scale}")
    log(f"[14] {SMALL}^2 cube texture, GPU vs CPU path: image and gradients within "
        f"{TEX_GRAD_RTOL} of their largest")

    # -- 15. the repairs, the 2-D texture op and the models on the card ---------
    # C.1 and C.2 at 64^2: finite, bitwise repeatable, within the CPU bars of
    # the CPU path.
    rep = (REPAIR_RES, REPAIR_RES)
    rng15 = np.random.RandomState(15)
    (a9, uv2, tex9, env8, dirs8) = inputs_from_numpy(
        rng15.rand(1, a8.shape[-2], 9), rng15.rand(2, tuv.shape[0], 2),
        rng15.rand(1, 32, 64, 9), rng15.rand(1, 6, 8, 8, 3),
        rng15.randn(tuv.shape[0], 3), device=dev)

    def repairs(view, devc):
        xs = [x.to(devc).detach().clone().requires_grad_()
              for x in (view, a9, uv2, tex9, env8, dirs8, tuv, ttex)]
        td, cd = t8.to(devc), c8.to(devc)
        rast, _ = dr.rasterize(None, xs[0], td, rep, grad_db=False)
        imgs = [dr.antialias(dr.interpolate(xs[1], rast, cd)[0].repeat(1, 1, 1, 2)[..., :17],
                             rast, xs[0], td),
                dr.render_pipeline(xs[0], td, xs[1], rep, attr_idx=cd),
                dr.render_pipeline_textured(xs[0], td, xs[2], xs[7], rep, uv_tri=cd),
                dr.render_pipeline_textured(xs[0], td, xs[6], xs[3], rep, uv_tri=cd,
                                            filter_mode="linear"),
                dr.render_pipeline_textured(xs[0], td, xs[6], xs[7], rep, uv_tri=cd,
                                            filter_mode="nearest"),
                dr.render_pipeline_textured(xs[0], td, xs[5], xs[4], rep, uv_tri=cd,
                                            boundary_mode="cube")]
        loss = sum((i ** 2).mean() for i in imgs)
        used = [x for x in xs if x is not xs[6]]
        return [i.detach() for i in imgs] + list(torch.autograd.grad(loss, used,
                                                                    allow_unused=True))

    pos2x = reqs[2]
    rg = repairs(pos2x.expand(2, -1, -1).contiguous(), dev)
    for x, y in zip(rg, repairs(pos2x.expand(2, -1, -1).contiguous(), dev)):
        if not (bool(torch.isfinite(x).all()) and torch.equal(x, y)):
            raise AssertionError("repairs: not finite or not bitwise repeatable")
    rc_cpu = repairs(pos2x.expand(2, -1, -1).contiguous().cpu(), "cpu")
    rep_err = 0.0
    for i, (x, y) in enumerate(zip(rg, rc_cpu)):
        err = float((x.cpu() - y).abs().max())
        scale = max(float(y.abs().max()), 1e-30)
        bar = TEX_CPU_ATOL if i < 6 else TEX_GRAD_RTOL * scale
        if not err <= bar:
            raise AssertionError(f"repairs output {i}, GPU vs CPU: {err} (bar {bar})")
        rep_err = max(rep_err, err / (1.0 if i < 6 else scale))
    log(f"[15] C.1 (antialias C = 17, render_pipeline A = 9) and C.2 (per-image uvs, C = 9, "
        f"nearest, cube) at {REPAIR_RES}^2, B = 2: finite, bitwise repeatable, within the CPU "
        f"bars of the CPU path (worst {rep_err:.3g})")

    # The 2-D texture op fwd + bwd on the bench textured scene.
    tex_kernels = (tc.KERNEL, txb.BWD_KERNEL, txb.GRAD_KERNEL)

    def uv_of(view):
        with torch.no_grad():
            rast, rast_db = dr.rasterize(None, view, t8, res, grad_db=True)
            return dr.interpolate(tuv, rast, c8, rast_db, diff_attrs="all")

    tuvs = [uv_of(view) for view in reqs]

    def tex_step(uv, uv_da):
        xs = [x.detach().clone().requires_grad_() for x in (ttex, uv, uv_da)]
        img = dr.texture(xs[0], xs[1], xs[2], filter_mode=FILTER, boundary_mode=BOUNDARY)
        return torch.autograd.grad((img ** 2).mean(), xs)

    for k in tex_kernels:
        k.launches = 0
    for d in tuvs:
        tex_step(*d)
    torch.cuda.synchronize()
    top_launches = {k.name: k.launches for k in tex_kernels}
    if min(top_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the texture op never launched: {top_launches}")
    top_ms = window_ms(torch, tex_step, tuvs)
    log(f"[15] texture (2-D, {FILTER}) fwd+bwd {RES}^2: {top_ms:.3f} ms/step; launches over "
        f"8 views {top_launches} ({card})")

    # The models.
    from nvdiffrast_tpu_torch.models.fit_earth import EarthFitModel
    from nvdiffrast_tpu_torch.models.fit_envphong import EnvPhongFitModel

    def run_model(model, steps, metric, kernels):
        for k in kernels:
            k.launches = 0
        m0 = metric(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [model.step() for _ in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        launches = {k.name: k.launches for k in kernels}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the model's path never launched: {launches}")
        return m0, metric(model), losses, ms, launches

    env_metric = lambda m: m.metrics()[0]  # noqa: E731
    model_kernels = (tcc.FWD_KERNEL, tcc.BWD_KERNEL, tcc.GRAD_SUM_KERNEL, rc.DB_KERNEL,
                     ic.KERNEL)
    e0, e1, el, env_ms, el_launch = run_model(
        EnvPhongFitModel(res=128, env_res=32, subdiv=2, seed=0, device=dev), ENV_STEPS,
        env_metric, model_kernels)
    lk = ENV_STEPS // 10
    log(f"[15] EnvPhongFitModel(128, env 32, subdiv 2): env RMSE {e0:.4f} -> {e1:.4f}, loss "
        f"{np.mean(el[:lk]):.5f} -> {np.mean(el[-lk:]):.5f} over {ENV_STEPS} steps, "
        f"{env_ms:.3f} ms/step; launches {el_launch} ({card})")
    if not (e1 < e0 and np.mean(el[-lk:]) < np.mean(el[:lk])):
        raise AssertionError("EnvPhongFitModel: env RMSE or loss did not fall")
    s0, s1, _, envs_ms, _ = run_model(
        EnvPhongFitModel(res=32, env_res=8, subdiv=1, seed=0, device=dev), 150, env_metric,
        model_kernels)
    log(f"[15] EnvPhongFitModel(32, env 8, subdiv 1): env RMSE {s0:.4f} -> {s1:.4f} after 150 "
        f"steps (bar {ENV_BAR}), {envs_ms:.3f} ms/step ({card})")
    if not s1 < ENV_BAR:
        raise AssertionError(f"envphong test configuration: env RMSE {s1}")
    earth_kernels = (tc.KERNEL, txb.GRAD_KERNEL, rc.DB_KERNEL, ic.KERNEL)
    psnr = lambda m: m.texture_psnr()  # noqa: E731
    p0, p1, pl_, earth_ms, pl_launch = run_model(
        EarthFitModel(res=128, ref_res=256, tex_res=(128, 256), max_mip_level=9, seed=0,
                      device=dev), EARTH_STEPS, psnr, earth_kernels)
    log(f"[15] EarthFitModel(128, ref 256, tex 128x256): PSNR {p0:.3f} -> {p1:.3f} dB over "
        f"{EARTH_STEPS} steps, {earth_ms:.3f} ms/step; launches {pl_launch} ({card})")
    if not p1 > p0:
        raise AssertionError("EarthFitModel: PSNR did not rise")
    q0, q1, _, earths_ms, _ = run_model(
        EarthFitModel(res=32, ref_res=64, tex_res=(32, 64), max_mip_level=4, seed=0,
                      device=dev), 50, psnr, earth_kernels)
    log(f"[15] EarthFitModel(32, ref 64, tex 32x64): PSNR {q0:.3f} -> {q1:.3f} dB after 50 "
        f"steps (bar {EARTH_BAR}), {earths_ms:.3f} ms/step ({card})")
    if not q1 > EARTH_BAR:
        raise AssertionError(f"earth test configuration: PSNR {q1}")

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
    # grad_scatter's tiles pass reads rid0, dd2 and the gs column of every
    # pixel (to its first non-zero row where live, all of it where not; the
    # rest of a live one in the walk), b0, b1 of the live own pixels, rid2
    # and ax of the kept pairs and a vtbl row a partial, writes each partial
    # (its row and 3A+18 float64 sums), ~(6A + 11) operations an own entry
    # and ~60 a pair; in all, the partials are read back once more and the
    # [R, 3A+18] rows written. The second run moves the partials (read and
    # write), the segment starts read the sorted rows, the sums read each
    # partial with its sorted position and write the rows.
    def scatter_bounds(n_pix, n_rows_a, n_own_, n_aa_, n_part_, R_, W_, n_tiles_, extra):
        pix = (3 + n_rows_a + extra) * n_pix + 2 * n_own_ + 2 * n_aa_ + 9 * n_part_
        part = n_part_ * (4 + 8 * W_)
        ops = n_own_ * (2 * W_ - 25 + 2 * extra) + n_aa_ * 60
        return (bound(pix * f32 + part, ops),
                bound(pix * f32 + 2 * part + R_ * W_ * f32, ops + n_part_ * W_),
                bound(2 * part + n_tiles_ * 12, 0),
                bound((n_part_ + R_ + 1) * f32, 0),
                bound(n_part_ * 8 + part + (R_ + 1) * f32 + R_ * W_ * f32, n_part_ * W_))

    scatter_bound, scatter_all_bound, gcompact_bound, gseg_bound, gsum_bound = scatter_bounds(
        N, A + 9, n_own, n_aa, n_part, R, 3 * A + 18, gcounts.numel(), 0)
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
    # texture_grad's first pass reads u, v, flevel and C cotangents of every
    # pixel and writes the tile counts and the entries (texel and C float64
    # partials), ~(30 + 3C) operations a kept tap; the second pass moves the
    # entries (read and write); the segment starts read the sorted texels
    # and write n_texels + 1 starts; the sums read each entry's texel, row
    # and partials and write the gradient. The linear+clamp yardstick, the
    # same on its own inputs.
    n_tiles9 = (RES // 16) ** 2
    ent_bytes = 4 + 8 * C
    texgrad_bound = bound(((3 + C) * N + n_tiles9) * f32 + n_ent9 * ent_bytes,
                          n_taps * (30 + 3 * C))
    lin_grad_bound = bound(((3 + C) * N + n_tiles9) * f32 + n_ent_lin * ent_bytes,
                           n_taps_lin * (30 + 3 * C))
    compact_bound = bound(2 * n_ent9 * ent_bytes + n_tiles9 * 12, 0)
    segments_bound = bound((n_ent9 + n_tex9 + 1) * f32, 0)
    sums_bound = bound(n_ent9 * (ent_bytes + 8) + (n_tex9 + 1) * f32 + n_tex9 * C * f32,
                       n_ent9 * C)
    # Filter 'linear' reads no flevel: u, v and the base level.
    lin_bound = bound((2 * N + TEX_SIZE * TEX_SIZE * C + C * N) * f32, N * (30 + 8 * C))
    lin_bwd_bound = bound(((2 + C + 3) * N + TEX_SIZE * TEX_SIZE * C) * f32, N * (40 + 14 * C))
    b14_bound = bound((iargs9[0].numel() + vtbl9.numel() + 16 * N + 10 * n_valid9) * f32,
                      220 * n_valid9)
    da4_bound, da4_all_bound = scatter_bounds(N, 11, n_own9, n_aa9, n_part9, R9, 24,
                                              gcounts9.numel(), 4)[:2]
    # The mip level reads da's 4 rows and writes flevel (20 bytes a pixel),
    # ~30 operations; its vjp reads da and gfl and writes 4 rows of g_da
    # (36 bytes), ~90 operations with the footprint recomputed.
    level_bound = bound(5 * N * f32, 30 * N)
    vjp_bound = bound(9 * N * f32, 90 * N)

    # Standalone ops' backward: aa_bwd reads dy, colour (own and
    # neighbours'), id and 4 residuals, writes g_color, 2 rows and the dense
    # 18 pair columns, ~20 operations a pixel and ~60 a kept pair;
    # interp_bwd reads u, v, id, A cotangents and the table, writes 2 + 3A
    # rows, ~10A operations a pixel; table_take reads the ids and the table,
    # writes 9 rows; scatter_rows' chunks pass reads the ids and the K values
    # of the columns with an id in range, writes each partial (its id and K
    # float64 sums), K float64 adds a live column; in all, the partials are
    # read back once more and the [R, K] rows written; its second run, the
    # segment starts and the sums as grad_scatter's.
    aabwd_bound = bound((vtbl11.numel() + (2 * A + 5) * N + (A + 20) * N) * f32,
                        20 * N + 60 * n_kept)
    ibwd_bound = bound((atbl11.numel() + (3 + A) * N + (2 + 3 * A) * N) * f32, 10 * A * N)
    take_bound = bound((vtbl11.numel() + N + 9 * N) * f32, 0)
    spart = n_part11 * (4 + 8 * 9)
    srows_bound = bound((N + 9 * n_inrange11) * f32 + spart, 9 * n_live)
    srows_all_bound = bound((N + 9 * n_inrange11 + R11 * 9) * f32 + 2 * spart, 9 * n_live)
    scompact_bound = bound(2 * spart + scounts.numel() * 12, 0)
    sseg_bound = bound((n_part11 + R11 + 1) * f32, 0)
    ssum_bound = bound(n_part11 * 8 + spart + (R11 + 1 + R11 * 9) * f32, 9 * n_part11)

    # Cube sampler: reads finite of every pixel, and s, t, face, tz (flevel
    # under a mip filter; C cotangents in the backward) of the valid
    # directions only, the pyramid once; writes C channels (3 gradients)
    # of every pixel; ~(40 + 8C) operations a level read forward (corner
    # setup, the seam wrap of the corners off the face, the average-of-3
    # fill, the blend), ~(40 + 14C) backward.
    cvalid_words = n_cvalid * (4 + ("mipmap" in FILTER))
    cube_fwd_bound = bound((N + cvalid_words + n_ctex * 3 + 3 * N) * f32,
                           n_creads * (40 + 8 * 3))
    # The cube backward as texture() runs it, the joint tiles pass: it
    # reads the same pixel streams, C cotangents of the valid directions and
    # the pyramid once, writes 3 gradients of every pixel, the tile counts
    # and each (texel, tile) partial (its texel and C float64 sums); ~(40 +
    # 14C) operations a level read and ~16 a kept tap. In all, the partials
    # are also sorted (texels read, sorted texels and their order written)
    # and read back with their order, and the [n_texels, C] gradient written.
    # The second run moves the partials (read and write), the segment starts
    # read the sorted texels, the sums read each partial with its order.
    cent = 4 + 8 * 3
    n_ctiles = cpart[2].numel()
    cstream = (N + cvalid_words + 3 * n_cvalid + n_ctex * 3 + 3 * N + n_ctiles) * f32
    cube_bwd_bound = bound(cstream + n_cpart * cent, n_creads * (40 + 14 * 3) + n_ctaps * 16)
    cube_bwd_all_bound = bound(cstream + n_cpart * (cent + 16 + cent + 12) + n_ctex * 3 * f32,
                               n_creads * (40 + 14 * 3) + n_ctaps * 16 + n_cpart * 3)
    ccompact_bound = bound(2 * n_cpart * cent + n_ctiles * 12, 0)
    cseg_bound = bound((n_cpart + n_ctex + 1) * f32, 0)
    csum_bound = bound(n_cpart * (cent + 8) + (n_ctex + 1 + n_ctex * 3) * f32, n_cpart * 3)

    # -- 16. the rest of the rasterizer: peel, range, bands, binning -----------
    phase16_kernels = phase16(dev, card, entry)

    # -- 17. parallel: row bands and data parallelism in two ranks -------------
    phase17_kernels = phase17(dev, card, entry)

    # texture_bwd's rows also by device time (torch.profiler, after every
    # other phase: the profiler leaves later launches slower on the host);
    # `ms` and `library_ms` stay phase 9's CUDA-event times, which include
    # what the wrapper's host work adds when calls run back to back.
    texbwd_dev_ms, lin_bwd_dev_ms, texbwd_lib_dev_ms = (device_ms(fn, 50)[0] for fn in (
        lambda: txb.texture_bwd(*bargs9), lambda: txb.texture_bwd(*lbargs),
        lambda: library_bwd([False, True])))
    level_dev_ms, vjp_dev_ms = (device_ms(fn, 50)[0] for fn in (
        lambda: tx.mip_level(*largs7), lambda: tx.level_vjp(*vargs9)))
    log(f"[7] mip_level {RES}^2, device time a call: kernel {level_dev_ms:.4f} ms; "
        f"[9] level_vjp {vjp_dev_ms:.4f} ms (CUDA events: {level_ms:.4f}, {vjp_ms:.4f} ms) "
        f"({card})")
    log(f"[9] texture_bwd {RES}^2, device time a call: kernel {texbwd_dev_ms:.4f} ms, "
        f"linear+clamp {lin_bwd_dev_ms:.4f} ms, grid_sample backward to the grid "
        f"{texbwd_lib_dev_ms:.4f} ms (CUDA events in phase 9: {texbwd_ms:.4f}, "
        f"{lin_bwd_ms:.4f}, {texbwd_lib_ms:.4f} ms) ({card})")

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
              scatter_err, scatter_ms, partials_plain_ms, scatter_bound, scatter_lib_ms,
              scatter_all_ms, scatter_all_bound),
        entry("grad_scatter_compact", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535",
              fit_launches[pb.SCATTER_COMPACT_KERNEL.name], gcompact_err,
              st5["pass 2 (compact, tiles over the cap)"], partials_plain_ms, gcompact_bound,
              None),
        entry("grad_scatter_segments", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535",
              fit_launches[pb.SCATTER_SEGMENT_KERNEL.name], gseg_err, st5["segment starts"],
              scatter_plain_ms, gseg_bound, None),
        entry("grad_scatter_sum", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535",
              fit_launches[pb.SCATTER_SUM_KERNEL.name], scatter_err, st5["sums"],
              scatter_plain_ms, gsum_bound, None),
        entry("rasterize_db", "cuda", "nvdiffrast_tpu_torch/csrc/rasterize.cu",
              "nvdiffrast_tpu/ops/rasterize_pallas.py:1039", tex_launches[rc.DB_KERNEL.name],
              db_err, db_ms, db_plain_ms, db_bound, None),
        entry("interp_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/interpolate_fwd.cu",
              "nvdiffrast_tpu/ops/interpolate_pallas.py:84", tex_launches[ic.KERNEL.name],
              interp_err, interp_ms, interp_plain_ms, interp_bound, None),
        entry("mip_level", "cuda", "nvdiffrast_tpu_torch/csrc/mip_level.cu",
              "nvdiffrast_tpu/ops/texture.py:511", tex_launches[tc.LEVEL_KERNEL.name],
              level_err, level_ms, level_plain_ms, level_bound, None, device_ms=level_dev_ms),
        entry("texture_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_fwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", tex_launches[tc.KERNEL.name],
              tex_err, tex_ms, tex_plain_ms, tex_bound, None),
        entry("texture_fwd_linear_clamp", "cuda", "nvdiffrast_tpu_torch/csrc/texture_fwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", lin_launches[tc.KERNEL.name],
              lin_err, lin_ms, lin_plain_ms, lin_bound, tex_lib_ms),
        entry("aa_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/aa_fwd.cu",
              "nvdiffrast_tpu/ops/antialias_pallas.py:149", tex_launches[ac.KERNEL.name],
              aa_err, aa_ms, aa_plain_ms, aa_bound, None),
        entry("texture_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_bwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", ttrain_launches[txb.BWD_KERNEL.name],
              texbwd_err, texbwd_ms, texbwd_plain_ms, texbwd_bound, None,
              device_ms=texbwd_dev_ms),
        entry("texture_bwd_linear_clamp", "cuda", "nvdiffrast_tpu_torch/csrc/texture_bwd.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:894", lin_launches[txb.BWD_KERNEL.name],
              lin_bwd_err, lin_bwd_ms, lin_bwd_plain_ms, lin_bwd_bound, texbwd_lib_ms,
              device_ms=lin_bwd_dev_ms, library_device_ms=texbwd_lib_dev_ms),
        entry("texture_grad", "cuda", "nvdiffrast_tpu_torch/csrc/texture_grad.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179", ttrain_launches[txb.GRAD_KERNEL.name],
              ent_err9, texgrad_ms, entries_plain_ms, texgrad_bound, None),
        entry("texture_grad_compact", "cuda", "nvdiffrast_tpu_torch/csrc/texture_grad.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179",
              ttrain_launches[txb.GRAD_COMPACT_KERNEL.name], max(compact_err9, over_err9),
              st9["pass 2 (compact, tiles over the cap)"], entries_plain_ms, compact_bound,
              None),
        entry("texture_grad_segments", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179",
              ttrain_launches[txb.GRAD_SEGMENT_KERNEL.name], seg_err9, st9["segment starts"],
              texgrad_plain_ms, segments_bound, None),
        entry("texture_grad_sum", "cuda", "nvdiffrast_tpu_torch/csrc/texture_grad.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179",
              ttrain_launches[txb.GRAD_SUM_KERNEL.name], texgrad_err, st9["sums"],
              texgrad_plain_ms, sums_bound, None),
        entry("texture_grad_linear_clamp", "cuda", "nvdiffrast_tpu_torch/csrc/texture_grad.cu",
              "nvdiffrast_tpu/ops/lattice_scatter.py:179", lin_launches[txb.GRAD_KERNEL.name],
              lin_grad_err, lin_grad_ms, lin_grad_plain_ms, lin_grad_bound, texgrad_lib_ms),
        entry("level_vjp", "cuda", "nvdiffrast_tpu_torch/csrc/mip_level.cu",
              "nvdiffrast_tpu/ops/pipeline_tex.py:167",
              ttrain_launches[tc.LEVEL_VJP_KERNEL.name], vjp_err, vjp_ms, vjp_plain_ms,
              vjp_bound, None, device_ms=vjp_dev_ms),
        entry("interp_raster_bwd_tex", "cuda",
              "nvdiffrast_tpu_torch/csrc/interp_raster_bwd_tex.cu",
              "nvdiffrast_tpu/ops/pipeline_tex_pallas.py:113", ttrain_launches[ptb.KERNEL.name],
              b14_err, b14_ms, b14_plain_ms, b14_bound, None),
        entry("grad_scatter_da4", "cuda", "nvdiffrast_tpu_torch/csrc/grad_scatter.cu",
              "nvdiffrast_tpu/ops/pipeline_pallas.py:535",
              ttrain_launches[pb.SCATTER_KERNEL.name], da4_err, da4_ms, da4_plain_ms,
              da4_bound, da4_lib_ms, da4_all_ms, da4_all_bound),
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
              scatter_rows_err, srows_ms, chunks_plain_ms, srows_bound, srows_lib_ms,
              srows_all_ms, srows_all_bound),
        entry("scatter_rows_compact", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/scatter.py:84", ops_launches[scatter.COMPACT_KERNEL.name],
              scompact_err, st11["pass 2 (compact, tiles over the cap)"], chunks_plain_ms,
              scompact_bound, None),
        entry("scatter_rows_segments", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/scatter.py:84", ops_launches[scatter.SEGMENT_KERNEL.name],
              sseg_err, st11["segment starts"], srows_plain_ms, sseg_bound, None),
        entry("scatter_rows_sum", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/scatter.py:84", ops_launches[scatter.SUM_KERNEL.name],
              scatter_rows_err, st11["sums"], srows_plain_ms, ssum_bound, None),
        entry("texture_cube_fwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_cube.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:1392", cube_launches[tcc.FWD_KERNEL.name],
              cube_fwd_err, cube_fwd_ms, cube_fwd_plain_ms, cube_fwd_bound, None),
        entry("texture_cube_bwd", "cuda", "nvdiffrast_tpu_torch/csrc/texture_cube.cu",
              "nvdiffrast_tpu/ops/texture_pallas.py:1508", cube_launches[tcc.BWD_KERNEL.name],
              cube_bwd_err, st14["tiles pass 1"], cube_bwd_plain_ms + cparts_plain_ms,
              cube_bwd_bound, None, cjoint_ms, cube_bwd_all_bound),
        entry("texture_cube_grad_compact", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/scatter.py:84",
              cube_launches[tcc.GRAD_COMPACT_KERNEL.name], compact_err14,
              st14["pass 2 (compact, tiles over the cap)"], cparts_plain_ms, ccompact_bound,
              None),
        entry("texture_cube_grad_segments", "cuda", "nvdiffrast_tpu_torch/csrc/raster_bin.cu",
              "nvdiffrast_tpu/ops/scatter.py:84",
              cube_launches[tcc.GRAD_SEGMENT_KERNEL.name], seg_err14, st14["segment starts"],
              cgrad_plain_ms, cseg_bound, None),
        entry("texture_cube_grad_sum", "cuda", "nvdiffrast_tpu_torch/csrc/segment_sum.cu",
              "nvdiffrast_tpu/ops/scatter.py:84",
              cube_launches[tcc.GRAD_SUM_KERNEL.name], cube_grad_err, st14["sums"],
              cgrad_plain_ms, csum_bound, None),
    ] + phase16_kernels + phase17_kernels
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
