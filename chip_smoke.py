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
     colours and a pose offset to a target render, the loss falling.
It prints one JSON line of per-kernel results (with each kernel's
bound: the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s) and, last, the device line. Any failed check raises, so the exit code is not 0. Without a
CUDA device, or without the package beside it, it fails at once.
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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nvdiffrast_tpu_torch import _build
    from nvdiffrast_tpu_torch.ops import pipeline as pl
    from nvdiffrast_tpu_torch.ops import pipeline_bwd_cuda as pb
    from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
    from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
    from nvdiffrast_tpu_torch.ops.antialias import _build_tables
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
