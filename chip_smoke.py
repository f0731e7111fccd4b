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
     frame and Mpix/s, and the twins' at 512^2.
It prints one JSON line of per-kernel results and, last, the device
line. Any failed check raises, so the exit code is not 0. Without a
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
    from nvdiffrast_tpu_torch.ops import pipeline_cuda as pc
    from nvdiffrast_tpu_torch.ops import rasterize_cuda as rc
    from nvdiffrast_tpu_torch.ops.antialias import _build_tables
    from nvdiffrast_tpu_torch.ops.topology import build_opposite_table
    from nvdiffrast_tpu_torch.utils.convert import inputs_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    card = card_line()
    log(f"[1] device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
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

    kernels = [
        {"name": "rasterize", "route": "cuda",
         "source": "nvdiffrast_tpu_torch/csrc/rasterize.cu",
         "replaces": "nvdiffrast_tpu/ops/rasterize_pallas.py:1039",
         "launches": launches["rasterize"], "max_abs_err": raster_err,
         "ms": raster_ms, "plain_ms": raster_plain_ms},
        {"name": "shade_fwd", "route": "cuda",
         "source": "nvdiffrast_tpu_torch/csrc/shade_fwd.cu",
         "replaces": "nvdiffrast_tpu/ops/pipeline_pallas.py:74",
         "launches": launches["shade_fwd"], "max_abs_err": shade_err,
         "ms": shade_ms, "plain_ms": shade_plain_ms},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
