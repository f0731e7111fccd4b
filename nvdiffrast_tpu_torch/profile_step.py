"""Where the time of one training step of render_pipeline goes, on a GPU.

    python -m nvdiffrast_tpu_torch.profile_step [--res 2048] [--steps 16]
        [--textured | --ops | --cube | --reductions | --texture]

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
With --texture it times no step but the 2-D sampler's kernels on the
textured step's own inputs (the bench textured scene, the colour
cotangent of mean(img**2)): texture_bwd (B11's backward) and
texture_fwd in linear-mipmap-linear + wrap and in linear + clamp on the
base level, and F.grid_sample and its backward to the grid, the PyTorch
calls for linear + clamp. Each case prints the same median CUDA-event
time, the device time a call and the bytes bound (inputs read once,
outputs written once, at 3.35 TB/s). It calls only entry points the
package has had since commit 54206d4, so it too runs in an older
checkout.
Prints:
  0. with --cube, the cube texture gradient's partials, its device time
     and device ops a call and host syncs, beside the earlier design's,
     then the gradient with a first-pass scratch of 0 (count, then
     write), 64, 256 (the wrappers' CUBE_CAP), 512 and 1,024 partials a
     tile: device time, CUDA-event time, peak memory, tiles run twice;
  1. ms/step: the wall time of a window of --steps steps under
     torch.profiler, synchronised at its end, over the steps;
  2. the port's spans (``nvdr.*``, ``utils/trace.py``) in that window:
     each span's count a step, its host ms a step, and its host ms
     outside the spans nested in it (its own glue and launches);
  3. the same window's device kernels and device time per step, the
     device's busy share of the window, and the kernels with the most
     device time;
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
from .ops import pipeline as pl
from .ops import pipeline_bwd_cuda as pb
from .ops import pipeline_tex as ptx
from .ops import pipeline_tex_bwd_cuda as ptb
from .ops import rasterize as ra
from .ops import scatter
from .ops import texture as tx
from .ops import texture_bwd_cuda as tb
from .ops import texture_cuda as tc
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("nvdr.")]
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


def _training(pos, tri, cidx, col, res):
    """A render_pipeline training step."""

    def step():
        p = pos.detach().requires_grad_()
        c = col.detach().requires_grad_()
        img = pl.render_pipeline(p, tri, c, res, attr_idx=cidx)
        return torch.autograd.grad((img ** 2).mean(), (p, c))

    return step


def _ops(pos, tri, cidx, col, res):
    """A training step of the composed standalone ops."""

    def step():
        p = pos.detach().requires_grad_()
        c = col.detach().requires_grad_()
        rast, _ = ra.rasterize(None, p, tri, res, grad_db=False)
        color, _ = interpolate(c, rast, cidx)
        img = aa.antialias(color, rast, p, tri)
        return torch.autograd.grad((img ** 2).mean(), (p, c))

    return step


def _textured(pos, tri, cidx, vtxp, res):
    """A render_pipeline_textured training step."""
    uv, tex, mode = _textured_inputs(pos, vtxp)

    def step():
        xs = [x.detach().requires_grad_() for x in (pos, uv, tex)]
        img = ptx.render_pipeline_textured(xs[0], tri, xs[1], xs[2], res, uv_tri=cidx,
                                           filter_mode=mode[0], boundary_mode=mode[1])
        return torch.autograd.grad((img ** 2).mean(), xs)

    return step


def _textured_inputs(pos, vtxp):
    """(uv, tex, (filter, boundary)) of bench.py's textured line: spherical
    uvs of the bench sphere, a 512x512x3 texture from rand seed 0."""
    dev = pos.device
    uv = torch.as_tensor(np.stack(
        [np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
         np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi], axis=1),
        dtype=torch.float32, device=dev)
    tex = torch.as_tensor(np.random.RandomState(0).rand(1, 512, 512, 3),
                          dtype=torch.float32, device=dev)
    return uv, tex, ("linear-mipmap-linear", "wrap")


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
    """An envphong-shaped step with a 512^2 cube map; prints section 0."""
    from .models.fit_envphong import shade
    from .ops import segments
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
    flat, cols, meta = _cube_taps(env, d, dd)[2:]
    n_tex, shape, mode = flat.shape[0], (1,) + tuple(res), "linear-mipmap-linear"
    dy = torch.full((3, N), 1e-7, device=dev)  # _cube_taps' cotangent
    # The tiles pass's first run and its partials' total, as
    # segments.tile_partials runs them.
    launch, n_tiles, C, cap = tcc.cube_tiles(None, cols, dy, meta, mode, shape)
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    key_s = torch.empty((n_tiles * cap,), dtype=torch.int32, device=dev)
    part_s = torch.empty((n_tiles * cap, C), dtype=torch.float64, device=dev)
    launch(None, counts, key_s, part_s, None, None)
    E = int(torch.cumsum(counts, 0, dtype=torch.int64)[-1])

    def earlier():  # the earlier cube_texture_grad: the taps' glue, then B10
        tid, w = tcc.cube_grad_entries(cols, meta, mode)
        return scatter.scatter_add_by_id(tid, (dy.repeat(1, w.shape[0] // N) * w).contiguous(),
                                         n_tex)

    new_ms, new_ops = _device_ms(lambda: tcc.cube_texture_grad(cols, dy, meta, n_tex, mode,
                                                               shape), 10)
    old_ms, old_ops = _device_ms(earlier, 5)
    print(f"[0] cube texture gradient {res[0]}^2: {E} (texel, tile) partials, "
          f"{int((counts > 0).sum())} tiles with taps, {int((counts > cap).sum())} over the "
          f"scratch of {cap} a tile; device time a call {new_ms:.4f} ms in {new_ops:.0f} device "
          f"ops, {host_syncs(lambda: tcc.cube_texture_grad(cols, dy, meta, n_tex, mode, shape))} "
          f"host sync(s); the earlier design (taps glue + B10) {old_ms:.4f} ms in "
          f"{old_ops:.0f} ops ({_card()})", flush=True)
    for c in (0, 64, 256, 512, 1024):  # the scratch: count-then-write (0) or c slots a tile
        def at_cap(c=c):
            k, p, _ = segments.tile_partials(*tcc.cube_tiles(None, cols, dy, meta, mode, shape,
                                                             cap=c), dev, "cube")
            return segments.row_sums(k, p, n_tex, tcc.GRAD_SEGMENT_KERNEL, tcc.GRAD_SUM_KERNEL)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        at_cap()
        torch.cuda.synchronize()
        mib = (torch.cuda.max_memory_allocated() - m0) / 2 ** 20
        print(f"[0] cube texture gradient, scratch of {c} a tile: device time a call "
              f"{_device_ms(at_cap, 5)[0]:.4f} ms, CUDA events {_event_ms(at_cap, 10):.4f} ms, "
              f"peak {mib:.1f} MiB, {int((counts > c).sum())} tiles run twice", flush=True)
    return step


def _texture_inputs(pos, tri, cidx, vtxp, res):
    """The 2-D sampler's calls on the bench textured scene: (texture_bwd
    args, linear + clamp args on the base level, grid_sample's (input,
    grid, colour cotangent))."""
    uv, tex, mode = _textured_inputs(pos, vtxp)
    H, W = res
    N, T, C = H * W, tri.shape[0], 3
    shape = (1, H, W)
    img, saved, meta = ptx._ptex_fwd_core(pos, uv, tex, tri, cidx, build_opposite_table(tri),
                                          res, *mode, -1)
    idf = saved[2]
    uvc, _, fl, flat, color = saved[7:12]
    img = img.detach().requires_grad_()
    dy = torch.autograd.grad((img ** 2).mean(), img)[0].reshape(N, C).T.contiguous()
    gc = ptb.aa_bwd_slim(dy, color, idf, saved[12:16], shape, T)[0]

    bargs = (flat, uvc[0], uvc[1], fl, gc, meta, shape, False, *mode[::-1])
    largs = (flat[:512 * 512], uvc[0], uvc[1], fl, gc, meta[:1], shape, False, "clamp",
             "linear")
    grid = (uvc.T.reshape(1, H, W, 2) * 2.0 - 1.0).contiguous()
    return bargs, largs, (tex.permute(0, 3, 1, 2).contiguous(), grid,
                                 gc.reshape(1, C, H, W).contiguous())


def _texture_calls(pos, tri, cidx, vtxp, res):
    """[(case, fn, iters, bound ms)]: the 2-D sampler's calls of --texture."""
    bargs, largs, (base, grid, gout) = _texture_inputs(pos, tri, cidx, vtxp, res)
    N, C, n_base = res[0] * res[1], 3, 512 * 512

    def ms(words):
        return words * 4 / 3.35e12 * 1e3

    n_tex = bargs[0].shape[0]
    return [
        ("texture_bwd, trilinear + wrap", lambda: tb.texture_bwd(*bargs), 50,
         ms((3 + C + 3) * N + n_tex * C)),
        ("texture_bwd, linear + clamp, base level", lambda: tb.texture_bwd(*largs), 50,
         ms((2 + C + 3) * N + n_base * C)),
        ("grid_sample backward to the grid", lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, base, grid, 0, 1, False, [False, True]), 50, ms((2 + C + 2) * N + n_base * C)),
        ("texture_fwd, trilinear + wrap", lambda: tc.sample(*bargs[:4], *bargs[5:]), 50,
         ms((3 + C) * N + n_tex * C)),
        ("texture_fwd, linear + clamp, base level", lambda: tc.sample(*largs[:4], *largs[5:]),
         50, ms((2 + C) * N + n_base * C)),
        ("F.grid_sample", lambda: torch.nn.functional.grid_sample(
            base, grid, mode="bilinear", padding_mode="border", align_corners=False), 50,
         ms((2 + C) * N + n_base * C)),
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
    ap.add_argument("--texture", action="store_true",
                    help="time the 2-D texture sampler's kernels alone instead")
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
    if args.texture:
        calls = _texture_calls(pos, tri, cidx, vtxp, res)
        event = [_event_ms(fn, iters) for _, fn, iters, _ in calls]
        for (case, fn, iters, bound_ms), ev in zip(calls, event):
            dev_ms = _device_ms(fn, iters)[0]
            print(f"[t] {case} {args.res}^2: {ev:.4f} ms, device time {dev_ms:.4f} ms a "
                  f"call, bytes bound {bound_ms:.4f} ms ({card})", flush=True)
        return
    if args.textured:
        what = "textured fwd+bwd"
        step = _textured(pos, tri, cidx, vtxp, res)
    elif args.cube:
        what = "envphong-shaped cube-map fwd+bwd"
        step = _cube(pos, tri, vtxp, res)
    elif args.ops:
        what = "composed ops fwd+bwd"
        step = _ops(pos, tri, cidx, col, res)
    else:
        what = "fwd+bwd"
        step = _training(pos, tri, cidx, col, res)

    # -- the profiled window: sections 1, 2 and 3 -----------------------------
    from torch.profiler import DeviceType, ProfilerActivity, profile

    for _ in range(4):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    step_ms = wall * 1e3 / args.steps
    print(f"[1] {what} {args.res}^2: {step_ms:.3f} ms/step, "
          f"{args.res ** 2 / 1e3 / step_ms:.2f} Mpix/s (profiled window; {card})", flush=True)

    spans = span_table([e for e in events if e.device_type != DeviceType.CUDA])
    print(f"[2] the port's spans a step: count, host ms (inclusive), host ms outside nested "
          f"spans ({card})", flush=True)
    for name, (n, incl, own) in sorted(spans.items(), key=lambda kv: -kv[1][2]):
        print(f"[2]   {n / args.steps:5.1f}x  {incl / 1e3 / args.steps:8.3f}  "
              f"{own / 1e3 / args.steps:8.3f}  {name}", flush=True)

    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in spans]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"[3] profiled {args.steps} steps: {len(kernels) / args.steps:.1f} device "
          f"ops and {dev_us / 1e3 / args.steps:.3f} ms device time per step; busy "
          f"{dev_us / 1e6 / wall * 100:.1f} % of the window ({card})", flush=True)
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


def span_table(host_events):
    """{span: (count, inclusive us, us outside nested spans)} of the
    port's spans (``nvdr.*``) among torch.profiler's host events."""
    spans = sorted(((e.time_range.start, -e.time_range.end, e.name, e.thread)
                    for e in host_events if e.name.startswith("nvdr.")))
    out, open_ = {}, {}
    for start, neg_end, name, thread in spans:
        stack = open_.setdefault(thread, [])
        while stack and -stack[-1][0] <= start:
            stack.pop()
        n, incl, own = out.get(name, (0, 0.0, 0.0))
        out[name] = (n + 1, incl - neg_end - start, own - neg_end - start)
        if stack:  # the parent's own time loses this span's
            parent = stack[-1][1]
            pn, pincl, pown = out[parent]
            out[parent] = (pn, pincl, pown + neg_end + start)
        stack.append((neg_end, name))
    return out


if __name__ == "__main__":
    main()
