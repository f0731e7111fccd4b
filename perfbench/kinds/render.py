"""Step kind ``render``: closed-loop forward calls without gradients.

A call renders the batch's views through the configuration's call into
the port under ``torch.no_grad()`` and ends with a device-side sum of
each view's image and its read. Every call of the window is checked by
those sums against the reference's. One call of the window, drawn from
the seed, is made again once the window and its peak have been read, and
its images are compared pixel by pixel: keeping them through the window
would count memory that no deployment holds.
"""

import time

import numpy as np
import torch

from perfbench import check, faults, harness, scene as sc, training
from perfbench.ref import train as ref_train

N_BATCHES = training.N_BATCHES


def run(cell, args, t0, device):
    with faults.planted(getattr(args, "fault", None), cell):
        return _run(cell, args, t0, device)


def _run(cell, args, t0, device):
    cfg, trf = cell.config, cell.traffic
    H, W = trf["resolution"]
    B, P = trf["views_per_call"], trf["pool"]
    scene = cell.config_module.build(cfg, args.seed, device)
    params = {k: p.detach() for k, p in scene["params"].items()}
    rng = np.random.default_rng([int(args.seed), 3, 0])
    views = torch.as_tensor(sc.view_matrices(cfg["camera"], P, rng), device=device)
    batches = sc.batch_order(args.seed * 5, P, B, N_BATCHES)
    order = torch.as_tensor(batches, device=device)
    sums = []

    def call(k, keep=None, syncs=None):
        with torch.no_grad():
            with harness.sync_counter(syncs):
                img = cell.config_module.render(scene, params, views[order[k % N_BATCHES]],
                                                (H, W))
            s = img.sum(dim=(1, 2, 3), dtype=torch.float64)
            sums.append((k, s.cpu()))
            if keep is not None:
                keep.append(img)

    for k in range(trf["warmup_calls"]):
        call(k)
    k0 = trf["warmup_calls"]
    sampled = int(np.random.default_rng([int(args.seed), 13]).integers(trf["sample_within"]))
    sums.clear()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    start, end, times, _ = harness.timed_window(lambda k: call(k0 + k), args.seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    window_sums = list(sums)
    measured = {"kind": "render", "setup_s": setup_s, "window_s": end - start,
                "step_s": times, "pixels": len(times) * B * H * W, "peak_bytes": peak}
    k0 += len(times)
    harness.log(f"setup {setup_s:.3f} s, window {end - start:.3f} s, {len(times)} calls")
    trace_data = None
    if args.trace:
        n = trf["trace_calls"]
        counter = iter(range(k0, k0 + n))
        trace = harness.profile_calls(lambda: call(next(counter)), n)
        k0 += n
        syncs = [0]
        for k in range(k0, k0 + trf["sync_calls"]):
            call(k, syncs=syncs)
        trace_data = {"kind": "render", "trace": trace, "steps": n,
                      "syncs_per_step": (syncs[0] / trf["sync_calls"]
                                         if device == "cuda" else None),
                      "shapes": training.shapes(cfg, scene, B, (H, W)),
                      "breakdown": harness.breakdown(trace)}
    if len(times) <= sampled:
        raise harness.BenchError(f"the window made {len(times)} calls; the sampled call "
                                 f"is {sampled}")
    kept = []
    call(trf["warmup_calls"] + sampled, keep=kept)
    prog_images = kept[0]
    arrays = scene["arrays"]
    del scene, kept
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = cell.ref_module
    mesh = ref.mesh(arrays, device)
    t_ref = time.perf_counter()
    ref_sums = {}
    first = trf["warmup_calls"]
    sampled_views = batches[(first + sampled) % N_BATCHES]
    ref_images = []
    for p in range(P):
        img = ref_train.render_views(ref, mesh, params, cfg, [p], views, (H, W),
                                     torch.float64, torch.float64)[0]
        ref_sums[p] = float(img.sum())
        if p in sampled_views:
            ref_images.append((p, img))
        del img
    ref_stack = torch.stack([dict(ref_images)[p] for p in sampled_views])
    gaps, failed = [], 0
    limit = cell.limits.get("sum_gap")
    for k, s in window_sums:
        idx = batches[k % N_BATCHES]
        g = max(abs(float(s[i]) - ref_sums[p]) / abs(ref_sums[p]) for i, p in enumerate(idx))
        gaps.append(g)
        failed += int(limit is None or not g <= limit)
    numbers = {"sum_gap": max(gaps), "image_gap": check.image_gap(prog_images, ref_stack)}
    harness.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    return {"measured": measured, "trace": trace_data, "numbers": numbers,
            "attempted": len(times), "failed": failed, "peak_bytes": peak}
