"""Step kind ``train``: closed-loop fitting steps on one device.

A step renders the batch's views through the configuration's call into
the port, takes the mean squared error against their targets, runs the
backward and an Adam step, and reads the loss; the next step starts
after that read. Set-up drives the first steps through the same call
(they are what the check compares) and a few more as warm-up.
"""

import time

import torch

from perfbench import check, faults, harness, training


def run(cell, args, t0, device):
    with faults.planted(getattr(args, "fault", None), cell):
        return _run(cell, args, t0, device)


def _run(cell, args, t0, device):
    trf = cell.traffic
    fit = training.Fitting(cell, args.seed, device)
    n_check = trf["checked_steps"]
    prog = fit.first_steps(fit.step, n_check)
    k0 = n_check
    for k in range(k0, k0 + trf["warmup_steps"]):
        fit.step(k)
    k0 += trf["warmup_steps"]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    start, end, times, losses = harness.timed_window(lambda k: fit.step(k0 + k),
                                                     args.seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    H, W = fit.resolution
    measured = {"kind": "train", "setup_s": setup_s, "window_s": end - start,
                "step_s": times, "pixels": len(times) * fit.B * H * W, "peak_bytes": peak}
    k0 += len(times)
    harness.log(f"setup {setup_s:.3f} s, window {end - start:.3f} s, {len(times)} steps")
    trace_data = None
    if args.trace:
        n = trf["trace_steps"]
        counter = iter(range(k0, k0 + n))
        trace = harness.profile_calls(lambda: fit.step(next(counter)), n)
        k0 += n
        syncs = [0]
        for k in range(k0, k0 + trf["sync_steps"]):
            fit.step(k, syncs=syncs)
        trace_data = {"kind": "train", "trace": trace, "steps": n,
                      "syncs_per_step": (syncs[0] / trf["sync_steps"]
                                         if device == "cuda" else None),
                      "shapes": fit.shapes(), "breakdown": harness.breakdown(trace)}
    failed = sum(1 for x in losses if not x == x or abs(x) == float("inf"))
    fit.release()
    t_ref = time.perf_counter()
    ref = training.reference(cell, fit, n_check, device)
    numbers = check.training_numbers(prog, ref)
    harness.log(f"leaf norms (grad prog, ref; change prog, ref) {check.leaf_norms(prog, ref)}")
    harness.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    return {"measured": measured, "trace": trace_data, "numbers": numbers,
            "attempted": len(times), "failed": failed, "peak_bytes": peak}
