"""One rank of a data-parallel cell (step kind ``dp``), started by
``kinds/dp.py`` in a process of its own (spawned, so it imports this
module by name)."""

import time
import traceback

import torch
import torch.distributed as dist

from perfbench import check, faults, harness, training


def worker(workload, args, jobs, rank, world, init, wall0, device, queue):
    """Run rank `rank` over jobs [(seed, fault)] in one process group and
    put (rank, [result dict per job] or error text) on queue."""
    try:
        from nvdiffrast_tpu_torch import parallel

        torch.set_num_threads(4)
        cell = harness.Cell(workload)
        dev_type = "cuda" if device == "cuda" else "cpu"
        parallel.multihost.initialize(init_method=init, world_size=world, rank=rank,
                                      device_type=dev_type, timeout_s=600)
        ctl = dist.new_group(backend="gloo")
        mesh = parallel.make_mesh((world,), ("dp",), dev_type)
        out = []
        for seed, fault in jobs:
            args.seed = seed
            with faults.planted(fault, cell):
                out.append(_rank(cell, args, rank, world, wall0, dev_type, ctl, mesh))
        dist.barrier(group=ctl)
        found = harness.forbidden_modules()
        dist.destroy_process_group()
        for res in out:
            res["forbidden"] = found
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def _allreduce(tensors):
    """Sum a list of tensors of one dtype over the ranks in place, in one
    collective (the reference's gradient sum)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()


def _rank(cell, args, rank, world, wall0, dev_type, ctl, mesh):
    """One run of the cell on this rank; rank 0's result is the run's."""
    from nvdiffrast_tpu_torch import parallel

    trf = cell.traffic
    dev = torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda" else "cpu"
    fit = training.Fitting(cell, args.seed, dev, stream=rank)
    hold = {"keep": None}
    dp_step = parallel.shard_map_train_step(lambda k: fit.loss(k, hold["keep"]), fit.opt, mesh)

    def step(k, keep=None, syncs=None):
        hold["keep"] = keep
        with harness.sync_counter(syncs):
            loss = dp_step(k)
        hold["keep"] = None
        return loss.item()

    n_check = trf["checked_steps"]
    prog = fit.first_steps(step, n_check)
    k0 = n_check
    for k in range(k0, k0 + trf["warmup_steps"]):
        step(k)
    k0 += trf["warmup_steps"]
    if dev_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier(group=ctl)
    setup_s = time.time() - wall0
    start = time.perf_counter()
    times, losses = [], []
    flag = torch.zeros(1, dtype=torch.int32)
    while True:
        t0 = time.perf_counter()
        losses.append(step(k0 + len(times)))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        flag[0] = int(t1 - start >= args.seconds)
        dist.broadcast(flag, 0, group=ctl)
        if flag.item():
            break
    end = time.perf_counter()
    peak = torch.tensor([torch.cuda.max_memory_allocated() if dev_type == "cuda" else 0],
                        dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=ctl)
    H, W = fit.resolution
    measured = {"kind": "dp", "setup_s": setup_s, "window_s": end - start, "step_s": times,
                "pixels": len(times) * fit.B * H * W * world, "peak_bytes": float(peak)}
    k0 += len(times)
    if rank == 0:
        harness.log(f"setup {setup_s:.3f} s, window {end - start:.3f} s, {len(times)} steps")
    trace_data = None
    if args.trace:
        n = trf["trace_steps"]
        counter = iter(range(k0, k0 + n))
        trace = harness.profile_calls(lambda: step(next(counter)), n)
        k0 += n
        syncs = [0]
        for k in range(k0, k0 + trf["sync_steps"]):
            step(k, syncs=syncs)
        w0, w1 = trace["window_us"]
        busy = torch.tensor([harness.busy_us(trace) * 1e-6], dtype=torch.float64)
        dist.all_reduce(busy, group=ctl)
        trace_data = {"kind": "dp", "trace": trace, "steps": n,
                      "syncs_per_step": (syncs[0] / trf["sync_steps"]
                                         if dev_type == "cuda" else None),
                      "shapes": fit.shapes(world), "breakdown": harness.breakdown(trace),
                      "device": {"busy_s": float(busy) / world, "window_s": (w1 - w0) * 1e-6}}
    failed = sum(1 for x in losses if not x == x or abs(x) == float("inf"))
    # Every rank ends the checked steps with the same parameters: rank 0's
    # against each rank's, exactly.
    theirs = {k: p.clone() for k, p in prog["params"].items()}
    for p in theirs.values():
        dist.broadcast(p, 0)
    spread = torch.tensor([max(float((prog["params"][k] - theirs[k]).abs().max())
                               for k in theirs)], dtype=torch.float64)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX, group=ctl)
    fit.release()
    t_ref = time.perf_counter()
    ref = training.reference(cell, fit, n_check, dev, allreduce=_allreduce, n_ranks=world)
    numbers = check.training_numbers(prog, ref)
    if rank == 0:
        harness.log(f"leaf norms (grad prog, ref; change prog, ref) {check.leaf_norms(prog, ref)}")
    if rank == 0:
        harness.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    numbers["rank_gap"] = float(spread)
    if rank != 0:
        return {}
    return {"measured": measured, "trace": trace_data, "numbers": numbers,
            "attempted": len(times), "failed": failed, "peak_bytes": float(peak),
            "device_kind": torch.cuda.get_device_name(dev) if dev_type == "cuda" else None}
