"""Step kind ``dp``: the training step of ``train`` on every rank, one
rank a device, with different views on each, through the port's
data-parallel step (``parallel.shard.shard_map_train_step``: the
gradients and the loss averaged over the ranks in one all-reduce).

The kernel library is built once here, before the ranks start; the
ranks meet through a file store in a fresh directory under TMPDIR and
stop together when rank 0's window has run its seconds. Rank 0 reports.
"""

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time

from perfbench import harness, ranks

JOIN_S = 900  # the longest a rank may take, set-up and reference included


def run(cell, args, t0, device):
    """One run (rank 0's result); with ``args.jobs`` [(seed, fault)] one
    run per job in one process group, and the list of their results."""
    world = int(cell.traffic["ranks"])
    if device == "cuda":
        from nvdiffrast_tpu_torch import _build

        _build.build()
    wall0 = time.time() - (time.perf_counter() - t0)
    jobs = getattr(args, "jobs", None) or [(args.seed, getattr(args, "fault", None))]
    tmp = tempfile.mkdtemp(prefix="perfbench_rdzv_", dir=os.environ.get("TMPDIR"))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=ranks.worker,
                         args=(cell.name, args, jobs, r, world, "file://" + os.path.join(tmp, "store"),
                               wall0, device, q))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results = {}
        deadline = time.time() + JOIN_S
        while len(results) < world:
            try:
                r, res = q.get(timeout=5)
            except queue_mod.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise harness.BenchError("a rank ended without a result")
                continue
            if isinstance(res, str):
                raise harness.BenchError(f"rank {r} failed:\n{res}")
            results[r] = res
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    found = sorted({m for res in results.values() for job in res for m in job["forbidden"]})
    if found:
        raise harness.BenchError(f"forbidden modules loaded by a rank: {', '.join(found)}")
    return results[0] if getattr(args, "jobs", None) else results[0][0]
