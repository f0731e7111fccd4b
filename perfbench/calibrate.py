"""Readings that set the limits of a cell's checks (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,... \\
        --fault-seeds 7,8,9 [--seconds 1] [--out FILE]

Runs the cell as the benchmark does, with a short window, once per
sound seed, then once per fault seed under each fault and the precision
control of ``faults.py`` that the cell's kind can have, all in one
process (the data-parallel kind: one process group). Prints each
check's readings and writes them as JSON: the lower reading of a check
is the largest over the sound seeds, its upper reading the smallest
over a fault's seeds.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="comma list; default all of the kind's")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seconds", type=float, default=15.0,
                    help="window of the control runs, whose reference render is slow")
    ap.add_argument("--out", default="")
    ap.add_argument("--write-limits", action="store_true",
                    help="write limits/<workload>.json by the rule in limit_between")
    a = ap.parse_args(argv)
    from perfbench import faults, harness, run

    cell = harness.Cell(a.workload)
    kind = cell.traffic["kind"]
    seeds = [int(s) for s in a.seeds.split(",") if s]
    fseeds = [int(s) for s in a.fault_seeds.split(",") if s]
    names = [f for f in a.faults.split(",") if f] or list(faults.KINDS[kind])
    jobs = [(s, None) for s in seeds] + [(s, f) for f in names for s in fseeds]
    t = time.time()
    rows = []
    import torch
    if kind == "dp":
        args = run.parse(["--workload", a.workload, "--seed", "0", "--seconds",
                          str(a.seconds)])
        args.jobs = jobs
        if device == "cuda":
            harness.device_info(torch, cell.chips, name=False)
        for (seed, fault), res in zip(jobs, cell.kind.run(cell, args, time.perf_counter(),
                                                          device)):
            rows.append({"seed": seed, "fault": fault, "numbers": res["numbers"]})
    else:
        for seed, fault in jobs:
            secs = a.control_seconds if fault == "control" else a.seconds
            try:
                line = run.main(["--workload", a.workload, "--seed", str(seed), "--seconds",
                                 str(secs)], device=device, fault=fault,
                                t0=time.perf_counter())
            except Exception as e:  # a fault or control that crashes gives no number
                if fault is None:
                    raise
                harness.log(f"{fault} on seed {seed} gave no number: {type(e).__name__}: {e}")
                if device == "cuda":
                    torch.cuda.empty_cache()
                continue
            rows.append({"seed": seed, "fault": fault,
                         "numbers": {k: v["value"] for k, v in line["checks"].items()}})
    summary = {}
    for name in rows[0]["numbers"]:
        sound = [r["numbers"][name] for r in rows if r["fault"] is None]
        s = {"lower": max(sound), "sound": sound}
        for f in names:
            vals = [r["numbers"][name] for r in rows if r["fault"] == f]
            if vals:
                s[f] = {"min": min(vals), "all": vals}
        summary[name] = s
    out = {"workload": a.workload, "seconds_taken": time.time() - t, "rows": rows,
           "summary": summary}
    limits = {}
    for name, s in summary.items():
        s["upper"], s["limit"] = limit_between(name, s, names)
        limits[name] = s["limit"]
        print(f"{name}: lower {s['lower']!r}; " + "; ".join(
            f"{f} min {s[f]['min']!r}" for f in names if f in s)
            + f"; upper {s['upper']!r}; limit {s['limit']!r}", flush=True)
    if a.write_limits:
        (cell.here / "limits" / f"{a.workload}.json").write_text(json.dumps(limits, indent=1)
                                                                 + "\n")
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(a.out).write_text(json.dumps(out, indent=1))
    return out


def limit_between(name, s, faults):
    """(upper reading, limit) of one check from its readings.

    The upper reading is the least of the control's (where it is three
    times the lower or more) and each fault's that is ten times the lower
    or more (the frozen state: three times). The limit lies between, in
    log scale two thirds of the way up: more room above the lower reading,
    which fresh seeds exceed, than below the upper. A number read exactly
    (lower 0 and every fault above 0) has the limit 0; one with no upper
    reading gets none (None), and the run cannot be correct."""
    lower = s["lower"]
    ups = [s[f]["min"] for f in faults if f in s
           and s[f]["min"] >= (3 if f in ("control", "frozen") else 10) * lower
           and s[f]["min"] > 0]
    if not ups:
        return None, None
    upper = min(ups)
    if lower == 0:
        return upper, 0.0
    return upper, float(f"{lower ** (1 / 3) * upper ** (2 / 3):.2g}")


if __name__ == "__main__":
    main(sys.argv[1:])
