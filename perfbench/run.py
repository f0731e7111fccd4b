"""The benchmark of nvdiffrast_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds BENCHMARK.json, perfbench/ and
the package. Builds the cell's scene and inputs from the seed, warms up,
measures for S seconds, checks what the timed path produced against the
plain reference, and prints one JSON line last on standard output (with
--trace 1 the per-layer metrics, read from a profile of a few steady
steps after the window). Exits non-zero, printing no result, without the
CUDA devices the cell asks for or when a forbidden module is loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device="cuda", t0=None, fault=None):
    """Run one cell; `device` "cpu" runs the port's plain twins and
    `fault` plants one of ``faults.py``'s (tests and calibration)."""
    from perfbench import harness

    args = parse(argv)
    args.fault = fault
    harness.cache_dirs()
    cell = harness.Cell(args.workload)
    import torch

    torch.set_num_threads(4)
    if device == "cuda":
        dev = harness.device_info(torch, cell.chips, name=cell.chips == 1)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    out = cell.kind.run(cell, args, _T0 if t0 is None else t0, device)
    found = harness.forbidden_modules()
    if found:
        raise harness.BenchError(f"forbidden modules loaded: {', '.join(found)}")
    dev["memory_peak_bytes"] = int(out["peak_bytes"])
    if out.get("device_kind"):
        dev["kind"] = out["device_kind"]
    trace = out["trace"]
    if trace is not None:
        dev.update(trace.get("device", {}))
        if "busy_s" not in dev and trace["trace"] is not None:
            dev["busy_s"] = harness.busy_us(trace["trace"]) * 1e-6
            w0, w1 = trace["trace"]["window_us"]
            dev["window_s"] = (w1 - w0) * 1e-6
    checks, ok = harness.judge(cell, out["numbers"])
    line = harness.result_line(cell, out["measured"], trace, checks, ok and out["failed"] == 0,
                               dev, out["attempted"], out["failed"])
    harness.emit(line)
    return line


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except Exception as e:  # the boundary of the run: report, print no result
        import traceback

        traceback.print_exc()
        print(f"perfbench: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
