"""A throwaway checkout for the CPU tests: this benchmark's files, the
package, and a BENCHMARK.json of tiny cells whose configurations, mixes
and limits are new files beside the real ones (nothing is edited)."""

import json
import os
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4, "image_gap": 1e-4,
               "sum_gap": 1e-5, "rank_gap": 0.0}


def make_checkout(root, ranks=2):
    """Build the checkout under `root`; returns its path."""
    root = pathlib.Path(root)
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "nvdiffrast_tpu_torch", root / "nvdiffrast_tpu_torch")
    cfgs = root / "perfbench" / "configs"
    for real, tiny, changes in (
            ("sphere_vcolor", "tiny_vcolor", {"mesh": {"kind": "uv_sphere", "n_lat": 6,
                                                       "n_lon": 10}}),
            ("earth_textured", "tiny_earth", {"mesh": {"kind": "uv_sphere", "n_lat": 6,
                                                       "n_lon": 10},
                                              "texture": {"height": 24, "width": 32,
                                                          "channels": 3},
                                              "max_mip_level": 3})):
        cfg = json.loads((cfgs / f"{real}.json").read_text())
        cfg.update(changes)
        cfg["name"] = tiny
        (cfgs / f"{tiny}.json").write_text(json.dumps(cfg))
        shutil.copy(cfgs / f"{real}.py", cfgs / f"{tiny}.py")
        shutil.copy(cfgs / f"{real}_ref.py", cfgs / f"{tiny}_ref.py")
    trf = root / "perfbench" / "traffic"
    for real, tiny, changes in (("train.2048x8", "train.tiny", {}),
                                ("render.2048x16", "render.tiny", {"views_per_call": 3}),
                                ("dp4.train.2048x8", "dp.train.tiny", {"ranks": ranks})):
        t = json.loads((trf / f"{real}.json").read_text())
        t.update({"resolution": [40, 48], "pool": 5, "trace_steps": 2, "trace_calls": 2,
                  "sync_steps": 1, "sync_calls": 1, "sample_within": 3})
        if "views_per_step" in t:
            t["views_per_step"] = 2
        t.update(changes)
        (trf / f"{tiny}.json").write_text(json.dumps(t))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] += [dict(c, name=tiny, file=f"perfbench/configs/{tiny}.json")
                         for c, tiny in zip(bench["configs"], ("tiny_vcolor", "tiny_earth"))]
    cells = [("tiny.vcolor.train", "tiny_vcolor", "train.tiny", "train"),
             ("tiny.earth.train", "tiny_earth", "train.tiny", "train"),
             ("tiny.earth.render", "tiny_earth", "render.tiny", "render"),
             ("tiny.earth.dp", "tiny_earth", "dp.train.tiny", "dp")]
    bench["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "CPU test"}
                           for n, c, t, _ in cells]
    # Each tiny cell reports what the real cells of its step kind report.
    kind_of = {w["name"]: json.loads((trf / f"{w['traffic']}.json").read_text())["kind"]
               for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {kind_of[w] for w in m["workloads"]}
            m["workloads"] += [n for n, _, _, k in cells if k in kinds]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    lim = root / "perfbench" / "limits"
    for n, *_ in cells:
        (lim / f"{n}.json").write_text(json.dumps(TINY_LIMITS))
    return root
