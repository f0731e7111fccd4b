"""The roofline arithmetic of the per-layer metrics against hand counts."""

import pytest

from perfbench import harness

EARTH = {"B": 8, "H": 2048, "W": 2048, "C": 3, "ranks": 1, "T": 65024,
         "uv_vertices": 33153, "params": {"pos": [33153, 3], "tex": [1, 1536, 2048, 3]}}
VCOLOR = {"B": 8, "H": 2048, "W": 2048, "C": 3, "ranks": 1, "T": 3968, "uv_vertices": 0,
          "params": {"pos": [2145, 3], "col": [2145, 3]}}


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_train_step_bytes_by_hand():
    m = _metric("kernel_roofline_pct.train")
    # earth: tri + uv_idx (2 x 65,024 x 3 int32), uvs (33,153 x 2), 8 view
    # matrices; pos 99,459 + texture 9,437,184 floats read once; image,
    # target, cotangent 8 x 2048^2 x 3 floats each; gradients written
    # once; Adam 28 bytes a parameter.
    mesh = 1_560_576 + 265_224 + 512
    n = 99_459 + 9_437_184
    pixels = 100_663_296
    assert m.step_bytes(EARTH) == mesh + 4 * n + 12 * pixels + 4 * n + 28 * n
    assert m.step_bytes(EARTH) == 1_553_105_012
    assert m.step_flops(EARTH) == 5 * pixels + 12 * n
    assert m.least_seconds(EARTH) == pytest.approx(1_553_105_012 / 3.35e12)
    # vcolor: tri + col_idx, no uvs, pos and col 2 x 6,435 floats.
    assert m.step_bytes(VCOLOR) == 95_232 + 512 + 36 * 12_870 + 12 * pixels


def test_render_call_bytes_by_hand():
    m = _metric("kernel_roofline_pct.render")
    s = dict(EARTH, B=16)
    assert m.call_bytes(s) == 1_560_576 + 265_224 + 1_024 + 4 * 9_536_643 + 4 * 201_326_592
    assert m.least_seconds(s) == pytest.approx(m.call_bytes(s) / 3.35e12)


def test_roofline_reads_device_time_per_step():
    m = _metric("kernel_roofline_pct.train")
    trace = {"window_us": (0, 100_000), "host": [], "calls": 2,
             "device": [("k", 0, 20_000, True), ("Memcpy HtoD", 20_000, 30_000, False),
                        ("k2", 40_000, 60_000, True)]}
    t = {"kind": "train", "trace": trace, "steps": 2, "shapes": EARTH}
    assert m.read(t) == pytest.approx(100 * m.least_seconds(EARTH) / 0.020)
    idle = _metric("device_idle_pct.train")
    assert idle.read(t) == pytest.approx(50.0)   # kernels and the copy cover 50 ms
    assert harness.busy_us(trace) == 50_000
