"""The port's samples (samples/torch/*.py) run end to end on the CPU.

Each runs through runpy with ``--device cpu`` and the tiny budgets of
tests/test_samples.py (earth at half its steps), so a crash anywhere in the script, the final
metric's print included, fails here. Without ``--device`` a sample runs
on the card and, where torch sees none, exits with a message instead of
switching to the CPU. The triangle's image at 32^2 equals JAX's
``rasterize`` + ``interpolate`` of the same triangle within 1e-6.
``graft_entry.entry``'s forward renders on the CPU.
"""

import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread a process)
import nvdiffrast_tpu as jdr

SAMPLES = {
    "triangle": ["--res", "32"],
    "cube": ["--resolution", "12", "--max-iter", "8", "--log-interval", "4"],
    # 3 steps, not 6: each renders the 256^2 reference on the CPU twins.
    "earth": ["--res", "32", "--max-iter", "3", "--log-interval", "3",
              "--max-mip-level", "3"],
    "envphong": ["--res", "32", "--env-res", "8", "--max-iter", "6",
                 "--log-interval", "3"],
    "pose": ["--resolution", "24", "--max-iter", "12", "--log-interval", "6"],
}


def _path(repo_root, name):
    return str(repo_root / "samples" / "torch" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_torch_sample_runs(name, tmp_path, monkeypatch, repo_root, capsys):
    argv = [f"samples/torch/{name}.py"] + SAMPLES[name] + ["--device", "cpu"]
    if name == "triangle":
        argv += ["--outdir", str(tmp_path)]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(_path(repo_root, name), run_name="__main__")
    assert "final" in capsys.readouterr().out or name == "triangle"
    if name == "triangle":
        assert (tmp_path / "tri.png").is_file()


def test_torch_samples_default_to_the_card(monkeypatch, repo_root):
    """The default device is cuda: without a card a sample fails loudly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sorted(SAMPLES):
        monkeypatch.setattr(sys, "argv", [f"samples/torch/{name}.py"])
        with pytest.raises(SystemExit, match="no CUDA device"):
            runpy.run_path(_path(repo_root, name), run_name="__main__")


def test_torch_triangle_matches_jax(repo_root):
    got = runpy.run_path(_path(repo_root, "triangle"))["render"](32, "cpu")
    pos = jnp.asarray([[[-0.8, -0.8, 0, 1], [0.8, -0.8, 0, 1], [-0.8, 0.8, 0, 1]]],
                      jnp.float32)
    col = jnp.asarray([[[1, 0, 0], [0, 1, 0], [0, 0, 1]]], jnp.float32)
    tri = jnp.asarray([[0, 1, 2]], jnp.int32)

    @jax.jit  # one compile; op by op, JAX's rasterizer compiles for 8-15 s
    def render(pos, col):
        rast, _ = jdr.rasterize(jdr.RasterizeCudaContext(), pos, tri, resolution=(32, 32))
        return jdr.interpolate(col, rast, tri)[0][0]

    ref = np.asarray(render(pos, col))
    assert got.shape == (32, 32, 3) and (got.sum(-1) > 0).mean() > 0.25
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_graft_entry_renders_on_the_cpu():
    """graft_entry.entry's flagship forward: the textured, antialiased
    sphere at 256^2, finite, its background black, ~43 % covered."""
    from nvdiffrast_tpu_torch.graft_entry import entry

    fn, args = entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    img = fn(*args)
    assert img.shape == (1, 256, 256, 3) and bool(torch.isfinite(img).all())
    cover = float((img.sum(-1) > 0).float().mean())
    assert 0.3 < cover < 0.6
    assert float(img[0, 0, 0].abs().sum()) == 0.0
