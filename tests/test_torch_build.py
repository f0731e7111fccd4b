"""The port's package boundary and kernel loader (no GPU needed).

* importing nvdiffrast_tpu_torch pulls in no JAX and starts no nvcc;
* the CUDA sources exist and export the entries the wrappers bind;
* the loader names nvcc when it is missing, passes the documented
  flags, caches by source hash and reports a failed compile.
"""

import os
import pathlib
import stat
import subprocess
import sys
import textwrap

import pytest

from nvdiffrast_tpu_torch import _build
from nvdiffrast_tpu_torch.ops import (antialias_cuda, gather, interpolate_cuda,
                                      pipeline_bwd_cuda, pipeline_cuda, pipeline_tex_bwd_cuda,
                                      rasterize_cuda, scatter, texture_bwd_cuda,
                                      texture_cube_cuda, texture_cuda)

import _torch_parity  # noqa: F401  (one intra-op thread a test worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
KERNELS = [rasterize_cuda.KERNEL, rasterize_cuda.DB_KERNEL, pipeline_cuda.KERNEL,
           pipeline_bwd_cuda.BWD_KERNEL, pipeline_bwd_cuda.SCATTER_KERNEL,
           interpolate_cuda.KERNEL, texture_cuda.KERNEL, antialias_cuda.KERNEL,
           texture_bwd_cuda.BWD_KERNEL, texture_bwd_cuda.GRAD_KERNEL,
           pipeline_tex_bwd_cuda.KERNEL, interpolate_cuda.BWD_KERNEL,
           antialias_cuda.BWD_KERNEL, gather.KERNEL, scatter.KERNEL,
           texture_cube_cuda.FWD_KERNEL, texture_cube_cuda.BWD_KERNEL,
           rasterize_cuda.BINNED_KERNEL, rasterize_cuda.PEEL_KERNEL,
           rasterize_cuda.RANGE_KERNEL, rasterize_cuda.BAND_KERNEL,
           rasterize_cuda.SETUP_KERNEL, rasterize_cuda.BIN_EMIT_KERNEL,
           rasterize_cuda.BIN_SEGMENT_KERNEL, texture_bwd_cuda.GRAD_COMPACT_KERNEL,
           texture_bwd_cuda.GRAD_SEGMENT_KERNEL, texture_bwd_cuda.GRAD_SUM_KERNEL,
           pipeline_bwd_cuda.SCATTER_COMPACT_KERNEL, pipeline_bwd_cuda.SCATTER_SEGMENT_KERNEL,
           pipeline_bwd_cuda.SCATTER_SUM_KERNEL, scatter.COMPACT_KERNEL,
           scatter.SEGMENT_KERNEL, scatter.SUM_KERNEL, texture_cube_cuda.GRAD_COMPACT_KERNEL,
           texture_cube_cuda.GRAD_SEGMENT_KERNEL, texture_cube_cuda.GRAD_SUM_KERNEL,
           texture_cuda.LEVEL_KERNEL, texture_cuda.LEVEL_VJP_KERNEL,
           texture_cube_cuda.SETUP_KERNEL]


def _fake_nvcc(bin_dir, log, exit_code=0):
    """An nvcc stand-in that records its arguments and writes -o."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    script = bin_dir / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        with open({str(log)!r}, "a") as f:
            f.write(" ".join(sys.argv[1:]) + "\\n")
        if {exit_code}:
            sys.stderr.write("fake compile error\\n")
            sys.exit({exit_code})
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "wb").close()
        """))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return script


def test_import_pulls_no_jax_and_starts_no_nvcc(tmp_path):
    log = tmp_path / "nvcc.log"
    _fake_nvcc(tmp_path / "bin", log)
    code = textwrap.dedent("""\
        import importlib, pkgutil, sys
        import nvdiffrast_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "nvdiffrast_tpu"))
        assert not bad, bad
        print("ok", len(pkg.__all__))
        """)
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert not log.exists(), "importing the package ran nvcc"


def test_cuda_sources_exist():
    names = {p.name for p in _build.sources()}
    assert {"rasterize.cu", "shade_fwd.cu", "pipeline_bwd.cu", "grad_scatter.cu",
            "interpolate_fwd.cu", "texture_fwd.cu", "aa_fwd.cu", "common.cu",
            "texture_bwd.cu", "texture_grad.cu", "interp_raster_bwd_tex.cu",
            "interpolate_bwd.cu", "aa_bwd.cu", "table_take.cu", "scatter_rows.cu",
            "texture_cube.cu", "raster_bin.cu", "raster_setup.cu", "segment_sum.cu",
            "mip_level.cu", "texture_cube_setup.cu"} <= names
    text = "".join(p.read_text() for p in _build.sources())
    for kernel in KERNELS:
        assert f'extern "C" int {kernel.symbol}(' in text
    # The AA pair math lives in one header that the AA kernels use.
    assert (_build.SRC_DIR / "aa_pair.cuh").exists()
    for name in ("shade_fwd.cu", "aa_fwd.cu", "pipeline_bwd.cu", "aa_bwd.cu", "grad_scatter.cu"):
        assert '#include "aa_pair.cuh"' in (_build.SRC_DIR / name).read_text()
    # The gradient reductions share their tile grouping, warp reduction,
    # scratch move and row sums (segment_sum.cuh, segment_sum.cu).
    for name in ("grad_scatter.cu", "texture_grad.cu", "scatter_rows.cu", "segment_sum.cu",
                 "texture_cube.cu"):
        assert '#include "segment_sum.cuh"' in (_build.SRC_DIR / name).read_text()
    for name in ("grad_scatter.cu", "texture_grad.cu", "scatter_rows.cu", "texture_cube.cu"):
        assert "nvdr_segment_compact(" in (_build.SRC_DIR / name).read_text()
    # The samplers' corner setup and level weights: one header.
    for name in ("texture_fwd.cu", "texture_bwd.cu", "texture_grad.cu", "texture_cube.cu"):
        assert '#include "texture_corner.cuh"' in (_build.SRC_DIR / name).read_text()
    # The mip level's arithmetic: one header, so the cube setup's level has
    # the level kernel's bits.
    for name in ("mip_level.cu", "texture_cube_setup.cu"):
        assert '#include "mip_level.cuh"' in (_build.SRC_DIR / name).read_text()
    assert 'extern "C" const char* nvdr_error_string(' in text
    assert all(p.parent == _build.SRC_DIR for p in _build.sources())


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_kernel_argtypes_match_c_entry(kernel):
    """The ctypes binding passes as many arguments as the C entry takes
    (the stream, added at launch, is the last)."""
    text = "".join(p.read_text() for p in _build.sources())
    start = text.index(f'extern "C" int {kernel.symbol}(')
    params = text[start:text.index(")", start)].split("(", 1)[1].split(",")
    assert params[-1].split() == ["void*", "stream"]
    assert len(kernel.argtypes) == len(params) - 1


def test_missing_nvcc_raises_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_flags_and_cache(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    _fake_nvcc(tmp_path / "cuda" / "bin", log)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    out = _build.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert _build.source_hash() in out.name
    # One compile per source (run side by side), then one link.
    *compiles, link = [line.split() for line in log.read_text().splitlines()]
    assert len(compiles) == len(_build.sources())
    for args in compiles:
        for flag in ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-fmad=false", "-Xcompiler", "-fPIC", "-c"):
            assert flag in args, flag
        assert "--use_fast_math" not in args and "-shared" not in args
    assert sorted(a for args in compiles for a in args if a.endswith(".cu")) == sorted(
        str(p) for p in _build.sources())
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert sum(a.endswith(".o") for a in link) == len(compiles)
    assert not list((tmp_path / "build").glob("*.o")), "objects left behind"
    assert _build.build() == out
    assert len(log.read_text().splitlines()) == len(compiles) + 1, (
        "rebuilt an unchanged source")


def test_failed_compile_raises(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path / "cuda" / "bin", tmp_path / "nvcc.log", exit_code=2)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="fake compile error"):
        _build.build()
    assert not _build.library_path().exists()
    assert not list((tmp_path / "build").glob("*.so"))
