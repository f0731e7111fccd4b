"""Kernel loader: nvcc -> one shared library -> ctypes.

The CUDA kernels under ``csrc/`` expose plain C entry points (pointers,
ints, floats and a stream; each returns ``cudaGetLastError()``). They
are compiled at first use, never at import, into ``_build/`` inside the
package (git-ignored), under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. The build log (``-Xptxas -v``: registers, shared memory,
spills per kernel) is kept beside the library.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction anywhere. Coverage, cut line
# and depth order must round exactly as the plain PyTorch twins do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(_DEFAULT_CUDA_HOME, "bin", "nvcc")
    if os.path.isfile(default):
        return default
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{_DEFAULT_CUDA_HOME}/bin): the CUDA kernels of nvdiffrast_tpu_torch "
        "are compiled from nvdiffrast_tpu_torch/csrc at first use on a GPU. "
        "Install the CUDA toolkit or point CUDA_HOME at it; CPU tensors "
        "need no build.")


def sources():
    """The kernel sources compiled into the library, in build order."""
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash():
    h = hashlib.sha256()
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path():
    return BUILD_DIR / f"libnvdr_torch_{source_hash()}.so"


def build():
    """Compile the kernels if this source hash has no library yet.

    Returns the library's path. Raises KernelBuildError when nvcc is
    missing or fails.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            lib.nvdr_error_string.argtypes = [ctypes.c_int]
            lib.nvdr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library, with its launch count.

    `launch` is the only place a kernel is launched; it adds one to
    `launches` per successful launch.
    """

    def __init__(self, name, argtypes):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def launch(self, device, *args):
        """Launch on `device`'s current stream; raise on a CUDA error."""
        if self._fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().nvdr_error_string(err).decode()
            raise KernelLaunchError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t):
    """Device pointer of a tensor, for a c_void_p argument."""
    return ctypes.c_void_p(t.data_ptr())
