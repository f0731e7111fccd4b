"""Kernel loader: nvcc -> one shared library -> ctypes.

The CUDA kernels under ``csrc/`` expose plain C entry points (pointers,
ints, floats and a stream; each returns ``cudaGetLastError()``). They
are compiled at first use, never at import, into ``_build/`` inside the
package (git-ignored), under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Each source compiles to an object in its own nvcc process, all
started together; one more nvcc links them. The build log (``-Xptxas
-v``: registers, shared memory, spills per kernel) is kept beside the
library.
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
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.tmp.so")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]  # waits for every compile
    results = [(c, p.returncode, o, e) for c, p, (o, e) in zip(cmds, procs, outs)]
    link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
    if all(rc == 0 for _, rc, _, _ in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    out.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + o + e for c, _, o, e in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, rc, e) for c, rc, _, e in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, e = failed[0]
        raise KernelBuildError(
            f"nvcc failed with exit code {rc}:\n{' '.join(c)}\n{e[-4000:]}")
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


KERNELS = []  # every Kernel made in this process, for launch_counts


class Kernel:
    """One C entry point of the library, with its launch count.

    `launch` is the only place a kernel is launched; it adds one to
    `launches` per successful launch. Several counters may bind one
    entry (`symbol`, by default `name`), one per mode a caller picks.
    """

    def __init__(self, name, argtypes, symbol=None):
        self.name = name
        self.symbol = symbol or name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def launch(self, device, *args):
        """Launch on `device`'s current stream; raise on a CUDA error."""
        if self._fn is None:
            fn = getattr(library(), self.symbol)
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


def reset_launches():
    """Set every kernel's launch count in this process to 0."""
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    """{name: launches} of the kernels launched in this process since
    their counts were last reset (a rank reports its own)."""
    return {k.name: k.launches for k in KERNELS if k.launches}


def ptr(t):
    """Device pointer of a tensor, for a c_void_p argument."""
    return ctypes.c_void_p(t.data_ptr())
