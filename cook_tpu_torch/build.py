"""Build and load the port's hand-written CUDA kernels.

`csrc/<name>.cu` (with the shared `csrc/score_tile.cuh`) compiles with
`nvcc` into `_build/lib<name>.so`, a shared library with a plain C
interface that the kernel's wrapper loads with `ctypes` (no PyTorch
headers, so a build takes seconds).  The build
happens at first use, inside the process that launches the kernel, and
`_build/` is never committed.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions compute them, so kernel and plain version can be
# compared bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only on a machine with the toolkit")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    """True when `lib<name>.so` is missing, or older than its `.cu` or any
    shared header `csrc/*.cuh` (an edited header must rebuild every kernel
    that includes it)."""
    src, path = _paths(name)
    if not os.path.exists(path):
        return True
    sources = [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(path) < max(map(os.path.getmtime, sources))


def load_all(names) -> list[ctypes.CDLL]:
    """The kernel libraries `names`, in order; every stale one is compiled
    first, one `nvcc` per source, all started together.  Raises (after
    every compiler has ended) if any build failed."""
    names = list(names)
    procs = {}
    try:
        for name in dict.fromkeys(names):
            if name in _libs or not _stale(name):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            src, path = _paths(name)
            procs[name] = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", path, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outputs = {name: proc.communicate()[0]
                   for name, proc in procs.items()}
    finally:
        # a compiler still running here was left by an exception
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):"
              f"\n{outputs[name]}"
              for name, proc in procs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_paths(name)[1])
    return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, compiled first if stale (`load_all`)."""
    return load_all([name])[0]


def bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int):
    """The C entry point `<name>_launch(ptr x n_ptrs, int x n_ints, stream)`
    of `lib` as a Python function that raises when the launch returns a
    cudaError_t other than 0.  Every pointer and the stream pass as
    c_void_p: a plain int would be cut to 32 bits."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p

    def launch(*args):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: "
                               + error_string(err).decode())

    return launch


@functools.lru_cache(maxsize=None)
def launcher(name: str, n_ptrs: int, n_ints: int):
    """`bind` of kernel library `name`, built at first use."""
    return bind(load(name), name, n_ptrs, n_ints)
