"""Build and load the port's hand-written CUDA kernels.

`csrc/<name>.cu` compiles with `nvcc` into `_build/lib<name>.so`, a shared
library with a plain C interface that the kernel's wrapper loads with
`ctypes` (no PyTorch headers, so a build takes seconds).  The build
happens at first use, inside the process that launches the kernel, and
`_build/` is never committed.
"""
from __future__ import annotations

import ctypes
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


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, compiled first if missing or older than
    its source."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (not os.path.exists(path)
            or os.path.getmtime(path) < os.path.getmtime(src)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", path, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
    lib = _libs[name] = ctypes.CDLL(path)
    return lib
