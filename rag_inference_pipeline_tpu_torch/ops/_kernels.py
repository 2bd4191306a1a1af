"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface, `build/kernels/libragtorch_kernels.so`
at the root of the checkout, and loaded with `ctypes`. The library is built
at first use and rebuilt when it is older than any source, as
`rag_inference_pipeline_tpu/utils/cpuscan.py` does for `native/`. Nothing
here runs at import time: the CPU tests import every module of the port on
a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libragtorch_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin or PATH): the port's CUDA kernels "
            "are built from csrc/ at first use"
        )
    return found


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH when missing or stale; returns the
    path. `verbose` rebuilds with `-Xptxas -v` and prints nvcc's report of
    each kernel's registers, shared memory and spills."""
    srcs = _sources()
    stale = not os.path.exists(LIB_PATH) or any(
        os.path.getmtime(LIB_PATH) < os.path.getmtime(s) for s in srcs
    )
    if not stale and not verbose:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the target and rename: a second process that loads the
    # library meanwhile sees either the old file or the whole new one
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    proc = subprocess.run(
        [*cmd, "-o", tmp, *srcs], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ragtorch_binmax_int8gs.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i32, i64, i32, i32, vp,
        ]
        lib.ragtorch_binmax_int8gs.restype = i32
        _lib = lib
        return lib
