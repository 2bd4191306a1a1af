"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by its own `nvcc` process for `sm_90a`, all
started together, and the objects are linked into one shared library with
a plain C interface, `build/kernels/libragtorch_kernels.so` at the root of
the checkout, loaded with `ctypes`. The library is built at first use and
rebuilt when it is older than any source or header, as
`rag_inference_pipeline_tpu/utils/cpuscan.py` does for `native/`. Nothing
here runs at import time: the CPU tests import every module of the port on
a machine with no `nvcc`.

Every wrapper launches through `launch`: the library is loaded once per
process and read without a lock after that, the stream is PyTorch's
current raw stream of the tensors' device (an int, no `Stream` object),
and a device guard is entered only when that device is not the current
one.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libragtorch_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# torch._C._cuda_getCurrentRawStream, looked up at the first launch: a CPU
# build of torch lacks it
_raw_stream: Optional[Callable[[int], int]] = None
_binmax_tile: Optional[tuple[int, int]] = None


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
    deps = srcs + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    stale = not os.path.exists(LIB_PATH) or any(
        os.path.getmtime(LIB_PATH) < os.path.getmtime(s) for s in deps
    )
    if not stale and not verbose:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # per-process names: a second process that builds meanwhile writes its
    # own objects, and the rename below replaces the library in one step
    tag = os.getpid()
    objs = [
        os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs
    ]
    ptxas = ("-Xptxas", "-v") if verbose else ()
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, *ptxas, "-o", o, s],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for s, o in zip(srcs, objs)
    ]
    tmp = f"{LIB_PATH}.{tag}.tmp"
    try:
        errors = []
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{os.path.basename(s)}:\n{err}")
            elif verbose and err:
                print(err, flush=True)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for p in procs:  # a failed build leaves no compiler running
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            # q, db, part_vals, part_steps, vals, idxs, B, D, ntotal, nbins,
            # groups, stream
            "ragtorch_binmax_int8gs": [vp] * 6 + [i32, i32, i64, i32, i32, vp],
            # q, db, scales, part_vals, part_steps, vals, idxs, B, D, N,
            # nbins, groups, stream
            "ragtorch_binmax_int8": [vp] * 7 + [i32, i32, i64, i32, i32, vp],
            # bins a block, queries a y-tile at most (out)
            "ragtorch_binmax_tile": [ctypes.POINTER(i32)] * 2,
            # cache_k, cache_v (or null), rows_k, rows_v, pos, B, S,
            # row_bytes, stream
            "ragtorch_kv_row_insert": [vp] * 5 + [i32] * 3 + [vp],
            # db, out, checksum, rows, D, chunk, blocks, stream
            "ragtorch_stream_sum": [vp] * 3 + [i64, i32, i32, i32, vp],
            # as ragtorch_binmax_int8gs, elem_bytes before the stream
            "ragtorch_binmax_bf16": [vp] * 6 + [i32, i32, i64, i32, i32, i32, vp],
            # q, buckets, slots, sizes, out, B, D, n_slots, cap, elem_bytes,
            # z_tiles, q_tile, stream
            "ragtorch_ivf_dedup": [vp] * 5 + [i32] * 7 + [vp],
            # q, buckets, probe, sizes, vals, win, B, D, nprobe, cap,
            # elem_bytes, stream
            "ragtorch_ivf_scan": [vp] * 6 + [i32] * 5 + [vp],
            # lut, codes, slots, sizes, out, b_pad, m, n_slots, cap, m_store,
            # stream
            "ragtorch_ivfpq4_adc": [vp] * 5 + [i32] * 5 + [vp],
            # xq, xs, wq[3], ws[3], bias[3], out[3], N[3], nmem, M, K,
            # out_kind, bm, bn, split, share, band, deep, pdl, stream
            "ragtorch_w8a8_gemm_wgmma": [vp] * 2 + [ctypes.POINTER(vp)] * 4
            + [ctypes.POINTER(i32)] + [i32] * 11 + [vp],
            # bm, bn, split, share, deep -> the clusters the card holds at
            # once (out; no stream: a host query)
            "ragtorch_w8a8_gemm_clusters": [i32] * 5 + [ctypes.POINTER(i32)],
            # x, wq[3], ws[3], bias[3], out[3], N[3], nmem, M, K, in_kind,
            # out_kind, mt, kc, depth, grid_x, cluster, stream
            "ragtorch_w8a8_qgemm": [vp] + [ctypes.POINTER(vp)] * 4
            + [ctypes.POINTER(i32)] + [i32] * 10 + [vp],
            # mt, K, cluster, slots, kc, depth -> a block's shared memory
            # (no stream: a host query)
            "ragtorch_w8a8_qgemm_smem": [i32] * 6,
            # mt, smem, cluster -> the clusters the card holds at once (out;
            # no stream: a host query)
            "ragtorch_w8a8_qgemm_clusters": [i32] * 3 + [ctypes.POINTER(i32)],
            # the short-K kernel: x, wq[3], ws[3], bias[3], out[3], N[3],
            # nmem, M, K, in_kind, out_kind, mt, nt8, grid_x, cluster, stream
            "ragtorch_w8a8_qshort": [vp] + [ctypes.POINTER(vp)] * 4
            + [ctypes.POINTER(i32)] + [i32] * 9 + [vp],
            # mt, K -> a block's shared memory (no stream: a host query)
            "ragtorch_w8a8_qshort_smem": [i32] * 2,
            # x, q, s, M, K, in_kind, path, warps, cluster, stream
            "ragtorch_w8a8_quantize_rows": [vp] * 3 + [i32] * 6 + [vp],
            # q, k, v, seg_q, seg_kv, out, B, T, H, dh, the (b, t, h)
            # element strides of q, k and v, kind, stream
            "ragtorch_flash_attention": [vp] * 6 + [i32] * 4 + [i64] * 9 + [i32, vp],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        _lib = lib
        return lib


def binmax_tile() -> tuple[int, int]:
    """The block tile of the bin-max kernels K1, K2 and K3 as the library
    reports it (csrc/binmax_mma.cuh): (bins a block, queries a y-tile at
    most). Read once per process."""
    global _binmax_tile
    if _binmax_tile is None:
        lib = _lib if _lib is not None else load_library()
        bins, max_q = ctypes.c_int(), ctypes.c_int()
        lib.ragtorch_binmax_tile(ctypes.byref(bins), ctypes.byref(max_q))
        _binmax_tile = (bins.value, max_q.value)
    return _binmax_tile


def needs_device_guard(index: int, current: int) -> bool:
    """A launch on device `index` enters a device guard only when the
    calling thread's current device is another one."""
    return index != current


def launch(name: str, index: int, *args) -> None:
    """Call the library's entry point `name` with `args` and the current
    stream of CUDA device `index`; raises on a non-zero cudaError."""
    global _raw_stream
    lib = _lib if _lib is not None else load_library()
    raw_stream = _raw_stream
    if raw_stream is None:
        raw_stream = _raw_stream = torch._C._cuda_getCurrentRawStream
    fn = getattr(lib, name)
    if needs_device_guard(index, torch._C._cuda_getDevice()):
        with torch.cuda.device(index):
            rc = fn(*args, raw_stream(index))
    else:
        rc = fn(*args, raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
