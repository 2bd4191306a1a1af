"""Build and load the host-side C++ libraries of `native/`.

The port compiles the repo's `native/docstore.cc`, `native/fastjson.cc` and
`native/cpuscan.cc` as they are, with the flags of `native/Makefile`, so
the doc store's file format and the re-score arithmetic are the JAX
package's by construction. Each library is built with `g++` at first use
into `build/native/` at the root of the checkout and rebuilt when it is
older than its source. A process compiles into a name of its own and
renames the result into place, so two processes that build at once never
load a half-written library (the in-place `make -C native` of the JAX
package can). Nothing is ever written into `native/`.

`cpuscan` is built with `-march=native`, and every library links the
host's C++ runtime: a library belongs to the host that built it. Its file
name carries a hash of the macros that `g++ -march=native` predefines
there (the compiler's version and the CPU's extensions among them:
`librag<name>.<hash>.so`), so a `build/` copied from another host is
never loaded. A failed build raises, naming `g++` and the source; no
caller falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")

# library name -> (source, compile flags, link flags), the flags of
# native/Makefile. Each library is compiled (-c) and linked in two steps:
# g++ links crtfastmath.o into a -shared link that is given -ffast-math,
# and its constructor sets the flush-to-zero and denormals-are-zero bits
# of the whole process's floating-point state when the library loads
# (every float32 in numpy and PyTorch on the CPU then loses its
# subnormals). The link step gets no -ffast-math, so the library computes
# as the Makefile's build does and leaves the process's state alone.
LIBS = {
    "docstore": ("docstore.cc", ("-O2",), ()),
    "fastjson": ("fastjson.cc", ("-O3",), ()),
    "cpuscan": (
        "cpuscan.cc",
        ("-O3", "-march=native", "-ffast-math", "-funroll-loops"),
        ("-lpthread",),
    ),
}
_COMMON = ("-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> str:
    """The library's file, named for this host's compiler and CPU and the
    library's flags."""
    tag = hashlib.sha1(repr((_native_target()[0], LIBS[name])).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"librag{name}.{tag}.so")


@functools.lru_cache(maxsize=None)
def _native_target() -> tuple[str, frozenset]:
    """(a hash of, the set of) the macros g++ predefines for
    `-march=native` on this host."""
    proc = subprocess.run(
        [_gxx(), "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ -march=native failed on this host:\n{proc.stderr}")
    lines = sorted(proc.stdout.splitlines())
    digest = hashlib.sha1("\n".join(lines).encode()).hexdigest()
    return digest, frozenset(ln.split()[1] for ln in lines if ln.startswith("#define"))


def _gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the port builds native/*.cc with g++ at "
            "first use"
        )
    return found


def build(name: str) -> str:
    """Compile `native/<source>` of library `name` into `build/native/`
    when the library is missing or older than its source; returns its
    path. Raises RuntimeError naming g++ and the source on failure."""
    src_name, compile_flags, link_flags = LIBS[name]
    src = os.path.join(SRC_DIR, src_name)
    out = lib_path(name)
    if not os.path.exists(src):
        raise RuntimeError(f"native source {src} not found: the port builds it with g++")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    obj = f"{tmp}.o"
    gxx = _gxx()
    try:
        for cmd in (
            [gxx, *compile_flags, *_COMMON, "-c", "-o", obj, src],
            [gxx, "-shared", "-o", tmp, obj, *link_flags],
        ):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {src} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stderr}"
                )
        os.replace(tmp, out)
    finally:
        for f in (obj, tmp):
            if os.path.exists(f):
                os.remove(f)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library `name` ("docstore", "fastjson" or "cpuscan"),
    loaded once per process; the caller sets its argtypes."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def isa() -> list[str]:
    """The x86 vector extensions that `-march=native` enables on this host
    (the ones `cpuscan.cc` branches on), as g++ predefines them."""
    wanted = ("__AVX512F__", "__AVX2__", "__AVX__", "__F16C__", "__FMA__")
    defined = _native_target()[1]
    return [m.strip("_") for m in wanted if m in defined]
