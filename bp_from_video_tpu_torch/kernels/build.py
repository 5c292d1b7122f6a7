"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds, not minutes.  Libraries land under ``.torch_kernels_build/`` at the
repository root (git-ignored), keyed by a hash of the source and the flags,
and are built at first use; ``build_all`` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), ".torch_kernels_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("multi_crop", "dense_s2_block", "roi_sums", "bottleneck",
           "stem_packed", "pf_stem", "clip_standardise")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    (process or None, output path)."""
    out = lib_path(name)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def _finish(name: str, proc, out: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(out + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every named source in parallel (one nvcc each); returns the
    wall seconds until all finished, per name (0.0 when cached)."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    secs = {}
    for name, proc, out in started:
        _finish(name, proc, out)
        secs[name] = 0.0 if proc is None else time.perf_counter() - t0
    return secs


def ptxas_log(name: str) -> str:
    """The compiler's register/shared-memory report for a built source."""
    path = lib_path(name) + ".log"
    return open(path).read() if os.path.exists(path) else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _LOCK:
        if name not in _LIBS:
            build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
