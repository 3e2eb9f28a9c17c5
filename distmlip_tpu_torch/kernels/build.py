"""Build the port's CUDA kernels with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so

The output lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name keyed by a hash of the source and the flags,
so a changed source rebuilds and an unchanged one is reused. ``ptxas``'s
register/spill report is kept beside it as ``<name>-<hash>.log``. Each
build that ran goes into the compile log (``obs.profiling``, site
``kernel_build``, the source's name as its bucket key).
Nothing here runs at import time; CPU-only hosts never need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..obs.profiling import KIND_FRESH, record_compile

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source in ``csrc/`` (one library each)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use on a machine with "
            "the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together. Returns the wall seconds of
    each build (0.0 when already built); raises with nvcc's output on any
    failure."""
    names = kernel_names() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.tmp{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        record_compile("kernel_build", KIND_FRESH, seconds[name], bucket_key=name,
                       executable_bytes=os.path.getsize(lib))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
