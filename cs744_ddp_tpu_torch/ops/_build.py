"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``ops/csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the
root of the checkout on first use.  The library's file name carries a hash of
its source, so an edited source is rebuilt and a built one is reused.  All
sources are compiled in parallel, one nvcc per source.  A failed build
raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("bnpool.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument types of every C entry point, by library.
SIGNATURES = {
    "bnpool.cu": {
        **{f"bnpool_sums_{t}": [_P] * 6 + [_I] * 5 + [_P] * 2
           for t in ("f32", "bf16")},
        **{f"bnpool_dx_{t}": [_P] * 7 + [_I] * 6 + [_P] * 2
           for t in ("f32", "bf16")},
    },
}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(log=None) -> Dict[str, float]:
    """Compile every source not yet built, all nvcc processes at once.

    Returns {source: seconds} for the sources compiled in this call and
    writes nvcc's register/spill report through ``log`` when given."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[src] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    failed = []
    for src, (proc, tmp, out, t0) in pending.items():
        text, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        _BUILT[src] = round(seconds[src], 3)
        if log is not None and text.strip():
            log(f"nvcc {src}:\n{text.rstrip()}")
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return seconds


# Loaded libraries by source: a shared library is loaded once per process.
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's seconds for each source this process compiled.
_BUILT: Dict[str, float] = {}


def build_report() -> Dict[str, dict]:
    """What this process did for each source: ``{"library": file name,
    "built": True, "nvcc_s": seconds}`` if it compiled it, ``"built":
    False`` if it found the library in ``build/kernels/`` already, and
    ``"loaded"`` whether the library is loaded.  The run manifest's
    ``cuda_kernels``."""
    return {src: {"library": _lib_path(src).name, "built": src in _BUILT,
                  "nvcc_s": _BUILT.get(src), "loaded": src in _LIBS}
            for src in SOURCES if src in _BUILT or src in _LIBS}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed (on first
    use, never at import: the tests import every module on hosts without
    nvcc)."""
    lib = _LIBS.get(source)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
