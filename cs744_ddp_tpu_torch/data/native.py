"""ctypes bindings for the native host-side loader (``native/fastloader.cpp``).

The reference training script's host data path is native library code
(torchvision's C transforms in DataLoader worker processes, ``Part 1/
main.py:96-101``).  This is its equivalent here, as in the reference
package's ``data/native.py``: threaded batch gather and augmentation in
C++, over the same source file, which this module binds and never edits.

The library is built from the checkout's own source at first use, with
``g++`` and the flags of ``native/Makefile``, into ``build/kernels/
libfastloader-<hash of source and flags>.so`` (a temp file renamed into
place, so that ranks building at once never load a half-written file).
There is no silent fallback: a failed build raises with the compiler's
output, and so do a failed load and a wrong ABI version (``fl_version``),
on every call of a wrapper.  The NumPy versions (``_np_*``) are the plain
reference the tests hold the library to; nothing else calls them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ft.supervisor import Watchdog
from .augment import AFFINE_BIAS, AFFINE_SCALE
from .cifar10 import MEAN, STD

EXPECTED_VERSION = 3
SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# native/Makefile's flags.  No -march: a library built on a newer CPU
# would SIGILL on an older host while its load still succeeds.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-lpthread",)
PAD = 4

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_int = ctypes.c_int
SIGNATURES = {
    "fl_gather_u8": [_u8p, _i64p, _int, _u8p, _int],
    "fl_augment_f32": [_u8p, _int, _i32p, _u8p, _f32p, _f32p, _f32p, _int],
    "fl_augment_u8": [_u8p, _int, _i32p, _u8p, _u8p, _int],
    "fl_gather_augment_u8": [_u8p, _i64p, _int, _i32p, _u8p, _u8p, _int],
    "fl_normalize_f32": [_u8p, _int, _f32p, _f32p, _f32p, _int],
}

_MEAN32 = np.ascontiguousarray(MEAN, np.float32)
_STD32 = np.ascontiguousarray(STD, np.float32)


class NativeLoaderError(RuntimeError):
    """The native loader could not be built, loaded or checked."""


# Loaded libraries by (source, build directory): loaded once per process.
_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}


# Images per C++ thread.  Each call starts its own threads, and for a batch
# of 256 one thread is as fast as two or four and twice to three times as
# fast as eight on an 8-core host (utils/profile_host.py).
IMAGES_PER_THREAD = 1024


def _nthreads(n: int) -> int:
    """Threads for a call over ``n`` images: one per IMAGES_PER_THREAD, at
    most the cores this process may run on."""
    return max(1, min(len(os.sched_getaffinity(0)), n // IMAGES_PER_THREAD))


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise NativeLoaderError(f"{cxx} not found on PATH; the native host "
                                f"loader cannot be built")
    return found


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``source`` is built: its name carries a hash of
    the source and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(Path(source).read_bytes() + " ".join(
        CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"libfastloader-{digest}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless its library is built; its path.  Raises
    ``NativeLoaderError`` with the compiler's output if the build fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(source),
           *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            tmp.unlink()
        raise NativeLoaderError(
            f"building the native host loader failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(source: Path = SOURCE,
                 build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library, built first if needed (at first use, never at
    import).  Raises ``NativeLoaderError`` if it cannot be built or loaded
    or its ``fl_version`` is not ``EXPECTED_VERSION``."""
    key = (str(source), str(build_dir))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    path = build(source, build_dir)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeLoaderError(f"loading {path} failed: {e}") from e
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.fl_version.argtypes = []
    lib.fl_version.restype = ctypes.c_int
    version = lib.fl_version()
    if version != EXPECTED_VERSION:
        raise NativeLoaderError(
            f"{path}: libfastloader ABI version {version}, expected "
            f"{EXPECTED_VERSION}")
    _LIBS[key] = lib
    return lib


_load_error: Optional[str] = None


def available() -> bool:
    """True when the library loads (building it first if needed); when
    False, ``load_error()`` says why.  A probe for the run's manifest: the
    wrappers still raise on a library that does not load."""
    global _load_error
    try:
        load_library()
    except NativeLoaderError as e:
        _load_error = str(e)
        return False
    _load_error = None
    return True


def load_error() -> Optional[str]:
    """Why the last ``available()`` found no library (None: it loaded, or
    no probe was made)."""
    return _load_error


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _check_images(images: np.ndarray, what: str) -> np.ndarray:
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.shape[1:] != (32, 32, 3):
        raise ValueError(f"{what} must be uint8 [N,32,32,3], got "
                         f"{images.dtype} {images.shape}")
    return images


def _check_indices(indices: np.ndarray, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices must lie in [0, {n}), got "
                         f"[{idx.min()}, {idx.max()}]")
    return idx


def _check_draws(offsets: np.ndarray, flips: np.ndarray,
                 n: int) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.ascontiguousarray(offsets, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    if offsets.shape != (n, 2) or flips.shape != (n,):
        raise ValueError(f"offsets must be [{n},2] and flips [{n}], got "
                         f"{offsets.shape} and {flips.shape}")
    if offsets.size and (offsets.min() < 0 or offsets.max() > 2 * PAD):
        raise ValueError(f"offsets must lie in [0, {2 * PAD}]")
    return offsets, flips


def _check_out(out: np.ndarray, n: int) -> np.ndarray:
    """Validate a caller-provided staging destination: contiguous uint8
    [n,32,32,3].  Never copies — the point of the out-parameter is writing
    straight into a reusable arena slot."""
    if out.shape != (n, 32, 32, 3) or out.dtype != np.uint8:
        raise ValueError(f"out must be uint8 [{n},32,32,3], got "
                         f"{out.dtype} {out.shape}")
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous (an arena row, not a "
                         "strided view)")
    if not out.flags.writeable:
        raise ValueError("out must be writeable")
    return out


def gather(dataset: np.ndarray, indices: np.ndarray,
           out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = dataset[indices[i]] for a [N,32,32,3] uint8 dataset.

    ``out`` (uint8 [n,32,32,3], contiguous) receives the rows in place
    (arena staging, the same contract as ``augment_u8``)."""
    lib = load_library()
    dataset = _check_images(dataset, "dataset")
    idx = _check_indices(indices, len(dataset))
    out = np.empty((len(idx), 32, 32, 3), np.uint8) if out is None \
        else _check_out(out, len(idx))
    lib.fl_gather_u8(_ptr(dataset, ctypes.c_uint8), _ptr(idx, ctypes.c_int64),
                     len(idx), _ptr(out, ctypes.c_uint8), _nthreads(len(idx)))
    return out


def augment(images: np.ndarray, offsets: np.ndarray, flips: np.ndarray
            ) -> np.ndarray:
    """Pad-4 crop + flip + normalize; images [N,32,32,3] u8 -> f32.

    offsets: [N,2] int32 in [0,8]; flips: [N] bool/uint8."""
    lib = load_library()
    images = _check_images(images, "images")
    n = len(images)
    offsets, flips = _check_draws(offsets, flips, n)
    out = np.empty((n, 32, 32, 3), np.float32)
    lib.fl_augment_f32(_ptr(images, ctypes.c_uint8), n,
                       _ptr(offsets, ctypes.c_int32),
                       _ptr(flips, ctypes.c_uint8),
                       _ptr(_MEAN32, ctypes.c_float),
                       _ptr(_STD32, ctypes.c_float),
                       _ptr(out, ctypes.c_float), _nthreads(n))
    return out


def augment_u8(images: np.ndarray, offsets: np.ndarray, flips: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pad-4 crop + flip, uint8 -> uint8 (zero padding, no normalize).

    The transfer-compact staging variant: the random transform runs on the
    host; normalization is an affine per-channel map the device step does,
    so uint8 carries 4x fewer bytes than ``augment``'s f32 over the
    host-to-device link.  ``out`` (uint8 [n,32,32,3], contiguous) receives
    the result in place."""
    lib = load_library()
    images = _check_images(images, "images")
    n = len(images)
    offsets, flips = _check_draws(offsets, flips, n)
    out = np.empty((n, 32, 32, 3), np.uint8) if out is None \
        else _check_out(out, n)
    lib.fl_augment_u8(_ptr(images, ctypes.c_uint8), n,
                      _ptr(offsets, ctypes.c_int32),
                      _ptr(flips, ctypes.c_uint8),
                      _ptr(out, ctypes.c_uint8), _nthreads(n))
    return out


def gather_augment_u8(dataset: np.ndarray, indices: np.ndarray,
                      offsets: np.ndarray, flips: np.ndarray,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused gather + pad-4 crop + flip from the resident [N,32,32,3] u8
    dataset straight into ``out``: ``augment_u8(gather(dataset,
    indices), ...)`` in one host copy."""
    lib = load_library()
    dataset = _check_images(dataset, "dataset")
    idx = _check_indices(indices, len(dataset))
    n = len(idx)
    offsets, flips = _check_draws(offsets, flips, n)
    out = np.empty((n, 32, 32, 3), np.uint8) if out is None \
        else _check_out(out, n)
    lib.fl_gather_augment_u8(_ptr(dataset, ctypes.c_uint8),
                             _ptr(idx, ctypes.c_int64), n,
                             _ptr(offsets, ctypes.c_int32),
                             _ptr(flips, ctypes.c_uint8),
                             _ptr(out, ctypes.c_uint8), _nthreads(n))
    return out


def normalize(images: np.ndarray) -> np.ndarray:
    """ToTensor+Normalize (the test transform) on the host, u8 -> f32."""
    lib = load_library()
    images = _check_images(images, "images")
    out = np.empty(images.shape, np.float32)
    lib.fl_normalize_f32(_ptr(images, ctypes.c_uint8), len(images),
                         _ptr(_MEAN32, ctypes.c_float),
                         _ptr(_STD32, ctypes.c_float),
                         _ptr(out, ctypes.c_float),
                         _nthreads(len(images)))
    return out


# -- the plain NumPy reference (tests only) ----------------------------------

def _np_gather(dataset: np.ndarray, indices: np.ndarray) -> np.ndarray:
    return dataset[np.asarray(indices, np.int64)]


def _np_augment_u8(images: np.ndarray, offsets: np.ndarray,
                   flips: np.ndarray) -> np.ndarray:
    padded = np.pad(images, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    out = np.empty(images.shape, np.uint8)
    for i in range(len(images)):
        oy, ox = offsets[i]
        crop = padded[i, oy:oy + 32, ox:ox + 32]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


def _np_normalize(images: np.ndarray) -> np.ndarray:
    """The library's affine form, in its two f32 roundings."""
    return images.astype(np.float32) * AFFINE_SCALE + AFFINE_BIAS


def _np_augment(images: np.ndarray, offsets: np.ndarray,
                flips: np.ndarray) -> np.ndarray:
    return _np_normalize(_np_augment_u8(images, offsets, flips))


def _np_gather_augment_u8(dataset: np.ndarray, indices: np.ndarray,
                          offsets: np.ndarray, flips: np.ndarray
                          ) -> np.ndarray:
    return _np_augment_u8(_np_gather(dataset, indices), offsets, flips)


# -- the staging arena --------------------------------------------------------

class StagingArena:
    """Reusable chunk-aligned uint8 staging buffers for the chunked
    windowed host-augment path (``train/loop.py``).

    ``nslots`` preallocated [chunk_batches, batch, 32, 32, 3] host tensors
    (pinned when ``pin``, as on the card, so that their host-to-device
    copies run asynchronously; ``pin_memory`` needs CUDA) are handed out
    round-robin by ``acquire()`` as NumPy views, which the C++ library
    writes.  ``retire(slot, fence)`` records the ``torch.cuda.Event``
    recorded on the copy stream after the slot's host-to-device copy, and
    the next ``acquire()`` of that slot waits on it (``synchronize``)
    before the producer overwrites the host memory.  On the CPU the fence
    is None: ``copy_`` there is synchronous.

    The copies go into device-owned buffers (``copy_``), so no transfer
    ever aliases the arena's host memory, on the CPU or on the card, and
    the fence covers everything there is to wait for (the reference's
    aliasing probe of its CPU client has no counterpart here)."""

    def __init__(self, nslots: int, chunk_batches: int, batch: int, *,
                 pin: bool = False):
        if nslots < 2:
            raise ValueError(f"need >= 2 slots to overlap, got {nslots}")
        self.chunk_batches = chunk_batches
        self._slots = [torch.empty((chunk_batches, batch, 32, 32, 3),
                                   dtype=torch.uint8, pin_memory=pin)
                       for _ in range(nslots)]
        self._bufs = [t.numpy() for t in self._slots]
        self._pending = [None] * nslots
        self._next = 0

    @property
    def nslots(self) -> int:
        return len(self._slots)

    def tensor(self, slot: int) -> torch.Tensor:
        """A slot's host tensor: the source of its host-to-device copy."""
        return self._slots[slot]

    def buffer(self, slot: int) -> np.ndarray:
        """A slot's NumPy view, without the fence (tests); the producer
        goes through ``acquire``."""
        return self._bufs[slot]

    def acquire(self, *, fence_timeout_s: Optional[float] = None,
                on_timeout=None) -> Tuple[int, np.ndarray]:
        """-> (slot, buffer): the next writable slot, after waiting for the
        transfer that still reads it.

        ``fence_timeout_s`` / ``on_timeout`` arm a detection-only watchdog
        around the wait: ``synchronize`` is a native call that cannot be
        interrupted from Python, so a wedged transfer can only be
        reported; the consumer's stall deadline is what turns the report
        into recovery."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        fence = self._pending[i]
        if fence is not None:
            with Watchdog(fence_timeout_s, on_timeout=on_timeout):
                fence.synchronize()
            self._pending[i] = None
        return i, self._bufs[i]

    def retire(self, slot: int, fence) -> None:
        """Record the event after the transfer that reads ``slot`` (None:
        nothing in flight); the slot stays unwritable until it completes."""
        self._pending[slot] = fence
