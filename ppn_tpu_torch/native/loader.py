"""ctypes wrapper of the native JPEG decode+resize pool (port of
``ppn_tpu/native/loader.py``).

``loader.cc`` is built at first use with g++ and the reference Makefile's
flags into ``build/ppn_tpu_torch/`` (a directory ``.gitignore`` lists),
against the libjpeg ABI-62 headers in ``include/`` and the libjpeg-turbo
that the imported Pillow wheel ships in its ``pillow.libs`` directory,
linked by file name with an rpath to that directory. The build holds a
file lock and publishes the library with an atomic rename, so concurrent
processes neither build twice at once nor load a half-written file; it
runs again when ``loader.cc`` is newer than the library.

There is no PIL fallback: when g++, the ``pillow.libs`` directory or an
ABI-62 libjpeg in it is missing, every entry point raises ``RuntimeError``
naming what is missing. PIL is imported only to find that directory.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "loader.cc"
INCLUDE = _DIR / "include"
BUILD_DIR = _DIR.parents[1] / "build" / "ppn_tpu_torch"
LIB = BUILD_DIR / "libppn_jpeg.so"
# ppn_tpu/native/Makefile's CXXFLAGS: -march=native lets g++ contract the
# resize's products into FMAs, so a build without it differs in the last
# bits from the reference's
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def pillow_libs() -> Path:
    """The ``pillow.libs`` directory beside the imported PIL package (where
    a Pillow wheel keeps the shared libraries it was built with)."""
    import PIL

    return Path(PIL.__file__).resolve().parents[1] / "pillow.libs"


def libjpeg() -> Path:
    """The ABI-62 libjpeg-turbo in ``pillow_libs()``. Raises
    ``RuntimeError`` naming the directory when it or the library is
    missing."""
    libs = pillow_libs()
    if not libs.is_dir():
        raise RuntimeError(
            f"native JPEG loader: no pillow.libs directory at {libs} (a PIL "
            "not installed from a wheel ships no libjpeg to link against)")
    found = sorted(libs.glob("libjpeg*.so*"))
    abi62 = [p for p in found if ".so.62" in p.name]
    if not abi62:
        raise RuntimeError(
            f"native JPEG loader: no ABI-62 libjpeg (libjpeg*.so.62*) in "
            f"{libs}; found {[p.name for p in found] or 'no libjpeg'}")
    return abi62[0]


def _build(jpeg: Path) -> None:
    """Compile ``loader.cc`` into ``LIB`` unless an up-to-date one exists,
    under a file lock, publishing it with an atomic rename."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native JPEG loader: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libppn_jpeg.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if LIB.exists() and LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
            return
        tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
        cmd = [gxx, *CXXFLAGS, "-I", str(INCLUDE), "-shared", "-o", str(tmp),
               str(SOURCE), "-L", str(jpeg.parent), f"-l:{jpeg.name}",
               f"-Wl,-rpath,{jpeg.parent}", "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native JPEG loader: g++ failed:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, LIB)


def load() -> ctypes.CDLL:
    """The loaded library, built first when missing or out of date. Raises
    ``RuntimeError`` naming what is missing when it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _build(libjpeg())
        lib = ctypes.CDLL(str(LIB))
        lib.ppn_jpeg_dims.restype = ctypes.c_int
        lib.ppn_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ppn_decode_resize.restype = ctypes.c_int
        lib.ppn_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.ppn_loader_create.restype = ctypes.c_void_p
        lib.ppn_loader_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
        lib.ppn_loader_submit.restype = None
        lib.ppn_loader_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.ppn_loader_get.restype = ctypes.c_int64
        lib.ppn_loader_get.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.ppn_loader_pending.restype = ctypes.c_int
        lib.ppn_loader_pending.argtypes = [ctypes.c_void_p]
        lib.ppn_loader_destroy.restype = None
        lib.ppn_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (nothing else changes when
    it does not: the entry points raise)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _out_hw(out_size) -> Tuple[int, int]:
    H, W = (int(v) for v in out_size)
    if H < 1 or W < 1:
        raise ValueError(f"output size {tuple(out_size)} must be positive")
    return H, W


def jpeg_dims(jpeg_bytes: bytes) -> Tuple[int, int]:
    """(width, height) from the JPEG header, without a full decode (dataset
    loaders scale their GT by the original size). Raises ``ValueError`` on
    a buffer whose header does not read."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().ppn_jpeg_dims(jpeg_bytes, len(jpeg_bytes), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        raise ValueError("corrupt JPEG (header unreadable)")
    return int(w.value), int(h.value)


def decode_resize(jpeg_bytes: bytes, out_size: Tuple[int, int]
                  ) -> np.ndarray:
    """JPEG bytes → (H, W, 3) float32 RGB in [0, 1] at ``out_size`` (H, W):
    libjpeg decode, then the half-pixel bilinear resize. Raises
    ``ValueError`` when the decode fails."""
    H, W = _out_hw(out_size)
    lib = load()
    out = np.empty((H, W, 3), np.float32)
    if lib.ppn_decode_resize(jpeg_bytes, len(jpeg_bytes), H, W,
                             out.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_float))) != 0:
        raise ValueError("native JPEG decode failed (corrupt input?)")
    return out


class NativeJpegLoader:
    """Asynchronous decode+resize pool of ``num_workers`` threads.

    ``submit(id, jpeg_bytes)`` from any thread; ``get()`` blocks for the
    next finished frame → ``(id, (H, W, 3) float32)``, or ``(id, None)``
    when that frame failed to decode. Frames complete out of order: carry
    the ids."""

    def __init__(self, out_size: Tuple[int, int], num_workers: int = 4):
        if num_workers < 1:
            raise ValueError(f"num_workers {num_workers} must be at least 1")
        self._lib = load()
        self._h, self._w = _out_hw(out_size)
        self._handle = self._lib.ppn_loader_create(num_workers, self._h,
                                                   self._w)

    def submit(self, job_id: int, jpeg_bytes: bytes) -> None:
        if job_id < 0:
            raise ValueError(f"job id {job_id} must be non-negative (a "
                             "failure comes back as -(id + 2))")
        self._lib.ppn_loader_submit(self._handle, job_id, jpeg_bytes,
                                    len(jpeg_bytes))

    def get(self) -> Tuple[int, Optional[np.ndarray]]:
        out = np.empty((self._h, self._w, 3), np.float32)
        rid = self._lib.ppn_loader_get(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rid < 0:
            return (-int(rid) - 2, None)  # decode failure for that id
        return (int(rid), out)

    def pending(self) -> int:
        """Jobs submitted and not yet taken by ``get``."""
        return self._lib.ppn_loader_pending(self._handle)

    def close(self) -> None:
        """Stop the workers (each finishes the queued jobs first)."""
        if self._handle:
            self._lib.ppn_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
