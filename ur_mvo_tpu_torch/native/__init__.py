"""ctypes bindings for the native host I/O runtime (``io_runtime.cpp``);
the port's own copy of ``ur_mvo_tpu.native``.

The shared library is built with ``g++`` at first use into
``build/ur_mvo_tpu_torch_native/`` beside the package (nothing is written
into the package), rebuilt when the source is newer, and exposes:

* :class:`ImagePrefetcher`: a multi-threaded in-order image loader (PGM
  and uint8 ``.npy``) with a bounded window of look-ahead,
* :class:`BoundedQueue`: a blocking byte queue with backpressure,
* :class:`NativeTumWriter`: a buffered TUM trajectory writer.

Importing this module builds nothing. :func:`available` is False only
where no ``g++`` is found (``Dataset`` then reads with Python); with a
compiler present, a build or load error raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "io_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ur_mvo_tpu_torch_native"
LIBRARY = BUILD_DIR / "liburmvo_io.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """Compile into a temporary file beside the library and rename it into
    place, so that processes building at once never load a partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", str(SOURCE), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native: building {SOURCE.name} failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises if either fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIBRARY))
        lib.urmvo_prefetcher_create.restype = ctypes.c_void_p
        lib.urmvo_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.urmvo_prefetcher_get.restype = ctypes.c_int
        lib.urmvo_prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.urmvo_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.urmvo_queue_create.restype = ctypes.c_void_p
        lib.urmvo_queue_create.argtypes = [ctypes.c_long]
        lib.urmvo_queue_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.urmvo_queue_pop.restype = ctypes.c_long
        lib.urmvo_queue_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.urmvo_queue_size.restype = ctypes.c_long
        lib.urmvo_queue_size.argtypes = [ctypes.c_void_p]
        lib.urmvo_queue_close.argtypes = [ctypes.c_void_p]
        lib.urmvo_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.urmvo_tum_writer_create.restype = ctypes.c_void_p
        lib.urmvo_tum_writer_create.argtypes = [ctypes.c_char_p]
        lib.urmvo_tum_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.urmvo_tum_writer_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native runtime can be had: loaded already, or a ``g++``
    to build it is on the ``PATH``."""
    return _lib is not None or shutil.which("g++") is not None


class ImagePrefetcher:
    """In-order parallel image loader over a list of PGM / uint8 ``.npy`` paths."""

    def __init__(self, paths: Sequence[str], n_workers: int = 4, window: int = 16,
                 max_bytes: int = 8 * 1024 * 1024):
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.urmvo_prefetcher_create(arr, len(paths), n_workers, window)
        self._n = len(paths)
        self._buf = np.empty(max_bytes, np.uint8)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> Optional[np.ndarray]:
        h = ctypes.c_int()
        w = ctypes.c_int()
        ok = self._lib.urmvo_prefetcher_get(
            self._handle, idx,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self._buf.size,
            ctypes.byref(h), ctypes.byref(w),
        )
        if not ok:
            return None
        return self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def __iter__(self):
        for i in range(self._n):
            img = self.get(i)
            if img is not None:
                yield img

    def close(self) -> None:
        if self._handle:
            self._lib.urmvo_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class BoundedQueue:
    """Blocking bounded byte queue with backpressure."""

    def __init__(self, capacity: int = 3):
        self._lib = load_library()
        self._handle = self._lib.urmvo_queue_create(capacity)

    def push(self, data: np.ndarray) -> None:
        flat = np.ascontiguousarray(data, np.uint8).ravel()
        self._lib.urmvo_queue_push(self._handle, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size)

    def pop(self, max_bytes: int = 8 * 1024 * 1024) -> Optional[np.ndarray]:
        buf = np.empty(max_bytes, np.uint8)
        n = self._lib.urmvo_queue_pop(self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_bytes)
        if n < 0:
            return None
        return buf[:n].copy()

    def __len__(self) -> int:
        return int(self._lib.urmvo_queue_size(self._handle))

    def close(self) -> None:
        self._lib.urmvo_queue_close(self._handle)

    def destroy(self) -> None:
        if self._handle:
            self._lib.urmvo_queue_destroy(self._handle)
            self._handle = None


class NativeTumWriter:
    """Buffered TUM writer: ``timestamp tx ty tz qx qy qz qw`` a line."""

    def __init__(self, path: str):
        self._lib = load_library()
        self._handle = self._lib.urmvo_tum_writer_create(path.encode())

    def write(self, ts: float, t: np.ndarray, q_wxyz: np.ndarray) -> None:
        t = np.ascontiguousarray(t, np.float64)
        q = np.ascontiguousarray(q_wxyz, np.float64)
        self._lib.urmvo_tum_writer_write(
            self._handle, float(ts),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )

    def close(self) -> None:
        if self._handle:
            self._lib.urmvo_tum_writer_destroy(self._handle)
            self._handle = None
