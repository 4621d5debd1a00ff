"""ctypes bindings for the native CSV codec (utils/trajio.py counterpart).

native/trajio.cpp is built with g++ on first use into the package's
_build/ directory (keyed by a hash of the source and flags, never into the
source tree) and loaded once per process. Unlike the JAX module there is
no numpy fallback: np.savetxt writes other bytes, so a missing g++ raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "trajio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libtrajio_{digest}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the CSV codec (native/trajio.cpp) needs it")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.trajio_read_csv.argtypes = [ctypes.c_char_p, ctypes.POINTER(dptr),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.trajio_read_csv.restype = ctypes.c_int
    lib.trajio_free.argtypes = [dptr]
    lib.trajio_free.restype = None
    lib.trajio_write_csv.argtypes = [ctypes.c_char_p, dptr, ctypes.c_int64, ctypes.c_int64]
    lib.trajio_write_csv.restype = ctypes.c_int
    return lib


def read_csv(path: str) -> np.ndarray:
    """CSV -> (rows, cols) float64 array."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.trajio_read_csv(os.fsencode(path), ctypes.byref(out), ctypes.byref(rows),
                             ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"trajio_read_csv({path!r}) failed with code {rc}")
    n = rows.value * cols.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else np.zeros(0)
    finally:
        lib.trajio_free(out)
    return arr.reshape(rows.value, cols.value)


def write_csv(path: str, arr: np.ndarray) -> None:
    """A (rows, cols) or (rows,) array as CSV, 17 significant digits."""
    a = np.ascontiguousarray(arr, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    rc = _lib().trajio_write_csv(os.fsencode(path),
                                 a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                 a.shape[0], a.shape[1])
    if rc != 0:
        raise OSError(f"trajio_write_csv({path!r}) failed with code {rc}")
