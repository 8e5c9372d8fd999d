"""ctypes bindings for the native matrix store (``matstore.cpp``).

Host code, not a device kernel: raw little-endian float64 matrices behind
a 32-byte header, with an FNV-1a checksum after the payload, and a fast
numeric CSV reader. ``matstore.cpp`` is a byte-for-byte copy of
``bigkrls_tpu/native/matstore.cpp``, so a file written by either package
reads in the other.

The shared library is built with ``g++ -O3 -shared -fPIC`` at first use
into ``bigkrls_tpu_torch/_build/``, keyed by a hash of the source, and
nothing is written beside the source. Without a compiler ``available()``
is False; ``read_csv`` then parses with numpy, ``mmap_matrix`` needs no
library, and the other functions raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "matstore.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CMD = ("-O3", "-shared", "-fPIC")
_MAGIC = 0x4B524C535F543130   # "KRLS_T10", the header's first word
_HEADER_BYTES = 32            # magic, rows, cols, dtype: four uint64
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _so_path() -> Path:
    digest = hashlib.sha256(" ".join(_CMD).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libmatstore_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CMD, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _so_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.matstore_write.restype = ctypes.c_int
        lib.matstore_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_uint64, ctypes.c_uint64]
        lib.matstore_read.restype = ctypes.c_int
        lib.matstore_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.matstore_header_bytes.restype = ctypes.c_int
        lib.matstore_header_bytes.argtypes = []
        lib.matstore_read_csv.restype = ctypes.c_longlong
        lib.matstore_read_csv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        if lib.matstore_header_bytes() != _HEADER_BYTES:
            raise RuntimeError("matstore.cpp's header is not 32 bytes")
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return _get_lib() is not None


def _need_lib() -> ctypes.CDLL:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native matstore unavailable (no C++ compiler)")
    return lib


def write_matrix(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` (1-D as one column) as float64 with its checksum."""
    lib = _need_lib()
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"write_matrix takes a 1-D or 2-D array, got "
                         f"{arr.ndim}-D")
    rc = lib.matstore_write(
        os.fsencode(path),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1])
    if rc != 0:
        raise IOError(f"matstore_write failed with code {rc}")


def read_matrix(path: str) -> np.ndarray:
    """Read a stored matrix after verifying its shape and checksum."""
    lib = _need_lib()
    rows = ctypes.c_uint64(0)
    cols = ctypes.c_uint64(0)
    rc = lib.matstore_read(os.fsencode(path), None, ctypes.byref(rows),
                           ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"matstore_read (query) failed with code {rc}")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.matstore_read(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"matstore_read failed with code {rc}")
    return out


def mmap_matrix(path: str) -> np.ndarray:
    """Zero-copy read-only view of a stored matrix's payload, past its
    header (the checksum is not verified)."""
    header = np.fromfile(path, dtype=np.uint64, count=4)
    if header.size != 4 or int(header[0]) != _MAGIC or int(header[3]) != 0:
        raise IOError(f"{path}: not a float64 matstore file")
    rows, cols = int(header[1]), int(header[2])
    return np.memmap(path, dtype=np.float64, mode="r", offset=_HEADER_BYTES,
                     shape=(rows, cols))


def read_csv(path: str) -> Tuple[np.ndarray, bool]:
    """Numeric CSV reader (the counterpart of ``read.big.matrix``).
    Returns ``(array, had_header)``."""
    lib = _get_lib()
    if lib is None:
        arr = np.loadtxt(path, delimiter=",", skiprows=0)
        return np.atleast_2d(arr), False
    rows = ctypes.c_longlong(0)
    cols = ctypes.c_longlong(0)
    hdr = ctypes.c_int(0)
    n = lib.matstore_read_csv(os.fsencode(path), None, 0, ctypes.byref(rows),
                              ctypes.byref(cols), ctypes.byref(hdr))
    if n < 0:
        raise IOError(f"matstore_read_csv (count) failed with code {n}")
    out = np.empty(n, dtype=np.float64)
    n2 = lib.matstore_read_csv(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(hdr))
    if n2 != n:
        raise IOError(f"matstore_read_csv failed with code {n2}")
    return out.reshape(rows.value, cols.value), bool(hdr.value)
