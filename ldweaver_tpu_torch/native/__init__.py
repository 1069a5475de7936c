"""ctypes loader for the native host-side kernels (builds on demand).

The native library accelerates the host-side hot loops (gz FASTA ingest,
the ARACNE DPI scan); every consumer has a pure-NumPy fallback, so a
missing toolchain degrades gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "ldweaver_native.cpp")
_SO = os.path.join(_HERE, "libldweaver_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
        "-march=native", _SRC, "-o", _SO, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        # retry without -march=native (portability)
        try:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            return True
        except Exception:
            return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            _SRC
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ldw_scan_alignment.restype = ctypes.c_long
        lib.ldw_scan_alignment.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
        ]
        lib.ldw_extract_codes.restype = ctypes.c_long
        lib.ldw_extract_codes.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.ldw_aracne.restype = None
        lib.ldw_aracne.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib
