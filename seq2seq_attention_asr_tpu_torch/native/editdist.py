"""ctypes bindings of the native edit distance (editdist.cpp), the JAX
package's native/editdist.py ABI. ``calls`` counts the calls that went
through the library."""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from . import build

_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)
calls = 0


def _load() -> ctypes.CDLL:
    lib = build.load("editdist")
    lib.asr_edit_distance.restype = ctypes.c_int64
    lib.asr_edit_distance.argtypes = [_PI32, ctypes.c_int64, _PI32, ctypes.c_int64]
    lib.asr_batch_edit_distance.restype = None
    lib.asr_batch_edit_distance.argtypes = [_PI32, _PI64, _PI32, _PI64, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64, _PI64]
    return lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    global calls
    lib = _load()
    a, b = _as_i32(a), _as_i32(b)
    d = lib.asr_edit_distance(a.ctypes.data_as(_PI32), a.size, b.ctypes.data_as(_PI32), b.size)
    calls += 1
    return int(d)


def batch_edit_distance(a: np.ndarray, a_len: Sequence[int], b: np.ndarray,
                        b_len: Sequence[int]) -> np.ndarray:
    """a: (B, Ma) padded, b: (B, Mb); returns the (B,) int64 distances."""
    global calls
    lib = _load()
    a, b = _as_i32(a), _as_i32(b)
    al = np.ascontiguousarray(a_len, dtype=np.int64)
    bl = np.ascontiguousarray(b_len, dtype=np.int64)
    out = np.empty(a.shape[0], dtype=np.int64)
    lib.asr_batch_edit_distance(a.ctypes.data_as(_PI32), al.ctypes.data_as(_PI64),
                                b.ctypes.data_as(_PI32), bl.ctypes.data_as(_PI64), a.shape[0],
                                a.shape[1], b.shape[1], out.ctypes.data_as(_PI64))
    calls += 1
    return out
