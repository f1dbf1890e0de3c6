"""ctypes bindings of the native FLAC decoder (flacdec.cpp), the JAX
package's native/flacdec.py ABI: `decode(data) -> (pcm (N, channels)
int32, sample_rate)`. A malformed stream or a CRC mismatch raises
ValueError (data/flac.py::decode_flac turns it into FlacError).
``decodes`` counts the streams decoded through the library."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import build

_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_ERRORS = {-1: "bad STREAMINFO", -2: "malformed frame", -4: "CRC mismatch"}
decodes = 0


def _load() -> ctypes.CDLL:
    lib = build.load("flacdec")
    lib.asr_flac_info.restype = ctypes.c_int64
    lib.asr_flac_info.argtypes = [_PU8, ctypes.c_int64, _PI64]
    lib.asr_flac_decode.restype = ctypes.c_int64
    lib.asr_flac_decode.argtypes = [_PU8, ctypes.c_int64, _PI32, ctypes.c_int64]
    return lib


def decode(data: bytes) -> Tuple[np.ndarray, int]:
    global decodes
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(_PU8)
    info = np.zeros(5, np.int64)
    if lib.asr_flac_info(bp, len(data), info.ctypes.data_as(_PI64)) != 0:
        raise ValueError("flacdec: bad STREAMINFO")
    total, sr, nch, _bps, _off = (int(v) for v in info)
    if total <= 0:
        # unknown length: start from a size-bounded guess and double it
        # while the decoder runs out of room
        total = max(len(data) * 4, 1 << 16)
    out = np.empty(total * nch, np.int32)
    n = lib.asr_flac_decode(bp, len(data), out.ctypes.data_as(_PI32), out.size)
    while n == -3:
        out = np.empty(out.size * 2, np.int32)
        n = lib.asr_flac_decode(bp, len(data), out.ctypes.data_as(_PI32), out.size)
    if n < 0:
        raise ValueError(f"flacdec: {_ERRORS.get(int(n), 'decode error')} ({n})")
    decodes += 1
    return out[: int(n) * nch].reshape(int(n), nch), sr
