"""ctypes bindings of the native batch packer (packing.cpp), the JAX
package's native/packing.py ABI: ragged (concatenated) views of a
dataset's features and labels, and their padded batches."""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from . import build

_PF = ctypes.POINTER(ctypes.c_float)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PI64 = ctypes.POINTER(ctypes.c_int64)


def _load() -> ctypes.CDLL:
    lib = build.load("packing")
    lib.asr_pack_batch.restype = None
    lib.asr_pack_batch.argtypes = [_PF, _PI64, _PI64, _PI64, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, _PF, _PI64]
    lib.asr_pack_labels.restype = None
    lib.asr_pack_labels.argtypes = [_PI32, _PI64, _PI64, _PI64, ctypes.c_int64, ctypes.c_int64,
                                    _PI32, _PI64]
    return lib


class RaggedFeatures:
    """Utterance features (L_i, D) concatenated along time."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        self.offsets = np.zeros(len(arrays) + 1, np.int64)
        np.cumsum([len(a) for a in arrays], out=self.offsets[1:])
        self.lengths = np.diff(self.offsets)
        self.flat = (np.ascontiguousarray(np.concatenate(arrays, axis=0), np.float32)
                     if arrays else np.zeros((0, 1), np.float32))
        self.dim = self.flat.shape[1] if self.flat.ndim == 2 else 1


class RaggedLabels:
    """Label sequences concatenated."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        self.offsets = np.zeros(len(arrays) + 1, np.int64)
        np.cumsum([len(a) for a in arrays], out=self.offsets[1:])
        self.lengths = np.diff(self.offsets)
        self.flat = (np.ascontiguousarray(np.concatenate(arrays), np.int32)
                     if arrays else np.zeros(0, np.int32))


def pack_batch(rf: RaggedFeatures, select: Sequence[int],
               l_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Utterances `select` zero-padded to (B, l_pad, D) (longer ones cut
    to l_pad), and their lengths."""
    lib = _load()
    sel = np.ascontiguousarray(select, np.int64)
    out = np.empty((sel.size, l_pad, rf.dim), np.float32)
    out_len = np.empty(sel.size, np.int64)
    lib.asr_pack_batch(rf.flat.ctypes.data_as(_PF), rf.offsets.ctypes.data_as(_PI64),
                       rf.lengths.ctypes.data_as(_PI64), sel.ctypes.data_as(_PI64), sel.size,
                       l_pad, rf.dim, out.ctypes.data_as(_PF), out_len.ctypes.data_as(_PI64))
    return out, out_len


def pack_labels(rl: RaggedLabels, select: Sequence[int],
                t_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Label sequences `select` zero-padded to (B, t_pad), and their lengths."""
    lib = _load()
    sel = np.ascontiguousarray(select, np.int64)
    out = np.empty((sel.size, t_pad), np.int32)
    out_len = np.empty(sel.size, np.int64)
    lib.asr_pack_labels(rl.flat.ctypes.data_as(_PI32), rl.offsets.ctypes.data_as(_PI64),
                        rl.lengths.ctypes.data_as(_PI64), sel.ctypes.data_as(_PI64), sel.size,
                        t_pad, out.ctypes.data_as(_PI32), out_len.ctypes.data_as(_PI64))
    return out, out_len
