"""Audio file readers: RIFF WAV and NIST SPHERE, no external codecs
(seq2seq_attention_asr_tpu/data/audio.py).

The reference reads audio with scikits.audiolab's ``Sndfile``
(timit/preprocess_timit.py:197-198), which returns float frames
normalized to [-1, 1). TIMIT ships NIST SPHERE files with a ``.WAV``
extension; LibriSpeech ships FLAC. audiolab handled both via libsndfile;
here all three containers are parsed natively (FLAC through the port's
C++ decoder, native/flacdec.cpp, data/flac.py). The functions and their
results are the JAX package's.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


class UnsupportedAudioFormat(RuntimeError):
    pass


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Normalize integer PCM to [-1, 1) float64 like libsndfile."""
    if data.dtype == np.int16:
        return data.astype(np.float64) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float64) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float64) - 128.0) / 128.0
    return data.astype(np.float64)


def read_sphere(path: str) -> Tuple[np.ndarray, int]:
    """NIST SPHERE reader (TIMIT's .WAV files).

    Header: 'NIST_1A\\n   <size>\\n' then 'key -type value' lines until
    'end_head'. Only PCM codings are read (TIMIT is ulaw-free 16-bit
    PCM); any other sample_coding raises UnsupportedAudioFormat.
    """
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise UnsupportedAudioFormat(f"{path}: not NIST SPHERE")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("latin-1")
        fields = {}
        for line in header.splitlines()[2:]:
            if line.strip() == "end_head":
                break
            parts = line.split(None, 2)
            if len(parts) == 3:
                fields[parts[0]] = parts[2]
        sr = int(fields.get("sample_rate", 16000))
        n = int(fields["sample_count"])
        nbytes = int(fields.get("sample_n_bytes", 2))
        fmt = fields.get("sample_coding", "pcm")
        byte_order = fields.get("sample_byte_format", "01")
        if "pcm" not in fmt:
            raise UnsupportedAudioFormat(f"{path}: sample_coding={fmt}")
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[nbytes]
        f.seek(header_size)
        data = np.frombuffer(f.read(n * nbytes), dtype=dtype)
        if nbytes > 1 and byte_order == "10":  # big-endian
            data = data.byteswap()
        return _pcm_to_float(data), sr


def read_riff_wav(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE PCM reader (mono or first channel)."""
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise UnsupportedAudioFormat(f"{path}: not RIFF/WAVE")
        sr, channels, bits = 16000, 1, 16
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
                (audio_fmt, channels, sr, _, _, bits) = struct.unpack(
                    "<HHIIHH", fmt[:16]
                )
                if audio_fmt not in (1, 0xFFFE):  # PCM / extensible
                    raise UnsupportedAudioFormat(
                        f"{path}: non-PCM wav (fmt={audio_fmt})"
                    )
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
        if data is None:
            raise UnsupportedAudioFormat(f"{path}: no data chunk")
        dtype = {8: np.uint8, 16: np.int16, 32: np.int32}[bits]
        pcm = np.frombuffer(data, dtype=dtype)
        if channels > 1:
            pcm = pcm[::channels]
        return _pcm_to_float(pcm), sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch by content: SPHERE, RIFF WAV, or .npy PCM.

    Returns (float64 samples in [-1, 1), sample_rate).
    """
    if path.endswith(".npy"):
        arr = np.load(path)
        return _pcm_to_float(np.asarray(arr)), 16000
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"NIST_1A"):
        return read_sphere(path)
    if magic.startswith(b"RIFF"):
        return read_riff_wav(path)
    if magic.startswith(b"fLaC"):
        from . import flac

        return flac.read_flac(path)
    raise UnsupportedAudioFormat(f"{path}: unrecognized audio container")
