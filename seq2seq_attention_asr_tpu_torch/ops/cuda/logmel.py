"""Fused STFT power -> mel -> dB front end (kernel K3).

Replaces the Pallas kernel ``stft_logmel_power``
(seq2seq_attention_asr_tpu/ops/pallas/logmel.py:119, body ``_kernel``
:69) and its wrapper ``logmel_pallas`` (:157). The CUDA source is
``csrc/logmel.cu``; ``stft_logmel_power_plain`` below is the same
function in plain PyTorch.

The TPU kernel computes the spectrum as dense DFT matmuls because the
MXU makes them cheap; the CUDA kernel computes the same power spectrum
as a 1024-point complex FFT of the frame's even and odd samples in
registers, split into the 1025 real bins, and the mel product over each
filter's nonzero taps only. Its twiddles and taps are tables built here
once per device, in float64 and cast to float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...data import features
from . import build

N_FFT = features.N_FFT  # 2048
HOP = features.HOP  # 512
NFREQ = 1 + N_FFT // 2  # 1025 real bins
N_MELS = 128
HALF = N_FFT // 2  # the complex FFT's length
TAP_RUN = 16  # taps a chunk: no thread of the kernel chains more
TAP_SLOTS = 256  # chunks the kernel's table holds (csrc/logmel.cu kSlots)

KERNEL = build.Kernel(
    "stft_logmel_power", "logmel.cu", "stft_logmel_power",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


class Consts(NamedTuple):
    """The front end's tables on one device. The plain version reads the
    window and the dense filters; the kernel the window, the twiddles
    and the filters' taps in chunks:
      fft_tw (HALF, 2): exp(-2 pi i e / HALF), e < HALF (re, im);
      split_tw (HALF // 4 + 1, 2): exp(-2 pi i k / N_FFT), k <= 256;
      taps (TAP_SLOTS, TAP_RUN): chunk c's weights, for bins
        tap_start[c] + i, i < TAP_RUN, zero where the chunk ends;
      mel_first (N_MELS + 1,): filter m's chunks are
        [mel_first[m], mel_first[m + 1]), each of at most TAP_RUN taps;
      nchunks: mel_first[N_MELS], the slots that hold taps."""
    window: torch.Tensor
    melw: torch.Tensor
    fft_tw: torch.Tensor
    split_tw: torch.Tensor
    taps: torch.Tensor
    tap_start: torch.Tensor
    mel_first: torch.Tensor
    nchunks: int


def twiddles(n: int, count: int) -> np.ndarray:
    """exp(-2 pi i k / n) for k < count as float32 (re, im) pairs, taken
    in float64."""
    ang = -2.0 * np.pi * np.arange(count, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def mel_chunks(melw: np.ndarray):
    """Each filter's nonzero taps (a contiguous run of bins) cut into
    chunks of at most TAP_RUN, in filter order: (taps, tap_start,
    mel_first). A chunk that would run past the last bin starts earlier,
    its weights shifted to match, so every read stays in [0, NFREQ)."""
    taps = np.zeros((TAP_SLOTS, TAP_RUN), np.float32)
    start = np.zeros(TAP_SLOTS, np.int32)
    first = np.zeros(N_MELS + 1, np.int32)
    c = 0
    for m in range(N_MELS):
        first[m] = c
        nz = np.flatnonzero(melw[m])
        if nz.size == 0:
            continue
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        for a in range(lo, hi, TAP_RUN):
            n = min(TAP_RUN, hi - a)
            s = min(a, NFREQ - TAP_RUN)
            if c == TAP_SLOTS:
                raise ValueError(f"mel filters need more than {TAP_SLOTS} chunks of {TAP_RUN} taps")
            taps[c, a - s:a - s + n] = melw[m, a:a + n]
            start[c] = s
            c += 1
    first[N_MELS] = c
    return taps, start, first


@functools.lru_cache(maxsize=4)
def _consts(sr: int, device: str) -> Consts:
    """The tables for sample rate `sr`, as tensors on `device`."""
    melw = features.mel_filterbank(sr, N_FFT, N_MELS).astype(np.float32)
    taps, start, first = mel_chunks(melw)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Consts(as_t(features.hann_window()), as_t(melw), as_t(twiddles(HALF, HALF)),
                  as_t(twiddles(N_FFT, HALF // 4 + 1)), as_t(taps), as_t(start), as_t(first),
                  int(first[-1]))


def stft_logmel_power_plain(yp: torch.Tensor, sr: int):
    """Plain PyTorch twin: frames, rfft power, mel product, dB, energy."""
    c = _consts(sr, str(yp.device))
    frames = yp.unfold(1, N_FFT, HOP) * c.window
    power = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2  # (B, L, NFREQ)
    lm = 10.0 * torch.log10(torch.clamp(power @ c.melw.T, min=features.AMIN))
    energy = torch.sqrt(torch.sum(power, dim=-1) / NFREQ)
    return lm, energy


def stft_logmel_power(yp: torch.Tensor, sr: int):
    """(B, S) reflect-padded PCM -> (lm (B, L, 128) dB, energy (B, L)),
    L = 1 + (S - n_fft) // hop. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if build.on_cpu(yp):
        return stft_logmel_power_plain(yp, sr)
    b, s = yp.shape
    if s < N_FFT:
        raise ValueError(f"stft_logmel_power: {s} samples, a frame needs {N_FFT}")
    nframes = 1 + (s - N_FFT) // HOP
    dev = yp.device
    build.check("yp", yp, (b, s), dev)
    c = _consts(sr, str(dev))
    lm = torch.empty((b, nframes, N_MELS), device=dev, dtype=torch.float32)
    energy = torch.empty((b, nframes), device=dev, dtype=torch.float32)
    KERNEL.launch(
        build.ptr(yp), build.ptr(c.window), build.ptr(c.fft_tw), build.ptr(c.split_tw),
        build.ptr(c.taps), build.ptr(c.tap_start), build.ptr(c.mel_first), build.ptr(lm),
        build.ptr(energy), b, s, nframes, NFREQ, c.nchunks, build.stream_of(yp),
    )
    return lm, energy


def logmel_fused(y: torch.Tensor, sr: int = 16000, nfreqs: int = 40, mean=None, std=None):
    """(B, N) PCM -> (B, L, 3*(nfreqs+1)) through the fused kernel: the
    twin of the JAX package's logmel_pallas (same numerics, same layout)."""
    pad = N_FFT // 2
    if y.shape[1] <= pad:
        raise ValueError(f"logmel: {y.shape[1]} samples, reflect padding needs more than {pad}")
    yp = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0].contiguous()
    lm, energy = stft_logmel_power(yp, sr)
    return features.assemble(lm, energy, nfreqs, mean, std)
