"""Acoustic front end (seq2seq_attention_asr_tpu/data/features.py): the
on-device batched log-mel path, and the numpy offline path of the
corpus readers (log-mel with energy, the stacked log-mel, the CQT
variants, the corpus normalization and PCA).

Numerics follow the reference's offline extractor
(preprocess_timit.py:196-225, Python-2-era librosa): centered STFT with
n_fft 2048, hop 512 and a periodic Hann window, power spectrum, 128
slaney mel filters of which the first ``nfreqs`` are kept,
``10*log10(max(amin, S))`` clipped at max - 80 dB per utterance, an RMS
energy column, and width-9 deltas and delta-deltas -> (B, L, 123); or
the channel stack logmel | delta | delta-delta, (3, L, nfreqs), of the
VGG recipe. The CQT variants take method="pseudo" (log-spaced triangles
on the STFT) or "exact" (direct constant-Q kernels, cqt_exact_np).

The constants, the filterbanks and the numpy functions are this
package's own copies of the JAX package's numpy code, with its results.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 2048
HOP = 512
AMIN = 1e-10
TOP_DB = 80.0


def hz_to_mel(f):
    """Slaney mel scale (librosa htk=False default)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f / f_sp,
    )


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int = N_FFT, n_mels: int = 128) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalized triangular filters."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float64)


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (scipy/librosa), float32."""
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def frames_for_samples(n_samples: int, hop: int = HOP) -> int:
    """Number of centered-STFT frames for an n_samples signal."""
    return 1 + n_samples // hop


def stft_np(y: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """Centered STFT -> (1 + n_fft//2, n_frames) complex."""
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann (scipy/librosa)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(y[idx] * window[None, :], n=n_fft, axis=1).T


def power_to_db(S: np.ndarray, amin: float = AMIN, top_db: float = TOP_DB) -> np.ndarray:
    """librosa.core.logamplitude with ref=1.0, clipped at max - top_db."""
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def delta_np(data: np.ndarray, width: int = 9, order: int = 1, axis: int = -1) -> np.ndarray:
    """Old-librosa delta: delta[i] = sum_m m * x[i + m] for m in [-h, h], h =
    width // 2, edge-padded, unnormalized; order 2 applies it twice."""
    half = width // 2
    kernel = np.arange(-half, half + 1, dtype=np.float64)
    out = data.astype(np.float64)
    for _ in range(order):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (half, half)
        padded = np.pad(out, pad, mode="edge")
        out = np.apply_along_axis(lambda m: np.correlate(m, kernel, mode="valid"), axis, padded)
    return out


def rms_energy_np(S_power: np.ndarray) -> np.ndarray:
    """Per-frame RMS from the power spectrogram (old librosa rmse)."""
    return np.sqrt(np.mean(S_power, axis=0))


def _power_and_db(y: np.ndarray, sr: int, n_fft: int, hop: int, nfreqs: int, n_mels: int):
    """The power spectrogram (1 + n_fft // 2, L) and the first nfreqs
    mel bands in dB (nfreqs, L): what logmel_np and logmel_stacked_np
    share."""
    S = np.abs(stft_np(y, n_fft, hop)) ** 2
    return S, power_to_db(mel_filterbank(sr, n_fft, n_mels) @ S)[:nfreqs]


def logmel_np(y: np.ndarray, sr: int, n_fft: int = N_FFT, hop: int = HOP, nfreqs: int = 40,
              n_mels: int = 128) -> np.ndarray:
    """(L, 3 (nfreqs + 1)): log-mel and RMS energy, with deltas and
    delta-deltas (preprocess_timit.py:196-209; nfreqs 40 -> 123 dims),
    the TIMIT and chorowski recipes' input."""
    S, lm = _power_and_db(y, sr, n_fft, hop, nfreqs, n_mels)
    spectr = np.vstack([lm, rms_energy_np(S)[None, :]])
    d1 = delta_np(spectr, order=1)
    d2 = delta_np(spectr, order=2)
    return np.vstack([spectr, d1, d2]).T


def logmel_stacked_np(y: np.ndarray, sr: int, n_fft: int = N_FFT, hop: int = HOP,
                      nfreqs: int = 40, n_mels: int = 128) -> np.ndarray:
    """(3, L, nfreqs): log-mel, delta and delta-delta stacked as channels
    (preprocess_timit.py:211-225), the VGG recipe's input."""
    _, lm = _power_and_db(y, sr, n_fft, hop, nfreqs, n_mels)
    d1 = delta_np(lm, order=1)
    d2 = delta_np(lm, order=2)
    return np.stack([lm.T, d1.T, d2.T], axis=0)


@functools.lru_cache(maxsize=8)
def pseudo_cqt_filterbank(
    sr: int, n_fft: int = N_FFT, n_bins: int = 84, fmin: Optional[float] = None, bins_per_octave: int = 12
) -> np.ndarray:
    """Log-spaced triangular filterbank approximating CQT bin centers.

    Documented deviation: librosa.cqt is a multirate filterbank; this
    projects the STFT onto geometrically spaced triangles (pseudo-CQT).
    """
    fmin = fmin or 32.703195662574829  # C1, librosa default
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    edges = fmin * 2.0 ** ((np.arange(n_bins + 2) - 1) / bins_per_octave)
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    ramps = edges[:, None] - fft_freqs[None, :]
    fdiff = np.diff(edges)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights.astype(np.float64), freqs


def cqt_exact_np(
    y: np.ndarray,
    sr: int,
    n_bins: int = 84,
    hop: int = HOP,
    fmin: Optional[float] = None,
    bins_per_octave: int = 12,
) -> np.ndarray:
    """Exact constant-Q magnitude transform -> (n_bins, n_frames).

    The mathematically exact transform librosa's multirate CQT
    (preprocess_timit.py:228-253 calls librosa.cqt) computes
    efficiently: per bin k, the magnitude of the correlation of the
    (center-padded) signal with a hann-windowed complex exponential at
    f_k whose length N_k = ceil(Q * sr / f_k), Q = 1/(2^(1/bpo) - 1) —
    i.e. constant Q = f_k / bandwidth per bin. Kernels are L1-normalized
    (unit window sum) so a unit-amplitude tone at f_k reads ~0.5 in
    every bin regardless of frequency. Multirate decimation is an
    EFFICIENCY device, not a semantics change, so the direct form is
    the correctness reference; tests/test_data.py measures the
    pseudo-CQT's deviation from this (large below ~bin 24 where the
    2048-pt STFT can't resolve constant-Q bandwidths, small above).
    """
    fmin = fmin or 32.703195662574829  # C1, librosa default
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    n_frames = 1 + len(y) // hop
    centers = hop * np.arange(n_frames)
    n_max = int(np.ceil(q * sr / freqs[0]))
    ypad = np.pad(y.astype(np.float64), n_max // 2 + 1)
    out = np.empty((n_bins, n_frames))
    for k, f in enumerate(freqs):
        n_k = int(np.ceil(q * sr / f))
        win = np.hanning(n_k)
        t = (np.arange(n_k) - n_k / 2.0) / sr
        kernel = win * np.exp(2j * np.pi * f * t)
        kernel /= win.sum()
        # frames centered at each hop position in the padded signal
        start = centers + (n_max // 2 + 1) - n_k // 2
        idx = start[:, None] + np.arange(n_k)[None, :]
        out[k] = np.abs(ypad[idx] @ kernel)
    return out


def _cqt_parts(y: np.ndarray, sr: int, n_bins: int, hop: int, nfreqs,
               method: str = "pseudo"):
    """Shared CQT pipeline: spectrogram, CQT magnitudes, deltas.

    method="pseudo": log-spaced triangles on the 2048-pt STFT (fast,
    resolution-limited at low bins); "exact": direct constant-Q kernels
    (cqt_exact_np). Both feed the same delta/energy assembly."""
    S = np.abs(stft_np(y, N_FFT, hop)) ** 2
    if method == "pseudo":
        fb, _ = pseudo_cqt_filterbank(sr, N_FFT, n_bins)
        cqt = np.sqrt(fb @ S)
    elif method == "exact":
        cqt = cqt_exact_np(y, sr, n_bins, hop)
        cqt = cqt[:, : S.shape[1]]
    else:
        raise ValueError(f"method must be 'pseudo' or 'exact', got {method!r}")
    if nfreqs is not None:
        cqt = cqt[:nfreqs]
    return S, cqt, delta_np(cqt, order=1), delta_np(cqt, order=2)


def cqt_np(
    y: np.ndarray, sr: int, n_bins: int = 84, hop: int = HOP,
    nfreqs: Optional[int] = None, method: str = "pseudo",
) -> np.ndarray:
    """CQT variant of preprocess_timit.py:228-240: (L, 3*nb+1)."""
    S, cqt, d1, d2 = _cqt_parts(y, sr, n_bins, hop, nfreqs, method)
    energy = rms_energy_np(S)[None, :]
    return np.vstack([cqt, d1, d2, energy]).T


def cqt_stacked_np(
    y: np.ndarray, sr: int, n_bins: int = 84, hop: int = HOP,
    nfreqs: Optional[int] = None, method: str = "pseudo",
) -> np.ndarray:
    """(3, L, nb) channel-stacked CQT/delta/delta-delta — the
    CQT_stacked dataset variant (preprocess_timit.py:241-253)."""
    _, cqt, d1, d2 = _cqt_parts(y, sr, n_bins, hop, nfreqs, method)
    return np.stack([cqt.T, d1.T, d2.T], axis=0)


def normalize_corpus(train_feats, *other_splits, pad: int = 10):
    """Train-set mean and std normalization, then `pad` zero frames at both
    ends (preprocess_timit.py:261-314). Splits are lists of (L_i, D)
    arrays, or of (3, L_i, D) channel stacks (statistics over the frames
    of each channel and bin). Returns (each split normalized..., mean,
    std)."""
    stacked = train_feats[0].ndim == 3
    axis = 1 if stacked else 0
    cat = np.concatenate(train_feats, axis=axis)
    mean = cat.mean(axis=axis, keepdims=True)
    std = cat.std(axis=axis, keepdims=True)

    def norm(split):
        out = []
        for f in split:
            g = (f - mean) / std
            if stacked:
                z = np.zeros((f.shape[0], pad, f.shape[2]))
                g = np.concatenate([z, g, z], axis=1)
            else:
                z = np.zeros((pad, f.shape[1]))
                g = np.vstack([z, g, z])
            out.append(g)
        return out

    return (norm(train_feats), *(norm(s) for s in other_splits), mean, std)


def delta_batched(x: torch.Tensor, width: int = 9, n_frames=None) -> torch.Tensor:
    """Width-9 centered ramp delta, edge-padded, unnormalized: (B, L, D)
    -> (B, L, D), delta[i] = sum_m m * x[i + m] for m in [-4, 4].

    n_frames: optional (B,) true frame counts; the edge padding then
    clamps at each row's own last frame, so a short member of a padded
    batch gets its per-utterance deltas."""
    half = width // 2
    b, l, d = x.shape
    offs = torch.arange(-half, half + 1, device=x.device)
    idx = torch.arange(l, device=x.device)[:, None] + offs[None, :]  # (L, W)
    if n_frames is None:
        idx = idx.clamp(0, l - 1).expand(b, l, width)
    else:
        last = torch.clamp(torch.as_tensor(n_frames, device=x.device), min=1) - 1
        idx = torch.minimum(idx.clamp(min=0)[None], last.long()[:, None, None])
    win = torch.gather(x, 1, idx.reshape(b, l * width, 1).expand(b, l * width, d))
    return torch.einsum("blkd,k->bld", win.reshape(b, l, width, d), offs.to(x.dtype))


def assemble(lm, energy, nfreqs: int, mean=None, std=None, n_frames=None):
    """(B, L, 128) dB and (B, L) energy -> (B, L, 3*(nfreqs+1)) features:
    per-utterance top_db clip (over each row's true frames when
    `n_frames` is given), the nfreqs slice, deltas, normalization."""
    if n_frames is None:
        peak = torch.amax(lm, dim=(1, 2), keepdim=True)
    else:
        valid = torch.arange(lm.shape[1], device=lm.device)[None, :, None] < n_frames[:, None, None]
        peak = torch.amax(torch.where(valid, lm, -torch.inf), dim=(1, 2), keepdim=True)
    lm = torch.maximum(lm, peak - TOP_DB)[..., :nfreqs]
    spectr = torch.cat([lm, energy[..., None]], dim=-1)
    d1 = delta_batched(spectr, n_frames=n_frames)
    d2 = delta_batched(d1, n_frames=n_frames)
    feats = torch.cat([spectr, d1, d2], dim=-1)
    if mean is not None:
        kw = dict(device=feats.device, dtype=torch.float32)
        feats = (feats - torch.as_tensor(mean, **kw)) / torch.as_tensor(std, **kw)
    return feats


def logmel_rfft(y: torch.Tensor, sr: int = 16000, nfreqs: int = 40, n_mels: int = 128,
                mean=None, std=None, n_samples=None) -> torch.Tensor:
    """Batched log-mel through torch.fft.rfft: (B, N) padded PCM ->
    (B, L, 3*(nfreqs+1)), L = 1 + N // hop. Twin of the JAX package's
    logmel_jax.

    n_samples: optional (B,) true PCM lengths. The centered STFT's
    reflect padding then happens about each row's OWN end (reflect-
    mapped gather indices), deltas clamp at its true frame count and
    the top_db peak ignores frames past it, so every row's true frames
    match the per-utterance offline pipeline."""
    y = y.float()
    b, n = y.shape
    pad = N_FFT // 2
    n_frames = 1 + n // HOP
    window = torch.from_numpy(hann_window()).to(y.device)
    if n_samples is None:
        if n <= pad:
            raise ValueError(f"logmel: {n} samples, reflect padding needs more than {pad}")
        yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = yp.unfold(1, N_FFT, HOP)[:, :n_frames] * window
        nf_true = None
    else:
        ns = torch.as_tensor(n_samples, device=y.device).long()
        nf_true = 1 + ns // HOP
        pos = (HOP * torch.arange(n_frames, device=y.device))[:, None] - pad + torch.arange(
            N_FFT, device=y.device
        )[None, :]  # (L, n_fft) signal positions, out-of-range included
        # np.pad(mode="reflect") for any position: fold into the period
        # 2n - 2 triangle wave.
        period = torch.clamp(2 * ns - 2, min=1)[:, None, None]
        q = torch.remainder(pos[None], period)
        r = torch.minimum(q, period - q)
        frames = torch.gather(y, 1, r.reshape(b, -1)).reshape(b, n_frames, N_FFT) * window
    power = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2  # (B, L, F)
    fb = torch.from_numpy(mel_filterbank(sr, N_FFT, n_mels).T.astype(np.float32)).to(y.device)
    lm = 10.0 * torch.log10(torch.clamp(power @ fb, min=AMIN))
    energy = torch.sqrt(torch.mean(power, dim=-1))
    return assemble(lm, energy, nfreqs, mean, std, n_frames=nf_true)


def logmel_device(y: torch.Tensor, sr: int = 16000, nfreqs: int = 40, mean=None, std=None,
                  n_samples=None) -> torch.Tensor:
    """Batched log-mel front end.

    Without `n_samples`: the fused STFT -> mel -> dB kernel (K3,
    ops/cuda/logmel.py) over the whole padded buffer. With `n_samples`
    (exact per-utterance parity): the rfft path, which reflect-pads
    each row about its own end."""
    if n_samples is not None:
        return logmel_rfft(y, sr, nfreqs=nfreqs, mean=mean, std=std, n_samples=n_samples)
    from ..ops.cuda import logmel

    return logmel.logmel_fused(y, sr, nfreqs=nfreqs, mean=mean, std=std)


def pca_fit(train_feats, n_components: int):
    """Fit PCA on stacked train frames (reference preprocess_timit.py:
    316-333 uses sklearn PCA; this is the plain SVD equivalent).

    Returns (components (D, n), mean (D,)).
    """
    frames = np.concatenate([np.asarray(f) for f in train_feats], axis=0)
    mu = frames.mean(axis=0)
    centered = frames - mu
    # economy SVD of (N, D): right singular vectors are the components
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return vt[:n_components].T.astype(np.float32), mu.astype(np.float32)


def pca_apply(feats, components: np.ndarray, mean: np.ndarray):
    """Project each (L, D) utterance onto the fitted components."""
    return [((np.asarray(f) - mean) @ components).astype(np.float32) for f in feats]
