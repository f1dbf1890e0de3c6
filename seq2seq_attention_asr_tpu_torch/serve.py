"""PCM -> text serving (seq2seq_attention_asr_tpu/serve.py).

Raw PCM -> log-mel front end (kernel K3, or the exact rfft path) ->
the model's encoder -> batched beam search -> token ids; only
detokenization is on the host. For the flagship Chorowski model the
encoder is 3x BiGRU (kernel K1) and each beam step kernel K2; for the
conv+BiLSTM model (registry "conv_bilstm") the encoder is three
conv + pool blocks (8x shorter in time) and a BiLSTM (kernel K7), each
beam step kernel K8, and the beam runs for the encoder's lengths.

PCM lengths are bucketed so that the encoder length of a bucket is a
multiple of ``frame_bucket`` frames, as in the JAX package.

Usage:
    t = Transcriber(model, params, mean=mean, std=std, eos_id=61,
                    id_to_text=lambda ids: " ".join(phones[i] for i in ids))
    texts = t.transcribe(list_of_pcm_float_arrays)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import interop, resolve_device
from .data import features
from .decode import beam as beam_lib

HOP = features.HOP
SR = 16000


@dataclasses.dataclass
class Transcription:
    ids: np.ndarray  # token ids, eos stripped
    score: float  # total beam log-prob
    text: Optional[str] = None


def pack_bucket(pcms, idxs, frames, l_pad: int):
    """Pack bucket members into one (n, l_pad*HOP - 1) PCM matrix.

    The buffer is the widest length that still frames to exactly l_pad,
    so no trailing sample is dropped. Each row's tail holds the reflect
    continuation of its signal, the centered STFT's right padding about
    the true end, so the last frame's features match the per-utterance
    pipeline. Returns (pcm, true frame counts, true sample counts)."""
    n_samp = l_pad * HOP - 1
    x = np.zeros((len(idxs), n_samp), np.float32)
    nf = np.zeros((len(idxs),), np.int32)
    ns = np.zeros((len(idxs),), np.int32)
    for j, i in enumerate(idxs):
        p = np.asarray(pcms[i], np.float32)
        x[j, : len(p)] = p
        tail = min(n_samp - len(p), len(p) - 1)
        if tail > 0:
            x[j, len(p) : len(p) + tail] = np.pad(p, (0, tail), mode="reflect")[len(p):]
        nf[j] = frames[i]
        ns[j] = len(p)
    return x, nf, ns


class Transcriber:
    """Batched PCM -> text on one device.

    mean/std: corpus normalization statistics; pad_frames: zero frames
    added at both ends, as the offline pipeline does (10 for TIMIT).
    exact=True reflect-pads each utterance about its own end (features
    match the per-utterance pipeline on every bucket member); False runs
    the fused front-end kernel over the padded buffer.
    """

    def __init__(self, model, params, *, eos_id: int, mean=None, std=None, pad_frames: int = 10,
                 beam_k: int = 5, len_factor: float = 1.0, exact: bool = True,
                 id_to_text: Optional[Callable[[Sequence[int]], str]] = None,
                 frame_bucket: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        # device-resident once: a checkpoint's numpy arrays are copied here
        self.params = interop.to_torch(params, self.device)
        self.eos_id = int(eos_id)
        f32 = dict(device=self.device, dtype=torch.float32)
        self.mean = None if mean is None else torch.as_tensor(np.asarray(mean, np.float32), **f32)
        self.std = None if std is None else torch.as_tensor(np.asarray(std, np.float32), **f32)
        self.pad_frames = int(pad_frames)
        self.beam_k = int(beam_k)
        self.len_factor = float(len_factor)
        self.exact = bool(exact)
        self.id_to_text = id_to_text
        self.frame_bucket = int(frame_bucket)

    def _run(self, pcm, n_frames, n_samples, l_pad: int) -> beam_lib.BeamResult:
        pad = self.pad_frames
        feats = features.logmel_device(
            pcm, SR, mean=self.mean, std=self.std,
            n_samples=n_samples if self.exact else None,
        )
        if pad:
            z = feats.new_zeros((feats.shape[0], pad, feats.shape[2]))
            feats = torch.cat([z, feats, z], dim=1)
        h, h_len = self.model.encode(self.params, feats, n_frames + 2 * pad)
        cap = int(math.ceil(self.len_factor * (l_pad + 2 * pad)))
        max_steps = torch.clamp((self.len_factor * h_len.float()).to(torch.long), max=cap)
        return beam_lib.beam_search(
            self.params["decoder"], self.model.attention_cfg, h, h_len, self.eos_id,
            k=self.beam_k, max_steps=max_steps, max_steps_cap=cap, device=self.device,
        )

    @torch.no_grad()
    def transcribe(self, pcms: Sequence[np.ndarray]) -> List[Transcription]:
        """pcms: float arrays in [-1, 1) at 16 kHz, any lengths. Groups
        utterances into frame-count buckets, runs each bucket as one
        batch, returns results in input order."""
        frames = [features.frames_for_samples(len(p)) for p in pcms]
        buckets = {}
        for i, f in enumerate(frames):
            l_pad = -(-f // self.frame_bucket) * self.frame_bucket
            buckets.setdefault(l_pad, []).append(i)

        out: List[Optional[Transcription]] = [None] * len(pcms)
        for l_pad, idxs in sorted(buckets.items()):
            x, nf, ns = pack_bucket(pcms, idxs, frames, l_pad)
            as_dev = lambda a: torch.from_numpy(a).to(self.device)
            res = self._run(as_dev(x), as_dev(nf).long(), as_dev(ns).long(), l_pad)
            toks = res.tokens.cpu().numpy()
            lens = res.lengths.cpu().numpy()
            scores = res.scores.cpu().numpy()
            for j, i in enumerate(idxs):
                ids = toks[j, : int(lens[j])]
                if len(ids) and ids[-1] == self.eos_id:
                    ids = ids[:-1]
                t = Transcription(ids=ids, score=float(scores[j]))
                if self.id_to_text is not None:
                    t.text = self.id_to_text(ids)
                out[i] = t
        return out  # type: ignore[return-value]
