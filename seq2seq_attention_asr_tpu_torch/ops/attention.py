"""Attention decoder (seq2seq_attention_asr_tpu/ops/attention.py).

One step, for beam search (the fused step, kernels K2 and K8) and as
the plain model of the kernels:

  e     = w_e . tanh(Vh + s_prev @ Ws + b_s [+ UF])  (Attention.lua:103-113)
  UF    = conv(alpha_prev) @ U, location-aware attention only
          (feature_maps > 0, Attention.lua:73-99)
  alpha = masked softmax of e over encoder positions
  c     = alpha^T h                                 (Attention.lua:129-136)
  r     = Linear(2S->S)(concat(Linear(c), Linear(y_prev)))
  s     = GRU(r, s_prev), mem passing through (model_chorowski_baseline.lua:
          48-51), or (s, mem) = LSTM(r, (s_prev, mem_prev)) (timit.lua:137)

and the readout decoder_mlp(concat(s, c)) -> log-probs. Training runs
the teacher-forced scan (``decode_teacher_forced``), one pair of kernels
for each decoder: the content-only GRU (K4 and K5), the location-aware
LSTM (K10 and K11), the location-aware GRU (K12 and K13) and the
content-only LSTM (K14 and K15). With mono_align and penalty_lambda > 0
the monotonic alignment penalty (ops/monotonic.py) is reported per step
and its ramp injected into the alignments' gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cells, readout
from .cells import torch_linear_init
from .cuda import attention_scan
from .masking import length_mask, masked_softmax
from .monotonic import (MonotonicAlignment, MonotonicAlignmentSeq, make_ramp,
                        monotonic_penalty_value)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """The decoder's widths, readout and attention options, with the JAX
    package's names. LSTM peepholes are not ported and are refused.
    The teacher-forced scan takes either cell with or without the
    location term (feature_maps > 0), and the monotonic penalty
    (mono_align and penalty_lambda > 0)."""

    score_depth: int
    state_depth: int
    annotation_depth: int
    output_depth: int
    readout: Tuple[Tuple, ...] = (("maxout", 64, 7), ("linear", 62))
    feature_maps: int = 0
    filt_size: int = 10
    cell: str = "gru"
    peepholes: bool = False
    mono_align: bool = True
    penalty_lambda: float = 0.0


def check_ported(cfg: AttentionConfig) -> None:
    """Raise for a decoder the port cannot step: LSTM peepholes, or a
    cell other than gru and lstm."""
    if cfg.cell not in ("gru", "lstm"):
        raise ValueError(f"unknown decoder cell {cfg.cell!r}")
    if cfg.cell == "lstm" and cfg.peepholes:
        raise NotImplementedError("LSTM peepholes are not ported")


def attention_init(generator: torch.Generator, cfg: AttentionConfig) -> Params:
    check_ported(cfg)
    a, s, st = cfg.annotation_depth, cfg.score_depth, cfg.state_depth
    p = {
        "v": torch_linear_init(generator, a, (a, s)),
        "ws": {
            "w": torch_linear_init(generator, st, (st, s)),
            "b": torch_linear_init(generator, st, (s,)),
        },
    }
    if cfg.feature_maps > 0:
        f, fm = cfg.filt_size, cfg.feature_maps
        # F: TemporalConvolution(1, featMaps, filtSize) with bias; U:
        # zero-bias 1x1 convolution featMaps -> scoreDepth.
        p["loc_conv"] = {"w": torch_linear_init(generator, f, (f, 1, fm)),
                         "b": torch_linear_init(generator, f, (fm,))}
        p["u"] = torch_linear_init(generator, fm, (fm, s))
    p.update({
        "w_e": torch_linear_init(generator, s, (s,)),
        "c_in": readout.linear_init(generator, a, st),
        "y_in": readout.linear_init(generator, cfg.output_depth, st),
        "dec_in": readout.linear_init(generator, 2 * st, st),
        "cell": (cells.gru_init(generator, st, st) if cfg.cell == "gru"
                 else cells.lstm_init(generator, st, st, cfg.peepholes)),
        "readout": readout.stack_init(generator, st + a, cfg.readout),
    })
    return p


def precompute_vh(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Annotation projection, hoisted out of the decoder loop: (B, L, A) -> (B, L, S)."""
    return h @ params["v"]


def init_state(cfg: AttentionConfig, batch: int, enc_len: int, device=None, dtype=torch.float32):
    """Zero (alpha, s, mem) — the reference's zero-state templates."""
    return (
        torch.zeros((batch, enc_len), device=device, dtype=dtype),
        torch.zeros((batch, cfg.state_depth), device=device, dtype=dtype),
        torch.zeros((batch, cfg.state_depth), device=device, dtype=dtype),
    )


def conv_pads(filt_size: int) -> Tuple[int, int]:
    """The location convolution's (left, right) zero padding
    (Attention.lua:77-85): an odd filter pads (f-1)/2 on both sides, an
    even one f/2 on the left and f/2-1 on the right, so that L positions
    come out."""
    if filt_size % 2 == 1:
        return (filt_size - 1) // 2, (filt_size - 1) // 2
    return filt_size // 2, filt_size // 2 - 1


def location_features(params: Params, cfg: AttentionConfig, alpha_prev: torch.Tensor) -> torch.Tensor:
    """UF = (conv1d(alpha_prev) + b) @ U: (B, L) -> (B, L, score_depth)."""
    w = params["loc_conv"]["w"][:, 0, :]  # (f, FM)
    l = alpha_prev.shape[1]
    ap = F.pad(alpha_prev, conv_pads(cfg.filt_size))
    feat = sum(ap[:, j : j + l, None] * w[j] for j in range(w.shape[0]))
    return (feat + params["loc_conv"]["b"]) @ params["u"]


def attention_weights(params: Params, cfg: AttentionConfig, s_prev, alpha_prev, vh,
                      enc_mask) -> torch.Tensor:
    """alpha (B, L) for one step, with the location term when feature_maps > 0."""
    ws = s_prev @ params["ws"]["w"] + params["ws"]["b"]
    z = vh + ws[:, None, :]
    if cfg.feature_maps > 0:
        z = z + location_features(params, cfg, alpha_prev)
    return masked_softmax(torch.tanh(z) @ params["w_e"], enc_mask)


def _cell_step(params: Params, cfg: AttentionConfig, r, s, mem):
    """decoder_recurrent: (s_new, mem_new). The GRU passes mem through;
    the LSTM's (s, mem) is its (h, c)."""
    if cfg.cell == "gru":
        return cells.gru_step(params["cell"], r, s), mem
    return cells.lstm_step(params["cell"], r, (s, mem))


def attention_step(params: Params, cfg: AttentionConfig, state, y_prev, vh, h, enc_mask,
                   ramp=None, unit_ramp=None):
    """One decoder step. state = (alpha_prev, s_prev, mem_prev); y_prev
    one-hot (B, V). ramp: the lambda-scaled injection ramp (None: no
    injection); unit_ramp: the lambda-free ramp of the penalty value
    (None: a zero penalty). Returns the new state and {s, c, alpha,
    penalty}, penalty (B,) scaled by penalty_lambda."""
    check_ported(cfg)
    alpha_prev, s_prev, mem = state
    alpha = attention_weights(params, cfg, s_prev, alpha_prev, vh, enc_mask)
    if unit_ramp is not None:
        penalty = monotonic_penalty_value(alpha, alpha_prev, unit_ramp)
    else:
        penalty = torch.zeros(alpha.shape[0], dtype=alpha.dtype, device=alpha.device)
    if cfg.mono_align and ramp is not None:
        alpha = MonotonicAlignment.apply(alpha, alpha_prev, ramp, penalty.detach())
    c = torch.einsum("bl,bld->bd", alpha, h)
    r = readout.linear_apply(
        params["dec_in"],
        torch.cat(
            [readout.linear_apply(params["c_in"], c), readout.linear_apply(params["y_in"], y_prev)],
            dim=-1,
        ),
    )
    s, mem = _cell_step(params, cfg, r, s_prev, mem)
    return (alpha, s, mem), {"s": s, "c": c, "alpha": alpha,
                             "penalty": cfg.penalty_lambda * penalty}


def apply_readout(params: Params, cfg: AttentionConfig, s: torch.Tensor, c: torch.Tensor,
                  *, generator: Optional[torch.Generator] = None,
                  train: bool = False) -> torch.Tensor:
    """decoder_mlp(concat(s, c)) -> log-probs, on any batch shape; a
    train-mode dropout layer draws from `generator`."""
    return readout.stack_apply(params["readout"], cfg.readout, torch.cat([s, c], dim=-1),
                               generator=generator, train=train)


def decode_teacher_forced(params: Params, cfg: AttentionConfig, h: torch.Tensor,
                          enc_lengths: torch.Tensor, labels_onehot: torch.Tensor,
                          dec_mask: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                          train: bool = False) -> Dict[str, torch.Tensor]:
    """Teacher-forced decode over all T output steps, the fused branch of
    the JAX package's decode_teacher_forced (ops/attention.py:320-434).

    h (B, L, A) annotations; labels_onehot (B, T, V); dec_mask (B, T).
    y_prev is the zero vector at step 0 and the label of step t-1 after
    (RNNAttention.lua:153-156, 174); the state starts at zero. The scan
    is one autograd function, chosen on (cell, feature_maps > 0) as the
    JAX package chooses its kernel (ops/attention.py:374-387):
    AttentionDecodeScan (K4, K5) for the content-only GRU,
    AttentionDecodeScanLoc (K12, K13) for the location-aware GRU,
    AttentionDecodeScanLSTM (K14, K15) for the content-only LSTM and
    AttentionDecodeScanLocLSTM (K10, K11) for the location-aware LSTM;
    the readout runs once over the stacked (s, c), its train-mode dropout
    drawn from `generator`. Returns logprobs (B, T, V), alpha (B, T, L),
    the decoder states s (B, T, St) and contexts c (B, T, A), and penalty
    (B, T).

    With mono_align and penalty_lambda > 0 (ops/attention.py:389-426 of
    the JAX package), every step's penalty value comes from the scan's
    alpha_seq against the ramp of the annotation lengths, the reported
    penalty is lambda * value * dec_mask, and alpha_seq passes through
    MonotonicAlignmentSeq, coupled into s_seq by a term of value zero:
    the loss reads logprobs only, and without the coupling autograd would
    never call that backward. The scan's alpha cotangent is then exactly
    the ramp injection. Otherwise penalty is zeros."""
    check_ported(cfg)
    enc_mask = length_mask(enc_lengths, h.shape[1], h.dtype)
    vh = precompute_vh(params, h)
    y_prev = torch.cat([torch.zeros_like(labels_onehot[:, :1]), labels_onehot[:, :-1]], dim=1)
    yin = readout.linear_apply(params["y_in"], y_prev)
    common = (vh.contiguous(), h.contiguous(), enc_mask, yin.contiguous(),
              params["ws"]["w"], params["ws"]["b"], params["w_e"], params["c_in"]["w"],
              params["c_in"]["b"], params["dec_in"]["w"], params["dec_in"]["b"])
    cell = params["cell"]
    loc = ((params["loc_conv"]["w"][:, 0, :], params["loc_conv"]["b"], params["u"])
           if cfg.feature_maps > 0 else ())
    if cfg.cell == "lstm":
        scan = (attention_scan.AttentionDecodeScanLocLSTM if loc
                else attention_scan.AttentionDecodeScanLSTM)
        s_seq, c_seq, alpha_seq, _ = scan.apply(*common, cell["w_h"], cell["w_x"], cell["b"],
                                                *loc)
    else:
        scan = attention_scan.AttentionDecodeScanLoc if loc else attention_scan.AttentionDecodeScan
        s_seq, c_seq, alpha_seq = scan.apply(*common, cell["w_zr"], cell["w_h"], *loc)
    if cfg.mono_align and cfg.penalty_lambda > 0.0:
        unit_ramp = make_ramp(enc_lengths, h.shape[1], 1.0, torch.float32)
        a32 = alpha_seq.float()
        ap32 = torch.cat([torch.zeros_like(a32[:, :1]), a32[:, :-1]], dim=1)
        pen_unit = torch.clamp(torch.einsum("btl,bl->bt", a32 - ap32, unit_ramp), min=0.0)
        alpha_seq = MonotonicAlignmentSeq.apply(alpha_seq, cfg.penalty_lambda * unit_ramp,
                                                dec_mask.float(), pen_unit.detach())
        s_seq = s_seq + (0.0 * torch.sum(alpha_seq, dim=-1, keepdim=True)).to(s_seq.dtype)
        penalty = (cfg.penalty_lambda * pen_unit * dec_mask).to(dec_mask.dtype)
    else:
        penalty = torch.zeros_like(dec_mask)
    return {
        "logprobs": apply_readout(params, cfg, s_seq, c_seq, generator=generator, train=train),
        "alpha": alpha_seq,
        "s": s_seq,
        "c": c_seq,
        "penalty": penalty,
    }
