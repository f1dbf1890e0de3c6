"""Content-based attention decoder (seq2seq_attention_asr_tpu/ops/attention.py).

The port has the flagship decoder: content-only attention
(``feature_maps == 0``) with a GRU cell whose mem passes through
untouched (model_chorowski_baseline.lua:48-51), for beam search one
step at a time and for training as a teacher-forced scan
(``decode_teacher_forced``, kernels K4 and K5). One step:

  e     = w_e . tanh(Vh + s_prev @ Ws + b_s)        (Attention.lua:103-113)
  alpha = masked softmax of e over encoder positions
  c     = alpha^T h                                 (Attention.lua:129-136)
  r     = Linear(2S->S)(concat(Linear(c), Linear(y_prev)))
  s     = GRU(r, s_prev)

and the readout decoder_mlp(concat(s, c)) -> log-probs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import cells, readout
from .cells import torch_linear_init
from .cuda import attention_scan
from .masking import length_mask, masked_softmax

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """The decoder's widths, readout and attention options, with the JAX
    package's names. Location-aware attention (feature_maps > 0), the
    LSTM cell and the monotonic penalty in training (mono_align and
    penalty_lambda > 0) are not ported yet and are refused."""

    score_depth: int
    state_depth: int
    annotation_depth: int
    output_depth: int
    readout: Tuple[Tuple, ...] = (("maxout", 64, 7), ("linear", 62))
    feature_maps: int = 0
    filt_size: int = 10
    cell: str = "gru"
    mono_align: bool = True
    penalty_lambda: float = 0.0


def check_ported(cfg: AttentionConfig, train: bool = False) -> None:
    """Raise NotImplementedError for what the port cannot compute yet.
    The monotonic penalty acts on training only."""
    if cfg.feature_maps > 0:
        raise NotImplementedError("location-aware attention (feature_maps > 0) is not ported yet")
    if cfg.cell != "gru":
        raise NotImplementedError(f"decoder cell {cfg.cell!r} is not ported yet; only 'gru' is")
    if train and cfg.mono_align and cfg.penalty_lambda > 0.0:
        raise NotImplementedError("the monotonic alignment penalty (penalty_lambda > 0) is not "
                                  "ported yet")


def attention_init(generator: torch.Generator, cfg: AttentionConfig) -> Params:
    check_ported(cfg)
    a, s, st = cfg.annotation_depth, cfg.score_depth, cfg.state_depth
    return {
        "v": torch_linear_init(generator, a, (a, s)),
        "ws": {
            "w": torch_linear_init(generator, st, (st, s)),
            "b": torch_linear_init(generator, st, (s,)),
        },
        "w_e": torch_linear_init(generator, s, (s,)),
        "c_in": readout.linear_init(generator, a, st),
        "y_in": readout.linear_init(generator, cfg.output_depth, st),
        "dec_in": readout.linear_init(generator, 2 * st, st),
        "cell": cells.gru_init(generator, st, st),
        "readout": readout.stack_init(generator, st + a, cfg.readout),
    }


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


def attention_weights(params: Params, s_prev, vh, enc_mask) -> torch.Tensor:
    """alpha (B, L) for one step of content-only attention."""
    ws = s_prev @ params["ws"]["w"] + params["ws"]["b"]
    e = torch.tanh(vh + ws[:, None, :]) @ params["w_e"]
    return masked_softmax(e, enc_mask)


def attention_step(params: Params, state, y_prev, vh, h, enc_mask):
    """One decoder step. state = (alpha_prev, s_prev, mem_prev); y_prev
    one-hot (B, V). Returns the new state and {s, c, alpha}."""
    _, s_prev, mem = state
    alpha = attention_weights(params, s_prev, vh, enc_mask)
    c = torch.einsum("bl,bld->bd", alpha, h)
    r = readout.linear_apply(
        params["dec_in"],
        torch.cat(
            [readout.linear_apply(params["c_in"], c), readout.linear_apply(params["y_in"], y_prev)],
            dim=-1,
        ),
    )
    s = cells.gru_step(params["cell"], r, s_prev)
    return (alpha, s, mem), {"s": s, "c": c, "alpha": alpha}


def apply_readout(params: Params, cfg: AttentionConfig, s: torch.Tensor, c: torch.Tensor,
                  *, train: bool = False) -> torch.Tensor:
    """decoder_mlp(concat(s, c)) -> log-probs, on any batch shape."""
    return readout.stack_apply(params["readout"], cfg.readout, torch.cat([s, c], dim=-1),
                               train=train)


def decode_teacher_forced(params: Params, cfg: AttentionConfig, h: torch.Tensor,
                          enc_lengths: torch.Tensor, labels_onehot: torch.Tensor,
                          dec_mask: torch.Tensor, *, train: bool = False) -> Dict[str, torch.Tensor]:
    """Teacher-forced decode over all T output steps, the fused branch of
    the JAX package's decode_teacher_forced (ops/attention.py:320-434).

    h (B, L, A) annotations; labels_onehot (B, T, V); dec_mask (B, T).
    y_prev is the zero vector at step 0 and the label of step t-1 after
    (RNNAttention.lua:153-156, 174); the state starts at zero. The scan
    is one AttentionDecodeScan (kernels K4 and K5) and the readout runs
    once over the stacked (s, c). Returns logprobs (B, T, V), alpha (B,
    T, L) and penalty (B, T), all zeros: the penalty is not ported."""
    check_ported(cfg, train=train)
    enc_mask = length_mask(enc_lengths, h.shape[1], h.dtype)
    vh = precompute_vh(params, h)
    y_prev = torch.cat([torch.zeros_like(labels_onehot[:, :1]), labels_onehot[:, :-1]], dim=1)
    yin = readout.linear_apply(params["y_in"], y_prev)
    s_seq, c_seq, alpha_seq = attention_scan.AttentionDecodeScan.apply(
        vh.contiguous(), h.contiguous(), enc_mask, yin.contiguous(),
        params["ws"]["w"], params["ws"]["b"], params["w_e"], params["c_in"]["w"],
        params["c_in"]["b"], params["dec_in"]["w"], params["dec_in"]["b"],
        params["cell"]["w_zr"], params["cell"]["w_h"],
    )
    return {
        "logprobs": apply_readout(params, cfg, s_seq, c_seq, train=train),
        "alpha": alpha_seq,
        "penalty": torch.zeros_like(dec_mask),
    }
