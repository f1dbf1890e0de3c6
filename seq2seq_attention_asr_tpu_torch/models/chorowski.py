"""Chorowski baseline: 3-layer BiGRU encoder + content attention decoder
with a GRU cell and a maxout readout (seq2seq_attention_asr_tpu/models/chorowski.py).

Flagship widths are the TIMIT recipe's (train/experiment.py:69-95 of
the JAX package): 123 -> 256 per direction (annotations 512), score
depth 512, state 256, maxout(64, window 7) -> 62 phones.
``forward`` is the training forward: encode, then the teacher-forced
decoder scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .. import interop
from ..ops import attention, rnn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ChorowskiConfig:
    input_frame_size: int = 123
    hidden_frame_size: int = 256
    output_frame_size: int = 256
    score_depth: int = 512
    state_depth: int = 256
    mlp_depth: int = 64
    output_depth: int = 62
    dropout: float = 0.0  # a readout layer: the identity in eval mode, refused in train mode
    # Attention options, with the JAX package's names. Serving and
    # training take feature_maps > 0 (training then runs the
    # location-aware GRU scan, kernels K12 and K13); training refuses
    # mono_align with penalty_lambda > 0.
    feature_maps: int = 0
    filt_size: int = 10
    mono_align: bool = True
    penalty_lambda: float = 0.0

    @property
    def annotation_depth(self) -> int:
        return 2 * self.output_frame_size

    def attention_config(self) -> attention.AttentionConfig:
        ro = [("dropout", self.dropout)] if self.dropout > 0.0 else []
        ro += [("maxout", self.mlp_depth, 7), ("linear", self.output_depth)]
        return attention.AttentionConfig(
            score_depth=self.score_depth,
            state_depth=self.state_depth,
            annotation_depth=self.annotation_depth,
            output_depth=self.output_depth,
            readout=tuple(ro),
            feature_maps=self.feature_maps,
            filt_size=self.filt_size,
            mono_align=self.mono_align,
            penalty_lambda=self.penalty_lambda,
        )


def init(cfg: ChorowskiConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random weights (torch's default Linear init) from `generator`,
    drawn on the CPU, then moved to `device`."""
    h = cfg.hidden_frame_size
    params = {
        "encoder": {
            "bigru1": rnn.bigru_init(generator, cfg.input_frame_size, h),
            "bigru2": rnn.bigru_init(generator, 2 * h, h),
            "bigru3": rnn.bigru_init(generator, 2 * h, cfg.output_frame_size),
        },
        "decoder": attention.attention_init(generator, cfg.attention_config()),
    }
    return interop.to_torch(params, device)


def encode(params: Params, cfg: ChorowskiConfig, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: (B, L, input_frame_size) -> annotations (B, L, 2*output_frame_size)."""
    enc = params["encoder"]
    h = rnn.bigru_layer(enc["bigru1"], x, lengths)
    h = rnn.bigru_layer(enc["bigru2"], h, lengths)
    return rnn.bigru_layer(enc["bigru3"], h, lengths)


def forward(params: Params, cfg: ChorowskiConfig, x: torch.Tensor, x_lengths: torch.Tensor,
            labels_onehot: torch.Tensor, dec_mask: torch.Tensor, *,
            train: bool = False) -> Dict[str, torch.Tensor]:
    """Encode, then teacher-forced decode (model_chorowski_baseline.lua:
    73-75). Returns logprobs (B, T, V), alpha (B, T, L), penalty (B, T)."""
    h = encode(params, cfg, x, x_lengths)
    return attention.decode_teacher_forced(params["decoder"], cfg.attention_config(), h,
                                           x_lengths, labels_onehot, dec_mask, train=train)
