"""Conv + BiLSTM TIMIT model (seq2seq_attention_asr_tpu/models/conv_bilstm.py),
the reference's inline TIMIT model (timit/timit.lua:98-169).

Encoder: three blocks of TemporalConvolution(k=3, VALID) + ReLU +
TemporalMaxPooling(2, 2), an 8x downsampling of time, then a BiLSTM
256 -> 128 per direction (kernel K7). Decoder: location-aware attention
(score depth 150, 16 feature maps, filter width 5) with an LSTM cell of
state 400, and the readout linear(656 -> 124) -> ReLU -> linear(-> 62)
(kernel K8 in the beam). Training runs ``forward``: the encoder, whose
BiLSTM's backward is kernel K9 and whose conv stack autograd
differentiates, then the teacher-forced location-aware LSTM decoder
scan (kernels K10 and K11), or with feature_maps = 0 the content-only
LSTM decoder scan (kernels K14 and K15). ``compute_dtype="bfloat16"`` is
the JAX package's mixed-precision operating point, as for the flagship
(models/chorowski.py): ``forward`` casts the float32 params and its
inputs to bf16 (the float32 masters get their gradients through the
casts), bf16 evaluation runs K7, K10 and K8's <LSTM, location> instance
through their bf16 entries, or with feature_maps = 0 K7, K14 and K8's
<LSTM, content> instance, and bf16 training (the train step,
``Trainer.fit``, ``run_cli``) K7, K9, K10 and K11, or K7, K9, K14 and K15,
through theirs. The conv stack's products, and their gradients, are
plain bf16 matrix products that sum in float32 (``float32_sums``), as
the JAX package leaves them to XLA. ``encode`` casts nothing, so serving
stays float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import interop
from ..ops import attention, conv, rnn
from .chorowski import cast_float32, float32_sums

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ConvBiLSTMConfig:
    input_frame_size: int = 123
    hidden_frame_size: int = 256
    output_frame_size: int = 128
    kw: int = 3
    score_depth: int = 150
    filt_size: int = 5
    feature_maps: int = 16
    state_depth: int = 400
    output_depth: int = 62
    penalty_lambda: float = 0.0
    mono_align: bool = True
    peepholes: bool = False  # refused: the port has no LSTM peepholes
    compute_dtype: str = "float32"  # or "bfloat16" (evaluation and training)

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port takes 'float32' "
                             f"or 'bfloat16'")

    @property
    def annotation_depth(self) -> int:
        return 2 * self.output_frame_size

    def attention_config(self) -> attention.AttentionConfig:
        return attention.AttentionConfig(
            score_depth=self.score_depth,
            state_depth=self.state_depth,
            annotation_depth=self.annotation_depth,
            output_depth=self.output_depth,
            readout=(("linear", 2 * self.output_depth), ("relu",), ("linear", self.output_depth)),
            feature_maps=self.feature_maps,
            filt_size=self.filt_size,
            cell="lstm",
            peepholes=self.peepholes,
            mono_align=self.mono_align,
            penalty_lambda=self.penalty_lambda,
        )


def init(cfg: ConvBiLSTMConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random weights (torch's default init) from `generator`, drawn on
    the CPU, then moved to `device`."""
    h = cfg.hidden_frame_size
    params = {
        "encoder": {
            "conv1": conv.temporal_conv_init(generator, cfg.input_frame_size, h, cfg.kw),
            "conv2": conv.temporal_conv_init(generator, h, h, cfg.kw),
            "conv3": conv.temporal_conv_init(generator, h, h, cfg.kw),
            "bilstm": rnn.bilstm_init(generator, h, cfg.output_frame_size),
        },
        "decoder": attention.attention_init(generator, cfg.attention_config()),
    }
    return interop.to_torch(params, device)


def encode_lengths(cfg: ConvBiLSTMConfig, lengths: torch.Tensor) -> torch.Tensor:
    """True lengths through the three conv + pool blocks (timit.lua:112,116,120)."""
    for _ in range(3):
        lengths = conv.conv_out_length(lengths, cfg.kw)
        lengths = conv.conv_out_length(lengths, 2, 2)
    return lengths


def encode(params: Params, cfg: ConvBiLSTMConfig, x: torch.Tensor, lengths: torch.Tensor):
    """x (B, L, input_frame_size) -> (annotations (B, L', 2*output_frame_size),
    their lengths (B,))."""
    enc = params["encoder"]
    h = x
    for name in ("conv1", "conv2", "conv3"):
        h = conv.temporal_max_pool(torch.relu(conv.temporal_conv(enc[name], h)), 2)
    out_lengths = encode_lengths(cfg, lengths)
    return rnn.bilstm_layer(enc["bilstm"], h, out_lengths), out_lengths


def forward(params: Params, cfg: ConvBiLSTMConfig, x: torch.Tensor, x_lengths: torch.Tensor,
            labels_onehot: torch.Tensor, dec_mask: torch.Tensor, *,
            generator: Optional[torch.Generator] = None, train: bool = False):
    """encode, then the teacher-forced decoder over the annotations'
    lengths (the penalty's ramp too): dict(logprobs (B, T, V), alpha (B,
    T, L'), penalty (B, T)). The recipe's readout has no dropout layer;
    `generator` is passed on for one that has. Under
    compute_dtype="bfloat16" the float32 params, x, labels_onehot and
    dec_mask are cast to bf16 first and the bf16 products sum in float32,
    as chorowski.forward does."""
    dt = getattr(torch, cfg.compute_dtype)
    params, x, labels_onehot, dec_mask = (cast_float32(a, dt)
                                          for a in (params, x, labels_onehot, dec_mask))
    with float32_sums(dt):
        h, enc_lengths = encode(params, cfg, x, x_lengths)
        return attention.decode_teacher_forced(params["decoder"], cfg.attention_config(), h,
                                               enc_lengths, labels_onehot, dec_mask,
                                               generator=generator, train=train)
