"""LibriSpeech VGG model (seq2seq_attention_asr_tpu/models/vgg.py), the
reference's librispeech/model_vgg.lua: a conv-only encoder on
3-channel stacked log-mel features and the attention decoder.

Encoder (model_vgg.lua:24-54), on (B, L, freq, 3) inputs, NHWC with H
time and W frequency: conv3x3(3->64), ReLU, conv3x3(64->64), ReLU, a
max pool of (time 1, freq 2), conv3x3(64->128), ReLU, conv3x3(128->128),
ReLU, a max pool of (2, 2); so time' = floor((L - 8) / 2) and freq' =
floor((floor((freq - 4) / 2) - 4) / 2). Then the height collapse to (B,
L', freq' * 128), frequency-major and channel-minor as the JAX
package's reshape of NHWC, and a 4-layer MLP 128 freq' -> 2048 -> 2048
-> 2048 -> output_frame_size, each layer with a ReLU. The convolutions
are cuDNN's (``ops/conv.py``: TF32 unless turned off) and the MLP
PyTorch matmuls, as the JAX package computes both outside any kernel.

Decoder (model_vgg.lua:58-93): content attention (feature_maps=0 in
the recipe) with a GRU cell on annotations of output_frame_size (no
x2, :63), and a two-layer maxout readout maxout(64, 7) -> linear(64)
-> maxout(64, 7) -> linear(V) (:74-82). Training runs kernels K4 and
K5 (the content-only GRU decoder scan); the beam runs K8's <GRU,
content> instance, which takes this four-layer readout.
``compute_dtype="bfloat16"`` raises NotImplementedError: K8 has no bf16
instance and no backward kernel a bf16 entry (ROADMAP Queue A item 5c).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import interop
from ..ops import attention, conv, readout

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    input_frame_size: int = 40  # frequency bins a channel (stacked log-mel)
    output_frame_size: int = 512
    score_depth: int = 512
    filt_size: int = 10
    feature_maps: int = 0
    state_depth: int = 256
    mlp_depth: int = 64
    output_depth: int = 62
    penalty_lambda: float = 0.0
    mono_align: bool = True
    compute_dtype: str = "float32"  # "bfloat16" is refused (ROADMAP Queue A item 5c)

    def __post_init__(self):
        if self.compute_dtype == "bfloat16":
            raise NotImplementedError(
                "vgg in bfloat16 needs a bf16 instance of K8 and bf16 entries of the backward "
                "kernels: ROADMAP Queue A item 5c")
        if self.compute_dtype != "float32":
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port takes 'float32' "
                             f"or 'bfloat16'")

    @property
    def annotation_depth(self) -> int:
        return self.output_frame_size  # no x2 (model_vgg.lua:63)

    @property
    def collapsed_freq(self) -> int:
        h = (self.input_frame_size - 4) // 2
        return 128 * ((h - 4) // 2)

    def attention_config(self) -> attention.AttentionConfig:
        return attention.AttentionConfig(
            score_depth=self.score_depth,
            state_depth=self.state_depth,
            annotation_depth=self.annotation_depth,
            output_depth=self.output_depth,
            readout=(("maxout", self.mlp_depth, 7), ("linear", self.mlp_depth),
                     ("maxout", self.mlp_depth, 7), ("linear", self.output_depth)),
            feature_maps=self.feature_maps,
            filt_size=self.filt_size,
            mono_align=self.mono_align,
            penalty_lambda=self.penalty_lambda,
        )


def init(cfg: VGGConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random weights (torch's default init) from `generator`, drawn on
    the CPU, then moved to `device`."""
    params = {
        "encoder": {
            "c1": conv.spatial_conv_init(generator, 3, 64, 3, 3),
            "c2": conv.spatial_conv_init(generator, 64, 64, 3, 3),
            "c3": conv.spatial_conv_init(generator, 64, 128, 3, 3),
            "c4": conv.spatial_conv_init(generator, 128, 128, 3, 3),
            "fc1": readout.linear_init(generator, cfg.collapsed_freq, 2048),
            "fc2": readout.linear_init(generator, 2048, 2048),
            "fc3": readout.linear_init(generator, 2048, 2048),
            "fc4": readout.linear_init(generator, 2048, cfg.output_frame_size),
        },
        "decoder": attention.attention_init(generator, cfg.attention_config()),
    }
    return interop.to_torch(params, device)


def encode_lengths(cfg: VGGConfig, lengths: torch.Tensor) -> torch.Tensor:
    """time' = floor((L - 8) / 2), clamped at 0 (model_vgg.lua:35-36)."""
    return torch.clamp((lengths - 8) // 2, min=0)


def encode(params: Params, cfg: VGGConfig, x: torch.Tensor, lengths: torch.Tensor):
    """x (B, L, freq, 3) -> (annotations (B, L', output_frame_size), their
    lengths (B,)). The conv stack runs in NCHW, x permuted once."""
    enc = params["encoder"]
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(conv.spatial_conv_nchw(enc["c1"], h))
    h = torch.relu(conv.spatial_conv_nchw(enc["c2"], h))
    h = conv.spatial_max_pool_nchw(h, 1, 2, 1, 2)  # frequency only
    h = torch.relu(conv.spatial_conv_nchw(enc["c3"], h))
    h = torch.relu(conv.spatial_conv_nchw(enc["c4"], h))
    h = conv.spatial_max_pool_nchw(h, 2, 2, 2, 2)
    b, c, lt, fr = h.shape
    # The height collapse (Transpose2 + View, :45-46): frequency-major,
    # channel-minor, as (B, L', freq', C) reshaped.
    h = h.permute(0, 2, 3, 1).reshape(b, lt, fr * c)
    for name in ("fc1", "fc2", "fc3", "fc4"):
        h = torch.relu(readout.linear_apply(enc[name], h))
    return h, encode_lengths(cfg, lengths)


def forward(params: Params, cfg: VGGConfig, x: torch.Tensor, x_lengths: torch.Tensor,
            labels_onehot: torch.Tensor, dec_mask: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            train: bool = False) -> Dict[str, torch.Tensor]:
    """encode, then the teacher-forced decoder over the annotations'
    lengths: dict(logprobs (B, T, V), alpha (B, T, L'), penalty (B, T)).
    The recipe's readout has no dropout layer; `generator` is passed on
    for one that has."""
    h, enc_lengths = encode(params, cfg, x, x_lengths)
    return attention.decode_teacher_forced(params["decoder"], cfg.attention_config(), h,
                                           enc_lengths, labels_onehot, dec_mask,
                                           generator=generator, train=train)
