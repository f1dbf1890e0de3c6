"""Chorowski baseline: 3-layer BiGRU encoder + content attention decoder
with a GRU cell and a maxout readout (seq2seq_attention_asr_tpu/models/chorowski.py).

Flagship widths are the TIMIT recipe's (train/experiment.py:69-95 of
the JAX package): 123 -> 256 per direction (annotations 512), score
depth 512, state 256, maxout(64, window 7) -> 62 phones.
``forward`` is the training forward: encode, then the teacher-forced
decoder scan. ``dropout`` > 0 puts a dropout layer at the readout's
input (model_chorowski_baseline_dropout.lua; registry name
"chorowski_dropout"). ``compute_dtype="bfloat16"`` is the JAX package's
mixed-precision operating point: ``forward`` casts the float32 params
and its inputs to bf16 (float32 masters, as the JAX package's
``forward`` does); the kernels take bf16 IO and product operands and
keep accumulation, carries and the softmax in float32, and the
log-softmax is float32. ``encode`` casts nothing, so serving stays
float32. bf16 evaluation runs (K1, K2 and K4 in bf16; with
feature_maps > 0, "flagship_loc", K1, K12 and K8's <GRU, location>
instance), and so does bf16 training (the train step, ``Trainer.fit``,
``run_cli``): of the content-only flagship K1, K4, K5 and K6 in bf16, of
flagship_loc K1, K6, K12 and K13.
"""

from __future__ import annotations

import contextlib

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import interop, tree
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
    dropout: float = 0.0  # a readout layer at the input of the maxout: the identity in eval mode
    # Attention options, with the JAX package's names. Serving and
    # training take feature_maps > 0 (training then runs the
    # location-aware GRU scan, kernels K12 and K13), and training the
    # monotonic penalty (mono_align with penalty_lambda > 0).
    feature_maps: int = 0
    filt_size: int = 10
    mono_align: bool = True
    penalty_lambda: float = 0.0
    compute_dtype: str = "float32"  # or "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the port takes 'float32' "
                             f"or 'bfloat16'")

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


def cast_float32(tree_or_tensor, dtype: torch.dtype):
    """Every float32 leaf of a tensor or a parameter tree cast to `dtype`,
    other leaves as they are (chorowski.py:120-126 of the JAX package)."""
    if dtype == torch.float32:
        return tree_or_tensor
    return tree.tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a, tree_or_tensor)


@contextlib.contextmanager
def float32_sums(dtype: torch.dtype):
    """For bf16: cuBLAS's bf16 products (the input projections, vh, yin,
    the teacher-forced readout) sum in float32, as the JAX package's bf16
    dots do, whatever torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction says (PyTorch's default, True,
    lets cuBLAS reduce in bf16); the flag is restored on exit. Nothing
    for other types."""
    if dtype != torch.bfloat16:
        yield
        return
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


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
            generator: Optional[torch.Generator] = None,
            train: bool = False) -> Dict[str, torch.Tensor]:
    """Encode, then teacher-forced decode (model_chorowski_baseline.lua:
    73-75); train-mode dropout draws from `generator`. Returns logprobs
    (B, T, V), alpha (B, T, L), penalty (B, T). Under
    compute_dtype="bfloat16" the float32 params, x, labels_onehot and
    dec_mask are cast to bf16 first, and the bf16 products sum in
    float32 (float32_sums); gradients reach the float32 masters through
    the casts."""
    dt = getattr(torch, cfg.compute_dtype)
    params, x, labels_onehot, dec_mask = (cast_float32(a, dt)
                                          for a in (params, x, labels_onehot, dec_mask))
    with float32_sums(dt):
        h = encode(params, cfg, x, x_lengths)
        return attention.decode_teacher_forced(params["decoder"], cfg.attention_config(), h,
                                               x_lengths, labels_onehot, dec_mask,
                                               generator=generator, train=train)
