"""Temporal convolution and pooling on padded batches
(seq2seq_attention_asr_tpu/ops/conv.py, the temporal part).

VALID padding, as the reference's TemporalConvolution and
TemporalMaxPooling; ``conv_out_length`` carries the true lengths of a
padded batch through them. The kernel layout is the JAX package's
(k, in, out). The convolution is k shifted matrix products, which run
in full float32 on the card; ``F.conv1d`` would go through cuDNN in
TF32 unless the caller turned ``cudnn.allow_tf32`` off.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .cells import torch_linear_init

Params = Dict[str, torch.Tensor]


def temporal_conv_init(generator: torch.Generator, dim_in: int, dim_out: int, k: int) -> Params:
    """TemporalConvolution(dim_in, dim_out, k): kernel (k, in, out), bias (out,)."""
    fan_in = dim_in * k
    return {"w": torch_linear_init(generator, fan_in, (k, dim_in, dim_out)),
            "b": torch_linear_init(generator, fan_in, (dim_out,))}


def temporal_conv(params: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID 1-D cross-correlation over time: (B, L, C_in) -> (B, L', C_out),
    L' = (L - k) // stride + 1, as sum_j x[:, j + stride * t] @ w[j]."""
    w = params["w"]
    k = w.shape[0]
    out_len = max((x.shape[1] - k) // stride + 1, 0)
    span = (out_len - 1) * stride + 1
    y = x.new_zeros((x.shape[0], out_len, w.shape[2]))
    if out_len:
        for j in range(k):
            y = y + x[:, j : j + span : stride] @ w[j]
    if "b" in params:
        y = y + params["b"]
    return y


def temporal_max_pool(x: torch.Tensor, k: int, stride: Optional[int] = None) -> torch.Tensor:
    """TemporalMaxPooling(k, stride), VALID: (B, L, C) -> (B, L', C)."""
    stride = stride or k
    if x.shape[1] < k:
        return x[:, :0]
    return x.unfold(1, k, stride).amax(dim=-1)


def conv_out_length(lengths: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """True lengths after a VALID convolution or pool of size k and stride s."""
    return torch.clamp((lengths - k) // stride + 1, min=0)
