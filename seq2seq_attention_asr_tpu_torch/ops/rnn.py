"""Bidirectional GRU layer (seq2seq_attention_asr_tpu/ops/rnn.py:131-188)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import cells
from .cuda import gru_scan
from .masking import length_mask

Params = Dict[str, Any]


def bigru_init(generator: torch.Generator, dim_in: int, dim_out: int) -> Params:
    return {
        "fwd": cells.gru_init(generator, dim_in, dim_out),
        "bwd": cells.gru_init(generator, dim_in, dim_out),
    }


def bigru_layer(params: Params, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """concat(fwd, bwd) GRU states along features: (B, L, I) -> (B, L, 2H).

    Both directions run in one flip-free scan (kernel K1,
    ops/cuda/gru_scan.py), whose gradient is kernel K6; the input
    projection and the stacking of the recurrent weights are plain
    tensor ops that autograd differentiates. With `lengths`, the input and the output
    are zeroed past each row's length: the bias-free GRU then holds
    h = 0 through the padding, which lets the backward direction scan
    the natural-order array; valid positions equal a per-row reverse
    scan, padding is exactly 0.
    """
    h_dim = params["fwd"]["w_zr"].shape[1] // 2
    if lengths is not None:
        mask = length_mask(lengths, x.shape[1], x.dtype)[:, :, None]
        x = x * mask
    xf = cells.gru_input_proj(params["fwd"], x).contiguous()
    xb = cells.gru_input_proj(params["bwd"], x).contiguous()
    wzr2 = torch.stack([params["fwd"]["w_zr"][:h_dim], params["bwd"]["w_zr"][:h_dim]])
    wh2 = torch.stack([params["fwd"]["w_h"][:h_dim], params["bwd"]["w_h"][:h_dim]])
    fwd, bwd = gru_scan.BiGRUScan2.apply(xf, xb, wzr2, wh2)
    ys = torch.cat([fwd, bwd], dim=-1)
    if lengths is not None:
        ys = ys * mask
    return ys
