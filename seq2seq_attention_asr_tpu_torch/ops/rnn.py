"""Bidirectional GRU and LSTM layers (seq2seq_attention_asr_tpu/ops/rnn.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import cells
from .cuda import gru_scan, lstm_scan
from .masking import flip_sequences, length_mask

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
    scan, padding is exactly 0. bf16 params and input (a bf16 model's)
    run in bf16 throughout, K1 and, for the gradient, K6 through their
    bf16 entries, and give bf16; the gradient reaches float32 masters
    through the caller's casts.
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


def _flip(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    return x.flip(1) if lengths is None else flip_sequences(x, lengths)


def gru_layer(params: Params, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
              reverse: bool = False, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU direction over a padded batch, (B, L, I) -> (B, L, H), from
    h0 (B, H) (zeros when None), through kernel K16 and, for its gradient,
    K17 (ops/cuda/gru_scan.py::GRUScan). The input projection is one
    matmul outside the kernel, as in the JAX package.

    `reverse=True` scans each sequence backward over its true length:
    the input is flipped about `lengths` (the whole time axis when
    None), scanned forward and flipped back, so output[t] is the state
    after consuming x[t..len-1]. The outputs are not masked: past a
    row's length the scan runs on into the padding, and those positions
    are returned as the JAX package returns them. bf16 params and input
    run K16 and K17 through their bf16 entries (h0 taken in bf16), and
    give a bf16 output and bf16 gradients, as the JAX package's Pallas
    branch does."""
    h_dim = params["w_zr"].shape[1] // 2
    if reverse:
        x = _flip(x, lengths)
    xproj = cells.gru_input_proj(params, x)
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], h_dim))
    ys = gru_scan.GRUScan.apply(xproj.contiguous(), h0.contiguous(), params["w_zr"][:h_dim],
                                params["w_h"][:h_dim])
    return _flip(ys, lengths) if reverse else ys


def lstm_layer(params: Params, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
               reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over a padded batch, (B, L, I) -> (B, L, H), a
    Python loop over time. reverse=True flips the input about each row's
    length, scans, and flips the output back, so padding stays in place."""
    h_dim = params["w_h"].shape[0]
    if reverse:
        x = _flip(x, lengths)
    xproj = cells.lstm_input_proj(params, x)
    state = (x.new_zeros((x.shape[0], h_dim)), x.new_zeros((x.shape[0], h_dim)))
    ys = []
    for t in range(x.shape[1]):
        state = cells.lstm_step_preproj(params, xproj[:, t], state)
        ys.append(state[0])
    ys = torch.stack(ys, dim=1) if ys else x.new_zeros((x.shape[0], 0, h_dim))
    return _flip(ys, lengths) if reverse else ys


def bilstm_init(generator: torch.Generator, dim_in: int, dim_out: int) -> Params:
    return {
        "fwd": cells.lstm_init(generator, dim_in, dim_out),
        "bwd": cells.lstm_init(generator, dim_in, dim_out),
    }


def bilstm_layer(params: Params, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """concat(fwd, bwd) LSTM states along features: (B, L, I) -> (B, L, 2H).

    The LSTM has biases, so h = 0 is no fixed point under zero input and
    the backward direction cannot walk the padded array from its tail,
    as the flip-free BiGRU does. As the JAX package's fused branch does:
    flip the backward direction's input about the lengths, project both
    directions, run one direction-stacked scan from zero states (kernel
    K7 forward, kernel K9 backward: ops/cuda/lstm_scan.py), then flip the
    backward outputs back. The flips are gathers and the projections
    matmuls, which autograd differentiates. The outputs are not masked:
    the forward direction runs on into the padding, as in the JAX
    package. bf16 params and input (a bf16 model's) project in bf16 and
    scan through K7's bf16 entry from float32 zero states, as the JAX
    package's fused branch does (ops/rnn.py:235); the scan's float32
    outputs are cast to the input's type, as there (:243-247)."""
    if "w_peep" in params["fwd"] or "w_peep" in params["bwd"]:
        raise NotImplementedError("LSTM peepholes are not ported")
    h_dim = params["fwd"]["w_h"].shape[0]
    xproj2 = torch.stack([cells.lstm_input_proj(params["fwd"], x),
                          cells.lstm_input_proj(params["bwd"], _flip(x, lengths))])
    zeros = x.new_zeros((2, x.shape[0], h_dim), dtype=torch.float32)
    wh2 = torch.stack([params["fwd"]["w_h"], params["bwd"]["w_h"]])
    hs = lstm_scan.BiLSTMScan.apply(xproj2.contiguous(), zeros, zeros, wh2.contiguous())
    return torch.cat([hs[0], _flip(hs[1], lengths)], dim=-1).to(x.dtype)
