"""Greedy (argmax) decoding, the K=1 path (seq2seq_attention_asr_tpu/decode/greedy.py).

Each step is one fused decoder step over a K=1 hypothesis grid, readout
included: kernel K2 for the flagship's content-only GRU decoder, K8 for
the location-aware and LSTM decoders, on CUDA tensors; the plain step on
CPU tensors. A sample is finished after it emits eos or reaches its
max_steps; it then emits nothing and its state stops changing. The loop
ends when every sample is finished (one host read a step) or after
`max_steps_cap` steps; the token history holds `max_steps_cap` columns,
as the JAX package's scan does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import attention
from ..ops.cuda.attention_step import fused_attention_step
from ..ops.masking import length_mask


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # (B, M)
    lengths: torch.Tensor  # (B,)
    logprob: torch.Tensor  # (B,) total logprob of the emitted tokens


@torch.no_grad()
def greedy_decode(params, cfg: attention.AttentionConfig, h: torch.Tensor,
                  enc_lengths: torch.Tensor, eos_id, max_steps: Optional[torch.Tensor] = None,
                  max_steps_cap: Optional[int] = None, device="cuda") -> GreedyResult:
    """h: (B, L, A) annotations; enc_lengths (B,). max_steps (B,) defaults
    to enc_lengths, max_steps_cap to the padded L. Runs on the card unless
    device="cpu"; h and params must already be there."""
    dev = resolve_device(device)
    if h.device.type != dev.type:
        raise ValueError(f"greedy_decode on {dev}: h lies on {h.device}")
    dev = h.device
    b, l_pad, _ = h.shape
    v = cfg.output_depth
    enc_lengths = enc_lengths.to(dev).long()
    max_steps = enc_lengths if max_steps is None else max_steps.to(dev).long()
    cap = int(max_steps_cap if max_steps_cap is not None else l_pad)
    eos = torch.as_tensor(eos_id, device=dev).long().expand(b)

    enc_mask = length_mask(enc_lengths, l_pad, h.dtype)
    vh = attention.precompute_vh(params, h).contiguous()
    h = h.contiguous()
    state = tuple(a[:, None] for a in attention.init_state(cfg, b, l_pad, device=dev,
                                                           dtype=h.dtype))
    last = torch.zeros((b,), device=dev, dtype=torch.long)
    done = torch.zeros((b,), device=dev, dtype=torch.bool)
    total = torch.zeros((b,), device=dev, dtype=torch.float32)
    tokens = torch.zeros((b, cap), device=dev, dtype=torch.long)
    lengths = torch.zeros((b,), device=dev, dtype=torch.long)
    for t in range(cap):
        y_prev = F.one_hot(last, v).to(h.dtype)
        if t == 0:
            y_prev = torch.zeros_like(y_prev)
        new_state, out = fused_attention_step(params, cfg, state, y_prev[:, None], vh, h,
                                              enc_mask)
        logp = out["logp"][:, 0]
        tok = torch.argmax(logp, dim=-1)
        tok_lp = logp.gather(1, tok[:, None])[:, 0]
        emit = ~done
        total = total + torch.where(emit, tok_lp, 0.0)
        tokens[:, t] = torch.where(emit, tok, 0)
        lengths = lengths + emit.long()
        keep = done.reshape(b, 1, 1)
        state = tuple(torch.where(keep, o, n) for n, o in zip(new_state, state))
        last = torch.where(done, last, tok)
        done = done | (tok == eos) | (t + 1 >= max_steps)
        if bool(done.all()):
            break
    return GreedyResult(tokens=tokens, lengths=lengths, logprob=total)
