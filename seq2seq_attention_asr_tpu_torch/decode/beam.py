"""Batched beam search on the device (seq2seq_attention_asr_tpu/decode/beam.py).

Parent-pointer formulation of the reference search
(Attention.lua:332-438), with the same rules as the JAX package:

  - step 1 feeds the zero y_prev vector and the zero state and takes
    the top K of the first log-probs; eos picks go straight to the
    finished pool;
  - each later step expands only the live hypotheses (K - finished of
    them), takes the top (K - finished) expansions by TOTAL log-prob
    (no length normalization) and moves picks that hit eos, or the
    per-sample max length with that final token appended, to the pool;
  - the pool is never re-pruned; the answer is its best hypothesis,
    the first written winning ties;
  - max_steps counts the steps after the first, so a force-finished
    hypothesis holds max_steps + 1 tokens.

Each step is one fused decoder-step launch (kernel K2, or K8 for the
location-aware and LSTM decoders) plus a few small tensor ops; the top
K (a stable descending sort, so that equal scores rank by flat index as
in ``lax.top_k``) runs on the device, the state (alpha, s, mem) follows
each pick's parent, the history keeps one packed (token, parent) row
per step, and the tokens are recovered once at the end by walking the
parent pointers on the device. The loop ends when every sample's pool
is full or the longest max_steps is reached, which costs one host read
per step. A bf16 model's beam (h and the params in bf16) carries its
state (alpha, s, mem) in bf16 between steps, through K2's bf16 entry,
and its scores in float32, as the JAX package's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import attention
from ..ops.cuda.attention_step import fused_attention_step
from ..ops.masking import NEG_INF, length_mask


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # (B, M) best finished hypothesis, 0-padded
    lengths: torch.Tensor  # (B,) token count of the best hypothesis
    scores: torch.Tensor  # (B,) total log-prob of the best hypothesis


def _scatter(base: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """base (B, K) with base[b, dest[b, i]] = src[b, i]; dest == K is a
    dump column that is dropped."""
    k = base.shape[1]
    ext = torch.cat([base, base[:, :1]], dim=1)
    return ext.scatter(1, dest, src)[:, :k]


def beam_search(params, cfg: attention.AttentionConfig, h: torch.Tensor, enc_lengths: torch.Tensor,
                eos_id, k: int = 5, max_steps: Optional[torch.Tensor] = None,
                max_steps_cap: Optional[int] = None, device="cuda") -> BeamResult:
    """h: (B, L, A) annotations; enc_lengths (B,). max_steps: (B,)
    per-sample cap (defaults to enc_lengths); max_steps_cap bounds the
    history (defaults to the padded L). Runs on the card unless
    device="cpu"; h and params must already be there. Returns the best
    finished hypothesis per sample."""
    dev = resolve_device(device)
    if h.device.type != dev.type:
        raise ValueError(f"beam_search on {dev}: h lies on {h.device}")
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
    t_max = int(max_steps.max())
    if t_max > cap:
        raise ValueError(f"max_steps {t_max} exceeds the history bound max_steps_cap={cap}")

    long = dict(device=dev, dtype=torch.long)
    slots = torch.arange(k, device=dev)[None, :]
    alpha0, s0, mem0 = attention.init_state(cfg, b * k, l_pad, device=dev, dtype=h.dtype)
    state = (alpha0.reshape(b, k, l_pad), s0.reshape(b, k, -1), mem0.reshape(b, k, -1))
    last = torch.zeros((b, k), **long)
    scores = torch.zeros((b, k), device=dev, dtype=torch.float32)
    live_count = torch.ones((b,), **long)
    hist = torch.zeros((cap + 1, b, k), **long)
    fin_scores = torch.full((b, k), NEG_INF, device=dev, dtype=torch.float32)
    fin_step = torch.zeros((b, k), **long)
    fin_parent = torch.zeros((b, k), **long)
    fin_token = torch.zeros((b, k), **long)
    fin_count = torch.zeros((b,), **long)

    t = 0
    while t <= t_max:
        y_prev = F.one_hot(last, v).to(h.dtype)
        if t == 0:
            y_prev = torch.zeros_like(y_prev)
        new_state, out = fused_attention_step(params, cfg, state, y_prev, vh, h, enc_mask)
        logp = out["logp"]

        # Expansion scores; dead hypothesis slots masked out.
        live = slots < live_count[:, None]
        exp_scores = torch.where(live[:, :, None], scores[:, :, None] + logp,
                                 torch.full_like(logp, NEG_INF))
        # Top K with the lower flat index first among equal scores, as
        # lax.top_k orders them; torch.topk promises no order for ties.
        val, idx = torch.sort(exp_scores.reshape(b, k * v), dim=1, descending=True, stable=True)
        val, idx = val[:, :k], idx[:, :k]
        parent = idx // v
        token = idx % v

        # The first (K - finished) ranks are taken; eos or length-cap
        # picks are finished, in rank order.
        budget = torch.full_like(fin_count, k) if t == 0 else k - fin_count
        allowed = slots < budget[:, None]
        hit_cap = (t >= max_steps)[:, None]
        is_fin = allowed & ((token == eos[:, None]) | hit_cap)
        to_live = allowed & ~is_fin

        dest = torch.where(is_fin, fin_count[:, None] + torch.cumsum(is_fin, 1) - 1, k)
        fin_scores = _scatter(fin_scores, dest, val)
        fin_step = _scatter(fin_step, dest, torch.full_like(token, t))
        fin_parent = _scatter(fin_parent, dest, parent)
        fin_token = _scatter(fin_token, dest, token)
        fin_count = fin_count + is_fin.sum(1)

        # Surviving picks fill the leading live slots, stable by rank;
        # a slot takes the state of its pick's parent, dead slots zeros.
        live_dest = torch.where(to_live, torch.cumsum(to_live, 1) - 1, k)
        live_count = to_live.sum(1)
        scores = _scatter(torch.zeros_like(scores), live_dest, val)
        last = _scatter(torch.zeros_like(last), live_dest, token)
        sel_parent = _scatter(torch.zeros_like(last), live_dest, parent)
        keep = (slots < live_count[:, None]).to(h.dtype)
        state = tuple(
            torch.gather(a, 1, sel_parent.reshape(b, k, 1).expand(a.shape)) * keep[:, :, None]
            for a in new_state
        )
        hist[t] = last * k + sel_parent
        t += 1
        if not bool((fin_count < k).any()):
            break

    # Best finished hypothesis: argmax total log-prob, first write wins.
    best = torch.argmax(fin_scores, dim=1, keepdim=True)
    bscore = fin_scores.gather(1, best)[:, 0]
    bstep = fin_step.gather(1, best)[:, 0]
    slot = fin_parent.gather(1, best)[:, 0]
    btok = fin_token.gather(1, best)[:, 0]
    # A live hypothesis at step s holds s tokens, so one finished at
    # step s has s + 1 with its final token.
    lengths = bstep + 1
    tokens = torch.zeros((b, cap + 1), **long)
    for s in range(t - 1, -1, -1):
        active = s < bstep
        code = hist[s].gather(1, slot[:, None])[:, 0]
        tokens[:, s] = torch.where(active, code // k, 0)
        slot = torch.where(active, code % k, slot)
    tokens.scatter_add_(1, bstep[:, None], btok[:, None])
    return BeamResult(tokens=tokens, lengths=lengths, scores=bscore)
