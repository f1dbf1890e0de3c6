"""Monotonic alignment penalty: identity forward, gradient injection
backward (seq2seq_attention_asr_tpu/ops/monotonic.py).

Reference: MonotonicAlignment.lua. Per decoder step the penalty is

    p = lambda * max(0, sum_i (cumsum(alpha)_i - cumsum(alpha_prev)_i))

(MonotonicAlignment.lua:27-39). It is never added to the loss; it only
shapes gradients: wherever p > 0 the backward adds the ramp
lambda * (L + 1 - i) to d(alpha) and its negation to d(alpha_prev)
(MonotonicAlignment.lua:49-75). With the prefix mask of a sample's
length, sum_{i<len} cumsum(x)_i = sum_j x_j * max(len - j, 0), so the
penalty is one weighted sum against the same ramp that the backward
injects. The ramp is zero beyond each sample's length, so padding gets
no gradient.

``MonotonicAlignmentSeq`` is the form the teacher-forced scan uses: the
identity on the stacked (B, T, L) alignments, whose backward adds every
step's injection to the scan's alpha cotangent, so that the decoder
kernels need no code of their own for the penalty.
``MonotonicAlignment`` is the per-step form of ``attention_step``.
"""

from __future__ import annotations

import torch

from ..parallel import comm


def make_ramp(lengths: torch.Tensor, max_len: int, lam, dtype=torch.float32) -> torch.Tensor:
    """lam * max(len - i, 0) per sample, 0-indexed i: (B,) -> (B, max_len).
    Equals the reference's 1-indexed lam * (L + 1 - i)."""
    pos = torch.arange(max_len, dtype=dtype, device=lengths.device)[None, :]
    return lam * torch.clamp(lengths.to(dtype)[:, None] - pos, min=0.0)


def monotonic_penalty_value(alpha: torch.Tensor, prev_alpha: torch.Tensor,
                            unit_ramp: torch.Tensor, group=None) -> torch.Tensor:
    """The unscaled penalty of one step, weighted-sum form: (B, L) -> (B,).
    unit_ramp is ``make_ramp(lengths, L, 1.0)``. With `group` (the
    encoder positions split over its ranks) the local partial sums are
    all-reduced over it before the clamp."""
    s = comm.all_reduce_sum(torch.sum(unit_ramp * (alpha - prev_alpha), dim=-1), group)
    return torch.clamp(s, min=0.0)


class MonotonicAlignmentSeq(torch.autograd.Function):
    """The identity on alpha_seq (B, T, L); the backward adds
    inject_t - inject_{t+1} to d(alpha_t), where inject_t =
    [active_t > 0] * dec_mask_t * base_ramp and inject_T = 0. base_ramp
    (B, L) is the lambda-scaled ramp, dec_mask and active (B, T) the
    steps' validity and unscaled penalty values. No gradient reaches the
    other inputs (active is a residual of the per-step rule)."""

    @staticmethod
    def forward(ctx, alpha_seq, base_ramp, dec_mask, active):
        ctx.save_for_backward(base_ramp, dec_mask, active)
        return alpha_seq.clone()

    @staticmethod
    def backward(ctx, g):
        base_ramp, dec_mask, active = ctx.saved_tensors
        fire = (active > 0.0).to(base_ramp.dtype) * dec_mask  # (B, T)
        inject = fire[:, :, None] * base_ramp[:, None, :]  # (B, T, L)
        minus = torch.cat([inject[:, 1:], torch.zeros_like(inject[:, :1])], dim=1)
        return g + (inject - minus).to(g.dtype), None, None, None


class MonotonicAlignment(torch.autograd.Function):
    """The identity on alpha (B, L); the backward adds the ramp to
    d(alpha) and subtracts it from d(prev_alpha) where active > 0. ramp:
    ``make_ramp(lengths, L, lam)``, times the step's validity; active
    (B,): the step's unscaled penalty value."""

    @staticmethod
    def forward(ctx, alpha, prev_alpha, ramp, active):
        ctx.save_for_backward(ramp, active)
        return alpha.clone()

    @staticmethod
    def backward(ctx, g):
        ramp, active = ctx.saved_tensors
        inject = torch.where(active[:, None] > 0.0, ramp, 0.0)
        return g + inject, -inject, None, None
