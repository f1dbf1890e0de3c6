"""Masked NLL and teacher-forced accuracy (seq2seq_attention_asr_tpu/train/loss.py).

nll = -sum(labelmask * logprobs), optionally divided per utterance by
its length (timit.lua:262-271); the label mask doubles as the teacher-
forcing input, so padded decoder steps are zeroed in both.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_nll(logprobs: torch.Tensor, labels_onehot: torch.Tensor, dec_mask: torch.Tensor,
               normalize: bool = False) -> torch.Tensor:
    """Sum over the batch of per-utterance NLL. logprobs and
    labels_onehot (B, T, V); dec_mask (B, T). normalize divides each
    utterance's NLL by its true length (opt.normalizeNLL)."""
    per_step = -torch.sum(labels_onehot * logprobs, dim=-1) * dec_mask
    per_utt = torch.sum(per_step, dim=-1)
    if normalize:
        per_utt = per_utt / torch.clamp(torch.sum(dec_mask, dim=-1), min=1.0)
    return torch.sum(per_utt)


def token_accuracy(logprobs: torch.Tensor, labels: torch.Tensor,
                   dec_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced argmax accuracy (timit.lua:285-288): (number
    correct, number of predictions), to be summed over batches first."""
    pred = torch.argmax(logprobs, dim=-1)
    correct = torch.sum((pred == labels) * dec_mask)
    return correct, torch.sum(dec_mask)
