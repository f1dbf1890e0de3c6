"""Edit-distance scoring: PER and CER (seq2seq_attention_asr_tpu/decode/metrics.py).

Wagner-Fischer Levenshtein distance (reference utils.lua:3-27) and the
PER/CER aggregation of the eval loops (timit/timit.lua:397-415,
librispeech/train.lua:247-260): the per-utterance distance divided by
the TARGET length (its eos token included), averaged over utterances.
Scoring is on the host, through the port's C++ scorer
(native/editdist.cpp, built at first use); `edit_distance_np` is the
numpy version of the same distance, for the tests and explicit callers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def edit_distance_np(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance, row-vectorized DP."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if a.size == 0:
        return int(b.size)
    if b.size == 0:
        return int(a.size)
    prev = np.arange(b.size + 1, dtype=np.int64)
    ar = np.arange(b.size + 1, dtype=np.int64)
    cand = np.empty(b.size + 1, dtype=np.int64)
    for i in range(1, a.size + 1):
        # cur[j] = min(prev[j] + 1, sub[j], cur[j-1] + 1); the recursive
        # insertion term resolves to a min-plus prefix scan:
        #   cur[j] = min_{j' <= j} cand[j'] + (j - j'),  cand[0] = i.
        cand[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]), out=cand[1:])
        prev = np.minimum.accumulate(cand - ar) + ar
    return int(prev[-1])


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance through the native scorer."""
    from ..native import editdist

    return editdist.edit_distance(a, b)


def batch_edit_distance(a: np.ndarray, a_len: Sequence[int], b: np.ndarray,
                        b_len: Sequence[int]) -> np.ndarray:
    """Per-row Levenshtein distance over padded (B, M) int arrays, the
    corpus scoring of `Evaluate` (timit/timit.lua:404-410): one native
    call a batch."""
    from ..native import editdist

    return editdist.batch_edit_distance(np.asarray(a), a_len, np.asarray(b), b_len)


def error_rate(predictions: List[np.ndarray], pred_lengths: Optional[Sequence[int]],
               targets: List[np.ndarray], target_lengths: Optional[Sequence[int]] = None) -> float:
    """mean_i editdist(pred_i, target_i) / |target_i|: PER or CER.

    predictions and targets may be padded 2-D arrays with explicit
    lengths or ragged lists (lengths None)."""
    total = 0.0
    n = len(predictions)
    for i in range(n):
        p = predictions[i]
        t = targets[i]
        if pred_lengths is not None:
            p = p[: int(pred_lengths[i])]
        if target_lengths is not None:
            t = t[: int(target_lengths[i])]
        total += edit_distance(p, t) / max(len(t), 1)
    return total / max(n, 1)
