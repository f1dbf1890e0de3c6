"""Length masks, per-row flips and the masked softmax
(seq2seq_attention_asr_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

from ..parallel import comm

NEG_INF = -1e30


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) {0,1} mask."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row of x (B, L, ...) about its true length, keeping
    the padding in place: y[b, t] = x[b, len_b - 1 - t] for t < len_b,
    x[b, t] otherwise. Lengths above L count as L. Its own inverse."""
    max_len = x.shape[1]
    lengths = torch.clamp(lengths.to(x.device).long(), max=max_len)[:, None]
    idx = torch.arange(max_len, device=x.device)[None, :]
    gather = torch.where(idx < lengths, lengths - 1 - idx, idx)
    gather = gather.reshape(gather.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, gather)


def masked_softmax(e: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                   group=None) -> torch.Tensor:
    """Softmax over `dim` with positions where mask == 0 forced to 0.

    Masked energies become NEG_INF before the max, and the exponentials
    are multiplied by the mask, so a masked position gets exactly 0.

    With `group` (a process group, parallel/comm.py), `dim` is also split
    over the group's ranks (sequence sharding): the max is the group's
    all-reduce MAX, with no gradient (the softmax does not depend on it),
    and the normalizer the group's differentiable all-reduce SUM; the
    probabilities stay split."""
    keep = mask > 0
    e = torch.where(keep, e, torch.full_like(e, NEG_INF))
    m = torch.amax(e, dim=dim, keepdim=True)
    if group is not None:
        m = comm.all_reduce_max(m, group)
    w = torch.exp(e - m) * keep
    z = torch.sum(w, dim=dim, keepdim=True)
    if group is not None:
        z = comm.all_reduce_sum(z, group)
    return w / torch.clamp(z, min=1e-30)
