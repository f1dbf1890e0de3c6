"""Sequence-sharded attention decoding
(seq2seq_attention_asr_tpu/parallel/seq_attention.py).

The encoder annotations h (B, L, A) of a dp rank's rows are split over
the ranks of its sp group, L / sp positions each, and the decoder's
attention runs on each rank's positions with the collectives of
ops/attention.py: energies on the local positions, the softmax's max and
normalizer reduced over the group, the location convolution's filter
support across a shard's edge from a halo exchange, the context c =
alpha^T h and the monotonic penalty's sums reduced over the group. The
decoder state (s, mem) and the outputs are the same on every rank of the
group.

Each function takes what a dp rank holds: its rows of the batch, with
every position of h (B / dp, L, A), and takes its own positions itself,
as shard_map's in_specs split them in the JAX package. The decoder runs
its step loop of PyTorch ops on the card (ops/attention.py::step_loop);
the encoder, before it, its kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..decode import beam as beam_lib
from ..ops import attention
from .mesh import Mesh, shard_positions


def sharded_decode_teacher_forced(mesh: Mesh, params, cfg: attention.AttentionConfig,
                                  h: torch.Tensor, enc_lengths: torch.Tensor,
                                  labels_onehot: torch.Tensor, dec_mask: torch.Tensor, *,
                                  generator: Optional[torch.Generator] = None,
                                  train: bool = False) -> Dict[str, torch.Tensor]:
    """Teacher-forced decode of this dp rank's rows with h's positions
    split over the sp group (the padded L must divide sp). Returns
    decode_teacher_forced's dict for these rows: alpha over this rank's
    positions (B, T, L / sp), logprobs, s, c and penalty whole.

    The readout and its dropout run outside the sharded step loop, on the
    (s, c) that every rank of the group holds, as the JAX package runs
    them outside its shard_map (seq_attention.py:56-62 there): the
    dropout mask is drawn at the global batch's shape from `generator`,
    the same on every rank, and sliced to these rows, so that it is
    bitwise the same under every mesh shape."""
    out = attention.decode_teacher_forced(params, cfg, shard_positions(mesh, h), enc_lengths,
                                          labels_onehot, dec_mask, group=mesh.sp_group,
                                          with_readout=False)
    b = h.shape[0]  # this dp rank's rows of the global batch's mesh.dp * b
    out["logprobs"] = attention.apply_readout(params, cfg, out["s"], out["c"],
                                              generator=generator, train=train,
                                              rows=(mesh.dp_rank * b, mesh.dp * b))
    return out


def sharded_beam_search(mesh: Mesh, params, cfg: attention.AttentionConfig, h: torch.Tensor,
                        enc_lengths: torch.Tensor, eos_id, k: int = 5,
                        max_steps: Optional[torch.Tensor] = None,
                        max_steps_cap: Optional[int] = None) -> beam_lib.BeamResult:
    """Beam search of this dp rank's rows with h's positions split over the
    sp group. The beam state (hypotheses, scores, finished pool) is the
    same on every rank of the group; the annotations and each
    hypothesis's alignment hold the rank's positions. max_steps defaults
    to the global enc_lengths, max_steps_cap to the padded L. The loop's
    trip count is agreed over the whole world every step (sync_group), so
    that dp ranks whose rows finish early go on stepping while a
    neighbour's halo exchange still needs them (the JAX package's
    MULTICHIP_r03 deadlock)."""
    if max_steps is None:
        max_steps = enc_lengths
    if max_steps_cap is None:
        max_steps_cap = h.shape[1]
    return beam_lib.beam_search(params, cfg, shard_positions(mesh, h), enc_lengths, eos_id, k=k,
                                max_steps=max_steps, max_steps_cap=max_steps_cap,
                                device=mesh.device, group=mesh.sp_group, sync_group=mesh.world)
