"""Data-parallel x sequence-sharded train, eval and decode steps
(seq2seq_attention_asr_tpu/parallel/dp.py).

Each rank runs the step on its rows of the global batch (mesh.put_batch,
or the mesh Trainer's own split): the encoder on every position of its
rows, then, with sp > 1, the decoder on its sp group's share of the
positions (parallel/seq_attention.py), else the decoder's kernels. The
train step is train/trainer.py::make_step_core, the code the single-rank
step runs, given the mesh: it scales each rank's loss by the global count
of real rows (and by 1 / sp: each sp rank computes the replicated part of
the loss), sums the gradients over the world before the optimizer, and
sums the reported metrics over dp. Every rank then applies the same
update to the same parameters.

Usage (or hand the mesh to train.trainer.Trainer, which wires the three
steps, checkpoints and data into the epoch loop):
    mesh = make_mesh(dp=2, sp=2)
    step = make_sharded_train_step(model, tx, tcfg, ocfg, mesh)
    state, metrics = step(state, put_batch(mesh, batch))
"""

from __future__ import annotations

import torch

from ..decode import beam as beam_lib
from ..models.chorowski import cast_float32, float32_sums
from ..train import trainer as trainer_lib
from . import comm, seq_attention


def make_sharded_forward(model, mesh):
    """forward(params, x, x_len, onehot, dec_mask, *, generator, train) ->
    the model's forward dict for this rank's rows (alpha over its
    positions): the forward_fn contract of trainer.make_step_core. The
    float32 params and inputs are cast to the model's compute_dtype as
    its forward casts them; the readout's dropout mask is drawn at the
    global batch's shape and sliced to the rank's rows."""
    dt = getattr(torch, getattr(model.cfg, "compute_dtype", "float32"))

    def forward(params, x, x_len, onehot, dec_mask, *, generator=None, train=False):
        params, x, onehot, dec_mask = (cast_float32(a, dt) for a in (params, x, onehot, dec_mask))
        with float32_sums(dt):
            h, h_len = model.encode(params, x, x_len)
            return seq_attention.sharded_decode_teacher_forced(
                mesh, params["decoder"], model.attention_cfg, h, h_len, onehot, dec_mask,
                generator=generator, train=train)

    return forward


def make_sharded_train_step(model, tx, tcfg, ocfg, mesh):
    """step(state, batch) -> (state, metrics) on this rank's rows: the
    single-rank step core (AWN and weight noise drawn from the state's
    generator, the same on every rank, then the dropout masks; the
    monotonic penalty; the column-norm projection), with the mesh's
    reductions. The metrics are the global batch's, the same on every
    rank."""
    return trainer_lib.make_step_core(make_sharded_forward(model, mesh), tx, ocfg, tcfg,
                                      model.output_depth, mesh=mesh)


def make_sharded_eval_step(model, mesh):
    """The teacher-forced eval of this rank's rows, its sums (nll,
    correct, total, n) summed over dp: the global batch's."""
    return trainer_lib.make_eval_step(make_sharded_forward(model, mesh), model.output_depth,
                                      mesh=mesh)


def make_sharded_decode_step(model, mesh, beam_k: int, len_factor: float = 1.0,
                             compute_dtype: str = "float32"):
    """decode_fn(params, x, x_len, eos_id, max_steps_cap) on this rank's
    rows (trainer.make_decode_step's contract): encode, then the beam,
    sequence-sharded when sp > 1 (the padded L must divide sp). The
    results come back for the whole global batch, every dp rank's rows
    gathered in rank order, so that every rank can score them; give every
    rank the global cap, so that the token buffers agree."""
    dt = getattr(torch, compute_dtype)

    @torch.no_grad()
    def decode_fn(params, x, x_len, eos_id, max_steps_cap: int) -> beam_lib.BeamResult:
        params, x = cast_float32(params, dt), cast_float32(x, dt)
        with float32_sums(dt):
            h, h_len = model.encode(params, x, x_len)
            max_steps = torch.clamp((len_factor * h_len.float()).long(), max=max_steps_cap)
            if mesh.sp > 1:
                res = seq_attention.sharded_beam_search(
                    mesh, params["decoder"], model.attention_cfg, h, h_len, eos_id, k=beam_k,
                    max_steps=max_steps, max_steps_cap=max_steps_cap)
            else:
                res = beam_lib.beam_search(params["decoder"], model.attention_cfg, h, h_len,
                                           eos_id, k=beam_k, max_steps=max_steps,
                                           max_steps_cap=max_steps_cap, device=mesh.device)
        return beam_lib.BeamResult(*(comm.all_gather_rows(a, mesh.dp_group) for a in res))

    return decode_fn
