"""One training step and one eval step (seq2seq_attention_asr_tpu/train/trainer.py:46-263).

The train state is (params, opt_state, generator). A step computes the
loss of a padded batch (x, x_len, y, dec_mask), its gradient through
autograd (the kernels' backward passes on the card), one optimizer
update and, when the recipe asks for it, the column-norm projection
after the update. The generator is the step's source of randomness; no
part of the ported recipe draws from it yet (train-mode dropout and
AWN/weight noise, which would, are refused).

Loss semantics (timit.lua:262-295): the loss is the MEAN over real rows
(rows with any unmasked decoder step) of the per-utterance NLL.
``normalize_nll`` divides each utterance's REPORTED nll by its length;
``normalize_grad`` divides the differentiated one; the two are
independent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from .. import tree
from . import optim
from .loss import token_accuracy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    normalize_nll: bool = False  # opt.normalizeNLL
    normalize_grad: bool = False  # opt.normalizeGrad (grad /= T)
    noise: str = "none"  # "none"; "awn" and "weight" are not ported yet


def _check_noise(tcfg: TrainConfig) -> None:
    if tcfg.noise in ("awn", "weight"):
        raise NotImplementedError(f"noise={tcfg.noise!r} is not ported yet")
    if tcfg.noise != "none":
        raise ValueError(f"unknown noise {tcfg.noise!r}")


def _one_hot_labels(y: torch.Tensor, dec_mask: torch.Tensor, v: int) -> torch.Tensor:
    """The label mask (timit.lua:262): one-hot zeroed at padded steps."""
    return F.one_hot(y.long(), v).to(dec_mask.dtype) * dec_mask[..., None]


def make_init_fn(tx: optim.Transform, tcfg: TrainConfig):
    """(params, generator) -> the train state (params, opt_state, generator)."""
    _check_noise(tcfg)

    def init_fn(params, generator: torch.Generator):
        return (params, tx.init(params), generator)

    return init_fn


def make_step_core(forward_fn: Callable[..., Dict[str, torch.Tensor]], tx: optim.Transform,
                   ocfg: optim.OptimConfig, tcfg: TrainConfig, output_depth: int):
    """step_fn(state, batch) -> (state, metrics); batch = (x, x_len, y,
    dec_mask). forward_fn(params, x, x_len, labels_onehot, dec_mask, *,
    train) -> dict(logprobs, alpha, penalty). Metrics are 0-d tensors on
    the batch's device: loss (the report), nll, grad_norm, param_norm
    (global norms, the latter after the update), correct, total,
    penalty."""
    _check_noise(tcfg)

    def rowmean(v, row):
        return torch.sum(v * row) / torch.clamp(torch.sum(row), min=1.0)

    def step_fn(state, batch):
        params, opt_state, generator = state
        x, x_len, y, dec_mask = batch
        onehot = _one_hot_labels(y, dec_mask, output_depth)
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
        live = tree.unflatten(params, leaves)
        with torch.enable_grad():
            out = forward_fn(live, x, x_len, onehot, dec_mask, train=True)
            per_utt = torch.sum(-torch.sum(onehot * out["logprobs"], dim=-1) * dec_mask, dim=-1)
            steps = torch.sum(dec_mask, dim=-1)
            lens = torch.clamp(steps, min=1.0)
            row = (steps > 0).to(per_utt.dtype)  # rows of batch padding count nowhere
            loss_grad = rowmean(per_utt / lens if tcfg.normalize_grad else per_utt, row)
            grads = tree.unflatten(params, torch.autograd.grad(loss_grad, leaves))
        with torch.no_grad():
            loss = rowmean(per_utt / lens if tcfg.normalize_nll else per_utt, row)
            logprobs = out["logprobs"].detach()
            gnorm = tree.global_norm(grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
            if ocfg.colnorm:
                params = optim.colnorm_project(params, ocfg.colnorm_maxval)
            correct, total = token_accuracy(logprobs, y, dec_mask)
            metrics = {
                "loss": loss,
                "nll": loss,
                "grad_norm": gnorm,
                "param_norm": tree.global_norm(params),
                "correct": correct,
                "total": total,
                "penalty": torch.sum(out["penalty"].detach()),
            }
        return (params, opt_state, generator), metrics

    return step_fn


def make_train_step(forward_fn, tx: optim.Transform, ocfg: optim.OptimConfig, tcfg: TrainConfig,
                    output_depth: int):
    """(init_fn, step_fn): see make_init_fn and make_step_core."""
    return make_init_fn(tx, tcfg), make_step_core(forward_fn, tx, ocfg, tcfg, output_depth)


def make_eval_step(forward_fn: Callable[..., Dict[str, torch.Tensor]], output_depth: int):
    """Teacher-forced eval (timit.lua:384-394): summed NLL, accuracy
    counts, and n, the number of real rows."""

    @torch.no_grad()
    def eval_fn(params, batch) -> Dict[str, Any]:
        x, x_len, y, dec_mask = batch
        onehot = _one_hot_labels(y, dec_mask, output_depth)
        out = forward_fn(params, x, x_len, onehot, dec_mask, train=False)
        nll = torch.sum(-torch.sum(onehot * out["logprobs"], dim=-1) * dec_mask)
        correct, total = token_accuracy(out["logprobs"], y, dec_mask)
        n = torch.sum((torch.sum(dec_mask, dim=-1) > 0).to(torch.float32))
        return {"nll": nll, "correct": correct, "total": total, "n": n}

    return eval_fn
