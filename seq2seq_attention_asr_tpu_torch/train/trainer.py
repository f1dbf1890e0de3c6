"""Training and evaluation loop (seq2seq_attention_asr_tpu/train/trainer.py).

The train state is (train_params, opt_state, generator): train_params
is the model's parameter tree, or under adaptive weight noise
(noise="awn") the dict {"mu", "s"} of train/awn.py, which the optimizer
updates as one tree. A step computes the loss of a padded batch (x,
x_len, y, dec_mask), its gradient through autograd (the kernels'
backward passes on the card), one optimizer update and, when the recipe
asks for it, the column-norm projection after the update (of mu alone
under AWN). The generator lies on the parameters' device and is the
step's one source of randomness: first the weight noise (AWN's or the
fixed-sigma one of noise="weight"), then the readout's dropout masks.
The JAX package splits its key three ways a step instead; the draws
cannot match its bits.

Loss semantics (timit.lua:262-295): the loss is the MEAN over real rows
(rows with any unmasked decoder step) of the per-utterance NLL.
``normalize_nll`` divides each utterance's REPORTED nll by its length;
``normalize_grad`` divides the differentiated one; the two are
independent.

``Trainer`` is the epoch loop of the reference (timit/timit.lua:493-565):
shuffled training with the metrics summed on the device and read every
SYNC_EVERY batches (the NaN tripwire fires at those reads), teacher-
forced valid NLL and accuracy, beam-search PER (61->39 fold with a
vocab, else the error rate on the raw ids), a JSONL metric log,
checkpoints of the latest state and of the best accuracy and PER,
resume, optimizer resets by epoch and restore on NaN, and the
out-of-core epoch over chunks of the training set (LibriSpeech). Everything
runs on the trainer's device, the card unless it is asked for the CPU.

With a mesh (parallel/mesh.py: every rank of a dp x sp world runs the same
Trainer), every rank walks the same global batches (the same batcher and
seed), pads each to a multiple of dp with dead copies of row 0 (dec_mask
0: no loss, metric or penalty), takes its rows and runs the steps of
parallel/dp.py; the metrics, eval sums and beam results are the global
batch's on every rank. Rank 0 alone writes the checkpoints, the metric
log and the dumps, a barrier after each; resume reads on every rank.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import interop, resolve_device, tree
from ..data import batching
from ..decode import beam as beam_lib
from ..decode import metrics as metrics_lib
from ..models.chorowski import cast_float32, float32_sums
from ..ops import attention as attention_ops
from ..parallel import comm
from ..utils import debug
from . import awn, checkpoint, optim
from .loss import token_accuracy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 100
    batch_size: int = 16
    normalize_nll: bool = False  # opt.normalizeNLL
    normalize_grad: bool = False  # opt.normalizeGrad (grad /= T)
    noise: str = "none"  # "none" | "awn" | "weight" (opt.adaweightnoise / weightnoise)
    # opt.adalambda: the KL's weight, ~1/num_train_samples (Graves 2011);
    # the reference's default is 1 (AdaptiveWeightNoise.lua:18).
    awn_lambda: float = 1.0
    awn_sigma_init: float = 0.075
    weight_noise_sigma: float = 0.0
    beam_k: int = 5  # opt.K
    max_samples: Optional[int] = None  # opt.maxnumsamples
    eval_len_factor: float = 1.0  # beam maxseqlen = factor * L (2.0 for librispeech)
    dump_attention: bool = False  # per-epoch alpha/Ws/Vh dump (timit.lua:540-550)
    dump_predictions: bool = False  # per-epoch beam outputs (predictions.t7, timit.lua:552)
    nan_debug: bool = True  # NaN tripwire (TrainUtils.lua:55-93)
    seed: int = 1


def _check_noise(tcfg: TrainConfig) -> None:
    if tcfg.noise not in ("none", "awn", "weight"):
        raise ValueError(f"unknown noise {tcfg.noise!r}")


def _one_hot_labels(y: torch.Tensor, dec_mask: torch.Tensor, v: int) -> torch.Tensor:
    """The label mask (timit.lua:262): one-hot zeroed at padded steps."""
    return F.one_hot(y.long(), v).to(dec_mask.dtype) * dec_mask[..., None]


def make_init_fn(tx: optim.Transform, tcfg: TrainConfig):
    """(params, generator) -> the train state (train_params, opt_state,
    generator); train_params is awn.init(params, awn_sigma_init) under
    noise="awn", else params."""
    _check_noise(tcfg)

    def init_fn(params, generator: torch.Generator):
        train_params = awn.init(params, tcfg.awn_sigma_init) if tcfg.noise == "awn" else params
        return (train_params, tx.init(train_params), generator)

    return init_fn


def make_step_core(forward_fn: Callable[..., Dict[str, torch.Tensor]], tx: optim.Transform,
                   ocfg: optim.OptimConfig, tcfg: TrainConfig, output_depth: int, mesh=None):
    """step_fn(state, batch) -> (state, metrics); batch = (x, x_len, y,
    dec_mask). forward_fn(params, x, x_len, labels_onehot, dec_mask, *,
    generator, train) -> dict(logprobs, alpha, penalty). Metrics are 0-d
    tensors on the batch's device: loss (the report), nll, grad_norm,
    param_norm (global norms, the latter after the update), correct,
    total, penalty, and under AWN awn_sigma_rms.

    Under AWN the forward runs at a sample w = mu + sigma * eps that is a
    leaf of its own; awn.grads turns dNLL/dw into the gradients of (mu,
    s), which the optimizer takes as one tree (grad_norm is theirs); the
    reported loss is the nll plus lambda * KL of the state before the
    update, param_norm is |mu|, and awn_sigma_rms the rms of sigma after
    the update (trainer.py:147-230 of the JAX package). Under
    noise="weight" the gradient at theta + sigma * eps updates theta.

    With a mesh (parallel/dp.py), the batch is this rank's rows and the
    loss stays the mean over the GLOBAL batch's real rows: each rank
    divides the sum over its rows by the global count, summed over dp
    before the backward, and by sp, since every rank of an sp group
    computes the readout and the loss of the same rows; the gradients are
    summed over the world before AWN's terms and the update, so that the
    monotonic penalty's injection, which is not scaled by the loss, counts
    once, and AWN's lambda * KL gradient is added once. The metrics are
    summed over dp."""
    _check_noise(tcfg)
    use_awn = tcfg.noise == "awn"
    dp_group = None if mesh is None else mesh.dp_group
    dp_sum = (lambda t: t) if mesh is None else (lambda t: comm.reduce(t, group=dp_group))

    def rowmean(v, row):
        """This rank's share of the mean over the global batch's real rows."""
        n_rows = torch.sum(row) if mesh is None else dp_sum(torch.sum(row))
        return torch.sum(v * row) / torch.clamp(n_rows, min=1.0)

    def step_fn(state, batch):
        train_params, opt_state, generator = state
        x, x_len, y, dec_mask = batch
        onehot = _one_hot_labels(y, dec_mask, output_depth)
        with torch.no_grad():
            if use_awn:
                params = awn.sample(generator, train_params)
            elif tcfg.noise == "weight":
                params = awn.weight_noise_sample(generator, train_params,
                                                 tcfg.weight_noise_sigma)
            else:
                params = train_params
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
        live = tree.unflatten(params, leaves)
        # The gradient runs after the forward has left its float32_sums,
        # so a bf16 model's backward products would sum in bf16 under
        # PyTorch's default flag: the step keeps the flag off for the
        # forward and the gradient alike (the JAX package sums every bf16
        # dot in float32), and restores the caller's. No float32 product
        # reads the flag.
        with torch.enable_grad(), float32_sums(torch.bfloat16):
            out = forward_fn(live, x, x_len, onehot, dec_mask, generator=generator, train=True)
            per_utt = torch.sum(-torch.sum(onehot * out["logprobs"], dim=-1) * dec_mask, dim=-1)
            steps = torch.sum(dec_mask, dim=-1)
            lens = torch.clamp(steps, min=1.0)
            row = (steps > 0).to(per_utt.dtype)  # rows of batch padding count nowhere
            loss_grad = rowmean(per_utt / lens if tcfg.normalize_grad else per_utt, row)
            if mesh is not None and mesh.sp > 1:
                loss_grad = loss_grad / mesh.sp
            grads = torch.autograd.grad(loss_grad, leaves)
        with torch.no_grad():
            if mesh is not None:
                grads = _world_sum(grads, mesh.world)
            grads = tree.unflatten(params, list(grads))
            loss = dp_sum(rowmean(per_utt / lens if tcfg.normalize_nll else per_utt, row))
            logprobs = out["logprobs"].detach()
            loss_report = loss
            if use_awn:
                loss_report = loss + tcfg.awn_lambda * awn.kl(train_params)
                grads = awn.grads(train_params, grads, tcfg.awn_lambda)
            gnorm = tree.global_norm(grads)
            updates, opt_state = tx.update(grads, opt_state, train_params)
            train_params = optim.apply_updates(train_params, updates)
            if ocfg.colnorm and use_awn:
                train_params = {"mu": optim.colnorm_project(train_params["mu"],
                                                            ocfg.colnorm_maxval),
                                "s": train_params["s"]}
            elif ocfg.colnorm:
                train_params = optim.colnorm_project(train_params, ocfg.colnorm_maxval)
            correct, total = token_accuracy(logprobs, y, dec_mask)
            metrics = {
                "loss": loss_report,
                "nll": loss,
                "grad_norm": gnorm,
                "param_norm": tree.global_norm(eval_params(tcfg, train_params)),
                "correct": dp_sum(correct),
                "total": dp_sum(total),
                "penalty": dp_sum(torch.sum(out["penalty"].detach())),
            }
            if use_awn:
                metrics["awn_sigma_rms"] = awn.sigma_rms(train_params)
        return (train_params, opt_state, generator), metrics

    return step_fn


def _world_sum(grads, world):
    """The gradients summed over the world, as one flat all-reduce."""
    if world is None:
        return grads
    flat = comm.reduce(torch.cat([g.reshape(-1) for g in grads]), group=world)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(forward_fn, tx: optim.Transform, ocfg: optim.OptimConfig, tcfg: TrainConfig,
                    output_depth: int):
    """(init_fn, step_fn): see make_init_fn and make_step_core."""
    return make_init_fn(tx, tcfg), make_step_core(forward_fn, tx, ocfg, tcfg, output_depth)


def make_eval_step(forward_fn: Callable[..., Dict[str, torch.Tensor]], output_depth: int,
                   mesh=None):
    """Teacher-forced eval (timit.lua:384-394): summed NLL, accuracy
    counts, and n, the number of real rows; with a mesh, each summed over
    dp (the global batch's)."""

    @torch.no_grad()
    def eval_fn(params, batch) -> Dict[str, Any]:
        x, x_len, y, dec_mask = batch
        onehot = _one_hot_labels(y, dec_mask, output_depth)
        out = forward_fn(params, x, x_len, onehot, dec_mask, train=False)
        nll = torch.sum(-torch.sum(onehot * out["logprobs"], dim=-1) * dec_mask)
        correct, total = token_accuracy(out["logprobs"], y, dec_mask)
        n = torch.sum((torch.sum(dec_mask, dim=-1) > 0).to(torch.float32))
        sums = {"nll": nll, "correct": correct, "total": total, "n": n}
        if mesh is not None:
            sums = {k: comm.reduce(v, group=mesh.dp_group) for k, v in sums.items()}
        return sums

    return eval_fn


def eval_params(tcfg: TrainConfig, train_params):
    """The weights evaluation uses: AWN's mode, mu, under noise="awn",
    else the params themselves (timit.lua:375-379)."""
    return awn.mode(train_params) if tcfg.noise == "awn" else train_params


def make_decode_step(encode_fn: Callable, attention_cfg, beam_k: int, len_factor: float = 1.0,
                     device="cuda", compute_dtype: str = "float32"):
    """Beam-search decode over a batch: encode, then search with a
    per-sample budget of min(len_factor * h_len, max_steps_cap) steps
    after the first. encode_fn(params, x, x_len) -> (annotations,
    annotation_lengths); eos_id (B,) is each sample's final target token
    (timit.lua:398). Under compute_dtype="bfloat16" the float32 params
    and x are cast to bf16 first (trainer.py:266-300 of the JAX
    package): the encoder and the beam step run their bf16 kernels, the
    bf16 products outside them sum in float32 (chorowski.float32_sums),
    the scores stay float32."""
    dev = resolve_device(device)
    dt = getattr(torch, compute_dtype)

    @torch.no_grad()
    def decode_fn(params, x, x_len, eos_id, max_steps_cap: int) -> beam_lib.BeamResult:
        params, x = cast_float32(params, dt), cast_float32(x, dt)
        with float32_sums(dt):
            h, h_len = encode_fn(params, x, x_len)
            max_steps = torch.clamp((len_factor * h_len.float()).long(), max=max_steps_cap)
            return beam_lib.beam_search(params["decoder"], attention_cfg, h, h_len, eos_id,
                                        k=beam_k, max_steps=max_steps,
                                        max_steps_cap=max_steps_cap, device=dev)

    return decode_fn


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


class MetricLog:
    """JSONL metrics log (the reference's HDF5 log.h5 scalar series,
    timit.lua:428-445). Numbers are written as floats."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.rows = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, row: Dict[str, Any]):
        row = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
               for k, v in row.items()}
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")

    @staticmethod
    def load(path: str):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]


class Trainer:
    """Epoch loop: Train() + Evaluate() + checkpoints + logs, on `device`
    (the card unless "cpu"). `vocab` (data.timit.Vocab) scores PER after
    the 61->39 fold; without it the error rate is taken on the raw ids.
    `optim_resets` maps an epoch to the OptimConfig it starts with
    (optimConfigResets, timit.lua:496-502). `mesh` (parallel.make_mesh)
    runs the dp x sp steps of parallel/dp.py on the mesh's device, which
    takes the place of `device`."""

    # Metrics are summed on the device and read back (one sync) every
    # this many batches; the NaN tripwire fires at these reads.
    SYNC_EVERY = 50

    _AGG_KEYS = ("loss", "nll", "correct", "total", "grad_norm", "penalty")

    def __init__(self, model, ocfg: optim.OptimConfig, tcfg: TrainConfig, *, vocab=None,
                 save_dir: Optional[str] = None,
                 optim_resets: Optional[Dict[int, optim.OptimConfig]] = None, device="cuda",
                 mesh=None):
        _check_noise(tcfg)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_chief = mesh is None or mesh.is_chief
        self.model = model
        self.ocfg = ocfg
        self.tcfg = tcfg
        self.vocab = vocab
        self.save_dir = save_dir
        self.optim_resets = optim_resets or {}
        self.log = MetricLog(os.path.join(save_dir, "log.jsonl")
                             if save_dir and self.is_chief else None)
        self._build(ocfg)
        self.state = None
        self.epoch = 0
        self.best = {"valid_accuracy": -1.0, "valid_per": float("inf")}

    def _build(self, ocfg: optim.OptimConfig):
        self.tx = optim.build_optimizer(ocfg)
        self.init_fn = make_init_fn(self.tx, self.tcfg)
        dtype = getattr(self.model.cfg, "compute_dtype", "float32")
        if self.mesh is not None:
            from ..parallel import dp

            self.step_fn = dp.make_sharded_train_step(self.model, self.tx, self.tcfg, ocfg,
                                                      self.mesh)
            self.eval_fn = dp.make_sharded_eval_step(self.model, self.mesh)
            self.decode_fn = dp.make_sharded_decode_step(self.model, self.mesh, self.tcfg.beam_k,
                                                         self.tcfg.eval_len_factor,
                                                         compute_dtype=dtype)
            return
        self.step_fn = make_step_core(self.model.forward, self.tx, ocfg, self.tcfg,
                                      self.model.output_depth)
        self.eval_fn = make_eval_step(self.model.forward, self.model.output_depth)
        self.decode_fn = make_decode_step(self.model.encode, self.model.attention_cfg,
                                          self.tcfg.beam_k, self.tcfg.eval_len_factor,
                                          device=self.device, compute_dtype=dtype)

    # -- state management ---------------------------------------------------

    def init(self, params):
        """The train state from `params` (numpy arrays or tensors), moved to
        the trainer's device (with a mesh, rank 0's, broadcast to every
        rank); the generator, on that device, is seeded with tcfg.seed, on
        every rank alike."""
        params = interop.to_torch(params, self.device)
        if self.mesh is not None:
            from ..parallel import mesh as mesh_lib

            params = mesh_lib.put_replicated(self.mesh, params)
        self.state = self.init_fn(params,
                                  torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        return self.state

    def _ckpt_path(self, tag: str) -> str:
        return os.path.join(self.save_dir, f"ckpt_{tag}")

    def _chief_writes(self, write) -> None:
        """write() on rank 0 alone (every rank without a mesh), then a
        barrier, so that no rank reads what rank 0 has not finished."""
        if self.is_chief:
            write()
        if self.mesh is not None:
            comm.barrier(self.mesh.world)

    def save_checkpoint(self, tag: str = "latest"):
        if self.save_dir:
            self._chief_writes(lambda: checkpoint.save(
                self._ckpt_path(tag), {"state": self.state, "epoch": self.epoch,
                                       "best": self.best}))

    def resume(self) -> bool:
        """Load ckpt_latest (state, epoch, best); False if there is none."""
        if not self.save_dir or self.state is None:
            return False
        path = self._ckpt_path("latest")
        if not checkpoint.exists(path):
            return False
        blob = checkpoint.load(path, device=self.device)
        self.state = tuple(blob["state"])
        self.epoch = int(blob["epoch"])
        self.best = {k: float(v) for k, v in blob["best"].items()}
        return True

    # -- epoch phases -------------------------------------------------------

    def _prepare_batch(self, batch, with_eos: bool = False):
        """A Batch or DeviceBatch -> ((x, x_len, y, dec_mask) on the device,
        y_len, eos); eos (the final target token of each utterance,
        timit.lua:398) is None unless with_eos. With a mesh the batch is
        first padded to a multiple of dp with dead copies of row 0 (its
        dec_mask zeroed: it adds to no loss, metric or penalty, and its
        lengths stay valid for the softmax; trainer.py:514-528 of the JAX
        package), and the arrays and eos are this rank's rows; y_len stays
        the global batch's real rows'."""
        if not isinstance(batch, batching.DeviceBatch):
            batch = batching.to_device(batch, self.device)
        arrs = tuple(a.to(self.device) for a in (batch.x, batch.x_len, batch.y, batch.dec_mask))
        y_len = np.asarray(batch.y_len)
        eos = None
        if with_eos:
            n = arrs[2].shape[0]
            rows = torch.arange(n, device=self.device)
            eos = arrs[2][rows, torch.as_tensor(y_len - 1, device=self.device).long()]
        if self.mesh is not None:
            from ..parallel import mesh as mesh_lib

            n = arrs[0].shape[0]
            dead = -n % self.mesh.dp
            if dead:
                rep = lambda a: torch.cat([a, a[:1].expand((dead,) + tuple(a.shape[1:]))])
                x, x_len, y, dec_mask = (rep(a) for a in arrs)
                dec_mask = torch.cat([dec_mask[:n], torch.zeros_like(dec_mask[n:])])
                arrs = (x, x_len, y, dec_mask)
                eos = None if eos is None else rep(eos)
            arrs = tuple(mesh_lib.shard_batch(self.mesh, a) for a in arrs)
            eos = None if eos is None else mesh_lib.shard_batch(self.mesh, eos)
        return arrs, y_len, eos

    def _batch_arrays(self, batch):
        return self._prepare_batch(batch)[0]

    def _drain(self, agg, agg_dev) -> None:
        """Add the device-side sums to the host's, with one read."""
        if agg_dev is not None:
            vals = torch.stack([agg_dev[k].float() for k in self._AGG_KEYS]).tolist()
            for k, v in zip(self._AGG_KEYS, vals):
                agg[k] += v

    def _tripwire(self, where: str, batch=None):
        bad = debug.find_nonfinite(self.state[0])
        uids = f" (uids {list(batch.uids)[:4]}...)" if batch is not None else ""
        raise debug.NonFiniteError(f"loss went non-finite {where}{uids}",
                                   bad or ["<params finite; non-finite loss only>"])

    def train_epoch(self, ds, batcher, epoch: int) -> Dict[str, float]:
        agg = {k: 0.0 for k in self._AGG_KEYS}
        t0 = time.time()
        n_batches, n_samples = self._train_pass(ds, batcher, epoch, agg)
        return self._train_row(agg, n_batches, n_samples, time.time() - t0, epoch)

    def train_epoch_chunked(self, load_chunk, n_chunks: int, batcher_fn,
                            epoch: int) -> Dict[str, float]:
        """The out-of-core epoch: the train chunks in an order drawn from
        RandomState(seed + epoch), one resident at a time (the reference's
        chunked LibriSpeech loop, librispeech/train.lua:82-103).
        load_chunk(i) -> Dataset; batcher_fn(ds) -> a batcher for it. The
        k-th chunk's pass shuffles its batches as epoch epoch * 1000 + k
        would."""
        agg = {k: 0.0 for k in self._AGG_KEYS}
        t0 = time.time()
        nb = ns = 0
        order = np.random.RandomState(self.tcfg.seed + epoch).permutation(n_chunks)
        for k, ci in enumerate(order):
            ds = load_chunk(int(ci))
            b, s = self._train_pass(ds, batcher_fn(ds), epoch * 1000 + k, agg)
            nb += b
            ns += s
        return self._train_row(agg, nb, ns, time.time() - t0, epoch)

    def _train_row(self, agg, n_batches: int, n_samples: int, dt: float, epoch: int):
        row = {
            "epoch": epoch,
            "train_loss": agg["loss"] / max(n_batches, 1),
            "train_nll": agg["nll"] / max(n_batches, 1),
            "train_accuracy": agg["correct"] / max(agg["total"], 1.0),
            "grad_norm": agg["grad_norm"] / max(n_batches, 1),
            "penalty": agg["penalty"] / max(n_samples, 1),
            "train_seconds": dt,
            "train_samples_per_s": n_samples / max(dt, 1e-9),
        }
        # Under AWN, the last batch's sigma rms and |mu|: the posterior's
        # drift (mu draining, sigma inflating) shows here before the PER.
        for k in ("awn_sigma_rms", "param_norm"):
            if k in agg:
                row[k] = agg[k]
        return row

    def _train_pass(self, ds, batcher, epoch: int, agg) -> Tuple[int, int]:
        agg_dev = None  # device-side running sums
        n_batches = n_samples = 0
        m = {}
        for batch in batcher.batches(ds, shuffle=True, seed=self.tcfg.seed + epoch,
                                     max_samples=self.tcfg.max_samples):
            self.state, m = self.step_fn(self.state, self._batch_arrays(batch))
            n_batches += 1
            n_samples += len(batch.uids)
            agg_dev = ({k: m[k] for k in self._AGG_KEYS} if agg_dev is None
                       else {k: agg_dev[k] + m[k] for k in self._AGG_KEYS})
            if n_batches % self.SYNC_EVERY == 0:
                self._drain(agg, agg_dev)
                agg_dev = None
                if self.tcfg.nan_debug and not math.isfinite(agg["loss"]):
                    self._tripwire(f"by epoch {epoch} batch {n_batches}", batch)
        self._drain(agg, agg_dev)
        if "awn_sigma_rms" in m:
            agg["awn_sigma_rms"] = float(m["awn_sigma_rms"])
            agg["param_norm"] = float(m["param_norm"])
        if self.tcfg.nan_debug and not math.isfinite(agg["loss"]):
            self._tripwire(f"in epoch {epoch}")
        return n_batches, n_samples

    @torch.no_grad()
    def evaluate(self, ds, batcher, decode: bool = True) -> Dict[str, float]:
        """Teacher-forced NLL and accuracy, and with `decode` the beam
        search's PER or CER (timit.lua:368-417): each utterance's edit
        distance over its target length (eos included), averaged over
        utterances. A batch's beam history holds ceil(eval_len_factor *
        L_pad) steps."""
        params = eval_params(self.tcfg, self.state[0])
        acc_dev = None  # device-side running sums (one read at the end)
        dists = []
        dump_pred = decode and self.tcfg.dump_predictions and self.save_dir
        pred_rows = []  # (uids, pred, plen, scores, targets, tlen)
        t0 = time.time()
        first = True
        for batch in batcher.batches(ds, shuffle=False, max_samples=self.tcfg.max_samples):
            if first:
                first = False
                self._maybe_dump_attention(params, batch)
            arrs, y_len, eos = self._prepare_batch(batch, with_eos=True)
            m = self.eval_fn(params, arrs)
            md = {k: m[k] for k in ("nll", "correct", "total", "n")}
            acc_dev = md if acc_dev is None else {k: acc_dev[k] + md[k] for k in md}
            if decode:
                x, x_len, _, _ = arrs
                # The history must hold factor * L hypotheses: the
                # LibriSpeech recipe decodes up to 2L steps
                # (librispeech/train.lua:251-252).
                cap = int(math.ceil(self.tcfg.eval_len_factor * x.shape[1]))
                res = self.decode_fn(params, x, x_len, eos, max_steps_cap=cap)
                # a mesh's results are the global batch's, dead rows last
                n = len(y_len)
                pred = res.tokens.cpu().numpy()[:n]
                plen = res.lengths.cpu().numpy()[:n]
                if self.vocab is not None and batch.y39 is not None:
                    targets = np.asarray(batch.y39)
                    pred = self.vocab.map_ids_61_to_39(pred)
                else:
                    targets = torch.as_tensor(batch.y).cpu().numpy()
                d = metrics_lib.batch_edit_distance(pred, plen, targets, y_len)
                dists.extend((d / np.maximum(y_len, 1)).tolist())
                if dump_pred:
                    pred_rows.append((list(batch.uids), pred, plen,
                                      res.scores.cpu().numpy()[:n], targets, y_len))
        if dump_pred and pred_rows:
            self._chief_writes(lambda: self._dump_predictions(pred_rows))
        acc = {}
        if acc_dev is not None:
            keys = list(acc_dev)
            acc = dict(zip(keys, torch.stack([acc_dev[k].float() for k in keys]).tolist()))
        out = {
            "valid_nll": acc.get("nll", 0.0) / max(acc.get("n", 0.0), 1.0),
            "valid_accuracy": acc.get("correct", 0.0) / max(acc.get("total", 0.0), 1.0),
            "valid_seconds": time.time() - t0,
        }
        if decode and dists:
            out["valid_per"] = float(np.mean(dists))
        return out

    def _dump_predictions(self, rows):
        """The epoch's beam outputs on the whole valid set (predictions.t7,
        timit.lua:552): one npz of padded tokens, lengths, scores and
        targets."""
        m = max(r[1].shape[1] for r in rows)
        tm = max(r[4].shape[1] for r in rows)
        pad = lambda a, w: np.pad(a, ((0, 0), (0, w - a.shape[1])))
        np.savez(
            os.path.join(self.save_dir, f"predictions_epoch{self.epoch + 1}.npz"),
            uids=np.asarray([u for r in rows for u in r[0]]),
            tokens=np.concatenate([pad(r[1], m) for r in rows]),
            lengths=np.concatenate([r[2] for r in rows]),
            scores=np.concatenate([r[3] for r in rows]),
            targets=np.concatenate([pad(r[4], tm) for r in rows]),
            target_lengths=np.concatenate([r[5] for r in rows]),
        )

    def _copy_predictions(self, tag: str):
        """predictions_best_*.t7 (timit.lua:555-562): the current epoch's
        prediction dump under the best-metric name; where this epoch wrote
        none (decode_every > 1), the newest one, with a log event."""
        if not (self.tcfg.dump_predictions and self.save_dir):
            return
        src = os.path.join(self.save_dir, f"predictions_epoch{self.epoch}.npz")
        if not os.path.exists(src):
            key = lambda p: int(re.search(r"epoch(\d+)", p).group(1))
            cands = sorted((p for p in glob.glob(os.path.join(self.save_dir,
                                                              "predictions_epoch*.npz"))
                            if re.search(r"epoch(\d+)", p)), key=key)
            if not cands:
                return
            src = cands[-1]
            self.log.append({"epoch": self.epoch, "event": "predictions_fallback", "tag": tag,
                             "source": os.path.basename(src)})
        self._chief_writes(lambda: shutil.copyfile(
            src, os.path.join(self.save_dir, f"predictions_{tag}.npz")))

    def _maybe_dump_attention(self, params, batch):
        """The first valid batch's alpha maps, the Ws projections of each
        step's s_{t-1} and the Vh projections of the annotations, and the
        output log-probs (timit.lua:540-550): attn_epoch{N}.npz."""
        if not (self.tcfg.dump_attention and self.save_dir) or not self.is_chief:
            return
        if not isinstance(batch, batching.DeviceBatch):
            batch = batching.to_device(batch, self.device)
        # the whole batch, unsharded, on rank 0 alone
        x, x_len, y, dec_mask = (a.to(self.device)
                                 for a in (batch.x, batch.x_len, batch.y, batch.dec_mask))
        onehot = _one_hot_labels(y, dec_mask, self.model.output_depth)
        dec = params["decoder"]
        h, h_len = self.model.encode(params, x, x_len)
        out = attention_ops.decode_teacher_forced(dec, self.model.attention_cfg, h, h_len, onehot,
                                                  dec_mask)
        s_prev = torch.cat([torch.zeros_like(out["s"][:, :1]), out["s"][:, :-1]], dim=1)
        np.savez(
            os.path.join(self.save_dir, f"attn_epoch{self.epoch + 1}.npz"),
            alpha=out["alpha"].cpu().numpy(),
            ws=(s_prev @ dec["ws"]["w"] + dec["ws"]["b"]).cpu().numpy(),  # (B, T, scoreDepth)
            vh=attention_ops.precompute_vh(dec, h).cpu().numpy(),  # (B, L, scoreDepth)
            output=out["logprobs"].cpu().numpy(),
            uids=np.asarray(batch.uids),
            x_len=x_len.cpu().numpy(),
            y_len=np.asarray(batch.y_len),
        )

    # -- full fit -----------------------------------------------------------

    def fit(self, train_ds, valid_ds, batcher, *, resume: bool = False, decode_every: int = 1,
            on_nan: str = "raise", max_nan_restores: int = 3, chunked=None, ckpt_every: int = 1):
        """Epoch loop, yielding each epoch's metric row. on_nan="raise"
        stops at the NaN tripwire; "restore" rolls back to ckpt_latest
        with a reshuffled epoch seed and goes on, up to max_nan_restores
        times. ckpt_every: epochs between "latest" checkpoints (the last
        epoch always saves); best-metric checkpoints always save.

        chunked: a (load_chunk, n_chunks, batcher_fn) triple for the
        out-of-core epoch (train_epoch_chunked); `train_ds` is ignored
        then, and `batcher` serves the validation pass only."""
        if resume:
            self.resume()
        nan_restores = 0
        while self.epoch < self.tcfg.num_epochs:
            epoch = self.epoch + 1
            if epoch in self.optim_resets:
                # optimConfigResets: new hyperparameters and optimizer
                # state, the same params (timit.lua:496-502)
                train_params, _, gen = self.state
                self._build(self.optim_resets[epoch])
                self.state = (train_params, self.tx.init(train_params), gen)
            try:
                if chunked is not None:
                    row = self.train_epoch_chunked(*chunked, epoch)
                else:
                    row = self.train_epoch(train_ds, batcher, epoch)
            except debug.NonFiniteError as e:
                recoverable = (on_nan == "restore" and nan_restores < max_nan_restores
                               and self.save_dir is not None)
                if not (recoverable and self.resume()):
                    raise
                nan_restores += 1
                self.log.append({"epoch": epoch, "event": "nan_restore",
                                 "restores": nan_restores, "detail": str(e)[:200]})
                # another shuffle on retry, so that a poison batch order
                # does not repeat the blow-up
                self.tcfg = dataclasses.replace(self.tcfg,
                                                seed=self.tcfg.seed + 101 * nan_restores)
                continue
            do_decode = decode_every > 0 and epoch % decode_every == 0
            row.update(self.evaluate(valid_ds, batcher, decode=do_decode))
            self.epoch = epoch
            self.log.append(row)
            if ckpt_every > 0 and (epoch % ckpt_every == 0 or epoch >= self.tcfg.num_epochs):
                self.save_checkpoint("latest")
            if row["valid_accuracy"] > self.best["valid_accuracy"]:
                self.best["valid_accuracy"] = row["valid_accuracy"]
                self.save_checkpoint("best_valid_accuracy")
                self._copy_predictions("best_valid_accuracy")
            if row.get("valid_per", float("inf")) < self.best["valid_per"]:
                self.best["valid_per"] = row["valid_per"]
                self.save_checkpoint("best_valid_PER")
                self._copy_predictions("best_valid_PER")
            yield row
