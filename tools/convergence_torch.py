#!/usr/bin/env python3
"""Convergence trajectory harness of the PyTorch port: from-scratch
beam-search PER curves of the recipes on synthetic speech-shaped corpora,
the port's counterpart of tools/convergence.py (whose flags, corpora,
widths, optimizer and stage schedule it mirrors).

Real TIMIT and LibriSpeech audio are not redistributable, so the models
train on the synthetic phone-emission task (data/synthetic.py): per-phone
prototype frames plus noise, a monotonic alignment, <EOS> termination.
The PER is the held-out split's beam-search PER (K=5), so it measures
generalization, not memorization.

Two corpus modes:
  default:       train_valid's 40-phone corpus; --model chorowski (the
                 canonical content attention GRU recipe), conv_bilstm (the
                 8x downsampling conv+BiLSTM recipe, location-aware LSTM
                 decoder) or vgg (the LibriSpeech VGG recipe on 3-channel
                 stacked, frequency-smoothed features); --chunks N drives
                 the out-of-core chunked epoch over N in-memory chunks.
  --timit-shape: timit_shaped's 61-phone corpus scored after the 61->39
                 fold, and the flagship chorowski_dropout recipe as a
                 3-stage length curriculum: (1) boot, the <=17-token
                 subset; (2) full, the whole corpus, the same trainer;
                 (3) awn, a new trainer with adaptive weight noise from
                 stage 2's weights. Features are always built on the host
                 (the JAX package's on-device synthesis is not ported), so
                 --host-features is implied.

Everything runs on the card unless --cpu is given; without a card and
without --cpu the harness raises. On the card TF32 is off, as in the
reference's float32 semantics. The initial weights come from
torch.Generator().manual_seed(--seed) on the CPU, so that a card run and
a CPU run start from the same weights; main(argv, init_params) takes
other ones instead (a tree of numpy arrays, e.g. the JAX package's).
There is no chip lease: run one harness a card at a time.

The JSON written to --out, {"meta", "trajectory"}, is rewritten after
every epoch, so a run that is cut keeps its rows. With --save-dir the
trainer checkpoints there and the best-PER evaluation weights (under AWN,
mu) are saved to <save-dir>/ckpt_best_eval.

Usage:
  python3 tools/convergence_torch.py --out runs/convergence_torch_conv_bilstm.json \\
      --model conv_bilstm --train-utts 400 --valid-utts 64 --epochs 600 \\
      --batch-size 32 --decode-every 20 [--cpu] [--small]
  python3 tools/convergence_torch.py --timit-shape --stage-epochs 300,120,0 \\
      --decode-every 3 --out runs/convergence_torch_timit_shape.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from seq2seq_attention_asr_tpu_torch import resolve_device  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import batching, features, synthetic  # noqa: E402
from seq2seq_attention_asr_tpu_torch.models import registry  # noqa: E402
from seq2seq_attention_asr_tpu_torch.train import checkpoint, optim  # noqa: E402
from seq2seq_attention_asr_tpu_torch.train import trainer as trainer_lib  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--train-utts", type=int, default=None)
    ap.add_argument("--valid-utts", type=int, default=None)
    ap.add_argument("--n-phones", type=int, default=40)
    ap.add_argument("--noise", type=float, default=0.35)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--decode-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch path)")
    ap.add_argument("--small", action="store_true", help="quarter-size model for quick runs")
    ap.add_argument("--model", default="chorowski", choices=("chorowski", "conv_bilstm", "vgg"),
                    help="default-mode recipe (the timit-shape mode is chorowski_dropout)")
    ap.add_argument("--feature-maps", type=int, default=16,
                    help="location-attention feature maps of --model vgg; the conv encoder "
                         "carries no position, so the free-running beam needs them on this "
                         "corpus")
    ap.add_argument("--unique-phones", action="store_true",
                    help="draw each utterance's phones without replacement")
    ap.add_argument("--chunks", type=int, default=1,
                    help=">1: train through the out-of-core chunked epoch over N chunks of "
                         "the train split (librispeech/train.lua:82-103)")
    ap.add_argument("--device-batches", action="store_true",
                    help="stage the batches once and reshuffle their order each epoch "
                         "(CachedDeviceBatcher) on the CPU too, as the card always does; "
                         "without it a CPU run reshuffles the utterances each epoch, as the "
                         "JAX harness does on its CPU")
    ap.add_argument("--timit-shape", action="store_true",
                    help="61-phone TIMIT-shaped corpus, the flagship curriculum")
    ap.add_argument("--stage-epochs", default=None,
                    help="timit-shape stage lengths 'boot,full,awn'")
    ap.add_argument("--awn-only", action="store_true",
                    help="run only the AWN stage, from --from-ckpt")
    ap.add_argument("--from-ckpt", default=None,
                    help="a checkpoint of the port's Trainer (ckpt_* of a boot or full stage)")
    ap.add_argument("--awn-lambda", type=float, default=None,
                    help="AWN KL weight (default 1/N_train, AdaptiveWeightNoise.lua:18)")
    ap.add_argument("--awn-sigma-init", type=float, default=0.01,
                    help="AWN posterior init sigma on the trained model (the reference's "
                         "0.075 is a from-scratch scale)")
    ap.add_argument("--save-dir", default=None,
                    help="Trainer checkpoint dir (and the best-PER eval export)")
    ap.add_argument("--compute-dtype", default=None,
                    help="timit-shape mode: the model's compute dtype (e.g. bfloat16)")
    ap.add_argument("--host-features", action="store_true",
                    help="accepted for the JAX harness's command lines: the port always "
                         "builds the features on the host")
    return ap.parse_args(argv)


def main(argv=None, init_params=None):
    """Run the harness; returns the trajectory rows. init_params: the
    first trainer's initial weights (numpy leaves, Trainer.init's input)
    in place of the seeded CPU draw."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.timit_shape:
        return run_timit_shape(args, device, init_params)
    return run_default(args, device, init_params)


def device_meta(device) -> dict:
    """meta's backend and, on the card, its name and power limit."""
    meta = {"backend": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        try:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        except (OSError, IndexError, subprocess.SubprocessError):
            line = f"{torch.cuda.get_device_name(0)}, power limit not read"
        meta["device"] = line
        meta["cuda"] = torch.version.cuda
    return meta


def smooth_freq(x: np.ndarray) -> np.ndarray:
    """Two passes of a [1/4, 1/2, 1/4] filter along the frequency axis
    (edge-padded): real log-mel bins are locally correlated, the structure
    VGG's 3x3 convs and frequency max-pools assume."""
    k = np.array([0.25, 0.5, 0.25])
    pad = np.pad(x, ((0, 0), (2, 2)), mode="edge")
    for _ in range(2):
        pad = k[0] * np.roll(pad, 1, 1) + k[1] * pad + k[2] * np.roll(pad, -1, 1)
    return pad[:, 2:-2]


def stack3(x: np.ndarray) -> np.ndarray:
    """(L, F) -> (L, F, 3): the smoothed features, their deltas and
    delta-deltas, as logmel_stacked_np stacks them."""
    x = smooth_freq(x)
    d1 = features.delta_np(x.T, order=1).T
    d2 = features.delta_np(x.T, order=2).T
    return np.ascontiguousarray(np.stack([x, d1, d2], axis=-1), np.float32)


def default_corpus(args):
    """(train, valid, vocab size, corpus description) of the default mode."""
    n_train = args.train_utts or 200
    n_valid = args.valid_utts or 40
    feat_dim = 40 if args.model == "vgg" else 123
    train, valid, v = synthetic.train_valid(
        n_train, n_valid, n_phones=args.n_phones, feat_dim=feat_dim, min_len=6, max_len=16,
        frames_per_phone=(4, 9), noise=args.noise, seed=args.seed,
        unique_phones=args.unique_phones)
    if args.model == "vgg":
        for ds in (train, valid):
            ds.x[:] = [stack3(x) for x in ds.x]
    desc = {"kind": "synthetic", "train_utts": n_train, "valid_utts": n_valid,
            "n_phones": args.n_phones, "feat_dim": feat_dim, "noise": args.noise,
            "unique_phones": bool(args.unique_phones),
            "stacked_channels": 3 if args.model == "vgg" else 0}
    return train, valid, v, desc


def chunk_split(train, chunks: int) -> list:
    """The train split as consecutive chunks of ceil(n / chunks) utterances."""
    n = len(train)
    per = -(-n // chunks)
    return [dataclasses.replace(train, uids=train.uids[lo:lo + per], x=train.x[lo:lo + per],
                                y=train.y[lo:lo + per], start=train.start[lo:lo + per],
                                finish=train.finish[lo:lo + per])
            for lo in range(0, n, per)]


def default_model(args, v: int):
    """(model, dims) of the default mode's recipe."""
    if args.model == "conv_bilstm":
        dims = (dict(hidden_frame_size=64, output_frame_size=32, score_depth=64, state_depth=100)
                if args.small else
                dict(hidden_frame_size=256, output_frame_size=128, score_depth=150,
                     state_depth=400))
        return registry.build("conv_bilstm", input_frame_size=123, output_depth=v,
                              feature_maps=16, filt_size=5, **dims), dims
    if args.model == "vgg":
        dims = (dict(output_frame_size=64, score_depth=64, state_depth=64, mlp_depth=32)
                if args.small else
                dict(output_frame_size=512, score_depth=512, state_depth=256, mlp_depth=64))
        model = registry.build("vgg", input_frame_size=40, output_depth=v,
                               feature_maps=args.feature_maps, filt_size=10, **dims)
        return model, dict(dims, feature_maps=args.feature_maps)
    dims = _dims(args.small)
    # content attention (feature_maps 0), GRU decoder, maxout readout
    # (exp_logmel7_chorowski_normNLL_colnorm.lua)
    return registry.build("chorowski", input_frame_size=123, output_depth=v, feature_maps=0,
                          filt_size=10, **dims), dims


def run_default(args, device, init_params=None):
    train, valid, v, corpus_desc = default_corpus(args)
    epochs = args.epochs or 40
    batch = args.batch_size or 16
    model, dims = default_model(args, v)
    tcfg = trainer_lib.TrainConfig(
        num_epochs=epochs, batch_size=batch, normalize_nll=True, beam_k=5, seed=args.seed,
        # the LibriSpeech evaluation gives the beam 2L steps (librispeech/train.lua:251-252)
        eval_len_factor=2.0 if args.model == "vgg" else 1.0)
    tr = trainer_lib.Trainer(model, _ocfg(), tcfg, save_dir=args.save_dir, device=device)
    tr.init(_init(model, args.seed, init_params))
    cached = device.type == "cuda" or args.device_batches

    def batcher_of(ds, n_buckets):
        bt = batching.BucketedBatcher.from_dataset(ds, batch, n_buckets=n_buckets)
        return batching.CachedDeviceBatcher(bt, seed=args.seed, device=device) if cached else bt

    batcher = batcher_of(train, 4)
    chunked = None
    if args.chunks > 1:
        subs = chunk_split(train, args.chunks)  # held here, so that their ids stay unique
        memo = {}

        def chunk_batcher(ds):
            # Trainer.fit asks for a batcher at each visit of a chunk: one
            # a chunk, so that its batches are staged once
            if id(ds) not in memo:
                memo[id(ds)] = batcher_of(ds, 2)
            return memo[id(ds)]

        chunked = (lambda i: subs[i], len(subs), chunk_batcher)

    meta = dict(device_meta(device), model={"name": args.model, **dims, "output_depth": v},
                corpus=corpus_desc, chunks=args.chunks, seed=args.seed,
                batches="staged once, order reshuffled" if cached else "reshuffled",
                recipe="adadelta(0.95,1e-8) normalizeNLL colnorm1.0 beam_k=5 (canonical)")
    print(f"backend={meta['backend']} model={meta['model']}", flush=True)
    rows = []
    t0 = time.time()
    _fit_logged(tr, train, valid, batcher, args.decode_every, rows, t0, meta, args.out,
                chunked=chunked)
    _summary(rows, t0)
    _export_best(args.save_dir, tr, tcfg, device)
    return rows


def _dims(small: bool) -> dict:
    return (dict(hidden_frame_size=64, output_frame_size=64, score_depth=128, state_depth=64,
                 mlp_depth=32)
            if small else
            dict(hidden_frame_size=256, output_frame_size=256, score_depth=512, state_depth=256,
                 mlp_depth=64))


def _ocfg() -> optim.OptimConfig:
    """Column-norm projection to maxval 1.0, the reference's
    columnNormConstraint default (TrainUtils.lua:52-53)."""
    return optim.OptimConfig(rho=0.95, eps=1e-8, colnorm=True, colnorm_maxval=1.0, maxnorm=1e20)


def _init(model, seed: int, init_params):
    """The first trainer's initial weights: init_params, else the model's
    init drawn on the CPU from torch.Generator().manual_seed(seed)."""
    if init_params is not None:
        return init_params
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


def _fit_logged(tr, train, valid, batcher, decode_every, rows, t0, meta, out, stage=None,
                chunked=None):
    for row in tr.fit(train, valid, batcher, decode_every=decode_every, ckpt_every=25,
                      chunked=chunked):
        row["wall_s"] = time.time() - t0
        if stage:
            row["stage"] = stage
        rows.append(dict(row))
        msg = (f"{stage or 'ep'} ep {row['epoch']:3d} nll {row['train_nll']:.3f} "
               f"acc {row['train_accuracy']:.3f}")
        if "valid_per" in row:
            msg += f" valid_per {row['valid_per']:.4f}"
        print(msg + f" ({row['wall_s']:.0f}s)", flush=True)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"meta": meta, "trajectory": rows}, f, indent=1)


def _summary(rows, t0) -> None:
    pers = [r["valid_per"] for r in rows if "valid_per" in r]
    if pers:
        print(f"final valid PER {pers[-1]:.4f} (best {min(pers):.4f}) over {len(rows)} epochs, "
              f"{time.time() - t0:.0f}s", flush=True)


def _export_best(save_dir, tr, tcfg, device) -> None:
    """Save the best-PER evaluation weights (under AWN, mu) as a plain
    parameter tree, <save_dir>/ckpt_best_eval."""
    if not save_dir:
        return
    path = tr._ckpt_path("best_valid_PER")
    src = path if checkpoint.exists(path) else tr._ckpt_path("latest")
    if not checkpoint.exists(src):
        print(f"no checkpoint in {save_dir} to export", flush=True)
        return
    blob = checkpoint.load(src, device=device)
    checkpoint.save(os.path.join(save_dir, "ckpt_best_eval"),
                    trainer_lib.eval_params(tcfg, blob["state"][0]))
    print(f"exported best eval params from {src}", flush=True)


def boot_subset(train):
    """The bootstrap stage's utterances: those with at most 17 tokens."""
    idx = [i for i in range(len(train)) if len(train.y[i]) <= 17]
    pick = lambda xs: [xs[i] for i in idx]
    return dataclasses.replace(train, uids=pick(train.uids), x=pick(train.x), y=pick(train.y),
                               y39=pick(train.y39), start=pick(train.start),
                               finish=pick(train.finish))


def run_timit_shape(args, device, init_params=None):
    """The flagship recipe's 3-stage length curriculum (module docstring)."""
    n_train = args.train_utts or 4000
    n_valid = args.valid_utts or 192
    batch = args.batch_size or 32
    stages = [int(s) for s in (args.stage_epochs or "400,200,300").split(",")]
    train, valid, vocab = synthetic.timit_shaped(n_train, n_valid, noise=args.noise,
                                                 seed=args.seed)
    v = vocab.size
    boot = boot_subset(train)

    dims = _dims(args.small)
    mk = dict(input_frame_size=123, output_depth=v, feature_maps=0, filt_size=10, dropout=0.5,
              **dims)
    if args.compute_dtype:
        mk["compute_dtype"] = args.compute_dtype
    model = registry.build("chorowski_dropout", **mk)

    meta = dict(
        device_meta(device),
        model={"name": "chorowski_dropout", **dims, "output_depth": v,
               "compute_dtype": mk.get("compute_dtype", "float32")},
        corpus={"kind": "timit_shaped", "train_utts": n_train, "valid_utts": n_valid,
                "n_phones": 61, "feat_dim": 123, "bootstrap_utts": len(boot),
                "scoring": "61->39 Kaldi fold, beam K=5 (timit.lua:397-415)"},
        host_features=True, seed=args.seed,
        recipe=("adadelta(0.95,1e-8) normalizeNLL colnorm1.0 dropout0.5 beam_k=5; stage3 "
                f"AWN(lambda=1/{n_train},sigma0={args.awn_sigma_init}); length curriculum "
                f"{stages}"))
    print(f"backend={meta['backend']} model={meta['model']} boot={len(boot)} utts", flush=True)
    rows = []
    t0 = time.time()
    sd = lambda tag: os.path.join(args.save_dir, tag) if args.save_dir else None

    tcfg = trainer_lib.TrainConfig(num_epochs=stages[0], batch_size=batch, normalize_nll=True,
                                   beam_k=5, seed=args.seed)
    tr = trainer_lib.Trainer(model, _ocfg(), tcfg, vocab=vocab, save_dir=sd("boot"),
                             device=device)
    tr.init(_init(model, args.seed, init_params))
    # batches staged once, their order reshuffled each epoch
    full_batcher = batching.CachedDeviceBatcher(
        batching.BucketedBatcher.from_dataset(train, batch, n_buckets=3), seed=args.seed,
        device=device)
    if args.awn_only:
        if not args.from_ckpt:
            raise SystemExit("--awn-only needs --from-ckpt")
        blob = checkpoint.load(args.from_ckpt, device=device)
        tr.state = tuple(blob["state"])
        meta["recipe"] += f"; awn-only from {args.from_ckpt} (ep {blob['epoch']})"
        print(f"awn-only: loaded {args.from_ckpt} at epoch {blob['epoch']} best={blob['best']}",
              flush=True)
    else:
        boot_batcher = batching.CachedDeviceBatcher(
            batching.BucketedBatcher.from_dataset(boot, batch, n_buckets=2), seed=args.seed,
            device=device)
        _fit_logged(tr, boot, valid, boot_batcher, max(args.decode_every * 5, 20), rows, t0,
                    meta, args.out, stage="boot")
        # stage 2: the same trainer and weights on the whole corpus. Its
        # save_dir keeps its own log and best-metric checkpoints: the boot
        # stage's best PER must not stop the full stage's from being saved.
        if args.save_dir:
            tr.save_dir = sd("full")
            tr.log = trainer_lib.MetricLog(os.path.join(tr.save_dir, "log.jsonl"))
        tr.best = {"valid_accuracy": -1.0, "valid_per": float("inf")}
        tr.tcfg = dataclasses.replace(tr.tcfg, num_epochs=stages[0] + stages[1])
        _fit_logged(tr, train, valid, full_batcher, args.decode_every, rows, t0, meta, args.out,
                    stage="full")

    # stage 3: adaptive weight noise (lambda ~ 1/N_train, Graves 2011) with
    # dropout still on, from the full stage's evaluation weights
    lam = args.awn_lambda if args.awn_lambda is not None else 1.0 / n_train
    meta["recipe"] += f"; awn lambda={lam:g} sigma0={args.awn_sigma_init}"
    tcfg3 = trainer_lib.TrainConfig(num_epochs=stages[2], batch_size=batch, normalize_nll=True,
                                    beam_k=5, seed=args.seed + 1, noise="awn", awn_lambda=lam,
                                    awn_sigma_init=args.awn_sigma_init)
    tr3 = trainer_lib.Trainer(model, _ocfg(), tcfg3, vocab=vocab, save_dir=sd("awn"),
                              device=device)
    tr3.init(trainer_lib.eval_params(tr.tcfg, tr.state[0]))
    _fit_logged(tr3, train, valid, full_batcher, args.decode_every, rows, t0, meta, args.out,
                stage="awn")
    _summary(rows, t0)
    _export_best(sd("awn"), tr3, tcfg3, device)
    return rows


if __name__ == "__main__":
    main()
