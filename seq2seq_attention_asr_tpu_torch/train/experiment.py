"""Experiment configs and the training entry point
(seq2seq_attention_asr_tpu/train/experiment.py): a model choice with its
kwargs, a TrainConfig and an OptimConfig, the initialization the recipe
asks for, where its data and run directory are, and `run_cli`, the
command line of the recipe scripts. The port has every recipe of the
JAX package: the canonical TIMIT recipe, its dropout variant, the
conv+BiLSTM TIMIT recipe (both families also with the attention's
location term switched on or off through
``exp.model_kwargs["feature_maps"]``), the three LibriSpeech recipes
(character and word Chorowski, VGG; trained from a chunked data
directory by the out-of-core epoch) and the scriptchecker smoke recipe.
Adaptive or fixed weight noise is a TrainConfig field (``noise``) of any
recipe."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from .. import interop
from . import initializers
from .optim import OptimConfig
from .trainer import TrainConfig


@dataclasses.dataclass
class Experiment:
    name: str
    model: str = "chorowski"  # registry name
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data_path: Optional[str] = None  # the directory of train.h5 and valid.h5
    save_dir: Optional[str] = None
    init_std: Optional[float] = None  # autoencoder:reset(std)
    orthogonalize: bool = True  # TrainUtils.orthogonalizeGraph
    optim_resets: Dict[int, OptimConfig] = dataclasses.field(default_factory=dict)

    def build_model(self):
        from ..models import registry

        return registry.build(self.model, **self.model_kwargs)

    def init_params(self, generator: torch.Generator, device="cuda"):
        """The model's random init, then the recipe's Gaussian reset and
        QR orthogonalization, all drawn and computed on the CPU from
        `generator`, then moved to `device` (the card unless asked for
        the CPU): a seed gives the same weights on any device."""
        params = self.build_model().init(generator, device="cpu")
        if self.init_std is not None:
            params = initializers.gaussian_reset(generator, params, self.init_std)
        if self.orthogonalize:
            params = initializers.orthogonalize_params(params)
        return interop.to_torch(params, device)

    def archive(self, source_file: Optional[str] = None) -> None:
        """Copy the defining config source and a JSON dump into save_dir."""
        if not self.save_dir:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        if source_file and os.path.exists(source_file):
            shutil.copy(source_file, self.save_dir)
        with open(os.path.join(self.save_dir, "experiment.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)


def timit_chorowski_normnll_colnorm(data_path: Optional[str] = None,
                                    save_dir: Optional[str] = None) -> Experiment:
    """The canonical TIMIT recipe (exp_logmel7_chorowski_normNLL_colnorm.lua:
    24-41): adadelta(0.95, 1e-8), normalized NLL, column-norm constraint
    maxval 1, clip off, orthogonal init, no weight or gradient noise,
    batch 16, 100 epochs, beam K=5 for the valid PER (the reference runs
    batch size 1)."""
    return Experiment(
        name="exp_logmel7_chorowski_normNLL_colnorm",
        model="chorowski",
        model_kwargs=dict(
            input_frame_size=123, hidden_frame_size=256, output_frame_size=256,
            score_depth=512, state_depth=256, mlp_depth=64, output_depth=62,
            feature_maps=0, filt_size=10, mono_align=True,
        ),
        train=TrainConfig(num_epochs=100, batch_size=16, normalize_nll=True, beam_k=5),
        optim=OptimConfig(rho=0.95, eps=1e-8, maxnorm=1e20, weight_decay=0.0,
                          gradnoise_eta=0.0, colnorm=True, colnorm_maxval=1.0),
        data_path=data_path,
        save_dir=save_dir,
        orthogonalize=True,
    )


def timit_chorowski_dropout(**kw) -> Experiment:
    """model_chorowski_baseline_dropout.lua: the canonical recipe with
    dropout 0.5 at the readout's input."""
    exp = timit_chorowski_normnll_colnorm(**kw)
    exp.name = "exp_chorowski_dropout"
    exp.model_kwargs["dropout"] = 0.5
    return exp


def librispeech_chorowski(num_chars: int, data_path: Optional[str] = None,
                          save_dir: Optional[str] = None) -> Experiment:
    """librispeech/model_chorowski_baseline.lua: the canonical recipe's
    architecture with num_chars outputs, CER evaluation with a beam of up
    to 2 L steps (eval_len_factor 2, librispeech/train.lua:251-252)."""
    exp = timit_chorowski_normnll_colnorm(data_path=data_path, save_dir=save_dir)
    exp.name = "exp_librispeech_chorowski"
    exp.model_kwargs["output_depth"] = num_chars
    exp.train = dataclasses.replace(exp.train, eval_len_factor=2.0)
    return exp


def librispeech_chorowski_words(num_words: int, data_path: Optional[str] = None,
                                save_dir: Optional[str] = None) -> Experiment:
    """The word-target LibriSpeech recipe (opt.labelset = 'words',
    librispeech/train.lua:28, utils_librispeech.lua:49-66): the character
    recipe with the output layer sized to the word vocabulary, scored by
    WER (the edit distance over word ids)."""
    exp = librispeech_chorowski(num_chars=num_words, data_path=data_path, save_dir=save_dir)
    exp.name = "exp_librispeech_chorowski_words"
    return exp


def timit_conv_bilstm(data_path: Optional[str] = None,
                      save_dir: Optional[str] = None) -> Experiment:
    """The reference's inline TIMIT conv+BiLSTM model (timit/timit.lua:
    98-169): 3 x (conv k=3 + ReLU + maxpool 2), an 8x downsampling of
    time, BiLSTM(256, 128), location-aware attention (16 feature maps,
    filter 5) with an LSTM decoder of state 400; adadelta(0.95, 1e-8),
    normalized NLL, orthogonal init, batch 16, 100 epochs, beam K=5."""
    return Experiment(
        name="exp_timit_conv_bilstm",
        model="conv_bilstm",
        model_kwargs=dict(
            input_frame_size=123, hidden_frame_size=256, output_frame_size=128,
            kw=3, score_depth=150, filt_size=5, feature_maps=16,
            state_depth=400, output_depth=62,
        ),
        train=TrainConfig(num_epochs=100, batch_size=16, normalize_nll=True, beam_k=5),
        optim=OptimConfig(rho=0.95, eps=1e-8, maxnorm=1e20),
        data_path=data_path,
        save_dir=save_dir,
        orthogonalize=True,
    )


def librispeech_vgg(num_chars: int, data_path: Optional[str] = None,
                    save_dir: Optional[str] = None) -> Experiment:
    """librispeech/model_vgg.lua: the VGG conv encoder on 3-channel stacked
    log-mel (40 bins), annotations of 512 (:63), the two-layer maxout
    readout (:74-82); adadelta(0.95, 1e-8) with the column-norm
    constraint, normalized NLL, orthogonal init, batch 16, 100 epochs,
    beam K=5 over up to 2 L steps."""
    return Experiment(
        name="exp_librispeech_vgg",
        model="vgg",
        model_kwargs=dict(
            input_frame_size=40, output_frame_size=512, score_depth=512, filt_size=10,
            feature_maps=0, state_depth=256, mlp_depth=64, output_depth=num_chars,
        ),
        train=TrainConfig(num_epochs=100, batch_size=16, normalize_nll=True, beam_k=5,
                          eval_len_factor=2.0),
        optim=OptimConfig(rho=0.95, eps=1e-8, colnorm=True, colnorm_maxval=1.0),
        data_path=data_path,
        save_dir=save_dir,
        orthogonalize=True,
    )


def scriptchecker(save_dir: Optional[str] = None) -> Experiment:
    """exp0_scriptchecker.lua: the tiny end-to-end smoke config (3
    samples, a small model, Gaussian then orthogonal init)."""
    return Experiment(
        name="exp0_scriptchecker",
        model="chorowski",
        model_kwargs=dict(
            input_frame_size=123, hidden_frame_size=32, output_frame_size=32,
            score_depth=32, state_depth=32, mlp_depth=16, output_depth=30,
            feature_maps=0, filt_size=10,
        ),
        train=TrainConfig(num_epochs=2, batch_size=2, normalize_nll=True, beam_k=3,
                          max_samples=3, eval_len_factor=2.0),
        optim=OptimConfig(colnorm=True),
        save_dir=save_dir,
        init_std=0.01,
        orthogonalize=True,
    )


def run_cli(make_experiment, dataset: str, argv=None, source_file: Optional[str] = None):
    """The command line of the recipe scripts (configs/exp_*.py and
    tools/train.py of the JAX package): the reference's
    `dofile(modelfile); dofile(trainfile)` bottom half
    (exp_logmel7_chorowski_normNLL_colnorm.lua:42-50).

    dataset: "timit" or "scriptchecker" (train.h5 and valid.h5 under
    --data), or "librispeech" (the chunked directory of the JAX package's
    tools/preprocess_librispeech.py: meta.txt, the train.db manifest of
    train chunks, valid.h5). make_experiment is called with data_path=...
    and save_dir=... ("timit"), save_dir=... ("scriptchecker"), or the
    output depth first ("librispeech": meta.txt's numwords where its
    labelset_words is set, else numchars). LibriSpeech trains on one
    chunk at a time in a shuffled order each epoch (Trainer.fit's
    chunked epoch), or in memory when there is a single chunk. The run is
    on the card unless --cpu is given. Returns the Trainer after its last
    epoch."""
    import argparse

    from ..data import batching
    from ..data import librispeech as ls
    from ..data import timit as timit_data
    from .trainer import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--save", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--decode-every", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--dp", type=int, default=0, help="not ported (ROADMAP Queue A item 9)")
    ap.add_argument("--sp", type=int, default=1, help="not ported (ROADMAP Queue A item 9)")
    args = ap.parse_args(argv)
    if args.dp or args.sp > 1:
        raise NotImplementedError("--dp and --sp (the mesh trainer) are not ported yet "
                                  "(ROADMAP Queue A item 9)")
    device = "cpu" if args.cpu else "cuda"

    vocab = None
    chunked = None
    if dataset == "timit":
        exp = make_experiment(data_path=args.data, save_dir=args.save)
        train_ds = timit_data.load_hdf5(os.path.join(args.data, "train.h5"))
        valid_ds = timit_data.load_hdf5(os.path.join(args.data, "valid.h5"))
        vocab = timit_data.Vocab.standard()
    elif dataset == "scriptchecker":
        exp = make_experiment(save_dir=args.save)
        train_ds = timit_data.load_hdf5(os.path.join(args.data, "train.h5"))
        valid_ds = timit_data.load_hdf5(os.path.join(args.data, "valid.h5"))
        # the output layer covers the data's label space (an out-of-range
        # id would one-hot to a zero row)
        vmax = int(max(int(y.max()) for y in train_ds.y + valid_ds.y)) + 1
        exp.model_kwargs["output_depth"] = max(exp.model_kwargs.get("output_depth", 0), vmax)
        if train_ds.y39 is not None:
            vocab = timit_data.Vocab.standard()
    elif dataset == "librispeech":
        meta = ls.load_meta(args.data)
        # the output depth follows the labelset the chunks were built with
        # (meta.txt numchars or numwords, utils_librispeech.lua:38-46)
        exp = make_experiment(meta["numwords"] if meta.get("labelset_words", 0)
                              else meta["numchars"], data_path=args.data, save_dir=args.save)
        # Out of core: one chunk resident at a time, in a shuffled order
        # each epoch (librispeech/train.lua:82-103).
        chunk_paths = ls.load_manifest(args.data)
        load_chunk = lambda i: timit_data.load_hdf5(chunk_paths[i])
        train_ds = load_chunk(0)  # the frame size, and a single chunk's training set
        if len(chunk_paths) > 1:
            chunked = (load_chunk, len(chunk_paths),
                       lambda ds: batching.BucketedBatcher.from_dataset(
                           ds, batch_size=exp.train.batch_size))
        valid_ds = timit_data.load_hdf5(os.path.join(args.data, "valid.h5"))
    else:
        raise ValueError(dataset)

    if args.epochs:
        exp.train = dataclasses.replace(exp.train, num_epochs=args.epochs)
    if args.batch_size:
        exp.train = dataclasses.replace(exp.train, batch_size=args.batch_size)
    if args.max_samples:
        exp.train = dataclasses.replace(exp.train, max_samples=args.max_samples)
    # the frame size: the last axis of flat (L, D) features, the frequency
    # axis of channel-stacked (L, freq, C) ones (the VGG recipe's NHWC input)
    x0 = train_ds.x[0]
    exp.model_kwargs["input_frame_size"] = int(x0.shape[-2] if x0.ndim == 3 else x0.shape[-1])
    exp.archive(source_file)

    params = exp.init_params(torch.Generator().manual_seed(exp.train.seed), device=device)
    tr = Trainer(exp.build_model(), exp.optim, exp.train, vocab=vocab, save_dir=exp.save_dir,
                 optim_resets=exp.optim_resets, device=device)
    tr.init(params)
    batcher = batching.BucketedBatcher.from_dataset(train_ds, batch_size=exp.train.batch_size)
    keys = ("epoch", "train_nll", "train_accuracy", "valid_nll", "valid_accuracy", "valid_per",
            "train_seconds", "train_samples_per_s")
    for row in tr.fit(train_ds, valid_ds, batcher, resume=args.resume,
                      decode_every=args.decode_every, chunked=chunked):
        print("  ".join(f"{k}={row[k]:.4f}" if isinstance(row.get(k), float)
                        else f"{k}={row.get(k)}" for k in keys if k in row), flush=True)
    return tr
