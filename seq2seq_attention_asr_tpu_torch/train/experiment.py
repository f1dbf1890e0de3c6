"""Experiment configs (seq2seq_attention_asr_tpu/train/experiment.py): a
model choice with its kwargs, a TrainConfig and an OptimConfig, and the
initialization the recipe asks for. The port has the canonical TIMIT
recipe and the conv+BiLSTM TIMIT recipe, both served and trained, also
with the attention's location term switched on or off through
``exp.model_kwargs["feature_maps"]``; the others come with their model
families."""

from __future__ import annotations

import dataclasses
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
    init_std: Optional[float] = None  # autoencoder:reset(std)
    orthogonalize: bool = True  # TrainUtils.orthogonalizeGraph

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


def timit_chorowski_normnll_colnorm() -> Experiment:
    """The canonical TIMIT recipe (exp_logmel7_chorowski_normNLL_colnorm.lua:
    24-41): adadelta(0.95, 1e-8), normalized NLL, column-norm constraint
    maxval 1, clip off, orthogonal init, no weight or gradient noise. The
    recipe's batch 16, 100 epochs and beam K=5 belong to the trainer loop
    and the eval beam, which are not ported yet."""
    return Experiment(
        name="exp_logmel7_chorowski_normNLL_colnorm",
        model="chorowski",
        model_kwargs=dict(
            input_frame_size=123, hidden_frame_size=256, output_frame_size=256,
            score_depth=512, state_depth=256, mlp_depth=64, output_depth=62,
            feature_maps=0, filt_size=10, mono_align=True,
        ),
        train=TrainConfig(normalize_nll=True),
        optim=OptimConfig(rho=0.95, eps=1e-8, maxnorm=1e20, weight_decay=0.0,
                          gradnoise_eta=0.0, colnorm=True, colnorm_maxval=1.0),
        orthogonalize=True,
    )


def timit_conv_bilstm() -> Experiment:
    """The reference's inline TIMIT conv+BiLSTM model (timit/timit.lua:
    98-169): 3 x (conv k=3 + ReLU + maxpool 2), an 8x downsampling of
    time, BiLSTM(256, 128), location-aware attention (16 feature maps,
    filter 5) with an LSTM decoder of state 400; adadelta(0.95, 1e-8),
    normalized NLL, orthogonal init. The port serves and trains this
    model. The recipe's batch 16, 100 epochs and beam K=5 belong to the
    trainer loop and the eval beam, which are not ported yet."""
    return Experiment(
        name="exp_timit_conv_bilstm",
        model="conv_bilstm",
        model_kwargs=dict(
            input_frame_size=123, hidden_frame_size=256, output_frame_size=128,
            kw=3, score_depth=150, filt_size=5, feature_maps=16,
            state_depth=400, output_depth=62,
        ),
        train=TrainConfig(normalize_nll=True),
        optim=OptimConfig(rho=0.95, eps=1e-8, maxnorm=1e20),
        orthogonalize=True,
    )
