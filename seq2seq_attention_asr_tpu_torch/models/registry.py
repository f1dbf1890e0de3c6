"""Model facade (seq2seq_attention_asr_tpu/models/registry.py), for the
three families:

  init(generator, device) -> params
  forward(params, x, x_len, labels_onehot, dec_mask, *, generator, train)
      -> dict(logprobs, alpha, penalty)
  encode(params, x, x_len) -> (annotations, annotation_lengths)
  attention_cfg  (for decoding)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import chorowski, conv_bilstm, vgg


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    cfg: Any
    init: Callable
    forward: Callable
    encode: Callable
    attention_cfg: Any

    @property
    def output_depth(self) -> int:
        return self.cfg.output_depth


def build(name: str, **overrides) -> Model:
    """name: chorowski | chorowski_dropout | conv_bilstm | vgg. Overrides
    are fields of the family's config dataclass (e.g. output_depth=30 for
    a LibriSpeech character vocabulary); chorowski_dropout is chorowski
    with dropout defaulting to 0.5 (model_chorowski_baseline_dropout.lua)."""
    if name == "chorowski_dropout":
        overrides.setdefault("dropout", 0.5)
        name = "chorowski"
    if name == "chorowski":
        cfg = chorowski.ChorowskiConfig(**overrides)
        return Model(
            name=name,
            cfg=cfg,
            init=lambda generator, device="cuda": chorowski.init(cfg, generator, device),
            forward=lambda p, x, xl, oh, dm, **kw: chorowski.forward(p, cfg, x, xl, oh, dm, **kw),
            encode=lambda p, x, xl: (chorowski.encode(p, cfg, x, xl), xl),
            attention_cfg=cfg.attention_config(),
        )
    if name == "conv_bilstm":
        cfg = conv_bilstm.ConvBiLSTMConfig(**overrides)
        return Model(
            name=name,
            cfg=cfg,
            init=lambda generator, device="cuda": conv_bilstm.init(cfg, generator, device),
            forward=lambda p, x, xl, oh, dm, **kw: conv_bilstm.forward(p, cfg, x, xl, oh, dm,
                                                                       **kw),
            encode=lambda p, x, xl: conv_bilstm.encode(p, cfg, x, xl),
            attention_cfg=cfg.attention_config(),
        )
    if name == "vgg":
        cfg = vgg.VGGConfig(**overrides)
        return Model(
            name=name,
            cfg=cfg,
            init=lambda generator, device="cuda": vgg.init(cfg, generator, device),
            forward=lambda p, x, xl, oh, dm, **kw: vgg.forward(p, cfg, x, xl, oh, dm, **kw),
            encode=lambda p, x, xl: vgg.encode(p, cfg, x, xl),
            attention_cfg=cfg.attention_config(),
        )
    raise ValueError(f"unknown model {name!r}")
