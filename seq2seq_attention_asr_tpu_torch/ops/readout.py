"""Readout stacks: linear, maxout, f32 log_softmax
(seq2seq_attention_asr_tpu/ops/readout.py).

Maxout follows the reference (Maxout.lua:14-19): Linear(in -> out*win)
then a max over each consecutive `win`-wide group of outputs. A dropout
layer is the identity in eval mode; in train mode it keeps each value
with probability 1 - rate, drawn by ``dropout_keep`` from the caller's
generator, and scales the kept values by 1 / (1 - rate)
(seq2seq_attention_asr_tpu/ops/readout.py:95-101).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .cells import torch_linear_init

Params = Dict[str, Any]
LayerSpec = Tuple


def linear_init(generator: torch.Generator, dim_in: int, dim_out: int) -> Params:
    w = torch_linear_init(generator, dim_in, (dim_in, dim_out))
    b = torch_linear_init(generator, dim_in, (dim_out,))
    return {"w": w, "b": b}


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def maxout_apply(params: Params, x: torch.Tensor, window: int) -> torch.Tensor:
    y = linear_apply(params, x)
    y = y.reshape(y.shape[:-1] + (y.shape[-1] // window, window))
    return torch.amax(y, dim=-1)


def stack_init(generator: torch.Generator, dim_in: int, specs: Sequence[LayerSpec]) -> List[Params]:
    params: List[Params] = []
    d = dim_in
    for spec in specs:
        kind = spec[0]
        if kind == "linear":
            params.append(linear_init(generator, d, spec[1]))
            d = spec[1]
        elif kind == "maxout":
            params.append(linear_init(generator, d, spec[1] * spec[2]))
            d = spec[1]
        elif kind in ("relu", "dropout"):
            params.append({})
        else:
            raise ValueError(f"unknown readout layer kind: {kind}")
    return params


def dropout_keep(generator: torch.Generator, shape, rate: float, device) -> torch.Tensor:
    """A dropout layer's keep-mask: uniform < 1 - rate, as
    jax.random.bernoulli(key, 1 - rate, shape) draws it. It reads only the
    generator, which lies on `device`."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def stack_apply(params: List[Params], specs: Sequence[LayerSpec], x: torch.Tensor,
                *, generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """Apply the stack, then log_softmax in float32. In train mode a
    dropout layer with rate > 0 draws its mask from `generator` (on x's
    device) and raises ValueError without one."""
    for p, spec in zip(params, specs):
        kind = spec[0]
        if kind == "linear":
            x = linear_apply(p, x)
        elif kind == "maxout":
            x = maxout_apply(p, x, spec[2])
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "dropout" and train and spec[1] > 0.0:
            if generator is None:
                raise ValueError("dropout in train mode needs a generator")
            keep = dropout_keep(generator, x.shape, spec[1], x.device)
            x = torch.where(keep, x / (1.0 - spec[1]), 0.0)
    return torch.log_softmax(x.float(), dim=-1)
