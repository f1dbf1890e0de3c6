"""Optimizer stack: adadelta, global-norm clip, L2, annealed gradient
noise and the column-norm projection (seq2seq_attention_asr_tpu/train/optim.py).

Recipe parity with timit.lua:298-348 and
exp_logmel7_chorowski_normNLL_colnorm.lua:24-41:
  - adadelta(rho=0.95, eps=1e-8) with torch/optim semantics: the
    running E[g^2] first, then the step, then the running E[delta^2]
    (not ``torch.optim.Adadelta``, whose defaults differ);
  - clip: g *= maxnorm/||g|| if ||g|| > maxnorm (timit.lua:298-302);
  - L2: g += wd * theta (timit.lua:305-308);
  - gradient noise: g += N(0, sigma^2), sigma = (eta/(1+t)^gamma)^0.5,
    t counting optimizer steps (timit.lua:311-315);
  - column-norm constraint: after the update, every weight matrix's
    per-output fan-in norm is projected to <= maxval
    (TrainUtils.lua:52-104, timit.lua:346-348).

Each transform is a pair of functions over parameter trees, as optax's
are: ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``; ``chain`` composes them and ``apply_updates`` adds
the updates. The gradient noise keeps a ``torch.Generator`` on the
parameters' device in its state and draws there, so a seed repeats its
noise on one device; it cannot give the JAX package's numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..tree import global_norm, leaves, map_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    rho: float = 0.95
    eps: float = 1e-8
    lr: float = 1.0
    maxnorm: float = 1e20  # grad clip threshold (1e20 = off)
    weight_decay: float = 0.0
    gradnoise_eta: float = 0.0
    gradnoise_gamma: float = 0.55
    colnorm_maxval: float = 1.0
    colnorm: bool = False


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params) -> (updates, state)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return Transform(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def adadelta(rho: float = 0.95, eps: float = 1e-8, lr: float = 1.0) -> Transform:
    """torch/optim adadelta: the updates are -lr * delta."""

    def init(params):
        return {"var": tree_map(torch.zeros_like, params), "acc": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        var = tree_map(lambda v, g: rho * v + (1 - rho) * g * g, state["var"], grads)
        delta = tree_map(lambda a, v, g: torch.sqrt(a + eps) / torch.sqrt(v + eps) * g,
                         state["acc"], var, grads)
        acc = tree_map(lambda a, d: rho * a + (1 - rho) * d * d, state["acc"], delta)
        return tree_map(lambda d: -lr * d, delta), {"var": var, "acc": acc}

    return Transform(init, update)


def clip_by_global_norm_torch(maxnorm: float) -> Transform:
    """g *= maxnorm/||g|| when ||g|| > maxnorm (timit.lua:298-302)."""

    def update(grads, state, params=None):
        norm = global_norm(grads)
        scale = torch.where(norm > maxnorm, maxnorm / (norm + 1e-30), 1.0)
        return tree_map(lambda g: g * scale, grads), state

    return Transform(lambda params: None, update)


def add_weight_decay(wd: float) -> Transform:
    """g += wd * theta (timit.lua:307)."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("weight decay needs the parameters")
        return tree_map(lambda g, p: g + wd * p, grads, params), state

    return Transform(lambda params: None, update)


def gradient_noise(eta: float, gamma: float, seed: int = 0) -> Transform:
    """Annealed Gaussian gradient noise (timit.lua:311-315). The state
    holds the step count and the generator the noise is drawn from."""

    def init(params):
        device = leaves(params)[0].device
        return {"generator": torch.Generator(device=device).manual_seed(seed), "t": 0}

    def update(grads, state, params=None):
        t = state["t"] + 1
        sigma = math.sqrt(eta / (1.0 + t) ** gamma)
        gen = state["generator"]
        noisy = tree_map(
            lambda g: g + sigma * torch.randn(g.shape, generator=gen, dtype=g.dtype, device=g.device),
            grads)
        return noisy, {"generator": gen, "t": t}

    return Transform(init, update)


def build_optimizer(cfg: OptimConfig) -> Transform:
    """Reference order: clip -> L2 -> noise -> adadelta (timit.lua:298-343)."""
    parts = []
    if cfg.maxnorm and cfg.maxnorm < 1e19:
        parts.append(clip_by_global_norm_torch(cfg.maxnorm))
    if cfg.weight_decay > 0:
        parts.append(add_weight_decay(cfg.weight_decay))
    if cfg.gradnoise_eta > 0:
        parts.append(gradient_noise(cfg.gradnoise_eta, cfg.gradnoise_gamma))
    parts.append(adadelta(cfg.rho, cfg.eps, cfg.lr))
    return chain(*parts)


def _is_weight_leaf(path, leaf) -> bool:
    """Weight matrices only. Torch constrains every module's 2-D
    `.weight` and never a bias (TrainUtils.lua:96-103); kernels here are
    (..., fan_in, out), so a leaf with ndim >= 2 whose last dict key does
    not start with 'b' (nor is 'window') is a weight, and so is the 1-D
    energy vector w_e, a (1, scoreDepth) weight in Torch."""
    name = next((k for k in reversed(path) if isinstance(k, str)), "")
    if name.startswith("b") or name == "window":
        return False
    return leaf.ndim >= 2 or name == "w_e"


def colnorm_project(params, maxval: float = 1.0):
    """Project each output unit's fan-in weight norm to <= maxval
    (TrainUtils.lua:63-85): norm = ||w_col|| + 1e-8, and columns with
    norm >= maxval are divided by norm / maxval."""

    def proj(path, w):
        if not _is_weight_leaf(path, w):
            return w
        flat = w.reshape(-1, w.shape[-1]) if w.ndim > 1 else w[:, None]
        norm = torch.linalg.vector_norm(flat, dim=0) + 1e-8
        div = torch.where(norm >= maxval, norm / maxval, 1.0)
        return (flat / div).reshape(w.shape)

    return map_with_path(proj, params)
