"""Adaptive weight noise, Graves 2011 (seq2seq_attention_asr_tpu/train/awn.py).

Reference: AdaptiveWeightNoise.lua. The learnt state is (mu, s) with
s = log sigma^2 per parameter; a train step samples w = mu + sigma * eps
(:27-38), evaluation uses w = mu (:58-61), and the objective is
L = lambda * KL + NLL, the KL taken against a scalar Gaussian prior
(alpha_mu, alpha_sigma2) recomputed in closed form from the posterior
(:63-80):

    alpha_mu     = mean(mu)
    alpha_sigma2 = max(EPS, mean(sigma^2) + mean((mu - alpha_mu)^2))
    KL = 0.5 * (n * log(alpha_sigma2) - sum(s))
       + 0.5 / alpha_sigma2 * (sum((mu - alpha_mu)^2) + sum(sigma^2)) - n / 2

Gradients (:82-104), from dNLL/dw at the sampled w:

    dL/dmu = lambda * (mu - alpha_mu) / alpha_sigma2 + dNLL/dw
    dL/ds  = lambda / 2 * (sigma^2 / alpha_sigma2 - 1) + 0.5 * (dNLL/dw)^2 * sigma^2

dL/ds is not the reparameterisation gradient: the sample is a leaf of
its own, autograd gives dNLL/dw only, and ``grads`` makes the rest.

The state is a dict {"mu": tree, "s": tree}, each tree shaped like the
model's parameters, so that ``tree``, the optimizer and ``checkpoint``
walk it as they walk parameters. The scalar statistics are float32 sums
over the leaves in ``tree.leaves`` order. ``normal_like`` is the one
draw: a function of the generator and the shapes only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..tree import leaves, tree_map

EPS = 1e-12

AWNState = Dict[str, Any]  # {"mu": params tree, "s": params tree (log sigma^2)}


def init(params, sigma_init: float = 0.075) -> AWNState:
    """mu <- params, s <- log(sigma_init^2) (AdaptiveWeightNoise.lua:40-56)."""
    s0 = torch.log(torch.tensor(sigma_init, dtype=torch.float32) ** 2)
    return {"mu": params, "s": tree_map(lambda p: torch.full_like(p, s0.item()), params)}


def normal_like(generator: torch.Generator, tree: Any) -> Any:
    """Standard normal draws shaped like `tree`'s leaves, in leaf order,
    on the generator's device."""
    return tree_map(lambda t: torch.randn(t.shape, generator=generator, dtype=t.dtype,
                                          device=t.device), tree)


def sample(generator: torch.Generator, state: AWNState) -> Any:
    """w = mu + sigma * eps, fresh eps per call (per train step)."""
    eps = normal_like(generator, state["mu"])
    return tree_map(lambda m, s, e: m + torch.exp(0.5 * s) * e, state["mu"], state["s"], eps)


def mode(state: AWNState) -> Any:
    """The evaluation weights: the posterior mean (AdaptiveWeightNoise.lua:58-61)."""
    return state["mu"]


def _tree_size(tree) -> torch.Tensor:
    return torch.tensor(float(sum(t.numel() for t in leaves(tree))), dtype=torch.float32)


def _tree_sum(tree) -> torch.Tensor:
    return sum(torch.sum(t) for t in leaves(tree))


def prior_stats(state: AWNState) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(alpha_mu, alpha_sigma2, n), 0-d float32 tensors."""
    n = _tree_size(state["mu"]).to(leaves(state["mu"])[0].device)
    alpha_mu = _tree_sum(state["mu"]) / n
    sigma2_sum = _tree_sum(tree_map(torch.exp, state["s"]))
    centered = tree_map(lambda m: (m - alpha_mu) ** 2, state["mu"])
    alpha_sigma2 = torch.clamp(sigma2_sum / n + _tree_sum(centered) / n, min=EPS)
    return alpha_mu, alpha_sigma2, n


def kl(state: AWNState) -> torch.Tensor:
    """The unscaled KL(posterior || adapted prior) (AdaptiveWeightNoise.lua:72-74)."""
    alpha_mu, alpha_sigma2, n = prior_stats(state)
    s_sum = _tree_sum(state["s"])
    sigma2_sum = _tree_sum(tree_map(torch.exp, state["s"]))
    sq_sum = _tree_sum(tree_map(lambda m: (m - alpha_mu) ** 2, state["mu"]))
    return (0.5 * (n * torch.log(alpha_sigma2) - s_sum)
            + 0.5 / alpha_sigma2 * (sq_sum + sigma2_sum) - n / 2.0)


def grads(state: AWNState, grad_w, lam: float) -> AWNState:
    """dNLL/dw at the sampled w -> {"mu": dL/dmu, "s": dL/ds}
    (AdaptiveWeightNoise.lua:82-104), with its lambda <= 0 branch: dL/dmu
    is dNLL/dw and dL/ds its Fisher term alone."""
    sigma2 = tree_map(torch.exp, state["s"])
    d_s_nll = tree_map(lambda g, v: 0.5 * g * g * v, grad_w, sigma2)
    if lam <= 0.0:
        return {"mu": grad_w, "s": d_s_nll}
    alpha_mu, alpha_sigma2, _ = prior_stats(state)
    d_mu = tree_map(lambda m, g: lam * (m - alpha_mu) / alpha_sigma2 + g, state["mu"], grad_w)
    d_s = tree_map(lambda v, dn: lam * 0.5 * (v / alpha_sigma2) - lam * 0.5 + dn, sigma2,
                   d_s_nll)
    return {"mu": d_mu, "s": d_s}


def sigma_rms(state: AWNState) -> torch.Tensor:
    """sqrt(mean(sigma^2)): the rms of the noise a step samples."""
    sig2 = sum(torch.sum(torch.exp(t)) for t in leaves(state["s"]))
    return torch.sqrt(sig2 / sum(t.numel() for t in leaves(state["s"])))


# --- fixed-sigma weight noise (WeightNoise.lua) ------------------------------


def weight_noise_sample(generator: torch.Generator, params, sigma: float):
    """w = theta + sigma * eps (WeightNoise.lua:17-22); the gradient at w
    is applied to theta."""
    eps = normal_like(generator, params)
    return tree_map(lambda p, e: p + sigma * e, params, eps)
