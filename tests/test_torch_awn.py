"""Adaptive weight noise and fixed weight noise in the port: against an
independent numpy version of the reference's formulas
(AdaptiveWeightNoise.lua:63-104, the twins of tests/test_awn.py), against
the JAX package's train/awn.py on the same trees, on the committed
checkpoint, and through one whole train step with JAX's draws.

Tolerances: the formulas as tests/test_awn.py holds JAX (KL rtol 1e-5,
gradients rtol 1e-4, atol 1e-5); the port against JAX's awn functions on
one tree rtol 1e-6 (float32 sums over the leaves in another order); a
train step as tests/test_torch_dropout.py states.

The committed checkpoint's lambda * KL at the AWN stage's start (sigma0
0.01, lambda 7.8125e-7, tools/convergence.py:511-527) is pinned in
chip_smoke.py, which holds the card to it: the float64 value within
1e-5, and the JAX package's float32 value, whose own sums of 4.36 M
equal log sigma^2 drift 1.2e-5 from the float64 value, within 2e-5.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.train import awn as jawn
from seq2seq_attention_asr_tpu.train import checkpoint as jcheckpoint
from seq2seq_attention_asr_tpu_torch import interop, tree
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.train import awn, checkpoint, optim, trainer
from test_torch_dropout import SMALL, JaxDraws, as_port_tree, close_by_path, step_parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "runs" / "timit_shape_ckpt" / "full" / "ckpt_best_valid_PER"
NPZ = CKPT.parent / "params.npz"


def _flat_ref(mu, s, lam, grad_w):
    """The reference on flat float64 vectors (AdaptiveWeightNoise.lua)."""
    mu = np.asarray(mu, np.float64)
    s = np.asarray(s, np.float64)
    n = mu.size
    sigma2 = np.exp(s)
    alpha_mu = mu.mean()
    alpha_sigma2 = max(1e-12, sigma2.mean() + ((mu - alpha_mu) ** 2).mean())
    kl = (0.5 * (n * np.log(alpha_sigma2) - s.sum())
          + 0.5 / alpha_sigma2 * (((mu - alpha_mu) ** 2).sum() + sigma2.sum()) - n / 2.0)
    g = np.asarray(grad_w, np.float64)
    d_mu = lam * (mu - alpha_mu) / alpha_sigma2 + g
    d_s = lam * 0.5 * (sigma2 / alpha_sigma2 - 1.0) + 0.5 * g * g * sigma2
    return kl, d_mu, d_s


def _tree():
    rng = np.random.RandomState(0)
    return {"a": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
            "b": {"w": torch.from_numpy(rng.randn(5).astype(np.float32))}}


def _flatten(t):
    return np.concatenate([np.ravel(l.numpy()) for l in tree.leaves(t)])


def test_kl_matches_reference_formula():
    state = awn.init(_tree(), sigma_init=0.1)
    want, _, _ = _flat_ref(_flatten(state["mu"]), _flatten(state["s"]), 1.0, 0.0)
    assert float(awn.kl(state)) == pytest.approx(want, rel=1e-5)


def test_grads_match_reference_formula():
    params = _tree()
    state = awn.init(params, sigma_init=0.2)
    rng = np.random.RandomState(1)
    grad_w = tree.tree_map(lambda p: torch.from_numpy(rng.randn(*p.shape).astype(np.float32)),
                           params)
    out = awn.grads(state, grad_w, 0.7)
    _, d_mu, d_s = _flat_ref(_flatten(state["mu"]), _flatten(state["s"]), 0.7, _flatten(grad_w))
    np.testing.assert_allclose(_flatten(out["mu"]), d_mu, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_flatten(out["s"]), d_s, rtol=1e-4, atol=1e-5)


def test_grads_lambda_zero_passthrough():
    """lambda == 0: d_mu = dNLL/dw, d_s = 0.5 g^2 sigma^2 (the :96-103
    else-branch of AdaptiveWeightNoise.lua)."""
    params = _tree()
    state = awn.init(params, sigma_init=0.3)
    grad_w = tree.tree_map(torch.ones_like, params)
    out = awn.grads(state, grad_w, 0.0)
    np.testing.assert_allclose(_flatten(out["mu"]), _flatten(grad_w))
    np.testing.assert_allclose(_flatten(out["s"]), 0.5 * np.exp(_flatten(state["s"])), rtol=1e-5)


def test_sample_statistics_and_mode():
    state = awn.init({"w": torch.zeros(2000)}, sigma_init=0.5)
    w = awn.sample(torch.Generator().manual_seed(0), state)
    assert float(torch.std(w["w"])) == pytest.approx(0.5, rel=0.1)
    assert float(torch.max(torch.abs(awn.mode(state)["w"]))) == 0.0
    torch.testing.assert_close(awn.sigma_rms(state), torch.tensor(0.5), rtol=1e-6, atol=0)


def test_weight_noise_sample():
    w = awn.weight_noise_sample(torch.Generator().manual_seed(0), {"w": torch.zeros(2000)}, 0.25)
    assert float(torch.std(w["w"])) == pytest.approx(0.25, rel=0.1)


def test_awn_train_step_learns():
    """100 train steps with noise="awn": the NLL at the posterior mean
    falls and the posterior stays finite."""
    model = registry.build("chorowski", input_frame_size=6, hidden_frame_size=8,
                           output_frame_size=8, score_depth=12, state_depth=8, mlp_depth=8,
                           output_depth=5, feature_maps=0, filt_size=5)
    tcfg = trainer.TrainConfig(normalize_nll=True, noise="awn", awn_lambda=0.01,
                               awn_sigma_init=0.05)
    ocfg = optim.OptimConfig()
    init_fn, step_fn = trainer.make_train_step(model.forward, optim.build_optimizer(ocfg), ocfg,
                                               tcfg, model.output_depth)
    rng = np.random.RandomState(2)
    b, l, t = 2, 10, 5
    x = torch.from_numpy(rng.randn(b, l, 6).astype(np.float32))
    x_len = torch.tensor([10, 7])
    y = torch.from_numpy(rng.randint(0, 5, (b, t)))
    dec_mask = torch.ones(b, t)
    state = init_fn(model.init(torch.Generator().manual_seed(0), device="cpu"),
                    torch.Generator().manual_seed(1))
    assert set(state[0]) == {"mu", "s"}

    def mode_nll(st):
        onehot = torch.nn.functional.one_hot(y, model.output_depth).float()
        out = model.forward(awn.mode(st[0]), x, x_len, onehot, dec_mask, train=False)
        return float(-torch.sum(onehot * out["logprobs"]) / torch.sum(dec_mask))

    before = mode_nll(state)
    nlls = []
    for _ in range(100):
        state, m = step_fn(state, (x, x_len, y, dec_mask))
        nlls.append(float(m["nll"]))
    assert np.isfinite(nlls).all()
    assert all(torch.isfinite(t).all() for t in tree.leaves(state[0]))
    assert mode_nll(state) < before - 0.01


def test_awn_functions_match_jax(monkeypatch):
    """init, kl, prior_stats, grads, sample with JAX's noise, and the
    weight-noise sample, on one tree of the port and the JAX package."""
    rng = np.random.RandomState(3)
    params = {"enc": {"w": rng.randn(6, 5), "b": rng.randn(5)}, "dec": [rng.randn(3, 4), {}]}
    params = jax.tree.map(lambda a: np.asarray(a * 0.3, np.float32), params)
    grad_w = jax.tree.map(lambda a: np.asarray(rng.randn(*a.shape), np.float32), params)
    jstate = jawn.init(params, 0.2)
    state = awn.init(interop.to_torch(params, "cpu"), 0.2)
    close_by_path(state, as_port_tree(jstate), 0, 0)
    for got, want in zip(awn.prior_stats(state), jawn.prior_stats(jstate)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(awn.kl(state)), float(jawn.kl(jstate)), rtol=1e-6)
    for lam in (0.0, 0.7):
        close_by_path(awn.grads(state, interop.to_torch(grad_w, "cpu"), lam),
                      as_port_tree(jawn.grads(jstate, grad_w, lam)), 1e-6, 1e-7)
    draws = JaxDraws(0)
    draws.next_step()
    monkeypatch.setattr(awn, "normal_like", draws.normal_like)
    close_by_path(awn.sample(None, state), as_port_tree(jawn.sample(draws.noise_rng, jstate)),
                  1e-6, 1e-7)
    close_by_path(awn.weight_noise_sample(None, state["mu"], 0.3),
                  as_port_tree(jawn.weight_noise_sample(draws.noise_rng, params, 0.3)), 1e-6, 1e-7)


def test_kl_of_the_committed_checkpoint():
    """The AWN stage's start (params.npz, sigma0 0.01, lambda 7.8125e-7):
    the port's lambda * KL on the CPU against the float64 formula and the
    JAX package's float32 awn.kl, both pinned in chip_smoke.py for the
    card."""
    import chip_smoke

    lam, sigma0 = chip_smoke.AWN_LAMBDA, chip_smoke.AWN_SIGMA0
    params = jax.tree.map(np.asarray, jcheckpoint.load(str(CKPT))["state"][0])
    want_jax = lam * float(jawn.kl(jawn.init(params, sigma0)))
    s0 = float(jnp.log(jnp.asarray(sigma0, jnp.float32) ** 2))
    mu = np.concatenate([np.ravel(l) for l in jax.tree.leaves(params)])
    want_f64 = lam * _flat_ref(mu, np.full(mu.size, s0), lam, 0.0)[0]
    got = lam * float(awn.kl(awn.init(checkpoint.load_params_npz(str(NPZ), "cpu"), sigma0)))
    assert want_f64 == pytest.approx(chip_smoke.AWN_LAMBDA_KL_F64, rel=1e-12)
    assert want_jax == pytest.approx(chip_smoke.AWN_LAMBDA_KL_JAX, rel=1e-6)
    assert got == pytest.approx(want_f64, rel=1e-5)
    assert got == pytest.approx(want_jax, rel=2e-5)


@pytest.mark.parametrize("case", ["awn", "weight"])
def test_noise_train_step_matches_jax(monkeypatch, case):
    """One train step with JAX's draws: AWN (lambda 0.01, sigma0 0.05) on
    the dropout recipe, its noise and then its mask drawn; fixed weight
    noise (sigma 0.05) on the canonical recipe. The metrics, the (mu, s)
    or parameter tree, and adadelta's state over it."""
    if case == "awn":
        m = step_parity(monkeypatch, lambda mod: mod.timit_chorowski_dropout(), SMALL,
                        dict(noise="awn", awn_lambda=0.01, awn_sigma_init=0.05))
        assert m["loss"] > m["nll"] and "awn_sigma_rms" in m
    else:
        step_parity(monkeypatch, lambda mod: mod.timit_chorowski_normnll_colnorm(), SMALL,
                    dict(noise="weight", weight_noise_sigma=0.05))


def test_noise_is_checked():
    with pytest.raises(ValueError):
        trainer.make_train_step(None, optim.build_optimizer(optim.OptimConfig()),
                                optim.OptimConfig(), trainer.TrainConfig(noise="gauss"), 7)
