"""Train-mode dropout in the port against the JAX package on the CPU, and
the harness that holds one train step of a regularised recipe to JAX's.

The port draws from a torch.Generator; the JAX package splits a key.
The draws are two module-level functions of the port
(``readout.dropout_keep``, ``awn.normal_like``), so a test can swap in
JAX's own draws, key for key (``JaxDraws``), and hold whole steps to
JAX's numbers.

Tolerances: the readout with JAX's mask rtol 1e-6; one train step's
loss report, nll, grad_norm, param_norm, awn_sigma_rms and penalty rtol
1e-5, the parameters and optimizer state after it rtol 5e-4 (atol 1e-7:
adadelta's first step moves a parameter by ~4.5e-4 whatever its
gradient's size, so a gradient near zero carries the gradients'
2e-4 through undamped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import readout as jreadout
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop, tree
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import readout
from seq2seq_attention_asr_tpu_torch.train import awn, experiment, optim, trainer
from test_torch_train import SMALL, TRAIN_BATCH, _batch

STEP_TOL = dict(metrics=1e-5, state=(5e-4, 1e-7))


class JaxDraws:
    """JAX's draws in place of the port's generator. A JAX train step
    splits its key into (rng, noise_rng, dropout_rng)
    (seq2seq_attention_asr_tpu/train/trainer.py:148); weight noise is one
    normal draw a leaf, in JAX's leaf order, over split(noise_rng, n)
    (awn.py:55-64, :125-127); the readout's dropout mask is
    bernoulli(split(dropout_rng)[1], 1 - rate, shape) (readout.py:95-101).
    Call next_step() before each port step; install() swaps the port's
    draws for these."""

    def __init__(self, seed: int):
        self.rng = jax.random.PRNGKey(seed)

    def next_step(self):
        self.rng, self.noise_rng, self.dropout_rng = jax.random.split(self.rng, 3)

    def normal_like(self, generator, t):
        leaves, treedef = jax.tree.flatten(interop.to_numpy(t))
        keys = jax.random.split(self.noise_rng, len(leaves))
        drawn = jax.tree.unflatten(treedef, [np.asarray(jax.random.normal(k, l.shape, l.dtype))
                                             for k, l in zip(keys, leaves)])
        return tree.tree_map(lambda x, d: torch.from_numpy(np.array(d)).to(x.device), t, drawn)

    def dropout_keep(self, generator, shape, rate, device):
        _, sub = jax.random.split(self.dropout_rng)
        keep = jax.random.bernoulli(sub, 1.0 - rate, tuple(shape))
        return torch.from_numpy(np.array(keep)).to(device)

    def install(self, monkeypatch):
        monkeypatch.setattr(awn, "normal_like", self.normal_like)
        monkeypatch.setattr(readout, "dropout_keep", self.dropout_keep)


def as_port_tree(x):
    """A JAX tree in the port's layout: named tuples (AWNState,
    AdadeltaState) as dicts of their fields, tuples as lists, numpy leaves."""
    if hasattr(x, "_fields"):
        return {k: as_port_tree(v) for k, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: as_port_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_port_tree(v) for v in x]
    return np.asarray(x)


def close_by_path(got, want, rtol, atol, path="root"):
    """A port tree (tensors) against as_port_tree(JAX tree), key by key."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got), set(want))
        for k in want:
            close_by_path(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            close_by_path(g, w, rtol, atol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=path)


def step_parity(monkeypatch, recipe, model_kwargs, train_kwargs, *, seed=1, steps=1):
    """`steps` train steps of recipe(module) (an experiment builder of both
    packages) with model_kwargs and TrainConfig fields train_kwargs, from
    JAX's init of the same weights, JAX's jitted step against the port's
    with JAX's draws: the metrics, the train params and the optimizer
    state after each step. Returns JAX's metrics of the last step."""
    jexp, exp = recipe(jexperiment), recipe(experiment)
    jexp.model_kwargs.update(model_kwargs)
    exp.model_kwargs.update(model_kwargs)
    jtcfg = dataclasses.replace(jexp.train, **train_kwargs)
    tcfg = dataclasses.replace(exp.train, **train_kwargs)
    jmodel, model = jexp.build_model(), exp.build_model()
    params = jax.tree.map(np.asarray, jexp.init_params(jax.random.PRNGKey(0)))
    jinit, jstep = jtrainer.make_train_step(jmodel.forward, joptim.build_optimizer(jexp.optim),
                                            jexp.optim, jtcfg, jmodel.output_depth)
    init_fn, step_fn = trainer.make_train_step(model.forward, optim.build_optimizer(exp.optim),
                                               exp.optim, tcfg, model.output_depth)
    batch = _batch(**TRAIN_BATCH)
    jstate = jinit(params, jax.random.PRNGKey(seed))
    state = init_fn(interop.to_torch(params, "cpu"), torch.Generator().manual_seed(seed))
    draws = JaxDraws(seed)
    draws.install(monkeypatch)
    jstep = jax.jit(jstep)
    for i in range(steps):
        jstate, jm = jstep(jstate, tuple(map(jnp.asarray, batch)))
        draws.next_step()
        state, m = step_fn(state, tuple(map(torch.from_numpy, batch)))
        jm = {k: float(v) for k, v in jm.items()}
        assert set(m) == set(jm)
        for k, w in jm.items():
            np.testing.assert_allclose(float(m[k]), w, rtol=STEP_TOL["metrics"],
                                       err_msg=f"step {i + 1} {k}")
        close_by_path(state[0], as_port_tree(jstate[0]), *STEP_TOL["state"])
        close_by_path(state[1], as_port_tree(jstate[1]), *STEP_TOL["state"])
    return jm


# --- the readout's dropout layer -----------------------------------------------------------

SPECS = (("dropout", 0.5), ("maxout", 8, 3), ("linear", 7))


def _readout_case(seed=0, shape=(3, 5, 12)):
    params = jax.tree.map(np.asarray, jreadout.stack_init(jax.random.PRNGKey(seed), shape[-1],
                                                          SPECS))
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return params, x


def test_dropout_with_jax_mask_matches_jax(monkeypatch):
    """The readout stack in train mode, its mask JAX's: equal to JAX's
    stack_apply with the same key."""
    params, x = _readout_case()
    key = jax.random.PRNGKey(7)
    want = jreadout.stack_apply(params, SPECS, jnp.asarray(x), dropout_rng=key, train=True)
    draws = JaxDraws(0)
    draws.dropout_rng = key
    monkeypatch.setattr(readout, "dropout_keep", draws.dropout_keep)
    got = readout.stack_apply(interop.to_torch(params, "cpu"), SPECS, torch.from_numpy(x),
                              generator=torch.Generator(), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # eval mode: the identity, as JAX's
    got = readout.stack_apply(interop.to_torch(params, "cpu"), SPECS, torch.from_numpy(x))
    want = jreadout.stack_apply(params, SPECS, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_dropout_mask_seed_fraction_and_scale():
    """A seed repeats the mask; about 1 - rate of the values are kept,
    each scaled by 1 / (1 - rate), the others zero."""
    x = torch.randn(64, 768, generator=torch.Generator().manual_seed(0)) + 3.0
    specs = (("dropout", 0.5),)

    def dropped(seed):
        logp = readout.stack_apply([{}], specs, x, generator=torch.Generator().manual_seed(seed),
                                   train=True)
        keep = readout.dropout_keep(torch.Generator().manual_seed(seed), x.shape, 0.5, x.device)
        return logp, keep

    (a, keep), (b, _), (c, _) = dropped(3), dropped(3), dropped(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert abs(float(keep.float().mean()) - 0.5) < 0.01
    want = torch.log_softmax(torch.where(keep, x / 0.5, 0.0), dim=-1)
    torch.testing.assert_close(a, want, rtol=0, atol=0)


def test_dropout_needs_a_generator_in_train_mode():
    x = torch.randn(2, 4)
    with pytest.raises(ValueError):
        readout.stack_apply([{}], (("dropout", 0.5),), x, train=True)
    # rate 0 and eval mode draw nothing
    for specs, train in (((("dropout", 0.0),), True), ((("dropout", 0.5),), False)):
        torch.testing.assert_close(readout.stack_apply([{}], specs, x, train=train),
                                   torch.log_softmax(x, dim=-1), rtol=0, atol=0)


def test_chorowski_dropout_is_the_jax_model():
    """registry.build("chorowski_dropout") and the recipe
    timit_chorowski_dropout give the JAX package's config and readout."""
    jm, m = jregistry.build("chorowski_dropout", **SMALL), registry.build("chorowski_dropout",
                                                                           **SMALL)
    assert m.cfg.dropout == jm.cfg.dropout == 0.5
    assert m.attention_cfg.readout == jm.attention_cfg.readout
    assert registry.build("chorowski_dropout", dropout=0.2).cfg.dropout == 0.2
    jexp, exp = jexperiment.timit_chorowski_dropout(), experiment.timit_chorowski_dropout()
    assert (exp.name, exp.model_kwargs) == (jexp.name, jexp.model_kwargs)
    assert exp.train == trainer.TrainConfig(**{f.name: getattr(jexp.train, f.name)
                                               for f in dataclasses.fields(trainer.TrainConfig)})


def test_chorowski_dropout_train_step_matches_jax(monkeypatch):
    """One train step of the dropout recipe at small widths, JAX's mask
    swapped in: JAX's metrics, parameters and adadelta state."""
    step_parity(monkeypatch, lambda m: m.timit_chorowski_dropout(), SMALL, {})


def test_dropout_step_draws_from_the_state_generator():
    """The step draws its masks from the train state's generator: the same
    generator state gives the same step, another seed another one."""
    exp = experiment.timit_chorowski_dropout()
    exp.model_kwargs.update(SMALL)
    model = exp.build_model()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    init_fn, step_fn = trainer.make_train_step(model.forward, optim.build_optimizer(exp.optim),
                                               exp.optim, exp.train, model.output_depth)
    batch = tuple(map(torch.from_numpy, _batch(**TRAIN_BATCH)))
    runs = [step_fn(init_fn(params, torch.Generator().manual_seed(s)), batch)[1]["loss"]
            for s in (5, 5, 6)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])
