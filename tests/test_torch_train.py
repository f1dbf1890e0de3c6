"""The port's training path against the JAX package on the CPU, at small
widths, on the same numpy inputs and weights (moved with ``interop``).

Tolerances:
  - decode_teacher_forced and chorowski.forward: logprobs and alpha rtol
    1e-4 (atol 1e-5), gradients of nll + 0.1 * sum(alpha^2) rtol 2e-4
    (atol 2e-5), as tests/test_pallas.py:183-202 holds the JAX kernel to
    the XLA scan;
  - loss functions: rtol 1e-6; optimizer chain, column-norm projection
    and orthogonalization: within 1e-6;
  - 20 train steps of the recipe from the same weights: loss, nll,
    grad_norm and param_norm rtol 1e-5 at step 1 and 1e-3 at every step
    (float32 sums in another order, fed back through adadelta).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seq2seq_attention_asr_tpu.models import chorowski as jchorowski
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu.train import initializers as jinit
from seq2seq_attention_asr_tpu.train import loss as jloss
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.models import chorowski, registry
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.train import experiment, initializers, loss, optim, trainer

SMALL = dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=16, score_depth=16,
             state_depth=16, mlp_depth=8, output_depth=7)


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def close_trees(got, want, rtol, atol):
    """Leaf by leaf, in the JAX package's (sorted-key) leaf order."""
    got = jax.tree.map(np.asarray, interop.to_numpy(got))
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for path, g, w in zip(paths, jax.tree.leaves(got), jax.tree.leaves(want)):
        close(g, w, rtol, atol, path)


def _batch(b, l, t, v, seed, lens, label_lens, feat=None):
    """(x, x_len, y, dec_mask) as numpy, ragged in both lengths."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, feat).astype(np.float32) if feat else None
    y = rng.randint(0, v, (b, t)).astype(np.int32)
    dm = (np.arange(t)[None] < np.asarray(label_lens)[:, None]).astype(np.float32)
    return x, np.asarray(lens, np.int32), y, dm


# --- decode_teacher_forced and chorowski.forward -------------------------------------------

B, L, T = 8, 16, 7
ENC_LENS = [16, 11, 5, 16, 1, 9, 13, 16]
LABEL_LENS = [7, 3, 7, 1, 5, 7, 2, 6]


def _objective(out, oh, dm):
    nll = -(oh * out["logprobs"] * dm[..., None]).sum()
    return nll + 0.1 * (out["alpha"] ** 2).sum()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_decode_teacher_forced_matches_jax(backend):
    """JAX's "pallas" backend here is its fused scan kernel in interpret
    mode (B = 8 and L = 16 pass its supported() gate)."""
    readout = (("maxout", 8, 3), ("linear", 7))
    jcfg = jatt.AttentionConfig(score_depth=16, filt_size=10, feature_maps=0, state_depth=16,
                                annotation_depth=24, output_depth=7, readout=readout)
    cfg = attention.AttentionConfig(score_depth=16, state_depth=16, annotation_depth=24,
                                    output_depth=7, readout=readout)
    params = jatt.attention_init(jax.random.PRNGKey(0), jcfg)
    _, lens, y, dm = _batch(B, L, T, 7, 1, ENC_LENS, LABEL_LENS)
    h = (np.random.RandomState(2).randn(B, L, 24) * 0.5).astype(np.float32)
    oh = np.eye(7, dtype=np.float32)[y] * dm[..., None]

    def jloss_fn(p, hh):
        out = jatt.decode_teacher_forced(p, jcfg, hh, jnp.asarray(lens), jnp.asarray(oh),
                                         jnp.asarray(dm), backend=backend)
        return _objective(out, oh, dm), out

    (_, want), (wgp, wgh) = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(h))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), port(params))
    th = torch.from_numpy(h).requires_grad_(True)
    got = attention.decode_teacher_forced(tp, cfg, th, torch.from_numpy(lens),
                                          torch.from_numpy(oh), torch.from_numpy(dm), train=True)
    for key in ("logprobs", "alpha", "penalty"):
        close(got[key].detach(), want[key], 1e-4, 1e-5, key)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                leaves + [th])
    close(grads[-1], wgh, 2e-4, 2e-5, "h")
    close_trees(jax.tree.unflatten(jax.tree.structure(tp), grads[:-1]), wgp, 2e-4, 2e-5)


def test_chorowski_forward_matches_jax():
    """The whole model, with the JAX package's BiGRU and decoder-scan
    kernels (interpret mode) as the reference."""
    jcfg = jchorowski.ChorowskiConfig(**SMALL, rnn_backend="pallas", attn_backend="pallas")
    params = jchorowski.init(jax.random.PRNGKey(3), jcfg)
    x, lens, y, dm = _batch(B, L, T, 7, 4, ENC_LENS, LABEL_LENS, feat=10)
    oh = np.eye(7, dtype=np.float32)[y] * dm[..., None]

    def jloss_fn(p):
        out = jchorowski.forward(p, jcfg, *map(jnp.asarray, (x, lens, oh, dm)), train=True)
        return _objective(out, oh, dm), out

    (_, want), wg = jax.value_and_grad(jloss_fn, has_aux=True)(params)
    model = registry.build("chorowski", **SMALL)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), port(params))
    got = model.forward(tp, *map(torch.from_numpy, (x, lens, oh, dm)), train=True)
    for key in ("logprobs", "alpha"):
        close(got[key].detach(), want[key], 1e-4, 1e-5, key)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                leaves)
    close_trees(jax.tree.unflatten(jax.tree.structure(tp), grads), wg, 2e-4, 2e-5)


# --- loss, optimizer, initializers ---------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
def test_masked_nll_and_token_accuracy_match_jax(normalize):
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 5, 7).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    _, _, y, dm = _batch(4, 0, 5, 7, 7, [0] * 4, [5, 2, 0, 4])
    oh = np.eye(7, dtype=np.float32)[y]
    want = jloss.masked_nll(*map(jnp.asarray, (logp, oh, dm)), normalize=normalize)
    got = loss.masked_nll(*map(torch.from_numpy, (logp, oh, dm)), normalize=normalize)
    close(got, want, 1e-6)
    wc, wt = jloss.token_accuracy(*map(jnp.asarray, (logp, y, dm)))
    gc, gt = loss.token_accuracy(*map(torch.from_numpy, (logp, y, dm)))
    assert (float(gc), float(gt)) == (float(wc), float(wt))


def _small_params(seed=0):
    return jax.tree.map(np.asarray, jchorowski.init(jax.random.PRNGKey(seed),
                                                    jchorowski.ChorowskiConfig(**SMALL)))


@pytest.mark.parametrize("cfg", [
    dict(colnorm=True),
    dict(colnorm=True, maxnorm=0.5, weight_decay=1e-3),
], ids=["recipe", "clip_and_l2"])
def test_optimizer_chain_matches_optax(cfg):
    """Two updates of the chain, then the column-norm projection, as the
    JAX trainer applies them."""
    params = _small_params()
    rng = np.random.RandomState(8)
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 0.3, params)
             for _ in range(2)]
    jcfg, tcfg = joptim.OptimConfig(**cfg), optim.OptimConfig(**cfg)
    jtx, tx = joptim.build_optimizer(jcfg), optim.build_optimizer(tcfg)
    jp, jstate = params, jtx.init(params)
    tp = port(params)
    tstate = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = joptim.colnorm_project(optax.apply_updates(jp, upd), jcfg.colnorm_maxval)
        upd, tstate = tx.update(port(g), tstate, tp)
        tp = optim.colnorm_project(optim.apply_updates(tp, upd), tcfg.colnorm_maxval)
    close_trees(tp, jp, 1e-6, 1e-6)


def test_colnorm_project_matches_jax():
    """Weights scaled up so that most columns (and w_e) are projected."""
    params = jax.tree.map(lambda p: p * 3.0, _small_params(1))
    close_trees(optim.colnorm_project(port(params), 1.0), joptim.colnorm_project(params, 1.0),
                1e-6, 1e-6)


def test_orthogonalize_params_matches_jax():
    params = _small_params(2)
    close_trees(initializers.orthogonalize_params(port(params)),
                jinit.orthogonalize_params(params), 1e-6, 1e-6)


def test_gradient_noise_scale_and_seed():
    """The annealed noise cannot match JAX's bits; its scale at step t is
    sqrt(eta / (1 + t)^gamma), and a seed repeats it."""
    zeros = {"w": torch.zeros(200, 500)}
    draw = lambda: optim.gradient_noise(0.3, 0.55, seed=4).update(
        zeros, optim.gradient_noise(0.3, 0.55, seed=4).init(zeros))[0]["w"]
    noise = draw()
    assert abs(float(noise.std()) / np.sqrt(0.3 / 2 ** 0.55) - 1) < 0.02
    torch.testing.assert_close(noise, draw(), rtol=0, atol=0)


# --- the trainer ---------------------------------------------------------------------------

STEPS = 20
TRAIN_BATCH = dict(b=4, l=12, t=6, v=7, seed=9, lens=[12, 7, 9, 3], label_lens=[6, 4, 2, 5],
                   feat=10)


def _recipe(module):
    exp = module.timit_chorowski_normnll_colnorm()
    exp.model_kwargs.update(SMALL)
    return exp


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's trajectory: its recipe at small widths, 20
    jitted steps on one fixed batch, and its eval step at the end."""
    exp = _recipe(jexperiment)
    model = exp.build_model()
    params = jax.tree.map(np.asarray, exp.init_params(jax.random.PRNGKey(0)))
    tx = joptim.build_optimizer(exp.optim)
    init_fn, step_fn = jtrainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                                model.output_depth)
    step_fn = jax.jit(step_fn)
    batch = _batch(**TRAIN_BATCH)
    state = init_fn(params, jax.random.PRNGKey(1))
    metrics = []
    for _ in range(STEPS):
        state, m = step_fn(state, tuple(map(jnp.asarray, batch)))
        metrics.append({k: float(v) for k, v in m.items()})
    evals = jtrainer.make_eval_step(model.forward, model.output_depth)(
        state[0], tuple(map(jnp.asarray, batch)))
    return params, batch, metrics, {k: float(v) for k, v in evals.items()}


def test_train_steps_track_jax(jax_run):
    params, batch, want, want_eval = jax_run
    exp = _recipe(experiment)
    model = exp.build_model()
    tx = optim.build_optimizer(exp.optim)
    init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                               model.output_depth)
    tb = tuple(map(torch.from_numpy, batch))
    state = init_fn(port(params), torch.Generator().manual_seed(1))
    for i, w in enumerate(want):
        state, m = step_fn(state, tb)
        for key in ("loss", "nll", "grad_norm", "param_norm"):
            close(float(m[key]), w[key], 1e-5 if i == 0 else 1e-3, 0.0, f"step {i + 1} {key}")
        for key in ("correct", "total", "penalty"):
            assert float(m[key]) == w[key], (i, key)
    assert want[-1]["loss"] < want[0]["loss"]
    got_eval = trainer.make_eval_step(model.forward, model.output_depth)(state[0], tb)
    for key, w in want_eval.items():
        close(float(got_eval[key]), w, 1e-3, 0.0, key)


def test_init_params_applies_the_recipe_on_the_cpu():
    """The recipe's init: random weights, then QR orthogonalization; the
    same seed gives the same weights, and the rows of each GRU gate are
    orthonormal."""
    exp = _recipe(experiment)
    p1 = exp.init_params(torch.Generator().manual_seed(5), device="cpu")
    p2 = exp.init_params(torch.Generator().manual_seed(5), device="cpu")
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    w_z = p1["encoder"]["bigru1"]["fwd"]["w_zr"][:, :16]
    torch.testing.assert_close(w_z.T @ w_z, torch.eye(16), rtol=0, atol=1e-5)


# --- what the slice does not port is refused -----------------------------------------------


def _forward(model, train):
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    x, lens, y, dm = _batch(2, 5, 3, 7, 0, [5, 3], [3, 2], feat=10)
    oh = torch.nn.functional.one_hot(torch.from_numpy(y).long(), 7).float()
    return model.forward(params, *map(torch.from_numpy, (x, lens)), oh, torch.from_numpy(dm),
                         train=train)


@pytest.mark.parametrize("case", ["awn", "weight", "dropout", "penalty", "lstm"])
def test_unported_configurations_are_refused(case):
    if case in ("awn", "weight"):
        with pytest.raises(NotImplementedError):
            trainer.make_train_step(None, optim.build_optimizer(optim.OptimConfig()),
                                    optim.OptimConfig(), trainer.TrainConfig(noise=case), 7)
    elif case in ("dropout", "penalty"):
        kw = dict(dropout=0.5) if case == "dropout" else dict(penalty_lambda=0.5)
        model = registry.build("chorowski", **SMALL, **kw)
        assert _forward(model, train=False)["logprobs"].shape == (2, 3, 7)
        with pytest.raises(NotImplementedError):
            _forward(model, train=True)
    else:
        # The LSTM decoder with peepholes: its weights are not made, and
        # the teacher-forced scan refuses it.
        cfg = attention.AttentionConfig(score_depth=4, state_depth=4, annotation_depth=4,
                                        output_depth=3, cell="lstm")
        params = attention.attention_init(torch.Generator().manual_seed(0), cfg)
        peep = dataclasses.replace(cfg, peepholes=True)
        for train in (False, True):
            with pytest.raises(NotImplementedError):
                attention.decode_teacher_forced(params, peep, torch.zeros(1, 2, 4),
                                                torch.tensor([2]), torch.zeros(1, 1, 3),
                                                torch.ones(1, 1), train=train)
        with pytest.raises(NotImplementedError):
            attention.attention_init(torch.Generator().manual_seed(0), peep)


def test_chorowski_forward_is_encode_then_decode():
    model = registry.build("chorowski", **SMALL)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    x, lens, y, dm = map(torch.from_numpy, _batch(2, 5, 3, 7, 1, [5, 2], [3, 1], feat=10))
    oh = torch.nn.functional.one_hot(y.long(), 7).float() * dm[..., None]
    got = chorowski.forward(params, model.cfg, x, lens, oh, dm)
    h, _ = model.encode(params, x, lens)
    want = attention.decode_teacher_forced(params["decoder"], model.attention_cfg, h, lens, oh, dm)
    torch.testing.assert_close(got["logprobs"], want["logprobs"], rtol=0, atol=0)
    assert model.output_depth == 7
