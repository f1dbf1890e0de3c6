"""Training of two decoders that no recipe of the port had trained before,
through the port against the JAX trainer on the CPU, at small widths,
from the same weights (moved with ``interop``) on the same numpy batch.
Each is a recipe with one model option changed, as a user of the JAX
package would change it:

- flagship_loc: timit_chorowski_normnll_colnorm with location-aware
  attention (feature_maps > 0; the recipe's filter of 10 and its
  column-norm constraint, which now also acts on the location weights):
  the location-aware GRU decoder scan (kernels K12 and K13);
- conv_bilstm_content: timit_conv_bilstm without the location term
  (feature_maps = 0): the content-only LSTM decoder scan (kernels K14
  and K15).

Tolerances: 20 train steps on one batch, loss, nll, grad_norm and
param_norm rtol 1e-5 at step 1 and 1e-3 at every step (float32 sums in
another order, fed back through adadelta); correct and total exact; the
eval step at the end rtol 1e-3. As tests/test_torch_train.py holds the
flagship recipe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

STEPS = 20


def _batch(n_frames, lens, seed):
    """(x, x_len, y, dec_mask) of 4 rows, 10-wide features zero past each
    row's length, 7 outputs, 5 labels with ragged lengths."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(lens, np.int32)
    x = rng.randn(4, n_frames, 10).astype(np.float32) * (np.arange(n_frames)[None, :, None]
                                                          < lens[:, None, None])
    y = rng.randint(0, 7, (4, 5)).astype(np.int32)
    dm = (np.arange(5)[None] < np.array([5, 3, 4, 2])[:, None]).astype(np.float32)
    return x, lens, y, dm


# name: (the recipe, its small widths with the changed option, the batch).
# The flagship's 12 frames are 12 encoder positions; conv_bilstm's 64
# frames give L' = 6 after its conv stack.
CONFIGS = {
    "flagship_loc": (
        lambda module: module.timit_chorowski_normnll_colnorm(),
        dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=16, score_depth=16,
             state_depth=16, mlp_depth=8, output_depth=7, feature_maps=4),
        (12, [12, 7, 9, 3], 9),
    ),
    "conv_bilstm_content": (
        lambda module: module.timit_conv_bilstm(),
        dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=8, score_depth=12,
             state_depth=16, output_depth=7, feature_maps=0),
        (64, [64, 50, 57, 40], 9),
    ),
}


def _recipe(name, module):
    recipe, small, _ = CONFIGS[name]
    exp = recipe(module)
    exp.model_kwargs.update(small)
    return exp


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX trainer's trajectory for one configuration: 20 jitted steps
    on one batch (its XLA scans on the CPU), and its eval step."""
    name = request.param
    exp = _recipe(name, jexperiment)
    model = exp.build_model()
    params = jax.tree.map(np.asarray, exp.init_params(jax.random.PRNGKey(0)))
    tx = joptim.build_optimizer(exp.optim)
    init_fn, step_fn = jtrainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                                model.output_depth)
    step_fn = jax.jit(step_fn)
    batch = _batch(*CONFIGS[name][2])
    state = init_fn(params, jax.random.PRNGKey(1))
    metrics = []
    for _ in range(STEPS):
        state, m = step_fn(state, tuple(map(jnp.asarray, batch)))
        metrics.append({k: float(v) for k, v in m.items()})
    evals = jtrainer.make_eval_step(model.forward, model.output_depth)(
        state[0], tuple(map(jnp.asarray, batch)))
    return name, params, batch, metrics, {k: float(v) for k, v in evals.items()}


def test_train_steps_track_jax(jax_run):
    name, params, batch, want, want_eval = jax_run
    exp = _recipe(name, experiment)
    model = exp.build_model()
    tx = optim.build_optimizer(exp.optim)
    init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                               model.output_depth)
    tb = tuple(map(torch.from_numpy, batch))
    state = init_fn(interop.to_torch(jax.tree.map(np.asarray, params), "cpu"),
                    torch.Generator().manual_seed(1))
    for i, w in enumerate(want):
        state, m = step_fn(state, tb)
        for key in ("loss", "nll", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(m[key]), w[key], rtol=1e-5 if i == 0 else 1e-3,
                                       err_msg=f"{name} step {i + 1} {key}")
        for key in ("correct", "total", "penalty"):
            assert float(m[key]) == w[key], (name, i, key)
    assert want[-1]["loss"] < want[0]["loss"]
    got_eval = trainer.make_eval_step(model.forward, model.output_depth)(state[0], tb)
    for key, w in want_eval.items():
        np.testing.assert_allclose(float(got_eval[key]), w, rtol=1e-3, err_msg=f"{name} {key}")
