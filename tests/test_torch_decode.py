"""The port's encoder and beam search against the JAX package on the CPU.

Tolerances: annotations rtol 2e-5 (atol 2e-6), the JAX package's
forward parity tolerance; beam tokens and lengths identical; beam
scores, sums of up to ~20 float32 log-probs, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.models import chorowski as jchor
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.models import chorowski, registry

DIMS = dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=16, score_depth=16,
            state_depth=16, mlp_depth=8, output_depth=6)


@pytest.fixture(scope="module")
def model():
    jmodel = jregistry.build("chorowski", **DIMS)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, registry.build("chorowski", **DIMS), params


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_encode_matches_jax(model, backend):
    jmodel, pmodel, params = model
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16, 10).astype(np.float32)
    lens = np.array([16, 11, 5], np.int32)
    jcfg = jchor.ChorowskiConfig(**DIMS, rnn_backend=backend)
    want = jchor.encode(params, jcfg, jnp.asarray(x), jnp.asarray(lens))
    got, got_len = pmodel.encode(interop.to_torch(params, "cpu"), torch.from_numpy(x),
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got_len.numpy(), lens)
    np.testing.assert_allclose(
        chorowski.encode(interop.to_torch(params, "cpu"), pmodel.cfg, torch.from_numpy(x),
                         torch.from_numpy(lens)).numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("seed,k", [(2, 3), (3, 2), (4, 1), (5, 5)])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_beam_search_matches_jax(model, seed, k, backend):
    """Identical tokens and lengths on a batch of unequal lengths and a
    per-row step cap below the encoder length. The decoder weights are
    scaled by 4 so that the log-probs move from step to step: over these
    cases eos ends hypotheses after 1, 2 and 3 tokens and caps force
    others to finish."""
    jmodel, pmodel, params = model
    rng = np.random.RandomState(seed)
    b, l = 4, 16
    h = rng.randn(b, l, 32).astype(np.float32)
    lens = np.array([16, 9, 12, 3], np.int32)
    max_steps = np.array([16, 5, 12, 3], np.int32)
    dec = jax.tree.map(lambda a: 4 * a, params["decoder"])
    want = jbeam.beam_search(dec, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens), 0,
                             k=k, max_steps=jnp.asarray(max_steps), max_steps_cap=l,
                             backend=backend)
    got = beam.beam_search(interop.to_torch(dec, "cpu"), pmodel.attention_cfg,
                           torch.from_numpy(h), torch.from_numpy(lens), 0, k=k,
                           max_steps=torch.from_numpy(max_steps), max_steps_cap=l,
                           device="cpu")
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)


def test_beam_search_refuses_steps_past_the_history(model):
    _, pmodel, params = model
    h = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError):
        beam.beam_search(interop.to_torch(params["decoder"], "cpu"), pmodel.attention_cfg, h,
                         torch.tensor([4]), 1, k=2, max_steps=torch.tensor([6]), max_steps_cap=4,
                         device="cpu")


def test_beam_search_stops_when_every_pool_is_full(model, monkeypatch):
    """With the readout's eos logit raised far above the rest, the first
    step finishes one hypothesis on eos and the second the other k - 1,
    so the loop ends after two decoder steps, well before max_steps, with
    the tokens of the JAX package."""
    jmodel, pmodel, params = model
    rng = np.random.RandomState(6)
    b, l, k = 3, 12, 3
    h = rng.randn(b, l, 32).astype(np.float32)
    lens = np.array([12, 10, 7], np.int32)
    dec = jax.tree.map(np.copy, params["decoder"])
    dec["readout"][-1]["b"][0] += 10.0
    want = jbeam.beam_search(dec, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens), 0,
                             k=k, backend="xla")
    step, calls = beam.fused_attention_step, []

    def counted(*args):
        calls.append(1)
        return step(*args)

    monkeypatch.setattr(beam, "fused_attention_step", counted)
    got = beam.beam_search(interop.to_torch(dec, "cpu"), pmodel.attention_cfg,
                           torch.from_numpy(h), torch.from_numpy(lens), 0, k=k, device="cpu")
    assert len(calls) == 2
    np.testing.assert_array_equal(got.lengths.numpy(), np.ones(b))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_beam_search_ties_rank_by_index_as_in_jax(backend):
    """With the last readout layer zeroed every log-prob ties (-log V),
    and every expansion score ties with its row's: the picks are then
    fixed by the tie order alone. lax.top_k ranks equal scores by lower
    flat index; so must the port (torch.topk promises no order)."""
    dims = dict(DIMS, output_depth=62)
    jmodel = jregistry.build("chorowski", **dims)
    params = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(1)))["decoder"]
    params["readout"][-1] = jax.tree.map(np.zeros_like, params["readout"][-1])
    rng = np.random.RandomState(7)
    h = rng.randn(3, 12, 32).astype(np.float32)
    lens = np.array([12, 8, 5], np.int32)
    want = jbeam.beam_search(params, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens), 61,
                             k=5, backend=backend)
    got = beam.beam_search(interop.to_torch(params, "cpu"),
                           registry.build("chorowski", **dims).attention_cfg,
                           torch.from_numpy(h), torch.from_numpy(lens), 61, k=5, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)
