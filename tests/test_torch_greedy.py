"""The port's greedy decode (K=1) against the JAX package's on the CPU,
for the flagship decoder (content-only GRU, maxout readout), the
flagship with location-aware attention and the conv+BiLSTM decoder
(location-aware LSTM, linear-ReLU-linear readout), at small widths with
the JAX weights carried across.

Tolerances: tokens and lengths identical; the summed log-prob rtol 1e-5
(atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import greedy as jgreedy
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import greedy
from seq2seq_attention_asr_tpu_torch.models import registry

FLAGSHIP = dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=16,
                score_depth=16, state_depth=16, mlp_depth=8, output_depth=6)
MODELS = {
    "flagship": ("chorowski", FLAGSHIP),
    "flagship_loc": ("chorowski", dict(FLAGSHIP, feature_maps=4, filt_size=5)),
    "conv_bilstm": ("conv_bilstm", dict(input_frame_size=10, hidden_frame_size=16,
                                        output_frame_size=8, score_depth=12, feature_maps=4,
                                        state_depth=16, output_depth=6)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    name, kw = MODELS[request.param]
    jmodel = jregistry.build(name, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, registry.build(name, **kw), params["decoder"]


def _with_eos_bias(dec, eos, bias):
    """The readout's last bias raised at eos, so that rows finish on eos."""
    dec = jax.tree.map(np.copy, dec)
    dec["readout"][-1]["b"][eos] += bias
    return dec


@pytest.mark.parametrize("seed,eos_bias", [(1, 0.0), (2, 0.5), (3, 2.0)])
def test_greedy_matches_jax(model, seed, eos_bias):
    jmodel, pmodel, dec = model
    rng = np.random.RandomState(seed)
    b, l, eos = 4, 12, 5
    a = jmodel.attention_cfg.annotation_depth
    h = rng.randn(b, l, a).astype(np.float32)
    lens = np.array([12, 7, 10, 3], np.int32)
    max_steps = np.array([12, 4, 9, 3], np.int32)
    dec = _with_eos_bias(jax.tree.map(lambda w: 3 * w, dec), eos, eos_bias)
    want = jgreedy.greedy_decode(dec, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens),
                                 eos, max_steps=jnp.asarray(max_steps), max_steps_cap=l)
    got = greedy.greedy_decode(interop.to_torch(dec, "cpu"), pmodel.attention_cfg,
                               torch.from_numpy(h), torch.from_numpy(lens), eos,
                               max_steps=torch.from_numpy(max_steps), max_steps_cap=l,
                               device="cpu")
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprob.numpy(), np.asarray(want.logprob), rtol=1e-5,
                               atol=1e-5)
    if eos_bias == 2.0:  # some row ends on eos before its cap
        toks, lens_got = got.tokens.numpy(), got.lengths.numpy()
        assert any(lens_got[i] < max_steps[i] and toks[i, lens_got[i] - 1] == eos
                   for i in range(b))


def test_greedy_defaults_and_refusals(model, monkeypatch):
    jmodel, pmodel, dec = model
    a = jmodel.attention_cfg.annotation_depth
    h = np.random.RandomState(4).randn(2, 6, a).astype(np.float32)
    lens = np.array([6, 2], np.int32)
    want = jgreedy.greedy_decode(dec, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens), 1)
    got = greedy.greedy_decode(interop.to_torch(dec, "cpu"), pmodel.attention_cfg,
                               torch.from_numpy(h), torch.from_numpy(lens), 1, device="cpu")
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError):  # asked for the card, given CPU tensors
        greedy.greedy_decode(interop.to_torch(dec, "cpu"), pmodel.attention_cfg,
                             torch.from_numpy(h), torch.from_numpy(lens), 1, device="cuda")
