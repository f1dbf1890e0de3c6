"""The port's conv+BiLSTM model (serving) against the JAX package on the
CPU: the temporal conv ops, the encoder, the recipe and PCM -> text.

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance; beam tokens identical, scores rtol 1e-5 (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu import serve as jserve
from seq2seq_attention_asr_tpu.models import conv_bilstm as jcb
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import conv as jconv
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu_torch import interop, serve
from seq2seq_attention_asr_tpu_torch.models import conv_bilstm, registry
from seq2seq_attention_asr_tpu_torch.ops import conv
from seq2seq_attention_asr_tpu_torch.train import experiment

RTOL, ATOL = 2e-5, 2e-6
DIMS = dict(input_frame_size=123, hidden_frame_size=16, output_frame_size=8, score_depth=12,
            feature_maps=4, state_depth=16, output_depth=7)


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("l,k,stride", [(13, 3, 1), (12, 3, 1), (11, 5, 2), (2, 3, 1)])
def test_temporal_conv_and_pool(l, k, stride):
    """VALID conv and pool at odd and even lengths, and a length under
    the kernel's width (no output frame)."""
    p = jconv.temporal_conv_init(jax.random.PRNGKey(l), 6, 5, k)
    x = np.random.RandomState(l).randn(3, l, 6).astype(np.float32)
    want = jconv.temporal_conv(p, jnp.asarray(x), stride)
    got = conv.temporal_conv(port(p), torch.from_numpy(x), stride)
    assert got.shape == want.shape
    close(got, want)
    for size in (2, 3):
        want = jconv.temporal_max_pool(jnp.asarray(x), size, stride)
        got = conv.temporal_max_pool(torch.from_numpy(x), size, stride)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lens = np.array([0, 1, 2, 3, 7, 13, 14], np.int32)
    np.testing.assert_array_equal(
        conv.conv_out_length(torch.from_numpy(lens), k, stride).numpy(),
        np.asarray(jconv.conv_out_length(jnp.asarray(lens), k, stride)))


@pytest.fixture(scope="module")
def models():
    jmodel = jregistry.build("conv_bilstm", **DIMS)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, registry.build("conv_bilstm", **DIMS), params


def test_init_has_the_jax_tree(models):
    _, pmodel, params = models
    got = interop.to_numpy(pmodel.init(torch.Generator().manual_seed(1), device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(params)]


def test_encode_matches_jax(models):
    """The JAX encoder through its Pallas BiLSTM scan (interpret mode);
    all 8 rows compared at every position, padding included."""
    _, pmodel, params = models
    rng = np.random.RandomState(2)
    x = rng.randn(8, 70, 123).astype(np.float32)
    lens = np.array([70, 41, 64, 33, 70, 55, 48, 26], np.int32)
    jcfg = jcb.ConvBiLSTMConfig(**DIMS, rnn_backend="pallas")
    want, want_len = jcb.encode(params, jcfg, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_len = pmodel.encode(port(params), torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == (8, 7, 16)
    close(got, want)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(conv_bilstm.encode_lengths(pmodel.cfg, torch.from_numpy(lens)),
                                  np.asarray(want_len))


def _pcm(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_transcriber_matches_jax(models, exact):
    """Three utterances in two frame buckets, 8x shorter after the
    encoder; the JAX package serves through its XLA front end."""
    jmodel, pmodel, params = models
    params = dict(params)
    # Decoder weights scaled by 3 so that the picks vary from step to step.
    params["decoder"] = jax.tree.map(lambda a: 3 * a, params["decoder"])
    pcms = [_pcm(24000, 0), _pcm(40000, 1), _pcm(24500, 2)]
    rng = np.random.RandomState(3)
    kw = dict(eos_id=6, pad_frames=10, beam_k=3, exact=exact,
              mean=rng.randn(123).astype(np.float32), std=rng.uniform(5, 20, 123).astype(np.float32))
    want = jserve.Transcriber(jmodel, params, frontend="xla", **kw).transcribe(pcms)
    got = serve.Transcriber(pmodel, params, device="cpu", **kw).transcribe(pcms)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.score, w.score, rtol=1e-5, atol=1e-5)
    assert any(len(g.ids) > 1 for g in got)


def test_recipe_matches_jax_and_initialises():
    """The recipe's model and optimizer fields are the JAX package's, and
    its init runs the LSTM branch of the orthogonalization."""
    exp, jexp = experiment.timit_conv_bilstm(), jexperiment.timit_conv_bilstm()
    assert exp.name == jexp.name and exp.model == jexp.model == "conv_bilstm"
    assert exp.model_kwargs == jexp.model_kwargs
    assert exp.optim.__dict__ == jexp.optim.__dict__
    assert exp.orthogonalize and exp.init_std is None
    exp.model_kwargs.update(hidden_frame_size=8, output_frame_size=4, score_depth=6,
                            feature_maps=2, state_depth=8, output_depth=5)
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")
    w_h = params["encoder"]["bilstm"]["fwd"]["w_h"][:, :4]  # the in-gate block, 4 x 4
    torch.testing.assert_close(w_h @ w_h.T, torch.eye(4), rtol=0, atol=1e-5)


def test_training_is_refused(models):
    _, pmodel, params = models
    with pytest.raises(NotImplementedError):
        pmodel.forward(port(params), torch.zeros(1, 70, 123), torch.tensor([70]),
                       torch.zeros(1, 3, 7), torch.ones(1, 3))
