"""The port's conv+BiLSTM model against the JAX package on the CPU: the
temporal conv ops, the encoder, the recipe and PCM -> text; the
location-aware LSTM decoder's teacher-forced scan and the model's
training forward, with their gradients.

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance; beam tokens identical, scores rtol 1e-5 (atol 1e-5);
teacher-forced logprobs and alpha rtol 1e-4 (atol 1e-5) and gradients of
nll + 0.1 * sum(alpha^2) rtol 2e-4 (atol 2e-5), as
tests/test_torch_train.py holds the flagship's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu import serve as jserve
from seq2seq_attention_asr_tpu.models import conv_bilstm as jcb
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops import conv as jconv
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu_torch import interop, serve
from seq2seq_attention_asr_tpu_torch.models import conv_bilstm, registry
from seq2seq_attention_asr_tpu_torch.ops import attention, conv
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


def _objective(out, oh, dm):
    nll = -(oh * out["logprobs"] * dm[..., None]).sum()
    return nll + 0.1 * (out["alpha"] ** 2).sum()


def _labels(b, t, v, label_lens, seed):
    rng = np.random.RandomState(seed)
    dm = (np.arange(t)[None] < np.asarray(label_lens)[:, None]).astype(np.float32)
    return np.eye(v, dtype=np.float32)[rng.randint(0, v, (b, t))] * dm[..., None], dm


def _check_grads(tree, grads, want, extra=()):
    leaves = jax.tree.leaves(tree)
    assert len(grads) == len(leaves) + len(extra)
    for got, w in zip(grads, jax.tree.leaves(want) + list(extra)):
        close(got, w, 2e-4, 2e-5)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_decode_teacher_forced_loc_lstm_matches_jax(backend):
    """The recipe's decoder at small widths (LSTM, 4 feature maps, filter
    5, linear -> relu -> linear readout); JAX's "pallas" backend is its
    fused loc-LSTM scan in interpret mode (B = 8, L = 16)."""
    kw = dict(score_depth=12, filt_size=5, feature_maps=4, state_depth=16, annotation_depth=16,
              output_depth=7, cell="lstm", readout=(("linear", 14), ("relu",), ("linear", 7)))
    jcfg, cfg = jatt.AttentionConfig(**kw), attention.AttentionConfig(**kw)
    params = jax.tree.map(np.asarray, jatt.attention_init(jax.random.PRNGKey(4), jcfg))
    lens = np.array([16, 11, 5, 16, 1, 9, 13, 16], np.int32)
    h = (np.random.RandomState(5).randn(8, 16, 16) * 0.5).astype(np.float32)
    oh, dm = _labels(8, 6, 7, [6, 3, 6, 1, 5, 6, 2, 4], 6)

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
        close(got[key].detach(), want[key], 1e-4, 1e-5)
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                jax.tree.leaves(tp) + [th])
    _check_grads(tp, grads, wgp, [wgh])


def _pool_ties(params, x):
    """Max-pool windows, over the three conv blocks, whose two inputs
    are equal and nonzero after the ReLU."""
    ties, hh = 0, torch.from_numpy(x)
    for name in ("conv1", "conv2", "conv3"):
        r = torch.relu(conv.temporal_conv(params["encoder"][name], hh))
        pairs = r[:, : r.shape[1] // 2 * 2].reshape(r.shape[0], -1, 2, r.shape[2])
        ties += int(((pairs[:, :, 0] == pairs[:, :, 1]) & (pairs[:, :, 0] > 0)).sum())
        hh = conv.temporal_max_pool(r, 2)
    return ties


def test_forward_matches_jax(models):
    """The training forward, the JAX model through its Pallas BiLSTM and
    loc-LSTM scans (interpret mode; 144 frames give L' = 16). The frames
    past each row's length are zero, as the serving front end pads them,
    so the conv stack gives equal positive values in the padding and the
    max pools see ties. There the port's amax splits the gradient evenly
    and JAX's reduce_window sends it to one input; the gradients agree
    all the same, because the padding's cotangent is zero."""
    _, pmodel, params = models
    rng = np.random.RandomState(7)
    lens = np.array([144, 101, 130, 96, 144, 117, 122, 99], np.int32)
    x = rng.randn(8, 144, 123).astype(np.float32)
    x *= (np.arange(144)[None, :, None] < lens[:, None, None])
    oh, dm = _labels(8, 9, 7, [9, 5, 9, 2, 7, 9, 4, 6], 8)
    assert _pool_ties(port(params), x) > 0
    jcfg = jcb.ConvBiLSTMConfig(**DIMS, rnn_backend="pallas", attn_backend="pallas")

    def jloss_fn(p):
        out = jcb.forward(p, jcfg, *map(jnp.asarray, (x, lens, oh, dm)), train=True)
        return _objective(out, oh, dm), out

    (_, want), wg = jax.value_and_grad(jloss_fn, has_aux=True)(params)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), port(params))
    got = pmodel.forward(tp, *map(torch.from_numpy, (x, lens, oh, dm)), train=True)
    assert got["alpha"].shape == (8, 9, 16)
    for key in ("logprobs", "alpha"):
        close(got[key].detach(), want[key], 1e-4, 1e-5)
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                jax.tree.leaves(tp))
    _check_grads(tp, grads, wg)
