"""The port's LSTM pieces against the JAX package on the CPU: per-row
flips, the LSTM cell and layer, the plain version of the BiLSTM scan
(kernel K7's twin) against the Pallas kernel in interpret mode, the
BiLSTM layer against both JAX backends, and the LSTM branch of the
orthogonal init.

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance (tests/test_pallas.py:210-221); orthogonalization
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops import cells as jcells
from seq2seq_attention_asr_tpu.ops import masking as jmask
from seq2seq_attention_asr_tpu.ops import rnn as jrnn
from seq2seq_attention_asr_tpu.ops.pallas import lstm_scan as jls
from seq2seq_attention_asr_tpu.train import initializers as jinit
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.ops import cells, masking, rnn
from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan
from seq2seq_attention_asr_tpu_torch.train import initializers

RTOL, ATOL = 2e-5, 2e-6


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("trailing", [(), (3,), (2, 2)])
def test_flip_sequences(trailing):
    """Lengths 0, short, full and past L (clamped to L); padding stays."""
    x = np.random.RandomState(0).randn(4, 6, *trailing).astype(np.float32)
    lens = np.array([0, 3, 6, 9], np.int32)
    want = jmask.flip_sequences(jnp.asarray(x), jnp.asarray(lens))
    got = masking.flip_sequences(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(masking.flip_sequences(got, torch.from_numpy(lens)).numpy(), x)


def test_lstm_cell_functions():
    rng = np.random.RandomState(1)
    p = jcells.lstm_init(jax.random.PRNGKey(2), 6, 9)
    x = rng.randn(3, 4, 6).astype(np.float32)
    h = (rng.randn(3, 4, 9) * 0.5).astype(np.float32)
    c = (rng.randn(3, 4, 9) * 0.5).astype(np.float32)
    tp = port(p)
    got = cells.lstm_step(tp, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    want = jcells.lstm_step(p, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    for g, w in zip(got, want):
        close(g, w)
    xp_want = jcells.lstm_input_proj(p, jnp.asarray(x))
    xp_got = cells.lstm_input_proj(tp, torch.from_numpy(x))
    close(xp_got, xp_want)
    got = cells.lstm_step_preproj(tp, xp_got, (torch.from_numpy(h), torch.from_numpy(c)))
    want = jcells.lstm_step_preproj(p, xp_want, (jnp.asarray(h), jnp.asarray(c)))
    for g, w in zip(got, want):
        close(g, w)
    mine = cells.lstm_init(torch.Generator().manual_seed(0), 6, 9)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer(reverse):
    p = jcells.lstm_init(jax.random.PRNGKey(3), 5, 8)
    x = np.random.RandomState(4).randn(3, 7, 5).astype(np.float32)
    lens = np.array([7, 4, 1], np.int32)
    want = jrnn.lstm_layer(p, jnp.asarray(x), jnp.asarray(lens), reverse=reverse)
    got = rnn.lstm_layer(port(p), torch.from_numpy(x), torch.from_numpy(lens), reverse=reverse)
    close(got, want)


def test_bilstm_scan_plain_matches_pallas():
    """Hidden and cell states of both directions from nonzero initial
    states, against the Pallas kernel's forward (_run_fwd)."""
    rng = np.random.RandomState(5)
    b, l, h = 3, 9, 16
    xproj2 = rng.randn(2, b, l, 4 * h).astype(np.float32)
    h02 = (rng.randn(2, b, h) * 0.5).astype(np.float32)
    c02 = (rng.randn(2, b, h) * 0.5).astype(np.float32)
    wh2 = (rng.randn(2, h, 4 * h) * 0.25).astype(np.float32)
    args = tuple(map(jnp.asarray, (xproj2, h02, c02, wh2)))
    want_h, want_c = jls._run_fwd(*args, interpret=True)
    got_h, got_c = lstm_scan.bilstm_scan(*map(torch.from_numpy, (xproj2, h02, c02, wh2)))
    close(got_h, want_h)
    close(got_c, want_c)
    close(got_h, jls.bilstm_scan(*args, True))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bilstm_layer_matches_jax(backend):
    """B=8, 16 -> 128, ragged lengths; every position compared, padding
    included (the outputs are not masked)."""
    params = jrnn.bilstm_init(jax.random.PRNGKey(5), 16, 128)
    x = np.array(jax.random.normal(jax.random.PRNGKey(6), (8, 6, 16)))
    lens = np.array([6, 4, 3, 6, 5, 2, 6, 1], np.int32)
    want = jrnn.bilstm_layer(params, jnp.asarray(x), jnp.asarray(lens), backend=backend)
    with torch.no_grad():
        got = rnn.bilstm_layer(port(params), torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == (8, 6, 256)
    close(got, want)


def test_bilstm_layer_refuses_autograd():
    params = port(jrnn.bilstm_init(jax.random.PRNGKey(7), 4, 8))
    x = torch.zeros(2, 3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError):
        rnn.bilstm_layer(params, x, torch.tensor([3, 2]))
    with torch.no_grad():
        assert rnn.bilstm_layer(params, x, torch.tensor([3, 2])).shape == (2, 3, 16)


def test_lstm_orthogonalization_matches_jax():
    """w_x per gate with the summed bias, w_h per gate without, on the
    same numpy tree (a BiLSTM and an LSTM decoder cell)."""
    tree = {"bilstm": jax.tree.map(np.asarray, jrnn.bilstm_init(jax.random.PRNGKey(8), 12, 8)),
            "cell": jax.tree.map(np.asarray, jcells.lstm_init(jax.random.PRNGKey(9), 8, 8))}
    want = jinit.orthogonalize_params(tree)
    got = initializers.orthogonalize_params(port(tree))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert not np.allclose(got["cell"]["w_h"].numpy(), tree["cell"]["w_h"])
