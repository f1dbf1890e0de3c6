"""The port's LSTM pieces against the JAX package on the CPU: per-row
flips, the LSTM cell and layer, the plain versions of the BiLSTM scan
(kernel K7's twin) and of its backward (kernel K9's twin) against the
Pallas kernels in interpret mode, ``BiLSTMScan`` against finite
differences, the BiLSTM layer and its gradient against both JAX
backends, and the LSTM branch of the orthogonal init.

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance (tests/test_pallas.py:210-221); gradients rtol 2e-4
(atol 2e-5), sums over B*L rows taken in another order;
orthogonalization within 1e-6.
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
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


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


def _scan_bwd_inputs(dtype=np.float32, b=3, l=9, h=16, seed=6):
    """(xproj2, h02, c02, wh2) and a cotangent of the hidden states."""
    rng = np.random.RandomState(seed)
    xproj2 = rng.randn(2, b, l, 4 * h)
    h02 = rng.randn(2, b, h) * 0.5
    c02 = rng.randn(2, b, h) * 0.5
    wh2 = rng.randn(2, h, 4 * h) * 0.25
    dys2 = rng.randn(2, b, l, h)
    return [a.astype(dtype) for a in (xproj2, h02, c02, wh2)], dys2.astype(dtype)


def _shifted(first, seq):
    """The state each step starts from: `first` at step 0, seq[t-1] after."""
    return np.concatenate([np.asarray(first)[:, :, None], np.asarray(seq)[:, :, :-1]], axis=2)


@pytest.mark.parametrize("reference", ["pallas_interpret", "torch_autograd"])
def test_bilstm_scan_bwd_plain_matches(reference):
    """K9's plain version from nonzero initial states: against the Pallas
    backward (_run_bwd) on the Pallas forward's saved states, and against
    autograd through the plain forward."""
    inputs, dys2 = _scan_bwd_inputs()
    xproj2, h02, c02, wh2 = inputs
    if reference == "pallas_interpret":
        hs, cs = jls._run_fwd(*map(jnp.asarray, inputs), interpret=True)
        h_prev, c_prev = _shifted(h02, hs), _shifted(c02, cs)
        want = jls._run_bwd(*map(jnp.asarray, (xproj2, h_prev, c_prev, dys2, wh2)),
                            interpret=True)
    else:
        args = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        hs, cs = lstm_scan.bilstm_scan_plain(*args)
        want = torch.autograd.grad((hs * torch.from_numpy(dys2)).sum(), args)
        h_prev, c_prev = _shifted(h02, hs.detach()), _shifted(c02, cs.detach())
    got = lstm_scan.bilstm_scan_bwd(*map(torch.from_numpy, (xproj2, h_prev, c_prev, dys2, wh2)))
    for name, g, w in zip(("dxproj2", "dh02", "dc02", "dwh2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_bilstm_scan_autograd_function_passes_gradcheck():
    inputs, _ = _scan_bwd_inputs(np.float64, b=2, l=4, h=3, seed=7)
    args = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    assert torch.autograd.gradcheck(lstm_scan.BiLSTMScan.apply, args)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bilstm_layer_gradient_matches_jax(backend):
    """The gradient of sum(y * w) for a random w, with ragged lengths,
    with respect to the input and every weight, against jax.grad of the
    JAX layer; w reaches the padding, so the cotangent is nonzero there
    too."""
    params = jrnn.bilstm_init(jax.random.PRNGKey(9), 16, 128)
    rng = np.random.RandomState(10)
    x = rng.randn(8, 6, 16).astype(np.float32)
    w = rng.randn(8, 6, 256).astype(np.float32)
    lens = np.array([6, 4, 3, 6, 5, 2, 6, 1], np.int32)

    def jloss(p, xx):
        return jnp.sum(jrnn.bilstm_layer(p, xx, jnp.asarray(lens), backend=backend) * w)

    wgp, wgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), port(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = rnn.bilstm_layer(tp, tx, torch.from_numpy(lens))
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves + [tx])
    close(grads[-1], wgx, GRAD_RTOL, GRAD_ATOL)
    for g, want in zip(grads[:-1], jax.tree.leaves(wgp)):
        close(g, want, GRAD_RTOL, GRAD_ATOL)


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
