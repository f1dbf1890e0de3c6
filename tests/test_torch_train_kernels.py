"""The training kernels' plain PyTorch versions against the JAX package's
Pallas kernels, run on the CPU in interpret mode as tests/test_pallas.py
runs them, on the same numpy inputs; and the port's autograd functions
against finite differences.

  - K6 (BiGRU backward): jax.vjp of gru_scan.bigru_scan2, and torch
    autograd through the plain forward; rtol 5e-4, atol 5e-5, the JAX
    package's gradient tolerance (tests/test_pallas.py:52-66).
  - K4 (decoder scan forward): attention_decode_scan called directly
    with block_b=8 and interpret=True (B = 8 and L a multiple of 8, so
    no wrapper can swap in the XLA scan); rtol 1e-4, atol 1e-5.
  - K5 (decoder scan backward): _run_bwd in interpret mode and
    _run_bwd_xla, on the same saved sequences and random nonzero
    cotangents; rtol 2e-4, atol 2e-5.
  - BiGRUScan2 and AttentionDecodeScan on CPU tensors (plain forward and
    backward): torch.autograd.gradcheck in float64.

Lengths are ragged everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jas
from seq2seq_attention_asr_tpu.ops.pallas import gru_scan as jgs
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan

GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _bigru_inputs(dtype=np.float32, b=3, l=13, h=8, seed=0):
    """Natural-order projections, zero past each row's length, as
    bigru_layer hands them over, and random cotangents."""
    rng = np.random.RandomState(seed)
    lens = np.array([l, 6, 1][:b])
    valid = (np.arange(l)[None] < lens[:, None])[:, :, None]
    xf = rng.randn(b, l, 3 * h) * valid
    xb = rng.randn(b, l, 3 * h) * valid
    wzr2 = rng.randn(2, h, 2 * h) * 0.4
    wh2 = rng.randn(2, h, h) * 0.4
    dys = (rng.randn(b, l, h), rng.randn(b, l, h))
    return [a.astype(dtype) for a in (xf, xb, wzr2, wh2)], [d.astype(dtype) for d in dys]


def _jax_bigru_vjp(inputs, dys):
    ys, vjp = jax.vjp(lambda *a: jgs.bigru_scan2(*a, True), *map(jnp.asarray, inputs))
    return ys, vjp(tuple(map(jnp.asarray, dys)))


def _autograd_bigru_vjp(inputs, dys):
    args = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    ysf, ysb = gru_scan.bigru_scan2_plain(*args)
    loss = (ysf * torch.from_numpy(dys[0])).sum() + (ysb * torch.from_numpy(dys[1])).sum()
    return (ysf.detach().numpy(), ysb.detach().numpy()), torch.autograd.grad(loss, args)


@pytest.mark.parametrize("reference", ["jax_pallas_vjp", "torch_autograd"])
def test_bigru_scan2_bwd_plain_matches(reference):
    inputs, dys = _bigru_inputs()
    ref = _jax_bigru_vjp if reference == "jax_pallas_vjp" else _autograd_bigru_vjp
    (ysf, ysb), want = ref(inputs, dys)
    got = gru_scan.bigru_scan2_bwd(*map(torch.from_numpy, inputs), torch.tensor(np.asarray(ysf)),
                                   torch.tensor(np.asarray(ysb)), *map(torch.from_numpy, dys))
    for name, g, w in zip(("dxf", "dxb", "dwzr2", "dwh2"), got, want):
        close(g, w, GRAD_RTOL, GRAD_ATOL, name)


def test_bigru_scan2_autograd_function_passes_gradcheck():
    inputs, _ = _bigru_inputs(np.float64, b=2, l=5, h=3, seed=1)
    args = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    assert torch.autograd.gradcheck(gru_scan.BiGRUScan2.apply, args)


# Decoder scan: B = 8 and L = 16 make JAX's kernel run as the kernel.
B, L, T, S, A, ST = 8, 16, 7, 128, 256, 128


def _scan_inputs(dtype=np.float32, b=B, l=L, t=T, s=S, a=A, st=ST, seed=0):
    """(vh, h, enc_mask, yin, 9 weights) with ragged encoder lengths; the
    weights as the port keeps them (1-D biases and w_e)."""
    rng = np.random.RandomState(seed)
    lens = np.array([l, l - 3, 5, l, 1, l - 7, 9, l][:b])
    mask = (np.arange(l)[None] < lens[:, None]).astype(dtype)
    h = rng.randn(b, l, a) * 0.5 * mask[:, :, None]
    u = lambda *shape: rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
    vh = h @ u(a, s)
    yin = rng.randn(b, t, st) * 0.5
    weights = [u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0], u(2 * st, 2 * st), u(2 * st, st)]
    return [np.asarray(x, dtype) for x in (vh, h, mask, yin, *weights)]


def _jax_args(inputs):
    """The JAX kernel's argument list: biases and w_e as (1, X) rows."""
    vh, h, mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, wzr, wh = map(jnp.asarray, inputs)
    return (vh, h, mask, yin, ws_w, ws_b[None], w_e[None], c_w, c_b[None], dec_w, dec_b[None],
            wzr, wh)


def test_attention_decode_scan_plain_matches_pallas():
    inputs = _scan_inputs()
    want = jas.attention_decode_scan(*_jax_args(inputs), 8, True)
    got = attention_scan.attention_decode_scan(*map(torch.from_numpy, inputs))
    for name, g, w in zip(("s_seq", "c_seq", "alpha_seq"), got, want):
        close(g, w, 1e-4, 1e-5, name)
    assert not got[2].numpy()[np.broadcast_to(inputs[2][:, None] == 0, got[2].shape)].any()


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_attention_decode_scan_bwd_plain_matches(reference):
    inputs = _scan_inputs()
    jargs = _jax_args(inputs)
    s_seq, c_seq, alpha_seq = jas.attention_decode_scan(*jargs, 8, True)
    rng = np.random.RandomState(5)
    cot = [rng.randn(B, T, n).astype(np.float32) for n in (ST, A, L)]
    saved = (s_seq, c_seq, *map(jnp.asarray, cot))
    if reference == "xla":
        want = jas._run_bwd_xla(*jargs, *saved)
    else:
        want = jas._run_bwd(*jargs, *saved, 8, True)
    # The port's backward takes the forward's alpha, which the JAX backward
    # recomputes.
    got = attention_scan.attention_decode_scan_bwd(
        *map(torch.from_numpy, inputs),
        *(torch.tensor(np.asarray(x)) for x in (s_seq, c_seq, alpha_seq)),
        *map(torch.from_numpy, cot))
    names = ("dvh", "dh", "dyin") + attention_scan.WEIGHTS
    for name, g, w in zip(names, got, want):
        close(g, np.asarray(w).reshape(g.shape), 2e-4, 2e-5, name)


def test_attention_decode_scan_autograd_function_passes_gradcheck():
    inputs = _scan_inputs(np.float64, b=2, l=5, t=3, s=4, a=6, st=3, seed=2)
    args = [torch.from_numpy(x) for x in inputs]
    for i, x in enumerate(args):
        if i != 2:  # enc_mask takes no gradient
            x.requires_grad_(True)
    assert torch.autograd.gradcheck(attention_scan.AttentionDecodeScan.apply, args)


def test_missing_cotangents_count_as_zeros():
    """The loss reads s and c only: an unused alpha_seq (or c_seq) gives
    the same gradient as an explicit zero cotangent."""
    inputs = _scan_inputs(b=2, l=8, t=3, s=8, a=8, st=4, seed=3)
    args = [torch.from_numpy(x).requires_grad_(i != 2) for i, x in enumerate(inputs)]
    diff = [a for i, a in enumerate(args) if i != 2]
    s_seq, c_seq, alpha_seq = attention_scan.AttentionDecodeScan.apply(*args)
    got = torch.autograd.grad(s_seq.square().sum(), diff)
    s_seq, c_seq, alpha_seq = attention_scan.AttentionDecodeScan.apply(*args)
    want = torch.autograd.grad(s_seq.square().sum() + 0 * c_seq.sum() + 0 * alpha_seq.sum(),
                               diff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
