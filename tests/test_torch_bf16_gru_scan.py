"""bf16 GRU scans: the one-direction scan (K16, K17) and the
direction-stacked one (K18, K19) with bf16 inputs, and ``rnn.gru_layer``
on a bf16 layer, against the JAX package on the CPU.

The JAX kernels take bf16 inputs (``_fwd_kernel``, ``_bwd_kernel``,
``_bi_fwd_kernel``, ``_bi_bwd_kernel``; interpret mode here, as
tests/test_pallas.py runs them). The port's plain bf16 versions round
where they round. Each comparison is made twice, as
tests/test_torch_bf16_train.py makes it:

  - elementwise against JAX's bf16 result within ATOL_KERNEL (two bf16
    ulps at 1.0) times the array's largest magnitude, since the two
    packages sum in other orders, which can move a rounded operand by an
    ulp;
  - by the ground-truth rule (tests/test_pallas.py:694-720): the relative
    L2 distance from JAX's float32 result on the same bf16-valued inputs
    is at most 2 x JAX's bf16 distance + 0.02.

The exact twin of the backward entries (``bigru_scan_bwd_twin_bf16``, the
entries' three stages and order of sums) is held to the plain bf16
version by the same rule. The forward entries' exact twin is their plain
bf16 version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops import cells as jcells
from seq2seq_attention_asr_tpu.ops import rnn as jrnn
from seq2seq_attention_asr_tpu.ops.pallas import gru_scan as jgs
from seq2seq_attention_asr_tpu_torch.ops import rnn
from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan
from test_torch_bf16 import BF16, bf16_np, ground_truth_rule, to_j, to_t
from test_torch_bf16_train import close_scaled

B, L, H = 16, 11, 32  # L not a multiple of the stacked kernels' TBLK = 8


@pytest.fixture(scope="module")
def inputs():
    """bf16-valued numpy inputs of the stacked scan (direction 0 is the
    one-direction scan's), a nonzero h0 and a cotangent."""
    rng = np.random.RandomState(11)
    f = lambda *shape, scale=1.0: bf16_np(rng.randn(*shape) * scale)
    return {"xproj2": f(2, B, L, 3 * H, scale=0.7), "h02": f(2, B, H, scale=0.5),
            "wzr2": f(2, H, 2 * H, scale=0.3), "wh2": f(2, H, H, scale=0.3),
            "cot2": f(2, B, L, H)}


def _args(inputs, stacked):
    names = ("xproj2", "h02", "wzr2", "wh2", "cot2")
    return tuple(inputs[n] if stacked else inputs[n][0] for n in names)


_JAX = {}


def _jax_vjp(stacked, args, dtype):
    """The JAX kernel's outputs and cotangents, once per scan and type."""
    key = (stacked, jnp.dtype(dtype).name)
    if key not in _JAX:
        fn = jgs.bigru_scan if stacked else jgs.gru_scan
        ys, vjp = jax.vjp(lambda *a: fn(*a, True), *(to_j(a, dtype) for a in args[:4]))
        _JAX[key] = ys, vjp(to_j(args[4], dtype))
    return _JAX[key]


@pytest.mark.parametrize("stacked", [False, True], ids=["K16", "K18"])
def test_bf16_forward_plain_matches_pallas(inputs, stacked):
    args = _args(inputs, stacked)
    want, _ = _jax_vjp(stacked, args, jnp.bfloat16)
    truth, _ = _jax_vjp(stacked, args, jnp.float32)
    fn = gru_scan.bigru_scan if stacked else gru_scan.gru_scan
    got = fn(*map(to_t, args[:4]))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == want.shape
    close_scaled(got, want, "ys")
    ground_truth_rule(truth, got, want, "ys")


@pytest.mark.parametrize("stacked", [False, True], ids=["K17", "K19"])
def test_bf16_backward_plain_matches_pallas(inputs, stacked):
    """The autograd function's cotangents (the backward's plain bf16
    version on the saved bf16 outputs) against the JAX VJP with bf16
    inputs, each in its primal's type."""
    args = _args(inputs, stacked)
    _, want = _jax_vjp(stacked, args, jnp.bfloat16)
    _, truth = _jax_vjp(stacked, args, jnp.float32)
    fn = gru_scan.BiGRUScan.apply if stacked else gru_scan.GRUScan.apply
    targs = [to_t(a).requires_grad_(True) for a in args[:4]]
    got = torch.autograd.grad(fn(*targs), targs, to_t(args[4]))
    for g, w, t, name in zip(got, want, truth, ("dxproj", "dh0", "dwzr", "dwh")):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16, name
        close_scaled(g, w, name)
        ground_truth_rule(t, g, w, name)


@pytest.mark.parametrize("stacked", [False, True], ids=["K17", "K19"])
def test_bf16_backward_twin_by_the_ground_truth_rule(inputs, stacked):
    """The backward entries' exact twin (pre-pass, walk, one reduction)
    against the plain bf16 version, on the JAX forward's shifted bf16
    states: both within the ground-truth rule of the float32 plain
    version on the same values, and dh0 rounded from the same carry."""
    args = [to_t(a) for a in _args(inputs, stacked)]
    if not stacked:
        args = [a[None] for a in args]
    xproj2, h02, wzr2, wh2, cot2 = args
    ys = gru_scan.bigru_scan(xproj2, h02, wzr2, wh2)
    h_prevs = torch.cat([h02[:, :, None], ys[:, :, :-1]], dim=2)
    call = (xproj2, h_prevs, cot2, wzr2, wh2)
    plain = gru_scan.bigru_scan_bwd_plain(*call)
    twin = gru_scan.bigru_scan_bwd_twin_bf16(*call)
    truth = gru_scan.bigru_scan_bwd_plain(*(a.float() for a in call))
    for t, tw, p, name in zip(truth, twin, plain, ("dxproj", "dh0", "dwzr", "dwh")):
        assert tw.dtype == p.dtype == BF16
        ground_truth_rule(t, tw, p, name)
        close_scaled(tw, p, name)


@pytest.mark.parametrize("stacked", [False, True])
def test_float32_scans_are_the_float_plain_versions(inputs, stacked):
    """The float32 path is unchanged by the bf16 one: the plain versions on
    float32 inputs are the float loops, bit for bit."""
    args = [to_t(a, torch.float32) for a in _args(inputs, True)]
    xproj2, h02, wzr2, wh2, cot2 = args
    ys = gru_scan.bigru_scan(xproj2, h02, wzr2, wh2)
    torch.testing.assert_close(ys, gru_scan._stacked_fwd(xproj2, h02, wzr2, wh2), rtol=0, atol=0)
    h_prevs = torch.cat([h02[:, :, None], ys[:, :, :-1]], dim=2)
    got = gru_scan.bigru_scan_bwd(xproj2, h_prevs, cot2, wzr2, wh2)
    for g, w in zip(got, gru_scan._stacked_bwd(xproj2, h_prevs, cot2, wzr2, wh2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert g.dtype == torch.float32


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_gru_layer_matches_jax(reverse):
    """rnn.gru_layer on a bf16 layer and bf16 input (ragged lengths, a bf16
    h0) against JAX gru_layer(backend="pallas") on the same values in
    bf16: the output and the gradient of sum(y * w) for the weights, x and
    h0, each in bf16, by both comparisons."""
    jp = jax.tree.map(bf16_np, jcells.gru_init(jax.random.PRNGKey(4), 10, 32))
    rng = np.random.RandomState(5)
    x, w = bf16_np(rng.randn(4, 7, 10)), bf16_np(rng.randn(4, 7, 32))
    h0 = bf16_np(rng.randn(4, 32) * 0.5)
    lens = np.array([7, 4, 2, 6], np.int32)

    def jax_run(dtype):
        def fn(p, xx, hh):
            return jrnn.gru_layer(p, xx, jnp.asarray(lens), reverse=reverse, h0=hh,
                                  backend="pallas")
        p, xx, hh = jax.tree.map(lambda a: to_j(a, dtype), (jp, x, h0))
        ys, vjp = jax.vjp(fn, p, xx, hh)
        return ys, vjp(to_j(w, dtype))

    want, (wgp, wgx, wgh) = jax_run(jnp.bfloat16)
    truth, (tgp, tgx, tgh) = jax_run(jnp.float32)
    tp = {k: to_t(v).requires_grad_(True) for k, v in jp.items()}
    tx, th = to_t(x).requires_grad_(True), to_t(h0).requires_grad_(True)
    got = rnn.gru_layer(tp, tx, torch.from_numpy(lens), reverse=reverse, h0=th)
    assert got.dtype == BF16
    close_scaled(got.detach(), want, "ys")
    ground_truth_rule(truth, got.detach(), want, "ys")
    grads = torch.autograd.grad(got, [tp["w_zr"], tp["w_h"], tx, th], to_t(w))
    for g, wv, t, name in zip(grads, (wgp["w_zr"], wgp["w_h"], wgx, wgh),
                              (tgp["w_zr"], tgp["w_h"], tgx, tgh), ("w_zr", "w_h", "x", "h0")):
        assert g.dtype == BF16, name
        close_scaled(g, wv, name)
        ground_truth_rule(t, g, wv, name)
