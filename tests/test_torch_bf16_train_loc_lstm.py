"""bf16 training (compute_dtype="bfloat16") of conv_bilstm,
conv_bilstm_content and flagship_loc against the JAX package, on the CPU.

Their bf16 backwards are the plain bf16 versions of K9
(``lstm_scan.bilstm_scan_bwd_plain`` on the widened inputs) and of K11,
K15 and K13 (``attention_scan.attention_decode_scan_{loc_lstm,lstm,loc}
_bwd_plain_bf16``), at the rounding points of the JAX kernels with bf16
inputs (``lstm_scan._bwd_kernel``, ``_bwd_core``, ``_bwd_kernel_loc_lstm``,
``_bwd_kernel_loc``). The JAX side runs its Pallas kernels in interpret
mode (the models with rnn_backend and attn_backend "pallas"; the scans
with block_b = 16), at B = 16 and L = 16, the multiples of 16 its bf16
kernels take. Each comparison is made twice, as in
tests/test_torch_bf16_train.py:

  - elementwise against JAX's bf16 result, atol times the array's
    largest magnitude (at least 1): ATOL_KERNEL (1.6e-2, two bf16 ulps at
    1.0) for a kernel's backward, STEP_ATOL (0.05, the JAX package's own
    bar for a bf16 model against float32) for a train step's gradients;
  - by the ground-truth rule: the port's relative L2 distance from JAX's
    float32 result is at most 2 x JAX's bf16 distance + 0.02.

Each JAX twin is traced and run once per module (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops import rnn as jrnn
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jas
from seq2seq_attention_asr_tpu.ops.pallas import lstm_scan as jls
from seq2seq_attention_asr_tpu_torch.ops import cells, rnn
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, build, lstm_scan
from test_torch_bf16 import ATOL_KERNEL, BF16, as_np, bf16_np, ground_truth_rule, to_j, to_t
from test_torch_bf16_train import PALLAS, SMALL, _flagship_batch, _hold_step, close_scaled

B, L, T, S, A, ST, FM, F = 16, 16, 5, 24, 32, 16, 4, 5
H = 16  # the BiLSTM's width a direction


def _bilstm_inputs():
    rng = np.random.RandomState(0)
    xproj2 = bf16_np(rng.randn(2, B, L, 4 * H) * 0.7)
    wh2 = bf16_np(rng.randn(2, H, 4 * H) * 0.3)
    dys2 = bf16_np(rng.randn(2, B, L, H) * 0.5)
    return xproj2, wh2, dys2


@pytest.fixture(scope="module")
def bilstm_jax():
    """JAX's bilstm_scan VJP in interpret mode with bf16 xproj2 and wh2
    (float32 zero states and cotangent, as bilstm_layer gives them), and
    with float32 inputs (the truth): (hs, cs, grads) for bf16, grads for
    float32."""
    xproj2, wh2, dys2 = _bilstm_inputs()
    z = jnp.zeros((2, B, H), jnp.float32)

    def vjp(dtype):
        xs, ws = to_j(xproj2, dtype), to_j(wh2, dtype)
        hs, pull = jax.vjp(lambda x, w: jls.bilstm_scan(x, z, z, w, True), xs, ws)
        return hs, pull(jnp.asarray(dys2))

    (hs, (dx, dw)), (_, truth) = vjp(jnp.bfloat16), vjp(jnp.float32)
    _, cs = jls._run_fwd(to_j(xproj2), z, z, to_j(wh2), True)
    return np.asarray(hs), np.asarray(cs), (np.asarray(dx), np.asarray(dw)), truth


def test_bilstm_scan_bwd_bf16_matches_pallas(bilstm_jax):
    """K9's plain bf16 version (bilstm_scan_bwd on bf16 xproj2 and wh2)
    against bilstm_scan's VJP with bf16 inputs, both fed JAX's forward
    states: float32 dxproj2 and dwh2, as the JAX kernel writes them
    (lstm_scan.py:161-166), within the float32 backward's tolerance of
    tests/test_torch_decoder_scans.py (rtol 2e-4 at the array's scale);
    through BiLSTMScan, autograd rounds each once to bf16."""
    hs, cs, (jdx, jdw), truth = bilstm_jax
    xproj2, wh2, dys2 = _bilstm_inputs()
    assert jdx.dtype == jdw.dtype == np.float32  # JAX hands the bf16 primals float32 cotangents
    zeros = torch.zeros(2, B, 1, H)
    h_prev = torch.cat([zeros, torch.from_numpy(hs)[:, :, :-1]], dim=2)
    c_prev = torch.cat([zeros, torch.from_numpy(cs)[:, :, :-1]], dim=2)
    dx, _, _, dw = lstm_scan.bilstm_scan_bwd(to_t(xproj2), h_prev, c_prev,
                                             torch.from_numpy(dys2), to_t(wh2))
    assert dx.dtype == dw.dtype == torch.float32
    for g, w, t, name in ((dx, jdx, truth[0], "dxproj2"), (dw, jdw, truth[1], "dwh2")):
        close_scaled(g, w, f"K9 {name}", 2e-4)
        ground_truth_rule(t, g, w, f"K9 {name}")
    # The autograd function: bf16 cotangents, each round(float32 cotangent).
    x, w = to_t(xproj2).requires_grad_(), to_t(wh2).requires_grad_()
    zero = torch.zeros(2, B, H)
    out = lstm_scan.BiLSTMScan.apply(x, zero, zero, w)
    gx, gw = torch.autograd.grad(out, (x, w), torch.from_numpy(dys2))
    assert gx.dtype == gw.dtype == BF16
    fwd_h, fwd_c = lstm_scan.bilstm_scan(x.detach(), zero, zero, w.detach())
    dx_own, _, _, dw_own = lstm_scan.bilstm_scan_bwd(
        x.detach(), torch.cat([zeros, fwd_h[:, :, :-1]], 2), torch.cat([zeros, fwd_c[:, :, :-1]], 2),
        torch.from_numpy(dys2), w.detach())
    torch.testing.assert_close(gx, dx_own.to(BF16), rtol=0, atol=0)
    torch.testing.assert_close(gw, dw_own.to(BF16), rtol=0, atol=0)


def test_bilstm_layer_bf16_gradient_of_x_rounds_the_cotangent(bilstm_jax):
    """Trap 6's pin: the bf16 gradient of a BiLSTM layer's input is the
    input projections' transposed products of round_bf16(dxproj2), K9's
    float32 cotangent rounded once (autograd's cast at BiLSTMScan), which
    is where the JAX package rounds it too: the port's gradient of x
    matches jax.grad of bilstm_layer(backend="pallas") in bf16 within
    ATOL_KERNEL at its scale, and the float32 truth by the ground-truth
    rule."""
    rng = np.random.RandomState(1)
    b, l, i = 16, 8, 12
    lens = np.array([8, 5, 8, 3] * 4)
    x = bf16_np(rng.randn(b, l, i))
    jp = jrnn.bilstm_init(jax.random.PRNGKey(0), i, H)
    params = jax.tree.map(bf16_np, jp)
    cot = bf16_np(rng.randn(b, l, 2 * H))

    def jgrad(dtype, backend):
        p = jax.tree.map(lambda a: to_j(a, dtype), params)
        f = lambda xx: jnp.sum(jrnn.bilstm_layer(p, xx, jnp.asarray(lens), backend=backend)
                               .astype(jnp.float32) * cot)
        return jax.grad(f)(to_j(x, dtype))

    # The float32 truth on JAX's XLA path, which compiles in a fraction of the time.
    want, truth = jgrad(jnp.bfloat16, "pallas"), jgrad(jnp.float32, "xla")
    tp = {d: {k: to_t(v) for k, v in params[d].items()} for d in params}
    tx = to_t(x).requires_grad_()
    ys = rnn.bilstm_layer(tp, tx, torch.from_numpy(lens))
    (got,) = torch.autograd.grad(ys, tx, to_t(cot))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    close_scaled(got, want, "d x", ATOL_KERNEL)
    ground_truth_rule(truth, got, want, "d x")
    # The same gradient by hand: K9's float32 cotangent, rounded once, then
    # the projections' transposed products in bf16.
    xd = tx.detach().requires_grad_()
    xproj2 = torch.stack([cells.lstm_input_proj(tp["fwd"], xd),
                          cells.lstm_input_proj(tp["bwd"], rnn._flip(xd, torch.from_numpy(lens)))])
    zeros = torch.zeros(2, b, H)
    wh2 = torch.stack([tp["fwd"]["w_h"], tp["bwd"]["w_h"]])
    hs, cs = lstm_scan.bilstm_scan(xproj2.detach(), zeros, zeros, wh2)
    z1 = torch.zeros(2, b, 1, H)
    dys = torch.stack([to_t(cot).float()[..., :H],
                       rnn._flip(to_t(cot).float()[..., H:], torch.from_numpy(lens))])
    dx2 = lstm_scan.bilstm_scan_bwd(xproj2.detach(), torch.cat([z1, hs[:, :, :-1]], 2),
                                    torch.cat([z1, cs[:, :, :-1]], 2), dys, wh2)[0]
    assert dx2.dtype == torch.float32
    (by_hand,) = torch.autograd.grad(xproj2, xd, build.round_bf16(dx2).to(BF16))
    torch.testing.assert_close(got, by_hand, rtol=0, atol=0)


def _scan_inputs(cell, fm, seed=0):
    """(vh, h, mask, yin, weights) with bf16 values (float32 numpy), the
    weights as the port keeps them (tests/test_torch_decoder_scans.py's
    layout), ragged encoder lengths."""
    rng = np.random.RandomState(seed)
    lens = np.array([L, L - 3, 5, L, 9, L - 7, 12, L] * 2)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    h = rng.randn(B, L, A) * 0.5 * mask[:, :, None]
    u = lambda *shape: rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
    vh = h @ u(A, S)
    yin = rng.randn(B, T, ST) * 0.5
    weights = [u(ST, S), u(ST, S)[0], u(S, S)[0], u(A, ST), u(A, ST)[0], u(2 * ST, ST),
               u(2 * ST, ST)[0]]
    weights += ([u(2 * ST, 2 * ST), u(2 * ST, ST)] if cell == "gru"
                else [u(ST, 4 * ST), u(ST, 4 * ST), u(ST, 4 * ST)[0]])
    if fm:
        weights += [rng.uniform(-1, 1, (F, fm)) * 2, u(fm, fm)[0], u(fm, S)]
    ins = [bf16_np(a) for a in (vh, h)] + [mask, bf16_np(yin)]
    return ins, [bf16_np(w) for w in weights]


def _jax_weights(weights, cell, dtype):
    """The JAX kernel's weight arguments: (1, X) biases and w_e; the LSTM's
    concat([w_h, w_x]) and its bias row; (1, FM) bconv."""
    w = [to_j(x, dtype) for x in weights]
    out = [w[0], w[1][None], w[2][None], w[3], w[4][None], w[5], w[6][None]]
    if cell == "gru":
        out += w[7:9]
        loc = w[9:]
    else:
        out += [jnp.concatenate([w[7], w[8]]), w[9][None]]
        loc = w[10:]
    if loc:
        out += [loc[0], loc[1][None], loc[2]]
    return out


def _port_grads(jgrads, cell):
    """JAX's weight gradients in the port's layout (1-D biases, w_h and
    w_x split from the LSTM's concatenated kernel)."""
    g = [np.asarray(x, np.float32) for x in jgrads]
    out = [g[0], g[1][0], g[2][0], g[3], g[4][0], g[5], g[6][0]]
    out += g[7:9] if cell == "gru" else [g[7][:ST], g[7][ST:], g[8][0]]
    if g[9:]:
        out += [g[9], g[10][0], g[11]]
    return out


# name: (cell, feature maps, JAX scan, the port's autograd function, backward,
# plain bf16 version, exact twin, weight names)
DECODERS = {
    "loc_lstm": ("lstm", FM, jas.attention_decode_scan_loc_lstm,
                 attention_scan.AttentionDecodeScanLocLSTM,
                 attention_scan.attention_decode_scan_loc_lstm_bwd,
                 attention_scan.attention_decode_scan_loc_lstm_bwd_plain_bf16,
                 attention_scan.attention_decode_scan_loc_lstm_bwd_twin_bf16,
                 attention_scan.WEIGHTS_LOC_LSTM),
    "loc": ("gru", FM, jas.attention_decode_scan_loc, attention_scan.AttentionDecodeScanLoc,
            attention_scan.attention_decode_scan_loc_bwd,
            attention_scan.attention_decode_scan_loc_bwd_plain_bf16,
            attention_scan.attention_decode_scan_loc_bwd_twin_bf16, attention_scan.WEIGHTS_LOC),
    "lstm": ("lstm", 0, jas.attention_decode_scan_lstm, attention_scan.AttentionDecodeScanLSTM,
             attention_scan.attention_decode_scan_lstm_bwd,
             attention_scan.attention_decode_scan_lstm_bwd_plain_bf16,
             attention_scan.attention_decode_scan_lstm_bwd_twin_bf16,
             attention_scan.WEIGHTS_LSTM),
}


def _cotangents(cell):
    rng = np.random.RandomState(7)
    shapes = [(B, T, ST), (B, T, A), (B, T, L)] + ([(B, T, ST)] if cell == "lstm" else [])
    return [bf16_np(rng.randn(*s) * 0.3) for s in shapes]


@pytest.fixture(scope="module")
def decoder_jax():
    """Per decoder: JAX's VJP in interpret mode of its own bf16 forward
    (the gradients of vh, h, yin and the weights in the port's layout),
    and of its float32 one (the truth), computed once."""
    out = {}
    for name, (cell, fm, jscan, *_rest) in DECODERS.items():
        ins, weights = _scan_inputs(cell, fm)
        cots = _cotangents(cell)

        def vjp(dtype):
            jw = _jax_weights(weights, cell, dtype)
            mask = to_j(ins[2], dtype)
            _, pull = jax.vjp(lambda vh, h, yin, *w: jscan(vh, h, mask, yin, *w, 16, True),
                              to_j(ins[0], dtype), to_j(ins[1], dtype), to_j(ins[3], dtype), *jw)
            g = pull(tuple(to_j(c, dtype) for c in cots))
            return [np.asarray(x, np.float32) for x in g[:3]] + _port_grads(g[3:], cell), \
                [x.dtype for x in g]

        (want, dtypes), (truth, _) = vjp(jnp.bfloat16), vjp(jnp.float32)
        assert set(dtypes) == {jnp.dtype(jnp.bfloat16)}
        out[name] = (want, truth)
    return out


def _port_scan(name):
    """The port's bf16 forward through the decoder's autograd function,
    its saved tensors (the forward's float32 alpha and c among them) and
    its gradients for the module's cotangents."""
    cell, fm, _, fn, *_ = DECODERS[name]
    ins, weights = _scan_inputs(cell, fm)
    vh, h, yin = (to_t(a).requires_grad_() for a in (ins[0], ins[1], ins[3]))
    tw = [to_t(w).requires_grad_() for w in weights]
    outs = fn.apply(vh, h, to_t(ins[2]), yin, *tw)
    assert all(o.dtype == BF16 for o in outs)
    saved = outs[0].grad_fn.saved_tensors
    cots = [to_t(c) for c in _cotangents(cell)]
    grads = torch.autograd.grad(outs, [vh, h, yin] + tw, cots)
    n_out = len(outs)
    seqs, c32 = [t.detach() for t in saved[-1 - n_out:-1]], saved[-1]
    return (vh.detach(), h.detach(), to_t(ins[2]), yin.detach()), [w.detach() for w in tw], \
        [o.detach() for o in outs], seqs, c32, cots, grads


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_bwd_plain_bf16_matches_pallas(decoder_jax, name):
    """K11's, K13's and K15's plain bf16 versions against the JAX VJPs
    with bf16 inputs (attention_scan.py:1292-1356, :984-1046, :1226-1290
    of the JAX package, interpret mode), each from its own package's bf16
    forward; the exact twins (the softmax's sum as the entries form it)
    by the same bars. The autograd function saves the forward's float32
    alpha (not the rounded alpha_seq) and c, its gradients are the plain
    version's, and the wrapper on CPU tensors is the plain version."""
    cell, fm, _, _, bwd, plain_fn, twin_fn, names = DECODERS[name]
    want, truth = decoder_jax[name]
    ins, tw, outs, seqs, c32, cots, grads = _port_scan(name)
    alpha32 = seqs[2]
    assert alpha32.dtype == c32.dtype == torch.float32
    torch.testing.assert_close(alpha32.to(BF16), outs[2], rtol=0, atol=0)
    plain = plain_fn(*ins, *tw, *seqs, *cots)
    twin = twin_fn(*ins, *tw, *seqs, *cots, c32)
    labels = ("dvh", "dh", "dyin") + names
    assert len(plain) == len(want) == len(labels)
    for g, tg, w, t, label in zip(plain, twin, want, truth, labels):
        assert g.dtype == tg.dtype == BF16
        close_scaled(g, w, f"{name} {label}")
        ground_truth_rule(t, g, w, f"{name} {label}")
        close_scaled(tg, w, f"{name}'s twin {label}")
        ground_truth_rule(t, tg, w, f"{name}'s twin {label}")
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    for g, p in zip(bwd(*ins, *tw, *seqs, *cots, c32=c32), plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32 alpha"):
        bwd(*ins, *tw, *seqs[:2], alpha32.to(BF16), *seqs[3:], *cots, c32=c32)


def _rel_l2(got, want):
    w = as_np(want)
    return float(np.linalg.norm(as_np(got) - w)) / max(float(np.linalg.norm(w)), 1e-9)


@pytest.mark.parametrize("name", ["loc_lstm", "loc"])
def test_location_backward_reads_the_rounded_alpha_prev(decoder_jax, name):
    """Trap 1's pin: the location term's alpha_prev is the rounded alpha
    (the bf16 alpha_seq JAX's backward reads), the step's alpha the
    forward's float32 one. Fed the unrounded alpha32 as alpha_prev
    instead, the plain bf16 version never leaves ATOL_KERNEL (a rounding
    of alpha_prev moves each value by well under two ulps), so the pin is
    the distance: U's gradient lands at least twice as far from JAX's (in
    relative L2; measured at this size 3.2e-3 rounded against 1.2e-2
    unrounded for K11, 1.9e-3 against 5.7e-3 for K13)."""
    cell, fm, _, _, _, _, _, names = DECODERS[name]
    want, _ = decoder_jax[name]
    ins, tw, _, seqs, _, cots, _ = _port_scan(name)
    args = (*tw, *seqs, *cots)
    good = attention_scan._bwd_plain_bf16(*ins, args, len(names), cell == "lstm")
    bad = attention_scan._bwd_plain_bf16(*ins, args, len(names), cell == "lstm", aprev=seqs[2])
    for g, b, w in zip(good, bad, want):
        close_scaled(g, w, name)
        close_scaled(b, w, name)
    assert _rel_l2(bad[-1], want[-1]) >= 2 * _rel_l2(good[-1], want[-1])


CONV_SMALL = dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=8, score_depth=12,
                  state_depth=16, output_depth=7)


def _conv_batch(seed=0):
    """16 utterances of up to 144 frames (L' = 16 after the conv stack)."""
    rng = np.random.RandomState(seed)
    b, t, v = 16, 5, CONV_SMALL["output_depth"]
    x = rng.randn(b, 144, CONV_SMALL["input_frame_size"]).astype(np.float32)
    x_len = np.array([144, 120, 144, 97] * 4, np.int32)
    y = rng.randint(0, v, (b, t)).astype(np.int32)
    dm = (np.arange(t)[None] < np.array([5, 4, 5, 2] * 4)[:, None]).astype(np.float32)
    return x, x_len, y, dm


STEPS = {
    "conv_bilstm": (lambda m: m.timit_conv_bilstm(), {**CONV_SMALL, "feature_maps": 4},
                    _conv_batch),
    "conv_bilstm_penalty": (lambda m: m.timit_conv_bilstm(),
                            {**CONV_SMALL, "feature_maps": 4, "penalty_lambda": 0.5},
                            _conv_batch),
    "conv_bilstm_content": (lambda m: m.timit_conv_bilstm(), {**CONV_SMALL, "feature_maps": 0},
                            _conv_batch),
    "flagship_loc": (lambda m: m.timit_chorowski_normnll_colnorm(), {**SMALL, "feature_maps": 4},
                     _flagship_batch),
    "flagship_loc_penalty": (lambda m: m.timit_chorowski_dropout(),
                             {**SMALL, "feature_maps": 4, "penalty_lambda": 0.5},
                             _flagship_batch),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_bf16_train_step_matches_jax(monkeypatch, case):
    """One bf16 train step of each small model (K7, K9, K10/K14 and
    K11/K15, or K1, K6, K12 and K13, by their plain bf16 versions), JAX's
    draws swapped in: the loss and every gradient leaf the optimizer
    receives, against JAX's bf16 step on its Pallas kernels (STEP_ATOL at
    scale) and by the ground-truth rule against JAX's float32 step.
    conv_bilstm and flagship_loc (with dropout) also with the monotonic
    penalty, whose ramp reaches the backward as an alpha cotangent."""
    recipe, kwargs, batch = STEPS[case]
    _hold_step(monkeypatch, recipe, kwargs, PALLAS, {}, batch())

