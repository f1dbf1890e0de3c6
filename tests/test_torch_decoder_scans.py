"""The port's location-aware GRU decoder scan (kernels K12 and K13) and
content-only LSTM decoder scan (kernels K14 and K15) against the JAX
package on the CPU: their plain versions against the Pallas kernels in
interpret mode (called directly with block_b=8, B = 8 and L a multiple of
8) and against autograd, their autograd functions against finite
differences and with missing cotangents, and decode_teacher_forced of
both decoders against the JAX package's through its Pallas scans.

Tolerances: the scan forward rtol 1e-4 (atol 1e-5) and its backward rtol
2e-4 (atol 2e-5), as tests/test_torch_location.py holds K10 and K11
(sums over steps and rows taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jas
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

B, L, T, S, A, ST, FM = 8, 16, 6, 32, 24, 16, 4
FWD, BWD = (1e-4, 1e-5), (2e-4, 2e-5)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want).reshape(np.shape(got)),
                               rtol=tol[0], atol=tol[1], err_msg=msg)


def _inputs(cell, fm, f=5, dtype=np.float32, b=B, l=L, t=T, s=S, a=A, st=ST, seed=0):
    """(vh, h, enc_mask, yin, weights) with ragged encoder lengths; the
    weights as the port keeps them: 1-D biases and w_e, the GRU's w_zr
    and w_h or the LSTM's w_h, w_x and b, then with fm > 0 the conv taps
    (f, FM), their bias and U."""
    rng = np.random.RandomState(seed)
    lens = np.array([l, l - 3, 5, l, 1, l - 7, 9, l][:b])
    mask = (np.arange(l)[None] < lens[:, None]).astype(dtype)
    h = rng.randn(b, l, a) * 0.5 * mask[:, :, None]
    u = lambda *shape: rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
    vh = h @ u(a, s)
    yin = rng.randn(b, t, st) * 0.5
    weights = [u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0]]
    weights += ([u(2 * st, 2 * st), u(2 * st, st)] if cell == "gru"
                else [u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0]])
    if fm:
        weights += [rng.uniform(-1, 1, (f, fm)) * 2, u(fm, fm)[0], u(fm, s)]
    return [np.asarray(x, dtype) for x in (vh, h, mask, yin, *weights)]


def _jax_args(inputs, cell):
    """The JAX kernel's arguments: (1, X) biases and w_e; the GRU's w_zr
    and w_h, or the LSTM's concat([w_h, w_x]) and its bias row; then
    (wconv, (1, FM) bconv, u) with the location term."""
    x = list(map(jnp.asarray, inputs))
    vh, h, mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b = x[:11]
    out = [vh, h, mask, yin, ws_w, ws_b[None], w_e[None], c_w, c_b[None], dec_w, dec_b[None]]
    if cell == "gru":
        out += x[11:13]
        loc = x[13:]
    else:
        out += [jnp.concatenate([x[11], x[12]]), x[13][None]]
        loc = x[14:]
    if loc:
        out += [loc[0], loc[1][None], loc[2]]
    return out


# (cell, feature maps): the port's forward and backward, the forward's
# plain twin, and the autograd function.
SCANS = {
    ("gru", FM): (attention_scan.attention_decode_scan_loc,
                  attention_scan.attention_decode_scan_loc_bwd,
                  attention_scan.attention_decode_scan_loc_plain,
                  attention_scan.AttentionDecodeScanLoc),
    ("lstm", 0): (attention_scan.attention_decode_scan_lstm,
                  attention_scan.attention_decode_scan_lstm_bwd,
                  attention_scan.attention_decode_scan_lstm_plain,
                  attention_scan.AttentionDecodeScanLSTM),
}


@pytest.mark.parametrize("cell,fm,filt", [("gru", FM, 5), ("gru", FM, 4), ("lstm", 0, 5)])
def test_scan_plain_matches_pallas(cell, fm, filt):
    """K12's plain version against attention_decode_scan_loc, filter 5
    (padding 2 and 2) and 4 (2 and 1); K14's against
    attention_decode_scan_lstm."""
    inputs = _inputs(cell, fm, f=filt)
    jargs = _jax_args(inputs, cell)
    want = (jas.attention_decode_scan_loc(*jargs, 8, True) if fm
            else jas.attention_decode_scan_lstm(*jargs, 8, True))
    got = SCANS[(cell, fm)][0](*map(torch.from_numpy, inputs))
    assert len(got) == len(want) == (3 if cell == "gru" else 4)
    for name, g, w in zip(("s_seq", "c_seq", "alpha_seq", "mem_seq"), got, want):
        close(g, w, FWD, name)
    assert not got[2].numpy()[np.broadcast_to(inputs[2][:, None] == 0, got[2].shape)].any()


def _grad_names(cell, fm):
    names = attention_scan.WEIGHTS_LOC if fm else attention_scan.WEIGHTS_LSTM
    assert (cell == "gru") == (fm > 0)
    return ("dvh", "dh", "dyin") + names


def _pallas_bwd(inputs, cell, fm, cot):
    """The Pallas backward in interpret mode on the Pallas forward's saved
    sequences: _run_bwd_loc for the location-aware GRU, _run_bwd for the
    content-only LSTM (its cell-weight gradient split as the port keeps
    the weights). Returns (saved, grads)."""
    jargs = _jax_args(inputs, cell)
    jcot = list(map(jnp.asarray, cot))
    if fm:
        saved = jas.attention_decode_scan_loc(*jargs, 8, True)
        want = list(jas._run_bwd_loc(*jargs, *saved, *jcot, 8, True))
    else:
        saved = jas.attention_decode_scan_lstm(*jargs, 8, True)
        s_seq, c_seq, _, mem_seq = saved
        want = list(jas._run_bwd(*jargs, s_seq, c_seq, *jcot[:3], 8, True, cell="lstm",
                                 mem_seq=mem_seq, dmem_seq=jcot[3]))
        dcell_w1, dcell_w2 = np.asarray(want[10]), np.asarray(want[11])
        want[10:12] = [dcell_w1[:ST], dcell_w1[ST:], dcell_w2[0]]
    return [torch.tensor(np.asarray(x)) for x in saved], want


@pytest.mark.parametrize("cell,fm,filt,reference", [
    ("gru", FM, 5, "pallas_interpret"), ("gru", FM, 4, "pallas_interpret"),
    ("gru", FM, 5, "torch_autograd"), ("lstm", 0, 5, "pallas_interpret"),
    ("lstm", 0, 5, "torch_autograd")])
def test_scan_bwd_plain_matches(cell, fm, filt, reference):
    """K13's and K15's plain versions with nonzero cotangents on every
    output (alpha's runs the cross-step carry through the location term),
    against the Pallas backward in interpret mode and against autograd
    through the plain forward."""
    inputs = _inputs(cell, fm, f=filt, seed=1)
    rng = np.random.RandomState(2)
    widths = (ST, A, L, ST)[:3 if cell == "gru" else 4]
    cot = [rng.randn(B, T, n).astype(np.float32) for n in widths]
    tin = list(map(torch.from_numpy, inputs))
    fwd, bwd, plain, _ = SCANS[(cell, fm)]
    if reference == "pallas_interpret":
        saved, want = _pallas_bwd(inputs, cell, fm, cot)
    else:
        args = [x.clone().requires_grad_(i != 2) for i, x in enumerate(tin)]
        outs = plain(*args)
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
        want = torch.autograd.grad(loss, [a for i, a in enumerate(args) if i != 2])
        saved = [o.detach() for o in outs]
    got = bwd(*tin, *saved, *map(torch.from_numpy, cot))
    names = _grad_names(cell, fm)
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        close(g, np.asarray(w), BWD, name)


@pytest.mark.parametrize("cell,fm", [("gru", 2), ("lstm", 0)])
def test_scan_autograd_function_passes_gradcheck(cell, fm):
    inputs = _inputs(cell, fm, dtype=np.float64, b=2, l=5, t=3, s=4, a=3, st=2, f=4, seed=3)
    args = [torch.from_numpy(x) for x in inputs]
    for i, x in enumerate(args):
        if i != 2:  # enc_mask takes no gradient
            x.requires_grad_(True)
    fn = SCANS[(cell, FM if fm else 0)][3]
    assert torch.autograd.gradcheck(fn.apply, args)


@pytest.mark.parametrize("cell,fm", [("gru", 3), ("lstm", 0)])
def test_scan_missing_cotangents_count_as_zeros(cell, fm):
    """The training loss reads s and c only: the unused alpha_seq (and the
    LSTM's mem_seq) reach the backward as None and give the gradient of
    explicit zero cotangents."""
    inputs = _inputs(cell, fm, b=2, l=8, t=3, s=8, a=8, st=4, seed=4)
    args = [torch.from_numpy(x).requires_grad_(i != 2) for i, x in enumerate(inputs)]
    diff = [a for i, a in enumerate(args) if i != 2]
    fn = SCANS[(cell, FM if fm else 0)][3]
    outs = fn.apply(*args)
    got = torch.autograd.grad(outs[0].square().sum() + outs[1].sum(), diff)
    outs = fn.apply(*args)
    want = torch.autograd.grad(outs[0].square().sum() + outs[1].sum()
                               + sum(0 * o.sum() for o in outs[2:]), diff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


MAXOUT = (("maxout", 8, 3), ("linear", 6))
LIN_RELU = (("linear", 12), ("relu",), ("linear", 6))
ENC_LENS = [16, 11, 5, 16, 1, 9, 13, 16]
LABEL_LENS = [6, 3, 6, 1, 5, 6, 2, 4]


def _objective(out, oh, dm):
    nll = -(oh * out["logprobs"] * dm[..., None]).sum()
    return nll + 0.1 * (out["alpha"] ** 2).sum()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cell,fm", [("gru", 4), ("lstm", 0)])
def test_decode_teacher_forced_matches_jax(cell, fm, train):
    """The location-aware GRU decoder (filter 10, as the flagship's
    recipe) and the content-only LSTM decoder: outputs and the gradient
    of an objective that reads logprobs and alpha, with respect to every
    weight and h, against JAX's decode_teacher_forced through its Pallas
    scans in interpret mode (B = 8 and L = 16 pass its supported() gate)."""
    kw = dict(score_depth=16, filt_size=10, feature_maps=fm, state_depth=16, annotation_depth=24,
              output_depth=6, cell=cell, mono_align=False, penalty_lambda=0.0,
              readout=MAXOUT if cell == "gru" else LIN_RELU)
    jcfg, cfg = jatt.AttentionConfig(**kw), attention.AttentionConfig(**kw)
    params = jatt.attention_init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(6)
    lens = np.asarray(ENC_LENS)
    h = (rng.randn(B, L, 24) * 0.5).astype(np.float32)
    dm = (np.arange(T)[None] < np.asarray(LABEL_LENS)[:, None]).astype(np.float32)
    oh = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (B, T))] * dm[..., None]

    def jloss_fn(p, hh):
        out = jatt.decode_teacher_forced(p, jcfg, hh, jnp.asarray(lens), jnp.asarray(oh),
                                         jnp.asarray(dm), train=train, backend="pallas")
        return _objective(out, oh, dm), out

    (_, want), (wgp, wgh) = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(h))
    tp = jax.tree.map(lambda t: t.requires_grad_(True),
                      interop.to_torch(jax.tree.map(np.asarray, params), "cpu"))
    th = torch.from_numpy(h).requires_grad_(True)
    got = attention.decode_teacher_forced(tp, cfg, th, torch.from_numpy(lens),
                                          torch.from_numpy(oh), torch.from_numpy(dm), train=train)
    for key in ("logprobs", "alpha", "penalty"):
        close(got[key].detach(), want[key], FWD, key)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                leaves + [th])
    close(grads[-1], wgh, BWD, "h")
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(wgp)]
    assert len(paths) == len(leaves)
    for path, g, w in zip(paths, grads[:-1], jax.tree.leaves(wgp)):
        close(g, w, BWD, path)
