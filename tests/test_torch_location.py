"""The port's location-aware attention and LSTM decoder against the JAX
package on the CPU: the location term, the plain step, the plain
version of the beam step (kernel K8's twin) against the Pallas kernel in
interpret mode, and the beam search; the plain versions of the
location-aware LSTM decoder scan (kernels K10 and K11) against the
Pallas kernels in interpret mode (called directly with block_b=8, B = 8
and L a multiple of 8) and autograd, and its autograd function against
finite differences; and what the teacher-forced scan still refuses (LSTM
peepholes, and the monotonic penalty in training).

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance (tests/test_pallas.py); beam tokens and lengths
identical, scores rtol 1e-5; the scan forward rtol 1e-4 (atol 1e-5) and
its backward rtol 2e-4 (atol 2e-5), as tests/test_torch_train_kernels.py
holds K4 and K5 (sums over steps and rows taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jas
from seq2seq_attention_asr_tpu.ops.pallas import attention_step as jstep
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, attention_step

RTOL, ATOL = 2e-5, 2e-6
MAXOUT = (("maxout", 8, 3), ("linear", 6))
LIN_RELU = (("linear", 12), ("relu",), ("linear", 6))


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def configs(cell, fm, readout=MAXOUT, filt=5, s=16, st=16, a=24):
    """The same decoder as a JAX and a port AttentionConfig."""
    kw = dict(score_depth=s, filt_size=filt, feature_maps=fm, state_depth=st, annotation_depth=a,
              output_depth=6, cell=cell, mono_align=False, penalty_lambda=0.0, readout=readout)
    return jatt.AttentionConfig(**kw), attention.AttentionConfig(**kw)


@pytest.mark.parametrize("filt", [5, 10])
def test_location_features(filt):
    """f=5 pads 2 and 2, f=10 pads 5 on the left and 4 on the right."""
    jcfg, cfg = configs("gru", 6, filt=filt)
    params = jatt.attention_init(jax.random.PRNGKey(filt), jcfg)
    alpha = np.random.RandomState(filt).rand(3, 11).astype(np.float32)
    want = jatt.location_features(params, jcfg, jnp.asarray(alpha))
    got = attention.location_features(port(params), cfg, torch.from_numpy(alpha))
    assert got.shape == (3, 11, 16)
    close(got, want)
    assert attention.conv_pads(filt) == ((2, 2) if filt == 5 else (5, 4))


def _step_inputs(b, l, st, a, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, l + 1, b)
    lens[0] = l
    return dict(
        h=rng.randn(b, l, a).astype(np.float32),
        alpha=rng.dirichlet(np.ones(l), b).astype(np.float32),
        s=(rng.randn(b, st) * 0.3).astype(np.float32),
        mem=(rng.randn(b, st) * 0.3).astype(np.float32),
        y=np.eye(6, dtype=np.float32)[rng.randint(0, 6, b)],
        mask=(np.arange(l)[None] < lens[:, None]).astype(np.float32),
    )


@pytest.mark.parametrize("fm", [0, 6])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_attention_step(cell, fm):
    jcfg, cfg = configs(cell, fm)
    params = jatt.attention_init(jax.random.PRNGKey(1), jcfg)
    d = _step_inputs(4, 10, 16, 24, 2)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    vh = jatt.precompute_vh(params, j["h"])
    (wa, ws, wm), want = jatt.attention_step(params, jcfg, (j["alpha"], j["s"], j["mem"]), j["y"],
                                             vh, j["h"], j["mask"], ramp=None)
    tp = port(params)
    (ga, gs, gm), got = attention.attention_step(tp, cfg, (t["alpha"], t["s"], t["mem"]), t["y"],
                                                 attention.precompute_vh(tp, t["h"]), t["h"],
                                                 t["mask"])
    for key in ("alpha", "s", "c"):
        close(got[key], want[key])
    close(ga, wa)
    close(gm, wm)
    if cell == "gru":
        assert gm is t["mem"]


@pytest.mark.parametrize("cell,fm,readout", [("gru", 3, MAXOUT), ("lstm", 0, LIN_RELU),
                                             ("lstm", 6, LIN_RELU)])
def test_fused_attention_step_plain_matches_pallas(cell, fm, readout):
    """K8's plain version against the Pallas step kernel (interpret
    mode, readout fused) at B=4, K=3, L=16."""
    jcfg, cfg = configs(cell, fm, readout)
    params = jatt.attention_init(jax.random.PRNGKey(3), jcfg)
    b, k, l = 4, 3, 16
    rng = np.random.RandomState(4)
    h = rng.randn(b, l, 24).astype(np.float32)
    lens = np.array([16, 9, 12, 5])
    mask = (np.arange(l)[None] < lens[:, None]).astype(np.float32)
    alpha0 = rng.dirichlet(np.ones(l), (b, k)).astype(np.float32)
    s0 = (rng.randn(b, k, 16) * 0.3).astype(np.float32)
    mem0 = (rng.randn(b, k, 16) * 0.3).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (b, k))]
    vh = jatt.precompute_vh(params, jnp.asarray(h))
    (wa, ws, wm), want = jstep.fused_attention_step(
        params, jcfg, tuple(map(jnp.asarray, (alpha0, s0, mem0))), jnp.asarray(y), vh,
        jnp.asarray(h), jnp.asarray(mask), with_readout=True, interpret=True)
    tp = port(params)
    th = torch.from_numpy(h)
    (ga, gs, gm), got = attention_step.fused_attention_step(
        tp, cfg, tuple(map(torch.from_numpy, (alpha0, s0, mem0))), torch.from_numpy(y),
        attention.precompute_vh(tp, th), th, torch.from_numpy(mask))
    for key in ("alpha", "s", "c", "logp"):
        close(got[key], want[key])
    close(ga, wa)
    close(gs, ws)
    close(gm, wm)
    assert not attention_step.uses_k2(cfg)


def test_beam_search_lstm_location_matches_jax():
    """The conv+BiLSTM decoder's beam (LSTM cell, 6 feature maps): the
    port's beam against the JAX beam through its Pallas step kernel."""
    jcfg, cfg = configs("lstm", 6, LIN_RELU)
    params = jatt.attention_init(jax.random.PRNGKey(0), jcfg)
    b, l = 8, 16
    rng = np.random.RandomState(1)
    lens = np.array([16, 9, 12, 5, 8, 16, 11, 13])
    h = (rng.randn(b, l, 24) * 0.5 * (np.arange(l)[None, :, None] < lens[:, None, None]))
    h = h.astype(np.float32)
    # Weights scaled by 3 so that the picks vary from step to step.
    params = jax.tree.map(lambda x: 3 * np.asarray(x), params)
    want = jbeam.beam_search(params, jcfg, jnp.asarray(h), jnp.asarray(lens), 2, k=3,
                             max_steps=jnp.asarray(lens), max_steps_cap=l, backend="pallas")
    got = beam.beam_search(port(params), cfg, torch.from_numpy(h), torch.from_numpy(lens), 2,
                           k=3, max_steps=torch.from_numpy(lens), max_steps_cap=l, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)
    assert len(set(got.lengths.tolist())) > 1


# The location-aware LSTM decoder scan: B = 8 and L = 16 make JAX's
# kernel run as the kernel.
B, L, T, S, A, ST, FM = 8, 16, 6, 32, 24, 16, 4


def _loc_scan_inputs(dtype=np.float32, b=B, l=L, t=T, s=S, a=A, st=ST, fm=FM, f=5,
                     seed=0):
    """(vh, h, enc_mask, yin, 13 weights) with ragged encoder lengths; the
    weights as the port keeps them (1-D biases and w_e, LSTM w_h, w_x, b
    apart, the conv taps (f, FM))."""
    rng = np.random.RandomState(seed)
    lens = np.array([l, l - 3, 5, l, 1, l - 7, 9, l][:b])
    mask = (np.arange(l)[None] < lens[:, None]).astype(dtype)
    h = rng.randn(b, l, a) * 0.5 * mask[:, :, None]
    u = lambda *shape: rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
    vh = h @ u(a, s)
    yin = rng.randn(b, t, st) * 0.5
    weights = [u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0], u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0],
               rng.uniform(-1, 1, (f, fm)) * 2, u(fm, fm)[0], u(fm, s)]
    return [np.asarray(x, dtype) for x in (vh, h, mask, yin, *weights)]


def _jax_loc_args(inputs):
    """The JAX kernel's arguments: (1, X) biases and w_e, the LSTM's
    concat([w_h, w_x]) and its bias row, then (wconv, bconv, u)."""
    (vh, h, mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_h, w_x, b, wconv, bconv,
     u) = map(jnp.asarray, inputs)
    return (vh, h, mask, yin, ws_w, ws_b[None], w_e[None], c_w, c_b[None], dec_w, dec_b[None],
            jnp.concatenate([w_h, w_x]), b[None], wconv, bconv[None], u)


@pytest.mark.parametrize("filt", [5, 4])
def test_loc_lstm_scan_plain_matches_pallas(filt):
    """K10's plain version; filter 5 pads 2 and 2, filter 4 pads 2 and 1."""
    inputs = _loc_scan_inputs(f=filt)
    want = jas.attention_decode_scan_loc_lstm(*_jax_loc_args(inputs), 8, True)
    got = attention_scan.attention_decode_scan_loc_lstm(*map(torch.from_numpy, inputs))
    for name, g, w in zip(("s_seq", "c_seq", "alpha_seq", "mem_seq"), got, want):
        close(g, w, 1e-4, 1e-5)
    assert not got[2].numpy()[np.broadcast_to(inputs[2][:, None] == 0, got[2].shape)].any()


def _grad_names():
    return ("dvh", "dh", "dyin") + attention_scan.WEIGHTS_LOC_LSTM


@pytest.mark.parametrize("reference", ["pallas_interpret", "torch_autograd"])
def test_loc_lstm_scan_bwd_plain_matches(reference):
    """K11's plain version with nonzero cotangents on s, c, alpha and mem
    (the alpha one runs the cross-step carry through the location term),
    against _run_bwd_loc in interpret mode on the Pallas forward's saved
    sequences, and against autograd through the plain forward."""
    inputs = _loc_scan_inputs(seed=1)
    rng = np.random.RandomState(2)
    cot = [rng.randn(B, T, n).astype(np.float32) for n in (ST, A, L, ST)]
    tin = list(map(torch.from_numpy, inputs))
    if reference == "pallas_interpret":
        jargs = _jax_loc_args(inputs)
        saved = jas.attention_decode_scan_loc_lstm(*jargs, 8, True)
        s_seq, c_seq, alpha_seq, mem_seq = saved
        want = list(jas._run_bwd_loc(*jargs, s_seq, c_seq, alpha_seq,
                                     *map(jnp.asarray, cot[:3]), 8, True, cell="lstm",
                                     mem_seq=mem_seq, dmem_seq=jnp.asarray(cot[3])))
        dcell_w1, dcell_w2 = np.asarray(want[10]), np.asarray(want[11])
        want[10:12] = [dcell_w1[:ST], dcell_w1[ST:], dcell_w2[0]]
        saved = [torch.tensor(np.asarray(x)) for x in saved]
    else:
        args = [x.clone().requires_grad_(i != 2) for i, x in enumerate(tin)]
        outs = attention_scan.attention_decode_scan_loc_lstm_plain(*args)
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
        want = torch.autograd.grad(loss, [a for i, a in enumerate(args) if i != 2])
        saved = [o.detach() for o in outs]
    got = attention_scan.attention_decode_scan_loc_lstm_bwd(*tin, *saved,
                                                            *map(torch.from_numpy, cot))
    assert len(got) == len(want) == 16
    for name, g, w in zip(_grad_names(), got, want):
        close(g, np.asarray(w).reshape(g.shape), 2e-4, 2e-5)


def test_loc_lstm_scan_autograd_function_passes_gradcheck():
    inputs = _loc_scan_inputs(np.float64, b=2, l=5, t=3, s=4, a=3, st=2, fm=2, f=3, seed=3)
    args = [torch.from_numpy(x) for x in inputs]
    for i, x in enumerate(args):
        if i != 2:  # enc_mask takes no gradient
            x.requires_grad_(True)
    assert torch.autograd.gradcheck(attention_scan.AttentionDecodeScanLocLSTM.apply, args)


def test_loc_lstm_scan_missing_cotangents_count_as_zeros():
    """The training loss reads s and c only: the unused alpha_seq and
    mem_seq reach the backward as None and give the gradient of explicit
    zero cotangents."""
    inputs = _loc_scan_inputs(b=2, l=8, t=3, s=8, a=8, st=4, fm=3, seed=4)
    args = [torch.from_numpy(x).requires_grad_(i != 2) for i, x in enumerate(inputs)]
    diff = [a for i, a in enumerate(args) if i != 2]
    s_seq, c_seq, alpha_seq, mem_seq = attention_scan.AttentionDecodeScanLocLSTM.apply(*args)
    got = torch.autograd.grad(s_seq.square().sum() + c_seq.sum(), diff)
    outs = attention_scan.AttentionDecodeScanLocLSTM.apply(*args)
    want = torch.autograd.grad(outs[0].square().sum() + outs[1].sum() + 0 * outs[2].sum()
                               + 0 * outs[3].sum(), diff)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_teacher_forced_scan_refuses_the_active_penalty():
    """Of the teacher-forced scan's options only the monotonic penalty is
    refused, and only in training: it would otherwise train without its
    gradient."""
    for cell, fm in (("gru", 0), ("gru", 4), ("lstm", 0), ("lstm", 4)):
        _, cfg = configs(cell, fm)
        cfg = dataclasses.replace(cfg, mono_align=True, penalty_lambda=0.5)
        params = attention.attention_init(torch.Generator().manual_seed(0), cfg)
        args = (params, cfg, torch.zeros(2, 5, 24), torch.tensor([5, 3]), torch.zeros(2, 3, 6),
                torch.ones(2, 3))
        assert attention.decode_teacher_forced(*args, train=False)["logprobs"].shape == (2, 3, 6)
        with pytest.raises(NotImplementedError):
            attention.decode_teacher_forced(*args, train=True)


def test_peepholes_are_refused():
    from seq2seq_attention_asr_tpu.ops import cells as jcells
    from seq2seq_attention_asr_tpu_torch.ops import cells, rnn

    _, cfg = configs("lstm", 0)
    with pytest.raises(NotImplementedError):
        attention.attention_init(torch.Generator().manual_seed(0),
                                 dataclasses.replace(cfg, peepholes=True))
    with pytest.raises(NotImplementedError):
        cells.lstm_init(torch.Generator().manual_seed(0), 4, 4, peepholes=True)
    peep = port(jcells.lstm_init(jax.random.PRNGKey(0), 4, 4, peepholes=True))
    with pytest.raises(NotImplementedError):
        cells.lstm_step(peep, torch.zeros(1, 4), (torch.zeros(1, 4), torch.zeros(1, 4)))
    with pytest.raises(NotImplementedError):
        rnn.bilstm_layer({"fwd": peep, "bwd": peep}, torch.zeros(1, 3, 4))
