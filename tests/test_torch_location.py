"""The port's location-aware attention and LSTM decoder against the JAX
package on the CPU: the location term, the plain step, the plain
version of the beam step (kernel K8's twin) against the Pallas kernel in
interpret mode, and the beam search; and what the teacher-forced scan
still refuses.

Tolerances: float32 forward rtol 2e-5 (atol 2e-6), the JAX package's
parity tolerance (tests/test_pallas.py); beam tokens and lengths
identical, scores rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops.pallas import attention_step as jstep
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

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


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cell,fm", [("gru", 4), ("lstm", 0), ("lstm", 4)])
def test_teacher_forced_scan_refuses_location_and_lstm(cell, fm, train):
    """K4/K5 are the content-only GRU scan: a location-aware or LSTM
    decoder must be refused, not run without its location term or cell."""
    _, cfg = configs(cell, fm)
    params = attention.attention_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError):
        attention.decode_teacher_forced(params, cfg, torch.zeros(2, 5, 24), torch.tensor([5, 3]),
                                        torch.zeros(2, 3, 6), torch.ones(2, 3), train=train)


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
