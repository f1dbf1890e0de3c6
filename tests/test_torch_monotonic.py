"""The monotonic alignment penalty in the port (ops/monotonic.py and the
teacher-forced scan) against the reference's rule and the JAX package on
the CPU.

The twins of tests/test_monotonic.py hold the port's functions to the
reference (MonotonicAlignment.lua:27-75). The sequence form, which wraps
the scans' alignments for all four decoders, is held to the port's
per-step attention_step with the ramp and to the JAX package's
decode_teacher_forced (its lax.scan and its Pallas scans in interpret
mode; B = 8 and L = 16 pass their supported() gate), on a loss that
reads logprobs only, as the trainer's does: the penalty's gradient must
reach the parameters through it. One train step of the location-aware
GRU recipe with the penalty on is held to JAX's.

Tolerances: the rule's values rtol 1e-6; logprobs, alpha and penalty
rtol 1e-4 (atol 1e-5) and the gradients rtol 2e-4 (atol 2e-5), the
decoder scans' tolerances of tests/test_torch_decoder_scans.py; a train
step as tests/test_torch_dropout.py states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.ops import attention, monotonic
from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask
from test_torch_dropout import SMALL, step_parity

FWD, BWD = (1e-4, 1e-5), (2e-4, 2e-5)
LAM = 0.5


def cumsum_penalty(alpha, prev, mask):
    """The reference formulation (MonotonicAlignment.lua:27-39), masked."""
    d = np.cumsum(alpha, -1) - np.cumsum(prev, -1)
    return np.maximum((d * mask).sum(-1), 0.0)


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def test_forward_is_identity():
    alpha, prev = _t([[0.1, 0.7, 0.2]]), _t([[0.5, 0.3, 0.2]])
    ramp = monotonic.make_ramp(torch.tensor([3]), 3, 2.0)
    out = monotonic.MonotonicAlignment.apply(alpha, prev, ramp, torch.ones(1))
    torch.testing.assert_close(out, alpha, rtol=0, atol=0)
    seq = torch.rand(2, 4, 3)
    out = monotonic.MonotonicAlignmentSeq.apply(seq, ramp.expand(2, 3), torch.ones(2, 4),
                                                torch.ones(2, 4))
    torch.testing.assert_close(out, seq, rtol=0, atol=0)


def test_penalty_value_matches_cumsum_form():
    unit_ramp = monotonic.make_ramp(torch.tensor([3]), 3, 1.0)
    alpha, prev = _t([[0.8, 0.1, 0.1]]), _t([[0.1, 0.1, 0.8]])
    # cumsums [0.8, 0.9, 1.0] and [0.1, 0.2, 1.0]: 0.7 + 0.7 + 0 = 1.4
    np.testing.assert_allclose(monotonic.monotonic_penalty_value(alpha, prev, unit_ramp).numpy(),
                               [1.4], rtol=1e-6)
    np.testing.assert_allclose(monotonic.monotonic_penalty_value(prev, alpha, unit_ramp).numpy(),
                               [0.0], atol=1e-7)
    rng = np.random.RandomState(0)
    for _ in range(10):
        l, ln = 9, rng.randint(1, 10)
        a, b = rng.rand(2, l), rng.rand(2, l)
        mask = (np.arange(l) < ln).astype(np.float64)
        ur = monotonic.make_ramp(torch.tensor([ln, ln]), l, 1.0, torch.float64)
        got = monotonic.monotonic_penalty_value(torch.from_numpy(a * mask),
                                                torch.from_numpy(b * mask), ur)
        np.testing.assert_allclose(got.numpy(), cumsum_penalty(a * mask, b * mask, mask),
                                   rtol=1e-6, atol=1e-9)


def _grads(alpha, prev, lam):
    l = alpha.shape[1]
    ramp = monotonic.make_ramp(torch.tensor([l]), l, lam)
    unit = monotonic.make_ramp(torch.tensor([l]), l, 1.0)
    a, p = alpha.clone().requires_grad_(True), prev.clone().requires_grad_(True)
    active = monotonic.monotonic_penalty_value(a, p, unit).detach()
    out = monotonic.MonotonicAlignment.apply(a, p, ramp, active)
    return torch.autograd.grad(torch.sum(out * 3.0), (a, p))


def test_gradient_injection_matches_reference_rule():
    ga, gp = _grads(_t([[0.7, 0.1, 0.1, 0.1]]), _t([[0.1, 0.1, 0.1, 0.7]]), LAM)
    # upstream 3 everywhere; the ramp lam * (L + 1 - i), i = 1..L: [2, 1.5, 1, 0.5]
    np.testing.assert_allclose(ga.numpy(), [[5.0, 4.5, 4.0, 3.5]], rtol=1e-6)
    np.testing.assert_allclose(gp.numpy(), [[-2.0, -1.5, -1.0, -0.5]], rtol=1e-6)


def test_no_injection_when_penalty_zero():
    ga, gp = _grads(_t([[0.1, 0.1, 0.8]]), _t([[0.8, 0.1, 0.1]]), LAM)
    np.testing.assert_allclose(ga.numpy(), 3.0 * np.ones((1, 3)), rtol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.zeros((1, 3)), atol=1e-7)


def test_ramp_respects_lengths():
    np.testing.assert_allclose(monotonic.make_ramp(torch.tensor([2, 4]), 4, 1.0).numpy(),
                               [[2.0, 1.0, 0.0, 0.0], [4.0, 3.0, 2.0, 1.0]])


def test_sequence_injection_is_the_per_step_rule():
    """MonotonicAlignmentSeq's backward is the per-step rule summed: step
    t's ramp into d(alpha_t) and its negation into d(alpha_{t-1}), none
    for a step that does not fire or is masked."""
    rng = np.random.RandomState(1)
    b, t, l = 3, 5, 6
    lens = torch.tensor([6, 4, 2])
    base = monotonic.make_ramp(lens, l, LAM)
    dm = torch.from_numpy((np.arange(t)[None] < np.array([[5], [3], [4]])).astype(np.float32))
    active = torch.from_numpy((rng.rand(b, t) > 0.4).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, t, l).astype(np.float32))
    seq = torch.rand(b, t, l, requires_grad=True)
    out = monotonic.MonotonicAlignmentSeq.apply(seq, base, dm, active)
    (got,) = torch.autograd.grad(out, seq, g)
    want = g.clone()
    for s in range(t):
        inject = (active[:, s] > 0).float()[:, None] * dm[:, s, None] * base
        want[:, s] += inject
        if s > 0:
            want[:, s - 1] -= inject
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# --- the teacher-forced scan with the penalty, all four decoders ---------------------------

B, L, T = 8, 16, 6
ENC_LENS = [16, 11, 5, 16, 1, 9, 13, 16]
LABEL_LENS = [6, 3, 6, 1, 5, 6, 2, 4]
MAXOUT = (("maxout", 8, 3), ("linear", 6))
LIN_RELU = (("linear", 12), ("relu",), ("linear", 6))
DECODERS = [("gru", 0), ("gru", 4), ("lstm", 0), ("lstm", 4)]


def _case(cell, fm, lam=LAM, seed=5):
    kw = dict(score_depth=16, filt_size=10 if cell == "gru" else 5, feature_maps=fm,
              state_depth=16, annotation_depth=24, output_depth=6, cell=cell, mono_align=True,
              penalty_lambda=lam, readout=MAXOUT if cell == "gru" else LIN_RELU)
    jcfg, cfg = jatt.AttentionConfig(**kw), attention.AttentionConfig(**kw)
    params = jax.tree.map(np.asarray, jatt.attention_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1)
    h = (rng.randn(B, L, 24) * 0.5).astype(np.float32)
    dm = (np.arange(T)[None] < np.asarray(LABEL_LENS)[:, None]).astype(np.float32)
    oh = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (B, T))] * dm[..., None]
    return jcfg, cfg, params, h, np.asarray(ENC_LENS, np.int32), oh, dm


def _nll(out, oh, dm):
    """The trainer's objective: logprobs only, alpha unread."""
    return -(oh * out["logprobs"] * dm[..., None]).sum()


def per_step_decode(params, cfg, h, lens, oh, dm):
    """The port's plain per-step model: attention_step over the steps with
    the step-masked ramp, then the readout on the stacked (s, c)."""
    b, l, _ = h.shape
    enc_mask = length_mask(lens, l, h.dtype)
    vh = attention.precompute_vh(params, h)
    unit = monotonic.make_ramp(lens, l, 1.0)
    y_prev = torch.cat([torch.zeros_like(oh[:, :1]), oh[:, :-1]], dim=1)
    state = attention.init_state(cfg, b, l)
    outs = []
    for t in range(oh.shape[1]):
        state, out = attention.attention_step(params, cfg, state, y_prev[:, t], vh, h, enc_mask,
                                              ramp=cfg.penalty_lambda * unit * dm[:, t, None],
                                              unit_ramp=unit)
        outs.append(out)
    stack = lambda k: torch.stack([o[k] for o in outs], dim=1)
    return {"logprobs": attention.apply_readout(params, cfg, stack("s"), stack("c")),
            "alpha": stack("alpha"), "penalty": stack("penalty") * dm}


def _port_run(fn, cfg, params, h, lens, oh, dm):
    tp = interop.to_torch(params, "cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    th = torch.from_numpy(h).requires_grad_(True)
    out = fn(tp, cfg, th, torch.from_numpy(lens), torch.from_numpy(oh), torch.from_numpy(dm))
    grads = torch.autograd.grad(_nll(out, torch.from_numpy(oh), torch.from_numpy(dm)),
                                leaves + [th])
    return out, grads


def _scan(p, cfg, h, lens, oh, dm):
    return attention.decode_teacher_forced(p, cfg, h, lens, oh, dm, train=True)


def fire_margin(alpha, lens, dm) -> float:
    """The smallest nonzero |sum_i ramp_i * (alpha_t - alpha_{t-1})_i| over
    the valid steps. The ramp goes in where that sum is > 0, a cliff: two
    float paths agree on the gradient only where every step clears 0 by
    more than their sums differ (~1e-7 here; the tests ask for 1e-6); a
    step whose alignment repeats exactly (a one-frame row) is 0 on both."""
    a = np.asarray(alpha, np.float64)
    prev = np.concatenate([np.zeros_like(a[:, :1]), a[:, :-1]], axis=1)
    ramp = np.maximum(np.asarray(lens)[:, None] - np.arange(a.shape[-1]), 0)
    s = np.abs(((a - prev) * ramp[:, None, :]).sum(-1))[np.asarray(dm) > 0]
    return float(s[s > 0].min())


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol[0], atol=tol[1],
                               err_msg=msg)


@pytest.mark.parametrize("cell,fm", DECODERS)
def test_scan_penalty_matches_the_per_step_model(cell, fm):
    """decode_teacher_forced's sequence form against attention_step over
    the steps: logprobs, alpha, penalty and the gradients of every weight
    and of h; the penalty fires on some steps."""
    _, cfg, params, h, lens, oh, dm = _case(cell, fm)
    got, ggot = _port_run(_scan, cfg, params, h, lens, oh, dm)
    want, gwant = _port_run(per_step_decode, cfg, params, h, lens, oh, dm)
    assert int((want["penalty"] > 0).sum()) > 0
    assert fire_margin(want["alpha"].detach(), lens, dm) > 1e-6
    for key in ("logprobs", "alpha", "penalty"):
        _close(got[key].detach(), want[key].detach(), FWD, key)
    for i, (g, w) in enumerate(zip(ggot, gwant)):
        _close(g, w, BWD, f"grad {i}")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cell,fm", DECODERS)
def test_scan_penalty_matches_jax(cell, fm, backend):
    """Against JAX's decode_teacher_forced (lax.scan with the per-step
    custom_vjp, or its Pallas scans with the sequence form)."""
    jcfg, cfg, params, h, lens, oh, dm = _case(cell, fm)

    def jloss(p, hh):
        out = jatt.decode_teacher_forced(p, jcfg, hh, jnp.asarray(lens), jnp.asarray(oh),
                                         jnp.asarray(dm), train=True, backend=backend)
        return _nll(out, oh, dm), out

    (_, want), (wgp, wgh) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(h))
    got, grads = _port_run(_scan, cfg, params, h, lens, oh, dm)
    assert float(jnp.sum(want["penalty"] > 0)) > 0
    assert fire_margin(want["alpha"], lens, dm) > 1e-6
    for key in ("logprobs", "alpha", "penalty"):
        _close(got[key].detach(), want[key], FWD, key)
    _close(grads[-1], wgh, BWD, "h")
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(wgp)]
    for path, g, w in zip(paths, grads[:-1], jax.tree.leaves(wgp)):
        _close(g, w, BWD, path)


@pytest.mark.parametrize("cell,fm", DECODERS)
def test_penalty_gradient_reaches_the_weights(cell, fm):
    """The guard of tests/test_pallas.py:588: through the logprobs-only
    loss, the weights' gradients with the penalty differ from those
    without it by more than 1e-4; without the coupling into s_seq they
    would be equal."""
    _, cfg, params, h, lens, oh, dm = _case(cell, fm)
    _, g1 = _port_run(_scan, cfg, params, h, lens, oh, dm)
    _, g0 = _port_run(_scan, dataclasses.replace(cfg, penalty_lambda=0.0), params, h, lens, oh,
                      dm)
    delta = max(float((a - b).abs().max()) for a, b in zip(g1[:-1], g0[:-1]))
    assert delta > 1e-4, delta


def test_penalty_is_reported_in_evaluation():
    """Under no_grad the penalty is reported as in training and the
    sequence form is the identity (the JAX package reports it whatever
    `train` is)."""
    _, cfg, params, h, lens, oh, dm = _case("gru", 0)
    args = (interop.to_torch(params, "cpu"), cfg, torch.from_numpy(h), torch.from_numpy(lens),
            torch.from_numpy(oh), torch.from_numpy(dm))
    with torch.no_grad():
        ev = attention.decode_teacher_forced(*args)
        tr = attention.decode_teacher_forced(*args, train=True)
        off = attention.decode_teacher_forced(args[0], dataclasses.replace(cfg, mono_align=False),
                                              *args[2:])
    for key in ("logprobs", "alpha", "penalty"):
        torch.testing.assert_close(ev[key], tr[key], rtol=0, atol=0)
    torch.testing.assert_close(ev["logprobs"], off["logprobs"], rtol=0, atol=0)
    assert float(ev["penalty"].sum()) > 0 and not off["penalty"].any()


def test_penalty_train_step_matches_jax(monkeypatch):
    """One train step of flagship_loc (the location-aware GRU decoder, 4
    maps at small widths) with penalty_lambda 0.5: JAX's metrics, the
    reported penalty among them, its parameters and adadelta state."""
    m = step_parity(monkeypatch, lambda mod: mod.timit_chorowski_normnll_colnorm(),
                    dict(SMALL, feature_maps=4, penalty_lambda=LAM), {})
    assert m["penalty"] > 0
