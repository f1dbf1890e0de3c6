"""bf16 training (compute_dtype="bfloat16") of the flagship and of VGG
against the JAX package, on the CPU.

The port's bf16 backwards are K6's and K5's plain bf16 versions
(``gru_scan.bigru_scan2_bwd_plain_bf16``,
``attention_scan.attention_decode_scan_bwd_plain_bf16``), at the rounding
points of the JAX kernels with bf16 inputs (``_bi2_bwd_kernel``,
``_bwd_core``). The JAX side runs its Pallas kernels in interpret mode
(the models with rnn_backend and attn_backend "pallas"; VGG, which has no
such option, with its decoder's backend "pallas"), at B = L = 16, the
multiples of 16 its bf16 kernels take. Each comparison is made twice:

  - elementwise against JAX's bf16 result, atol times the array's
    largest magnitude (at least 1): for the kernels' backwards
    ATOL_KERNEL (1.6e-2, two bf16 ulps at 1.0; tests/test_torch_bf16.py),
    since the two packages sum in other orders, which can move a rounded
    operand by an ulp; for a whole train step's gradients STEP_ATOL
    (0.05, the JAX package's own bar for a bf16 model against float32,
    tests/test_end_to_end.py:148-178), since the plain ops around the
    kernels (the readout, the projections, the convolutions) round where
    each framework's bf16 ops round: JAX's XLA sums a bf16 bias gradient
    in bf16, the port's in float32;
  - by the ground-truth rule (tests/test_pallas.py:694-720): the port's
    relative L2 distance from JAX's float32 result on the same
    bf16-valued inputs (the same draws) is at most 2 x JAX's bf16
    distance + 0.02, leaf by leaf.

A train step's loss is held to JAX's bf16 loss at rtol 5e-3 (the loss
is a float32 sum of bf16-rounded log-probabilities; tests/test_end_to_end.py
:148-178 of the JAX package bounds a bf16 forward's outputs at 0.05).
The gradients compared are the ones the optimizer receives: a transform
that records them stands in for adadelta in both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seq2seq_attention_asr_tpu.data import synthetic as jsynthetic
from seq2seq_attention_asr_tpu.data import timit as jtimit
from seq2seq_attention_asr_tpu.models import vgg as jvgg
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jscan
from seq2seq_attention_asr_tpu.ops.pallas import gru_scan as jgs
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop, tree
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer
from test_torch_bf16 import (ATOL_KERNEL, BF16, _scan_inputs, as_np, bf16_np, ground_truth_rule,
                             to_j, to_t)
from test_torch_dropout import JaxDraws

SMALL = dict(input_frame_size=8, hidden_frame_size=16, output_frame_size=16, score_depth=24,
             state_depth=16, mlp_depth=12, output_depth=7)
VGG_SMALL = dict(input_frame_size=20, output_frame_size=16, score_depth=12, state_depth=12,
                 mlp_depth=8, output_depth=8)
PALLAS = dict(rnn_backend="pallas", attn_backend="pallas")
LOSS_RTOL = 5e-3
STEP_ATOL = 0.05


def close_scaled(got, want, label, atol=ATOL_KERNEL):
    """Elementwise within atol times the array's scale."""
    w = as_np(want)
    atol = atol * max(1.0, float(np.max(np.abs(w))) if w.size else 1.0)
    np.testing.assert_allclose(as_np(got), w, rtol=0, atol=atol, err_msg=label)


def test_bigru_scan2_bwd_plain_bf16_matches_pallas():
    """K6's plain bf16 version against bigru_scan2's VJP with bf16 inputs
    (gru_scan.py:698-775 of the JAX package, interpret mode), both fed
    JAX's forward outputs; float32 on float32 inputs is the float plain
    version."""
    rng = np.random.RandomState(0)
    b, l, h = 16, 16, 32
    lens = np.array([16, 11, 5, 16] * 4)
    valid = (np.arange(l)[None] < lens[:, None])[:, :, None]
    xf, xb = (bf16_np(rng.randn(b, l, 3 * h) * valid) for _ in range(2))
    wzr2 = bf16_np(rng.randn(2, h, 2 * h) * 0.3)
    wh2 = bf16_np(rng.randn(2, h, h) * 0.3)
    dys = [bf16_np(rng.randn(b, l, h) * valid) for _ in range(2)]
    args = (xf, xb, wzr2, wh2)

    def jax_vjp(dtype):
        ys, vjp = jax.vjp(lambda *a: jgs.bigru_scan2(*a, True), *(to_j(a, dtype) for a in args))
        return ys, vjp(tuple(to_j(d, dtype) for d in dys))

    ys, want = jax_vjp(jnp.bfloat16)
    _, truth = jax_vjp(jnp.float32)
    got = gru_scan.bigru_scan2_bwd(*map(to_t, (*args, *ys, *dys)))
    for g, w, t, name in zip(got, want, truth, ("dxf", "dxb", "dwzr2", "dwh2")):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        close_scaled(g, w, f"K6 {name}")
        ground_truth_rule(t, g, w, f"K6 {name}")
    # The float32 path is the float plain version, unchanged.
    f32 = [to_t(a, torch.float32) for a in (*args, *ys, *dys)]
    for g, w in zip(gru_scan.bigru_scan2_bwd(*f32), gru_scan._bwd_plain(*f32)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _cotangents(seed, b, t, st, a, l):
    rng = np.random.RandomState(seed)
    return tuple(bf16_np(rng.randn(*shape) * 0.3) for shape in ((b, t, st), (b, t, a), (b, t, l)))


def test_attention_decode_scan_bwd_plain_bf16_matches_pallas():
    """K5's plain bf16 version against attention_decode_scan's VJP with
    bf16 inputs (attention_scan.py:1156-1222 of the JAX package,
    interpret mode), each from its own package's bf16 forward; the twin
    (the softmax's sum as K5's entry forms it) holds the plain version
    by the same bars."""
    ins, weights = _scan_inputs(1)
    b, l = ins[0].shape[:2]
    t_len = ins[3].shape[1]
    cots = _cotangents(2, b, t_len, 16, 32, l)

    def jax_vjp(dtype):
        jw = [to_j(w[None] if w.ndim == 1 else w, dtype) for w in weights]
        jins = [to_j(a, dtype) for a in ins]
        _, vjp = jax.vjp(lambda vh, h, yin, *w: jscan.attention_decode_scan(
            vh, h, jins[2], yin, *w, 16, True), jins[0], jins[1], jins[3], *jw)
        g = vjp(tuple(to_j(c, dtype) for c in cots))
        return [g[0], g[1], g[2]] + [gw[0] if w.ndim == 1 else gw for gw, w in zip(g[3:], weights)]

    want, truth = jax_vjp(jnp.bfloat16), jax_vjp(jnp.float32)
    tins, tw = [to_t(a) for a in ins], [to_t(w) for w in weights]
    (s_seq, c_seq, _), (alpha32, c32) = attention_scan.attention_decode_scan_train(*tins, *tw)
    assert alpha32.dtype == c32.dtype == torch.float32
    plain = attention_scan.attention_decode_scan_bwd_plain_bf16(
        *tins, *tw, s_seq, c_seq, alpha32, *map(to_t, cots))
    twin = attention_scan.attention_decode_scan_bwd_twin_bf16(
        *tins, *tw, s_seq, c_seq, alpha32, *map(to_t, cots), c32)
    names = ("dvh", "dh", "dyin") + attention_scan.WEIGHTS
    for g, tw_, w, t, name in zip(plain, twin, want, truth, names):
        assert g.dtype == tw_.dtype == BF16 and w.dtype == jnp.bfloat16
        close_scaled(g, w, f"K5 {name}")
        ground_truth_rule(t, g, w, f"K5 {name}")
        close_scaled(tw_, w, f"K5's twin {name}")
        ground_truth_rule(t, tw_, w, f"K5's twin {name}")
    # The wrapper on CPU tensors is the plain version; it refuses a bf16
    # backward without the forward's float32 alpha and c.
    got = attention_scan.attention_decode_scan_bwd(*tins, *tw, s_seq, c_seq, alpha32,
                                                   *map(to_t, cots), c32=c32)
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32 alpha"):
        attention_scan.attention_decode_scan_bwd(*tins, *tw, s_seq, c_seq, alpha32.to(BF16),
                                                 *map(to_t, cots), c32=c32)


def test_decoder_backward_reads_the_float32_alpha():
    """AttentionDecodeScan on bf16 saves the forward's
    float32 alpha and c (not the rounded alpha_seq it returns), and its
    backward equals the plain bf16 backward fed that float32 alpha, and
    differs from one fed the rounded alpha."""
    ins, weights = _scan_inputs(3)
    tins = [to_t(a) for a in ins]
    tw = [to_t(w).requires_grad_() for w in weights]
    vh = tins[0].requires_grad_()
    s_seq, c_seq, alpha_seq = attention_scan.AttentionDecodeScan.apply(vh, *tins[1:], *tw)
    assert alpha_seq.dtype == BF16
    saved = s_seq.grad_fn.saved_tensors
    alpha_saved, c_saved = saved[-2], saved[-1]
    assert alpha_saved.dtype == c_saved.dtype == torch.float32
    assert alpha_saved.shape == alpha_seq.shape
    assert not torch.equal(alpha_saved, alpha_seq.float())  # the rounding moved some alpha
    torch.testing.assert_close(alpha_saved.to(BF16), alpha_seq, rtol=0, atol=0)
    b, l = ins[0].shape[:2]
    cots = [to_t(c) for c in _cotangents(4, b, ins[3].shape[1], 16, 32, l)]
    got = torch.autograd.grad((s_seq, c_seq, alpha_seq), [vh] + tw, cots)
    args = (*tins, *[w.detach() for w in tw], s_seq.detach(), c_seq.detach())
    want = attention_scan.attention_decode_scan_bwd_plain_bf16(*args, alpha_saved, *cots)
    rounded = attention_scan.attention_decode_scan_bwd_plain_bf16(
        *args, alpha_seq.detach().float(), *cots)
    skip = {2}  # yin got no gradient here: it is not a leaf of this graph
    for i, (g, w) in enumerate(zip(got, [want[0]] + list(want[3:]))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert any(not torch.equal(a, r) for i, (a, r) in enumerate(zip(want, rounded))
               if i not in skip)


def _capture():
    """Stand-ins for the optimizer that record the gradients they get (as
    their state) and update nothing: JAX's and the port's."""
    jtx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    tx = optim.Transform(lambda p: tree.tree_map(torch.zeros_like, p),
                         lambda g, s, p=None: (tree.tree_map(torch.zeros_like, g), g))
    return jtx, tx


def _grads_of_one_step(monkeypatch, recipe, family_kwargs, jax_kwargs, train_kwargs, batch,
                       jax_dtype):
    """One train step of recipe(module) with JAX's draws, the gradients
    the optimizer receives and the loss: JAX's at `jax_dtype` (bf16 with
    jax_kwargs, on its Pallas kernels; float32, the truth, on its XLA
    path, which compiles in a fifth of the time), and the port's in bf16.
    Returns (port (loss, grads), JAX's (loss, grads))."""
    jexp, exp = recipe(jexperiment), recipe(experiment)
    jexp.model_kwargs.update(family_kwargs, compute_dtype=jax_dtype,
                             **(jax_kwargs if jax_dtype == "bfloat16" else {}))
    exp.model_kwargs.update(family_kwargs, compute_dtype="bfloat16")
    jtcfg = dataclasses.replace(jexp.train, **train_kwargs)
    tcfg = dataclasses.replace(exp.train, **train_kwargs)
    jmodel, model = jexp.build_model(), exp.build_model()
    params = jax.tree.map(np.asarray, jexp.init_params(jax.random.PRNGKey(0)))
    jtx, tx = _capture()
    jinit, jstep = jtrainer.make_train_step(jmodel.forward, jtx, jexp.optim, jtcfg,
                                            jmodel.output_depth)
    init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, tcfg,
                                               model.output_depth)
    jstate, jm = jax.jit(jstep)(jinit(params, jax.random.PRNGKey(1)),
                                tuple(map(jnp.asarray, batch)))
    draws = JaxDraws(1)
    draws.install(monkeypatch)
    draws.next_step()
    state = init_fn(interop.to_torch(params, "cpu"), torch.Generator().manual_seed(1))
    state, m = step_fn(state, tuple(map(torch.from_numpy, batch)))
    return ((float(m["loss"]), interop.to_numpy(state[1])),
            (float(jm["loss"]), jax.tree.map(np.asarray, jstate[1])))


def _flatten(x, path="root"):
    """(path, numpy leaf) pairs of a port or JAX tree (named tuples by
    field), in a fixed order."""
    if hasattr(x, "_fields"):
        x = dict(zip(x._fields, x))
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in _flatten(x[k], f"{path}/{k}")]
    if isinstance(x, (list, tuple)):
        return [p for i, v in enumerate(x) for p in _flatten(v, f"{path}/{i}")]
    return [(path, np.asarray(x))]


def _hold_step(monkeypatch, recipe, family_kwargs, jax_kwargs, train_kwargs, batch):
    (loss, grads), (jloss, jgrads) = _grads_of_one_step(
        monkeypatch, recipe, family_kwargs, jax_kwargs, train_kwargs, batch, "bfloat16")
    _, (_, truth) = _grads_of_one_step(
        monkeypatch, recipe, family_kwargs, jax_kwargs, train_kwargs, batch, "float32")
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    got, want, f32 = _flatten(grads), _flatten(jgrads), _flatten(truth)
    assert [p for p, _ in got] == [p for p, _ in want] == [p for p, _ in f32]
    assert len(got) > 10
    for (path, g), (_, w), (_, t) in zip(got, want, f32):
        assert g.dtype == np.float32 and np.isfinite(g).all(), path  # the masters' gradients
        close_scaled(g, w, path, STEP_ATOL)
        ground_truth_rule(t, g, w, path)


def _flagship_batch(seed=0):
    rng = np.random.RandomState(seed)
    b, l, t, v = 16, 16, 5, SMALL["output_depth"]
    x = rng.randn(b, l, SMALL["input_frame_size"]).astype(np.float32)
    x_len = np.array([16, 11, 16, 7] * 4, np.int32)
    y = rng.randint(0, v, (b, t)).astype(np.int32)
    dm = (np.arange(t)[None] < np.array([5, 4, 5, 2] * 4)[:, None]).astype(np.float32)
    return x, x_len, y, dm


FLAGSHIP_CASES = {
    "plain": (lambda m: m.timit_chorowski_normnll_colnorm(), {}, {}),
    "dropout": (lambda m: m.timit_chorowski_dropout(), {}, {}),
    "penalty": (lambda m: m.timit_chorowski_normnll_colnorm(), {"penalty_lambda": 0.5}, {}),
    "awn": (lambda m: m.timit_chorowski_dropout(), {},
            dict(noise="awn", awn_lambda=1e-3, awn_sigma_init=0.02)),
}


@pytest.mark.parametrize("case", list(FLAGSHIP_CASES))
def test_flagship_bf16_train_step_matches_jax(monkeypatch, case):
    """One bf16 train step of the flagship at small widths (K1, K4, K5
    and K6's plain bf16 versions), JAX's draws swapped in: the loss and
    every gradient leaf the optimizer receives (under AWN those of mu and
    s), against JAX's bf16 step on its Pallas kernels and by the
    ground-truth rule against JAX's float32 step."""
    recipe, kwargs, tkw = FLAGSHIP_CASES[case]
    _hold_step(monkeypatch, recipe, {**SMALL, **kwargs}, PALLAS, tkw, _flagship_batch())


def test_vgg_bf16_gradient_matches_jax(monkeypatch):
    """One bf16 train step of VGG at small widths (K4 and K5's plain bf16
    versions, bf16 convolutions), JAX's bf16 decoder on its Pallas scan:
    the loss and every gradient leaf, both ways. 40 stacked frames give
    16 encoder frames."""
    orig = jvgg.attention.decode_teacher_forced
    monkeypatch.setattr(jvgg.attention, "decode_teacher_forced",
                        functools.partial(orig, backend="pallas"))
    rng = np.random.RandomState(3)
    b, t, v = 16, 5, VGG_SMALL["output_depth"]
    x = rng.randn(b, 40, 20, 3).astype(np.float32)
    x_len = np.array([40, 35] * 8, np.int32)
    y = rng.randint(0, v, (b, t)).astype(np.int32)
    dm = (np.arange(t)[None] < np.array([5, 4, 5, 2] * 4)[:, None]).astype(np.float32)

    def recipe(m):
        return m.librispeech_vgg(v)

    (loss, grads), (jloss, jgrads) = _grads_of_one_step(
        monkeypatch, recipe, VGG_SMALL, {}, {}, (x, x_len, y, dm), "bfloat16")
    monkeypatch.undo()  # the truth on JAX's XLA decoder
    _, (_, truth) = _grads_of_one_step(
        monkeypatch, recipe, VGG_SMALL, {}, {}, (x, x_len, y, dm), "float32")
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for (path, g), (_, w), (_, tr) in zip(_flatten(grads), _flatten(jgrads), _flatten(truth)):
        assert g.dtype == np.float32 and np.isfinite(g).all(), path
        close_scaled(g, w, path, STEP_ATOL)
        ground_truth_rule(tr, g, w, path)


def test_bf16_gradient_sums_in_float32_under_either_flag(monkeypatch):
    """The train step takes a bf16 model's gradient with cuBLAS's
    reduced-precision bf16 reduction off, whatever the caller set, and
    restores the caller's flag (the gradient runs outside the forward's
    float32_sums)."""
    matmul = torch.backends.cuda.matmul
    seen = []
    bwd = gru_scan.bigru_scan2_bwd

    def spy(*args):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return bwd(*args)

    monkeypatch.setattr(gru_scan, "bigru_scan2_bwd", spy)
    exp = experiment.timit_chorowski_normnll_colnorm()
    exp.model_kwargs.update(SMALL, compute_dtype="bfloat16")
    model = exp.build_model()
    init_fn, step_fn = trainer.make_train_step(model.forward, optim.build_optimizer(exp.optim),
                                               exp.optim, exp.train, model.output_depth)
    batch = tuple(map(torch.from_numpy, _flagship_batch(1)))
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            state = init_fn(model.init(torch.Generator().manual_seed(0), device="cpu"),
                            torch.Generator().manual_seed(0))
            step_fn(state, batch)
            assert matmul.allow_bf16_reduced_precision_reduction is flag
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert seen == [False] * 6  # three layers a step, two steps


def test_bf16_run_cli_trains_the_flagship(tmp_path):
    """Trainer.fit through run_cli in bf16 on the CPU: the scriptchecker
    recipe with its model in bf16 trains two epochs from h5 files; the
    loss is finite and the params it keeps stay float32."""
    pytest.importorskip("h5py")
    train, valid, _ = jsynthetic.timit_shaped(6, 4, max_len=10)
    data = tmp_path / "data"
    data.mkdir()
    jtimit.save_hdf5(train, str(data / "train.h5"))
    jtimit.save_hdf5(valid, str(data / "valid.h5"))

    def bf16_checker(save_dir=None):
        exp = experiment.scriptchecker(save_dir=save_dir)
        exp.model_kwargs["compute_dtype"] = "bfloat16"
        return exp

    save = str(tmp_path / "run")
    tr = experiment.run_cli(bf16_checker, "scriptchecker",
                            ["--cpu", "--data", str(data), "--save", save, "--decode-every", "0"])
    rows = trainer.MetricLog.load(f"{save}/log.jsonl")
    assert tr.epoch == 2 and all(np.isfinite(r["train_loss"]) for r in rows)
    assert tr.model.cfg.compute_dtype == "bfloat16"
    assert all(t.dtype == torch.float32 for t in tree.leaves(tr.state[0]))
