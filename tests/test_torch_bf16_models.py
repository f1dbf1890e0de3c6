"""The bf16 operating point (compute_dtype="bfloat16") of the evaluation
paths of conv+BiLSTM, flagship_loc (the flagship recipe with
feature_maps=16), VGG and conv_bilstm_content (the conv+BiLSTM recipe
with feature_maps=0) against the JAX package, on the CPU.

The kernels these paths reach in bf16: K7 (the BiLSTM forward), K10, K12
and K14 (the location-aware decoders' scans and the content-only LSTM
decoder's) and K8's <LSTM, location>, <GRU, location>, <GRU, content>
(with VGG's four-layer readout) and <LSTM, content> instances (the beam
step). Their plain bf16 versions round where the JAX kernels with bf16
inputs round; K10's, K12's and K14's entries fold c_in and dec_in into
the gates, so their exact twins (folded_scan_plain) round fewer
operands. Bars, as tests/test_torch_bf16.py sets them for the
flagship:

  - the plain bf16 versions against the Pallas kernels in interpret mode
    on the same bf16 inputs: atol 1.6e-2 (two bf16 ulps at 1.0), and the
    ground-truth rule (each result's relative L2 distance from the
    float32 result on the same bf16-valued inputs, upcast, at most 2 x
    the JAX kernel's + 0.02), at B = L = 16 (the JAX bf16 kernels want
    multiples of 16);
  - each exact twin against its plain bf16 version by the ground-truth
    rule, and equal to it (1e-5) in float32;
  - the models' forwards against JAX's bf16 forwards (its Pallas kernels
    where its config takes them; VGG's XLA path) and the port's own
    float32 forwards: atol 0.05;
  - the beam against JAX's Pallas beam: token agreement >= 0.98, lengths
    >= 0.9;
  - Trainer.evaluate in bf16 on 16 utterances: PER within 0.02 of JAX's
    CPU bf16 evaluation (its XLA path), NLL rtol 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops import rnn as jrnn
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jscan
from seq2seq_attention_asr_tpu.ops.pallas import attention_step as jstep
from seq2seq_attention_asr_tpu.ops.pallas import lstm_scan as jls
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import tree
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import attention, rnn
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, attention_step, lstm_scan
from seq2seq_attention_asr_tpu_torch.train import optim, trainer

BF16 = torch.bfloat16
ATOL_KERNEL = 1.6e-2  # two bf16 ulps at 1.0
# The three configurations at small widths: (family, its kwargs).
MODELS = {
    "conv_bilstm": ("conv_bilstm", dict(input_frame_size=16, hidden_frame_size=16,
                                        output_frame_size=8, score_depth=12, feature_maps=4,
                                        state_depth=16, output_depth=8)),
    "flagship_loc": ("chorowski", dict(input_frame_size=16, hidden_frame_size=16,
                                       output_frame_size=16, score_depth=24, state_depth=16,
                                       mlp_depth=12, output_depth=8, feature_maps=4,
                                       filt_size=5)),
    "vgg": ("vgg", dict(input_frame_size=20, output_frame_size=16, score_depth=12,
                        state_depth=12, mlp_depth=8, output_depth=8)),
    "conv_bilstm_content": ("conv_bilstm", dict(input_frame_size=16, hidden_frame_size=16,
                                                output_frame_size=8, score_depth=12,
                                                feature_maps=0, state_depth=16, output_depth=8)),
}
# Their decoders (K8's four bf16 instances), as the JAX and the port configs.
DECODERS = {
    "lstm_loc": dict(score_depth=12, state_depth=16, annotation_depth=16, output_depth=8,
                     readout=(("linear", 16), ("relu",), ("linear", 8)), feature_maps=4,
                     filt_size=5, cell="lstm"),
    "gru_loc": dict(score_depth=24, state_depth=16, annotation_depth=32, output_depth=8,
                    readout=(("maxout", 12, 7), ("linear", 8)), feature_maps=4, filt_size=5,
                    cell="gru"),
    "gru_vgg": dict(score_depth=12, state_depth=12, annotation_depth=16, output_depth=8,
                    readout=(("maxout", 8, 7), ("linear", 8), ("maxout", 8, 7), ("linear", 8)),
                    feature_maps=0, filt_size=10, cell="gru"),
    "lstm_content": dict(score_depth=12, state_depth=16, annotation_depth=16, output_depth=8,
                         readout=(("linear", 16), ("relu",), ("linear", 8)), feature_maps=0,
                         filt_size=5, cell="lstm"),
}
# The decoder scans with a bf16 entry: K10, K12 and K14, by their decoder.
SCANS = {"K10": "lstm_loc", "K12": "gru_loc", "K14": "lstm_content"}


def bf16_np(a):
    """numpy float32 holding bf16 values: the inputs both packages share."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def to_t(a, dtype=BF16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def to_j(a, dtype=jnp.bfloat16):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def ground_truth_rule(truth, port, ref, label):
    """The port's relative L2 distance from the float32 truth is at most 2x
    the JAX package's + 0.02."""
    t = as_np(truth)
    den = max(float(np.linalg.norm(t)), 1e-6)
    port_err = float(np.linalg.norm(as_np(port) - t)) / den
    ref_err = float(np.linalg.norm(as_np(ref) - t)) / den
    assert port_err <= 2.0 * ref_err + 0.02, f"{label}: port {port_err:.4f} vs JAX {ref_err:.4f}"


def close(got, want, atol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=atol)


def jcfg_of(name):
    return jatt.AttentionConfig(mono_align=False, penalty_lambda=0.0, **DECODERS[name])


def cfg_of(name):
    return attention.AttentionConfig(mono_align=False, **DECODERS[name])


def bf16_decoder(name, seed):
    """A JAX decoder init rounded to bf16, as float32 numpy."""
    return jax.tree.map(bf16_np, jatt.attention_init(jax.random.PRNGKey(seed), jcfg_of(name)))


def test_bilstm_scan_bf16_matches_pallas():
    """K7's plain bf16 version against bilstm_scan in interpret mode: bf16
    projections and weights, float32 zero states, float32 hidden states
    out (the JAX kernel's scratch and outputs are float32)."""
    rng = np.random.RandomState(0)
    b, l, h = 16, 16, 16
    xproj2 = bf16_np(rng.randn(2, b, l, 4 * h))
    wh2 = bf16_np(rng.randn(2, h, 4 * h) * 0.3)
    z2 = np.zeros((2, b, h), np.float32)
    want = jls.bilstm_scan(to_j(xproj2), to_j(z2, jnp.float32), to_j(z2, jnp.float32),
                           to_j(wh2), True)
    hs, cs = lstm_scan.bilstm_scan(to_t(xproj2), to_t(z2, torch.float32),
                                   to_t(z2, torch.float32), to_t(wh2))
    truth, _ = lstm_scan.bilstm_scan(*(to_t(a, torch.float32) for a in (xproj2, z2, z2, wh2)))
    assert hs.dtype == cs.dtype == torch.float32 and want.dtype == jnp.float32
    close(hs, want, ATOL_KERNEL)
    ground_truth_rule(truth, hs, want, "K7")
    torch.testing.assert_close(hs, truth, rtol=0, atol=0)  # it rounds nothing


def test_bilstm_layer_bf16_casts_like_jax():
    """bilstm_layer on bf16 params and input: float32 zero states into
    K7's bf16 path and the output cast back to bf16, as the JAX package's
    fused branch (backend="pallas") does; the padding's values too."""
    from seq2seq_attention_asr_tpu.ops import cells as jcells

    key = jax.random.PRNGKey(1)
    params = {"fwd": jcells.lstm_init(key, 12, 16), "bwd": jcells.lstm_init(key + 1, 12, 16)}
    params = jax.tree.map(bf16_np, params)
    rng = np.random.RandomState(1)
    x = bf16_np(rng.randn(16, 16, 12))
    lens = np.array([16, 9, 12, 3] * 4, np.int32)
    want = jrnn.bilstm_layer(jax.tree.map(to_j, params), to_j(x), jnp.asarray(lens),
                             backend="pallas")
    got = rnn.bilstm_layer(tree.tree_map(to_t, params), to_t(x), torch.from_numpy(lens))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    close(got, want, ATOL_KERNEL)


def _scan_inputs(kernel, seed):
    """K10's, K12's or K14's (a key of SCANS) inputs at B = L = 16, T = 6,
    bf16-valued: (vh, h, mask, yin), the port's weights, and the JAX
    kernel's."""
    name = SCANS[kernel]
    lstm, has_loc = DECODERS[name]["cell"] == "lstm", DECODERS[name]["feature_maps"] > 0
    p = bf16_decoder(name, seed)
    a_dim, s_dim, st = (DECODERS[name][k] for k in ("annotation_depth", "score_depth",
                                                    "state_depth"))
    rng = np.random.RandomState(seed)
    b, l, t = 16, 16, 6
    h = bf16_np(rng.randn(b, l, a_dim) * 0.5)
    vh = bf16_np(rng.randn(b, l, s_dim) * 0.5)
    mask = (np.arange(l)[None] < np.array([16, 12, 16, 9] * 4)[:, None]).astype(np.float32)
    yin = bf16_np(rng.randn(b, t, st) * 0.5)
    c = p["cell"]
    common = [p["ws"]["w"], p["ws"]["b"], p["w_e"], p["c_in"]["w"], p["c_in"]["b"],
              p["dec_in"]["w"], p["dec_in"]["b"]]
    loc = [p["loc_conv"]["w"][:, 0, :], p["loc_conv"]["b"], p["u"]] if has_loc else []
    cell = [c["w_h"], c["w_x"], c["b"]] if lstm else [c["w_zr"], c["w_h"]]
    jcell = [np.concatenate([c["w_h"], c["w_x"]], 0), c["b"]] if lstm else cell
    two_d = lambda w: w[None] if w.ndim == 1 else w
    jw = [two_d(w) for w in common + jcell + loc]
    return (vh, h, mask, yin), tuple(common + cell + loc), jw


# Each scan's JAX kernel and the port's wrapper, by name.
SCAN_FNS = {"K10": "attention_decode_scan_loc_lstm", "K12": "attention_decode_scan_loc",
            "K14": "attention_decode_scan_lstm"}


@pytest.mark.parametrize("kernel", list(SCANS))
def test_loc_scan_bf16_matches_pallas(kernel):
    """K10's, K12's and K14's plain bf16 versions against
    attention_decode_scan_loc_lstm, _loc and _lstm in interpret mode."""
    ins, weights, jw = _scan_inputs(kernel, 1)
    lstm = DECODERS[SCANS[kernel]]["cell"] == "lstm"
    jfn, fn = getattr(jscan, SCAN_FNS[kernel]), getattr(attention_scan, SCAN_FNS[kernel])
    want = jfn(*map(to_j, ins), *map(to_j, jw), 16, True)
    got = fn(*map(to_t, ins), *map(to_t, weights))
    truth = fn(*(to_t(a, torch.float32) for a in (*ins, *weights)))
    names = ("s", "c", "alpha", "mem")
    assert len(got) == len(want) == (4 if lstm else 3)
    for g, w, t, name in zip(got, want, truth, names):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        close(g, w, ATOL_KERNEL)
        ground_truth_rule(t, g, w, f"{kernel} {name}")


@pytest.mark.parametrize("kernel", list(SCANS))
def test_folded_twins_round_where_the_bf16_entries_round(kernel):
    """folded_scan_plain, the twin of K10's, K12's and K14's entries as
    they compute (the fold, then s_prev, the features, c and rg s_prev
    rounded): on float32 inputs the plain scan; on bf16 inputs bf16 out,
    no farther from the float32 truth than the ground-truth rule lets the
    Pallas kernel in interpret mode be, and apart from the float32 result
    rounded at its outputs."""
    ins, weights, jw = _scan_inputs(kernel, 4)
    lstm = DECODERS[SCANS[kernel]]["cell"] == "lstm"
    f32 = [to_t(a, torch.float32) for a in (*ins, *weights)]
    truth = attention_scan._scan_plain(*f32[:4], tuple(f32[4:]), lstm)
    for g, w in zip(attention_scan.folded_scan_plain(*f32[:4], tuple(f32[4:]), lstm), truth):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    want = getattr(jscan, SCAN_FNS[kernel])(*map(to_j, ins), *map(to_j, jw), 16, True)
    got = attention_scan.folded_scan_plain(*map(to_t, ins), tuple(map(to_t, weights)), lstm)
    for g, w, t, name in zip(got, want, truth, ("s", "c", "alpha", "mem")):
        assert g.dtype == BF16
        ground_truth_rule(t, g, w, f"twin {name}")
    assert not torch.equal(got[0].float(), truth[0].to(BF16).float())


def test_lstm_fold_bf16_widens_exactly():
    """The bf16 entries' pre-pass tables are the float32 fold of the
    widened weights, for the LSTM as for the GRU."""
    ins, weights, _ = _scan_inputs("K10", 2)
    args = (ins[3], *weights[3:7], *weights[8:10])
    got = attention_scan.lstm_fold_plain(*map(to_t, args))
    want = attention_scan.lstm_fold_plain(*(to_t(a, torch.float32) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(DECODERS))
def test_k8_bf16_matches_pallas(name):
    """K8's plain bf16 version (the readout fused: VGG's four layers for
    gru_vgg) against fused_attention_step in interpret mode, the beam's
    state (alpha, s, mem) in bf16."""
    params = bf16_decoder(name, 3)
    jcfg, cfg = jcfg_of(name), cfg_of(name)
    assert not attention_step.uses_k2(cfg)
    rng = np.random.RandomState(3)
    b, k, l, st = 16, 3, 16, cfg.state_depth
    h = bf16_np(rng.randn(b, l, cfg.annotation_depth) * 0.5)
    mask = (np.arange(l)[None] < np.array([16, 9, 12, 5] * 4)[:, None]).astype(np.float32)
    alpha0 = bf16_np(rng.dirichlet(np.ones(l), (b, k)))
    s0 = bf16_np(rng.randn(b, k, st) * 0.5)
    mem0 = bf16_np(rng.randn(b, k, st) * 0.5) if cfg.cell == "lstm" else np.zeros((b, k, st))
    y = np.eye(cfg.output_depth, dtype=np.float32)[rng.randint(0, cfg.output_depth, (b, k))]
    jp = jax.tree.map(to_j, params)
    jvh = jatt.precompute_vh(jp, to_j(h))
    (wa, ws, wm), want = jstep.fused_attention_step(
        jp, jcfg, tuple(map(to_j, (alpha0, s0, mem0))), to_j(y), jvh, to_j(h), to_j(mask),
        with_readout=True, interpret=True)
    vh = as_np(jvh)

    def run(dtype):
        tp = tree.tree_map(lambda a: to_t(a, dtype), params)
        return attention_step.fused_attention_step(
            tp, cfg, tuple(to_t(a, dtype) for a in (alpha0, s0, mem0)), to_t(y, dtype),
            to_t(vh, dtype), to_t(h, dtype), to_t(mask, dtype))

    (ga, gs, gm), got = run(BF16)
    (_, _, tm), truth = run(torch.float32)
    assert got["logp"].dtype == torch.float32 and want["logp"].dtype == jnp.float32
    for key in ("alpha", "s", "c", "logp"):
        if key != "logp":
            assert got[key].dtype == BF16
        close(got[key], want[key], ATOL_KERNEL)
        ground_truth_rule(truth[key], got[key], want[key], f"K8 {name} {key}")
    close(gs, ws, ATOL_KERNEL)
    close(ga, wa, ATOL_KERNEL)
    assert gm.dtype == BF16
    close(gm, wm, ATOL_KERNEL)
    if cfg.cell == "lstm":
        ground_truth_rule(tm, gm, wm, f"K8 {name} mem")


def _jax_model(name):
    family, dims = MODELS[name]
    backends = {} if family == "vgg" else dict(attn_backend="pallas", rnn_backend="pallas")
    return jregistry.build(family, compute_dtype="bfloat16", **dims, **backends)


def _port_models(name):
    family, dims = MODELS[name]
    return registry.build(family, compute_dtype="bfloat16", **dims), registry.build(family, **dims)


def _forward_batch(name, seed):
    """A batch of 16 at lengths whose encoder output is 16 frames (the JAX
    bf16 kernels' tile): conv_bilstm's 142 input frames, VGG's 40
    stacked frames of 20 bins, flagship_loc's 16."""
    rng = np.random.RandomState(seed)
    b, t, v = 16, 5, 8
    shape = {"conv_bilstm": (142, 16), "flagship_loc": (16, 16), "vgg": (40, 20, 3),
             "conv_bilstm_content": (142, 16)}[name]
    x = rng.randn(b, *shape).astype(np.float32)
    x_len = np.array([shape[0], shape[0] - 5] * 8, np.int32)
    y = rng.randint(0, v, (b, t))
    dm = (np.arange(t)[None] < np.array([5, 4, 5, 2] * 4)[:, None]).astype(np.float32)
    oh = np.eye(v, dtype=np.float32)[y] * dm[..., None]
    return x, x_len, oh, dm


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_bf16_matches_jax_and_float32(name):
    """The bf16 model's forward (K7, K10, K12, the bf16 convolutions and
    products) against JAX's bf16 forward (on its Pallas kernels for
    conv_bilstm and flagship_loc, its XLA path for VGG) and the port's
    own float32 forward, from the port's seeded init; the float32
    masters stay float32."""
    m16, m32 = _port_models(name)
    tp = m32.init(torch.Generator().manual_seed(0), device="cpu")
    params = tree.tree_map(lambda t: t.numpy(), tp)
    x, x_len, oh, dm = _forward_batch(name, 0)
    want = _jax_model(name).forward(params, *map(jnp.asarray, (x, x_len, oh, dm)), train=False)
    args = (torch.from_numpy(x), torch.from_numpy(x_len), torch.from_numpy(oh),
            torch.from_numpy(dm))
    got = m16.forward(tp, *args)
    f32 = m32.forward(tp, *args)
    assert got["logprobs"].dtype == torch.float32 and got["alpha"].dtype == BF16
    assert all(t.dtype == torch.float32 for t in tree.leaves(tp))  # masters
    close(got["logprobs"], want["logprobs"], 0.05)
    close(got["alpha"], want["alpha"], 0.05)
    close(got["logprobs"], f32["logprobs"], 0.05)


@pytest.mark.parametrize("name", list(DECODERS))
def test_beam_search_bf16_matches_jax_pallas(name):
    """bf16 encoder states through K8's plain bf16 version against JAX's
    beam on its Pallas step kernel: float32 scores; K = 3, and for the
    content-only LSTM (conv_bilstm_content's decoder) the recipes' K = 5."""
    params = bf16_decoder(name, 4)
    rng = np.random.RandomState(5)
    b, l, k = 16, 16, 5 if name == "lstm_content" else 3
    h = bf16_np(rng.randn(b, l, DECODERS[name]["annotation_depth"]) * 0.5)
    lens = np.array([16, 9, 12, 5] * 4)
    want = jbeam.beam_search(jax.tree.map(to_j, params), jcfg_of(name), to_j(h),
                             jnp.asarray(lens), eos_id=2, k=k, max_steps=jnp.asarray(lens),
                             max_steps_cap=l, backend="pallas")
    got = beam.beam_search(tree.tree_map(to_t, params), cfg_of(name), to_t(h),
                           torch.from_numpy(lens), 2, k=k, max_steps=torch.from_numpy(lens),
                           max_steps_cap=l, device="cpu")
    assert got.scores.dtype == torch.float32
    agree = float(np.mean(got.tokens.numpy() == np.asarray(want.tokens)))
    assert agree >= 0.98, f"token agreement {agree}"
    assert float(np.mean(got.lengths.numpy() == np.asarray(want.lengths))) >= 0.9


class Fixed:
    def __init__(self, batches):
        self._batches = batches

    def batches(self, ds, **kw):
        return iter(self._batches)


def _eval_batches(name, seed):
    """16 utterances of a learnable synthetic corpus (data/synthetic.py) at
    the configuration's input width, one batch as the trainer stages it
    (VGG's frames as 20 bins of 3 channels)."""
    feat_dim, frames = {"conv_bilstm": (16, (8, 12)), "flagship_loc": (16, (3, 7)),
                        "vgg": (60, (4, 8)), "conv_bilstm_content": (16, (8, 12))}[name]
    ds, _, _ = synthetic.make_corpus(16, n_phones=7, feat_dim=feat_dim, min_len=3, max_len=8,
                                     frames_per_phone=frames, seed=seed)
    if name == "vgg":
        ds = dataclasses.replace(ds, x=[x.reshape(len(x), 20, 3) for x in ds.x])
    base = batching.BucketedBatcher.from_dataset(ds, 16, n_buckets=1)
    return [batching.Batch(x=np.asarray(b.x), x_len=np.asarray(b.x_len), y=np.asarray(b.y),
                           y_len=np.asarray(b.y_len), y39=b.y39, uids=list(b.uids))
            for b in base.batches(ds)]


@pytest.mark.parametrize("name", list(MODELS))
def test_evaluate_bf16_matches_jax(name):
    """Trainer.evaluate of the bf16 model (make_eval_step with the model's
    forward, make_decode_step casting params and x) on 16 utterances:
    PER within 0.02 of JAX's CPU bf16 evaluation, NLL rtol 0.05; the
    params it was given stay float32."""
    batches = _eval_batches(name, 5)
    m16, _ = _port_models(name)
    params = m16.init(torch.Generator().manual_seed(0), device="cpu")
    tcfg = trainer.TrainConfig(batch_size=16, normalize_nll=True, beam_k=5, seed=1)
    tr = trainer.Trainer(m16, optim.OptimConfig(), tcfg, vocab=None, device="cpu")
    tr.state = (params, None, None)
    got = tr.evaluate(None, Fixed(batches))
    family, dims = MODELS[name]
    jtcfg = jtrainer.TrainConfig(batch_size=16, normalize_nll=True, beam_k=5, seed=1, prefetch=0)
    jtr = jtrainer.Trainer(jregistry.build(family, compute_dtype="bfloat16", **dims),
                           joptim.OptimConfig(), jtcfg, vocab=None)
    jtr.state = (jax.tree.map(lambda t: t.numpy(), params), None, None)
    want = jtr.evaluate(None, Fixed(batches))
    assert abs(got["valid_per"] - want["valid_per"]) <= 0.02, (got, want)
    np.testing.assert_allclose(got["valid_nll"], want["valid_nll"], rtol=0.05)
    assert all(t.dtype == torch.float32 for t in tree.leaves(params))


def test_bf16_training_and_the_content_lstm_refuse():
    """A bf16 gradient of every model runs and reaches every float32
    master as a finite float32 gradient: VGG's (K5's plain bf16 backward
    and the bf16 convolutions; tests/test_torch_bf16_train.py holds it to
    JAX), conv_bilstm's, flagship_loc's and conv_bilstm_content's (the
    plain bf16 backwards of K9, K11, K13 and K15;
    tests/test_torch_bf16_train_loc_lstm.py holds them to JAX);
    conv_bilstm_content's bf16 evaluation path, the content-only LSTM's
    scan (K14) and K8's <LSTM, content> step, takes bf16 inputs and gives
    bf16 outputs."""
    for name in MODELS:
        m16, _ = _port_models(name)
        params = tree.tree_map(lambda a: a.requires_grad_(),
                               m16.init(torch.Generator().manual_seed(0), device="cpu"))
        x, x_len, oh, dm = (torch.from_numpy(a) for a in _forward_batch(name, 1))
        out = m16.forward(params, x, x_len, oh, dm)
        out["logprobs"].sum().backward()
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   and bool(torch.isfinite(p.grad).all()) for p in tree.leaves(params)), name
    assert registry.build("conv_bilstm", compute_dtype="bfloat16",
                          feature_maps=0).cfg.compute_dtype == "bfloat16"
    cfg = attention.AttentionConfig(score_depth=12, state_depth=16, annotation_depth=16,
                                    output_depth=8, readout=(("linear", 8),), cell="lstm")
    dec = tree.tree_map(lambda t: t.to(BF16),
                        attention.attention_init(torch.Generator().manual_seed(0), cfg))
    b, k, l = 2, 3, 5
    state = tuple(torch.zeros(b, k, n, dtype=BF16) for n in (l, 16, 16))
    h = torch.zeros(b, l, 16, dtype=BF16)
    (_, s_new, mem), out = attention_step.fused_attention_step(
        dec, cfg, state, torch.zeros(b, k, 8, dtype=BF16), torch.zeros(b, l, 12, dtype=BF16), h,
        torch.ones(b, l, dtype=BF16))
    assert s_new.dtype == mem.dtype == out["c"].dtype == BF16
    assert out["logp"].dtype == torch.float32
    c = dec["cell"]
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], c["w_h"], c["w_x"], c["b"])
    seqs = attention_scan.attention_decode_scan_lstm(torch.zeros(b, l, 12, dtype=BF16), h,
                                                     torch.ones(b, l, dtype=BF16),
                                                     torch.zeros(b, 4, 16, dtype=BF16), *weights)
    assert len(seqs) == 4 and all(x.dtype == BF16 for x in seqs)
