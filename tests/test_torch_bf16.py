"""The bf16 operating point (compute_dtype="bfloat16") of the flagship's
evaluation path against the JAX package, on the CPU.

The JAX package rounds a bf16 model's values at its own places: its
Pallas kernels (K1 ``_bi2_fwd_kernel``, K4 ``_fwd_kernel``, K2
``_kernel`` with ``_apply_readout_fused``) keep accumulation, carries
and the softmax in float32 and round each product's operand, each
output and each readout layer to bf16; its XLA path carries bf16. The
port's plain bf16 versions follow the kernels. Bars:

  - the ground-truth rule (tests/test_pallas.py:694-720): take each
    result's relative L2 distance from the float32 result on the same
    bf16-valued inputs, upcast; the port's distance must be at most 2 x
    the JAX package's + 0.02, leaf by leaf;
  - the kernels' plain bf16 versions against the Pallas kernels in
    interpret mode on the same bf16 inputs: atol 1.6e-2 (two bf16 ulps
    at 1.0), at B = L = 16 (below that the JAX bf16 kernels are not
    taken: their supported() wants multiples of 16);
  - the model's forward against JAX's Pallas forward and the port's own
    float32 forward: atol 0.05 (tests/test_end_to_end.py:148-178);
  - the beam against JAX's Pallas beam: token agreement >= 0.98,
    lengths >= 0.9, scores rtol = atol = 5e-3 (tests/test_pallas.py:
    495-534);
  - the committed checkpoint's held-out beam PER: within 0.02 of JAX's
    CPU bf16 evaluation (its XLA path, which rounds elsewhere) on the
    first 16 utterances; all 192 (-m slow) print the numbers PERF.md
    records:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_bf16.py -s
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops.pallas import attention_scan as jscan
from seq2seq_attention_asr_tpu.ops.pallas import attention_step as jstep
from seq2seq_attention_asr_tpu.ops.pallas import gru_scan as jgs
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import serve
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic, timit
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, attention_step, gru_scan
from seq2seq_attention_asr_tpu_torch.train import checkpoint, optim, trainer

BF16 = torch.bfloat16
ATOL_KERNEL = 1.6e-2  # two bf16 ulps at 1.0
ROOT = pathlib.Path(__file__).resolve().parents[1]
NPZ = ROOT / "runs" / "timit_shape_ckpt" / "full" / "params.npz"
DIMS = dict(input_frame_size=123, hidden_frame_size=256, output_frame_size=256, score_depth=512,
            state_depth=256, mlp_depth=64, output_depth=62, feature_maps=0, filt_size=10,
            dropout=0.5)
SMALL = dict(input_frame_size=8, hidden_frame_size=16, output_frame_size=16, score_depth=24,
             state_depth=16, mlp_depth=12, output_depth=7, feature_maps=0, filt_size=5,
             penalty_lambda=0.0)
# The flagship's decoder at small widths (content-only GRU, maxout -> linear: K2's readout).
JCFG = jatt.AttentionConfig(score_depth=32, filt_size=5, feature_maps=0, state_depth=16,
                            annotation_depth=32, output_depth=7, cell="gru", mono_align=False,
                            penalty_lambda=0.0, readout=(("maxout", 12, 7), ("linear", 7)))
CFG = attention.AttentionConfig(score_depth=32, state_depth=16, annotation_depth=32,
                                output_depth=7, readout=JCFG.readout)


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


def port(tree, dtype=torch.float32):
    """A JAX parameter tree as the port's, in `dtype`."""
    return jax.tree.map(lambda a: to_t(a, dtype), tree)


def bf16_params(cfg=JCFG, seed=0):
    """A JAX decoder init rounded to bf16, as float32 numpy."""
    return jax.tree.map(bf16_np, jatt.attention_init(jax.random.PRNGKey(seed), cfg))


def test_bigru_scan2_bf16_matches_pallas():
    """K1's plain bf16 version against bigru_scan2 in interpret mode."""
    rng = np.random.RandomState(0)
    b, l, h = 16, 16, 32
    lens = np.array([16, 11, 5, 16] * 4)
    valid = (np.arange(l)[None] < lens[:, None])[:, :, None]
    xf, xb = (bf16_np(rng.randn(b, l, 3 * h) * valid) for _ in range(2))
    wzr2 = bf16_np(rng.randn(2, h, 2 * h) * 0.3)
    wh2 = bf16_np(rng.randn(2, h, h) * 0.3)
    args = (xf, xb, wzr2, wh2)
    want = jgs.bigru_scan2(*map(to_j, args), True)
    got = gru_scan.bigru_scan2(*map(to_t, args))
    truth = gru_scan.bigru_scan2(*(to_t(a, torch.float32) for a in args))
    for g, w, t, d in zip(got, want, truth, ("fwd", "bwd")):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        close(g, w, ATOL_KERNEL)
        ground_truth_rule(t, g, w, f"K1 {d}")
    assert not got[1].float().numpy()[~np.broadcast_to(valid, (b, l, h))].any()


def _scan_inputs(seed):
    rng = np.random.RandomState(seed)
    p = bf16_params()
    b, l, t = 16, 16, 6
    h = bf16_np(rng.randn(b, l, 32) * 0.5)
    vh = bf16_np(rng.randn(b, l, 32) * 0.5)
    mask = (np.arange(l)[None] < np.array([16, 12, 16, 9] * 4)[:, None]).astype(np.float32)
    yin = bf16_np(rng.randn(b, t, 16) * 0.5)
    c = p["cell"]
    weights = (p["ws"]["w"], p["ws"]["b"], p["w_e"], p["c_in"]["w"], p["c_in"]["b"],
               p["dec_in"]["w"], p["dec_in"]["b"], c["w_zr"], c["w_h"])
    return (vh, h, mask, yin), weights


def test_attention_decode_scan_bf16_matches_pallas():
    """K4's plain bf16 version against attention_decode_scan in interpret mode."""
    ins, weights = _scan_inputs(1)
    jw = [to_j(w[None] if w.ndim == 1 else w) for w in weights]
    want = jscan.attention_decode_scan(*map(to_j, ins), *jw, 16, True)
    got = attention_scan.attention_decode_scan(*map(to_t, ins), *map(to_t, weights))
    truth = attention_scan.attention_decode_scan(*(to_t(a, torch.float32) for a in ins),
                                                 *(to_t(w, torch.float32) for w in weights))
    for g, w, t, name in zip(got, want, truth, ("s", "c", "alpha")):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        close(g, w, ATOL_KERNEL)
        ground_truth_rule(t, g, w, f"K4 {name}")


def test_folded_scan_twin_rounds_where_the_bf16_entry_rounds():
    """gru_folded_scan_plain, the twin of K4's entries as they compute (the
    fold, then s_prev, c and rg s_prev rounded): on float32 inputs the
    plain scan; on bf16 inputs bf16 out, no farther from the float32 truth
    than the ground-truth rule lets the Pallas kernel in interpret mode
    be, and apart from the float32 sums of the same fold wherever a
    rounding point moves a value."""
    ins, weights = _scan_inputs(4)
    f32 = [to_t(a, torch.float32) for a in (*ins, *weights)]
    truth = attention_scan.attention_decode_scan_plain(*f32)
    for g, w in zip(attention_scan.gru_folded_scan_plain(*f32), truth):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    jw = [to_j(w[None] if w.ndim == 1 else w) for w in weights]
    want = jscan.attention_decode_scan(*map(to_j, ins), *jw, 16, True)
    got = attention_scan.gru_folded_scan_plain(*map(to_t, ins), *map(to_t, weights))
    for g, w, t, name in zip(got, want, truth, ("s", "c", "alpha")):
        assert g.dtype == BF16
        ground_truth_rule(t, g, w, f"K4's twin {name}")
    assert not torch.equal(got[0].float(), truth[0].to(BF16).float())


def test_gru_fold_bf16_widens_exactly():
    """The bf16 entry's pre-pass tables are the float32 fold of the
    widened weights."""
    ins, weights = _scan_inputs(2)
    args = (ins[3], *weights[3:])
    got = attention_scan.gru_fold_plain(*map(to_t, args))
    want = attention_scan.gru_fold_plain(*(to_t(a, torch.float32) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fused_attention_step_bf16_matches_pallas():
    """K2's plain bf16 version (the readout fused) against
    fused_attention_step in interpret mode."""
    params = bf16_params()
    rng = np.random.RandomState(3)
    b, k, l = 16, 3, 16
    h = bf16_np(rng.randn(b, l, 32) * 0.5)
    mask = (np.arange(l)[None] < np.array([16, 9, 12, 5] * 4)[:, None]).astype(np.float32)
    alpha0 = bf16_np(rng.rand(b, k, l))
    s0 = bf16_np(rng.randn(b, k, 16) * 0.5)
    mem0 = np.zeros((b, k, 16), np.float32)
    y = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (b, k))]
    jp = jax.tree.map(to_j, params)
    jvh = jatt.precompute_vh(jp, to_j(h))
    (wa, ws, _), want = jstep.fused_attention_step(
        jp, JCFG, tuple(map(to_j, (alpha0, s0, mem0))), to_j(y), jvh, to_j(h), to_j(mask),
        with_readout=True, interpret=True)
    vh = as_np(jvh)  # the same bf16 projection for both (and, upcast, for the truth)

    def run(dtype):
        tp = port(params, dtype)
        return attention_step.fused_attention_step(
            tp, CFG, tuple(to_t(a, dtype) for a in (alpha0, s0, mem0)), to_t(y, dtype),
            to_t(vh, dtype), to_t(h, dtype), to_t(mask, dtype))

    (ga, gs, _), got = run(BF16)
    _, truth = run(torch.float32)
    assert got["logp"].dtype == torch.float32 and want["logp"].dtype == jnp.float32
    for key in ("alpha", "s", "c", "logp"):
        if key != "logp":
            assert got[key].dtype == BF16
        close(got[key], want[key], ATOL_KERNEL)
        ground_truth_rule(truth[key], got[key], want[key], f"K2 {key}")
    close(gs, ws, ATOL_KERNEL)
    close(ga, wa, ATOL_KERNEL)


def _forward_batch(seed):
    rng = np.random.RandomState(seed)
    b, l, t, v = 16, 16, 5, 7
    x = rng.randn(b, l, 8).astype(np.float32)
    x_len = np.array([16, 11, 16, 7] * 4, np.int32)
    y = rng.randint(0, v, (b, t))
    dm = (np.arange(t)[None] < np.array([5, 4, 5, 2] * 4)[:, None]).astype(np.float32)
    oh = np.eye(v, dtype=np.float32)[y] * dm[..., None]
    return x, x_len, oh, dm


def test_forward_bf16_matches_jax_pallas_and_float32():
    """The bf16 model's forward (K1 and K4's plain bf16 versions) against
    JAX's bf16 forward on its Pallas kernels and against the port's own
    float32 forward."""
    jm = jregistry.build("chorowski", compute_dtype="bfloat16", rnn_backend="pallas",
                         attn_backend="pallas", **SMALL)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x, x_len, oh, dm = _forward_batch(0)
    want = jm.forward(params, *map(jnp.asarray, (x, x_len, oh, dm)), train=False)
    m16 = registry.build("chorowski", compute_dtype="bfloat16", **SMALL)
    m32 = registry.build("chorowski", **SMALL)
    tp = port(params)
    args = (torch.from_numpy(x), torch.from_numpy(x_len), torch.from_numpy(oh),
            torch.from_numpy(dm))
    got = m16.forward(tp, *args)
    f32 = m32.forward(tp, *args)
    assert got["logprobs"].dtype == torch.float32 and got["alpha"].dtype == BF16
    assert all(t.dtype == torch.float32 for t in tp["decoder"]["cell"].values())  # masters
    close(got["logprobs"], want["logprobs"], 0.05)
    close(got["alpha"], want["alpha"], 0.05)
    close(got["logprobs"], f32["logprobs"], 0.05)


def test_beam_search_bf16_matches_jax_pallas():
    """bf16 encoder states through K2's plain bf16 version against JAX's
    beam on its Pallas step kernel: f32 scores."""
    params = bf16_params(seed=4)
    rng = np.random.RandomState(5)
    b, l = 16, 16
    h = bf16_np(rng.randn(b, l, 32) * 0.5)
    lens = np.array([16, 9, 12, 5] * 4)
    want = jbeam.beam_search(jax.tree.map(to_j, params), JCFG, to_j(h), jnp.asarray(lens),
                             eos_id=2, k=3, max_steps=jnp.asarray(lens), max_steps_cap=l,
                             backend="pallas")
    got = beam.beam_search(port(params, BF16), CFG, to_t(h), torch.from_numpy(lens), 2, k=3,
                           max_steps=torch.from_numpy(lens), max_steps_cap=l, device="cpu")
    assert got.scores.dtype == torch.float32
    agree = float(np.mean(got.tokens.numpy() == np.asarray(want.tokens)))
    assert agree >= 0.98, f"token agreement {agree}"
    assert float(np.mean(got.lengths.numpy() == np.asarray(want.lengths))) >= 0.9
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=5e-3, atol=5e-3)


class Fixed:
    def __init__(self, batches):
        self._batches = batches

    def batches(self, ds, **kw):
        return iter(self._batches)


@pytest.fixture(scope="module")
def held_out():
    """The committed checkpoint's held-out split, batched as the trainer
    stages it (batch 32 over the train split's 3 buckets), on the host:
    the batches as numpy, and the parameters (numpy and tensors)."""
    train, valid, _ = synthetic.timit_shaped(4000, 192, noise=0.35, seed=1)
    base = batching.BucketedBatcher.from_dataset(train, 32, n_buckets=3)
    batches = [batching.Batch(x=np.asarray(b.x), x_len=np.asarray(b.x_len), y=np.asarray(b.y),
                              y_len=np.asarray(b.y_len), y39=b.y39, uids=list(b.uids))
               for b in batching.CachedDeviceBatcher(base, seed=1, device="cpu").batches(valid)]
    params = checkpoint.load_params_npz(str(NPZ), "cpu")
    return batches, params


def evaluate(batches, params, jax_too: bool):
    """The port's bf16 Trainer.evaluate on `batches` and, with jax_too,
    JAX's: (port row, JAX row or None)."""
    tcfg = trainer.TrainConfig(batch_size=32, normalize_nll=True, beam_k=5, seed=1)
    tr = trainer.Trainer(registry.build("chorowski_dropout", compute_dtype="bfloat16", **DIMS),
                         optim.OptimConfig(), tcfg, vocab=timit.Vocab.standard(), device="cpu")
    tr.state = (params, None, None)
    got = tr.evaluate(None, Fixed(batches))
    want = None
    if jax_too:
        jtcfg = jtrainer.TrainConfig(batch_size=32, normalize_nll=True, beam_k=5, seed=1,
                                     prefetch=0)
        jtr = jtrainer.Trainer(jregistry.build("chorowski_dropout", compute_dtype="bfloat16",
                                               **DIMS), joptim.OptimConfig(), jtcfg,
                               vocab=timit.Vocab.standard())
        jtr.state = (jax.tree.map(lambda t: t.numpy(), params), None, None)
        want = jtr.evaluate(None, Fixed(batches))
    return got, want


def first_16(batch):
    n = 16
    return batching.Batch(x=batch.x[:n], x_len=batch.x_len[:n], y=batch.y[:n],
                          y_len=batch.y_len[:n], y39=batch.y39[:n], uids=batch.uids[:n])


def test_held_out_bf16_first_16(held_out):
    """The committed checkpoint as a bf16 model on the first 16 held-out
    utterances: the port's Trainer.evaluate (make_decode_step casting
    params and x) within 0.02 of JAX's CPU bf16 evaluation."""
    batches, params = held_out
    got, want = evaluate([first_16(batches[0])], params, jax_too=True)
    print(f"first 16 held-out utterances, bf16: port valid_per {got['valid_per']!r}, JAX "
          f"{want['valid_per']!r}; valid_nll port {got['valid_nll']!r}, JAX "
          f"{want['valid_nll']!r}")
    assert abs(got["valid_per"] - want["valid_per"]) <= 0.02
    assert got["valid_per"] < 0.25
    np.testing.assert_allclose(got["valid_nll"], want["valid_nll"], rtol=0.05)


def test_decode_step_bf16_casts_like_jax(held_out):
    """make_decode_step(compute_dtype="bfloat16") takes float32 params and
    x, decodes through the bf16 encoder and beam, and scores in float32;
    the params it was given stay float32."""
    batches, params = held_out
    b = first_16(batches[0])
    m = registry.build("chorowski_dropout", compute_dtype="bfloat16", **DIMS)
    dec = trainer.make_decode_step(m.encode, m.attention_cfg, 5, device="cpu",
                                   compute_dtype="bfloat16")
    x = torch.from_numpy(b.x[:4])
    x_len = torch.from_numpy(b.x_len[:4])
    eos = torch.from_numpy(b.y[np.arange(4), b.y_len[:4] - 1])
    res = dec(params, x, x_len, eos, x.shape[1])
    assert res.scores.dtype == torch.float32 and bool(torch.isfinite(res.scores).all())
    assert params["decoder"]["w_e"].dtype == torch.float32
    h, _ = m.encode(params, x, x_len)
    assert h.dtype == torch.float32  # encode casts nothing


def test_bf16_training_and_other_decoders_refuse():
    """A bf16 train step and bf16 conv_bilstm raise NotImplementedError
    naming their ROADMAP items; a bad compute_dtype raises ValueError; the
    location-aware decoder's scan and K8's step refuse bf16 inputs."""
    with pytest.raises(ValueError):
        registry.build("chorowski", compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="5c"):
        registry.build("conv_bilstm", compute_dtype="bfloat16")
    with pytest.raises(ValueError):
        registry.build("conv_bilstm", compute_dtype="float64")
    m = registry.build("chorowski", compute_dtype="bfloat16", **SMALL)
    tr = trainer.Trainer(m, optim.OptimConfig(), trainer.TrainConfig(batch_size=16), device="cpu")
    tr.init(m.init(torch.Generator().manual_seed(0), device="cpu"))
    x, x_len, oh, dm = _forward_batch(1)
    y = torch.from_numpy(oh.argmax(-1))
    with pytest.raises(NotImplementedError, match="5b"):
        tr.step_fn(tr.state, (torch.from_numpy(x), torch.from_numpy(x_len), y,
                              torch.from_numpy(dm)))
    loc = registry.build("chorowski", compute_dtype="bfloat16", **dict(SMALL, feature_maps=4))
    lp = loc.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(TypeError, match="5c"):
        loc.forward(lp, torch.from_numpy(x), torch.from_numpy(x_len), torch.from_numpy(oh),
                    torch.from_numpy(dm))
    lcfg = dataclasses.replace(CFG, feature_maps=4)
    ldec = jax.tree.map(lambda t: t.to(BF16), lp["decoder"])
    b, k, l = 2, 3, 5
    state = tuple(torch.zeros(b, k, n, dtype=BF16) for n in (l, 16, 16))
    h = torch.zeros(b, l, 32, dtype=BF16)
    with pytest.raises(TypeError, match="5c"):
        attention_step.fused_attention_step(ldec, lcfg, state, torch.zeros(b, k, 7, dtype=BF16),
                                            torch.zeros(b, l, 24, dtype=BF16), h,
                                            torch.ones(b, l, dtype=BF16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_products_sum_in_float32_whatever_the_flag(monkeypatch, dtype):
    """A bf16 model's forward and make_decode_step's decode run with
    cuBLAS's reduced-precision bf16 reduction off, whatever the caller's
    flag, and put the flag back, also when the call raises; a float32
    model leaves the flag alone."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski

    matmul = torch.backends.cuda.matmul
    seen = []
    encode = chorowski.encode

    def spy(*args, **kw):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return encode(*args, **kw)

    monkeypatch.setattr(chorowski, "encode", spy)
    m = registry.build("chorowski", compute_dtype=dtype, **SMALL)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    x, x_len, oh, dm = (torch.from_numpy(a) for a in _forward_batch(2))
    dec = trainer.make_decode_step(lambda p, xx, ll: (spy(p, m.cfg, xx, ll), ll), m.attention_cfg,
                                   2, device="cpu", compute_dtype=dtype)
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        m.forward(params, x, x_len, oh, dm)
        dec(params, x[:2], x_len[:2], torch.zeros(2, dtype=torch.long), 3)
        assert seen == [dtype == "float32"] * 2
        assert matmul.allow_bf16_reduced_precision_reduction
        with pytest.raises(RuntimeError):
            with chorowski.float32_sums(getattr(torch, dtype)):
                raise RuntimeError
        assert matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


def test_bf16_transcriber_serves_float32():
    """serve.Transcriber on a bf16 config gives the float32 config's tokens
    and scores: encode casts nothing, so serving stays float32."""
    dims = dict(input_frame_size=123, hidden_frame_size=8, output_frame_size=8, score_depth=8,
                state_depth=8, mlp_depth=8, output_depth=7)
    params = registry.build("chorowski", **dims).init(torch.Generator().manual_seed(0), "cpu")
    params["decoder"] = jax.tree.map(lambda a: 3 * a, params["decoder"])
    rng = np.random.RandomState(3)
    t = np.arange(9000) / 16000.0
    pcms = [(0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.05 * rng.randn(n)).astype(np.float32)
            for f, n in ((440, 9000), (300, 4100))]
    kw = dict(eos_id=6, pad_frames=2, beam_k=3, mean=rng.randn(123).astype(np.float32),
              std=rng.uniform(5, 20, 123).astype(np.float32), device="cpu")
    got = serve.Transcriber(registry.build("chorowski", compute_dtype="bfloat16", **dims), params,
                            **kw).transcribe(pcms)
    want = serve.Transcriber(registry.build("chorowski", **dims), params, **kw).transcribe(pcms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.score == w.score


@pytest.mark.slow
def test_held_out_bf16_full_split(held_out):
    """All 192 held-out utterances: the port's CPU bf16 PER (the value
    chip_smoke.py holds the card to) and JAX's CPU bf16 evaluation."""
    import chip_smoke

    batches, params = held_out
    got, want = evaluate(batches, params, jax_too=True)
    print(f"held-out split, bf16, 192 utterances: port valid_per {got['valid_per']!r}, JAX "
          f"{want['valid_per']!r}; valid_nll port {got['valid_nll']!r}, JAX "
          f"{want['valid_nll']!r}; valid_accuracy port {got['valid_accuracy']!r}, JAX "
          f"{want['valid_accuracy']!r}; CPU seconds port {got['valid_seconds']:.1f}, JAX "
          f"{want['valid_seconds']:.1f}")
    assert abs(got["valid_per"] - want["valid_per"]) <= 0.02
    assert got["valid_per"] == pytest.approx(chip_smoke.HELD_OUT_PER_CPU_BF16, abs=1e-9)
