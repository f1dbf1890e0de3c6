"""The main path's quality gate: the committed flagship-shape checkpoint's
held-out beam PER, through the port's Trainer.evaluate and the JAX
package's, on the CPU.

The checkpoint (runs/timit_shape_ckpt/full/ckpt_best_valid_PER, read by
the port from params.npz) was trained and scored by tools/convergence.py
--timit-shape on timit_shaped(4000, 192, noise=0.35, seed=1), with the
valid split batched at 32 over 3 length buckets of the TRAIN lengths
(longer utterances cut to the last boundary) and cached from one
shuffle with seed 1; beam K=5, a budget of eval_len_factor (1.0) times
the encoder length, the 61->39 fold. Two stagings of that split:

  - "synth": as tools/convergence.py staged it, the features drawn by the JAX
    package's DeviceSynth (jax.random noise, keyed per bucket group);
  - "host": the corpus's own host-drawn features, batched by the port's
    batcher with the same boundaries.

Both trainers score the same numpy batches. Tolerances: equal PER
(within 0.001) and equal tokens on every utterance whose two best beam
scores are not tied (a differing utterance must have scores within
1e-4). Tier 1 runs the first staged batch; the whole split (-m slow,
minutes of JAX compiles and CPU beam search) prints the numbers that
PERF.md records:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_quality.py -s
"""

import os
import pathlib
import tempfile

import jax
import numpy as np
import pytest

from seq2seq_attention_asr_tpu.data import batching as jbatching
from seq2seq_attention_asr_tpu.data import synthetic as jsynthetic
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.train import checkpoint as jcheckpoint
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.data import batching, timit
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.train import checkpoint, optim, trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "runs" / "timit_shape_ckpt" / "full" / "ckpt_best_valid_PER"
NPZ = ROOT / "runs" / "timit_shape_ckpt" / "full" / "params.npz"
AWN = ROOT / "runs" / "timit_shape_ckpt" / "awn" / "ckpt_best_eval"
DIMS = dict(input_frame_size=123, hidden_frame_size=256, output_frame_size=256, score_depth=512,
            state_depth=256, mlp_depth=64, output_depth=62, feature_maps=0, filt_size=10,
            dropout=0.5)
BATCH, BUCKETS, SEED, NOISE = 32, 3, 1, 0.35


class Fixed:
    """A batcher that yields the given batches."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self, ds, **kw):
        return iter(self._batches)


@pytest.fixture(scope="module")
def staged():
    """{"synth": [Batch], "host": [Batch]}, the 192 held-out utterances in
    the staging order, and the vocab. The port's batcher stages the host
    split from the JAX package's corpus, which data/synthetic.py gives
    bit for bit (tests/test_torch_data.py)."""
    train, valid, vocab = jsynthetic.timit_shaped(4000, 192, noise=NOISE, seed=SEED)
    synth = jbatching.CachedDeviceBatcher(
        jbatching.BucketedBatcher.from_dataset(train, BATCH, n_buckets=BUCKETS), seed=SEED,
        synth=jbatching.DeviceSynth(jsynthetic.prototype_table(61, 123, SEED), noise=NOISE,
                                    seed=SEED))
    host = batching.CachedDeviceBatcher(
        batching.BucketedBatcher.from_dataset(train, BATCH, n_buckets=BUCKETS), seed=SEED,
        device="cpu")
    as_np = lambda b: batching.Batch(x=np.array(b.x), x_len=np.array(b.x_len), y=np.array(b.y),
                                     y_len=np.array(b.y_len), y39=b.y39, uids=list(b.uids))
    return {"synth": [as_np(b) for b in synth.batches(valid)],
            "host": [as_np(b) for b in host.batches(valid)]}, vocab


@pytest.fixture(scope="module")
def trainers(staged):
    """One JAX and one port Trainer for every evaluation of the module, so
    that the JAX package compiles each batch shape once."""
    _, vocab = staged
    jtcfg = jtrainer.TrainConfig(batch_size=BATCH, normalize_nll=True, beam_k=5, seed=SEED,
                                 prefetch=0, dump_predictions=True)
    tcfg = trainer.TrainConfig(batch_size=BATCH, normalize_nll=True, beam_k=5, seed=SEED,
                               dump_predictions=True)
    return (jtrainer.Trainer(jregistry.build("chorowski_dropout", **DIMS), joptim.OptimConfig(),
                             jtcfg, vocab=vocab),
            trainer.Trainer(registry.build("chorowski_dropout", **DIMS), optim.OptimConfig(),
                            tcfg, vocab=timit.Vocab.standard(), device="cpu"))


def evaluate_both(trainers, params, port_params, batches):
    """JAX's Trainer.evaluate with `params` (numpy) and the port's with
    `port_params` (tensors on the CPU) on `batches`, each with its
    prediction dump: ((jax row, jax dump), (port row, port dump))."""
    out = []
    for tr, p in zip(trainers, (params, port_params)):
        with tempfile.TemporaryDirectory() as d:
            tr.state, tr.save_dir = (p, None, None), d
            row = tr.evaluate(None, Fixed(batches))
            with np.load(os.path.join(d, "predictions_epoch1.npz")) as z:
                out.append((row, dict(z)))
    return out


def check_agreement(want, got, label):
    """Equal PER within 0.001, tokens equal on every utterance but ties;
    returns the number of utterances whose tokens differ."""
    (wrow, wd), (grow, gd) = want, got
    assert list(wd["uids"]) == list(gd["uids"])
    differ = [i for i in range(len(wd["uids"]))
              if wd["lengths"][i] != gd["lengths"][i]
              or not np.array_equal(wd["tokens"][i, : wd["lengths"][i]],
                                    gd["tokens"][i, : gd["lengths"][i]])]
    gap = float(np.max(np.abs(wd["scores"] - gd["scores"])))
    print(f"{label}: {len(wd['uids'])} utterances, valid_per JAX {wrow['valid_per']!r}, port "
          f"{grow['valid_per']!r}; valid_nll JAX {wrow['valid_nll']!r}, port "
          f"{grow['valid_nll']!r}; "
          f"valid_accuracy JAX {wrow['valid_accuracy']!r}, port {grow['valid_accuracy']!r}; "
          f"tokens differ on {len(differ)} utterances; largest beam score gap {gap:.3e}; "
          f"CPU seconds JAX {wrow['valid_seconds']:.1f}, port {grow['valid_seconds']:.1f}")
    assert abs(grow["valid_per"] - wrow["valid_per"]) <= 1e-3
    assert grow["valid_accuracy"] == wrow["valid_accuracy"]
    np.testing.assert_allclose(grow["valid_nll"], wrow["valid_nll"], rtol=1e-5)
    for i in differ:  # a tie between two hypotheses, not a different search
        assert abs(float(wd["scores"][i]) - float(gd["scores"][i])) < 1e-4, wd["uids"][i]
    return len(differ)


@pytest.fixture(scope="module")
def params():
    """The checkpoint's parameters: numpy from the orbax checkpoint for the
    JAX package, tensors from params.npz for the port."""
    return (jax.tree.map(np.asarray, jcheckpoint.load(str(CKPT))["state"][0]),
            checkpoint.load_params_npz(str(NPZ), "cpu"))


@pytest.mark.parametrize("split", ["synth", "host"])
def test_quality_gate_first_batch(staged, trainers, params, split):
    """The first staged batch (32 utterances of the smallest bucket):
    equal tokens on every utterance and equal PER."""
    batches, _ = staged
    first = batches[split][:1]
    assert first[0].x.shape == (BATCH, min(b.x.shape[1] for b in batches[split]), 123)
    want, got = evaluate_both(trainers, *params, first)
    assert check_agreement(want, got, f"{split} first batch") == 0
    assert want[0]["valid_per"] == got[0]["valid_per"] < 0.2


def test_stagings_hold_the_same_batches(staged):
    """Both stagings hold the 192 utterances in the same batches: the
    train split's 3 bucket boundaries, batch 32, the tail batches; only
    the features' noise draws differ."""
    batches, _ = staged
    shapes = [b.x.shape[:2] for b in batches["synth"]]
    assert shapes == [b.x.shape[:2] for b in batches["host"]]
    assert sum(s[0] for s in shapes) == 192 and max(s[1] for s in shapes) == 192
    for s, h in zip(batches["synth"], batches["host"]):
        assert s.uids == h.uids
        for field in ("x_len", "y", "y_len", "y39"):
            np.testing.assert_array_equal(getattr(s, field), getattr(h, field))
        assert not np.array_equal(s.x, h.x)


@pytest.mark.slow
@pytest.mark.parametrize("split", ["synth", "host"])
def test_quality_gate_full_split(staged, trainers, params, split):
    """The whole held-out split: the port's PER equals the JAX package's
    within 0.001; on the host-built split it is the value chip_smoke.py
    holds the card to."""
    import chip_smoke

    batches, _ = staged
    want, got = evaluate_both(trainers, *params, batches[split])
    check_agreement(want, got, f"{split} split")
    if split == "host":
        assert got[0]["valid_per"] == pytest.approx(chip_smoke.HELD_OUT_PER_CPU, abs=1e-9)


@pytest.mark.slow
def test_awn_mu_per(staged, trainers):
    """The AWN stage's best checkpoint (its mu, the weights JAX evaluates
    AWN with) through the same path, on both stagings."""
    mu = jax.tree.map(np.asarray, jcheckpoint.load(str(AWN)))
    batches, _ = staged
    for split in ("synth", "host"):
        want, got = evaluate_both(trainers, mu, interop.to_torch(mu, "cpu"), batches[split])
        check_agreement(want, got, f"AWN mu, {split} split")


@pytest.mark.slow
def test_train_split_by_staging(params):
    """The checkpoint on the first three train batches of each staging:
    its eval-mode NLL a step (averaged over utterances, the train_nll of
    normalize_nll) and the global norm of the gradient of the mean
    per-utterance NLL; the JAX package's on both stagings, the port's on
    the host-built one. The checkpoint was trained on the DeviceSynth
    draws; chip_smoke.py's restart of the AWN stage trains on the
    host-built draws of the same utterances."""
    import jax.numpy as jnp
    import optax
    import torch

    from seq2seq_attention_asr_tpu_torch import tree

    train, _, _ = jsynthetic.timit_shaped(4000, 192, noise=NOISE, seed=SEED)
    base = lambda: jbatching.BucketedBatcher.from_dataset(train, BATCH, n_buckets=BUCKETS)
    stagings = {
        "synth": jbatching.CachedDeviceBatcher(base(), seed=SEED, synth=jbatching.DeviceSynth(
            jsynthetic.prototype_table(61, 123, SEED), noise=NOISE, seed=SEED)),
        "host": batching.CachedDeviceBatcher(batching.BucketedBatcher.from_dataset(
            train, BATCH, n_buckets=BUCKETS), seed=SEED, device="cpu")}
    jparams, tparams = params
    jmodel, model = jregistry.build("chorowski_dropout", **DIMS), registry.build(
        "chorowski_dropout", **DIMS)

    def jstats(p, x, xl, y, dm):
        oh = jax.nn.one_hot(y, 62) * dm[..., None]
        per = -(oh * jmodel.forward(p, x, xl, oh, dm)["logprobs"]).sum(-1).sum(-1)
        return jnp.mean(per), jnp.mean(per / dm.sum(-1))

    jgrad = jax.jit(jax.value_and_grad(jstats, has_aux=True))
    got = {}
    for name, batcher in stagings.items():
        rows = []
        for i, b in enumerate(batcher.batches(train)):
            if i == 3:
                break
            arrs = [np.asarray(a) for a in (b.x, b.x_len, b.y, b.dec_mask)]
            (_, nll), g = jgrad(jparams, *map(jnp.asarray, arrs))
            rows.append((float(nll), float(optax.global_norm(g))))
            if name == "host":
                leaves = [t.detach().requires_grad_(True) for t in tree.leaves(tparams)]
                x, xl, y, dm = map(torch.from_numpy, arrs)
                oh = torch.nn.functional.one_hot(y.long(), 62).float() * dm[..., None]
                lp = model.forward(tree.unflatten(tparams, leaves), x, xl, oh, dm)["logprobs"]
                per = -(oh * lp).sum(-1).sum(-1)
                gn = float(tree.global_norm(torch.autograd.grad(per.mean(), leaves)))
                np.testing.assert_allclose(float((per / dm.sum(-1)).mean().detach()), rows[-1][0],
                                           rtol=1e-4)
                np.testing.assert_allclose(gn, rows[-1][1], rtol=1e-3)
            print(f"train split, {name} staging, batch {i} {b.x.shape}: NLL a step "
                  f"{rows[-1][0]!r}, gradient norm {rows[-1][1]!r}")
        got[name] = np.mean(rows, axis=0)
        print(f"train split, {name} staging, first three batches: mean NLL a step "
              f"{got[name][0]!r}, mean gradient norm {got[name][1]!r}")
    assert got["synth"][0] < got["host"][0] / 3
