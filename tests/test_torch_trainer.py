"""The port's Trainer (epoch loop, evaluation, checkpoints, resume, NaN
restore) and its entry point `run_cli`, on the CPU, against the JAX
package's Trainer where the two can be compared.

Tolerances: a two-epoch fit from the same weights on the same batches
gives the JAX rows' train metrics and valid NLL within rtol 1e-4 (20
steps of float32 sums in another order, fed back through adadelta, as
tests/test_torch_train.py holds them), the same valid accuracy and PER
(equal tokens); MetricLog rows are equal; a resumed state is equal bit
for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.data import batching as jbatching
from seq2seq_attention_asr_tpu.data import features as jfeatures
from seq2seq_attention_asr_tpu.data import synthetic as jsynthetic
from seq2seq_attention_asr_tpu.data import timit as jtimit
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import tree
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic, timit
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, optim, trainer
from seq2seq_attention_asr_tpu_torch.utils import debug

SMALL = dict(input_frame_size=123, hidden_frame_size=12, output_frame_size=12, score_depth=12,
             state_depth=12, mlp_depth=8, output_depth=62)


@pytest.fixture
def one_thread():
    """The CPU runs of many tiny steps go faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_params(name, kw, seed=0):
    return jax.tree.map(np.asarray, jregistry.build(name, **kw).init(jax.random.PRNGKey(seed)))


def test_train_config_matches_jax():
    got = {f.name: f.default for f in dataclasses.fields(trainer.TrainConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainConfig)}
    # the port has no feeder thread
    want.pop("prefetch")
    assert got == want
    with pytest.raises(ValueError):
        trainer.Trainer(registry.build("chorowski", **SMALL), optim.OptimConfig(),
                        trainer.TrainConfig(noise="gauss"), device="cpu")
    with pytest.raises(NotImplementedError):
        trainer.Trainer(registry.build("chorowski", **SMALL), optim.OptimConfig(),
                        trainer.TrainConfig(), device="cpu", mesh=object())


def test_metric_log_rows_match_jax(tmp_path):
    rows = [{"epoch": 3, "train_loss": np.float32(1.25), "valid_per": 0.5, "event": "x",
             "n": np.int64(4)},
            {"epoch": 4, "loss": torch.tensor(2.5), "grad_norm": jax.numpy.asarray(0.75)}]
    got = trainer.MetricLog(str(tmp_path / "p" / "log.jsonl"))
    want = jtrainer.MetricLog(str(tmp_path / "j" / "log.jsonl"))
    for r in rows:
        got.append(dict(r, loss=float(r["loss"])) if "loss" in r else r)
        want.append(dict(r, loss=float(r["loss"])) if "loss" in r else r)
    assert got.rows == want.rows
    assert trainer.MetricLog.load(got.path) == jtrainer.MetricLog.load(want.path) == got.rows
    port_only = trainer.MetricLog(None)
    port_only.append(rows[1])
    assert port_only.rows == [{"epoch": 4.0, "loss": 2.5, "grad_norm": 0.75}]


@pytest.fixture(scope="module")
def corpus():
    """Two small TIMIT-shaped splits, short utterances."""
    port = synthetic.timit_shaped(16, 6, seed=1, max_len=10)
    jx = jsynthetic.timit_shaped(16, 6, seed=1, max_len=10)
    return port, jx


def test_fit_matches_jax(corpus, tmp_path, one_thread):
    """Two epochs of the flagship recipe at small widths, from the same
    weights, on the same batches: the same rows, the same checkpoints."""
    (train, valid, vocab), (jtrain, jvalid, jvocab) = corpus
    exp = experiment.timit_chorowski_normnll_colnorm()
    exp.model_kwargs.update(SMALL)
    tcfg = dataclasses.replace(exp.train, num_epochs=2, batch_size=4, beam_k=3)
    jtcfg = jtrainer.TrainConfig(num_epochs=2, batch_size=4, beam_k=3, normalize_nll=True,
                                 prefetch=0)
    jocfg = joptim.OptimConfig(**dataclasses.asdict(exp.optim))
    params = jax_params("chorowski", exp.model_kwargs)

    jtr = jtrainer.Trainer(jregistry.build("chorowski", **exp.model_kwargs), jocfg, jtcfg,
                           vocab=jvocab, save_dir=str(tmp_path / "jax"))
    jtr.init(params)
    want = list(jtr.fit(jtrain, jvalid, jbatching.BucketedBatcher.from_dataset(jtrain, 4, 2)))
    tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=vocab,
                         save_dir=str(tmp_path / "port"), device="cpu")
    tr.init(params)
    got = list(tr.fit(train, valid, batching.BucketedBatcher.from_dataset(train, 4, 2)))

    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("train_loss", "train_nll", "train_accuracy", "grad_norm", "valid_nll"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        for k in ("epoch", "penalty", "valid_accuracy", "valid_per"):
            assert g[k] == w[k], k
    assert tr.best == jtr.best
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    logged = trainer.MetricLog.load(str(tmp_path / "port" / "log.jsonl"))
    assert [r["epoch"] for r in logged] == [1.0, 2.0] and "valid_per" in logged[-1]


class Fixed:
    """A batcher that yields the given batches."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self, ds, **kw):
        return iter(self._batches)


def test_awn_dropout_fit_matches_jax(corpus, tmp_path, one_thread, monkeypatch):
    """Two epochs of the AWN stage (the dropout recipe, noise="awn") at
    small widths from the same weights on the same batches, with JAX's
    draws: the same rows, the last batch's awn_sigma_rms and param_norm
    among them, the evaluation at mu."""
    from test_torch_dropout import JaxDraws

    (train, valid, vocab), (jtrain, jvalid, jvocab) = corpus
    exp = experiment.timit_chorowski_dropout()
    exp.model_kwargs.update(SMALL)
    noise = dict(noise="awn", awn_lambda=1e-3, awn_sigma_init=0.02)
    tcfg = dataclasses.replace(exp.train, num_epochs=2, batch_size=4, beam_k=3, **noise)
    jtcfg = jtrainer.TrainConfig(num_epochs=2, batch_size=4, beam_k=3, normalize_nll=True,
                                 prefetch=0, **noise)
    jocfg = joptim.OptimConfig(**dataclasses.asdict(exp.optim))
    params = jax_params("chorowski_dropout", exp.model_kwargs)

    jtr = jtrainer.Trainer(jregistry.build("chorowski", **exp.model_kwargs), jocfg, jtcfg,
                           vocab=jvocab)
    jtr.init(params)
    want = list(jtr.fit(jtrain, jvalid, jbatching.BucketedBatcher.from_dataset(jtrain, 4, 2)))
    tr = trainer.Trainer(exp.build_model(), exp.optim, tcfg, vocab=vocab, device="cpu")
    tr.init(params)
    draws = JaxDraws(tcfg.seed)
    draws.install(monkeypatch)
    step = tr.step_fn

    def drawn_step(state, batch):
        draws.next_step()
        return step(state, batch)

    tr.step_fn = drawn_step
    got = list(tr.fit(train, valid, batching.BucketedBatcher.from_dataset(train, 4, 2)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and "awn_sigma_rms" in g
        for k in ("train_loss", "train_nll", "train_accuracy", "grad_norm", "valid_nll",
                  "awn_sigma_rms", "param_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        for k in ("epoch", "penalty", "valid_accuracy", "valid_per"):
            assert g[k] == w[k], k
    assert tr.best == jtr.best
    assert got[-1]["train_loss"] > got[-1]["train_nll"]


def test_awn_dropout_trainer_resumes_its_state_and_generator(tmp_path):
    """An AWN trainer with dropout: its checkpoint holds (mu, s), the
    optimizer state over both and the generator, on the trainer's device;
    one epoch, then a resumed second, ends where two epochs straight do,
    bit for bit."""
    ds = _toy_dataset()
    exp = _toy_recipe(tmp_path)
    exp.model_kwargs["dropout"] = 0.5
    tcfg = dataclasses.replace(exp.train, noise="awn", awn_lambda=0.01, awn_sigma_init=0.05)
    batcher = batching.BucketedBatcher.from_dataset(ds, 2, n_buckets=1)
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")

    def make(save_dir, epochs):
        tr = trainer.Trainer(exp.build_model(), exp.optim,
                             dataclasses.replace(tcfg, num_epochs=epochs), save_dir=save_dir,
                             device="cpu")
        tr.init(params)
        return tr

    straight = make(str(tmp_path / "a"), 2)
    list(straight.fit(ds, ds, batcher, decode_every=0))
    assert straight.state[2].device.type == "cpu" and set(straight.state[0]) == {"mu", "s"}
    list(make(str(tmp_path / "b"), 1).fit(ds, ds, batcher, decode_every=0))
    saved = checkpoint.load(str(tmp_path / "b" / "ckpt_latest"), device="cpu")
    assert set(saved["state"][0]) == {"mu", "s"} and set(saved["state"][1][0]) == {"var", "acc"}
    assert set(saved["state"][1][0]["var"]) == {"mu", "s"}
    resumed = make(str(tmp_path / "b"), 2)
    rows = list(resumed.fit(ds, ds, batcher, resume=True, decode_every=0))
    assert [r["epoch"] for r in rows] == [2]
    for a, b in zip(tree.leaves(list(straight.state[:2])), tree.leaves(list(resumed.state[:2]))):
        assert torch.equal(a, b)
    assert torch.equal(straight.state[2].get_state(), resumed.state[2].get_state())


def test_run_cli_trains_the_awn_stage(tmp_path):
    """run_cli with an experiment that asks for AWN and dropout: the
    trainer's state is (mu, s), and the epoch rows carry awn_sigma_rms."""
    pytest.importorskip("h5py")
    root = str(tmp_path / "TIMIT")
    _make_corpus(root, {"TRAIN": ["MAAA0", "MBBB0"], "TEST": ["MCCC0"]})
    train, valid, _, _, _, _ = jtimit.build_datasets(root, feature_fn=jfeatures.logmel_np, pad=2)
    data = str(tmp_path / "data")
    os.makedirs(data)
    jtimit.save_hdf5(train, os.path.join(data, "train.h5"))
    jtimit.save_hdf5(valid, os.path.join(data, "valid.h5"))

    def awn_stage(save_dir=None):
        exp = experiment.scriptchecker(save_dir=save_dir)
        exp.model_kwargs["dropout"] = 0.5
        exp.train = dataclasses.replace(exp.train, noise="awn", awn_lambda=1e-3,
                                        awn_sigma_init=0.01)
        return exp

    save = str(tmp_path / "run")
    tr = experiment.run_cli(awn_stage, "scriptchecker",
                            ["--cpu", "--data", data, "--save", save, "--decode-every", "0"])
    assert tr.epoch == 2 and set(tr.state[0]) == {"mu", "s"}
    rows = trainer.MetricLog.load(os.path.join(save, "log.jsonl"))
    assert all(0.0099 < r["awn_sigma_rms"] < 0.0101 and np.isfinite(r["train_loss"])
               for r in rows)


def test_attention_and_prediction_dumps_match_jax(corpus, tmp_path):
    """attn_epoch1.npz (alpha, the Ws and Vh projections, the log-probs of
    the first valid batch) and predictions_epoch1.npz hold the JAX
    package's arrays (floats within 1e-5); a best-metric copy of an epoch
    that wrote no dump falls back to the newest one and logs it."""
    (_, valid, vocab), (_, jvalid, jvocab) = corpus
    params = jax_params("chorowski", SMALL, seed=3)
    batches = list(batching.BucketedBatcher([48, 256], 4).batches(valid))
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    jtr = jtrainer.Trainer(jregistry.build("chorowski", **SMALL), joptim.OptimConfig(),
                           jtrainer.TrainConfig(beam_k=2, prefetch=0, dump_attention=True,
                                                dump_predictions=True),
                           vocab=jvocab, save_dir=dirs["jax"])
    jtr.state = (params, None, None)
    tr = trainer.Trainer(registry.build("chorowski", **SMALL), optim.OptimConfig(),
                         trainer.TrainConfig(beam_k=2, dump_attention=True, dump_predictions=True),
                         vocab=vocab, save_dir=dirs["port"], device="cpu")
    tr.init(params)
    want, got = jtr.evaluate(jvalid, Fixed(batches)), tr.evaluate(valid, Fixed(batches))
    assert got["valid_per"] == want["valid_per"]
    for name in ("attn_epoch1.npz", "predictions_epoch1.npz"):
        with np.load(os.path.join(dirs["jax"], name)) as w, \
                np.load(os.path.join(dirs["port"], name)) as g:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                if w[k].dtype.kind == "f":
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5, err_msg=k)
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tr.epoch = 2
    tr._copy_predictions("best_valid_PER")
    assert os.path.exists(os.path.join(dirs["port"], "predictions_best_valid_PER.npz"))
    assert tr.log.rows[-1] == {"epoch": 2.0, "event": "predictions_fallback",
                               "tag": "best_valid_PER", "source": "predictions_epoch1.npz"}


def test_evaluate_scores_raw_ids_without_a_vocab(corpus):
    """Without a vocab (or without y39) the error rate is taken on the raw
    ids, as in the JAX package."""
    (train, valid, _), (jtrain, jvalid, _) = corpus
    params = jax_params("chorowski", SMALL, seed=3)
    batches = list(batching.BucketedBatcher([48, 256], 4).batches(valid))
    jtr = jtrainer.Trainer(jregistry.build("chorowski", **SMALL), joptim.OptimConfig(),
                           jtrainer.TrainConfig(beam_k=2, prefetch=0))
    jtr.state = (params, None, None)
    tr = trainer.Trainer(registry.build("chorowski", **SMALL), optim.OptimConfig(),
                         trainer.TrainConfig(beam_k=2), device="cpu")
    tr.init(params)
    want = jtr.evaluate(jvalid, Fixed(batches))
    got = tr.evaluate(valid, Fixed(batches))
    assert got["valid_per"] == want["valid_per"] and got["valid_accuracy"] == want["valid_accuracy"]
    np.testing.assert_allclose(got["valid_nll"], want["valid_nll"], rtol=1e-5)
    assert set(tr.evaluate(valid, Fixed(batches), decode=False)) == \
        {"valid_nll", "valid_accuracy", "valid_seconds"}


def _toy_dataset():
    rng = np.random.RandomState(0)
    return timit.Dataset(
        uids=[f"u{i}" for i in range(4)],
        x=[rng.randn(rng.randint(10, 16), 8).astype(np.float32) for _ in range(4)],
        y=[rng.randint(0, 6, rng.randint(3, 6)).astype(np.int32) for _ in range(4)],
        y39=None, start=[np.zeros(0)] * 4, finish=[np.zeros(0)] * 4)


def _toy_recipe(tmp_path):
    exp = experiment.scriptchecker(save_dir=str(tmp_path / "run"))
    exp.model_kwargs.update(input_frame_size=8, hidden_frame_size=8, output_frame_size=8,
                            score_depth=8, state_depth=8, mlp_depth=8, output_depth=7)
    exp.train = dataclasses.replace(exp.train, num_epochs=2, max_samples=None)
    return exp


def test_trainer_resume(tmp_path):
    """A new Trainer resumes the epoch counter, the best metrics and the
    train state (params, optimizer state, generator) of ckpt_latest, and
    runs only the epochs left (timit.lua:85-96, 469-490)."""
    ds = _toy_dataset()
    exp = _toy_recipe(tmp_path)
    batcher = batching.BucketedBatcher.from_dataset(ds, 2, n_buckets=1)
    tr1 = trainer.Trainer(exp.build_model(), exp.optim, exp.train, save_dir=exp.save_dir,
                          device="cpu")
    tr1.init(exp.init_params(torch.Generator().manual_seed(0), device="cpu"))
    rows1 = list(tr1.fit(ds, ds, batcher, decode_every=0))
    assert len(rows1) == 2 and "valid_per" not in rows1[-1]

    tr2 = trainer.Trainer(exp.build_model(), exp.optim,
                          dataclasses.replace(exp.train, num_epochs=3), save_dir=exp.save_dir,
                          device="cpu")
    tr2.init(exp.init_params(torch.Generator().manual_seed(99), device="cpu"))  # overwritten
    # ckpt_latest is written before the epoch's best metrics are updated,
    # as in the JAX package
    saved = checkpoint.load(os.path.join(exp.save_dir, "ckpt_latest"), device="cpu")
    assert tr2.resume() and tr2.epoch == 2 and tr2.best == saved["best"]
    for a, b in zip(tree.leaves(list(tr1.state[:2])), tree.leaves(list(tr2.state[:2]))):
        assert torch.equal(a, b)
    assert torch.equal(tr1.state[2].get_state(), tr2.state[2].get_state())
    rows2 = list(tr2.fit(ds, ds, batcher, resume=True, decode_every=0))
    assert tr2.epoch == 3 and [r["epoch"] for r in rows2] == [3]
    assert len(trainer.MetricLog.load(os.path.join(exp.save_dir, "log.jsonl"))) == 3


def test_nan_restore(tmp_path):
    """A loss that goes non-finite raises NonFiniteError naming the bad
    leaves (on_nan="raise"), or rolls back to ckpt_latest with a new
    shuffle and goes on (on_nan="restore")."""
    ds = _toy_dataset()
    exp = _toy_recipe(tmp_path)
    exp.train = dataclasses.replace(exp.train, num_epochs=3)
    batcher = batching.BucketedBatcher.from_dataset(ds, 2, n_buckets=1)
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, save_dir=exp.save_dir,
                         device="cpu")
    tr.init(exp.init_params(torch.Generator().manual_seed(0), device="cpu"))
    step, calls = tr.step_fn, []

    def poisoned(state, batch):  # the 3rd step (epoch 2) blows up once
        calls.append(1)
        state, m = step(state, batch)
        if len(calls) == 3:
            params = tree.tree_map(lambda t: t * float("nan"), state[0])
            state, m = (params,) + tuple(state[1:]), dict(m, loss=m["loss"] * float("nan"))
        return state, m

    tr.step_fn = poisoned
    after_epoch1 = []
    for row in tr.fit(ds, ds, batcher, decode_every=0, on_nan="restore"):
        if row["epoch"] == 1:
            after_epoch1 = [t.clone() for t in tree.leaves(tr.state[0])]
    log = trainer.MetricLog.load(os.path.join(exp.save_dir, "log.jsonl"))
    events = [r for r in log if r.get("event") == "nan_restore"]
    assert len(events) == 1 and events[0]["epoch"] == 2.0 and events[0]["restores"] == 1.0
    assert "non-finite" in events[0]["detail"]
    assert [r["epoch"] for r in log if "event" not in r] == [1.0, 2.0, 3.0]
    assert tr.epoch == 3 and tr.tcfg.seed == exp.train.seed + 101
    assert not debug.find_nonfinite(tr.state[0]) and after_epoch1

    tr2 = trainer.Trainer(exp.build_model(), exp.optim, exp.train, device="cpu")
    tr2.init(exp.init_params(torch.Generator().manual_seed(0), device="cpu"))
    step2 = tr2.step_fn
    tr2.step_fn = lambda s, b: (lambda st, m: ((tree.tree_map(lambda t: t * float("nan"), st[0]),)
                                               + tuple(st[1:]), dict(m, loss=m["loss"] * np.nan)))(
        *step2(s, b))
    with pytest.raises(debug.NonFiniteError) as e:
        list(tr2.fit(ds, ds, batcher, decode_every=0, on_nan="restore"))  # no save_dir
    assert "['decoder']['w_e']" in e.value.paths


def test_checkpoint_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    gen.manual_seed(7)
    torch.randn(3, generator=gen)
    blob = {"state": ({"a": torch.arange(3.0), "r": [{}, {"w": torch.ones(2, 2)}]},
                      [{"var": torch.zeros(1)}, None], gen),
            "epoch": 4, "best": {"valid_per": float("inf"), "valid_accuracy": 0.5}}
    path = str(tmp_path / "d" / "ckpt_latest")
    assert not checkpoint.exists(path)
    checkpoint.save(path, blob)
    assert checkpoint.exists(path) and not os.path.exists(path + ".tmp")
    got = checkpoint.load(path, device="cpu")
    assert got["epoch"] == 4 and got["best"] == blob["best"]
    assert isinstance(got["state"], tuple) and got["state"][1][1] is None
    assert torch.equal(got["state"][0]["r"][1]["w"], torch.ones(2, 2))
    assert torch.equal(torch.randn(4, generator=got["state"][2]), torch.randn(4, generator=gen))


def _write_sphere(path, pcm, sr=16000):
    hdr = (b"NIST_1A\n    1024\n" + f"sample_rate -i {sr}\nsample_count -i {len(pcm)}\n"
           f"sample_n_bytes -i 2\nsample_byte_format -s2 01\n"
           f"sample_coding -s3 pcm\nend_head\n".encode())
    with open(path, "wb") as f:
        f.write(hdr + b" " * (1024 - len(hdr)) + pcm.astype("<i2").tobytes())


def _make_corpus(root, speakers, n_utts=2, sr=16000):
    """A miniature TIMIT tree: SPHERE audio, .PHN and .WRD files."""
    rng = np.random.RandomState(0)
    phones = ["h#", "aa", "b", "iy", "t"]
    for split, spks in speakers.items():
        for spk in spks:
            d = os.path.join(root, split, "DR1", spk)
            os.makedirs(d, exist_ok=True)
            for u in range(n_utts):
                n = sr // 2
                _write_sphere(os.path.join(d, f"SX{u}.WAV"), (rng.randn(n) * 2000).astype(np.int16))
                seg = n // 4
                with open(os.path.join(d, f"SX{u}.PHN"), "w") as f:
                    for k in range(4):
                        f.write(f"{k * seg} {(k + 1) * seg} {phones[(u + k) % len(phones)]}\n")
                with open(os.path.join(d, f"SX{u}.WRD"), "w") as f:
                    f.write(f"0 {n} word\n")


def test_scriptchecker_end_to_end(tmp_path):
    """The port twin of tests/test_end_to_end.py::test_scriptchecker_end_to_end:
    the JAX package's offline pipeline writes the HDF5 splits, the port's
    run_cli trains the scriptchecker recipe on them for two epochs on the
    CPU, decodes, logs and checkpoints, then resumes for a third."""
    pytest.importorskip("h5py")
    root = str(tmp_path / "TIMIT")
    _make_corpus(root, {"TRAIN": ["MAAA0", "MBBB0", "MTLB0"], "TEST": ["MCCC0"]})
    train, valid, _, vocab, _, _ = jtimit.build_datasets(root, feature_fn=jfeatures.logmel_np,
                                                         pad=2)
    data = str(tmp_path / "data")
    os.makedirs(data)
    jtimit.save_hdf5(train, os.path.join(data, "train.h5"))
    jtimit.save_hdf5(valid, os.path.join(data, "valid.h5"))
    save = str(tmp_path / "run")
    tr = experiment.run_cli(experiment.scriptchecker, "scriptchecker",
                            ["--cpu", "--data", data, "--save", save, "--decode-every", "2"])
    assert tr.device.type == "cpu" and tr.epoch == 2 and tr.vocab is not None
    assert tr.model.cfg.output_depth == vocab.size
    rows = trainer.MetricLog.load(os.path.join(save, "log.jsonl"))
    assert len(rows) == 2 and np.isfinite(rows[-1]["train_nll"])
    # an untrained model can emit up to maxseqlen tokens: PER may exceed 1
    assert "valid_per" not in rows[0] and 0.0 <= rows[-1]["valid_per"] <= 10.0
    assert checkpoint.exists(os.path.join(save, "ckpt_latest"))
    assert json.load(open(os.path.join(save, "experiment.json")))["name"] == "exp0_scriptchecker"
    tr = experiment.run_cli(experiment.scriptchecker, "scriptchecker",
                            ["--cpu", "--data", data, "--save", save, "--resume", "--epochs", "3",
                             "--decode-every", "0"])
    assert tr.epoch == 3 and len(trainer.MetricLog.load(os.path.join(save, "log.jsonl"))) == 3
    for argv in (["--dp", "2"], ["--sp", "2"]):
        with pytest.raises(NotImplementedError):
            experiment.run_cli(experiment.scriptchecker, "scriptchecker",
                               ["--cpu", "--data", data] + argv)
    # a TIMIT directory is no LibriSpeech one: it has no meta.txt
    with pytest.raises(FileNotFoundError, match="meta.txt"):
        experiment.run_cli(experiment.scriptchecker, "librispeech", ["--cpu", "--data", data])


def test_memorization_beam_per_under_5pct(one_thread):
    """The port twin of tests/test_convergence.py::test_memorization_beam_per_under_5pct,
    from the JAX init carried across: the flagship recipe memorizes a tiny
    synthetic corpus to beam PER < 5%, with exact beam matches."""
    train, _, v = synthetic.train_valid(12, 2, n_phones=7, feat_dim=16, min_len=3, max_len=6,
                                        seed=0)
    kw = dict(input_frame_size=16, hidden_frame_size=32, output_frame_size=32, score_depth=32,
              state_depth=32, mlp_depth=24, output_depth=v, feature_maps=0, filt_size=5)
    tcfg = trainer.TrainConfig(num_epochs=400, batch_size=6, normalize_nll=True, beam_k=3)
    tr = trainer.Trainer(registry.build("chorowski", **kw), optim.OptimConfig(maxnorm=100.0),
                         tcfg, device="cpu")
    tr.init(jax_params("chorowski", kw))
    batcher = batching.BucketedBatcher.from_dataset(train, 6, n_buckets=1)
    best = float("inf")
    for row in tr.fit(train, train, batcher, decode_every=25):
        if "valid_per" in row:
            best = min(best, row["valid_per"])
            if best < 0.05:
                break
    assert best < 0.05, f"beam-search PER never dropped below 5% (best {best:.3f})"
    params = trainer.eval_params(tcfg, tr.state[0])
    b = next(batcher.batches(train))
    x, xl, y = torch.from_numpy(b.x), torch.from_numpy(b.x_len), b.y
    eos = torch.from_numpy(y[np.arange(len(y)), b.y_len - 1])
    res = tr.decode_fn(params, x, xl, eos, max_steps_cap=int(x.shape[1]))
    exact = sum(int(b.y_len[i]) == int(res.lengths[i])
                and np.array_equal(y[i][: b.y_len[i]], res.tokens[i, : int(res.lengths[i])].numpy())
                for i in range(len(y)))
    assert exact >= len(y) - 1, f"only {exact}/{len(y)} exact beam matches"
