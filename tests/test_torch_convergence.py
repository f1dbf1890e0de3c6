"""The port's convergence harness (tools/convergence_torch.py) against the
JAX package's (tools/convergence.py), on the CPU at --small widths.

(a) Both harnesses build the same corpora, array for array: the default
mode's 40-phone corpus, VGG's frequency-smoothed stacked features, the
chunk split of the out-of-core epoch, and the TIMIT-shaped corpus with
its bootstrap subset. (b) Two epochs of each default-mode recipe, one
of them chunked, from JAX's initial weights: the same batches in the
same order, each port step taken from the JAX run's weights before it
gives that JAX step's loss, nll and grad_norm within rtol 1e-4 and its
token counts exactly, and the free-running rows match the JAX rows:
train_loss, train_nll, train_accuracy, grad_norm and valid_nll within
rtol 1e-4 (the tolerance of tests/test_torch_trainer.py's
test_fit_matches_jax: float32 sums in another order, fed back through
adadelta), valid_accuracy and valid_per equal. VGG's free-running rows
are held for its first epoch only: its training is chaotic from its
first steps at this size (a 1e-7 relative change of its initial weights
moves the port's own grad norm by 1e-2 within 8 steps, ~10x a step), so
no float32 run in another sum order stays within 1e-4 of it for two
epochs; its second epoch is held step by step along JAX's trajectory.
VGG's case of (b) is tests/test_torch_convergence_vgg.py and (c), the
TIMIT-shaped curriculum, tests/test_torch_convergence_timit.py: files of
their own, so that the JAX runs compile on more than one worker.

The JAX harness is loaded from its file under another module name (its
__main__ takes a chip lease) and run with sys.argv patched; its
Trainer.init, Trainer.fit, step functions and
BucketedBatcher.from_dataset are wrapped to record the initial weights,
the corpora, the steps and the bucketed datasets, and the port's
likewise.
"""

import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.data import batching as jbatching
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.data import batching
from seq2seq_attention_asr_tpu_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--small", "--train-utts", "24", "--valid-utts", "8"]
ROW_CLOSE = ("train_loss", "train_nll", "train_accuracy", "grad_norm", "valid_nll")
ROW_EQUAL = ("epoch", "valid_accuracy", "valid_per")


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harnesses():
    return (load("jax_convergence_harness", ROOT / "tools" / "convergence.py"),
            load("convergence_torch_harness", ROOT / "tools" / "convergence_torch.py"))


@pytest.fixture
def one_thread():
    """The CPU runs of many tiny steps go faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stop(Exception):
    """Raised by a recording Trainer.fit to end a harness before training."""


def as_numpy(tree):
    """A JAX tree or a port tree of tensors, its leaves as numpy arrays."""
    if isinstance(tree, (list, tuple)) and tree and isinstance(tree[0], torch.Tensor):
        return [t.detach().cpu().numpy() for t in tree]
    if any(isinstance(t, torch.Tensor) for t in jax.tree.leaves(tree)):
        return interop.to_numpy(tree)
    return jax.tree.map(np.asarray, tree)


class Recorder:
    """Wraps a package's Trainer.init and Trainer.fit and
    BucketedBatcher.from_dataset: the first init's weights (numpy), every
    fit's (train, valid, chunked) and every bucketed dataset; with stop,
    the first fit raises Stop. With steps, every train step's weights
    before it, batch and metrics (numpy), and the trainers."""

    def __init__(self, monkeypatch, trainer_mod, batching_mod, stop=False, steps=False):
        self.inits, self.fits, self.bucketed, self.steps, self.trainers = [], [], [], [], []
        cls = trainer_mod.Trainer
        init, fit = cls.init, cls.fit
        from_dataset = batching_mod.BucketedBatcher.from_dataset.__func__

        def rec_init(tr, params):
            self.inits.append(as_numpy(params) if trainer_mod is jtrainer else params)
            self.trainers.append(tr)
            state = init(tr, params)
            if steps:
                step = tr.step_fn

                def rec_step(state, batch):
                    before = as_numpy(state[0])
                    state, m = step(state, batch)
                    self.steps.append((before, as_numpy(list(batch)),
                                       {k: float(v) for k, v in m.items()}))
                    return state, m

                tr.step_fn = rec_step
            return state

        def rec_fit(tr, train, valid, batcher, **kw):
            self.fits.append((train, valid, kw.get("chunked")))
            if stop:
                raise Stop
            return fit(tr, train, valid, batcher, **kw)

        def rec_from_dataset(klass, ds, batch_size, n_buckets=8):
            self.bucketed.append((ds, n_buckets))
            return from_dataset(klass, ds, batch_size, n_buckets)

        monkeypatch.setattr(cls, "init", rec_init)
        monkeypatch.setattr(cls, "fit", rec_fit)
        monkeypatch.setattr(batching_mod.BucketedBatcher, "from_dataset",
                            classmethod(rec_from_dataset))


def run_jax(mod, argv, monkeypatch, stop=False, steps=False):
    """The JAX harness on argv: (recorder, trajectory rows or None)."""
    rec = Recorder(monkeypatch, jtrainer, jbatching, stop, steps)
    monkeypatch.setattr(sys, "argv", ["convergence.py", *argv])
    try:
        mod.main()
    except Stop:
        return rec, None
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        return rec, json.load(f)["trajectory"]


def run_port(mod, argv, monkeypatch, stop=False, steps=False, init_params=None):
    """The port's harness on argv with --cpu: (recorder, rows or None)."""
    rec = Recorder(monkeypatch, trainer, batching, stop, steps)
    try:
        rows = mod.main([*argv, "--cpu"], init_params=init_params)
    except Stop:
        return rec, None
    return rec, rows


def assert_same_dataset(got, want, tag):
    assert len(got) == len(want) > 0, tag
    assert list(got.uids) == list(want.uids), tag
    for field in ("x", "y", "y39", "start", "finish"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, (tag, field)
            continue
        assert len(g) == len(w), (tag, field)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape and a.dtype == b.dtype, (tag, field, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {field}[{i}]")


def assert_same_chunks(got, want, tag):
    assert got is not None and want is not None and got[1] == want[1], tag
    for i in range(want[1]):
        assert_same_dataset(got[0](i), want[0](i), f"{tag} chunk {i}")


CORPORA = {
    "default_40_phones": ["--model", "chorowski", "--n-phones", "40"],
    "vgg_stack3": ["--model", "vgg", "--chunks", "2"],
    "chunk_split": ["--model", "chorowski", "--train-utts", "25", "--chunks", "3"],
    "timit_shape": ["--timit-shape", "--host-features", "--train-utts", "60",
                    "--stage-epochs", "1,1,0"],
}


@pytest.mark.parametrize("case", list(CORPORA))
def test_corpora_equal_the_jax_harness(case, harnesses, tmp_path, monkeypatch):
    jmod, pmod = harnesses
    argv = SMALL + CORPORA[case] + ["--out", str(tmp_path / "out.json")]
    jrec, _ = run_jax(jmod, argv, monkeypatch, stop=True)
    prec, _ = run_port(pmod, argv, monkeypatch, stop=True)
    (train, valid, chunked), = prec.fits
    (jtrain, jvalid, jchunked), = jrec.fits
    assert_same_dataset(train, jtrain, "train")
    assert_same_dataset(valid, jvalid, "valid")
    assert [n for _, n in prec.bucketed] == [n for _, n in jrec.bucketed]
    for (ds, _), (jds, _) in zip(prec.bucketed, jrec.bucketed):
        assert_same_dataset(ds, jds, "bucketed")
    if case == "vgg_stack3":
        assert train.x[0].ndim == 3 and train.x[0].shape[1:] == (40, 3)
    if "--chunks" in argv:
        assert_same_chunks(chunked, jchunked, case)
    else:
        assert chunked is None and jchunked is None
    if case == "timit_shape":
        # the boot stage trains on the <=17-token subset; the full corpus
        # is bucketed first (3 buckets), the subset after (2)
        full, boot = prec.bucketed[0][0], prec.bucketed[1][0]
        assert train is boot and 0 < len(boot) < len(full)
        assert all(len(y) <= 17 for y in boot.y)
        assert sum(len(y) <= 17 for y in full.y) == len(boot)


def assert_rows_match(got, want, keys_equal=ROW_EQUAL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ROW_CLOSE:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"epoch {w['epoch']} {k}")
        for k in keys_equal:
            assert g.get(k) == w.get(k), (w["epoch"], k, g.get(k), w.get(k))


def assert_steps_along_jax(prec, jrec):
    """The port's steps took the JAX steps' batches in their order, and
    the port's step function from each JAX step's weights gives its
    metrics."""
    assert len(prec.steps) == len(jrec.steps) > 0
    tr = prec.trainers[0]
    for i, ((_, batch, _), (params, jbatch, jm)) in enumerate(zip(prec.steps, jrec.steps)):
        for a, b in zip(batch, jbatch):
            np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
        state = tr.init_fn(interop.to_torch(params, "cpu"), torch.Generator())
        _, m = tr.step_fn(state, tuple(torch.from_numpy(a) for a in batch))
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("correct", "total"):
            assert float(m[k]) == jm[k], (i, k)


def check_default_fit(extra, tmp_path, monkeypatch, held_epochs=2):
    """(b) for a default-mode recipe (argv `extra`): two epochs through
    both harnesses, the steps along JAX's trajectory, the first
    `held_epochs` free-running rows, and the JSON the port wrote."""
    jmod, pmod = (load("jax_convergence_harness", ROOT / "tools" / "convergence.py"),
                  load("convergence_torch_harness", ROOT / "tools" / "convergence_torch.py"))
    argv = SMALL + extra + ["--epochs", "2", "--decode-every", "1"]
    jrec, want = run_jax(jmod, argv + ["--out", str(tmp_path / "jax.json")], monkeypatch,
                         steps=True)
    prec, got = run_port(pmod, argv + ["--out", str(tmp_path / "port.json")], monkeypatch,
                         steps=True, init_params=jrec.inits[0])
    assert [r["epoch"] for r in got] == [1, 2] and all("valid_per" in r for r in got)
    assert_steps_along_jax(prec, jrec)
    assert_rows_match(got[:held_epochs], want[:held_epochs])
    with open(tmp_path / "port.json") as f:
        written = json.load(f)
    assert written["trajectory"] == json.loads(json.dumps(got))
    assert written["meta"]["backend"] == "cpu" and "device" not in written["meta"]
    assert written["meta"]["chunks"] == (2 if "--chunks" in argv else 1)


@pytest.mark.parametrize("model", ["chorowski", "conv_bilstm"])
def test_default_mode_rows_match_the_jax_harness(model, tmp_path, monkeypatch, one_thread):
    check_default_fit(["--model", model], tmp_path, monkeypatch)


def test_timit_shape_stages_keep_their_own_checkpoints(harnesses, tmp_path, one_thread):
    """With --save-dir each stage checkpoints into a directory of its own,
    the full stage with its own best-metric record (the boot stage's
    best PER does not stop the full stage's from being saved), the AWN
    stage's best evaluation weights are exported, and --awn-only
    restarts the AWN stage from the full stage's checkpoint."""
    from seq2seq_attention_asr_tpu_torch.train import checkpoint

    _, pmod = harnesses
    argv = ["--small", "--timit-shape", "--train-utts", "24", "--valid-utts", "4",
            "--decode-every", "1", "--save-dir", str(tmp_path / "run"), "--cpu"]
    rows = pmod.main(argv + ["--stage-epochs", "1,1,1", "--out", str(tmp_path / "a.json")])
    assert [r["stage"] for r in rows] == ["boot", "full", "awn"]
    for stage in ("boot", "full", "awn"):
        assert (tmp_path / "run" / stage / "ckpt_latest").is_file(), stage
        assert trainer.MetricLog.load(str(tmp_path / "run" / stage / "log.jsonl")), stage
    full_best = tmp_path / "run" / "full" / "ckpt_best_valid_PER"
    assert checkpoint.load(str(full_best), device="cpu")["best"]["valid_per"] == \
        rows[1]["valid_per"]
    assert (tmp_path / "run" / "awn" / "ckpt_best_eval").is_file()
    again = pmod.main(argv + ["--stage-epochs", "0,0,1", "--awn-only", "--from-ckpt",
                              str(full_best), "--out", str(tmp_path / "b.json")])
    assert [r["stage"] for r in again] == ["awn"]
    np.testing.assert_allclose(again[0]["train_loss"], rows[2]["train_loss"], rtol=1e-4)


def test_the_harness_needs_a_card_unless_asked_for_the_cpu(harnesses, tmp_path, monkeypatch):
    _, pmod = harnesses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmod.main(SMALL + ["--epochs", "1", "--out", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()
