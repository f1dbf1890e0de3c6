"""The port's LibriSpeech path against the JAX package on the CPU: the
channel-stacked front end (through K3's plain version and in numpy)
and its corpus normalization, the vocabularies and the chunked
directory (manifest, meta), the out-of-core chunked epoch, and run_cli
"librispeech" on a data directory that the JAX package's own
tools/preprocess_librispeech.py writes from an in-process FLAC tree:
the character and VGG recipes, and the word recipe.

Tolerances: the stacked front end as tests/test_torch_kernels.py holds
K3's assembled features (dB within 1e-4 of the Pallas kernel in
interpret mode, the deltas 20x and the delta-deltas 400x that); the
numpy features and the normalization equal; a fit's rows from the same
weights on the same batches as tests/test_torch_trainer.py holds them
(train metrics and valid NLL rtol 1e-4, valid accuracy and PER equal).
"""

import dataclasses
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.data import batching as jbatching
from seq2seq_attention_asr_tpu.data import features as jfeatures
from seq2seq_attention_asr_tpu.data import librispeech as jls
from seq2seq_attention_asr_tpu.data import timit as jtimit
from seq2seq_attention_asr_tpu.ops.pallas import logmel as jlm
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.data import batching, features
from seq2seq_attention_asr_tpu_torch.data import librispeech as ls
from seq2seq_attention_asr_tpu_torch.data import timit
from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel
from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = ("train_loss", "train_nll", "train_accuracy", "grad_norm", "valid_nll")


def _pcm(b, n, seed):
    """A tone per row over white noise of 2/3 its amplitude (the
    noise floor of tests/test_torch_kernels.py)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * (300 + 200 * np.arange(b))[:, None] * t[None])
    return (tone + 0.2 * rng.randn(b, n)).astype(np.float32)


@pytest.mark.parametrize("channel,scale", [(0, 1), (1, 20), (2, 400)])
def test_logmel_stacked_matches_pallas(channel, scale):
    """(B, 3, L, 40) from K3's plain version against the JAX kernel in
    interpret mode, on equal-length rows (the peak clip takes each row's
    max over every frame, padding included, in both)."""
    y = _pcm(2, 16 * 512 - 1, 4)
    want = np.asarray(jlm.logmel_stacked_pallas(jnp.asarray(y), 16000, interpret=True))
    got = logmel.logmel_stacked(torch.from_numpy(y), 16000).numpy()
    assert got.shape == want.shape == (2, 3, 16, 40)
    np.testing.assert_allclose(got[:, channel], want[:, channel], rtol=0, atol=1e-4 * scale)


def test_logmel_stacked_np_and_its_normalization_match_jax():
    """The offline stacked features and normalize_corpus's stacked branch
    (statistics over the frames of each channel and bin, pad frames of
    zeros at both ends), and the flat branch."""
    ys = [_pcm(1, n, s)[0] for n, s in ((6000, 1), (9000, 2), (4500, 3))]
    got = [features.logmel_stacked_np(y, 16000) for y in ys]
    want = [jfeatures.logmel_stacked_np(y, 16000) for y in ys]
    for g, w in zip(got, want):
        assert g.shape[0] == 3 and g.shape[2] == 40
        np.testing.assert_array_equal(g, w)
    for pad in (1, 3):
        for g, w in zip(features.normalize_corpus(got[:2], got[2:], pad=pad),
                        jfeatures.normalize_corpus(want[:2], want[2:], pad=pad)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    flat = [np.random.RandomState(i).randn(5 + i, 4) for i in range(3)]
    for g, w in zip(features.normalize_corpus(flat, pad=2), jfeatures.normalize_corpus(flat, pad=2)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


TEXTS = ["HELLO WORLD", "THE CAT SAT", "A DOG RAN FAST", "SHE SAW THE SEA", "GOOD DAY TO YOU"]


def test_vocab_matches_jax():
    got, want = ls.build_vocab(TEXTS), jls.build_vocab(TEXTS)
    assert got.charmap == want.charmap and got.wordmap == want.wordmap
    for labelset in ("chars", "words"):
        assert got.size(labelset) == want.size(labelset)
        for t in TEXTS:
            np.testing.assert_array_equal(got.to_ids(t, labelset), want.to_ids(t, labelset))
    ids = got.to_ids(TEXTS[2], "chars")
    assert ids[-1] == got.charmap[ls.EOS] == got.num_chars - 1
    assert got.ids_to_chars(ids) == want.ids_to_chars(ids) == TEXTS[2]
    assert got.ids_to_words(got.to_ids(TEXTS[3], "words")) == TEXTS[3]
    with pytest.raises(ValueError):
        got.to_ids(TEXTS[0], "phones")


def _dataset(n, seed, d=6, stacked=False):
    rng = np.random.RandomState(seed)
    shape = (lambda i: (8 + i, d, 3)) if stacked else (lambda i: (8 + i, d))
    return timit.Dataset(uids=[f"u{seed}_{i}" for i in range(n)],
                         x=[rng.randn(*shape(i)).astype(np.float32) for i in range(n)],
                         y=[rng.randint(0, 5, 3 + i % 2).astype(np.int32) for i in range(n)],
                         y39=None, start=[np.zeros(0)] * n, finish=[np.zeros(0)] * n)


def test_chunked_directory_round_trip(tmp_path):
    """The port's chunks, manifest and meta read back through both
    packages, and JAX's through the port; iter_chunks' shuffled order is
    the JAX package's."""
    pytest.importorskip("h5py")
    ds = _dataset(7, 0, stacked=True)
    paths = ls.save_chunked(ds, str(tmp_path / "p"), n_chunks=3)
    jpaths = jls.save_chunked(ds, str(tmp_path / "j"), n_chunks=3)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths] == [
        "train0.h5", "train1.h5", "train2.h5"]
    assert ls.load_manifest(str(tmp_path / "p")) == jls.load_manifest(str(tmp_path / "p")) == paths
    assert ls.load_manifest(str(tmp_path / "j")) == jpaths
    meta = {"inputFrameSize": 6, "trainsamples": 7, "numchars": 30, "numwords": 12,
            "labelset_words": 0}
    ls.save_meta(str(tmp_path / "p"), meta)
    assert ls.load_meta(str(tmp_path / "p")) == jls.load_meta(str(tmp_path / "p")) == meta
    with open(tmp_path / "p" / "meta.txt") as f:
        want_lines = f.read()
    jls.save_meta(str(tmp_path / "j"), meta)
    assert open(tmp_path / "j" / "meta.txt").read() == want_lines
    for seed in (0, 5):
        got = [c.uids for c in ls.iter_chunks(str(tmp_path / "p"), shuffle=True, seed=seed)]
        want = [c.uids for c in jls.iter_chunks(str(tmp_path / "j"), shuffle=True, seed=seed)]
        assert got == want and sorted(u for c in got for u in c) == sorted(ds.uids)
    back = timit.load_hdf5(paths[1])
    assert back.uids == ds.uids[3:6] and back.y39 is None
    for a, b in zip(back.x, ds.x[3:6]):
        np.testing.assert_array_equal(a, b)


def test_stacked_examples_pad_as_jax_does():
    """(L, freq, C) examples through BucketedBatcher: padded over L only,
    as the JAX package's numpy path pads them; CachedDeviceBatcher holds
    the same batches as (B, L, freq, C) tensors."""
    ds = _dataset(5, 2, stacked=True)
    base = batching.BucketedBatcher.from_dataset(ds, 2, 2)
    got = list(base.batches(ds, shuffle=True, seed=3))
    want = list(jbatching.BucketedBatcher.from_dataset(ds, 2, 2).batches(ds, shuffle=True, seed=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.x.shape[2:] == (6, 3)
        for k in ("x", "x_len", "y", "y_len"):
            np.testing.assert_array_equal(getattr(g, k), np.asarray(getattr(w, k)))
        assert list(g.uids) == list(w.uids)
    cached = {tuple(b.uids): b for b in batching.CachedDeviceBatcher(base, seed=3, device="cpu")
              .batches(ds, shuffle=True, seed=1)}
    assert len(cached) == len(got)
    for g in got:
        c = cached[tuple(g.uids)]
        assert c.x.dtype == torch.float32 and c.x.shape == g.x.shape
        np.testing.assert_array_equal(c.x.numpy(), g.x)
        np.testing.assert_array_equal(c.x_len.numpy(), g.x_len)


SMALL_CHOROWSKI = dict(hidden_frame_size=8, output_frame_size=8, score_depth=8, state_depth=8,
                       mlp_depth=8)
SMALL_VGG = dict(output_frame_size=8, score_depth=8, state_depth=8, mlp_depth=8)


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ROW_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        for k in ("epoch", "valid_accuracy", "valid_per"):
            assert g.get(k) == w.get(k), k


def test_chunked_fit_matches_jax(tmp_path):
    """The twin of tests/test_end_to_end.py::test_chunked_out_of_core_training:
    two epochs over two HDF5 chunks, one resident at a time in a shuffled
    order each epoch, from the same weights: the JAX Trainer's rows."""
    pytest.importorskip("h5py")
    rng = np.random.RandomState(0)

    def mk_ds(n, off):
        return timit.Dataset(
            x=[rng.randn(10 + i, 16).astype(np.float32) for i in range(n)],
            y=[rng.randint(0, 7, (3,)).astype(np.int32) for i in range(n)],
            y39=None, uids=[f"c{off}_{i}" for i in range(n)],
            start=[np.zeros(0)] * n, finish=[np.zeros(0)] * n)

    paths = ls.save_chunked(mk_ds(8, 0), str(tmp_path / "chunks"), n_chunks=2)
    exp = experiment.scriptchecker(save_dir=str(tmp_path / "port"))
    jexp = jexperiment.scriptchecker(save_dir=str(tmp_path / "jax"))
    for e in (exp, jexp):
        e.model_kwargs.update(input_frame_size=16, hidden_frame_size=8, output_frame_size=8,
                              score_depth=8, state_depth=8, mlp_depth=8, output_depth=7)
    exp.train = dataclasses.replace(exp.train, num_epochs=2, beam_k=2)
    jexp.train = dataclasses.replace(jexp.train, num_epochs=2, beam_k=2, prefetch=0)
    params = jax.tree.map(np.asarray, jexp.init_params(jax.random.PRNGKey(0)))
    valid = timit.load_hdf5(paths[0])
    bf = lambda ds: batching.BucketedBatcher.from_dataset(ds, 4, n_buckets=2)
    jbf = lambda ds: jbatching.BucketedBatcher.from_dataset(ds, 4, n_buckets=2)

    jtr = jtrainer.Trainer(jexp.build_model(), jexp.optim, jexp.train, save_dir=jexp.save_dir)
    jtr.init(params)
    seen = []
    jload = lambda i: seen.append(("jax", i)) or jtimit.load_hdf5(paths[i])
    want = list(jtr.fit(None, jtimit.load_hdf5(paths[0]), jbf(valid), chunked=(jload, 2, jbf)))
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, save_dir=exp.save_dir,
                         device="cpu")
    tr.init(interop.to_torch(params, "cpu"))
    load = lambda i: seen.append(("port", i)) or timit.load_hdf5(paths[i])
    got = list(tr.fit(None, valid, bf(valid), chunked=(load, 2, bf)))
    _assert_rows_match(got, want)
    assert all("valid_per" in r for r in got)
    order = [i for who, i in seen if who == "port"]
    assert order == [i for who, i in seen if who == "jax"] and sorted(order[:2]) == [0, 1]
    for e in (1, 2):
        assert list(np.random.RandomState(exp.train.seed + e).permutation(2)) == order[2 * e - 2:2 * e]
    assert tr.best == jtr.best


# -- run_cli "librispeech" on the JAX package's preprocessing --------------

SENTENCES = ["HELLO WORLD", "THE CAT SAT", "A DOG RAN FAST", "SHE SAW THE SEA",
             "GOOD DAY TO YOU", "RAIN IN SPAIN"]


def _write_flac_utt(dirname, uid, seed, n_samp=8000):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flac_encoder import encode_flac

    rng = np.random.RandomState(seed)
    t = np.arange(n_samp) / 16000.0
    pcm = 0.2 * np.sin(2 * np.pi * (180 + 35 * seed) * t) + 0.05 * rng.randn(n_samp)
    with open(os.path.join(dirname, uid + ".flac"), "wb") as f:
        f.write(encode_flac((pcm * 32767).astype(np.int16)))


@pytest.fixture(scope="module")
def librispeech_tree(tmp_path_factory):
    """The LibriSpeech layout, <split>/<speaker>/<chapter>/ with FLAC audio
    and a .trans.txt: 6 train and 3 valid utterances of 0.5 s (the
    fixture of tests/test_runbook.py)."""
    root = tmp_path_factory.mktemp("librispeech_root")
    for split, spk_chaps in (("train-clean", [("19", "198"), ("26", "495")]),
                             ("dev-clean", [("84", "121")])):
        for si, (spk, chap) in enumerate(spk_chaps):
            d = os.path.join(str(root), split, spk, chap)
            os.makedirs(d, exist_ok=True)
            lines = []
            for u in range(3):
                uid = f"{spk}-{chap}-{u:04d}"
                _write_flac_utt(d, uid, seed=si * 3 + u + 1)
                lines.append(f"{uid} {SENTENCES[(si * 3 + u) % len(SENTENCES)]}")
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return str(root)


def _preprocess(tree, out, *flags):
    """The JAX package's tools/preprocess_librispeech.py, in this process."""
    argv = sys.argv
    sys.argv = ["preprocess_librispeech.py", "--train", os.path.join(tree, "train-clean"),
                "--valid", os.path.join(tree, "dev-clean"), "--out", out, "--chunks", "2",
                *flags]
    try:
        runpy.run_path(os.path.join(REPO, "tools", "preprocess_librispeech.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv


def _small(recipe, widths):
    def make(n_out, data_path=None, save_dir=None):
        exp = recipe(n_out, data_path=data_path, save_dir=save_dir)
        exp.model_kwargs.update(widths)
        return exp
    return make


@pytest.mark.parametrize("recipe,variant,labelset,widths", [
    ("librispeech_chorowski", "logmel", "chars", SMALL_CHOROWSKI),
    ("librispeech_vgg", "logmel_stacked", "chars", SMALL_VGG),
    ("librispeech_chorowski_words", "logmel", "words", SMALL_CHOROWSKI),
])
def test_run_cli_librispeech_matches_jax(librispeech_tree, tmp_path, monkeypatch, recipe, variant,
                                         labelset, widths):
    """The twin of tests/test_runbook.py::test_runbook_librispeech (and, for
    the word recipe, of tests/test_flac.py::test_librispeech_words_end_to_end):
    the JAX package's preprocessing writes the chunked directory, then one
    epoch of each package's run_cli at small widths on the CPU, out of
    core over its two chunks, from the JAX run's initial weights: the
    same rows, the CER or WER and the valid NLL included."""
    pytest.importorskip("h5py")
    data = str(tmp_path / "data")
    _preprocess(librispeech_tree, data, "--variant", variant, "--labelset", labelset)
    meta = ls.load_meta(data)
    assert len(ls.load_manifest(data)) == 2 and meta["labelset_words"] == (labelset == "words")
    argv = ["--data", data, "--epochs", "1", "--batch-size", "2", "--cpu"]

    inits = []  # the JAX run's initial weights, copied before its trainer donates them
    jax_init = jexperiment.Experiment.init_params
    monkeypatch.setattr(jexperiment.Experiment, "init_params", lambda self, key: (
        lambda p: inits.append(jax.tree.map(np.array, p)) or p)(jax_init(self, key)))
    jexperiment.run_cli(_small(getattr(jexperiment, recipe), widths), "librispeech",
                        argv + ["--save", str(tmp_path / "jax")])
    want = [json.loads(line) for line in open(tmp_path / "jax" / "log.jsonl")]
    params = inits[0]
    monkeypatch.setattr(experiment.Experiment, "init_params",
                        lambda self, gen, device="cuda": interop.to_torch(params, device))
    tr = experiment.run_cli(_small(getattr(experiment, recipe), widths), "librispeech",
                            argv + ["--save", str(tmp_path / "port")])
    got = trainer.MetricLog.load(str(tmp_path / "port" / "log.jsonl"))

    n_out = meta["numwords"] if labelset == "words" else meta["numchars"]
    assert tr.model.cfg.output_depth == n_out and tr.device.type == "cpu"
    if variant == "logmel_stacked":
        assert tr.model.name == "vgg" and tr.model.cfg.input_frame_size == 40
    _assert_rows_match(got, want)
    assert np.isfinite(got[-1]["valid_per"]) and 0.0 <= got[-1]["valid_per"] < 10.0
    assert os.path.exists(tmp_path / "port" / "experiment.json")
