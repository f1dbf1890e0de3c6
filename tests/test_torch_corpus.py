"""The port's corpus readers against the JAX package's, on the CPU, on
corpora built in this process: the SPHERE and RIFF readers, TIMIT's walk,
speaker split and build_datasets (with and without PCA), LibriSpeech's
walk and build_datasets (character and word targets) from FLAC, and the
port's preprocessing CLIs against the JAX tools on one tree. uids, y,
y39, start, finish and the vocabularies are held exactly; features, mean
and std within 1e-6. Also tools/extract_alpha_torch.py on a checkpoint
of the port's trainer."""

import json
import os
import runpy
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flac_encoder import encode_flac  # noqa: E402
from seq2seq_attention_asr_tpu.data import audio as jaudio  # noqa: E402
from seq2seq_attention_asr_tpu.data import features as jfeatures  # noqa: E402
from seq2seq_attention_asr_tpu.data import librispeech as jls  # noqa: E402
from seq2seq_attention_asr_tpu.data import timit as jtimit  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import audio, features  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import librispeech as ls  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import timit  # noqa: E402
from seq2seq_attention_asr_tpu_torch.native import flacdec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
SR = 16000


def _pcm16(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    y = 0.25 * np.sin(2 * np.pi * (150 + 40 * (seed % 7)) * t) + 0.05 * rng.randn(n)
    return (y * 32767).astype(np.int16)


def _sphere(pcm, byte_format="01", coding="pcm", nbytes=2):
    data = pcm.astype(">i2" if byte_format == "10" else "<i2").tobytes() if nbytes == 2 else \
        pcm.tobytes()
    hdr = (b"NIST_1A\n   1024\n"
           + f"database_id -s5 TIMIT\nsample_rate -i {SR}\nsample_count -i {len(pcm)}\n"
             f"sample_n_bytes -i {nbytes}\nsample_byte_format -s2 {byte_format}\n"
             f"sample_coding -s{len(coding)} {coding}\nend_head\n".encode())
    return hdr + b" " * (1024 - len(hdr)) + data


def _riff(pcm, channels=1, bits=16, fmt=1, extra_chunk=True):
    data = pcm.tobytes()
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, SR, SR * channels * bits // 8,
                            channels * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 5) + b"abcde\x00"  # odd size, padded
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("kind", ["sphere_01", "sphere_10", "sphere_u8", "riff16", "riff16_stereo",
                                  "riff8", "riff32", "npy"])
def test_audio_readers_match_jax_bit_for_bit(tmp_path, kind):
    pcm = _pcm16(3001, 1)
    path = str(tmp_path / ("a.npy" if kind == "npy" else "a.wav"))
    if kind == "npy":
        np.save(path, pcm)
    else:
        blob = {
            "sphere_01": lambda: _sphere(pcm),
            "sphere_10": lambda: _sphere(pcm, byte_format="10"),
            "sphere_u8": lambda: _sphere((pcm // 256 + 128).astype(np.uint8), nbytes=1),
            "riff16": lambda: _riff(pcm),
            "riff16_stereo": lambda: _riff(np.stack([pcm, pcm // 3], 1), channels=2),
            "riff8": lambda: _riff((pcm // 256 + 128).astype(np.uint8), bits=8),
            "riff32": lambda: _riff(pcm.astype(np.int32) << 16, bits=32, extra_chunk=False),
        }[kind]()
        with open(path, "wb") as f:
            f.write(blob)
    got, sr = audio.read_audio(path)
    want, jsr = jaudio.read_audio(path)
    assert sr == jsr == SR and got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    if kind in ("sphere_01", "sphere_10", "riff16", "npy"):
        np.testing.assert_array_equal(got, pcm / 32768.0)


@pytest.mark.parametrize("kind", ["ulaw", "riff_float", "riff_no_data", "unknown"])
def test_audio_readers_refuse_what_jax_refuses(tmp_path, kind):
    """A SPHERE coding that is no PCM, a non-PCM or data-less RIFF, and an
    unknown container raise UnsupportedAudioFormat in both packages."""
    pcm = _pcm16(100, 2)
    blob = {"ulaw": lambda: _sphere(pcm, coding="ulaw"),
            "riff_float": lambda: _riff(pcm, fmt=3),
            "riff_no_data": lambda: _riff(pcm)[:-(len(pcm) * 2 + 8)],
            "unknown": lambda: b"OggS" + bytes(60)}[kind]()
    path = str(tmp_path / "b.wav")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(jaudio.UnsupportedAudioFormat):
        jaudio.read_audio(path)
    with pytest.raises(audio.UnsupportedAudioFormat):
        audio.read_audio(path)


# --- TIMIT ---------------------------------------------------------------

PHONES = [p for p, _, _ in timit.KALDI_MAP]


def _write_timit_utt(d, stem, seed, upper=True):
    rng = np.random.RandomState(seed)
    n = 6000 + 400 * (seed % 9)
    pcm = _pcm16(n, seed)
    ext = lambda e: e.upper() if upper else e.lower()
    with open(os.path.join(d, stem + ext(".wav")), "wb") as f:
        f.write(_sphere(pcm, byte_format="10" if seed % 3 == 0 else "01"))
    cuts = np.sort(rng.choice(np.arange(100, n - 100), 5, replace=False))
    bounds = [0, *cuts.tolist(), n]
    phones = [PHONES[i] for i in rng.randint(0, len(PHONES), len(bounds) - 1)]
    with open(os.path.join(d, stem + ext(".phn")), "w") as f:
        f.write("".join(f"{a} {b} {p}\n" for a, b, p in zip(bounds, bounds[1:], phones)))
    with open(os.path.join(d, stem + ext(".wrd")), "w") as f:
        f.write(f"{bounds[1]} {bounds[3]} word{seed}\n{bounds[3]} {bounds[5]} other\n")


@pytest.fixture(scope="module")
def timit_tree(tmp_path_factory):
    """TIMIT's layout: TRAIN/<dialect>/<speaker>/ with SPHERE .WAV, .PHN and
    .WRD files; two speakers of the reference's development split, three
    others, the SA sentences (skipped), a .PHN without audio (skipped);
    a lower-case test/ tree."""
    root = str(tmp_path_factory.mktemp("timit"))
    seed = 0
    for split, spks in (("TRAIN", ["DR1/MTLB0", "DR1/FAKE1", "DR2/FGRW0", "DR2/MABC0",
                                   "DR3/FXYZ0"]), ("test", ["dr1/mdab0", "dr2/fjem0"])):
        for spk in spks:
            d = os.path.join(root, split, spk)
            os.makedirs(d)
            upper = split == "TRAIN"
            for stem in ("SX12", "SI640", "SA1"):
                seed += 1
                _write_timit_utt(d, stem if upper else stem.lower(), seed, upper)
    with open(os.path.join(root, "TRAIN", "DR1", "FAKE1", "SX99.PHN"), "w") as f:
        f.write("0 100 h#\n")
    return root


def _assert_datasets_equal(got, want):
    assert got.uids == want.uids
    for key in ("y", "y39", "start", "finish"):
        g, w = getattr(got, key), getattr(want, key)
        if w is None:
            assert g is None
            continue
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert len(got.x) == len(want.x)
    for a, b in zip(got.x, want.x):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_timit_walk_and_split_match_jax(timit_tree):
    got, want = timit.walk_corpus(timit_tree, "TRAIN"), jtimit.walk_corpus(timit_tree, "TRAIN")
    assert [u.uid for u in got] == [u.uid for u in want]
    assert len(got) == 10 and not any("SA1" in u.uid or "SX99" in u.uid for u in got)
    for g, w in zip(got, want):
        assert (g.wav_path, g.phones, g.words) == (w.wav_path, w.phones, w.words)
        np.testing.assert_array_equal(g.starts, w.starts)
        np.testing.assert_array_equal(g.finishes, w.finishes)
    (tr, va), (jtr, jva) = timit.split_train_valid(got), jtimit.split_train_valid(want)
    assert [u.uid for u in tr] == [u.uid for u in jtr] and len(tr) == 6
    assert [u.uid for u in va] == [u.uid for u in jva] == [
        "MTLB0_SI640", "MTLB0_SX12", "FGRW0_SI640", "FGRW0_SX12"]
    assert timit.VALID_SPEAKERS == jtimit.VALID_SPEAKERS
    assert [u.uid for u in timit.walk_corpus(timit_tree, "TEST")] == \
        [u.uid for u in jtimit.walk_corpus(timit_tree, "TEST")]
    with pytest.raises(FileNotFoundError):
        timit.walk_corpus(timit_tree, "DEV")


@pytest.mark.parametrize("pca,max_utts", [(None, None), (7, 3)])
def test_timit_build_datasets_matches_jax(timit_tree, pca, max_utts):
    got = timit.build_datasets(timit_tree, pca_components=pca, max_utts=max_utts)
    want = jtimit.build_datasets(timit_tree, pca_components=pca, max_utts=max_utts)
    for g, w in zip(got[:3], want[:3]):
        _assert_datasets_equal(g, w)
    assert got[3].phones == want[3].phones and got[3].index39 == want[3].index39
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert got[0].x[0].shape[-1] == (pca or 123)
    if not pca:  # the pad: 10 zero frames at both ends
        assert not got[0].x[0][:10].any() and not got[0].x[0][-10:].any()


def test_timit_build_datasets_takes_other_features(timit_tree):
    """feature_fn and pad pass through: the stacked log-mel, pad 2."""
    got = timit.build_datasets(timit_tree, feature_fn=features.logmel_stacked_np, pad=2,
                               max_utts=2)
    want = jtimit.build_datasets(timit_tree, feature_fn=jfeatures.logmel_stacked_np, pad=2,
                                 max_utts=2)
    for g, w in zip(got[:3], want[:3]):
        _assert_datasets_equal(g, w)
    assert got[0].x[0].shape[0] == 3


def test_feature_functions_match_jax():
    y = _pcm16(9000, 4) / 32768.0
    for name in ("logmel_np", "logmel_stacked_np", "cqt_np", "cqt_stacked_np"):
        np.testing.assert_array_equal(getattr(features, name)(y, SR),
                                      getattr(jfeatures, name)(y, SR), err_msg=name)
    np.testing.assert_array_equal(features.cqt_stacked_np(y, SR, method="exact", nfreqs=24),
                                  jfeatures.cqt_stacked_np(y, SR, method="exact", nfreqs=24))
    S = np.abs(features.stft_np(y)) ** 2
    np.testing.assert_array_equal(features.rms_energy_np(S), jfeatures.rms_energy_np(S))
    fb, freqs = features.pseudo_cqt_filterbank(SR)
    jfb, jfreqs = jfeatures.pseudo_cqt_filterbank(SR)
    np.testing.assert_array_equal(fb, jfb)
    np.testing.assert_array_equal(freqs, jfreqs)
    rng = np.random.RandomState(0)
    feats = [rng.randn(40, 6) @ np.diag([5.0, 2, 1, 0.5, 0.2, 0.1]) for _ in range(3)]
    comps, mu = features.pca_fit(feats, 3)
    jcomps, jmu = jfeatures.pca_fit(feats, 3)
    np.testing.assert_array_equal(comps, jcomps)
    np.testing.assert_array_equal(mu, jmu)
    for g, w in zip(features.pca_apply(feats, comps, mu), jfeatures.pca_apply(feats, comps, mu)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        features.cqt_np(y, SR, method="other")


# --- LibriSpeech ---------------------------------------------------------

WORDS = ["THE", "CAT", "SAT", "ON", "A", "MAT", "DOG", "RAN", "FAR", "AWAY", "IT'S", "SUN"]


@pytest.fixture(scope="module")
def librispeech_tree(tmp_path_factory):
    """LibriSpeech's layout, <split>/<speaker>/<chapter>/ with FLAC audio
    and <speaker>-<chapter>.trans.txt: 8 train utterances over two
    speakers (one chapter with a .wav and one .flac without a
    transcript), 3 valid and 2 test."""
    root = str(tmp_path_factory.mktemp("librispeech"))
    rng = np.random.RandomState(3)
    seed = 0
    for split, chapters in (("train", [("19", "198", 4), ("26", "495", 4)]),
                            ("valid", [("84", "121", 3)]), ("test", [("61", "70", 2)])):
        for spk, chap, n in chapters:
            d = os.path.join(root, split, spk, chap)
            os.makedirs(d)
            lines = []
            for u in range(n):
                seed += 1
                uid = f"{spk}-{chap}-{u:04d}"
                pcm = _pcm16(4000 + 700 * (seed % 5), seed)
                with open(os.path.join(d, uid + ".flac"), "wb") as f:
                    f.write(encode_flac(pcm.astype(np.int32), blocksize=1024,
                                        mode="lpc2" if seed % 2 else "fixed2",
                                        npart_order=seed % 3))
                lines.append(f"{uid} " + " ".join(rng.choice(WORDS, rng.randint(2, 6))))
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    d = os.path.join(root, "train", "19", "198")
    with open(os.path.join(d, "19-198-0099.flac"), "wb") as f:  # no transcript: skipped
        f.write(encode_flac(_pcm16(3000, 99).astype(np.int32)))
    return root


def _ls_roots(tree, test=True):
    roots = {k: os.path.join(tree, k) for k in ("train", "valid")}
    if test:
        roots["test"] = os.path.join(tree, "test")
    return roots


def test_librispeech_walk_matches_jax(librispeech_tree):
    for split in ("train", "valid", "test"):
        d = os.path.join(librispeech_tree, split)
        assert ls.walk_corpus(d) == jls.walk_corpus(d)
    assert len(ls.walk_corpus(os.path.join(librispeech_tree, "train"))) == 8


@pytest.mark.parametrize("labelset,feature", [("chars", "logmel_np"), ("words", "logmel_np"),
                                              ("words", "logmel_stacked_np")])
def test_librispeech_build_datasets_matches_jax(librispeech_tree, labelset, feature):
    """Through the native FLAC decoder (counted), the same datasets, vocab,
    mean and std as the JAX package's; word ids from the sorted word set
    with <eos> last."""
    before = flacdec.decodes
    got, vocab, mean, std = ls.build_datasets(_ls_roots(librispeech_tree),
                                              feature_fn=getattr(features, feature),
                                              labelset=labelset)
    assert flacdec.decodes - before == 13
    want, jvocab, jmean, jstd = jls.build_datasets(_ls_roots(librispeech_tree),
                                                   feature_fn=getattr(jfeatures, feature),
                                                   labelset=labelset)
    assert list(got) == list(want) == ["train", "valid", "test"]
    for split in got:
        _assert_datasets_equal(got[split], want[split])
    assert (vocab.charmap, vocab.wordmap) == (jvocab.charmap, jvocab.wordmap)
    assert list(vocab.wordmap)[-1] == ls.EOS and vocab.wordmap[ls.EOS] == vocab.num_words - 1
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=TOL)
    if labelset == "words":
        text = jls.walk_corpus(os.path.join(librispeech_tree, "train"))[0][2]
        assert vocab.ids_to_words(got["train"].y[0][:-1]) == text


def test_librispeech_build_with_a_given_vocab_and_max_utts(librispeech_tree):
    vocab = ls.build_vocab(["THE CAT SAT ON A MAT DOG RAN FAR AWAY IT'S SUN"])
    jvocab = jls.build_vocab(["THE CAT SAT ON A MAT DOG RAN FAR AWAY IT'S SUN"])
    got = ls.build_datasets(_ls_roots(librispeech_tree, test=False), vocab=vocab, max_utts=3,
                            labelset="words")
    want = jls.build_datasets(_ls_roots(librispeech_tree, test=False), vocab=jvocab, max_utts=3,
                              labelset="words")
    for split in ("train", "valid"):
        _assert_datasets_equal(got[0][split], want[0][split])
    assert len(got[0]["train"]) == 3


# --- the CLIs ------------------------------------------------------------


def _run_jax_tool(name, argv):
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")
    finally:
        sys.argv = old


def _load_tool(name):
    return runpy.run_path(os.path.join(REPO, "tools", name))["main"]


def _assert_h5_equal(a, b):
    import h5py

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        for uid in fa:
            assert sorted(fa[uid].keys()) == sorted(fb[uid].keys())
            for key in fa[uid]:
                ga, gb = np.asarray(fa[uid][key]), np.asarray(fb[uid][key])
                assert ga.dtype == gb.dtype and ga.shape == gb.shape, (uid, key)
                if key == "x":
                    np.testing.assert_allclose(ga, gb, rtol=0, atol=TOL)
                else:
                    np.testing.assert_array_equal(ga, gb)


def _assert_npz_equal(a, b):
    with np.load(a) as na, np.load(b) as nb:
        assert sorted(na.files) == sorted(nb.files)
        for k in na.files:
            np.testing.assert_allclose(na[k], nb[k], rtol=0, atol=TOL)


@pytest.mark.parametrize("variant,pca", [("logmel", None), ("logmel_stacked", None),
                                         ("logmel", 5)])
def test_preprocess_timit_cli_matches_jax(timit_tree, tmp_path, variant, pca):
    flags = ["--root", timit_tree, "--variant", variant, "--max-utts", "4"]
    flags += ["--pca", str(pca)] if pca else []
    _run_jax_tool("preprocess_timit.py", flags + ["--out", str(tmp_path / "jax")])
    assert _load_tool("preprocess_timit_torch.py")(flags + ["--out", str(tmp_path / "port")]) == 0
    got, want = tmp_path / "port" / variant, tmp_path / "jax" / variant
    for split in ("train", "valid", "test"):
        _assert_h5_equal(got / f"{split}.h5", want / f"{split}.h5")
    _assert_npz_equal(got / "mean_std.npz", want / "mean_std.npz")
    assert (got / "phonemes.txt").read_text() == (want / "phonemes.txt").read_text()
    assert (got / "phonemes.txt").read_text().count("\n") == 63


@pytest.mark.parametrize("labelset,variant", [("chars", "logmel"), ("words", "logmel_stacked")])
def test_preprocess_librispeech_cli_matches_jax(librispeech_tree, tmp_path, labelset, variant):
    flags = ["--train", os.path.join(librispeech_tree, "train"), "--valid",
             os.path.join(librispeech_tree, "valid"), "--test",
             os.path.join(librispeech_tree, "test"), "--chunks", "3", "--labelset", labelset,
             "--variant", variant]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax_tool("preprocess_librispeech.py", flags + ["--out", jax_out])
    assert _load_tool("preprocess_librispeech_torch.py")(flags + ["--out", port_out]) == 0
    names = sorted(os.listdir(jax_out))
    assert sorted(os.listdir(port_out)) == names
    assert {"train0.h5", "train1.h5", "train2.h5", "train.db", "valid.h5", "test.h5",
            "meta.txt", "chars.txt", "mean_std.npz"} == set(names)
    for name in names:
        a, b = os.path.join(port_out, name), os.path.join(jax_out, name)
        if name.endswith(".h5"):
            _assert_h5_equal(a, b)
        elif name.endswith(".npz"):
            _assert_npz_equal(a, b)
        elif name == "train.db":  # the chunk paths, each under its own out dir
            assert open(a).read().replace(port_out, "OUT") == open(b).read().replace(jax_out,
                                                                                     "OUT")
        else:
            assert open(a).read() == open(b).read(), name
    meta = ls.load_meta(port_out)
    assert meta["labelset_words"] == int(labelset == "words")
    assert meta["numwords"] == len({w for *_, t in jls.walk_corpus(librispeech_tree)
                                    for w in t.split()}) + 1
    assert meta["inputFrameSize"] == (40 if variant == "logmel_stacked" else 123)


def test_extract_alpha_cli(tmp_path, monkeypatch):
    """tools/extract_alpha_torch.py on a checkpoint of the port's trainer:
    each utterance's alpha (T x L) is the model's teacher-forced alpha,
    rows summing to 1; with no card and no --cpu it raises."""
    from seq2seq_attention_asr_tpu_torch.data import synthetic
    from seq2seq_attention_asr_tpu_torch.train import experiment, trainer

    run = tmp_path / "run"
    exp = experiment.timit_chorowski_normnll_colnorm(save_dir=str(run))
    exp.model_kwargs.update(hidden_frame_size=8, output_frame_size=8, score_depth=8,
                            state_depth=8, mlp_depth=4)
    exp.archive()
    json.load(open(run / "experiment.json"))
    train, valid, vocab = synthetic.timit_shaped(4, 3, max_len=12)
    tr = trainer.Trainer(exp.build_model(), exp.optim, exp.train, vocab=vocab,
                         save_dir=str(run), device="cpu")
    tr.init(exp.init_params(torch.Generator().manual_seed(0), device="cpu"))
    tr.save_checkpoint()
    data = tmp_path / "data"
    data.mkdir()
    timit.save_hdf5(valid, str(data / "valid.h5"))
    main = _load_tool("extract_alpha_torch.py")
    out = str(tmp_path / "alpha.h5")
    argv = ["--ckpt", str(run / "ckpt_latest"), "--data", str(data), "--out", out, "--n", "2"]
    assert main(argv + ["--cpu"]) == 0
    import h5py

    model, params = exp.build_model(), tr.state[0]
    ds = timit.load_hdf5(str(data / "valid.h5"))
    with h5py.File(out, "r") as f:
        assert sorted(f.keys()) == sorted(ds.uids[:2])
        for i in range(2):
            g = f[ds.uids[i]]
            onehot = torch.nn.functional.one_hot(torch.as_tensor(ds.y[i][None]).long(),
                                                 model.output_depth).float()
            with torch.no_grad():
                want = model.forward(params, torch.as_tensor(ds.x[i][None]),
                                     torch.tensor([len(ds.x[i])]), onehot,
                                     torch.ones(1, len(ds.y[i])), train=False)["alpha"][0]
            alpha = np.asarray(g["alpha"])
            assert alpha.shape == (len(ds.y[i]), len(ds.x[i]))
            np.testing.assert_array_equal(alpha, want.numpy())
            np.testing.assert_allclose(alpha.sum(-1), 1.0, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(g["y"]), ds.y[i])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
