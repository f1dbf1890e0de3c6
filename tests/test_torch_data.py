"""The port's data modules against the JAX package's on the CPU: the
TIMIT vocabulary and folding table, the synthetic corpora (bit-equal
arrays from the same seeds), the bucketed batcher (equal Batch fields,
with and without shuffle, max_samples and truncation) and the cached
device batcher (the same batches each epoch, in the JAX package's
order); the HDF5 format both ways; the NaN tripwire's paths."""

import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.data import batching as jbatching
from seq2seq_attention_asr_tpu.data import synthetic as jsynthetic
from seq2seq_attention_asr_tpu.data import timit as jtimit
from seq2seq_attention_asr_tpu.utils import debug as jdebug
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic, timit
from seq2seq_attention_asr_tpu_torch.utils import debug


def same_dataset(got, want):
    assert got.uids == want.uids
    for field in ("x", "y", "y39", "start", "finish"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)


def test_vocab_and_kaldi_map_match_jax():
    assert timit.KALDI_MAP == jtimit.KALDI_MAP and timit.EOS == jtimit.EOS
    got, want = timit.Vocab.standard(), jtimit.Vocab.standard()
    assert (got.phones, got.index, got.fold48, got.fold39, got.index39) == \
        (want.phones, want.index, want.fold48, want.fold39, want.index39)
    assert got.size == want.size == 62
    ids = np.random.RandomState(0).randint(0, 62, (7, 9))
    np.testing.assert_array_equal(got.map_ids_61_to_39(ids), want.map_ids_61_to_39(ids))
    phones = ["aa", "zh", "ix", "q", "h#", timit.EOS]
    np.testing.assert_array_equal(got.to_ids(phones), want.to_ids(phones))
    np.testing.assert_array_equal(got.to_ids39(phones), want.to_ids39(phones))


@pytest.mark.parametrize("kw", [dict(), dict(unique_phones=True, n_phones=9, max_len=6),
                                dict(n_phones=5, feat_dim=3, frames_per_phone=(1, 2), seed=4)])
def test_make_corpus_is_bit_equal(kw):
    got = synthetic.make_corpus(11, **kw)
    want = jsynthetic.make_corpus(11, **kw)
    same_dataset(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(synthetic.prototype_table(7, 5, 3),
                                  jsynthetic.prototype_table(7, 5, 3))


def test_train_valid_and_timit_shaped_are_bit_equal():
    for g, w in zip(synthetic.train_valid(6, 3, n_phones=4, feat_dim=5, seed=2)[:2],
                    jsynthetic.train_valid(6, 3, n_phones=4, feat_dim=5, seed=2)[:2]):
        same_dataset(g, w)
    got = synthetic.timit_shaped(12, 5, seed=1)
    want = jsynthetic.timit_shaped(12, 5, seed=1)
    same_dataset(got[0], want[0])
    same_dataset(got[1], want[1])
    assert got[2].phones == want[2].phones


def _corpus(n=23, seed=0):
    return synthetic.make_corpus(n, n_phones=6, feat_dim=4, min_len=2, max_len=9, seed=seed)[0], \
        jsynthetic.make_corpus(n, n_phones=6, feat_dim=4, min_len=2, max_len=9, seed=seed)[0]


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("x", "x_len", "y", "y_len", "dec_mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (g.y39 is None) == (w.y39 is None)
        if w.y39 is not None:
            np.testing.assert_array_equal(g.y39, w.y39)
        assert g.uids == w.uids


def test_make_buckets_matches_jax():
    rng = np.random.RandomState(0)
    for n_buckets, multiple in ((8, 16), (3, 16), (1, 8), (5, 4)):
        lengths = rng.randint(5, 300, rng.randint(1, 200))
        assert batching.make_buckets(lengths, n_buckets, multiple) == \
            jbatching.make_buckets(lengths, n_buckets, multiple)
    for n in (1, 16, 17, 40, 41, 900):
        assert batching._round_up(n, [16, 40]) == jbatching._round_up(n, [16, 40])


@pytest.mark.parametrize("opts", [dict(), dict(shuffle=True, seed=3),
                                  dict(shuffle=True, seed=5, max_samples=9),
                                  dict(drop_remainder=True, shuffle=True, seed=1)])
def test_bucketed_batcher_matches_jax(opts):
    ds, jds = _corpus()
    got = batching.BucketedBatcher.from_dataset(ds, 4, n_buckets=3)
    want = jbatching.BucketedBatcher.from_dataset(jds, 4, n_buckets=3)
    assert got.l_buckets == want.l_buckets
    same_batches(list(got.batches(ds, **opts)), list(want.batches(jds, **opts)))


def test_bucketed_batcher_truncates_like_jax():
    """Utterances longer than the last boundary are cut to it."""
    ds, jds = _corpus(15, seed=1)
    ds.y39 = [y % 5 for y in ds.y]
    jds.y39 = [y % 5 for y in jds.y]
    got = list(batching.BucketedBatcher([12, 20], 4).batches(ds, shuffle=True, seed=2))
    want = list(jbatching.BucketedBatcher([12, 20], 4)._pad_np(jds, b_idx, lb, tp)
                for b_idx, lb, tp in _plan(jds, [12, 20], 4, 2))
    assert max(len(x) for x in ds.x) > 20 and max(int(b.x_len.max()) for b in got) == 20
    same_batches(got, want)


def _plan(ds, buckets, size, seed):
    """(indices, L_pad, T_pad) of each batch, as BucketedBatcher.batches groups them."""
    out = []
    for b in jbatching.BucketedBatcher(buckets, size).batches(ds, shuffle=True, seed=seed):
        idxs = [ds.uids.index(u) for u in b.uids]
        out.append((idxs, b.x.shape[1], b.y.shape[1]))
    return out


def test_cached_device_batcher_matches_jax_order():
    ds, jds = _corpus(30, seed=2)
    base = batching.BucketedBatcher.from_dataset(ds, 4, n_buckets=2)
    jbase = jbatching.BucketedBatcher.from_dataset(jds, 4, n_buckets=2)
    cb = batching.CachedDeviceBatcher(base, seed=1, device="cpu")
    jcb = jbatching.CachedDeviceBatcher(jbase, seed=1)
    first = list(cb.batches(ds, shuffle=True, seed=10))
    for opts in (dict(shuffle=True, seed=10), dict(shuffle=True, seed=11), dict(),
                 dict(max_samples=9)):
        got = list(cb.batches(ds, **opts))
        want = list(jcb.batches(jds, **opts))
        assert [b.uids for b in got] == [b.uids for b in want]
        for g, w in zip(got, want):
            assert isinstance(g.x, torch.Tensor) and g.x.device.type == "cpu"
            for field in ("x", "x_len", "y", "dec_mask"):
                np.testing.assert_array_equal(getattr(g, field).numpy(),
                                              np.asarray(getattr(w, field)), err_msg=field)
            np.testing.assert_array_equal(g.y_len, w.y_len)
    # built once: every epoch yields the same objects
    assert {id(b) for b in first} == {id(b) for b in cb.batches(ds, shuffle=True, seed=12)}


def test_hdf5_round_trip_both_ways(tmp_path):
    pytest.importorskip("h5py")
    ds, jds = _corpus(5)
    ds.y39 = [y % 4 for y in ds.y]
    jds.y39 = [y % 4 for y in jds.y]
    port_file, jax_file = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    timit.save_hdf5(ds, port_file)
    jtimit.save_hdf5(jds, jax_file)
    same_dataset(timit.load_hdf5(jax_file), jtimit.load_hdf5(jax_file))
    same_dataset(jtimit.load_hdf5(port_file), jtimit.load_hdf5(jax_file))


def test_find_nonfinite_paths_match_jax():
    tree = {"r": [{}, {"w": np.array([np.inf], np.float32)}], "a": np.ones(3, np.float32),
            "b": {"c": np.array([1.0, np.nan], np.float32)}, "i": np.arange(3)}
    want = jdebug.find_nonfinite(tree)
    assert debug.find_nonfinite(tree) == want == ["['b']['c']", "['r'][1]['w']"]
    as_tensors = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("nan")])},
                  "r": [{}, {"w": torch.tensor([float("inf")])}], "i": torch.arange(3)}
    assert debug.find_nonfinite(as_tensors) == want
    with pytest.raises(debug.NonFiniteError) as e:
        debug.check_finite(as_tensors, "params")
    assert e.value.paths == want and e.value.name == "params"
    debug.check_finite({"a": torch.ones(2)})
