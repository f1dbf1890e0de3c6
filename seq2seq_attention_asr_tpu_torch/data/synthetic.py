"""Synthetic learnable speech-shaped corpora (seq2seq_attention_asr_tpu/data/synthetic.py).

A sequence of discrete "phones", each emitting a variable number of
feature frames drawn from a per-phone prototype plus Gaussian noise: the
structure an attention model must learn on TIMIT (monotonic alignment,
per-phone identity, EOS termination). The same seeds give the JAX
package's arrays bit for bit (numpy's RandomState, the same draws in the
same order). ``make_corpus`` returns a ``data.timit.Dataset``, so the
batcher, the trainer, the beam and the PER scorer take it unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .timit import Dataset, Vocab


def prototype_table(n_phones: int, feat_dim: int, seed: int = 0) -> np.ndarray:
    """The per-phone prototype vectors `make_corpus(seed=seed)` uses:
    well-separated scaled random rows, deterministic in (n_phones,
    feat_dim, seed)."""
    proto_rng = np.random.RandomState(10_000 + seed)
    prototypes = proto_rng.randn(n_phones, feat_dim).astype(np.float32)
    prototypes /= np.linalg.norm(prototypes, axis=1, keepdims=True)
    return prototypes * 2.0


def make_corpus(n_utts: int, n_phones: int = 7, feat_dim: int = 16, min_len: int = 3,
                max_len: int = 8, frames_per_phone: Tuple[int, int] = (3, 7), noise: float = 0.3,
                seed: int = 0, prototypes: Optional[np.ndarray] = None,
                unique_phones: bool = False) -> Tuple[Dataset, np.ndarray, int]:
    """`n_utts` utterances. Ids 0..n_phones-1 are emitting phones, id
    n_phones is <EOS>, appended to every target (preprocess_timit.py:
    99-102). A phone token emits uniform(frames_per_phone) frames of its
    prototype + N(0, noise^2). Returns (dataset, prototypes, vocab_size);
    pass `prototypes` back in to draw another split of the same phone ->
    feature mapping. unique_phones draws each utterance's phones without
    replacement (needs n_phones >= max_len)."""
    rng = np.random.RandomState(seed)
    if prototypes is None:
        prototypes = prototype_table(n_phones, feat_dim, seed)
    else:
        n_phones = prototypes.shape[0]
        feat_dim = prototypes.shape[1]
    eos = n_phones
    vocab_size = n_phones + 1

    xs, ys, starts, finishes, uids = [], [], [], [], []
    for i in range(n_utts):
        t = rng.randint(min_len, max_len + 1)
        if unique_phones:
            phones = rng.permutation(n_phones)[:t]
        else:
            phones = rng.randint(0, n_phones, size=t)
        frames, st, fi = [], [], []
        pos = 0
        for p in phones:
            d = rng.randint(frames_per_phone[0], frames_per_phone[1] + 1)
            f = prototypes[p][None, :] + noise * rng.randn(d, feat_dim)
            frames.append(f.astype(np.float32))
            st.append(pos)
            fi.append(pos + d)
            pos += d
        xs.append(np.concatenate(frames, axis=0))
        ys.append(np.concatenate([phones, [eos]]).astype(np.int32))
        # <EOS> repeats the last phone's span (preprocess_timit.py:99-102)
        starts.append(np.asarray(st + [st[-1]], np.int64))
        finishes.append(np.asarray(fi + [fi[-1]], np.int64))
        uids.append(f"syn{seed}_{i}")

    ds = Dataset(uids=uids, x=xs, y=ys, y39=None, start=starts, finish=finishes)
    return ds, prototypes, vocab_size


def train_valid(n_train: int, n_valid: int, seed: int = 0,
                **kwargs) -> Tuple[Dataset, Dataset, int]:
    """Disjoint train/valid splits over one phone->feature mapping."""
    train, protos, v = make_corpus(n_train, seed=seed, **kwargs)
    kwargs.pop("n_phones", None)
    kwargs.pop("feat_dim", None)
    valid, _, _ = make_corpus(n_valid, seed=seed + 1, prototypes=protos, **kwargs)
    return train, valid, v


def timit_shaped(n_train: int, n_valid: int, *, noise: float = 0.35, seed: int = 1,
                 min_len: int = 8, max_len: int = 50,
                 frames_per_phone: Tuple[int, int] = (2, 5)):
    """TIMIT-shaped corpus: the standard 61-phone(+<EOS>) vocabulary,
    8-50 phones an utterance at 2-5 frames a phone (~16-250 frames),
    123-dim features, and y39 targets, so that evaluation scores the
    TIMIT PER (61->39 fold + beam search, timit/timit.lua:397-415).
    Returns (train, valid, vocab)."""
    vocab = Vocab.standard()
    n_ph = vocab.size - 1  # 61 emitting phones; <EOS> = 61 is last
    shape = dict(min_len=min_len, max_len=max_len, frames_per_phone=frames_per_phone, noise=noise)
    train, protos, v = make_corpus(n_train, n_phones=n_ph, feat_dim=123, seed=seed, **shape)
    valid, _, _ = make_corpus(n_valid, seed=seed + 1, prototypes=protos, **shape)
    assert v == vocab.size
    fold = lambda ds: dataclasses.replace(ds, y39=[vocab.map_ids_61_to_39(y) for y in ds.y])
    return fold(train), fold(valid), vocab
