"""LibriSpeech vocabularies and the chunked out-of-core training set
(seq2seq_attention_asr_tpu/data/librispeech.py), after the reference's
librispeech/preprocess.py and utils_librispeech.lua:

  - the character and word vocabularies over the transcriptions, sorted,
    0-based, with <eos> last (:83-111); `labelset` picks which one gives
    the target ids (opt.labelset, librispeech/train.lua:28);
  - the chunked training set: N HDF5 chunk files, a `train.db` manifest
    of their paths and `meta.txt` (inputFrameSize, sample counts,
    vocabulary sizes) (:246-307), which the trainer reads one chunk at a
    time (librispeech/train.lua:82-103, ``Trainer.fit(chunked=...)``).

The corpus walk and the feature extraction (`walk_corpus`,
`build_datasets`) need the FLAC reader and are not ported (ROADMAP
Queue A item 8); the JAX package's tools/preprocess_librispeech.py
writes the directory this module reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

from .timit import Dataset, load_hdf5, save_hdf5

EOS = "<eos>"


@dataclasses.dataclass
class CharVocab:
    charmap: Dict[str, int]
    wordmap: Dict[str, int]

    @property
    def num_chars(self) -> int:
        return len(self.charmap)

    @property
    def num_words(self) -> int:
        return len(self.wordmap)

    def chars_to_ids(self, text: str) -> np.ndarray:
        return np.array([self.charmap[c] for c in text] + [self.charmap[EOS]], np.int32)

    def ids_to_chars(self, ids) -> str:
        inv = {v: k for k, v in self.charmap.items()}
        return "".join(inv[int(i)] for i in ids if inv.get(int(i)) != EOS)

    def words_to_ids(self, text: str) -> np.ndarray:
        """Word targets (labelset 'words', utils_librispeech.lua:49-66)."""
        return np.array([self.wordmap[w] for w in text.split()] + [self.wordmap[EOS]], np.int32)

    def ids_to_words(self, ids) -> str:
        inv = {v: k for k, v in self.wordmap.items()}
        return " ".join(inv[int(i)] for i in ids if inv.get(int(i)) != EOS)

    def to_ids(self, text: str, labelset: str = "chars") -> np.ndarray:
        if labelset == "chars":
            return self.chars_to_ids(text)
        if labelset == "words":
            return self.words_to_ids(text)
        raise ValueError(f"labelset must be 'chars' or 'words', got {labelset!r}")

    def size(self, labelset: str = "chars") -> int:
        """The model's output_depth for the labelset (numchars or numwords in
        meta.txt, preprocess.py:299-304)."""
        return self.num_chars if labelset == "chars" else self.num_words


def build_vocab(transcripts: List[str]) -> CharVocab:
    """Sorted character and word maps, each with <eos> last (preprocess.py:
    83-104)."""
    chars, words = set(), set()
    for t in transcripts:
        chars.update(t)
        words.update(t.split())
    charmap = {c: i for i, c in enumerate(sorted(chars))}
    wordmap = {w: i for i, w in enumerate(sorted(words))}
    charmap[EOS] = len(charmap)
    wordmap[EOS] = len(wordmap)
    return CharVocab(charmap, wordmap)


def save_chunked(ds: Dataset, outdir: str, n_chunks: int = 1, prefix: str = "train") -> List[str]:
    """`ds` in n_chunks consecutive HDF5 files `{prefix}{c}.h5` of ceil(n /
    n_chunks) utterances (fewer files where the last would be empty),
    and the manifest `{prefix}.db` of their paths. Returns the paths."""
    os.makedirs(outdir, exist_ok=True)
    n = len(ds)
    per = -(-n // n_chunks)
    paths = []
    for c in range(n_chunks):
        lo, hi = c * per, min((c + 1) * per, n)
        if lo >= hi:
            break
        sub = Dataset(uids=ds.uids[lo:hi], x=ds.x[lo:hi], y=ds.y[lo:hi], y39=None,
                      start=ds.start[lo:hi], finish=ds.finish[lo:hi])
        p = os.path.join(outdir, f"{prefix}{c}.h5")
        save_hdf5(sub, p)
        paths.append(p)
    with open(os.path.join(outdir, f"{prefix}.db"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths


def load_manifest(outdir: str, prefix: str = "train") -> List[str]:
    """The chunk paths listed in `{prefix}.db`, in order."""
    with open(os.path.join(outdir, f"{prefix}.db")) as f:
        return [line.strip() for line in f if line.strip()]


def save_meta(outdir: str, meta: Dict[str, int]) -> None:
    """meta.txt: one `key value` line each, by increasing value."""
    with open(os.path.join(outdir, "meta.txt"), "w") as f:
        for k, v in sorted(meta.items(), key=lambda kv: kv[1]):
            f.write(f"{k} {v}\n")


def load_meta(outdir: str) -> Dict[str, int]:
    meta = {}
    with open(os.path.join(outdir, "meta.txt")) as f:
        for line in f:
            k, v = line.split()
            meta[k] = int(v)
    return meta


def iter_chunks(outdir: str, prefix: str = "train", shuffle: bool = False, seed: int = 0):
    """One in-memory Dataset per chunk file, in the manifest's order or
    shuffled by RandomState(seed) (train.lua:84-88)."""
    paths = load_manifest(outdir, prefix)
    order = np.arange(len(paths))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for i in order:
        yield load_hdf5(paths[i])
