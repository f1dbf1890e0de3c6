"""LibriSpeech vocabularies and the chunked out-of-core training set
(seq2seq_attention_asr_tpu/data/librispeech.py), after the reference's
librispeech/preprocess.py and utils_librispeech.lua:

  - the character and word vocabularies over the transcriptions, sorted,
    0-based, with <eos> last (:83-111); `labelset` picks which one gives
    the target ids (opt.labelset, librispeech/train.lua:28);
  - the chunked training set: N HDF5 chunk files, a `train.db` manifest
    of their paths and `meta.txt` (inputFrameSize, sample counts,
    vocabulary sizes) (:246-307), which the trainer reads one chunk at a
    time (librispeech/train.lua:82-103, ``Trainer.fit(chunked=...)``);
  - the corpus walk (`walk_corpus`: `<id> <TEXT>` lines of *.txt paired
    with sibling audio, FLAC through data/flac.py) and `build_datasets`
    (features, the train split's normalization, character or word
    targets); tools/preprocess_librispeech_torch.py writes the chunked
    directory from them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import audio, features
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


def walk_corpus(rootdir: str) -> List[Tuple[str, str, str]]:
    """Returns [(utt_id, audio_path, transcription)]. Pairs
    `<id> <TEXT>` lines in *.trans.txt / *.txt with sibling audio files
    (.flac or converted .wav/.npy)."""
    trans: Dict[str, str] = {}
    audio_paths: Dict[str, str] = {}
    for dirname, _, fnames in sorted(os.walk(rootdir)):
        for f in sorted(fnames):
            p = os.path.join(dirname, f)
            if f.endswith(".txt"):
                with open(p) as fh:
                    for line in fh:
                        parts = line.strip().split(None, 1)
                        if len(parts) == 2:
                            trans[parts[0]] = parts[1]
            elif f.endswith((".flac", ".wav", ".WAV", ".npy")):
                audio_paths[os.path.splitext(f)[0]] = p
    return [
        (uid, audio_paths[uid], txt)
        for uid, txt in sorted(trans.items())
        if uid in audio_paths
    ]


def build_datasets(
    roots: Dict[str, str],
    feature_fn: Callable[[np.ndarray, int], np.ndarray] = features.logmel_np,
    pad: int = 1,
    max_utts: Optional[int] = None,
    vocab: Optional[CharVocab] = None,
    labelset: str = "chars",
) -> Tuple[Dict[str, Dataset], CharVocab, np.ndarray, np.ndarray]:
    """roots: {"train": dir, "valid": dir, "test": dir}. Returns
    ({split: Dataset}, vocab, mean, std). Normalization stats come from
    the train split; pad=1 matches preprocess.py:286. labelset selects
    character or word targets (opt.labelset, librispeech/train.lua:28 +
    utils_librispeech.lua:49-66); the model's output_depth must then be
    vocab.size(labelset)."""
    walked = {k: walk_corpus(v) for k, v in roots.items()}
    if max_utts:
        walked = {k: v[:max_utts] for k, v in walked.items()}
    if vocab is None:
        vocab = build_vocab([t for split in walked.values() for _, _, t in split])

    def extract(split):
        out = []
        for _, path, _ in split:
            pcm, sr = audio.read_audio(path)
            out.append(feature_fn(pcm, sr))
        return out

    names = list(walked.keys())
    featsets = [extract(walked[n]) for n in names]
    train_idx = names.index("train") if "train" in names else 0
    ordered = [featsets[train_idx]] + [
        f for i, f in enumerate(featsets) if i != train_idx
    ]
    normed_and_stats = features.normalize_corpus(*ordered, pad=pad)
    mean, std = normed_and_stats[-2], normed_and_stats[-1]
    normed = list(normed_and_stats[:-2])
    feats = {}
    feats[names[train_idx]] = normed[0]
    rest = iter(normed[1:])
    for i, n in enumerate(names):
        if i != train_idx:
            feats[n] = next(rest)

    def mk(split, fs):
        return Dataset(
            uids=[uid for uid, _, _ in split],
            x=[f.astype(np.float32) for f in fs],
            y=[vocab.to_ids(t, labelset) for _, _, t in split],
            y39=None,
            start=[np.zeros(0, np.int64)] * len(split),
            finish=[np.zeros(0, np.int64)] * len(split),
        )

    return (
        {n: mk(walked[n], feats[n]) for n in names},
        vocab,
        mean,
        std,
    )


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
