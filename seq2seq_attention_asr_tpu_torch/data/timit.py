"""TIMIT vocabulary, in-memory datasets and the HDF5 format
(seq2seq_attention_asr_tpu/data/timit.py).

The phoneme vocabulary (61 observed phones + <EOS> = 62, sorted, 0-based)
with the standard Kaldi 60->48->39 folding table (preprocess_timit.py:
163-180), the in-memory split, and the per-utterance HDF5 groups {x, y,
y39, start, finish} (preprocess_timit.py:341-363), and the offline
pipeline: the corpus walk (`walk_corpus`, SA sentences skipped), the
reference's 50-speaker development split (`split_train_valid`) and
`build_datasets` (audio -> features -> train-set normalization, PCA
optional). ``h5py`` is imported inside the two HDF5 functions only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import audio, features

# Kaldi 60->48->39 phone folding (tab table in egs/timit; the reference
# reads it from phones.60-48-39.map). 'q' is retained as its own class
# like the reference's map file (some recipes delete it).
KALDI_MAP: List[Tuple[str, str, str]] = [
    ("aa", "aa", "aa"), ("ae", "ae", "ae"), ("ah", "ah", "ah"),
    ("ao", "ao", "aa"), ("aw", "aw", "aw"), ("ax", "ax", "ah"),
    ("ax-h", "ax", "ah"), ("axr", "er", "er"), ("ay", "ay", "ay"),
    ("b", "b", "b"), ("bcl", "vcl", "sil"), ("ch", "ch", "ch"),
    ("d", "d", "d"), ("dcl", "vcl", "sil"), ("dh", "dh", "dh"),
    ("dx", "dx", "dx"), ("eh", "eh", "eh"), ("el", "el", "l"),
    ("em", "m", "m"), ("en", "en", "n"), ("eng", "ng", "ng"),
    ("epi", "epi", "sil"), ("er", "er", "er"), ("ey", "ey", "ey"),
    ("f", "f", "f"), ("g", "g", "g"), ("gcl", "vcl", "sil"),
    ("h#", "sil", "sil"), ("hh", "hh", "hh"), ("hv", "hh", "hh"),
    ("ih", "ih", "ih"), ("ix", "ix", "ih"), ("iy", "iy", "iy"),
    ("jh", "jh", "jh"), ("k", "k", "k"), ("kcl", "cl", "sil"),
    ("l", "l", "l"), ("m", "m", "m"), ("n", "n", "n"),
    ("ng", "ng", "ng"), ("nx", "n", "n"), ("ow", "ow", "ow"),
    ("oy", "oy", "oy"), ("p", "p", "p"), ("pau", "sil", "sil"),
    ("pcl", "cl", "sil"), ("q", "q", "q"), ("r", "r", "r"),
    ("s", "s", "s"), ("sh", "sh", "sh"), ("t", "t", "t"),
    ("tcl", "cl", "sil"), ("th", "th", "th"), ("uh", "uh", "uh"),
    ("uw", "uw", "uw"), ("ux", "uw", "uw"), ("v", "v", "v"),
    ("w", "w", "w"), ("y", "y", "y"), ("z", "z", "z"),
    ("zh", "zh", "sh"),
]

EOS = "<EOS>"

# The 50-speaker development split used by the reference
# (timit/valid_spkrid.txt — data asset, not code).
VALID_SPEAKERS = frozenset(
    "MTLB0 MHMR0 FGRW0 MJLG1 MDNS0 FALK0 FSLS0 MDWM0 FSJW0 MRJB1 MTPP0 "
    "MADC0 MJKR0 FPAZ0 MGAF0 MBEF0 MAKR0 MILB0 MMEB0 MFMC0 FJLR0 FCKE0 "
    "MRDS0 MRTJ0 MMAR0 FDFB0 MRWA0 MCDD0 MCEF0 FLAC0 FDJH0 MTKP0 MLNS0 "
    "MPRD0 MJJB0 MMAM0 FSKC0 MAPV0 MREH1 MJRH1 MVJH0 MMJB1 MHJB0 MDLC0 "
    "FNTB0 MDEF0 MTJM0 MREE0 FMJF0 MSFV0".split()
)


@dataclasses.dataclass
class Vocab:
    """Phoneme vocabulary with 61->48->39 foldings (0-based indices)."""

    phones: List[str]  # index -> phone61 (+ <EOS> last)
    index: Dict[str, int]  # phone61 -> index
    fold48: Dict[str, str]
    fold39: Dict[str, str]
    index39: Dict[str, int]  # phone39 -> index in the 39(+EOS) space

    @classmethod
    def standard(cls) -> "Vocab":
        phones = sorted(p for p, _, _ in KALDI_MAP) + [EOS]
        fold48 = {p: q for p, q, _ in KALDI_MAP}
        fold39 = {p: r for p, _, r in KALDI_MAP}
        fold48[EOS] = EOS
        fold39[EOS] = EOS
        p39 = sorted(set(fold39.values()) - {EOS}) + [EOS]
        return cls(phones=phones, index={p: i for i, p in enumerate(phones)}, fold48=fold48,
                   fold39=fold39, index39={p: i for i, p in enumerate(p39)})

    @property
    def size(self) -> int:  # 62, the reference's opt.outputDepth
        return len(self.phones)

    def to_ids(self, phones: Sequence[str]) -> np.ndarray:
        return np.array([self.index[p] for p in phones], dtype=np.int32)

    def to_ids39(self, phones: Sequence[str]) -> np.ndarray:
        return np.array([self.index39[self.fold39[p]] for p in phones], dtype=np.int32)

    def map_ids_61_to_39(self, ids: np.ndarray) -> np.ndarray:
        """61(+EOS)-space ids -> 39(+EOS)-space ids (timit.lua:78-82)."""
        lut = np.array([self.index39[self.fold39[p]] for p in self.phones], dtype=np.int32)
        return lut[np.asarray(ids, dtype=np.int64)]


@dataclasses.dataclass
class Utterance:
    uid: str  # e.g. "MTLB0_SX123"
    wav_path: str
    phones: List[str]  # with trailing <EOS>
    starts: np.ndarray  # sample offsets per phone (<EOS> repeats last)
    finishes: np.ndarray
    words: List[str]


def _parse_time_aligned(path: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    starts, finishes, labels = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                starts.append(int(parts[0]))
                finishes.append(int(parts[1]))
                labels.append(parts[2])
    return labels, np.array(starts, np.int64), np.array(finishes, np.int64)


def walk_corpus(root: str, subset: str) -> List[Utterance]:
    """Collect utterances from TIMIT/<subset> (TRAIN or TEST), skipping the
    SA sentences, in sorted directory and file order. Accepts both upper-
    and lower-case corpus layouts; a .PHN without its audio is skipped."""
    utts = []
    for sub in (subset, subset.lower()):
        top = os.path.join(root, sub)
        if os.path.isdir(top):
            break
    else:
        raise FileNotFoundError(f"no {subset} under {root}")
    for dirname, _, fnames in sorted(os.walk(top)):
        for fname in sorted(fnames):
            up = fname.upper()
            if not up.endswith(".PHN") or up.startswith("SA"):
                continue
            stem = fname[:-4]
            spk = os.path.basename(dirname).upper()
            phn = os.path.join(dirname, fname)
            phones, st, fi = _parse_time_aligned(phn)
            wrd = _sibling(dirname, stem, (".WRD", ".wrd"))
            words = _parse_time_aligned(wrd)[0] if wrd else []
            wav = _sibling(dirname, stem, (".WAV", ".wav", ".WAV.wav", ".wav.WAV"))
            if wav is None:
                continue
            # append <EOS> with duplicated final times (preprocess:99-102
            # appends only the token; times arrays keep phone alignment)
            utts.append(
                Utterance(
                    uid=f"{spk}_{stem.upper()}",
                    wav_path=wav,
                    phones=phones + [EOS],
                    starts=st,
                    finishes=fi,
                    words=words,
                )
            )
    return utts


def _sibling(dirname: str, stem: str, exts) -> Optional[str]:
    for e in exts:
        p = os.path.join(dirname, stem + e)
        if os.path.exists(p):
            return p
    return None


def split_train_valid(
    utts: List[Utterance], valid_speakers=VALID_SPEAKERS
) -> Tuple[List[Utterance], List[Utterance]]:
    """Speaker-based split (preprocess_timit.py:62-83)."""
    train = [u for u in utts if u.uid.split("_")[0] not in valid_speakers]
    valid = [u for u in utts if u.uid.split("_")[0] in valid_speakers]
    return train, valid


@dataclasses.dataclass
class Dataset:
    """In-memory split: parallel lists of features and labels."""

    uids: List[str]
    x: List[np.ndarray]  # (L_i, D) float32
    y: List[np.ndarray]  # (T_i,) int32 in 61+EOS space
    y39: List[np.ndarray]  # (T_i,) int32 in 39+EOS space, or None
    start: List[np.ndarray]
    finish: List[np.ndarray]

    def __len__(self):
        return len(self.x)


def build_datasets(
    root: str,
    vocab: Optional[Vocab] = None,
    feature_fn: Callable[[np.ndarray, int], np.ndarray] = features.logmel_np,
    pad: int = 10,
    max_utts: Optional[int] = None,
    pca_components: Optional[int] = None,
) -> Tuple[Dataset, Dataset, Dataset, Vocab, np.ndarray, np.ndarray]:
    """Full offline pipeline: walk -> features -> normalize -> datasets.

    Returns (train, valid, test, vocab, mean, std). `max_utts` truncates
    each split for smoke tests (the reference's --script_test idea).
    `pca_components` optionally projects frames onto train-set principal
    components after normalization (preprocess_timit.py:316-333).
    """
    vocab = vocab or Vocab.standard()
    train_u, valid_u = split_train_valid(walk_corpus(root, "TRAIN"))
    test_u = walk_corpus(root, "TEST")
    if max_utts:
        train_u, valid_u, test_u = (
            train_u[:max_utts], valid_u[:max_utts], test_u[:max_utts]
        )

    def extract(us):
        feats = []
        for u in us:
            pcm, sr = audio.read_audio(u.wav_path)
            feats.append(feature_fn(pcm, sr))
        return feats

    ftr, fva, fte = extract(train_u), extract(valid_u), extract(test_u)
    ftr, fva, fte, mean, std = features.normalize_corpus(ftr, fva, fte, pad=pad)
    if pca_components:
        comps, mu = features.pca_fit(ftr, pca_components)
        ftr = features.pca_apply(ftr, comps, mu)
        fva = features.pca_apply(fva, comps, mu)
        fte = features.pca_apply(fte, comps, mu)

    def mk(us, fs):
        return Dataset(
            uids=[u.uid for u in us],
            x=[f.astype(np.float32) for f in fs],
            y=[vocab.to_ids(u.phones) for u in us],
            y39=[vocab.to_ids39(u.phones) for u in us],
            start=[u.starts for u in us],
            finish=[u.finishes for u in us],
        )

    return mk(train_u, ftr), mk(valid_u, fva), mk(test_u, fte), vocab, mean, std


def save_hdf5(ds: Dataset, path: str) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for i in range(len(ds)):
            g = f.create_group(ds.uids[i])
            g.create_dataset("x", data=ds.x[i])
            g.create_dataset("y", data=ds.y[i])
            if ds.y39 is not None:
                g.create_dataset("y39", data=ds.y39[i])
            g.create_dataset("start", data=ds.start[i])
            g.create_dataset("finish", data=ds.finish[i])


def load_hdf5(path: str) -> Dataset:
    import h5py

    ds = Dataset(uids=[], x=[], y=[], y39=[], start=[], finish=[])
    with h5py.File(path, "r") as f:
        for uid in sorted(f.keys()):
            g = f[uid]
            ds.uids.append(uid)
            ds.x.append(np.asarray(g["x"], np.float32))
            ds.y.append(np.asarray(g["y"], np.int32))
            if "y39" in g:
                ds.y39.append(np.asarray(g["y39"], np.int32))
            ds.start.append(np.asarray(g["start"]) if "start" in g else np.zeros(0))
            ds.finish.append(np.asarray(g["finish"]) if "finish" in g else np.zeros(0))
    if not ds.y39:
        ds.y39 = None
    return ds
