"""TIMIT vocabulary, in-memory datasets and the HDF5 format
(seq2seq_attention_asr_tpu/data/timit.py).

The phoneme vocabulary (61 observed phones + <EOS> = 62, sorted, 0-based)
with the standard Kaldi 60->48->39 folding table (preprocess_timit.py:
163-180), the in-memory split, and the per-utterance HDF5 groups {x, y,
y39, start, finish} (preprocess_timit.py:341-363). The corpus walk and
the offline feature pipeline are not ported. ``h5py`` is imported inside
the two HDF5 functions only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

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
