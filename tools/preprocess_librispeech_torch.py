#!/usr/bin/env python3
"""Offline LibriSpeech preprocessing with the PyTorch port alone (the
port's copy of tools/preprocess_librispeech.py, the same flags and the
same files).

Builds the character and word vocabularies, decodes the FLAC audio with
the port's C++ decoder, extracts features on the CPU, and writes a
chunked train set (train<N>.h5 and the train.db manifest), valid.h5 and
test.h5, mean_std.npz, meta.txt (inputFrameSize, sample counts,
numchars, numwords, labelset_words) and chars.txt. --labelset picks
character or word targets (opt.labelset, librispeech/train.lua:28);
--script-test keeps 20 utterances a split in 5 chunks, as the
reference's --script_test (preprocess.py:35-39). Writing HDF5 needs
h5py.

Usage:
  python3 tools/preprocess_librispeech_torch.py --train DIR --valid DIR \\
      [--test DIR] --out ./data [--chunks 8] [--labelset chars|words] \\
      [--variant logmel|logmel_stacked] [--script-test]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from seq2seq_attention_asr_tpu_torch.data import features, librispeech as ls  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import timit  # noqa: E402


def to_time_major(datasets) -> None:
    """Stacked features (3, L, F) -> (L, F, 3) in place, float32: bucketing
    and padding key on axis 0, and the batch arrives NHWC as vgg.encode
    takes it."""
    for ds in datasets.values():
        ds.x[:] = [np.ascontiguousarray(np.transpose(f, (1, 2, 0)), np.float32) for f in ds.x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", required=True)
    ap.add_argument("--valid", required=True)
    ap.add_argument("--test", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--labelset", choices=("chars", "words"), default="chars")
    ap.add_argument("--variant", choices=("logmel", "logmel_stacked"), default="logmel",
                    help="logmel: flat 123-dim frames (chorowski recipes); logmel_stacked: "
                         "3-channel (L, freq, 3) logmel/delta/delta-delta for the VGG recipe")
    ap.add_argument("--script-test", action="store_true")
    args = ap.parse_args(argv)

    roots = {"train": args.train, "valid": args.valid}
    if args.test:
        roots["test"] = args.test
    feature_fn = (features.logmel_stacked_np if args.variant == "logmel_stacked"
                  else features.logmel_np)
    datasets, vocab, mean, std = ls.build_datasets(
        roots, feature_fn=feature_fn, pad=1, max_utts=20 if args.script_test else None,
        labelset=args.labelset)
    if args.variant == "logmel_stacked":
        to_time_major(datasets)
    os.makedirs(args.out, exist_ok=True)
    n_chunks = 5 if args.script_test else args.chunks
    ls.save_chunked(datasets["train"], args.out, n_chunks=n_chunks)
    for split in ("valid", "test"):
        if split in datasets:
            timit.save_hdf5(datasets[split], os.path.join(args.out, f"{split}.h5"))
    np.savez(os.path.join(args.out, "mean_std.npz"), mean=mean, std=std)
    d = datasets["train"]
    ls.save_meta(args.out, {
        "inputFrameSize": (int(d.x[0].shape[-2] if d.x[0].ndim == 3 else d.x[0].shape[-1])
                           if len(d) else 0),
        "trainsamples": len(d),
        "validsamples": len(datasets.get("valid", [])),
        "testsamples": len(datasets.get("test", [])),
        "numchars": vocab.num_chars,
        "numwords": vocab.num_words,
        "labelset_words": 1 if args.labelset == "words" else 0,
    })
    with open(os.path.join(args.out, "chars.txt"), "w") as f:
        for c, i in sorted(vocab.charmap.items(), key=lambda kv: kv[1]):
            f.write(f"{c!r} {i}\n")
    print(f"wrote {len(d)} train utterances in {n_chunks} chunks to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
