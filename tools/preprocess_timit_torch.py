#!/usr/bin/env python3
"""Offline TIMIT preprocessing with the PyTorch port alone (the port's
copy of tools/preprocess_timit.py, the same flags and the same files).

Walks a TIMIT tree (the SA sentences skipped, the reference's 50-speaker
development split taken out of TRAIN), extracts features on the CPU,
normalizes with the train split's statistics, and writes
<out>/<variant>/{train,valid,test}.h5 with per-utterance groups {x, y,
y39, start, finish}, mean_std.npz and the phonemes.txt vocabulary dump.
Writing HDF5 needs h5py.

Usage:
  python3 tools/preprocess_timit_torch.py --root /path/to/TIMIT --out ./data \\
      [--variant logmel|logmel_stacked|cqt|...] [--max-utts N] [--pca N]
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from seq2seq_attention_asr_tpu_torch.data import features, timit  # noqa: E402

FEATURES = {
    "logmel": features.logmel_np,
    "logmel_stacked": features.logmel_stacked_np,
    "cqt": features.cqt_np,
    "cqt_stacked": features.cqt_stacked_np,
    # true constant-Q kernels (features.cqt_exact_np) instead of the
    # STFT-projected pseudo-CQT
    "cqt_exact": functools.partial(features.cqt_np, method="exact"),
    "cqt_exact_stacked": functools.partial(features.cqt_stacked_np, method="exact"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="TIMIT corpus root")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--variant", default="logmel", choices=list(FEATURES))
    ap.add_argument("--pad", type=int, default=10)
    ap.add_argument("--max-utts", type=int, default=None,
                    help="truncate each split (smoke tests)")
    ap.add_argument("--pca", type=int, default=None,
                    help="project frames onto N train-set principal components "
                         "(preprocess_timit.py:316-333)")
    args = ap.parse_args(argv)

    train, valid, test, vocab, mean, std = timit.build_datasets(
        args.root, feature_fn=FEATURES[args.variant], pad=args.pad, max_utts=args.max_utts,
        pca_components=args.pca)
    outdir = os.path.join(args.out, args.variant)
    os.makedirs(outdir, exist_ok=True)
    for name, ds in (("train", train), ("valid", valid), ("test", test)):
        timit.save_hdf5(ds, os.path.join(outdir, f"{name}.h5"))
    np.savez(os.path.join(outdir, "mean_std.npz"), mean=mean, std=std)
    # phonemes.txt (preprocess_timit.py:176-180)
    with open(os.path.join(outdir, "phonemes.txt"), "w") as f:
        f.write("index60,phoneme60,index39,phoneme39\n")
        for i, p in enumerate(vocab.phones):
            f.write(f"{i},{p},{vocab.index39[vocab.fold39[p]]},{vocab.fold39[p]}\n")
    print(f"wrote {len(train)} train / {len(valid)} valid / {len(test)} test utterances to "
          f"{outdir} (inputFrameSize={train.x[0].shape[-1] if len(train) else '?'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
