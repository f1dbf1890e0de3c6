#!/usr/bin/env python3
"""Convert a JAX Trainer checkpoint's parameters into the port's `.npz`.

A bridge between the two packages, run on the CPU: it reads the orbax
checkpoint with the JAX package's reader (`train/checkpoint.py`, which
needs JAX and orbax) and writes the parameters alone, as float32, with
the PyTorch port's `save_params_npz`, which the port reads with
`load_params_npz` on any device, the card included. It is the one file
beside the port that imports the JAX package; nothing of the port
imports it.

    JAX_PLATFORMS=cpu python tools/ckpt_to_npz.py \
        [--ckpt runs/timit_shape_ckpt/full/ckpt_best_valid_PER] \
        [--out runs/timit_shape_ckpt/full/params.npz]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "runs", "timit_shape_ckpt", "full", "ckpt_best_valid_PER")
OUT = os.path.join(ROOT, "runs", "timit_shape_ckpt", "full", "params.npz")


def checkpoint_params(path: str):
    """The model parameters of a JAX Trainer checkpoint, as numpy arrays:
    the first entry of its train state."""
    import jax
    import numpy as np

    from seq2seq_attention_asr_tpu.train import checkpoint

    return jax.tree.map(np.asarray, checkpoint.load(path)["state"][0])


def main(argv=None) -> int:
    from seq2seq_attention_asr_tpu_torch.train import checkpoint as port_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    port_checkpoint.save_params_npz(args.out, checkpoint_params(args.ckpt))
    print(f"{args.out}: {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
