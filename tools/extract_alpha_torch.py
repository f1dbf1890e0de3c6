#!/usr/bin/env python3
"""Attention alignments from a checkpoint of the PyTorch port (the port's
copy of tools/extract_alpha.py, after the reference's ExtractAlpha.lua).

Reads the run's experiment.json (beside the checkpoint) and the
checkpoint through the port's train/checkpoint.py, runs teacher-forced
forwards on the first N utterances of a split, and writes each one's
attention matrix (T x L) with its labels and phone start/finish times to
an HDF5 file (h5py), one group an utterance. Runs on the card unless
--cpu is given; with no card and no --cpu it raises.

Usage:
  python3 tools/extract_alpha_torch.py --ckpt runs/exp1/ckpt_latest \\
      --data data/logmel --out alpha_sample.h5 [--n 20] [--split valid] [--cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from seq2seq_attention_asr_tpu_torch import resolve_device  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import timit  # noqa: E402
from seq2seq_attention_asr_tpu_torch.models import registry  # noqa: E402
from seq2seq_attention_asr_tpu_torch.train import checkpoint, trainer  # noqa: E402


def load_model(ckpt: str, device: torch.device):
    """(model, evaluation params on `device`) of the checkpoint `ckpt`:
    the model named by experiment.json beside it (the flagship's
    defaults when there is none), AWN's mode under noise="awn"."""
    exp_json = os.path.join(os.path.dirname(os.path.abspath(ckpt)), "experiment.json")
    model_name, model_kwargs, noise = "chorowski", {}, "none"
    if os.path.exists(exp_json):
        with open(exp_json) as f:
            blob = json.load(f)
        model_name, model_kwargs = blob["model"], blob["model_kwargs"]
        noise = blob["train"].get("noise", "none")
    model = registry.build(model_name, **model_kwargs)
    state = checkpoint.load(ckpt, device=device)["state"]
    params = trainer.eval_params(trainer.TrainConfig(noise=noise), state[0])
    return model, params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True, help="the directory of <split>.h5")
    ap.add_argument("--out", default="alpha_sample.h5")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--split", default="valid")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import h5py

    device = resolve_device("cpu" if args.cpu else "cuda")
    model, params = load_model(args.ckpt, device)
    ds = timit.load_hdf5(os.path.join(args.data, f"{args.split}.h5"))
    with h5py.File(args.out, "w") as f, torch.no_grad():
        for i in range(min(args.n, len(ds))):
            x = torch.as_tensor(ds.x[i][None], device=device)
            x_len = torch.tensor([len(ds.x[i])], device=device)
            y = ds.y[i]
            onehot = torch.nn.functional.one_hot(torch.as_tensor(y[None], device=device).long(),
                                                 model.output_depth).float()
            dec_mask = torch.ones((1, len(y)), device=device)
            alpha = model.forward(params, x, x_len, onehot, dec_mask, train=False)["alpha"][0]
            alpha = alpha.float().cpu().numpy()
            g = f.create_group(ds.uids[i])
            g.create_dataset("alpha", data=alpha)
            g.create_dataset("y", data=y)
            g.create_dataset("start", data=ds.start[i])
            g.create_dataset("finish", data=ds.finish[i])
            print(f"{ds.uids[i]}: alpha {alpha.shape}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
