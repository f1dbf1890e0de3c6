"""Checkpoint and resume (seq2seq_attention_asr_tpu/train/checkpoint.py).

The reference `torch.save`s the whole model table every epoch, with
best-valid-accuracy and best-valid-PER copies (timit/timit.lua:551-562).
Here `save` writes the trainer's blob (the train state (params,
optimizer state, generator), the epoch and the best metrics) with
`torch.save`, atomically; a `torch.Generator` is stored as its device
and state and rebuilt by `load`, on the device it is asked for.

`save_params_npz` and `load_params_npz` keep a parameter tree alone as
one `.npz` of float32 arrays keyed by the `/`-joined tree path: the
format of a checkpoint carried over from the JAX package, which the card
can read without JAX or orbax. A list in the tree is stored by index;
an entry with no leaves (a dropout layer of the readout) comes back as
an empty dict, as the JAX package's tree has it.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .. import interop, resolve_device
from ..tree import map_with_path

_GEN = "__generator__"


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Generator):
        return {_GEN: str(obj.device), "state": obj.get_state()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    return obj


def _unpack(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, dict):
        if _GEN in obj:
            gen = torch.Generator(device=device if obj[_GEN] != "cpu" else "cpu")
            gen.set_state(obj["state"].cpu())
            return gen
        return {k: _unpack(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def save(path: str, blob: Any) -> None:
    """Atomic save of nested dicts, lists and tuples of tensors, numbers,
    strings and generators."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_pack(blob), tmp)
    os.replace(tmp, path)


def load(path: str, device="cuda") -> Any:
    """A blob written by `save`, its tensors on `device` (the card unless
    "cpu"); a generator saved from a card comes back on `device`."""
    dev = resolve_device(device)
    return _unpack(torch.load(path, map_location="cpu", weights_only=True), dev)


def exists(path: str) -> bool:
    return os.path.isfile(path)


def save_params_npz(path: str, params: Any) -> None:
    """A parameter tree (numpy arrays or tensors) as one float32 .npz,
    keyed by `/`-joined paths (dict keys and list indices)."""
    flat = {}

    def leaf(p, a):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        flat["/".join(str(k) for k in p)] = a.astype(np.float32)

    map_with_path(leaf, params)
    with open(path, "wb") as f:  # np.savez would append ".npz" to a bare name
        np.savez(f, **flat)


def _listify(node: Any) -> Any:
    """Dicts keyed by indices become lists; an index with no leaves is {}."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node.get(str(i), {}) for i in range(max(int(k) for k in node) + 1)]
    return node


def load_params_npz(path: str, device="cuda") -> Any:
    """The tree `save_params_npz` wrote, as tensors on `device` (the card
    unless "cpu"), in `interop`'s layout."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, name = key.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = z[key]
    return interop.to_torch(_listify(root), device)
