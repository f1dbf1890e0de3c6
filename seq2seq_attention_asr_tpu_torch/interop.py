"""Parameter trees between the JAX package and the port.

Both packages keep parameters as nested dicts and lists of arrays with
the same keys, the same list order and the same input-major ``(in,
out)`` kernel layout (seq2seq_attention_asr_tpu/ops/cells.py:40-53), so
a tree converts leaf by leaf with no renaming or transposes. The JAX
side hands over numpy arrays (``np.asarray`` of its leaves, or a
checkpoint loaded by its ``train/checkpoint.py``); nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device
from .tree import tree_map


def to_torch(tree: Any, device="cuda") -> Any:
    """Array-like leaves -> tensors on `device`, dtype kept."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return tree_map(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays (on the host), dtype kept."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
