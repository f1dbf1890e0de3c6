"""NaN tripwires (seq2seq_attention_asr_tpu/utils/debug.py).

The reference's TrainUtils.lua:55-93 checks norms for NaN inside the
column-norm projection, stashes the offending module and stops. Here
`find_nonfinite` scans a parameter tree (nested dicts and lists of
tensors or arrays) on the host and names the leaves that hold NaN or
Inf, with the JAX package's path strings ("['decoder']['w_e']");
`check_finite` raises `NonFiniteError` with them. The jaxpr and graphviz
helpers of the JAX module have no counterpart here.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch



def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.all(np.isfinite(arr)))


def find_nonfinite(tree: Any, path=()) -> List[str]:
    """Paths of the floating-point leaves that hold NaN or Inf, in the JAX
    package's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in find_nonfinite(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in find_nonfinite(v, path + (i,))]
    return [] if _finite(tree) else [_keystr(path)]


class NonFiniteError(RuntimeError):
    """Raised by the tripwire; carries the offending leaf paths (the
    reference's `__debug_module` stash, TrainUtils.lua:58-60)."""

    def __init__(self, name: str, paths: List[str]):
        super().__init__(f"non-finite values in {name}: {paths}")
        self.name = name
        self.paths = paths


def check_finite(tree: Any, name: str = "tree") -> None:
    """Host-side tripwire: raise NonFiniteError listing the bad leaves."""
    bad = find_nonfinite(tree)
    if bad:
        raise NonFiniteError(name, bad)
