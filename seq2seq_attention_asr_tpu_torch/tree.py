"""Parameter trees: nested dicts and lists of tensors, the JAX package's
pytree layout (same keys, same list order), walked in that order."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Path = Tuple[Any, ...]


def map_with_path(fn: Callable, tree: Any, *rest: Any, path: Path = ()) -> Any:
    """fn(path, leaf, *leaves_of_rest) at every leaf; `rest` are trees of
    the same structure. Tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def unflatten(tree: Any, new_leaves: List[Any]) -> Any:
    """A tree of `tree`'s structure holding `new_leaves` in leaf order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in leaves(tree)))
