"""The dp x sp mesh over torch.distributed
(seq2seq_attention_asr_tpu/parallel/mesh.py).

The JAX package's mesh names two axes of its devices: "dp", data
parallelism over the batch's rows, and "sp", the encoder positions of
the attention decoder. Here the world's ranks form the same (dp, sp)
grid, rank r at (r // sp, r % sp) as the JAX mesh lays its devices out,
each rank one process on one device; ``Mesh`` holds the rank's
coordinates, its device and two process groups, "dp" (the ranks of its
sp column: the batch's other rows) and "sp" (the ranks of its dp row:
the other positions of its rows), and the world's. A world of one rank
with no process group has no groups at all: every collective is then the
identity (parallel/comm.py).

PyTorch has no sharded global array, so the JAX package's shardings
become functions that take this rank's part of a host array: its rows
(``shard_batch``, ``put_batch``: ``batch_sharding``), its positions
(``shard_positions``: ``annotation_sharding``'s sp split) and the whole
tree, the same on every rank (``put_replicated``: ``replicated``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device, tree
from . import comm, multihost

DATA_AXIS = "dp"
SEQ_AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    sp: int
    rank: int  # in the world
    device: torch.device
    groups: Dict[str, Any]  # "dp", "sp", "world": process groups, or None in a world of one

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, SEQ_AXIS: self.sp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    @property
    def dp_group(self):
        return self.groups[DATA_AXIS]

    @property
    def sp_group(self):
        """The sp group, or None where sp = 1 (the decoder then runs its
        kernels, as the JAX package's does outside shard_map)."""
        return self.groups[SEQ_AXIS] if self.sp > 1 else None

    @property
    def world(self):
        return self.groups["world"]

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


def _device(device, rank: int) -> torch.device:
    """The rank's device: `device`, or for a bare "cuda" the card of
    LOCAL_RANK (a launcher's), else of rank modulo the visible cards."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(dp: Optional[int] = None, sp: int = 1, device="cuda") -> Mesh:
    """The (dp, sp) mesh of the world's ranks; dp defaults to world // sp.

    The default process group is used where one exists (a launcher's, or
    one the caller built); otherwise multihost.initialize() builds it from
    a launcher's environment (NCCL for the card, gloo for the CPU), and a
    world of one rank needs none. Two ranks that share a card need a gloo
    group, which the caller builds first: NCCL refuses them, and this
    function never switches backends on its own. Runs on the card unless
    device="cpu"."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        multihost.initialize(backend="nccl" if dev.type == "cuda" else "gloo")
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} ranks")
    dev = _device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = {DATA_AXIS: None, SEQ_AXIS: None, "world": None}
    if dist.is_initialized():
        groups["world"] = dist.group.WORLD
        # Every rank creates every group, in the same order.
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)], group_desc=DATA_AXIS)
            if rank % sp == j:
                groups[DATA_AXIS] = g
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)], group_desc=SEQ_AXIS)
            if rank // sp == i:
                groups[SEQ_AXIS] = g
    return Mesh(dp=dp, sp=sp, rank=rank, device=dev, groups=groups)


def _rows(mesh: Mesh, a):
    b = a.shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} rows does not divide dp={mesh.dp}")
    n = b // mesh.dp
    return a[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def shard_batch(mesh: Mesh, a) -> torch.Tensor:
    """This rank's rows of a global batch array (B divisible by dp), as a
    tensor on its device."""
    rows = _rows(mesh, a)
    t = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(rows))
    return t.to(mesh.device)


def put_batch(mesh: Mesh, batch):
    """shard_batch on every leaf of a batch tree."""
    return tree.tree_map(lambda a: shard_batch(mesh, a), batch)


def shard_positions(mesh: Mesh, h: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """This rank's positions of h along `axis` (the encoder positions;
    the padded length must divide sp), as annotation_sharding splits them."""
    l = h.shape[axis]
    if l % mesh.sp:
        raise ValueError(f"a padded length of {l} positions does not divide sp={mesh.sp}")
    n = l // mesh.sp
    return h.narrow(axis, mesh.sp_rank * n, n)


def put_replicated(mesh: Mesh, params):
    """Every tensor leaf of `params` on this rank's device, as rank 0
    holds it (a broadcast over the world, so that every rank starts
    identical); other leaves as they are."""
    def put(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if not isinstance(a, torch.Tensor):
            return a
        return comm.broadcast(a.to(mesh.device), 0, mesh.world)

    return tree.tree_map(put, params)


def pad_batch_to(tree_, batch: int):
    """Pad a host batch pytree's leading axis up to `batch` (so uneven
    final batches still divide the dp axis); returns (tree, real_n)."""

    def pad(a):
        n = a.shape[0]
        if n == batch:
            return a
        reps = np.zeros((batch - n,) + a.shape[1:], a.dtype)
        return np.concatenate([a, reps], axis=0)

    n = tree.leaves(tree_)[0].shape[0]
    return tree.tree_map(pad, tree_), n
