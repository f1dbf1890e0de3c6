"""The mesh's collectives over a torch.distributed process group: the
counterparts of the JAX package's ``psum``, ``pmax``, ``all_gather`` and
``ppermute`` inside ``shard_map`` (ops/masking.py, ops/monotonic.py,
ops/attention.py, decode/beam.py there).

Every one of them is an all-reduce: a sum, a max, or, for the gathers
and the halo exchange, the sum of a buffer in which each rank fills its
own slot and leaves the others zero (adding zeros is exact, so each rank
reads its peers' values bit for bit). gloo and NCCL both take an
all-reduce, so no point-to-point operation is needed. A group of the
gloo backend on CUDA tensors stages the operand through the host (a copy
to the CPU, the all-reduce there, a copy back): the one way two ranks
that share one card can talk, since NCCL refuses two ranks on one device.
bf16 operands are reduced in float32 and rounded back.

``group=None`` is the world of one rank: every function returns its
input's value unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def reduce(x: torch.Tensor, op=ReduceOp.SUM, group=None) -> torch.Tensor:
    """The all-reduce of x over `group`, a new tensor on x's device and of
    its type; no gradient."""
    if group is None:
        return x.detach().clone()
    wide = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    buf = x.detach().to(wide, copy=True).contiguous()
    if _staged(buf, group):
        buf = buf.cpu()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(device=x.device, dtype=x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over the group; its backward sums the cotangents over
    the group, which is what every rank's copy of the sum owes each term."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce(x, ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return reduce(g, ReduceOp.SUM, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum of x over `group` (x itself when None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The max of x over `group`, with no gradient (x when None)."""
    return x if group is None else reduce(x, ReduceOp.MAX, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (each (B, ...), the same shape) stacked along the
    rows in the group's rank order: (n * B, ...); no gradient."""
    if group is None:
        return x
    slots = x.new_zeros((size(group),) + tuple(x.shape))
    slots[rank(group)] = x
    return reduce(slots, ReduceOp.SUM, group).reshape((-1,) + tuple(x.shape[1:]))


class _Halo(torch.autograd.Function):
    """[left halo | x | right halo] along the last axis, the halos the
    neighbours' edge positions (zeros at the chain's ends), as
    ``_halo_exchange``'s two ppermutes give them; the backward sends each
    halo's cotangent back to the edge it came from."""

    @staticmethod
    def forward(ctx, x, left, right, group):
        n, me, loc = size(group), rank(group), x.shape[-1]
        ctx.args = (left, right, group, loc)
        edges = x.new_zeros((n,) + tuple(x.shape[:-1]) + (left + right,))
        edges[me] = torch.cat([x[..., loc - left:], x[..., :right]], dim=-1)
        edges = reduce(edges, ReduceOp.SUM, group)
        zeros = x.new_zeros(tuple(x.shape[:-1]) + (left + right,))
        lh = (edges[me - 1] if me > 0 else zeros)[..., :left]
        rh = (edges[me + 1] if me < n - 1 else zeros)[..., left:]
        return torch.cat([lh, x, rh], dim=-1)

    @staticmethod
    def backward(ctx, g):
        left, right, group, loc = ctx.args
        n, me = size(group), rank(group)
        dx = g[..., left:left + loc].clone()
        back = g.new_zeros((n,) + tuple(g.shape[:-1]) + (left + right,))
        if me > 0:
            back[me - 1, ..., :left] = g[..., :left]
        if me < n - 1:
            back[me + 1, ..., left:] = g[..., left + loc:]
        back = reduce(back, ReduceOp.SUM, group)[me]
        dx[..., loc - left:] += back[..., :left]
        dx[..., :right] += back[..., left:]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """x (..., L_loc), one shard of a sequence split over `group` in rank
    order, with `left` positions of the previous shard in front and
    `right` of the next one behind: (..., left + L_loc + right). A shard
    narrower than its halo is refused."""
    if x.shape[-1] < max(left, right):
        raise ValueError(f"a shard of {x.shape[-1]} positions is narrower than its halo "
                         f"({left}, {right})")
    return _Halo.apply(x, left, right, group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """x as rank `src` of the default group (or `group`) holds it, on x's
    device; x itself when no process group exists."""
    if not dist.is_initialized():
        return x
    buf = x.detach().clone().contiguous()
    if _staged(buf, group):
        buf = buf.cpu()
    dist.broadcast(buf, src, group=group)
    return buf.to(x.device)


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)
