"""The world's process group and each rank's share of the data
(seq2seq_attention_asr_tpu/parallel/multihost.py).

Every rank runs the same program. ``initialize`` builds the default
process group of torch.distributed from its arguments or a launcher's
environment (``python -m torch.distributed.run`` sets WORLD_SIZE, RANK,
MASTER_ADDR and MASTER_PORT); ``host_shard`` gives each rank its slice
of a dataset; ``global_batch`` puts a rank's local arrays on its device,
as the rows of the global batch it feeds: PyTorch has no global array
to stitch them into, which the JAX package's
``make_array_from_process_local_data`` does.

``spawn`` starts a world of ranks on this host, each a process of its
own joined to the others over a file store, under a time limit: the
tests run their worlds of 2 and 4 ranks over gloo this way, and
chip_smoke.py its two ranks that share the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tree


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group for a world of num_processes
    ranks (default: WORLD_SIZE, else 1), this one process_id (RANK, else
    0), meeting at coordinator_address ("host:port", default MASTER_ADDR
    and MASTER_PORT); backend NCCL where a card is visible, else gloo,
    unless given. Nothing happens when the group already exists, or in a
    world of one rank with no coordinator."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes == 1 and coordinator_address is None:
        return
    if coordinator_address is None:
        raise ValueError(f"a world of {num_processes} ranks needs a coordinator address")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def host_shard(ds, process_id: Optional[int] = None, process_count: Optional[int] = None):
    """A rank's slice of a dataset, utterance-level round robin: rank p
    owns utterances p, p + n, ... Deterministic; the dataset itself in a
    world of one."""
    ready = dist.is_initialized()
    pid = (dist.get_rank() if ready else 0) if process_id is None else process_id
    n = (dist.get_world_size() if ready else 1) if process_count is None else process_count
    if n <= 1:
        return ds
    idx = list(range(pid, len(ds), n))
    return dataclasses.replace(
        ds,
        uids=[ds.uids[i] for i in idx],
        x=[ds.x[i] for i in idx],
        y=[ds.y[i] for i in idx],
        y39=None if ds.y39 is None else [ds.y39[i] for i in idx],
        start=[ds.start[i] for i in idx],
        finish=[ds.finish[i] for i in idx],
    )


def global_batch(mesh, local_arrays):
    """This rank's local batch arrays on its device: the rows of the
    global batch that it feeds, in rank order."""
    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(mesh.device)

    return tree.tree_map(put, local_arrays)


def _host(x):
    """A result tree with every tensor as a numpy array (bf16 widened)."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().cpu().numpy() if a.dtype == torch.bfloat16 \
                else a.detach().cpu().numpy()
        return a

    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return conv(x)


def _rank_main(rank, nprocs, store, fn, args, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=nprocs,
                                rank=rank, timeout=datetime.timedelta(seconds=120))
        result = fn(rank, *args)
        dist.barrier()
        out.put((rank, "ok", _host(result)))
    except Exception:  # the parent raises it with the rank's traceback
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, timeout: float = 120.0) -> List[Any]:
    """fn(rank, *args) on each of `nprocs` new processes (the "spawn"
    start method: fn and args must pickle), joined in one gloo world over
    a file store, one intra-op thread each: gloo, since ranks that share
    a card cannot use NCCL. Returns each rank's result, tensors as numpy
    arrays, in rank order. Raises the first rank's error, or TimeoutError
    when the world has not finished within `timeout` seconds (a hung
    collective); no rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, os.path.join(tmp, "store"), fn, args, out))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout} s "
                                   f"(ranks done: {sorted(results)})")
            try:
                rank, status, value = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0]}")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=10)
        return [results[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
