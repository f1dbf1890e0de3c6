"""The plan of a recurrent walk on a thread-block cluster.

The GRU forward (K1, K16, K18; cell "gru_fwd") and backward (K6, K17,
K19; cell "gru"), both in ``csrc/gru_walk.cuh``, and the LSTM forward
(K7; cell "lstm_fwd", ``csrc/bilstm_scan.cu``) and backward (K9; cell
"lstm", ``csrc/bilstm_scan_bwd.cu``) run each direction's walk
for a group of R batch rows on one cluster of C blocks; block k owns the
state units [k H / C, (k + 1) H / C) and holds the slice of the
recurrent weight that touches them. The plan fixes C, R and whether the
weight slices are held in shared memory ("resident") or read from L2
each step ("streamed"). It is a plain function of the shapes and of two
numbers of the device, which ``limits`` asks the kernel's library for:
the opt-in shared memory of a block and how many clusters can be
resident when each block takes that much (one block to an SM, from
``cudaOccupancyMaxActiveClusters``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

CLUSTER = 8  # blocks of a cluster: the largest portable size
ROWS = (1, 2, 4, 8, 16)  # batch rows of a cluster: the walk's instances
# A walk's step costs about as much as STEP_ROWS more batch rows of work:
# the barriers and pushes every step pays, against the products and pushes
# that grow with R. K6's walk at B=16, L=144, H=256 takes 4.2, 4.4, 5.0,
# 6.9 and 16.3 us a step and wave at R = 1, 2, 4, 8, 16 (chip_smoke.py
# phase 8 on an NVIDIA H100 80GB HBM3 at 700.00 W), and this cost picks the
# fastest R there and at B=128 (R=8, 3 waves of 15 clusters).
STEP_ROWS = 4
# The forward walk's step grows with R faster than that at R = 16 (its
# registers overflow into a 240-byte stack frame), so its cost is the step
# and wave K1's walk takes at each R, in us: 3.42, 4.10, 4.89, 6.75 and
# 18.83 at B=16, 3.64, 4.30, 5.15, 7.07 and 19.20 at B=128, L=144, H=256
# (chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3 at 700.00 W).
# K7's LSTM forward walk takes 2.18-2.25, 2.30-2.91, 2.75-3.34,
# 3.29-3.85 and 12.18-12.89 us a step and wave at R = 1, 2, 4, 8, 16 (its
# 4 x 16 sums a lane at R = 16 spill into a stack frame) over B=1 and 8,
# L'=14 and B=16 and 128, L'=16, H=128 (chip_smoke.py phase 8 on an NVIDIA
# H100 80GB HBM3 at 700.00 W).
STEP_COST = {"gru_fwd": {1: 3.5, 2: 4.2, 4: 5.0, 8: 6.9, 16: 19.0},
             "lstm_fwd": {1: 2.2, 2: 2.4, 4: 2.8, 8: 3.3, 16: 12.5}}
# Per cell, in floats, what csrc/cluster_walk.cuh's walk_smem_bytes
# counts: the weight slice's width a unit and the vectors gathered from
# every unit a batch row, both in units of H (the backward's gathered
# cotangents, one or two copies of the weight width; the forward's h and
# r * h; the LSTM forward's two buffers of h), the per-unit inputs staged
# for a step (two buffers of them) and the per-unit values a step keeps
# across phases.
WIDTH = {"gru": 3, "lstm": 4, "gru_fwd": 3, "lstm_fwd": 4}
GATHERED = {"gru": 3, "lstm": 8, "gru_fwd": 2, "lstm_fwd": 2}
STAGED = {"gru": 5, "lstm": 7, "gru_fwd": 3, "lstm_fwd": 4}
HELD = {"gru": 3, "lstm": 2, "gru_fwd": 1, "lstm_fwd": 1}


@dataclasses.dataclass(frozen=True)
class Plan:
    cluster: int
    rows: int
    resident: bool

    def args(self) -> Tuple[int, int, int]:
        """The C entry points' (cluster, rows, resident) arguments."""
        return self.cluster, self.rows, int(self.resident)


def smem_bytes(cell: str, h: int, cluster: int, rows: int, resident: bool) -> int:
    """Shared memory of one block of the walk, as the kernel lays it out."""
    hs = -(-h // cluster)
    floats = ((hs * WIDTH[cell] * h if resident else 0) + GATHERED[cell] * rows * h
              + (2 * STAGED[cell] + HELD[cell]) * rows * hs)
    return 4 * floats


def plan(b: int, h: int, cell: str, directions: int, smem_limit: int, clusters: int) -> Plan:
    """The walk's plan for batch b, state width h and `directions`
    directions, on a device whose blocks take at most `smem_limit` bytes
    of shared memory and that holds `clusters` clusters of CLUSTER blocks
    at once.

    - C = CLUSTER, or h where h is narrower (a block owns at least one unit).
    - R takes the fewest step costs: the launch's directions * ceil(b / R)
      clusters run in ceil(that / clusters) waves, each step of a wave
      costing STEP_COST[cell][R], or STEP_ROWS + R for a cell without a
      table; the smallest R of equal cost. Where one wave holds every
      cluster this is the smallest R that fits one wave, unless a larger R
      in one wave costs less.
    - The weight slices are resident where the blocks' shared memory holds
      them at that R, else streamed; a streamed plan halves R until it fits.
    """
    c = min(CLUSTER, h)

    def cost(r):
        step = STEP_COST[cell][r] if cell in STEP_COST else STEP_ROWS + r
        return -(-directions * -(-b // r) // clusters) * step

    rows = min(ROWS, key=lambda r: (cost(r), r))
    if smem_bytes(cell, h, c, rows, True) <= smem_limit:
        return Plan(c, rows, True)
    while smem_bytes(cell, h, c, rows, False) > smem_limit:
        if rows == ROWS[0]:
            raise ValueError(f"{cell} walk: H={h} does not fit {smem_limit} bytes of shared "
                             "memory")
        rows //= 2
    return Plan(c, rows, False)


_LIMITS: Dict[Tuple[str, int], Tuple[int, int]] = {}


def limits(kernel, device: torch.device) -> Tuple[int, int]:
    """(opt-in shared memory of a block, resident clusters of CLUSTER
    blocks) of `kernel`'s walk on `device`, from its ``<symbol>_limits``
    C helper; asked once per kernel and device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (kernel.name, index)
    if key not in _LIMITS:
        out = ctypes.POINTER(ctypes.c_int)
        fn = kernel.helper(kernel.symbol + "_limits", [ctypes.c_int, out, out])
        smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(CLUSTER, ctypes.byref(smem), ctypes.byref(clusters))
        if rc != 0 or clusters.value < 1:
            raise RuntimeError(f"{kernel.name}: no cluster of {CLUSTER} blocks fits the device "
                               f"(error {rc}, {clusters.value} clusters)")
        _LIMITS[key] = (smem.value, clusters.value)
    return _LIMITS[key]


def plan_on(kernel, b: int, h: int, cell: str, directions: int, device: torch.device) -> Plan:
    """The plan `kernel`'s wrapper runs for these shapes on `device`."""
    return plan(b, h, cell, directions, *limits(kernel, device))
