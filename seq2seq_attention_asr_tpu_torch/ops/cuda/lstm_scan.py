"""Bidirectional LSTM scan, forward (kernel K7).

Replaces the forward of the Pallas kernel ``bilstm_scan``
(seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:178, ``_run_fwd``
:103, ``pallas_call`` :107, body ``_fwd_kernel`` :36). CUDA source
``csrc/bilstm_scan.cu``; ``bilstm_scan_plain`` below is the same
function in plain PyTorch.

Both directions run in one launch over the direction-stacked input
projections; direction 1 arrives already flipped into its scan order
(ops/rnn.py::bilstm_layer does the flips). The cell-state sequence is
written beside the hidden states, as ``_run_fwd`` does, for the
backward pass of a later slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.Kernel(
    "bilstm_scan", "bilstm_scan.cu", "bilstm_scan_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
MAX_H = 1024  # csrc/bilstm_scan.cu refuses wider states


def bilstm_scan_plain(xproj2, h02, c02, wh2):
    """Plain PyTorch twin: a Python loop over time of the gate math of
    cells.lstm_step_preproj, both directions stacked."""
    _, b, l, h4 = xproj2.shape
    h_dim = h4 // 4
    h, c = h02, c02
    hs = xproj2.new_empty((2, b, l, h_dim))
    cs = xproj2.new_empty((2, b, l, h_dim))
    for t in range(l):
        g_in, g_forget, g_cell, g_out = (xproj2[:, :, t] + torch.bmm(h, wh2)).chunk(4, dim=-1)
        c = torch.sigmoid(g_forget) * c + torch.sigmoid(g_in) * torch.tanh(g_cell)
        h = torch.sigmoid(g_out) * torch.tanh(c)
        hs[:, :, t] = h
        cs[:, :, t] = c
    return hs, cs


def bilstm_scan(xproj2, h02, c02, wh2):
    """xproj2 (2, B, L, 4H): ``x @ w_x + b`` per direction, direction 1
    in its scan order; h02, c02 (2, B, H) initial states; wh2 (2, H, 4H)
    recurrent weights. Returns (hidden states, cell states), each
    (2, B, L, H) float32, direction 1 in scan order. No peepholes.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if build.on_cpu(xproj2, h02, c02, wh2):
        return bilstm_scan_plain(xproj2, h02, c02, wh2)
    _, b, l, h4 = xproj2.shape
    h = h4 // 4
    if h4 != 4 * h or not 1 <= h <= MAX_H:
        raise ValueError(f"bilstm_scan: hidden size {h4 / 4} not in [1, {MAX_H}]")
    dev = xproj2.device
    for name, t, shape in (("xproj2", xproj2, (2, b, l, 4 * h)), ("h02", h02, (2, b, h)),
                           ("c02", c02, (2, b, h)), ("wh2", wh2, (2, h, 4 * h))):
        build.check(name, t, shape, dev)
    hs = torch.empty((2, b, l, h), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs)
    if b * l == 0:
        return hs, cs
    KERNEL.launch(
        build.ptr(xproj2), build.ptr(h02), build.ptr(c02), build.ptr(wh2),
        build.ptr(hs), build.ptr(cs), b, l, h, build.stream_of(xproj2),
    )
    return hs, cs
