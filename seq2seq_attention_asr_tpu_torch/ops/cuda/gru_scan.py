"""Flip-free bidirectional GRU scan: forward (kernel K1) and backward
(kernel K6), joined by the autograd function ``BiGRUScan2``.

K1 replaces the Pallas kernel ``bigru_scan2`` forward
(seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666, body
``_bi2_fwd_kernel`` :521), CUDA source ``csrc/bigru_scan2.cu``; K6
replaces its backward (:716, body ``_bi2_bwd_kernel`` :567), CUDA
source ``csrc/bigru_scan2_bwd.cu``. ``bigru_scan2_plain`` and
``bigru_scan2_bwd_plain`` below are the same functions in plain
PyTorch.

The reference GRU is bias-free, so h = 0 is a fixed point under zero
input: the backward direction scans the natural-order array from the
zero-padded tail down and holds h = 0 through the padding. Callers
zero-pad and zero-mask (ops/rnn.py).
"""

from __future__ import annotations

import ctypes

import torch

from .. import cells
from . import build

KERNEL = build.Kernel(
    "bigru_scan2", "bigru_scan2.cu", "bigru_scan2_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
KERNEL_BWD = build.Kernel(
    "bigru_scan2_bwd", "bigru_scan2_bwd.cu", "bigru_scan2_bwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
MAX_H = 1024  # csrc/bigru_scan2.cu and csrc/bigru_scan2_bwd.cu refuse wider states


def bigru_scan2_plain(xf, xb, wzr2, wh2):
    """Plain PyTorch twin: a Python loop over time, both directions."""
    b, l, _ = xf.shape
    h = wh2.shape[2]
    pf = {"w_zr": wzr2[0], "w_h": wh2[0]}
    pb = {"w_zr": wzr2[1], "w_h": wh2[1]}
    hf = xf.new_zeros((b, h))
    hb = xf.new_zeros((b, h))
    ysf = xf.new_empty((b, l, h))
    ysb = xf.new_empty((b, l, h))
    for s in range(l):
        t = l - 1 - s
        hf = cells.gru_step_preproj(pf, xf[:, s], hf)
        hb = cells.gru_step_preproj(pb, xb[:, t], hb)
        ysf[:, s] = hf
        ysb[:, t] = hb
    return ysf, ysb


def _hidden(xf) -> int:
    h3 = xf.shape[2]
    h = h3 // 3
    if h3 != 3 * h or not 1 <= h <= MAX_H:
        raise ValueError(f"bigru_scan2: hidden size {h3 / 3} not in [1, {MAX_H}]")
    return h


def bigru_scan2(xf, xb, wzr2, wh2):
    """xf/xb: (B, L, 3H) natural-order input projections of the forward
    and backward directions (zero-padded tails); wzr2 (2, H, 2H) and
    wh2 (2, H, H) the recurrent halves of the kernels. Returns (ysf,
    ysb), each (B, L, H) in natural time order; zero initial states.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if build.on_cpu(xf, xb, wzr2, wh2):
        return bigru_scan2_plain(xf, xb, wzr2, wh2)
    b, l, _ = xf.shape
    h = _hidden(xf)
    dev = xf.device
    build.check("xf", xf, (b, l, 3 * h), dev)
    build.check("xb", xb, (b, l, 3 * h), dev)
    build.check("wzr2", wzr2, (2, h, 2 * h), dev)
    build.check("wh2", wh2, (2, h, h), dev)
    ysf = torch.empty((b, l, h), device=dev, dtype=torch.float32)
    ysb = torch.empty_like(ysf)
    if b * l == 0:
        return ysf, ysb
    KERNEL.launch(
        build.ptr(xf), build.ptr(xb), build.ptr(wzr2), build.ptr(wh2),
        build.ptr(ysf), build.ptr(ysb), b, l, h, build.stream_of(xf),
    )
    return ysf, ysb


def bigru_scan2_bwd_plain(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb):
    """Plain PyTorch twin of K6: per direction, a reverse-time loop that
    recomputes the gates from the saved outputs, as ``_bi2_bwd_kernel``
    does. Direction 0 ran forward in time, so its backward walks t =
    L-1..0 with h_prev = ysf[t-1]; direction 1 ran backward, so its
    backward walks t = 0..L-1 with h_prev = ysb[t+1]; h_prev is 0 where
    that index leaves [0, L)."""
    b, l, _ = xf.shape
    h = wh2.shape[2]
    zero = xf.new_zeros((b, h))
    dxs = [torch.empty_like(xf), torch.empty_like(xb)]
    dwzr2 = torch.zeros_like(wzr2)
    dwh2 = torch.zeros_like(wh2)
    for d, (x, ys, dys) in enumerate(((xf, ysf, dysf), (xb, ysb, dysb))):
        prev = -1 if d == 0 else 1  # h_prev sits at t + prev
        carry = zero
        for t in (range(l - 1, -1, -1) if d == 0 else range(l)):
            h_prev = ys[:, t + prev] if 0 <= t + prev < l else zero
            zr = torch.sigmoid(h_prev @ wzr2[d] + x[:, t, : 2 * h])
            z, r = zr[:, :h], zr[:, h:]
            rh = r * h_prev
            c = torch.tanh(rh @ wh2[d] + x[:, t, 2 * h:])
            dh = dys[:, t] + carry
            dz = dh * (c - h_prev)
            da_c = dh * z * (1.0 - c * c)
            drh = da_c @ wh2[d].T
            dr = drh * h_prev
            da_zr = torch.cat([dz * z * (1.0 - z), dr * r * (1.0 - r)], dim=-1)
            carry = drh * r + da_zr @ wzr2[d].T + dh * (1.0 - z)
            dxs[d][:, t, : 2 * h] = da_zr
            dxs[d][:, t, 2 * h:] = da_c
            dwzr2[d] += h_prev.T @ da_zr
            dwh2[d] += rh.T @ da_c
    return dxs[0], dxs[1], dwzr2, dwh2


def bigru_scan2_bwd(xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb):
    """Cotangents of bigru_scan2's inputs given its inputs, its outputs
    (ysf, ysb) and their cotangents: (dxf, dxb, dwzr2, dwh2).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    args = (xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb)
    if build.on_cpu(*args):
        return bigru_scan2_bwd_plain(*args)
    b, l, _ = xf.shape
    h = _hidden(xf)
    dev = xf.device
    shapes = [(b, l, 3 * h)] * 2 + [(2, h, 2 * h), (2, h, h)] + [(b, l, h)] * 4
    for name, t, shape in zip(("xf", "xb", "wzr2", "wh2", "ysf", "ysb", "dysf", "dysb"),
                              args, shapes):
        build.check(name, t, shape, dev)
    dxf = torch.empty((b, l, 3 * h), device=dev, dtype=torch.float32)
    dxb = torch.empty_like(dxf)
    dwzr2 = torch.empty((2, h, 2 * h), device=dev, dtype=torch.float32)
    dwh2 = torch.empty((2, h, h), device=dev, dtype=torch.float32)
    rh = torch.empty((2, b, l, h), device=dev, dtype=torch.float32)  # r * h_prev, per step
    if b * l == 0:
        return dxf, dxb, dwzr2.zero_(), dwh2.zero_()
    KERNEL_BWD.launch(
        *[build.ptr(t) for t in args],
        build.ptr(dxf), build.ptr(dxb), build.ptr(dwzr2), build.ptr(dwh2), build.ptr(rh),
        b, l, h, build.stream_of(xf),
    )
    return dxf, dxb, dwzr2, dwh2


class BiGRUScan2(torch.autograd.Function):
    """bigru_scan2 with its gradient: K1 forward, K6 backward (the plain
    versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, xf, xb, wzr2, wh2):
        ysf, ysb = bigru_scan2(xf, xb, wzr2, wh2)
        ctx.save_for_backward(xf, xb, wzr2, wh2, ysf, ysb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dysf, dysb):
        return bigru_scan2_bwd(*ctx.saved_tensors, dysf.contiguous(), dysb.contiguous())
