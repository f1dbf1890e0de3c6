"""Bias-free GRU scans on the card and their plain PyTorch versions.

- The flip-free bidirectional scan, forward (kernel K1) and backward
  (kernel K6), joined by the autograd function ``BiGRUScan2``. K1
  replaces the Pallas kernel ``bigru_scan2`` forward
  (seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666, body
  ``_bi2_fwd_kernel`` :521), CUDA source ``csrc/bigru_scan2.cu``; K6
  replaces its backward (:716, body ``_bi2_bwd_kernel`` :567), CUDA
  source ``csrc/bigru_scan2_bwd.cu``. The reference GRU is bias-free, so
  h = 0 is a fixed point under zero input: the backward direction scans
  the natural-order array from the zero-padded tail down and holds h = 0
  through the padding. Callers zero-pad and zero-mask (ops/rnn.py).
- One direction from a given initial state, forward (kernel K16) and
  backward (kernel K17), joined by ``GRUScan``: the Pallas kernel
  ``gru_scan`` (:147, body ``_fwd_kernel`` :38; backward :177, body
  ``_bwd_kernel`` :71), behind ``ops/rnn.py::gru_layer``.
- The direction-stacked BiGRU, forward (kernel K18) and backward (kernel
  K19), joined by ``BiGRUScan``: the Pallas kernel ``bigru_scan`` (:407,
  body ``_bi_fwd_kernel`` :257; backward :445, body ``_bi_bwd_kernel``
  :308). Direction 1 arrives flipped into its scan order, so every
  direction walks t = 0..L-1 from its own initial state; K16/K17 are the
  same kernels with one direction. CUDA sources ``csrc/gru_scan.cu`` and
  ``csrc/gru_scan_bwd.cu``.

K1 has a bf16 entry too (``KERNEL_BF16``, the same walk with a bf16 IO
type): the JAX kernel with bf16 inputs (``dt`` = bf16 in
``_bi2_fwd_kernel``) rounds the products' operands h and r * h to bf16,
accumulates in float32, carries h in float32 and rounds each output at
its store. K6 has none yet: ``BiGRUScan2`` refuses the gradient of a
bf16 scan.

Every kernel's plain version (``*_plain``) sits beside its wrapper; all
the kernels share the walks of ``csrc/gru_walk.cuh``, which run on
thread-block clusters whose plan (``walk.plan``: cell "gru_fwd" for the
forwards, "gru" for the backwards) the wrappers compute and pass. The
backward ones (K6, K17, K19) run a gate pre-pass before their walk.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cells
from . import build, walk

KERNEL = build.Kernel(
    "bigru_scan2", "bigru_scan2.cu", "bigru_scan2_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BWD = build.Kernel(
    "bigru_scan2_bwd", "bigru_scan2_bwd.cu", "bigru_scan2_bwd",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BF16 = build.Kernel(
    "bigru_scan2_bf16", "bigru_scan2.cu", "bigru_scan2_fwd_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNEL_GRU = build.Kernel("gru_scan", "gru_scan.cu", "gru_scan_fwd", _FWD_ARGS)
KERNEL_GRU_BWD = build.Kernel("gru_scan_bwd", "gru_scan_bwd.cu", "gru_scan_bwd", _BWD_ARGS)
KERNEL_BI = build.Kernel("bigru_scan", "gru_scan.cu", "bigru_scan_fwd", _FWD_ARGS)
KERNEL_BI_BWD = build.Kernel("bigru_scan_bwd", "gru_scan_bwd.cu", "bigru_scan_bwd", _BWD_ARGS)
MAX_H = 1024  # every kernel here refuses wider states (csrc/gru_walk.cuh's callers)


def bigru_scan2_plain(xf, xb, wzr2, wh2):
    """Plain PyTorch twin: a Python loop over time, both directions (on
    bfloat16 inputs, bigru_scan2_plain_bf16)."""
    if xf.dtype == torch.bfloat16:
        return bigru_scan2_plain_bf16(xf, xb, wzr2, wh2)
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


def bigru_scan2_plain_bf16(xf, xb, wzr2, wh2):
    """Plain twin of K1's bf16 entry (``_bi2_fwd_kernel`` with bf16
    inputs): the inputs widened to float32, h carried in float32, the
    products' operands h and r * h rounded to bf16 where the products
    read them, and each output rounded to bf16."""
    b, l, _ = xf.shape
    h = wh2.shape[2]
    xs = (xf.float(), xb.float())
    ws = [(wzr2[d].float(), wh2[d].float()) for d in range(2)]
    hs = [xs[0].new_zeros((b, h)) for _ in range(2)]
    ys = [xs[0].new_empty((b, l, h)) for _ in range(2)]
    for s in range(l):
        for d, t in ((0, s), (1, l - 1 - s)):
            x, (wzr, wh) = xs[d][:, t], ws[d]
            zr = torch.sigmoid(build.round_bf16(hs[d]) @ wzr + x[:, : 2 * h])
            z, r = zr[:, :h], zr[:, h:]
            c = torch.tanh(build.round_bf16(r * hs[d]) @ wh + x[:, 2 * h:])
            hs[d] = (1.0 - z) * hs[d] + z * c
            ys[d][:, t] = hs[d]
    return ys[0].to(torch.bfloat16), ys[1].to(torch.bfloat16)


def _hidden(x, name: str) -> int:
    h3 = x.shape[-1]
    h = h3 // 3
    if h3 != 3 * h or not 1 <= h <= MAX_H:
        raise ValueError(f"{name}: hidden size {h3 / 3} not in [1, {MAX_H}]")
    return h


def bigru_scan2(xf, xb, wzr2, wh2):
    """xf/xb: (B, L, 3H) natural-order input projections of the forward
    and backward directions (zero-padded tails); wzr2 (2, H, 2H) and
    wh2 (2, H, H) the recurrent halves of the kernels. Returns (ysf,
    ysb), each (B, L, H) in natural time order; zero initial states.
    All float32, or all bfloat16 (outputs in bf16).

    CPU tensors take the plain version; CUDA tensors the kernel (float32
    or bf16 entry, by the inputs' type)."""
    if build.on_cpu(xf, xb, wzr2, wh2):
        return bigru_scan2_plain(xf, xb, wzr2, wh2)
    dt = build.io_dtype(xf)
    kernel = KERNEL_BF16 if dt == torch.bfloat16 else KERNEL
    b, l, _ = xf.shape
    h = _hidden(xf, kernel.name)
    dev = xf.device
    build.check("xf", xf, (b, l, 3 * h), dev, dt)
    build.check("xb", xb, (b, l, 3 * h), dev, dt)
    build.check("wzr2", wzr2, (2, h, 2 * h), dev, dt)
    build.check("wh2", wh2, (2, h, h), dev, dt)
    ysf = torch.empty((b, l, h), device=dev, dtype=dt)
    ysb = torch.empty_like(ysf)
    if b * l == 0:
        return ysf, ysb
    # The bf16 entry's walk keeps its slices in float: the float walk's plan.
    plan = walk.plan_on(KERNEL, b, h, "gru_fwd", 2, dev)
    kernel.launch(
        build.ptr(xf), build.ptr(xb), build.ptr(wzr2), build.ptr(wh2),
        build.ptr(ysf), build.ptr(ysb), b, l, h, *plan.args(), build.stream_of(xf),
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
    h = _hidden(xf, KERNEL_BWD.name)
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
    plan = walk.plan_on(KERNEL_BWD, b, h, "gru", 2, dev)
    KERNEL_BWD.launch(
        *[build.ptr(t) for t in args],
        build.ptr(dxf), build.ptr(dxb), build.ptr(dwzr2), build.ptr(dwh2), build.ptr(rh),
        b, l, h, *plan.args(), build.stream_of(xf),
    )
    return dxf, dxb, dwzr2, dwh2


class BiGRUScan2(torch.autograd.Function):
    """bigru_scan2 with its gradient: K1 forward, K6 backward (the plain
    versions on CPU tensors). The gradient of a bf16 scan is refused:
    K6 has no bf16 instance yet."""

    @staticmethod
    def forward(ctx, xf, xb, wzr2, wh2):
        ysf, ysb = bigru_scan2(xf, xb, wzr2, wh2)
        ctx.save_for_backward(xf, xb, wzr2, wh2, ysf, ysb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dysf, dysb):
        if ctx.saved_tensors[0].dtype == torch.bfloat16:
            raise NotImplementedError(build.BF16_TRAINING)
        return bigru_scan2_bwd(*ctx.saved_tensors, dysf.contiguous(), dysb.contiguous())


def bigru_scan_plain(xproj2, h02, wzr2, wh2):
    """Plain PyTorch twin of K18 (and, with one direction, of K16): a
    Python loop over time of ``_bi_fwd_kernel``'s step, the directions
    stacked on the leading axis, each from its own initial state."""
    d, b, l, h3 = xproj2.shape
    h = h3 // 3
    hs = h02
    ys = xproj2.new_empty((d, b, l, h))
    for t in range(l):
        x = xproj2[:, :, t]
        zr = torch.sigmoid(torch.bmm(hs, wzr2) + x[..., : 2 * h])
        z, r = zr[..., :h], zr[..., h:]
        c = torch.tanh(torch.bmm(r * hs, wh2) + x[..., 2 * h:])
        hs = (1.0 - z) * hs + z * c
        ys[:, :, t] = hs
    return ys


def gru_scan_plain(xproj, h0, w_zr_h, w_h_h):
    """Plain PyTorch twin of K16: ``_fwd_kernel``'s step in a loop over time."""
    return bigru_scan_plain(xproj[None], h0[None], w_zr_h[None], w_h_h[None])[0]


def bigru_scan_bwd_plain(xproj2, h_prevs2, dys2, wzr2, wh2):
    """Plain PyTorch twin of K19 (and, with one direction, of K17): the
    reverse-time loop of ``_bi_bwd_kernel``, which recomputes each step's
    gates from the state the step started from, h_prevs2[:, :, t], and
    sums the weight gradients step by step. Returns (dxproj2, dh02,
    dwzr2, dwh2); dh02 is the carry after step 0."""
    d, b, l, h3 = xproj2.shape
    h = h3 // 3
    carry = xproj2.new_zeros((d, b, h))
    dxproj2 = torch.empty_like(xproj2)
    dwzr2, dwh2 = torch.zeros_like(wzr2), torch.zeros_like(wh2)
    wzr_t, wh_t = wzr2.transpose(1, 2), wh2.transpose(1, 2)
    for t in range(l - 1, -1, -1):
        h_prev, x = h_prevs2[:, :, t], xproj2[:, :, t]
        zr = torch.sigmoid(torch.bmm(h_prev, wzr2) + x[..., : 2 * h])
        z, r = zr[..., :h], zr[..., h:]
        rh = r * h_prev
        c = torch.tanh(torch.bmm(rh, wh2) + x[..., 2 * h:])
        dh = dys2[:, :, t] + carry
        da_c = dh * z * (1.0 - c * c)
        drh = torch.bmm(da_c, wh_t)
        da_zr = torch.cat([dh * (c - h_prev) * z * (1.0 - z), drh * h_prev * r * (1.0 - r)],
                          dim=-1)
        carry = drh * r + torch.bmm(da_zr, wzr_t) + dh * (1.0 - z)
        dxproj2[:, :, t, : 2 * h] = da_zr
        dxproj2[:, :, t, 2 * h:] = da_c
        dwzr2 += torch.bmm(h_prev.transpose(1, 2), da_zr)
        dwh2 += torch.bmm(rh.transpose(1, 2), da_c)
    return dxproj2, carry, dwzr2, dwh2


def gru_scan_bwd_plain(xproj, h_prevs, dys, w_zr_h, w_h_h):
    """Plain PyTorch twin of K17: ``_bwd_kernel``'s reverse-time loop."""
    return tuple(g[0] for g in bigru_scan_bwd_plain(xproj[None], h_prevs[None], dys[None],
                                                    w_zr_h[None], w_h_h[None]))


def _sizes(kernel, lead, xproj):
    """(B, L, H) of the inputs of a scan whose arrays carry the leading
    axes `lead`: () for K16/K17, (2,) for K18/K19."""
    if xproj.dim() != len(lead) + 3:
        raise ValueError(f"{kernel.name}: xproj has {xproj.dim()} axes, expected {len(lead) + 3}")
    b, l = xproj.shape[len(lead):len(lead) + 2]
    return b, l, _hidden(xproj, kernel.name)


def _scan_fwd(kernel, lead, xproj, h0, w_zr, w_h):
    """Check the inputs of K16 or K18 and launch it."""
    b, l, h = _sizes(kernel, lead, xproj)
    dev = xproj.device
    for name, t, shape in (("xproj", xproj, (b, l, 3 * h)), ("h0", h0, (b, h)),
                           ("w_zr", w_zr, (h, 2 * h)), ("w_h", w_h, (h, h))):
        build.check(name, t, (*lead, *shape), dev)
    ys = torch.empty((*lead, b, l, h), device=dev, dtype=torch.float32)
    if b * l:
        plan = walk.plan_on(kernel, b, h, "gru_fwd", lead[0] if lead else 1, dev)
        kernel.launch(build.ptr(xproj), build.ptr(h0), build.ptr(w_zr), build.ptr(w_h),
                      build.ptr(ys), b, l, h, *plan.args(), build.stream_of(xproj))
    return ys


def _scan_bwd(kernel, lead, xproj, h_prevs, dys, w_zr, w_h):
    """Check the inputs of K17 or K19 and launch it."""
    b, l, h = _sizes(kernel, lead, xproj)
    dev = xproj.device
    for name, t, shape in (("xproj", xproj, (b, l, 3 * h)), ("h_prevs", h_prevs, (b, l, h)),
                           ("dys", dys, (b, l, h)), ("w_zr", w_zr, (h, 2 * h)),
                           ("w_h", w_h, (h, h))):
        build.check(name, t, (*lead, *shape), dev)
    new = lambda *shape: torch.empty((*lead, *shape), device=dev, dtype=torch.float32)
    dxproj, dh0, dwzr, dwh = new(b, l, 3 * h), new(b, h), new(h, 2 * h), new(h, h)
    if b * l == 0:
        return dxproj, dh0.zero_(), dwzr.zero_(), dwh.zero_()
    rh = new(b, l, h)  # r * h_prev per step, for the reduction of dWh
    plan = walk.plan_on(kernel, b, h, "gru", lead[0] if lead else 1, dev)
    kernel.launch(*[build.ptr(t) for t in (xproj, h_prevs, dys, w_zr, w_h, dxproj, dh0, dwzr,
                                           dwh, rh)], b, l, h, *plan.args(),
                  build.stream_of(xproj))
    return dxproj, dh0, dwzr, dwh


def gru_scan(xproj, h0, w_zr_h, w_h_h):
    """One GRU direction over time: xproj (B, L, 3H) the input
    projections (cells.gru_input_proj), h0 (B, H), the recurrent halves
    w_zr_h (H, 2H) and w_h_h (H, H). Returns every state (B, L, H).

    CPU tensors take the plain version; CUDA tensors kernel K16."""
    if build.on_cpu(xproj, h0, w_zr_h, w_h_h):
        return gru_scan_plain(xproj, h0, w_zr_h, w_h_h)
    return _scan_fwd(KERNEL_GRU, (), xproj, h0, w_zr_h, w_h_h)


def gru_scan_bwd(xproj, h_prevs, dys, w_zr_h, w_h_h):
    """Cotangents of gru_scan's inputs given its input projections, the
    state each step started from (h_prevs[:, t]: h0 at t = 0, then the
    outputs), the outputs' cotangent and the recurrent weights:
    (dxproj, dh0, dw_zr_h, dw_h_h).

    CPU tensors take the plain version; CUDA tensors kernel K17."""
    args = (xproj, h_prevs, dys, w_zr_h, w_h_h)
    if build.on_cpu(*args):
        return gru_scan_bwd_plain(*args)
    return _scan_bwd(KERNEL_GRU_BWD, (), *args)


def bigru_scan(xproj2, h02, wzr2, wh2):
    """Both GRU directions over time, stacked: xproj2 (2, B, L, 3H) with
    direction 1 already flipped into its scan order, h02 (2, B, H), wzr2
    (2, H, 2H), wh2 (2, H, H). Returns every state (2, B, L, H),
    direction 1 in scan order (the caller flips it back).

    CPU tensors take the plain version; CUDA tensors kernel K18."""
    if build.on_cpu(xproj2, h02, wzr2, wh2):
        return bigru_scan_plain(xproj2, h02, wzr2, wh2)
    return _scan_fwd(KERNEL_BI, (2,), xproj2, h02, wzr2, wh2)


def bigru_scan_bwd(xproj2, h_prevs2, dys2, wzr2, wh2):
    """bigru_scan's cotangents, as gru_scan_bwd's with the directions
    stacked: (dxproj2, dh02, dwzr2, dwh2).

    CPU tensors take the plain version; CUDA tensors kernel K19."""
    args = (xproj2, h_prevs2, dys2, wzr2, wh2)
    if build.on_cpu(*args):
        return bigru_scan_bwd_plain(*args)
    return _scan_bwd(KERNEL_BI_BWD, (2,), *args)


class GRUScan(torch.autograd.Function):
    """gru_scan with its gradient: K16 forward, K17 backward (the plain
    versions on CPU tensors). The backward puts h0 in front of the
    outputs for the state each step started from, as the JAX VJP does
    (``_vjp_bwd`` :223)."""

    @staticmethod
    def forward(ctx, xproj, h0, w_zr_h, w_h_h):
        ys = gru_scan(xproj, h0, w_zr_h, w_h_h)
        ctx.save_for_backward(xproj, h0, w_zr_h, w_h_h, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xproj, h0, w_zr_h, w_h_h, ys = ctx.saved_tensors
        h_prevs = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
        return gru_scan_bwd(xproj, h_prevs, dys.contiguous(), w_zr_h, w_h_h)


class BiGRUScan(torch.autograd.Function):
    """bigru_scan with its gradient: K18 forward, K19 backward (the plain
    versions on CPU tensors), the states shifted as ``_bi_vjp_bwd`` (:498)
    shifts them."""

    @staticmethod
    def forward(ctx, xproj2, h02, wzr2, wh2):
        ys = bigru_scan(xproj2, h02, wzr2, wh2)
        ctx.save_for_backward(xproj2, h02, wzr2, wh2, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xproj2, h02, wzr2, wh2, ys = ctx.saved_tensors
        h_prevs = torch.cat([h02[:, :, None], ys[:, :, :-1]], dim=2)
        return bigru_scan_bwd(xproj2, h_prevs, dys.contiguous(), wzr2, wh2)
