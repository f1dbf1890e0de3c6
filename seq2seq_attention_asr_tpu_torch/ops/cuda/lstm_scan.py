"""Bidirectional LSTM scan: forward (kernel K7) and backward (kernel
K9), joined by the autograd function ``BiLSTMScan``.

K7 replaces the forward of the Pallas kernel ``bilstm_scan``
(seq2seq_attention_asr_tpu/ops/pallas/lstm_scan.py:178, ``_run_fwd``
:103, ``pallas_call`` :107, body ``_fwd_kernel`` :36), CUDA source
``csrc/bilstm_scan.cu``; K9 replaces its backward (``_run_bwd`` :139,
``pallas_call`` :145, body ``_bwd_kernel`` :58), CUDA source
``csrc/bilstm_scan_bwd.cu``. ``bilstm_scan_plain`` and
``bilstm_scan_bwd_plain`` below are the same functions in plain
PyTorch.

Both directions run in one launch over the direction-stacked input
projections; direction 1 arrives already flipped into its scan order
(ops/rnn.py::bilstm_layer does the flips). The forward writes the
cell-state sequence beside the hidden states, as ``_run_fwd`` does, so
that the backward forms the gates from the saved states. K7 walks the
steps on thread-block clusters (plan cell "lstm_fwd"); K9 runs a gate
pre-pass over every step, then a walk on thread-block clusters (cell
"lstm"). Each wrapper computes its walk's plan (``walk.plan_on``) and
passes it; where no cluster fits the device, it raises.

K7 has a bf16 entry (``KERNEL_BF16``, the same walk with a bf16 IO type
for xproj2 and wh2): the JAX kernel with bf16 inputs (``_fwd_kernel``
with bf16 xproj and w_h, float32 h0 and c0, ops/rnn.py:235 of the JAX
package) carries h and c in float32 and stores both outputs in float32
(:119-126), so ``jnp.dot(h, w_h)`` multiplies the unrounded float32 h by
the widened bf16 weights: it rounds nothing. ``bilstm_layer`` then casts
the outputs to the input's type (ops/rnn.py:243-247 of the JAX
package). The entry widens xproj2 and wh2 as it loads them and runs the
float32 walk's plan; its plain twin, and the plain version at the JAX
kernel's rounding points, is ``bilstm_scan_plain`` on the widened
inputs.

K9 has a bf16 entry too (``KERNEL_BWD_BF16``, the same pre-pass and walk
with a bf16 IO type for xproj2 and wh2). The JAX kernel with bf16 inputs
(``_bwd_kernel`` with bf16 xproj and w_h, :58-100) rounds nothing either:
its h_prev and c_prev are the forward's float32 states, ``jnp.dot(h_prev,
w_h)`` and ``jnp.dot(da, w_h.T)`` multiply float32 values by the widened
weights, and its outputs dxproj and dwh are float32 (:161-166). The
entry widens xproj2 and wh2 as it loads them, runs the float32 walk's
plan and writes float32 dxproj2 and dwh2; its plain twin, and the plain
version at the JAX kernel's rounding points, is ``bilstm_scan_bwd_plain``
on the widened inputs. ``BiLSTMScan.backward`` returns those float32
cotangents for the bf16 primals and leaves the cast to autograd, which
rounds each once to bf16 where it hands it on. For dxproj2 that is
where JAX rounds it too: the input projection's transposed product
rounds its float32 cotangent to bf16 before it multiplies. JAX keeps the
unrounded float32 dwh2 for the master's gradient, where the port rounds
it once (ROADMAP, "Differences that are deliberate").
"""

from __future__ import annotations

import ctypes

import torch

from . import build, walk

KERNEL = build.Kernel(
    "bilstm_scan", "bilstm_scan.cu", "bilstm_scan_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BWD = build.Kernel(
    "bilstm_scan_bwd", "bilstm_scan_bwd.cu", "bilstm_scan_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BF16 = build.Kernel(
    "bilstm_scan_bf16", "bilstm_scan.cu", "bilstm_scan_fwd_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BWD_BF16 = build.Kernel(
    "bilstm_scan_bwd_bf16", "bilstm_scan_bwd.cu", "bilstm_scan_bwd_bf16",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
MAX_H = 1024  # csrc/bilstm_scan.cu and csrc/bilstm_scan_bwd.cu refuse wider states


def bilstm_scan_plain(xproj2, h02, c02, wh2):
    """Plain PyTorch twin: a Python loop over time of the gate math of
    cells.lstm_step_preproj, both directions stacked. bf16 xproj2 and
    wh2 (K7's bf16 entry) are widened first; the states and the outputs
    are float32 either way."""
    xproj2, wh2 = build.widen(xproj2), build.widen(wh2)
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


def _hidden(xproj2) -> int:
    h4 = xproj2.shape[3]
    h = h4 // 4
    if h4 != 4 * h or not 1 <= h <= MAX_H:
        raise ValueError(f"bilstm_scan: hidden size {h4 / 4} not in [1, {MAX_H}]")
    return h


def bilstm_scan(xproj2, h02, c02, wh2):
    """xproj2 (2, B, L, 4H): ``x @ w_x + b`` per direction, direction 1
    in its scan order; h02, c02 (2, B, H) initial states; wh2 (2, H, 4H)
    recurrent weights. Returns (hidden states, cell states), each
    (2, B, L, H) float32, direction 1 in scan order. No peepholes.
    xproj2 and wh2 float32, or both bfloat16 (the bf16 entry); h02 and
    c02 float32 either way, as the JAX package passes them.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if build.on_cpu(xproj2, h02, c02, wh2):
        return bilstm_scan_plain(xproj2, h02, c02, wh2)
    _, b, l, _ = xproj2.shape
    h = _hidden(xproj2)
    dev, dt = xproj2.device, build.io_dtype(xproj2)
    kernel = KERNEL_BF16 if dt == torch.bfloat16 else KERNEL
    for name, t, shape, t_dt in (("xproj2", xproj2, (2, b, l, 4 * h), dt),
                                 ("h02", h02, (2, b, h), torch.float32),
                                 ("c02", c02, (2, b, h), torch.float32),
                                 ("wh2", wh2, (2, h, 4 * h), dt)):
        build.check(name, t, shape, dev, t_dt)
    hs = torch.empty((2, b, l, h), device=dev, dtype=torch.float32)
    cs = torch.empty_like(hs)
    if b * l == 0:
        return hs, cs
    # The bf16 entry's walk keeps its slices in float: the float walk's plan.
    plan = walk.plan_on(KERNEL, b, h, "lstm_fwd", 2, dev)
    kernel.launch(
        build.ptr(xproj2), build.ptr(h02), build.ptr(c02), build.ptr(wh2),
        build.ptr(hs), build.ptr(cs), b, l, h, *plan.args(), build.stream_of(xproj2),
    )
    return hs, cs


def bilstm_scan_bwd_plain(xproj2, h_prev2, c_prev2, dys2, wh2):
    """Plain PyTorch twin of K9: a reverse-time loop of the gate math of
    ``_bwd_kernel``, both directions stacked, that recomputes each step
    from the previous states; then dW_h = sum h_prev^T da over (b, t),
    as the kernel's reduction forms it. bf16 xproj2 and wh2 (K9's bf16
    entry) are widened first; the other inputs and every output are
    float32 either way."""
    xproj2, wh2 = build.widen(xproj2), build.widen(wh2)
    _, b, l, h4 = xproj2.shape
    h_dim = h4 // 4
    dh = xproj2.new_zeros((2, b, h_dim))
    dc = xproj2.new_zeros((2, b, h_dim))
    dxproj2 = torch.empty_like(xproj2)
    wh_t = wh2.transpose(1, 2)
    for t in range(l - 1, -1, -1):
        c_prev = c_prev2[:, :, t]
        gates = xproj2[:, :, t] + torch.bmm(h_prev2[:, :, t], wh2)
        g_in, g_forget, g_cell, g_out = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(g_in), torch.sigmoid(g_forget), torch.sigmoid(g_out)
        g = torch.tanh(g_cell)
        tc = torch.tanh(f * c_prev + i * g)
        dh = dys2[:, :, t] + dh
        dc = dc + dh * o * (1.0 - tc * tc)
        da = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        dxproj2[:, :, t] = da
        dh = torch.bmm(da, wh_t)
        dc = dc * f
    dwh2 = torch.bmm(h_prev2.reshape(2, b * l, h_dim).transpose(1, 2),
                     dxproj2.reshape(2, b * l, h4))
    return dxproj2, dh, dc, dwh2


def bilstm_scan_bwd(xproj2, h_prev2, c_prev2, dys2, wh2):
    """Cotangents of bilstm_scan's inputs given its input projections,
    the hidden and cell states before each step (h_prev2[:, :, t] is the
    state step t starts from: h02 at t = 0), the cotangent of the hidden
    states and the recurrent weights: (dxproj2, dh02, dc02, dwh2), all
    float32. xproj2 and wh2 float32, or both bfloat16 (the bf16 entry);
    the other inputs float32 either way.

    CPU tensors take the plain version; CUDA tensors the kernel (float32
    or bf16 entry, by the inputs' type)."""
    args = (xproj2, h_prev2, c_prev2, dys2, wh2)
    if build.on_cpu(*args):
        return bilstm_scan_bwd_plain(*args)
    _, b, l, _ = xproj2.shape
    h = _hidden(xproj2)
    dev, dt = xproj2.device, build.io_dtype(xproj2)
    kernel = KERNEL_BWD_BF16 if dt == torch.bfloat16 else KERNEL_BWD
    shapes = [(2, b, l, 4 * h)] + [(2, b, l, h)] * 3 + [(2, h, 4 * h)]
    for name, t, shape, t_dt in zip(("xproj2", "h_prev2", "c_prev2", "dys2", "wh2"), args,
                                    shapes, (dt,) + (torch.float32,) * 3 + (dt,)):
        build.check(name, t, shape, dev, t_dt)
    dxproj2 = torch.empty((2, b, l, 4 * h), device=dev, dtype=torch.float32)
    dh02 = torch.empty((2, b, h), device=dev, dtype=torch.float32)
    dc02 = torch.empty_like(dh02)
    dwh2 = torch.empty((2, h, 4 * h), device=dev, dtype=torch.float32)
    if b * l == 0:
        return dxproj2, dh02.zero_(), dc02.zero_(), dwh2.zero_()
    tc2 = torch.empty((2, b, l, h), device=dev, dtype=torch.float32)  # tanh(c) per step
    plan = walk.plan_on(kernel, b, h, "lstm", 2, dev)
    kernel.launch(
        *[build.ptr(t) for t in (*args, dxproj2, dh02, dc02, dwh2, tc2)], b, l, h, *plan.args(),
        build.stream_of(xproj2),
    )
    return dxproj2, dh02, dc02, dwh2


class BiLSTMScan(torch.autograd.Function):
    """bilstm_scan with its gradient: K7 forward, K9 backward (the plain
    versions on CPU tensors), each in float32 or through its bf16 entry.
    Returns the hidden states; saves them with the cell states, and the
    backward shifts both by one step with the initial state in front, as
    the JAX VJP does (``_vjp_bwd`` :194). On bf16 primals the backward
    returns float32 dxproj2 and dwh2, as the JAX kernel gives them, and
    autograd rounds each to bf16 as it hands it on."""

    @staticmethod
    def forward(ctx, xproj2, h02, c02, wh2):
        hs, cs = bilstm_scan(xproj2, h02, c02, wh2)
        ctx.save_for_backward(xproj2, h02, c02, wh2, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xproj2, h02, c02, wh2, hs, cs = ctx.saved_tensors
        h_prev2 = torch.cat([h02[:, :, None], hs[:, :, :-1]], dim=2)
        c_prev2 = torch.cat([c02[:, :, None], cs[:, :, :-1]], dim=2)
        return bilstm_scan_bwd(xproj2, h_prev2, c_prev2, dhs.contiguous(), wh2)
