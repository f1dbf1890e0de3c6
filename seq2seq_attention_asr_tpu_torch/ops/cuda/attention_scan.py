"""Teacher-forced attention-decoder scans, each a forward kernel and a
backward kernel joined by an autograd function: the content-only GRU
decoder's (K4 and K5, ``AttentionDecodeScan``), and at the end of this
module the location-aware LSTM decoder's (K10 and K11,
``AttentionDecodeScanLocLSTM``), the location-aware GRU decoder's (K12
and K13, ``AttentionDecodeScanLoc``) and the content-only LSTM decoder's
(K14 and K15, ``AttentionDecodeScanLSTM``).

Replaces the Pallas kernel ``attention_decode_scan`` for the content-only
GRU decoder (seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:1156):
its forward (pallas_call :355 in ``_run_fwd`` :290, body ``_fwd_kernel``
:165 with ``_step_core`` :91) and its backward (pallas_call :851 in
``_run_bwd`` :800, body ``_bwd_kernel`` :376 / ``_bwd_core`` :419). Both
are the <GRU, content> instances of the decoder scans' walks in
``csrc/attention_scan_loc_lstm.cu``: the forward the pre-pass and
forward cluster walk, on ``fwd_plan_on``'s plan as K10's, K12's and
K14's; the backward the pre-pass, cluster walk and reduction, on
``scan_plan_on``'s plan as K11's and K15's. ``attention_decode_scan_plain`` and
``attention_decode_scan_bwd_plain`` below are the same functions in
plain PyTorch; the latter follows ``_run_bwd_xla`` (:1047) step by step,
except that it takes each step's alpha from the saved alpha sequence.

One step, from the zero state s_0 = 0:

  e     = w_e . tanh(vh + s_prev @ ws_w + ws_b)     (B, L)
  alpha = masked softmax of e                        (B, L)
  c     = alpha^T h                                  (B, A)
  r     = concat(c @ c_w + c_b, yin_t) @ dec_w + dec_b
  s     = GRU(r, s_prev), bias-free, r gate before the candidate product

Weights are the port's parameter leaves: biases and w_e are 1-D.

K4 has a bf16 entry (``KERNEL_FWD_BF16``): every input bfloat16, the
outputs bfloat16 (``_run_fwd`` gives them vh's type). The JAX kernel
with bf16 inputs (``_step_core`` with ``dt`` = bf16) keeps the energies,
the softmax, c and the s carry in float32 and rounds each product's
operand to bf16: s_prev before ws, c before c_in, [cc | yin] before
dec_in, [s_prev | r] before the gates and [rg s_prev | r] before the
candidate. The plain versions round there too (``rnd``). The bf16
entry's pre-pass folds c_in and dec_in into the gates as the float32
one does, its tables in float32 from the widened weights, so it rounds
s_prev, c and rg s_prev and not cc or r, which it never forms
(ROADMAP, "Differences that are deliberate"); ``gru_folded_scan_plain``
is its plain twin as it computes. K5, and the other
decoders' scans, have no bf16 instance yet: they refuse bf16.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from ..masking import masked_softmax
from . import build

# K4 and K12, the GRU's forwards, are built from the decoder scans' source
# into a library of their own (the forward walk's GRU instances), and K5
# into another, beside K10's and K14's and the rest's.
KERNEL_FWD = build.Kernel(
    "attention_decode_scan_fwd", "attention_scan_loc_lstm.cu", "attention_decode_scan_fwd",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    defines=("GRU_FWD_ONLY",),
)
KERNEL_BWD = build.Kernel(
    "attention_decode_scan_bwd", "attention_scan_loc_lstm.cu", "attention_decode_scan_bwd",
    [ctypes.c_void_p] * 32 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    defines=("CONTENT_GRU_BWD_ONLY",),
)
KERNEL_FWD_BF16 = build.Kernel(
    "attention_decode_scan_fwd_bf16", "attention_scan_loc_lstm.cu",
    "attention_decode_scan_fwd_bf16",
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    defines=("GRU_FWD_ONLY",),
)
WEIGHTS = ("ws_w", "ws_b", "w_e", "c_w", "c_b", "dec_w", "dec_b", "gru_wzr", "gru_wh")


def _same(x):
    return x


def _step_core(vh, h, enc_mask, yin_t, s_prev, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b,
               gru_wzr, gru_wh, rnd=_same):
    """One decoder step (_step_core for the GRU cell): (alpha, c, s_new).
    `rnd` rounds each product's operand where the JAX kernel rounds it to
    its IO type (build.round_bf16 for bf16, on float32 tensors; the
    identity for float32)."""
    st = dec_w.shape[1]
    ws = rnd(s_prev) @ ws_w + ws_b
    e = torch.tanh(vh + ws[:, None, :]) @ w_e
    alpha = masked_softmax(e, enc_mask)
    c = torch.einsum("bl,bla->ba", alpha, h)
    r = rnd(torch.cat([rnd(c) @ c_w + c_b, yin_t], dim=-1)) @ dec_w + dec_b
    zr = torch.sigmoid(rnd(torch.cat([s_prev, r], dim=-1)) @ gru_wzr)
    zg, rg = zr[:, :st], zr[:, st:]
    cand = torch.tanh(rnd(torch.cat([rg * s_prev, r], dim=-1)) @ gru_wh)
    return alpha, c, (1.0 - zg) * s_prev + zg * cand


def attention_decode_scan_plain(vh, h, enc_mask, yin, *weights):
    """Plain PyTorch twin of K4: _step_core looped over the T steps. On
    bfloat16 inputs the twin of its bf16 entry: the inputs widened to
    float32, s carried in float32, the products' operands rounded as the
    JAX kernel rounds them, the outputs rounded to bf16."""
    dt, rnd = vh.dtype, _same
    if dt == torch.bfloat16:
        vh, h, enc_mask, yin, *weights = (t.float() for t in (vh, h, enc_mask, yin, *weights))
        rnd = build.round_bf16
    b, t_len, st = yin.shape
    s = yin.new_zeros((b, st))
    s_seq, c_seq, alpha_seq = [], [], []
    for t in range(t_len):
        alpha, c, s = _step_core(vh, h, enc_mask, yin[:, t], s, *weights, rnd=rnd)
        s_seq.append(s)
        c_seq.append(c)
        alpha_seq.append(alpha)
    return tuple(torch.stack(x, dim=1).to(dt) for x in (s_seq, c_seq, alpha_seq))


def attention_decode_scan_bwd_plain(vh, h, enc_mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w,
                                    dec_b, gru_wzr, gru_wh, s_seq, c_seq, alpha_seq, ds_seq,
                                    dc_seq, dalpha_seq):
    """Plain PyTorch twin of K5, step for step ``_run_bwd_xla``: a
    reverse-time loop that recomputes each step from the saved s (shifted
    by one, zero at step 0) and c sequences, and takes the step's alpha
    from the saved alpha sequence (``_run_bwd_xla`` recomputes it through
    the softmax, which gives the forward's alpha too). Returns (dvh, dh,
    dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dgru_wzr,
    dgru_wh)."""
    b, t_len, st = yin.shape
    ds_carry = yin.new_zeros((b, st))
    dvh, dh = torch.zeros_like(vh), torch.zeros_like(h)
    dyin = torch.empty_like(yin)
    dw = [torch.zeros_like(w) for w in (ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh)]
    for t in range(t_len - 1, -1, -1):
        s_prev = s_seq[:, t - 1] if t > 0 else ds_carry.new_zeros((b, st))
        c_saved = c_seq[:, t]
        ws = s_prev @ ws_w + ws_b
        a = torch.tanh(vh + ws[:, None, :])
        alpha = alpha_seq[:, t]
        cc = c_saved @ c_w + c_b
        rr = torch.cat([cc, yin[:, t]], dim=-1)
        r = rr @ dec_w + dec_b
        sr = torch.cat([s_prev, r], dim=-1)
        zr = torch.sigmoid(sr @ gru_wzr)
        zg, rg = zr[:, :st], zr[:, st:]
        cand_in = torch.cat([rg * s_prev, r], dim=-1)
        cand = torch.tanh(cand_in @ gru_wh)

        ds = ds_seq[:, t] + ds_carry
        dzg = ds * (cand - s_prev)
        da_cand = ds * zg * (1.0 - cand * cand)
        dcand_in = da_cand @ gru_wh.T
        drgs, dr = dcand_in[:, :st], dcand_in[:, st:]
        da_zr = torch.cat([dzg * zg * (1.0 - zg), drgs * s_prev * rg * (1.0 - rg)], dim=-1)
        dsr = da_zr @ gru_wzr.T
        ds_prev = dsr[:, :st] + drgs * rg + ds * (1.0 - zg)
        dr = dr + dsr[:, st:]

        drr = dr @ dec_w.T
        dcc = drr[:, :st]
        dyin[:, t] = drr[:, st:]
        dc = dcc @ c_w.T + dc_seq[:, t]

        dalpha = torch.einsum("ba,bla->bl", dc, h) + dalpha_seq[:, t]
        dh += alpha[:, :, None] * dc[:, None, :]
        de = alpha * (dalpha - torch.sum(dalpha * alpha, dim=-1, keepdim=True))
        dz = de[:, :, None] * w_e * (1.0 - a * a)
        dvh += dz
        dws = torch.sum(dz, dim=1)
        ds_carry = ds_prev + dws @ ws_w.T

        for acc, step in zip(dw, (
            s_prev.T @ dws, dws.sum(0), torch.einsum("bls,bl->s", a, de),
            c_saved.T @ dcc, dcc.sum(0), rr.T @ dr, dr.sum(0), sr.T @ da_zr,
            cand_in.T @ da_cand,
        )):
            acc += step
    return (dvh, dh, dyin, *dw)


def attention_decode_scan(vh, h, enc_mask, yin, *weights):
    """vh (B,L,S) projected annotations; h (B,L,A); enc_mask (B,L); yin
    (B,T,St) = y_prev @ y_in.w + y_in.b; weights ws_w (St,S), ws_b (S,),
    w_e (S,), c_w (A,St), c_b (St,), dec_w (2St,St), dec_b (St,),
    gru_wzr (2St,2St), gru_wh (2St,St). Returns (s_seq (B,T,St), c_seq
    (B,T,A), alpha_seq (B,T,L)).

    CPU tensors take the plain version; CUDA tensors the kernel (K4), on
    fwd_plan_on's plan; it raises RuntimeError where no cluster fits the
    device. All float32, or all bfloat16 (the bf16 entry; outputs in
    bf16)."""
    if build.on_cpu(vh, h, enc_mask, yin, *weights):
        return attention_decode_scan_plain(vh, h, enc_mask, yin, *weights)
    kernel = KERNEL_FWD_BF16 if vh.dtype == torch.bfloat16 else KERNEL_FWD
    return _scan(kernel, False, vh, h, enc_mask, yin, weights)


def attention_decode_scan_bwd(vh, h, enc_mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b,
                              gru_wzr, gru_wh, s_seq, c_seq, alpha_seq, ds_seq, dc_seq,
                              dalpha_seq):
    """Cotangents of attention_decode_scan's differentiable inputs given
    its inputs, the saved (s_seq, c_seq, alpha_seq) and their cotangents:
    (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b,
    dgru_wzr, dgru_wh).

    CPU tensors take the plain version; CUDA tensors the kernel (K5), on
    scan_plan_on's plan; it raises RuntimeError where no cluster fits the
    device."""
    weights = (ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh)
    saved = (s_seq, c_seq, alpha_seq, ds_seq, dc_seq, dalpha_seq)
    if build.on_cpu(vh, h, enc_mask, yin, *weights, *saved):
        return attention_decode_scan_bwd_plain(vh, h, enc_mask, yin, *weights, *saved)
    return _scan_bwd(KERNEL_BWD, False, len(weights), vh, h, enc_mask, yin, (*weights, *saved))


class AttentionDecodeScan(torch.autograd.Function):
    """attention_decode_scan with its gradient: K4 forward, K5 backward
    (the plain versions on CPU tensors). Saves s_seq, c_seq and alpha_seq
    (the JAX VJP, :1185-1189, saves s and c and recomputes alpha);
    enc_mask gets no gradient, and a missing cotangent of c_seq or
    alpha_seq counts as zeros. The gradient of a bf16 scan is refused:
    K5 has no bf16 instance yet."""

    @staticmethod
    def forward(ctx, vh, h, enc_mask, yin, *weights):
        s_seq, c_seq, alpha_seq = attention_decode_scan(vh, h, enc_mask, yin, *weights)
        ctx.save_for_backward(vh, h, enc_mask, yin, *weights, s_seq, c_seq, alpha_seq)
        return s_seq, c_seq, alpha_seq

    @staticmethod
    def backward(ctx, ds_seq, dc_seq, dalpha_seq):
        vh, h, enc_mask, yin, *rest = ctx.saved_tensors
        if vh.dtype == torch.bfloat16:
            raise NotImplementedError(build.BF16_TRAINING)
        dvh, dh, dyin, *dw = attention_decode_scan_bwd(
            vh, h, enc_mask, yin, *rest,
            ds_seq.contiguous(), dc_seq.contiguous(), dalpha_seq.contiguous())
        return (dvh, dh, None, dyin, *dw)


# --- The location-aware and LSTM decoder scans (kernels K10-K15) -------------------------
#
# Three decoders, each a forward and a backward kernel over one templated
# body in ``csrc/attention_scan_loc_lstm.cu``:
#
#   location-aware LSTM  K10, K11  attention_decode_scan_loc_lstm (:1292)
#   location-aware GRU   K12, K13  attention_decode_scan_loc (:984)
#   content-only LSTM    K14, K15  attention_decode_scan_lstm (:1226)
#
# (seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py). Their
# forwards replace pallas_call :355 (``_run_fwd`` :290) with the bodies
# ``_fwd_kernel_loc_lstm`` :254, ``_fwd_kernel_loc`` :219 and
# ``_fwd_kernel_lstm`` :189 (``_location_term`` :62, ``_step_core``
# :91); their backwards pallas_call :945 (``_run_bwd_loc`` :891, bodies
# ``_bwd_kernel_loc_lstm`` :624 and ``_bwd_kernel_loc`` :710) and :851
# (``_run_bwd`` :800, body ``_bwd_kernel_lstm`` :577), with
# ``_bwd_core`` :419. One step, from zero s, mem and alpha:
#
#   UF    = (conv1d(alpha_prev) + bconv) @ u          (B, L, S), location-aware only
#   alpha = masked softmax of w_e . tanh(vh + s_prev @ ws_w + ws_b [+ UF])
#   c     = alpha^T h;  r = concat(c @ c_w + c_b, yin_t) @ dec_w + dec_b
#   (s, mem) = LSTM(r, (s_prev, mem_prev)): gates s_prev @ w_h + r @ w_x + b
#   or    s  = GRU(r, s_prev), as in the content-only GRU scan above
#
# The LSTM's w_h, w_x and b are the port's parameter leaves; the JAX
# package's concat([w_h, w_x]) is never built. The LSTM scans also return
# the cell-state sequence mem, which their backward reads. The forwards
# (K10, K12, K14, and K4 above) run a pre-pass that folds c_in and dec_in
# into the gates (``lstm_fold_plain``, ``gru_fold_plain``), then a walk on
# thread-block clusters on ``fwd_plan_on``'s plan.

# K10 and K14 are built from the decoder scans' source into a library of
# their own (the forward walk's LSTM instances), and K12 with K4 into
# another (its GRU instances), beside K11's, K13's and K15's.
KERNEL_LOC_LSTM_FWD = build.Kernel(
    "attention_decode_scan_loc_lstm_fwd", "attention_scan_loc_lstm.cu",
    "attention_decode_scan_loc_lstm_fwd",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    defines=("LSTM_FWD_ONLY",),
)
KERNEL_LOC_LSTM_BWD = build.Kernel(
    "attention_decode_scan_loc_lstm_bwd", "attention_scan_loc_lstm.cu",
    "attention_decode_scan_loc_lstm_bwd",
    [ctypes.c_void_p] * 42 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
KERNEL_LOC_FWD = build.Kernel(
    "attention_decode_scan_loc_fwd", "attention_scan_loc_lstm.cu", "attention_decode_scan_loc_fwd",
    [ctypes.c_void_p] * 20 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    defines=("GRU_FWD_ONLY",),
)
KERNEL_LOC_BWD = build.Kernel(
    "attention_decode_scan_loc_bwd", "attention_scan_loc_lstm.cu", "attention_decode_scan_loc_bwd",
    [ctypes.c_void_p] * 38 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)
KERNEL_LSTM_FWD = build.Kernel(
    "attention_decode_scan_lstm_fwd", "attention_scan_loc_lstm.cu",
    "attention_decode_scan_lstm_fwd",
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    defines=("LSTM_FWD_ONLY",),
)
KERNEL_LSTM_BWD = build.Kernel(
    "attention_decode_scan_lstm_bwd", "attention_scan_loc_lstm.cu",
    "attention_decode_scan_lstm_bwd",
    [ctypes.c_void_p] * 36 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)
_COMMON = WEIGHTS[:7]
_LOC = ("wconv", "bconv", "u")
WEIGHTS_LOC_LSTM = _COMMON + ("w_h", "w_x", "b") + _LOC
WEIGHTS_LOC = WEIGHTS + _LOC
WEIGHTS_LSTM = _COMMON + ("w_h", "w_x", "b")


def _loc_features(alpha_prev, wconv, bconv):
    """conv1d(alpha_prev) + bconv: (B, L) -> (B, L, FM), zero-padded as the
    reference pads (Attention.lua:77-85): f // 2 on the left and the
    rest on the right, for odd and even filter widths alike."""
    f = wconv.shape[0]
    l = alpha_prev.shape[1]
    ap = torch.nn.functional.pad(alpha_prev, (f // 2, f - 1 - f // 2))
    return sum(ap[:, j: j + l, None] * wconv[j] for j in range(f)) + bconv


def lstm_fold_plain(yin, c_w, c_b, dec_w, dec_b, w_x, b):
    """The LSTM forwards' pre-pass in plain PyTorch: the decoder input and
    the gates are linear in c, so the step's gate pre-activations
    s_prev @ w_h + r @ w_x + b are s_prev @ w_h + P[:, t] + c @ W_cx with
    P = ([c_b | yin] @ dec_w + dec_b) @ w_x + b (B, T, 4St) and W_cx =
    c_w @ dec_w[:St] @ w_x (A, 4St), both known before the first step.
    Returns (P, W_cx), gate-major as w_x (the kernel stores them unit by
    unit)."""
    p, w_cx = _fold(yin, c_w, c_b, dec_w, dec_b, w_x)
    return p + b, w_cx


def gru_fold_plain(yin, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh):
    """The GRU forwards' pre-pass in plain PyTorch: the gates'
    pre-activations [s_prev | r] @ w_zr and the candidate's [rg s_prev |
    r] @ w_h take r through W_x = [w_zr[St:] | w_h[St:]], and r @ W_x is
    P[:, t] + c @ W_cx with P = ([c_b | yin] @ dec_w + dec_b) @ W_x (B, T,
    3St) and W_cx = c_w @ dec_w[:St] @ W_x (A, 3St). Returns (P, W_cx),
    their columns the update gate's, the reset gate's and the candidate's
    (the kernel stores them unit by unit). bf16 inputs are widened to
    float32 first, as the bf16 entry's pre-pass widens them: its tables
    are float32."""
    yin, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh = (
        t.float() for t in (yin, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh))
    st = dec_w.shape[1]
    return _fold(yin, c_w, c_b, dec_w, dec_b, torch.cat([gru_wzr[st:], gru_wh[st:]], dim=1))


def gru_folded_scan_plain(vh, h, enc_mask, yin, *weights):
    """Plain twin of K4 as its entries compute it: gru_fold_plain's P and
    W_cx, then each step's update and reset gates sigmoid(s_prev @
    w_zr[:St] + x[:, :2St]) and candidate tanh((rg s_prev) @ w_h[:St] +
    x[:, 2St:]) with x = P[:, t] + c @ W_cx. The float32 entry's sums in
    exact arithmetic; on bfloat16 inputs the bf16 entry's: s carried in
    float32, s_prev rounded to bf16 before ws_w and w_zr[:St], c before
    W_cx, rg s_prev before w_h[:St], the outputs bf16. cc and r, which
    the fold never forms, are not rounded, where the JAX kernel's rounding
    points (attention_decode_scan_plain) round them."""
    dt, rnd = vh.dtype, _same
    if dt == torch.bfloat16:
        vh, h, enc_mask, yin, *weights = (t.float() for t in (vh, h, enc_mask, yin, *weights))
        rnd = build.round_bf16
    ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh = weights
    p, w_cx = gru_fold_plain(yin, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh)
    b, t_len, st = yin.shape
    s = yin.new_zeros((b, st))
    outs = ([], [], [])
    for t in range(t_len):
        sr = rnd(s)
        alpha = masked_softmax(torch.tanh(vh + (sr @ ws_w + ws_b)[:, None, :]) @ w_e, enc_mask)
        c = torch.einsum("bl,bla->ba", alpha, h)
        x = p[:, t] + rnd(c) @ w_cx
        zr = torch.sigmoid(sr @ gru_wzr[:st] + x[:, :2 * st])
        zg, rg = zr[:, :st], zr[:, st:]
        s = (1.0 - zg) * s + zg * torch.tanh(rnd(rg * s) @ gru_wh[:st] + x[:, 2 * st:])
        for seq, v in zip(outs, (s, c, alpha)):
            seq.append(v)
    return tuple(torch.stack(x, dim=1).to(dt) for x in outs)


def _fold(yin, c_w, c_b, dec_w, dec_b, w_x):
    """(([c_b | yin] @ dec_w + dec_b) @ w_x, c_w @ dec_w[:St] @ w_x)."""
    st = dec_w.shape[1]
    zy = torch.cat([c_b.expand(yin.shape[:-1] + c_b.shape), yin], dim=-1) @ dec_w + dec_b
    return zy @ w_x, (c_w @ dec_w[:st]) @ w_x


def _split(weights, lstm: bool):
    """(the seven weights every decoder has, the cell's, the location
    term's (wconv, bconv, u) or ())."""
    n_cell = 3 if lstm else 2
    return weights[:7], weights[7:7 + n_cell], weights[7 + n_cell:]


def _scan_plain(vh, h, enc_mask, yin, weights, lstm: bool):
    """The step above looped over the T steps: (s_seq, c_seq, alpha_seq),
    and mem_seq for the LSTM."""
    (ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b), cell_w, loc_w = _split(weights, lstm)
    bsz, t_len, st = yin.shape
    s = yin.new_zeros((bsz, st))
    mem = torch.zeros_like(s)
    alpha = vh.new_zeros(vh.shape[:2])
    outs = ([], [], [], [])
    for t in range(t_len):
        z = vh + (s @ ws_w + ws_b)[:, None, :]
        if loc_w:
            z = z + _loc_features(alpha, loc_w[0], loc_w[1]) @ loc_w[2]
        alpha = masked_softmax(torch.tanh(z) @ w_e, enc_mask)
        c = torch.einsum("bl,bla->ba", alpha, h)
        r = torch.cat([c @ c_w + c_b, yin[:, t]], dim=-1) @ dec_w + dec_b
        if lstm:
            w_h, w_x, b = cell_w
            g_in, g_forget, g_cell, g_out = (s @ w_h + r @ w_x + b).chunk(4, dim=-1)
            mem = torch.sigmoid(g_forget) * mem + torch.sigmoid(g_in) * torch.tanh(g_cell)
            s = torch.sigmoid(g_out) * torch.tanh(mem)
        else:
            gru_wzr, gru_wh = cell_w
            zr = torch.sigmoid(torch.cat([s, r], dim=-1) @ gru_wzr)
            zg, rg = zr[:, :st], zr[:, st:]
            cand = torch.tanh(torch.cat([rg * s, r], dim=-1) @ gru_wh)
            s = (1.0 - zg) * s + zg * cand
        for seq, v in zip(outs, (s, c, alpha, mem)):
            seq.append(v)
    return tuple(torch.stack(x, dim=1) for x in outs[:4 if lstm else 3])


def _scan_bwd_plain(vh, h, enc_mask, yin, weights, saved, cots, lstm: bool):
    """The backward of _scan_plain, step for step as the kernels walk: a
    reverse-time loop that recomputes each step's energies, decoder input
    and cell from the saved s, mem and alpha (shifted by one, zero at
    step 0) and the saved c, takes alpha itself from alpha_seq, and
    carries ds, dmem and the cotangent of alpha_prev (the location term's
    input) to the step before. The GRU follows ``_run_bwd_xla`` (:1047).
    saved is (s_seq, c_seq, alpha_seq[, mem_seq]) and cots their
    cotangents, each None where there is none: it counts as zeros.
    Returns (dvh, dh, dyin, then the gradient of each weight)."""
    (ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b), cell_w, loc_w = _split(weights, lstm)
    s_seq, c_seq, alpha_seq = saved[:3]
    ds_seq, dc_seq, dalpha_seq = cots[:3]
    mem_seq, dmem_seq = (saved[3], cots[3]) if lstm else (None, None)
    bsz, t_len, st = yin.shape
    cot = lambda seq, t, like: like.new_zeros(like.shape) if seq is None else seq[:, t]
    ds_carry = yin.new_zeros((bsz, st))
    dmem_carry = torch.zeros_like(ds_carry)
    dal_carry = vh.new_zeros(vh.shape[:2])
    dvh, dh = torch.zeros_like(vh), torch.zeros_like(h)
    dyin = torch.empty_like(yin)
    dw = [torch.zeros_like(w) for w in weights]
    for t in range(t_len - 1, -1, -1):
        prev = (lambda seq: seq[:, t - 1]) if t > 0 else (lambda seq: torch.zeros_like(seq[:, 0]))
        s_prev, alpha_prev = prev(s_seq), prev(alpha_seq)
        alpha, c_saved = alpha_seq[:, t], c_seq[:, t]
        ws = s_prev @ ws_w + ws_b
        z = vh + ws[:, None, :]
        if loc_w:
            wconv, bconv, u = loc_w
            feat = _loc_features(alpha_prev, wconv, bconv)
            z = z + feat @ u
        a = torch.tanh(z)
        cc = c_saved @ c_w + c_b
        rr = torch.cat([cc, yin[:, t]], dim=-1)
        r = rr @ dec_w + dec_b
        ds = cot(ds_seq, t, ds_carry) + ds_carry

        if lstm:
            w_h, w_x, b = cell_w
            mem_prev = prev(mem_seq)
            g_in, g_forget, g_cell, g_out = (s_prev @ w_h + r @ w_x + b).chunk(4, dim=-1)
            i, fg, o = torch.sigmoid(g_in), torch.sigmoid(g_forget), torch.sigmoid(g_out)
            g = torch.tanh(g_cell)
            tm = torch.tanh(fg * mem_prev + i * g)
            dmem = ds * o * (1.0 - tm * tm) + cot(dmem_seq, t, ds_carry) + dmem_carry
            dgates = torch.cat([dmem * g * i * (1.0 - i), dmem * mem_prev * fg * (1.0 - fg),
                                dmem * i * (1.0 - g * g), ds * tm * o * (1.0 - o)], dim=-1)
            dmem_carry = dmem * fg
            ds_prev = dgates @ w_h.T
            dr = dgates @ w_x.T
            cell_steps = (s_prev.T @ dgates, r.T @ dgates, dgates.sum(0))
        else:
            gru_wzr, gru_wh = cell_w
            sr = torch.cat([s_prev, r], dim=-1)
            zr = torch.sigmoid(sr @ gru_wzr)
            zg, rg = zr[:, :st], zr[:, st:]
            cand_in = torch.cat([rg * s_prev, r], dim=-1)
            cand = torch.tanh(cand_in @ gru_wh)
            dzg = ds * (cand - s_prev)
            da_cand = ds * zg * (1.0 - cand * cand)
            dcand_in = da_cand @ gru_wh.T
            drgs, dr = dcand_in[:, :st], dcand_in[:, st:]
            da_zr = torch.cat([dzg * zg * (1.0 - zg), drgs * s_prev * rg * (1.0 - rg)], dim=-1)
            dsr = da_zr @ gru_wzr.T
            ds_prev = dsr[:, :st] + drgs * rg + ds * (1.0 - zg)
            dr = dr + dsr[:, st:]
            cell_steps = (sr.T @ da_zr, cand_in.T @ da_cand)

        # The decoder-input MLP and the context.
        drr = dr @ dec_w.T
        dcc = drr[:, :st]
        dyin[:, t] = drr[:, st:]
        dc = dcc @ c_w.T + cot(dc_seq, t, c_saved)
        dalpha = torch.einsum("ba,bla->bl", dc, h) + cot(dalpha_seq, t, alpha) + dal_carry
        dh += alpha[:, :, None] * dc[:, None, :]
        # The masked softmax and the energies.
        de = alpha * (dalpha - torch.sum(dalpha * alpha, dim=-1, keepdim=True))
        dz = de[:, :, None] * w_e * (1.0 - a * a)
        dvh += dz
        dws = torch.sum(dz, dim=1)
        ds_carry = ds_prev + dws @ ws_w.T
        steps = [s_prev.T @ dws, dws.sum(0), torch.einsum("bls,bl->s", a, de),
                 c_saved.T @ dcc, dcc.sum(0), rr.T @ dr, dr.sum(0), *cell_steps]
        if loc_w:
            # The location term: UF = feat @ u, feat = conv(alpha_prev) + bconv.
            f = wconv.shape[0]
            pad_l, l = f // 2, alpha.shape[1]
            dfeat = dz @ u.T
            ap = torch.nn.functional.pad(alpha_prev, (pad_l, f - 1 - pad_l))
            dap = torch.zeros_like(ap)
            for j in range(f):
                dap[:, j: j + l] += dfeat @ wconv[j]
            dal_carry = dap[:, pad_l: pad_l + l]
            steps += [torch.stack([torch.einsum("bl,blq->q", ap[:, j: j + l], dfeat)
                                   for j in range(f)]),
                      dfeat.sum((0, 1)), torch.einsum("blq,bls->qs", feat, dz)]
        for acc, step in zip(dw, steps):
            acc += step
    return (dvh, dh, dyin, *dw)


def attention_decode_scan_loc_lstm_plain(vh, h, enc_mask, yin, *weights):
    """Plain PyTorch twin of K10: (s_seq, c_seq, alpha_seq, mem_seq)."""
    return _scan_plain(vh, h, enc_mask, yin, weights, lstm=True)


def attention_decode_scan_loc_plain(vh, h, enc_mask, yin, *weights):
    """Plain PyTorch twin of K12: (s_seq, c_seq, alpha_seq)."""
    return _scan_plain(vh, h, enc_mask, yin, weights, lstm=False)


def attention_decode_scan_lstm_plain(vh, h, enc_mask, yin, *weights):
    """Plain PyTorch twin of K14: (s_seq, c_seq, alpha_seq, mem_seq)."""
    return _scan_plain(vh, h, enc_mask, yin, weights, lstm=True)


def attention_decode_scan_loc_lstm_bwd_plain(vh, h, enc_mask, yin, *args):
    """Plain PyTorch twin of K11. args: the 13 weights, (s_seq, c_seq,
    alpha_seq, mem_seq) and their cotangents (each may be None). Returns
    (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dw_h,
    dw_x, db, dwconv, dbconv, du)."""
    return _scan_bwd_plain(vh, h, enc_mask, yin, args[:13], args[13:17], args[17:], lstm=True)


def attention_decode_scan_loc_bwd_plain(vh, h, enc_mask, yin, *args):
    """Plain PyTorch twin of K13. args: the 12 weights, (s_seq, c_seq,
    alpha_seq) and their cotangents (each may be None). Returns (dvh, dh,
    dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dgru_wzr,
    dgru_wh, dwconv, dbconv, du)."""
    return _scan_bwd_plain(vh, h, enc_mask, yin, args[:12], args[12:15], args[15:], lstm=False)


def attention_decode_scan_lstm_bwd_plain(vh, h, enc_mask, yin, *args):
    """Plain PyTorch twin of K15. args: the 10 weights, (s_seq, c_seq,
    alpha_seq, mem_seq) and their cotangents (each may be None). Returns
    (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dw_h,
    dw_x, db)."""
    return _scan_bwd_plain(vh, h, enc_mask, yin, args[:10], args[10:14], args[14:], lstm=True)


def _scan_dims(vh, h, yin, weights, lstm: bool):
    """(B, T, L, S, A, St) and, with the location term, (FM, F)."""
    b, l, s_dim = vh.shape
    loc_w = _split(weights, lstm)[2]
    loc = (loc_w[0].shape[1], loc_w[0].shape[0]) if loc_w else ()
    return (b, yin.shape[1], l, s_dim, h.shape[2], yin.shape[2]), loc


def _check_scan_inputs(vh, h, enc_mask, yin, weights, lstm: bool, dtype=torch.float32):
    (b, t_len, l, s_dim, a_dim, st), loc = _scan_dims(vh, h, yin, weights, lstm)
    shapes = [(b, l, s_dim), (b, l, a_dim), (b, l), (b, t_len, st), (st, s_dim), (s_dim,),
              (s_dim,), (a_dim, st), (st,), (2 * st, st), (st,)]
    shapes += ([(st, 4 * st), (st, 4 * st), (4 * st,)] if lstm
               else [(2 * st, 2 * st), (2 * st, st)])
    names = ("vh", "h", "enc_mask", "yin") + (WEIGHTS_LSTM if lstm else WEIGHTS)
    if loc:
        fm, f = loc
        shapes += [(f, fm), (fm,), (fm, s_dim)]
        names += _LOC
    if len(weights) != len(names) - 4:
        raise ValueError(f"{len(weights)} weights, expected {len(names) - 4}")
    for name, t, shape in zip(names, (vh, h, enc_mask, yin, *weights), shapes):
        build.check(name, t, shape, vh.device, dtype)


def _scan(kernel, lstm: bool, vh, h, enc_mask, yin, weights):
    """The forward wrapper of K10, K12, K14 and K4 (and K4's bf16 entry):
    the plain version on CPU tensors, the kernel on CUDA tensors, on
    fwd_plan_on's plan with a scratch of fwd_scratch_floats. Only K4 has
    a bf16 entry: the others refuse bfloat16 inputs on either device."""
    dt = torch.bfloat16 if kernel is KERNEL_FWD_BF16 else torch.float32
    if vh.dtype == torch.bfloat16 and dt != torch.bfloat16:
        raise TypeError(f"{kernel.name}: {build.BF16_OTHER_DECODERS}")
    if build.on_cpu(vh, h, enc_mask, yin, *weights):
        return _scan_plain(vh, h, enc_mask, yin, weights, lstm)
    _check_scan_inputs(vh, h, enc_mask, yin, weights, lstm, dt)
    (b, t_len, l, s_dim, a_dim, st), loc = _scan_dims(vh, h, yin, weights, lstm)
    f32 = dict(device=vh.device, dtype=torch.float32)
    shapes = [(b, t_len, st), (b, t_len, a_dim), (b, t_len, l), (b, t_len, st)]
    outs = tuple(torch.empty(shape, device=vh.device, dtype=dt)
                 for shape in shapes[:4 if lstm else 3])
    if b * t_len == 0:
        return outs
    plan = fwd_plan_on(kernel, b, l, s_dim, a_dim, st, *(loc or (0, 0)), vh.device)
    scratch = torch.empty(fwd_scratch_floats(b, t_len, a_dim, st, FWD_CELL[kernel.symbol]),
                          **f32)
    kernel.launch(*[build.ptr(t) for t in (vh, h, enc_mask, yin, *weights, *outs, scratch)],
                  b, t_len, l, s_dim, a_dim, st, *loc, *plan.args(), build.stream_of(vh))
    return outs


def stash_floats(lstm: bool, b: int, t_len: int, l: int, s_dim: int, st: int, fm: int = 0,
                 f: int = 0, partials: int = 0) -> int:
    """Floats of the stash of K5, K11, K13 and K15 (``carve_stash``): (B*T)
    rows of rr (2St), for the LSTM r (St), for the GRU sr and cand_in (2St
    each), dws (S), dcc and dr (St each), for the LSTM dgates (4St), for
    the GRU da_zr (2St) and da_cand (St), and for K13 (the GRU with the
    location term, fm > 0) the per-step w_e partial (S); then, with the
    location term, B rows of the step's dz (L*S, which every step
    rewrites); then the partial sums: for K13, B rows of dU (FM*S) and of
    dwconv and dbconv ((F + 1) * FM); for the cluster walks (K5, K11,
    K15), `partials` rows (one per block of the walk: ScanPlan.partials)
    of dw_e (S) and, with the location term, of dU and of dwconv and
    dbconv. Neither the location term's share nor the partials grow with
    T: the walks sum them over the steps themselves."""
    if not lstm and fm:  # K13
        return b * t_len * (11 * st + 2 * s_dim) + b * l * s_dim + b * (fm * s_dim + (f + 1) * fm)
    cell = 9 * st if lstm else 11 * st
    return (b * t_len * (cell + s_dim) + (b * l * s_dim if fm else 0)
            + partials * (s_dim + (fm * s_dim + (f + 1) * fm if fm else 0)))


# --- The plan of the decoder backwards' cluster walk (K5, K11, K15) ------------------------
#
# K5, K11 and K15 walk the steps of R batch rows on a thread-block cluster of
# C blocks (csrc/attention_scan_loc_lstm.cu, decoder_walk). The plan (C, R) is
# a plain function of the shapes, of the cell, and of two numbers of the
# device, which ``scan_limits`` asks the kernel's library for: the opt-in
# shared memory of a block, and how many clusters of C blocks can be resident
# at once when each block takes that much (one block to an SM).

WALK_CLUSTERS = (16, 8)  # 16 is a non-portable cluster size on Hopper
WALK_ROWS = (1, 2, 4, 8)  # the walk's instances
# The mbarriers of a step's exchanges, by cell (csrc: kBarsLstm, kBarsGru).
WALK_BARS = {"lstm": 5, "gru": 6}
# The walk's cell, by the C entry point of its backward.
WALK_CELL = {"attention_decode_scan_bwd": "gru", "attention_decode_scan_loc_lstm_bwd": "lstm",
             "attention_decode_scan_lstm_bwd": "lstm"}
# A step of the walk and wave, in us, by cell and (C, R), on an NVIDIA H100
# 80GB HBM3 at 700.00 W (chip_smoke.py phase 8's sweeps): for the LSTM,
# K11's walk at the conv+BiLSTM recipe's shape (L' = 16, T = 56) under each
# plan, the mean of B = 16 and 128 (K15's steps are 0.65-0.75 of these, in
# the same order); for the GRU, K5's at the flagship's (L = 144, T = 56),
# the mean of B = 16 and 128. R = 8 fits no block of K5 at the flagship's
# widths: its cost is R = 4's doubled.
STEP_COST = {
    "lstm": {(16, 1): 33.5, (16, 2): 38.4, (16, 4): 45.8, (16, 8): 65.3,
             (8, 1): 38.4, (8, 2): 47.2, (8, 4): 61.2, (8, 8): 89.4},
    "gru": {(16, 1): 20.3, (16, 2): 28.4, (16, 4): 46.2, (16, 8): 92.4,
            (8, 1): 23.6, (8, 2): 36.3, (8, 4): 57.6, (8, 8): 115.2},
}


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def _r4(n: int) -> int:
    return 4 * _cdiv(n, 4)


def _cspan(n: int, c: int) -> int:
    """The largest of c blocks' shares of n units (csrc's cspan): whole
    groups of 4 where 4 divides n."""
    return _cdiv(n, c) if n % 4 else 4 * _cdiv(n // 4, c)


def walk_smem_bytes(cell: str, rows: int, cluster: int, l: int, s_dim: int, a_dim: int, st: int,
                    fm: int = 0, f: int = 0) -> int:
    """Shared memory of one block of the walk of `cell` ("lstm" or "gru";
    fm = f = 0 without the location term), as
    csrc/attention_scan_loc_lstm.cu's walk_smem_floats counts it, every
    buffer a whole number of 16-byte groups: the step's mbarriers; the
    gathered gate cotangents (R rows of 4St for the LSTM, 3St for the
    GRU's da_cand and da_zr), dr, dcc, dc (R rows of St, St and A); the
    blocks' shares of the softmax's sum and their dws partials (C x R and
    C x R x S); dws; two buffers of a step's staged inputs of the block's
    units (at most ceil(St/C), in whole groups of 4 where 4 divides St:
    the cell's 4 or 3 gate values, mem_prev or s_prev, the cotangent of s
    and for the LSTM of mem), of ws, of its ceil(L/C) positions (alpha,
    its cotangent, and alpha_prev with the filter's reach) and of its
    columns (c and its cotangent; as many as units of A); the carries and
    dsp (the LSTM's s and mem carries, the GRU's s carry and its two
    halves of da_cand w_h^T), de; w_e and dw_e's sum; and with the
    location term the positions' features and dfeat (with the halo), U
    and dU's sum, the filter and the sums of dwconv and dbconv."""
    r, c, loc, lstm = rows, cluster, int(fm > 0), int(cell == "lstm")
    stc, ac, pc, sp = _cspan(st, c), _cspan(a_dim, c), _cdiv(l, c), _r4(s_dim)
    floats = (_r4(2 * WALK_BARS[cell]) + _r4((3 + lstm) * r * st) + 2 * _r4(r * st)
              + _r4(r * a_dim) + _r4(c * r) + _r4(c * r * sp) + _r4(r * sp)
              + 2 * (_r4((3 + lstm) * r * stc) + (2 + lstm) * _r4(r * stc) + _r4(r * sp)
                     + 2 * _r4(r * pc) + loc * _r4(r * (pc + f - 1)) + 2 * _r4(r * ac))
              + (4 - lstm) * _r4(r * stc) + 2 * _r4(r * pc) + 2 * _r4(s_dim)
              + loc * (_r4(r * pc * fm) + _r4(r * (pc + f - 1) * fm) + 2 * _r4(fm * s_dim)
                       + _r4(f * fm) + _r4(fm) + _r4((f + 1) * fm)))
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    cluster: int  # blocks of a cluster
    rows: int  # batch rows of a cluster
    waves: int = 1  # rounds of resident clusters the launch takes

    def partials(self, b: int) -> int:
        """Rows of the walk's partial sums at batch b: one per block."""
        return _cdiv(b, self.rows) * self.cluster


def scan_plan(b: int, smem: Dict[Tuple[int, int], int], smem_limit: int,
              resident: Dict[int, int], cost: Dict[Tuple[int, int], float],
              what: str = "decoder scan backward") -> ScanPlan:
    """The walk's plan for b batch rows: `smem[(C, R)]` bytes a block
    takes on clusters of C blocks with R rows each, `smem_limit` the
    device's opt-in bytes a block, `resident[C]` the clusters of C blocks
    the device holds at once, `cost[(C, R)]` a step's time (STEP_COST of
    the walk's cell). Of the (C, R) that fit, those whose ceil(b / R)
    clusters fill one wave, if any, else all, by the fewest waves x
    cost[(C, R)], then the fewer waves, the smaller R, the larger C.
    RuntimeError (naming `what`) when no cluster fits."""
    fits = [(c, r) for c in WALK_CLUSTERS for r in WALK_ROWS
            if resident.get(c, 0) >= 1 and smem[(c, r)] <= smem_limit]
    if not fits:
        raise RuntimeError(
            f"{what}: no cluster of {' or '.join(map(str, WALK_CLUSTERS))} "
            f"blocks fits the device (resident clusters {resident}; shared memory a block "
            f"{min(smem.values())} bytes or more of {smem_limit})")
    waves = {(c, r): _cdiv(_cdiv(b, r), resident[c]) for c, r in fits}
    one = [cr for cr in fits if waves[cr] == 1]
    c, r = min(one or fits, key=lambda cr: (waves[cr] * cost[cr], waves[cr], cr[1], -cr[0]))
    return ScanPlan(c, r, waves[(c, r)])


_LIMITS: Dict[Tuple[str, int], Tuple[int, Dict[int, int]]] = {}


def scan_limits(kernel, device: torch.device) -> Tuple[int, Dict[int, int]]:
    """(opt-in shared memory of a block, {C: resident clusters of C
    blocks}) of `kernel`'s walk (K5, K11 or K15, or the forward walk of
    K10, K12, K14 or K4) on `device`, from its
    ``<symbol>_limits`` C helper; asked once per kernel and device. A
    cluster size the device refuses counts 0 clusters."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (kernel.name, index)
    if key not in _LIMITS:
        out = ctypes.POINTER(ctypes.c_int)
        fn = kernel.helper(kernel.symbol + "_limits", [ctypes.c_int, out, out])
        smem, resident = 0, {}
        with torch.cuda.device(index):
            for c in WALK_CLUSTERS:
                limit, n = ctypes.c_int(0), ctypes.c_int(0)
                rc = fn(c, ctypes.byref(limit), ctypes.byref(n))
                resident[c] = n.value if rc == 0 else 0
                smem = max(smem, limit.value if rc == 0 else 0)
        _LIMITS[key] = (smem, resident)
    return _LIMITS[key]


def scan_plan_on(kernel, b: int, l: int, s_dim: int, a_dim: int, st: int, fm: int, f: int,
                 device: torch.device) -> ScanPlan:
    """The plan `kernel`'s wrapper (K5, K11 or K15) runs for these shapes
    on `device`: its walk's cell's (WALK_CELL) shared memory and step
    costs."""
    cell = WALK_CELL[kernel.symbol]
    smem_limit, resident = scan_limits(kernel, device)
    smem = {(c, r): walk_smem_bytes(cell, r, c, l, s_dim, a_dim, st, fm, f)
            for c in WALK_CLUSTERS for r in WALK_ROWS}
    return scan_plan(b, smem, smem_limit, resident, STEP_COST[cell])


# --- The plan of the decoder forwards' cluster walk (K10, K12, K14, K4) -------------------
#
# The forwards walk the steps of R batch rows on a cluster of C blocks
# (csrc/attention_scan_loc_lstm.cu, decoder_fwd_walk), as the backwards do,
# with two exchanges a step for the LSTM and three for the GRU. The plan
# (C, R) is chosen as ``scan_plan`` chooses the backwards', from the
# forward's own shared memory and step costs of its cell; a block holds its
# slice of W_cx (G ceil(St / C) rows of A floats, G = 4 gates for the LSTM,
# 3 for the GRU) in shared memory where that still fits ("resident"), else
# it streams the slice from L2 each step, as it always does the s_prev
# products' weights.

# The mbarriers of a forward step's exchanges, by cell (csrc: kBarsFwdLstm,
# kBarsFwdGru), and the gate columns of a unit (csrc: kGates).
FWD_BARS = {"lstm": 2, "gru": 3}
FWD_GATES = {"lstm": 4, "gru": 3}
FWD_WARPS = 16  # warps of a block (csrc: kThreads / 32), a feature buffer each
# The forward walk's cell, by the C entry point of its forward.
FWD_CELL = {"attention_decode_scan_loc_lstm_fwd": "lstm", "attention_decode_scan_lstm_fwd": "lstm",
            "attention_decode_scan_loc_fwd": "gru", "attention_decode_scan_fwd": "gru",
            "attention_decode_scan_fwd_bf16": "gru"}
# A step of the forward walk and wave, in us, by cell and (C, R), on an
# NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 8's sweeps, on the
# plan's layout: W_cx resident where it fits): for the LSTM, K10's walk at
# the conv+BiLSTM recipe's shape (L' = 16, T = 56), the mean of B = 16 and
# 128 (K14's steps are 0.7-0.9 of these, in the same order); R = 8 fits no
# block on clusters of 16 at the recipe's widths: its cost is R = 4's
# doubled. For the GRU, K12's walk at flagship_loc's shape (L = 144, T =
# 56), the mean of B = 16 and 128 (K4's steps are 0.7-0.9 of these, in the
# same order); R = 4 on clusters of 8 fits K4's block but not K12's: K12's
# R = 2 times K4's ratio of the two (1.52); the other (C, R) fit no block
# at the flagship's widths and cost their R / 2's doubled.
FWD_STEP_COST = {
    "lstm": {(16, 1): 16.8, (16, 2): 18.3, (16, 4): 22.1, (16, 8): 44.2,
             (8, 1): 20.5, (8, 2): 21.7, (8, 4): 26.7, (8, 8): 40.5},
    "gru": {(16, 1): 19.2, (16, 2): 27.6, (16, 4): 55.2, (16, 8): 110.4,
            (8, 1): 22.3, (8, 2): 30.2, (8, 4): 45.8, (8, 8): 91.6},
}


def fwd_smem_bytes(rows: int, cluster: int, l: int, s_dim: int, a_dim: int, st: int,
                   fm: int = 0, f: int = 0, resident: bool = False, cell: str = "lstm") -> int:
    """Shared memory of one block of the forward walk of `cell` ("lstm" or
    "gru"; fm = f = 0 without the location term), as
    csrc/attention_scan_loc_lstm.cu's fwd_smem_floats counts it, every
    buffer a whole number of 16-byte groups, G = FWD_GATES[cell]: the
    step's mbarriers; s gathered from every block, two buffers (R rows of
    St); the blocks' ws partials (C x R x S) and ws; the blocks' softmax
    shares (C x R rows of A + 2: the context partial, the local max and
    sum) and c; each row's scales of the blocks and its max and normaliser
    (C + 2); the gates of the block's units and two buffers of their
    staged P (R rows of G ceil(St/C) each); the LSTM's cell state (R rows
    of ceil(St/C)); the GRU's gathered rg s_prev (R rows of St) takes ws's
    floats (R rows of the larger of S and St); the energies and their
    exponentials on its ceil(L/C) positions; w_e; its
    units' rows of ws_w; where resident its rows of W_cx^T (G ceil(St/C) x
    A); the mask on its positions, or with the location term the mask,
    alpha_prev and the peers' energies on the filter's window (ceil(L/C) +
    F - 1 positions), U, the filter and a feature buffer a warp."""
    r, c, loc, lstm = rows, cluster, int(fm > 0), int(cell == "lstm")
    stc, pc, sp, g = _cspan(st, c), _cdiv(l, c), _r4(s_dim), FWD_GATES[cell]
    floats = (_r4(2 * FWD_BARS[cell]) + 2 * _r4(r * st) + _r4(c * r * sp)
              + _r4(r * max(sp, (1 - lstm) * st)) + _r4(c * r * _r4(a_dim + 2))
              + _r4(r * _r4(a_dim)) + _r4(r * (c + 2)) + 3 * _r4(g * r * stc)
              + lstm * _r4(r * stc) + 2 * _r4(r * pc) + _r4(s_dim) + _r4(stc * s_dim)
              + int(resident) * _r4(g * stc * a_dim) + (1 - loc) * _r4(r * pc)
              + loc * (3 * _r4(r * (pc + f - 1)) + _r4(fm * s_dim) + _r4(f * fm) + _r4(fm)
                       + _r4(FWD_WARPS * fm)))
    return 4 * floats


def fwd_scratch_floats(b: int, t_len: int, a_dim: int, st: int, cell: str = "lstm") -> int:
    """Floats of the forwards' global scratch (``carve_fwd_scratch``), G =
    FWD_GATES[cell]: the pre-pass's [c_b | yin] @ dec_w + dec_b and c_w @
    dec_w[:St] ((B*T + A) rows of St), P (B*T rows of G St), W_cx^T (G St
    rows of A) and the s_prev products' weights transposed (G St rows of
    St)."""
    g = FWD_GATES[cell]
    return (_r4((b * t_len + a_dim) * st) + _r4(g * b * t_len * st) + _r4(g * st * a_dim)
            + _r4(g * st * st))


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    cluster: int  # blocks of a cluster
    rows: int  # batch rows of a cluster
    resident: bool  # W_cx's slice in shared memory
    waves: int = 1  # rounds of resident clusters the launch takes

    def args(self) -> Tuple[int, int, int]:
        """The C entry points' (cluster, rows, resident) arguments."""
        return self.cluster, self.rows, int(self.resident)


def fwd_plan(b: int, l: int, s_dim: int, a_dim: int, st: int, fm: int, f: int,
             smem_limit: int, resident: Dict[int, int],
             cost: Dict[Tuple[int, int], float] = None, cell: str = "lstm") -> FwdPlan:
    """The forward walk's plan for b batch rows of `cell` at these widths,
    on a device whose blocks take at most `smem_limit` bytes and that
    holds `resident[C]` clusters of C blocks at once: of the (C, R) whose
    streamed layout fits, ``scan_plan``'s choice by `cost` (default
    FWD_STEP_COST[cell]); W_cx's slice resident where that layout fits
    too. RuntimeError when no cluster fits."""
    smem = {(c, r): fwd_smem_bytes(r, c, l, s_dim, a_dim, st, fm, f, cell=cell)
            for c in WALK_CLUSTERS for r in WALK_ROWS}
    plan = scan_plan(b, smem, smem_limit, resident, cost or FWD_STEP_COST[cell],
                     "decoder scan forward")
    held = fwd_smem_bytes(plan.rows, plan.cluster, l, s_dim, a_dim, st, fm, f, True,
                          cell) <= smem_limit
    return FwdPlan(plan.cluster, plan.rows, held, plan.waves)


def fwd_plan_on(kernel, b: int, l: int, s_dim: int, a_dim: int, st: int, fm: int, f: int,
                device: torch.device) -> FwdPlan:
    """The plan `kernel`'s wrapper (K10, K12, K14 or K4) runs for these
    shapes on `device`: its walk's cell's (FWD_CELL) shared memory and
    step costs."""
    return fwd_plan(b, l, s_dim, a_dim, st, fm, f, *scan_limits(kernel, device),
                    cell=FWD_CELL[kernel.symbol])


def _scan_bwd(kernel, lstm: bool, n_weights: int, vh, h, enc_mask, yin, args):
    """The backward wrapper of K5, K11, K13 and K15: args are the weights,
    the saved output sequences and their cotangents (each None where there
    is none: it counts as zeros). The cluster walks (K5, K11, K15) run
    scan_plan_on's plan."""
    n_out = 4 if lstm else 3
    weights = args[:n_weights]
    saved = args[n_weights:n_weights + n_out]
    cots = args[n_weights + n_out:]
    if len(cots) != n_out:
        raise ValueError(f"{len(args)} arguments after yin, expected {n_weights + 2 * n_out}")
    given = [t for t in cots if t is not None]
    if build.on_cpu(vh, h, enc_mask, yin, *weights, *saved, *given):
        return _scan_bwd_plain(vh, h, enc_mask, yin, weights, saved, cots, lstm)
    _check_scan_inputs(vh, h, enc_mask, yin, weights, lstm)
    (bsz, t_len, l, s_dim, a_dim, st), loc = _scan_dims(vh, h, yin, weights, lstm)
    dev = vh.device
    seq_shapes = [(bsz, t_len, st), (bsz, t_len, a_dim), (bsz, t_len, l), (bsz, t_len, st)]
    for name, t, shape in zip(("s_seq", "c_seq", "alpha_seq", "mem_seq"), saved, seq_shapes):
        build.check(name, t, shape, dev)
    for name, t, shape in zip(("ds_seq", "dc_seq", "dalpha_seq", "dmem_seq"), cots, seq_shapes):
        if t is not None:
            build.check(name, t, shape, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    grads = [torch.empty_like(vh), torch.empty_like(h), torch.empty_like(yin)]
    grads += [torch.empty(w.shape, **f32) for w in weights]
    if bsz * t_len == 0:
        return tuple(g.zero_() for g in grads)
    plan_args, partials = (), 0
    if kernel.symbol in WALK_CELL:
        plan = scan_plan_on(kernel, bsz, l, s_dim, a_dim, st, *(loc or (0, 0)), dev)
        plan_args, partials = (plan.cluster, plan.rows), plan.partials(bsz)
    scratch = torch.empty(stash_floats(lstm, bsz, t_len, l, s_dim, st, *(loc or (0, 0)),
                                       partials), **f32)
    kernel.launch(
        *[build.ptr(t) for t in (vh, h, enc_mask, yin, *weights, *saved)],
        *[None if t is None else build.ptr(t) for t in cots],
        *[build.ptr(t) for t in (*grads, scratch)],
        bsz, t_len, l, s_dim, a_dim, st, *loc, *plan_args, build.stream_of(vh),
    )
    return tuple(grads)


def attention_decode_scan_loc_lstm(vh, h, enc_mask, yin, *weights):
    """vh (B,L,S); h (B,L,A); enc_mask (B,L); yin (B,T,St); weights ws_w
    (St,S), ws_b (S,), w_e (S,), c_w (A,St), c_b (St,), dec_w (2St,St),
    dec_b (St,), w_h (St,4St), w_x (St,4St), b (4St,), wconv (F,FM),
    bconv (FM,), u (FM,S). Returns (s_seq (B,T,St), c_seq (B,T,A),
    alpha_seq (B,T,L), mem_seq (B,T,St)).

    CPU tensors take the plain version; CUDA tensors the kernel (K10), on
    fwd_plan_on's plan; it raises RuntimeError where no cluster fits the
    device."""
    return _scan(KERNEL_LOC_LSTM_FWD, True, vh, h, enc_mask, yin, weights)


def attention_decode_scan_loc(vh, h, enc_mask, yin, *weights):
    """As attention_decode_scan_loc_lstm, with the GRU cell: weights ws_w,
    ws_b, w_e, c_w, c_b, dec_w, dec_b, gru_wzr (2St,2St), gru_wh (2St,St),
    wconv, bconv, u. Returns (s_seq, c_seq, alpha_seq).

    CPU tensors take the plain version; CUDA tensors the kernel (K12), on
    fwd_plan_on's plan as K10's wrapper."""
    return _scan(KERNEL_LOC_FWD, False, vh, h, enc_mask, yin, weights)


def attention_decode_scan_lstm(vh, h, enc_mask, yin, *weights):
    """As attention_decode_scan_loc_lstm, without the location term:
    weights ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_h, w_x, b. Returns
    (s_seq, c_seq, alpha_seq, mem_seq).

    CPU tensors take the plain version; CUDA tensors the kernel (K14), on
    fwd_plan_on's plan as K10's wrapper."""
    return _scan(KERNEL_LSTM_FWD, True, vh, h, enc_mask, yin, weights)


def attention_decode_scan_loc_lstm_bwd(vh, h, enc_mask, yin, *args):
    """Cotangents of attention_decode_scan_loc_lstm's differentiable
    inputs given its inputs, its four outputs and their cotangents (each
    None where there is none: it counts as zeros): (dvh, dh, dyin, dws_w,
    dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dw_h, dw_x, db, dwconv,
    dbconv, du).

    CPU tensors take the plain version; CUDA tensors the kernel (K11), on
    scan_plan_on's plan; it raises RuntimeError where no cluster fits the
    device."""
    return _scan_bwd(KERNEL_LOC_LSTM_BWD, True, 13, vh, h, enc_mask, yin, args)


def attention_decode_scan_loc_bwd(vh, h, enc_mask, yin, *args):
    """Cotangents of attention_decode_scan_loc's differentiable inputs
    given its inputs, its three outputs and their cotangents (each may be
    None): (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b,
    dgru_wzr, dgru_wh, dwconv, dbconv, du).

    CPU tensors take the plain version; CUDA tensors the kernel (K13)."""
    return _scan_bwd(KERNEL_LOC_BWD, False, 12, vh, h, enc_mask, yin, args)


def attention_decode_scan_lstm_bwd(vh, h, enc_mask, yin, *args):
    """Cotangents of attention_decode_scan_lstm's differentiable inputs
    given its inputs, its four outputs and their cotangents (each may be
    None): (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b,
    dw_h, dw_x, db).

    CPU tensors take the plain version; CUDA tensors the kernel (K15), on
    scan_plan_on's plan as K11's wrapper."""
    return _scan_bwd(KERNEL_LSTM_BWD, True, 10, vh, h, enc_mask, yin, args)


def _forward(ctx, scan, args):
    """An autograd forward of one of the scans: saves the inputs and the
    output sequences, as the JAX VJPs do, and hands a missing cotangent
    to the backward as None."""
    outs = scan(*args)
    ctx.save_for_backward(*args, *outs)
    ctx.set_materialize_grads(False)
    return outs


def _backward(ctx, scan_bwd, cots):
    vh, h, enc_mask, yin, *rest = ctx.saved_tensors
    cots = [None if c is None else c.contiguous() for c in cots]
    dvh, dh, dyin, *dw = scan_bwd(vh, h, enc_mask, yin, *rest, *cots)
    return (dvh, dh, None, dyin, *dw)


class AttentionDecodeScanLocLSTM(torch.autograd.Function):
    """attention_decode_scan_loc_lstm with its gradient: K10 forward, K11
    backward (the plain versions on CPU tensors). Saves the four output
    sequences, as the JAX VJP does (:1308-1326). enc_mask gets no
    gradient; a missing cotangent (mem_seq's always, on the training
    path, and alpha_seq's unless the loss reads alpha) reaches the
    backward as None and counts as zeros."""

    @staticmethod
    def forward(ctx, vh, h, enc_mask, yin, *weights):
        return _forward(ctx, attention_decode_scan_loc_lstm, (vh, h, enc_mask, yin, *weights))

    @staticmethod
    def backward(ctx, *cots):
        return _backward(ctx, attention_decode_scan_loc_lstm_bwd, cots)


class AttentionDecodeScanLoc(torch.autograd.Function):
    """attention_decode_scan_loc with its gradient: K12 forward, K13
    backward (the plain versions on CPU tensors). Saves s_seq, c_seq and
    alpha_seq, as the JAX VJP does (:1001-1017); enc_mask gets no
    gradient, and a missing cotangent counts as zeros."""

    @staticmethod
    def forward(ctx, vh, h, enc_mask, yin, *weights):
        return _forward(ctx, attention_decode_scan_loc, (vh, h, enc_mask, yin, *weights))

    @staticmethod
    def backward(ctx, *cots):
        return _backward(ctx, attention_decode_scan_loc_bwd, cots)


class AttentionDecodeScanLSTM(torch.autograd.Function):
    """attention_decode_scan_lstm with its gradient: K14 forward, K15
    backward (the plain versions on CPU tensors). Saves the four output
    sequences (the JAX VJP, :1246-1262, saves s, c and mem, and
    recomputes alpha); enc_mask gets no gradient, and a missing cotangent
    counts as zeros."""

    @staticmethod
    def forward(ctx, vh, h, enc_mask, yin, *weights):
        return _forward(ctx, attention_decode_scan_lstm, (vh, h, enc_mask, yin, *weights))

    @staticmethod
    def backward(ctx, *cots):
        return _backward(ctx, attention_decode_scan_lstm_bwd, cots)
