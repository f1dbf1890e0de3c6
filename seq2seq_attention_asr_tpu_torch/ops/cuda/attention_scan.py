"""Teacher-forced attention-decoder scan: forward (kernel K4) and
backward (kernel K5), joined by the autograd function
``AttentionDecodeScan``.

Replaces the Pallas kernel ``attention_decode_scan`` for the content-only
GRU decoder (seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:1156):
its forward (pallas_call :355 in ``_run_fwd`` :290, body ``_fwd_kernel``
:165 with ``_step_core`` :91) and its backward (pallas_call :851 in
``_run_bwd`` :800, body ``_bwd_kernel`` :376 / ``_bwd_core`` :419). Both
kernels are in ``csrc/attention_scan.cu``. ``attention_decode_scan_plain``
and ``attention_decode_scan_bwd_plain`` below are the same functions in
plain PyTorch; the latter follows ``_run_bwd_xla`` (:1047) step by step.

One step, from the zero state s_0 = 0:

  e     = w_e . tanh(vh + s_prev @ ws_w + ws_b)     (B, L)
  alpha = masked softmax of e                        (B, L)
  c     = alpha^T h                                  (B, A)
  r     = concat(c @ c_w + c_b, yin_t) @ dec_w + dec_b
  s     = GRU(r, s_prev), bias-free, r gate before the candidate product

Weights are the port's parameter leaves: biases and w_e are 1-D.
"""

from __future__ import annotations

import ctypes

import torch

from ..masking import masked_softmax
from . import build

KERNEL_FWD = build.Kernel(
    "attention_decode_scan_fwd", "attention_scan.cu", "attention_decode_scan_fwd",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
KERNEL_BWD = build.Kernel(
    "attention_decode_scan_bwd", "attention_scan.cu", "attention_decode_scan_bwd",
    [ctypes.c_void_p] * 31 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
WEIGHTS = ("ws_w", "ws_b", "w_e", "c_w", "c_b", "dec_w", "dec_b", "gru_wzr", "gru_wh")


def _step_core(vh, h, enc_mask, yin_t, s_prev, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b,
               gru_wzr, gru_wh):
    """One decoder step (_step_core for the GRU cell): (alpha, c, s_new)."""
    st = dec_w.shape[1]
    ws = s_prev @ ws_w + ws_b
    e = torch.tanh(vh + ws[:, None, :]) @ w_e
    alpha = masked_softmax(e, enc_mask)
    c = torch.einsum("bl,bla->ba", alpha, h)
    r = torch.cat([c @ c_w + c_b, yin_t], dim=-1) @ dec_w + dec_b
    zr = torch.sigmoid(torch.cat([s_prev, r], dim=-1) @ gru_wzr)
    zg, rg = zr[:, :st], zr[:, st:]
    cand = torch.tanh(torch.cat([rg * s_prev, r], dim=-1) @ gru_wh)
    return alpha, c, (1.0 - zg) * s_prev + zg * cand


def attention_decode_scan_plain(vh, h, enc_mask, yin, *weights):
    """Plain PyTorch twin of K4: _step_core looped over the T steps."""
    b, t_len, st = yin.shape
    s = yin.new_zeros((b, st))
    s_seq, c_seq, alpha_seq = [], [], []
    for t in range(t_len):
        alpha, c, s = _step_core(vh, h, enc_mask, yin[:, t], s, *weights)
        s_seq.append(s)
        c_seq.append(c)
        alpha_seq.append(alpha)
    return tuple(torch.stack(x, dim=1) for x in (s_seq, c_seq, alpha_seq))


def attention_decode_scan_bwd_plain(vh, h, enc_mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w,
                                    dec_b, gru_wzr, gru_wh, s_seq, c_seq, ds_seq, dc_seq,
                                    dalpha_seq):
    """Plain PyTorch twin of K5, step for step ``_run_bwd_xla``: a
    reverse-time loop that recomputes each step from the saved s (shifted
    by one, zero at step 0) and c sequences. Returns (dvh, dh, dyin,
    dws_w, dws_b, dw_e, dc_w, dc_b, ddec_w, ddec_b, dgru_wzr, dgru_wh)."""
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
        alpha = masked_softmax(a @ w_e, enc_mask)
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


def _dims(vh, h, yin):
    b, l, s_dim = vh.shape
    return b, yin.shape[1], l, s_dim, h.shape[2], yin.shape[2]


def _check_inputs(vh, h, enc_mask, yin, weights):
    b, t_len, l, s_dim, a_dim, st = _dims(vh, h, yin)
    dev = vh.device
    shapes = [(b, l, s_dim), (b, l, a_dim), (b, l), (b, t_len, st), (st, s_dim), (s_dim,),
              (s_dim,), (a_dim, st), (st,), (2 * st, st), (st,), (2 * st, 2 * st), (2 * st, st)]
    names = ("vh", "h", "enc_mask", "yin") + WEIGHTS
    for name, t, shape in zip(names, (vh, h, enc_mask, yin, *weights), shapes):
        build.check(name, t, shape, dev)


def attention_decode_scan(vh, h, enc_mask, yin, *weights):
    """vh (B,L,S) projected annotations; h (B,L,A); enc_mask (B,L); yin
    (B,T,St) = y_prev @ y_in.w + y_in.b; weights ws_w (St,S), ws_b (S,),
    w_e (S,), c_w (A,St), c_b (St,), dec_w (2St,St), dec_b (St,),
    gru_wzr (2St,2St), gru_wh (2St,St). Returns (s_seq (B,T,St), c_seq
    (B,T,A), alpha_seq (B,T,L)).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if build.on_cpu(vh, h, enc_mask, yin, *weights):
        return attention_decode_scan_plain(vh, h, enc_mask, yin, *weights)
    _check_inputs(vh, h, enc_mask, yin, weights)
    b, t_len, l, s_dim, a_dim, st = _dims(vh, h, yin)
    f32 = dict(device=vh.device, dtype=torch.float32)
    s_seq = torch.empty((b, t_len, st), **f32)
    c_seq = torch.empty((b, t_len, a_dim), **f32)
    alpha_seq = torch.empty((b, t_len, l), **f32)
    if b * t_len == 0:
        return s_seq, c_seq, alpha_seq
    KERNEL_FWD.launch(
        *[build.ptr(t) for t in (vh, h, enc_mask, yin, *weights, s_seq, c_seq, alpha_seq)],
        b, t_len, l, s_dim, a_dim, st, build.stream_of(vh),
    )
    return s_seq, c_seq, alpha_seq


def scratch_floats(b: int, t_len: int, s_dim: int, st: int) -> int:
    """Floats of K5's per-step operand and cotangent stash, (B*T) rows of
    rr, sr, cand_in (2St each), dws (S), dcc, dr (St each), da_zr (2St),
    da_cand (St) and the per-step w_e partial (S), in that order."""
    return b * t_len * (11 * st + 2 * s_dim)


def attention_decode_scan_bwd(vh, h, enc_mask, yin, ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b,
                              gru_wzr, gru_wh, s_seq, c_seq, ds_seq, dc_seq, dalpha_seq):
    """Cotangents of attention_decode_scan's differentiable inputs given
    its inputs, the saved s_seq and c_seq, and the cotangents of (s_seq,
    c_seq, alpha_seq): (dvh, dh, dyin, dws_w, dws_b, dw_e, dc_w, dc_b,
    ddec_w, ddec_b, dgru_wzr, dgru_wh).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    weights = (ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh)
    saved = (s_seq, c_seq, ds_seq, dc_seq, dalpha_seq)
    if build.on_cpu(vh, h, enc_mask, yin, *weights, *saved):
        return attention_decode_scan_bwd_plain(vh, h, enc_mask, yin, *weights, *saved)
    _check_inputs(vh, h, enc_mask, yin, weights)
    b, t_len, l, s_dim, a_dim, st = _dims(vh, h, yin)
    dev = vh.device
    for name, t, shape in zip(("s_seq", "c_seq", "ds_seq", "dc_seq", "dalpha_seq"), saved,
                              [(b, t_len, st), (b, t_len, a_dim), (b, t_len, st),
                               (b, t_len, a_dim), (b, t_len, l)]):
        build.check(name, t, shape, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    grads = [torch.empty_like(vh), torch.empty_like(h), torch.empty_like(yin)]
    grads += [torch.empty(w.shape, **f32) for w in weights]
    if b * t_len == 0:
        return tuple(g.zero_() for g in grads)
    scratch = torch.empty(scratch_floats(b, t_len, s_dim, st), **f32)
    KERNEL_BWD.launch(
        *[build.ptr(t) for t in (vh, h, enc_mask, yin, *weights, *saved, *grads, scratch)],
        b, t_len, l, s_dim, a_dim, st, build.stream_of(vh),
    )
    return tuple(grads)


class AttentionDecodeScan(torch.autograd.Function):
    """attention_decode_scan with its gradient: K4 forward, K5 backward
    (the plain versions on CPU tensors). Saves s_seq and c_seq, as the
    JAX VJP does (:1185-1189); enc_mask gets no gradient, and a missing
    cotangent of c_seq or alpha_seq counts as zeros."""

    @staticmethod
    def forward(ctx, vh, h, enc_mask, yin, *weights):
        s_seq, c_seq, alpha_seq = attention_decode_scan(vh, h, enc_mask, yin, *weights)
        ctx.save_for_backward(vh, h, enc_mask, yin, *weights, s_seq, c_seq)
        return s_seq, c_seq, alpha_seq

    @staticmethod
    def backward(ctx, ds_seq, dc_seq, dalpha_seq):
        vh, h, enc_mask, yin, *rest = ctx.saved_tensors
        dvh, dh, dyin, *dw = attention_decode_scan_bwd(
            vh, h, enc_mask, yin, *rest,
            ds_seq.contiguous(), dc_seq.contiguous(), dalpha_seq.contiguous())
        return (dvh, dh, None, dyin, *dw)
