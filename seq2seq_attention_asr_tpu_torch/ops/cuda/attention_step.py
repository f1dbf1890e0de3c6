"""One beam-search decoder step for all K hypotheses (kernel K2).

Replaces the Pallas kernel ``fused_attention_step``
(seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371, body
``_kernel`` :85 with the readout fused by ``_apply_readout_fused`` :40)
for the content-only GRU decoder. The CUDA source is
``csrc/attention_step.cu``; ``fused_attention_step_plain`` below is
the same function in plain PyTorch, built from ops/attention.py.

Public layout is the JAX one, (B, K, ...); the kernel reads vh and h
once per batch row for all K hypotheses.
"""

from __future__ import annotations

import ctypes

import torch

from .. import attention
from . import build

KERNEL = build.Kernel(
    "fused_attention_step", "attention_step.cu", "fused_attention_step",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
MAX_K = 8  # hypotheses per kernel block (csrc/attention_step.cu)


def _readout_layers(params, cfg):
    """The readout as the kernel takes it: maxout then linear, dropout
    layers dropped (eval mode). Anything else is refused."""
    layers = [(p, s) for p, s in zip(params["readout"], cfg.readout) if s[0] != "dropout"]
    kinds = [s[0] for _, s in layers]
    if kinds != ["maxout", "linear"]:
        raise NotImplementedError(f"fused readout takes maxout -> linear, got {cfg.readout}")
    return layers


def fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask):
    """Plain PyTorch twin: ops/attention.attention_step over the
    flattened (B*K) batch, then the readout."""
    alpha_prev, s_prev, mem = state
    b, k = s_prev.shape[:2]
    flat = lambda a: a.reshape((b * k,) + a.shape[2:])
    per_hyp = lambda a: flat(a[:, None].expand((b, k) + a.shape[1:]))
    _, out = attention.attention_step(
        params, (flat(alpha_prev), flat(s_prev), flat(mem)), flat(y_prev),
        per_hyp(vh), per_hyp(h), per_hyp(enc_mask),
    )
    logp = attention.apply_readout(params, cfg, out["s"], out["c"])
    unflat = lambda a: a.reshape((b, k) + a.shape[1:])
    res = {"s": unflat(out["s"]), "c": unflat(out["c"]), "alpha": unflat(out["alpha"]),
           "logp": unflat(logp)}
    return (res["alpha"], res["s"], mem), res


def fused_attention_step(params, cfg, state, y_prev, vh, h, enc_mask):
    """One decoder step over a (B, K) hypothesis grid, readout included.

    state = (alpha_prev (B,K,L), s_prev (B,K,St), mem (B,K,St)); y_prev
    one-hot (B,K,V); vh (B,L,S); h (B,L,A); enc_mask (B,L). Returns
    (new_state, {"s", "c", "alpha", "logp"}); mem passes through.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    attention.check_ported(cfg)
    alpha_prev, s_prev, mem = state
    if build.on_cpu(s_prev, y_prev, vh, h, enc_mask):
        return fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask)
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim = h.shape[2]
    v = cfg.output_depth
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_attention_step: K={k} not in [1, {MAX_K}]")
    (mo, mo_spec), (lin, _) = _readout_layers(params, cfg)
    m, win = mo_spec[1], mo_spec[2]
    dev = vh.device
    yin = (y_prev.reshape(b * k, v) @ params["y_in"]["w"] + params["y_in"]["b"]).reshape(b, k, st)
    args = [
        ("vh", vh, (b, l, s_dim)), ("h", h, (b, l, a_dim)), ("enc_mask", enc_mask, (b, l)),
        ("yin", yin.contiguous(), (b, k, st)), ("s_prev", s_prev.contiguous(), (b, k, st)),
        ("ws.w", params["ws"]["w"], (st, s_dim)), ("ws.b", params["ws"]["b"], (s_dim,)),
        ("w_e", params["w_e"], (s_dim,)),
        ("c_in.w", params["c_in"]["w"], (a_dim, st)), ("c_in.b", params["c_in"]["b"], (st,)),
        ("dec_in.w", params["dec_in"]["w"], (2 * st, st)), ("dec_in.b", params["dec_in"]["b"], (st,)),
        ("cell.w_zr", params["cell"]["w_zr"], (2 * st, 2 * st)),
        ("cell.w_h", params["cell"]["w_h"], (2 * st, st)),
        ("maxout.w", mo["w"], (st + a_dim, m * win)), ("maxout.b", mo["b"], (m * win,)),
        ("linear.w", lin["w"], (m, v)), ("linear.b", lin["b"], (v,)),
    ]
    for name, t, shape in args:
        build.check(name, t, shape, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    alpha = torch.empty((b, k, l), **f32)
    c = torch.empty((b, k, a_dim), **f32)
    s = torch.empty((b, k, st), **f32)
    logp = torch.empty((b, k, v), **f32)
    KERNEL.launch(
        *[build.ptr(t) for _, t, _ in args],
        build.ptr(alpha), build.ptr(c), build.ptr(s), build.ptr(logp),
        b, k, l, s_dim, a_dim, st, m, win, v, build.stream_of(vh),
    )
    return (alpha, s, mem), {"s": s, "c": c, "alpha": alpha, "logp": logp}
