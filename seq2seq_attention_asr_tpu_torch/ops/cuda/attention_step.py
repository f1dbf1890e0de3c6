"""One beam-search decoder step for all K hypotheses (kernels K2 and K8).

K2 replaces the Pallas kernel ``fused_attention_step``
(seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371, body
``_kernel`` :85 with the readout fused by ``_apply_readout_fused`` :40)
for the content-only GRU decoder with the maxout -> linear readout. K8
replaces its location-aware and LSTM branches (``_kernel_loc`` :116,
the LSTM branch of ``_kernel``), with the readout given as a layer list
(linear, maxout, relu; dropout is the identity in eval mode). Both are
C entry points of ``csrc/attention_step.cu``; ``fused_attention_step``
routes a configuration to one of them, and ``fused_attention_step_plain``
below is the same function in plain PyTorch, built from
ops/attention.py.

Public layout is the JAX one, (B, K, ...); the kernels read vh and h
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
KERNEL_LOC_LSTM = build.Kernel(
    "fused_attention_step_loc_lstm", "attention_step.cu", "fused_attention_step_loc_lstm",
    [ctypes.c_void_p] * 25 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
)
MAX_K = 8  # hypotheses per kernel block (csrc/attention_step.cu)
MAX_LAYERS = 4  # readout layers K8 takes, dropout dropped
LAYER_KINDS = {"linear": 0, "maxout": 1, "relu": 2}


def _readout_layers(params, cfg):
    """The readout without its dropout layers (the identity in eval mode)."""
    return [(p, s) for p, s in zip(params["readout"], cfg.readout) if s[0] != "dropout"]


def uses_k2(cfg) -> bool:
    """K2 takes the content-only GRU decoder with the maxout -> linear
    readout; every other configuration goes to K8."""
    kinds = [s[0] for s in cfg.readout if s[0] != "dropout"]
    return cfg.cell == "gru" and cfg.feature_maps == 0 and kinds == ["maxout", "linear"]


def fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask):
    """Plain PyTorch twin: ops/attention.attention_step over the
    flattened (B*K) batch, then the readout."""
    alpha_prev, s_prev, mem = state
    b, k = s_prev.shape[:2]
    flat = lambda a: a.reshape((b * k,) + a.shape[2:])
    per_hyp = lambda a: flat(a[:, None].expand((b, k) + a.shape[1:]))
    (_, _, mem_new), out = attention.attention_step(
        params, cfg, (flat(alpha_prev), flat(s_prev), flat(mem)), flat(y_prev),
        per_hyp(vh), per_hyp(h), per_hyp(enc_mask),
    )
    logp = attention.apply_readout(params, cfg, out["s"], out["c"])
    unflat = lambda a: a.reshape((b, k) + a.shape[1:])
    res = {"s": unflat(out["s"]), "c": unflat(out["c"]), "alpha": unflat(out["alpha"]),
           "logp": unflat(logp)}
    return (res["alpha"], res["s"], unflat(mem_new)), res


def fused_attention_step(params, cfg, state, y_prev, vh, h, enc_mask):
    """One decoder step over a (B, K) hypothesis grid, readout included.

    state = (alpha_prev (B,K,L), s_prev (B,K,St), mem (B,K,St)); y_prev
    one-hot (B,K,V); vh (B,L,S); h (B,L,A); enc_mask (B,L). Returns
    (new_state, {"s", "c", "alpha", "logp"}): the GRU passes mem
    through, the LSTM's new mem is its cell state.
    CPU tensors take the plain version; CUDA tensors kernel K2 (the
    content-only GRU decoder with the maxout -> linear readout) or K8
    (every other decoder). K8 raises RuntimeError on a shape whose
    buffers do not fit in one block's shared memory."""
    attention.check_ported(cfg)
    alpha_prev, s_prev, mem = state
    if build.on_cpu(alpha_prev, s_prev, mem, y_prev, vh, h, enc_mask):
        return fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask)
    b, k, st = s_prev.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_attention_step: K={k} not in [1, {MAX_K}]")
    v = cfg.output_depth
    yin = (y_prev.reshape(b * k, v) @ params["y_in"]["w"] + params["y_in"]["b"]).reshape(b, k, st)
    if uses_k2(cfg):
        return _step_k2(params, cfg, state, yin, vh, h, enc_mask)
    return _step_k8(params, cfg, state, yin, vh, h, enc_mask)


def _step_args(params, vh, h, enc_mask, yin, s_prev):
    """What K2 and K8 both take: (name, tensor, shape) in their C order."""
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim = h.shape[2]
    return [
        ("vh", vh, (b, l, s_dim)), ("h", h, (b, l, a_dim)), ("enc_mask", enc_mask, (b, l)),
        ("yin", yin.contiguous(), (b, k, st)), ("s_prev", s_prev.contiguous(), (b, k, st)),
        ("ws.w", params["ws"]["w"], (st, s_dim)), ("ws.b", params["ws"]["b"], (s_dim,)),
        ("w_e", params["w_e"], (s_dim,)),
        ("c_in.w", params["c_in"]["w"], (a_dim, st)), ("c_in.b", params["c_in"]["b"], (st,)),
        ("dec_in.w", params["dec_in"]["w"], (2 * st, st)), ("dec_in.b", params["dec_in"]["b"], (st,)),
    ]


def _outputs(b, k, l, a_dim, st, v, dev):
    f32 = dict(device=dev, dtype=torch.float32)
    return (torch.empty((b, k, l), **f32), torch.empty((b, k, a_dim), **f32),
            torch.empty((b, k, st), **f32), torch.empty((b, k, v), **f32))


def _step_k2(params, cfg, state, yin, vh, h, enc_mask):
    _, s_prev, mem = state
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim, v, dev = h.shape[2], cfg.output_depth, vh.device
    (mo, mo_spec), (lin, _) = _readout_layers(params, cfg)
    m, win = mo_spec[1], mo_spec[2]
    args = _step_args(params, vh, h, enc_mask, yin, s_prev) + [
        ("cell.w_zr", params["cell"]["w_zr"], (2 * st, 2 * st)),
        ("cell.w_h", params["cell"]["w_h"], (2 * st, st)),
        ("maxout.w", mo["w"], (st + a_dim, m * win)), ("maxout.b", mo["b"], (m * win,)),
        ("linear.w", lin["w"], (m, v)), ("linear.b", lin["b"], (v,)),
    ]
    for name, t, shape in args:
        build.check(name, t, shape, dev)
    alpha, c, s, logp = _outputs(b, k, l, a_dim, st, v, dev)
    KERNEL.launch(
        *[build.ptr(t) for _, t, _ in args],
        build.ptr(alpha), build.ptr(c), build.ptr(s), build.ptr(logp),
        b, k, l, s_dim, a_dim, st, m, win, v, build.stream_of(vh),
    )
    return (alpha, s, mem), {"s": s, "c": c, "alpha": alpha, "logp": logp}


def _step_k8(params, cfg, state, yin, vh, h, enc_mask):
    alpha_prev, s_prev, mem = state
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim, v, dev = h.shape[2], cfg.output_depth, vh.device
    lstm, loc = cfg.cell == "lstm", cfg.feature_maps > 0
    fm, f = cfg.feature_maps, cfg.filt_size
    cell = params["cell"]
    if lstm:
        # The gates are s_prev @ w_h + r @ w_x + b, two products in the
        # kernel (one on concat(s_prev, r) in attention_step.py:299-301 of
        # the JAX package).
        cell_args = [("cell.w_h", cell["w_h"], (st, 4 * st)),
                     ("cell.w_x", cell["w_x"], (st, 4 * st)), ("cell.b", cell["b"], (4 * st,))]
        state_args = [("mem", mem.contiguous(), (b, k, st))]
    else:
        cell_args = [("cell.w_zr", cell["w_zr"], (2 * st, 2 * st)),
                     ("cell.w_h", cell["w_h"], (2 * st, st)), ("cell.b", None, None)]
        state_args = [("mem", None, None)]
    if loc:
        state_args.append(("alpha_prev", alpha_prev.contiguous(), (b, k, l)))
        loc_args = [("loc_conv.w", params["loc_conv"]["w"].reshape(f, fm), (f, fm)),
                    ("loc_conv.b", params["loc_conv"]["b"], (fm,)),
                    ("u", params["u"], (fm, s_dim))]
    else:
        state_args.append(("alpha_prev", None, None))
        loc_args = [("loc_conv.w", None, None), ("loc_conv.b", None, None), ("u", None, None)]
    layers = _readout_layers(params, cfg)
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_attention_step: {len(layers)} readout layers, K8 takes 1 to "
                         f"{MAX_LAYERS}")
    ro_args, kinds, outs, wins, width = [], [], [], [], st + a_dim
    for i, (p, spec) in enumerate(layers):
        kinds.append(LAYER_KINDS[spec[0]])
        if spec[0] == "relu":
            out, win = width, 1
        else:
            out, win = spec[1], spec[2] if spec[0] == "maxout" else 1
        outs.append(out)
        wins.append(win)
        ro_args += [(f"readout[{i}].w", p.get("w"), (width, out * win)),
                    (f"readout[{i}].b", p.get("b"), (out * win,))]
        width = out
    if width != v:
        raise ValueError(f"fused_attention_step: the readout ends at width {width}, not {v}")
    # In the C entry point's order; absent tensors (the GRU's mem and gate
    # bias, the location term without it, a relu layer's weights) pass NULL.
    ins = _step_args(params, vh, h, enc_mask, yin, s_prev) + cell_args + state_args + loc_args
    for name, t, shape in ins + ro_args:
        if t is not None:
            build.check(name, t, shape, dev)
    ptr = lambda t: None if t is None else build.ptr(t).value
    alpha, c, s, logp = _outputs(b, k, l, a_dim, st, v, dev)
    mem_new = torch.empty((b, k, st), device=dev, dtype=torch.float32) if lstm else mem
    n = len(layers)
    KERNEL_LOC_LSTM.launch(
        *[ptr(t) for _, t, _ in ins],
        ptr(alpha), ptr(c), ptr(s), ptr(mem_new) if lstm else None, ptr(logp),
        n, (ctypes.c_int * n)(*kinds), (ctypes.c_int * n)(*outs), (ctypes.c_int * n)(*wins),
        (ctypes.c_void_p * n)(*[ptr(t) for _, t, _ in ro_args[0::2]]),
        (ctypes.c_void_p * n)(*[ptr(t) for _, t, _ in ro_args[1::2]]),
        int(lstm), int(loc), b, k, l, s_dim, a_dim, st, v, fm, f, build.stream_of(vh),
    )
    return (alpha, s, mem_new), {"s": s, "c": c, "alpha": alpha, "logp": logp}
