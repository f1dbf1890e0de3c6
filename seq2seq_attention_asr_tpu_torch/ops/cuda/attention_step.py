"""One beam-search decoder step for all K hypotheses (kernels K2 and K8).

K2 replaces the Pallas kernel ``fused_attention_step``
(seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371, body
``_kernel`` :85 with the readout fused by ``_apply_readout_fused`` :40)
for the content-only GRU decoder with the maxout -> linear readout. K8
replaces its location-aware and LSTM branches (``_kernel_loc`` :116,
the LSTM branch of ``_kernel``), with the readout given as a layer list
(linear, maxout, relu; dropout is the identity in eval mode). Both run
each batch row (and each group of at most MAX_K of its hypotheses,
``hyp_groups``) on a thread-block cluster of C blocks, C from
``step_plan``: each block streams 1/C of the step's weight columns
(K8's readout layers too, the last one's logits staying in the block)
and takes 1/C of the encoder positions. Both are C entry points of
``csrc/attention_step.cu``; ``fused_attention_step`` routes a
configuration to one of them, and ``fused_attention_step_plain`` below
is the same function in plain PyTorch, built from ops/attention.py.

Public layout is the JAX one, (B, K, ...); the kernels read vh and h
once per batch row for all K hypotheses.

K2 has a bf16 entry (``KERNEL_BF16``) for the bf16 model's beam: every
input bfloat16, alpha, c and s out in bf16 (the beam's state is bf16
between steps), logp float32. As the JAX kernel with bf16 inputs, it
keeps the energies, the softmax, c and the cell's math in float32 and
rounds each product's operand to bf16 (``attention_scan.step_plain``
names where); the readout takes round([s | c]), rounds each layer's
product and then its bias add (``_readout_bf16``), and only the
log-softmax is float32. K8 has a bf16 entry too (``KERNEL_LOC_LSTM_BF16``),
for its four instances, <LSTM, location>, <GRU, location>, <GRU,
content> and <LSTM, content> (conv_bilstm's, flagship_loc's, vgg's and
conv_bilstm_content's beams): the beam's state (alpha,
s, mem) arrives bf16 and is widened, alpha, c, s and mem store in bf16,
logp in float32, and it rounds where the JAX kernel with bf16 inputs
rounds (``_kernel_loc`` and the LSTM branch of ``_kernel``): the location
term's features before u, c before c_in, [cc | yin] before dec_in, r
before the gates (and the GRU's candidate), the GRU's rg s_prev before
its candidate, and the readout as K2's. It forms every one of those
operands (it folds nothing), so ``_plain_bf16`` is both its plain twin
and the plain version at the JAX kernel's rounding points.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from .. import attention
from . import attention_scan, build

KERNEL = build.Kernel(
    "fused_attention_step", "attention_step.cu", "fused_attention_step",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
KERNEL_BF16 = build.Kernel(
    "fused_attention_step_bf16", "attention_step.cu", "fused_attention_step_bf16",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
KERNEL_LOC_LSTM = build.Kernel(
    "fused_attention_step_loc_lstm", "attention_step.cu", "fused_attention_step_loc_lstm",
    [ctypes.c_void_p] * 25 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
)
KERNEL_LOC_LSTM_BF16 = build.Kernel(
    "fused_attention_step_loc_lstm_bf16", "attention_step.cu", "fused_attention_step_loc_lstm_bf16",
    [ctypes.c_void_p] * 25 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
)
MAX_K = 8  # hypotheses a cluster takes (csrc/common.cuh: kMaxK); a wider beam is cut in groups
CLUSTERS = (16, 8)  # K2's and K8's cluster sizes, largest first; 16 is a non-portable size
WARPS = 16  # warps of a block (csrc/common.cuh: kThreads / 32)
MAX_LAYERS = 4  # readout layers K8 takes, dropout dropped
LAYER_KINDS = {"linear": 0, "maxout": 1, "relu": 2}


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def hyp_groups(k: int) -> Tuple[int, int]:
    """A beam of k hypotheses as K2 and K8 cut it: (G, the largest group),
    G = ceil(k / MAX_K) balanced groups, group g the hypotheses [g k / G,
    (g + 1) k / G); each (batch row, group) runs on a cluster of its own
    (csrc/attention_step.cu: HypGroup)."""
    g = _cdiv(k, MAX_K)
    return g, _cdiv(k, g)


def _r4(n: int) -> int:
    """n rounded up to whole 16-byte groups of floats."""
    return _cdiv(n, 4) * 4


def _cspan(n: int, c: int) -> int:
    """The largest share of n items over c blocks, in groups of 4 where 4
    divides n (csrc/attention_step.cu: cspan)."""
    return _cdiv(n, c) if n % 4 else 4 * _cdiv(n // 4, c)


def step_smem_bytes(k: int, l: int, s: int, a: int, st: int, m: int, w: int, v: int,
                    c: int) -> int:
    """Shared memory of one block of K2 on clusters of c blocks, as
    csrc/attention_step.cu's step_smem_floats lays it out (K hypotheses,
    L positions, score S, annotation A, state St, maxout M groups of W,
    V outputs): the gathered vectors (ws, w_e, s_prev | r, c_in | yin,
    reset * s_prev | r, s_new | c), over which the block's logits (its
    cspan(V, c) columns) lie at the readout's end, the maxout outputs,
    the block's ceil(L / c) positions' mask and energies, the context
    partials and softmax statistics the cluster exchanges, the local
    gates, the block's bias columns, and the products' warp partials."""
    vc = _cspan(v, c)
    floats = (max(k * (7 * st + s + a) + s, k * vc) + k * m + _cdiv(l, c) * (k + 1)
              + c * k * (_cdiv(a, c) + 3) + k + k * max(2 * _cdiv(st, c), _cdiv(m, c) * w)
              + _cdiv(s, c) + 2 * _cdiv(st, c) + _cdiv(m, c) * w
              + WARPS * k * min(128, max(_cdiv(s, c), 2 * _cdiv(st, c), _cdiv(m, c) * w, vc)))
    return 4 * floats


def _vocab_cap(smem_of, smem_limit: int) -> int:
    """The largest V such that smem_of(u) <= smem_limit for every u <= V (0
    when none fits). A block's share of V, cspan(V, C), can shrink as V
    grows past a multiple of 4, so V and the multiple of 4 below it are
    both checked."""
    fits = lambda v: all(smem_of(u) <= smem_limit for u in (v, max(4 * (v // 4), 1)))
    lo, hi = 0, 1 << 26
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def step_vocab_cap(k: int, l: int, s: int, a: int, st: int, m: int, w: int, c: int,
                   smem_limit: int) -> int:
    """The largest V such that K2's block on clusters of c blocks fits
    `smem_limit` bytes for every vocabulary of V outputs or fewer."""
    return _vocab_cap(lambda v: step_smem_bytes(k, l, s, a, st, m, w, v, c), smem_limit)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    cluster: int  # blocks of a batch row's cluster
    waves: int  # rounds of resident clusters the launch takes


def step_plan(b: int, smem: Dict[int, int], smem_limit: int,
              resident: Dict[int, int]) -> StepPlan:
    """K2's or K8's plan for b clusters (a cluster a batch row and
    hypothesis group): `smem[C]` bytes a block needs on clusters of C,
    `smem_limit` the device's opt-in bytes a block, and `resident[C]` the
    clusters of C blocks the device holds at once. The largest C of
    CLUSTERS whose b clusters fit one wave; else the smallest that fits
    the device at all, in waves. RuntimeError when no cluster fits."""
    fits = [c for c in CLUSTERS if resident.get(c, 0) >= 1 and smem[c] <= smem_limit]
    if not fits:
        raise RuntimeError(
            f"fused_attention_step: no cluster of {' or '.join(map(str, CLUSTERS))} blocks fits "
            f"the device (resident clusters {resident}; shared memory a block {smem} bytes of "
            f"{smem_limit})")
    for c in fits:
        if b <= resident[c]:
            return StepPlan(c, 1)
    c = fits[-1]
    return StepPlan(c, _cdiv(b, resident[c]))


_LIMITS: Dict[tuple, Tuple[int, Dict[int, int]]] = {}


def _device_limits(device: torch.device, key: tuple, kernel: build.Kernel, symbol: str,
                   lead: tuple = ()):
    """(opt-in shared memory of a block, {C: resident clusters of C
    blocks}) from the C helper `symbol` of `kernel`'s library (called
    with the ints `lead`, C and two outputs), asked once per device and
    `key`: binding the helper reads the sources, so it is bound on the
    first ask only. A cluster size the device refuses counts 0 clusters."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (index, key) not in _LIMITS:
        out = ctypes.POINTER(ctypes.c_int)
        helper = kernel.helper(symbol, [ctypes.c_int] * (len(lead) + 1) + [out, out])
        smem, resident = 0, {}
        with torch.cuda.device(index):
            for c in CLUSTERS:
                limit, n = ctypes.c_int(0), ctypes.c_int(0)
                rc = helper(*lead, c, ctypes.byref(limit), ctypes.byref(n))
                resident[c] = n.value if rc == 0 else 0
                smem = max(smem, limit.value)
        _LIMITS[(index, key)] = (smem, resident)
    return _LIMITS[(index, key)]


def step_limits(device: torch.device) -> Tuple[int, Dict[int, int]]:
    """(opt-in shared memory of a block, {C: resident clusters of C
    blocks}) of K2 on `device`, from the ``fused_attention_step_limits``
    C helper."""
    return _device_limits(device, ("k2",), KERNEL, "fused_attention_step_limits")


def step_plan_on(b: int, k: int, l: int, s: int, a: int, st: int, m: int, w: int, v: int,
                 device: torch.device) -> StepPlan:
    """The plan K2's wrapper runs for these shapes on `device`, for either
    entry (the bf16 one's block and shared memory are the float one's):
    b times hyp_groups(k) clusters, each block sized for the largest
    group."""
    smem_limit, resident = step_limits(device)
    groups, kg = hyp_groups(k)
    smem = {c: step_smem_bytes(kg, l, s, a, st, m, w, v, c) for c in CLUSTERS}
    return step_plan(b * groups, smem, smem_limit, resident)


def readout_dims(dense, c: int) -> Tuple[int, int, int, int]:
    """K8's readout on clusters of c blocks, from its dense layers
    [(kind, out, win)] (LAYER_KINDS' linear or maxout; relu folded
    away): the widest output of a layer but the last (0 for one layer),
    the most maxout pre-activations a block holds, the most columns a
    block's share of a layer's product takes, and the most outputs a
    block takes of the last layer. Every layer is split over the blocks
    (maxout in whole groups, linear in groups of 4 where 4 divides its
    width); a layer but the last is gathered into every block, the last
    stays where it is formed (csrc/attention_step.cu: readout_dims)."""
    maxw = maxpre = cols = lastw = 0
    for i, (kind, out, win) in enumerate(dense):
        maxout = kind == LAYER_KINDS["maxout"]
        share = _cdiv(out, c) if maxout else _cspan(out, c)
        cols = max(cols, share * win)
        if maxout:
            maxpre = max(maxpre, share * win)
        if i == len(dense) - 1:
            lastw = share
        else:
            maxw = max(maxw, out)
    return maxw, maxpre, cols, lastw


def step_loc_lstm_smem_bytes(k: int, l: int, s: int, a: int, st: int, fm: int, f: int, c: int,
                             lstm: bool, dense) -> int:
    """Shared memory of one block of K8 on clusters of c blocks, for a group
    of k hypotheses, as csrc/attention_step.cu's step_loc_lstm_smem_floats
    lays it out (fm = f = 0 without the location term; `dense` the
    readout's dense layers, as readout_dims takes them), each buffer
    rounded up to 16 bytes: the gathered vectors (ws, w_e, s_prev | r,
    c_in | yin, the GRU's reset gate * s_prev, over which the block's
    logits of the readout's last layer lie, dead by then; s_new | c, two
    outputs of the readout's earlier layers), the block's ceil(L / c)
    positions' mask and energies, the context partials and softmax
    statistics the cluster exchanges, its units' gate pre-activations (or
    a maxout layer's), the LSTM's cell state, a product's early half, its
    bias columns; with the location term
    alpha_prev on the positions and their F - 1 halo, U, the taps, the
    bias and a warp's features of one hypothesis; the products' warp
    partials."""
    maxw, maxpre, cols, lastw = readout_dims(dense, c)
    loc, lstm = int(fm > 0), int(lstm)
    stc, lc = _cspan(st, c), _cdiv(l, c)
    floats = (max(_r4(k * s) + _r4(s) + 2 * _r4(2 * k * st) + (1 - lstm) * _r4(k * st),
                  _r4(k * lastw))
              + _r4(k * (st + a)) + 2 * _r4(k * maxw) + _r4(lc) + _r4(k * lc)
              + _r4(c * k * _cdiv(a, c)) + _r4(2 * c * k) + _r4(c * k) + _r4(k)
              + _r4(k * max((2 + 2 * lstm) * stc, maxpre)) + (1 + lstm) * _r4(k * stc)
              + _r4(_cspan(s, c)) + 2 * _r4(stc) + lstm * _r4(4 * stc)
              + loc * (_r4(k * (lc + f - 1)) + _r4(fm * s) + _r4(f * fm) + _r4(fm)
                       + _r4(WARPS * fm))
              + _r4(WARPS * k * min(128, max(_cspan(s, c), 2 * stc, cols))))
    return 4 * floats


def step_loc_lstm_vocab_cap(k: int, l: int, s: int, a: int, st: int, fm: int, f: int, c: int,
                            lstm: bool, dense, smem_limit: int) -> int:
    """The largest V such that K8's block on clusters of c blocks fits
    `smem_limit` bytes for every vocabulary of V outputs or fewer, the
    readout's last dense layer (`dense[-1]`, a linear or maxout layer)
    taking V outputs."""
    kind, _, win = dense[-1]
    return _vocab_cap(lambda v: step_loc_lstm_smem_bytes(k, l, s, a, st, fm, f, c, lstm,
                                                         [*dense[:-1], (kind, v, win)]),
                      smem_limit)


def step_loc_lstm_limits(device: torch.device, lstm: bool,
                         loc: bool) -> Tuple[int, Dict[int, int]]:
    """step_limits for K8's instance (lstm, loc), from the
    ``fused_attention_step_loc_lstm_limits`` C helper."""
    return _device_limits(device, ("k8", bool(lstm), bool(loc)), KERNEL_LOC_LSTM,
                          "fused_attention_step_loc_lstm_limits", (int(lstm), int(loc)))


def step_loc_lstm_plan_on(b: int, k: int, l: int, s: int, a: int, st: int, fm: int, f: int,
                          lstm: bool, dense, device: torch.device) -> StepPlan:
    """The plan K8's wrapper runs for these shapes on `device` (fm = f =
    0 without the location term): b times hyp_groups(k) clusters, each
    block sized for the largest group."""
    smem_limit, resident = step_loc_lstm_limits(device, lstm, fm > 0)
    groups, kg = hyp_groups(k)
    smem = {c: step_loc_lstm_smem_bytes(kg, l, s, a, st, fm, f, c, lstm, dense)
            for c in CLUSTERS}
    return step_plan(b * groups, smem, smem_limit, resident)


def _readout_layers(params, cfg):
    """The readout without its dropout layers (the identity in eval mode)."""
    return [(p, s) for p, s in zip(params["readout"], cfg.readout) if s[0] != "dropout"]


def k8_layers(cfg):
    """K8's readout layers, dropout dropped, as (kind, out, win) in
    LAYER_KINDS' codes: a maxout layer's groups and window, a linear
    layer's width and 1, a relu its input's width and 1."""
    width, layers = cfg.state_depth + cfg.annotation_depth, []
    for spec in cfg.readout:
        if spec[0] == "dropout":
            continue
        out, win = (width, 1) if spec[0] == "relu" else (spec[1], spec[2] if spec[0] == "maxout"
                                                          else 1)
        layers.append((LAYER_KINDS[spec[0]], out, win))
        width = out
    return layers


def k8_dense(layers):
    """The dense (linear and maxout) layers of k8_layers' list, each
    relu folded into the layer before it: what K8's plan counts."""
    return [layer for layer in layers if layer[0] != LAYER_KINDS["relu"]]


def uses_k2(cfg) -> bool:
    """K2 takes the content-only GRU decoder with the maxout -> linear
    readout; every other configuration goes to K8."""
    kinds = [s[0] for s in cfg.readout if s[0] != "dropout"]
    return cfg.cell == "gru" and cfg.feature_maps == 0 and kinds == ["maxout", "linear"]


def fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask):
    """Plain PyTorch twin: ops/attention.attention_step over the
    flattened (B*K) batch, then the readout; on bfloat16 inputs
    ``_plain_bf16``."""
    if vh.dtype == torch.bfloat16:
        return _plain_bf16(params, cfg, state, y_prev, vh, h, enc_mask)
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


def _yin(params, y_prev):
    """y_prev (B, K, V) @ y_in.w + y_in.b -> (B, K, St), in y_prev's type
    (for bf16, the product and the bias add each round to bf16)."""
    b, k, v = y_prev.shape
    return (y_prev.reshape(b * k, v) @ params["y_in"]["w"] + params["y_in"]["b"]).reshape(b, k, -1)


def _readout_bf16(params, cfg, x):
    """The readout of the bf16 entries (``_apply_readout_fused`` with dt =
    bf16) on x = round([s | c]) in float32: each linear or maxout layer
    rounds its product to bf16, then its bias add (maxout takes the max
    of such values over its window), a relu acts as it is, dropout is
    the identity; the log-softmax is float32."""
    for p, spec in _readout_layers(params, cfg):
        if spec[0] in ("linear", "maxout"):
            x = build.round_bf16(build.round_bf16(x @ p["w"].float()) + p["b"].float())
            if spec[0] == "maxout":
                x = torch.amax(x.reshape(x.shape[:-1] + (spec[1], spec[2])), dim=-1)
        elif spec[0] == "relu":
            x = torch.relu(x)
    return torch.log_softmax(x, dim=-1)


def _plain_bf16(params, cfg, state, y_prev, vh, h, enc_mask):
    """Plain twin of K2's and K8's bf16 entries (``_kernel`` and
    ``_kernel_loc`` with bf16 inputs): yin as the wrapper forms it, then
    attention_scan.step_plain on the inputs and the state widened to
    float32 with the bf16 roundings, over the flattened (B*K) batch;
    alpha, c, s (and the LSTM's mem) rounded to bf16, logp from
    _readout_bf16. The GRU's mem passes through."""
    alpha_prev, s_prev, mem = state
    b, k, st = s_prev.shape
    f = lambda a: a.float()
    flat = lambda a: f(a).reshape((b * k,) + a.shape[2:])
    per_hyp = lambda a: f(a)[:, None].expand((b, k) + a.shape[1:]).reshape((b * k,) + a.shape[1:])
    lstm = cfg.cell == "lstm"
    cell = params["cell"]
    weights = [params["ws"]["w"], params["ws"]["b"], params["w_e"], params["c_in"]["w"],
               params["c_in"]["b"], params["dec_in"]["w"], params["dec_in"]["b"]]
    weights += [cell["w_h"], cell["w_x"], cell["b"]] if lstm else [cell["w_zr"], cell["w_h"]]
    if cfg.feature_maps > 0:
        weights += [params["loc_conv"]["w"][:, 0, :], params["loc_conv"]["b"], params["u"]]
    alpha, c, s, mem_new = attention_scan.step_plain(
        per_hyp(vh), per_hyp(h), per_hyp(enc_mask), flat(_yin(params, y_prev)), flat(s_prev),
        flat(mem), flat(alpha_prev), tuple(map(f, weights)), lstm, build.round_bf16)
    logp = _readout_bf16(params, cfg, build.round_bf16(torch.cat([s, c], dim=-1)))
    unflat = lambda a: a.reshape((b, k) + a.shape[1:])
    res = {"s": unflat(s), "c": unflat(c), "alpha": unflat(alpha)}
    res = {key: val.to(torch.bfloat16) for key, val in res.items()}
    res["logp"] = unflat(logp)
    return (res["alpha"], res["s"], unflat(mem_new).to(torch.bfloat16) if lstm else mem), res


def fused_attention_step(params, cfg, state, y_prev, vh, h, enc_mask):
    """One decoder step over a (B, K) hypothesis grid, readout included.

    state = (alpha_prev (B,K,L), s_prev (B,K,St), mem (B,K,St)); y_prev
    one-hot (B,K,V); vh (B,L,S); h (B,L,A); enc_mask (B,L). Returns
    (new_state, {"s", "c", "alpha", "logp"}): the GRU passes mem
    through, the LSTM's new mem is its cell state.
    CPU tensors take the plain version; CUDA tensors kernel K2 (the
    content-only GRU decoder with the maxout -> linear readout) or K8
    (every other decoder). Both raise RuntimeError where no cluster plan
    fits the device. bfloat16 inputs (a bf16 model's beam) take K2's or
    K8's bf16 entry, or their plain twin."""
    attention.check_ported(cfg)
    alpha_prev, s_prev, mem = state
    if build.on_cpu(alpha_prev, s_prev, mem, y_prev, vh, h, enc_mask):
        return fused_attention_step_plain(params, cfg, state, y_prev, vh, h, enc_mask)
    b, k, st = s_prev.shape
    if k < 1:
        raise ValueError(f"fused_attention_step: K={k}, the beam needs a hypothesis")
    yin = _yin(params, y_prev)
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


def _outputs(b, k, l, a_dim, st, v, dev, dtype=torch.float32):
    """alpha, c and s in `dtype`, logp in float32."""
    io = dict(device=dev, dtype=dtype)
    return (torch.empty((b, k, l), **io), torch.empty((b, k, a_dim), **io),
            torch.empty((b, k, st), **io), torch.empty((b, k, v), device=dev, dtype=torch.float32))


def _step_k2(params, cfg, state, yin, vh, h, enc_mask):
    _, s_prev, mem = state
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim, v, dev, dt = h.shape[2], cfg.output_depth, vh.device, build.io_dtype(vh)
    kernel = KERNEL_BF16 if dt == torch.bfloat16 else KERNEL
    (mo, mo_spec), (lin, _) = _readout_layers(params, cfg)
    m, win = mo_spec[1], mo_spec[2]
    args = _step_args(params, vh, h, enc_mask, yin, s_prev) + [
        ("cell.w_zr", params["cell"]["w_zr"], (2 * st, 2 * st)),
        ("cell.w_h", params["cell"]["w_h"], (2 * st, st)),
        ("maxout.w", mo["w"], (st + a_dim, m * win)), ("maxout.b", mo["b"], (m * win,)),
        ("linear.w", lin["w"], (m, v)), ("linear.b", lin["b"], (v,)),
    ]
    for name, t, shape in args:
        build.check(name, t, shape, dev, dt)
    plan = step_plan_on(b, k, l, s_dim, a_dim, st, m, win, v, dev)
    alpha, c, s, logp = _outputs(b, k, l, a_dim, st, v, dev, dt)
    kernel.launch(
        *[build.ptr(t) for _, t, _ in args],
        build.ptr(alpha), build.ptr(c), build.ptr(s), build.ptr(logp),
        b, k, l, s_dim, a_dim, st, m, win, v, plan.cluster, build.stream_of(vh),
    )
    return (alpha, s, mem), {"s": s, "c": c, "alpha": alpha, "logp": logp}


def _step_k8(params, cfg, state, yin, vh, h, enc_mask):
    alpha_prev, s_prev, mem = state
    b, k, st = s_prev.shape
    _, l, s_dim = vh.shape
    a_dim, v, dev, dt = h.shape[2], cfg.output_depth, vh.device, build.io_dtype(vh)
    kernel = KERNEL_LOC_LSTM_BF16 if dt == torch.bfloat16 else KERNEL_LOC_LSTM
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
    spec = k8_layers(cfg)
    ro_args, width = [], st + a_dim
    for i, ((p, _), (_, out, win)) in enumerate(zip(layers, spec)):
        ro_args += [(f"readout[{i}].w", p.get("w"), (width, out * win)),
                    (f"readout[{i}].b", p.get("b"), (out * win,))]
        width = out
    if width != v:
        raise ValueError(f"fused_attention_step: the readout ends at width {width}, not {v}")
    dense = k8_dense(spec)
    if not dense:
        raise ValueError("fused_attention_step: the readout has no linear or maxout layer; K8 "
                         "takes at least one")
    kinds, outs, wins = zip(*spec)
    # In the C entry point's order; absent tensors (the GRU's mem and gate
    # bias, the location term without it, a relu layer's weights) pass NULL.
    ins = _step_args(params, vh, h, enc_mask, yin, s_prev) + cell_args + state_args + loc_args
    for name, t, shape in ins + ro_args:
        if t is not None:
            build.check(name, t, shape, dev, dt)
    ptr = lambda t: None if t is None else build.ptr(t).value
    # The bf16 entry's block and shared memory are the float one's: its plan.
    plan = step_loc_lstm_plan_on(b, k, l, s_dim, a_dim, st, fm if loc else 0, f if loc else 0,
                                 lstm, dense, dev)
    alpha, c, s, logp = _outputs(b, k, l, a_dim, st, v, dev, dt)
    mem_new = torch.empty((b, k, st), device=dev, dtype=dt) if lstm else mem
    n = len(layers)
    kernel.launch(
        *[ptr(t) for _, t, _ in ins],
        ptr(alpha), ptr(c), ptr(s), ptr(mem_new) if lstm else None, ptr(logp),
        n, (ctypes.c_int * n)(*kinds), (ctypes.c_int * n)(*outs), (ctypes.c_int * n)(*wins),
        (ctypes.c_void_p * n)(*[ptr(t) for _, t, _ in ro_args[0::2]]),
        (ctypes.c_void_p * n)(*[ptr(t) for _, t, _ in ro_args[1::2]]),
        int(lstm), int(loc), b, k, l, s_dim, a_dim, st, v, fm, f, plan.cluster,
        build.stream_of(vh),
    )
    return (alpha, s, mem_new), {"s": s, "c": c, "alpha": alpha, "logp": logp}
