#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: PCM -> text serving
and training of the flagship Chorowski model through its six CUDA
kernels.

    python3 chip_smoke.py

Phases, each fatal when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the six kernels from csrc/ (one nvcc per source, in parallel);
  3. hold each kernel to its plain PyTorch version through its public
     wrapper: K1-K3 at the serving shapes, batch 1 and 8 (max abs error
     1e-4); K4 (1e-4 abs) and K5, K6 (max|got - plain| <= 5e-4 *
     max|plain| + 5e-5 for each output) at the training shape, B = 16,
     L = 144, T = 56, encoder lengths ragged in 96-144 and label lengths
     in 20-56;
  4. serve 3.5 s of PCM with seeded random flagship weights: exact=False
     at batch 1 and 8 (kernels K1, K2, K3), exact=True at batch 1 (K1,
     K2), with the launch counts zeroed just before each request;
  5. the same requests on the CPU: tokens equal, scores within 5e-3, and
     one fused_attention_step launch per beam step the CPU run took; then
     two more requests at exact=False batch 8 with the readout's eos
     bias raised, so that hypotheses finish on eos and the beam stops
     early;
  6. train the recipe timit_chorowski_normnll_colnorm at full width
     (orthogonal init from seed 0, one seeded batch at the training
     shape): 3 steps on the card with the launch counts zeroed before
     each step and exactly 3 / 3 / 1 / 1 launches of K1 / K6 / K4 / K5
     (none of K2, K3) after it, the same 3 steps on the CPU (loss, nll,
     grad_norm and param_norm within rtol 1e-3), then 30 more card steps,
     the last with a lower loss than the first;
  7. kernel (device), wrapper-call, plain-version and bound times per kernel;
  8. the p50 request latency over 10 requests, and the device idle share:
     1 - (device time of one request) / p50; the p50 train step over 10
     steps after 3 warm-up steps at B = 16 and 128, audio seconds per
     second, the device time of one step and its idle share;
  9. one {"kernels": [...]} JSON line, the card line, and the last line
     {"ok": true, "device": {...}}.

It exits nonzero without a card, and imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SR = 16000
PCM_SECONDS = 3.5
BEAM_K = 5
EOS_ID = 61  # the TIMIT recipe's <EOS>, the last of its 62 outputs
# Added to the readout's eos logit in the "eos" requests. With seed 0,
# 0.2 makes one hypothesis per sample finish on eos at the first step and
# the rest run to max_steps; 0.3 makes every hypothesis finish on eos and
# the beam leave its loop after two steps.
EOS_BIASES = (0.2, 0.3)
PAD_FRAMES = 10  # zero frames at both ends, as the TIMIT pipeline adds
TOL = 1e-4  # kernel vs plain version, max abs error
SCORE_TOL = 5e-3  # card vs CPU beam scores (sums of ~130 log-probs)
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32
# outside the tensor cores, and HBM3 bandwidth. The kernels compute in
# float32 on the CUDA cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Training: the padded TIMIT shapes (L frames, T labels), the recipe's
# batch, and the larger batch the train step is also timed at.
TRAIN_L, TRAIN_T, TRAIN_B, BIG_B = 144, 56, 16, 128
TRAIN_RTOL = 1e-3  # card vs CPU train-step metrics
MORE_STEPS = 30
HOP = 512  # samples per frame at 16 kHz: audio seconds of a batch = B * L * HOP / SR
STEP_LAUNCHES = {"bigru_scan2": 3, "bigru_scan2_bwd": 3, "attention_decode_scan_fwd": 1,
                 "attention_decode_scan_bwd": 1, "fused_attention_step": 0,
                 "stft_logmel_power": 0}
# Device kernels of a train step, by the name each carries in a trace.
STEP_KERNELS = ("bigru_scan2_bwd_kernel", "bigru_scan2_kernel", "scan_fwd_kernel",
                "scan_bwd_kernel", "atb_kernel")

REPLACES = {
    "bigru_scan2": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:666",
    "fused_attention_step": "seq2seq_attention_asr_tpu/ops/pallas/attention_step.py:371",
    "stft_logmel_power": "seq2seq_attention_asr_tpu/ops/pallas/logmel.py:119",
    "bigru_scan2_bwd": "seq2seq_attention_asr_tpu/ops/pallas/gru_scan.py:716",
    "attention_decode_scan_fwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:355",
    "attention_decode_scan_bwd": "seq2seq_attention_asr_tpu/ops/pallas/attention_scan.py:851",
}
SOURCES = {
    "bigru_scan2": "seq2seq_attention_asr_tpu_torch/csrc/bigru_scan2.cu",
    "fused_attention_step": "seq2seq_attention_asr_tpu_torch/csrc/attention_step.cu",
    "stft_logmel_power": "seq2seq_attention_asr_tpu_torch/csrc/logmel.cu",
    "bigru_scan2_bwd": "seq2seq_attention_asr_tpu_torch/csrc/bigru_scan2_bwd.cu",
    "attention_decode_scan_fwd": "seq2seq_attention_asr_tpu_torch/csrc/attention_scan.cu",
    "attention_decode_scan_bwd": "seq2seq_attention_asr_tpu_torch/csrc/attention_scan.cu",
}
NO_LIBRARY = {
    "bigru_scan2": "cuDNN's GRU carries biases and applies the reset gate after its matmul",
    "fused_attention_step": "no PyTorch call computes the attention step with its readout",
    "stft_logmel_power": "torch.stft gives the spectrum only, not the mel dB and energy",
    "bigru_scan2_bwd": "no PyTorch call computes the bias-free, reset-before-matmul GRU backward",
    "attention_decode_scan_fwd": "no PyTorch call computes the attention decoder scan",
    "attention_decode_scan_bwd": "no PyTorch call computes the attention decoder scan's backward",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_pcm(n_utt: int, seed: int) -> list:
    """Speech-like test PCM: a few drifting harmonics under a syllable-
    rate envelope, plus noise."""
    rng = np.random.RandomState(seed)
    n = int(PCM_SECONDS * SR)
    t = np.arange(n) / SR
    pcms = []
    for _ in range(n_utt):
        f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 6)))
        x = 0.2 * env * voiced + 0.02 * rng.randn(n)
        pcms.append(x.astype(np.float32))
    return pcms


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of `fn` over `iters` back-to-back calls (CUDA events):
    the device's time, or the host's where the host is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, symbols, iters: int) -> float:
    """Mean device time of one call of `fn`, from a profiler trace of
    `iters` calls: the summed time of the device kernels whose names hold
    one of `symbols` (a C entry point may start more than one), without
    the Python wrapper's time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = 0.0
    for symbol in symbols:
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and symbol in e.name]
        # The trace may drop a record now and then; the mean is over those kept.
        if not 0.9 * iters <= len(durs) <= iters:
            raise SystemExit(f"profiler saw {len(durs)} launches of {symbol}, expected {iters}")
        ms += sum(durs) / len(durs) / 1e3
    return ms


def bound(flops: float, nbytes: float):
    """Least time on this card for the work: (ms, "operations"|"bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def cpu_transcribe(tr, pcms):
    """The CPU run of Transcriber `tr` and the number of decoder steps
    its beam took: calls of the step function, which on CPU tensors runs
    the plain version and launches nothing."""
    from seq2seq_attention_asr_tpu_torch.decode import beam

    step, calls = beam.fused_attention_step, []

    def counted(*args):
        calls.append(1)
        return step(*args)

    beam.fused_attention_step = counted
    try:
        with torch.no_grad():
            out = tr.transcribe(pcms)
    finally:
        beam.fused_attention_step = step
    return out, len(calls)


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def bwd_err(got, want) -> float:
    """The backward tolerance's measure: the largest, over the output
    tensors, of max|got - plain| - 5e-4 * max|plain|; it must be at most
    5e-5 (sums over B*L or B*T rows are taken in another order)."""
    return max(float((g - w).abs().max()) - 5e-4 * float(w.abs().max())
               for g, w in zip(got, want))


class Case:
    """Inputs of one kernel at the shapes of its path, its wrapper, its
    plain version, the device kernels its entry point starts, and what
    the work costs at the least. A backward case is held to bwd_err."""

    def __init__(self, name, symbols, kernel, plain, args, flops, nbytes, backward=False):
        self.name, self.symbols, self.kernel, self.plain, self.args = name, symbols, kernel, plain, args
        self.flops, self.nbytes, self.backward = flops, nbytes, backward

    def check(self, got, want, tag: str) -> float:
        """Max abs error of the kernel against the plain version; exits
        when it is out of tolerance or not finite."""
        err = max_err(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if self.backward:
            excess = bwd_err(got, want)
            ok, tol = excess <= 5e-5, f"max|plain| * 5e-4 + 5e-5, excess {excess:.3e}"
        else:
            ok, tol = err <= TOL, f"{TOL}"
        print(f"parity {self.name} {tag}: max_abs_err={err:.3e} (tol {tol}), finite={finite}")
        if not finite or not ok:
            raise SystemExit(f"{self.name} {tag} disagrees with its plain version")
        return err


def cases(params, cfg, b: int, gen: torch.Generator):
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step, gru_scan, logmel

    dev = torch.device("cuda")
    n_frames = 1 + int(PCM_SECONDS * SR) // 512
    l_pad = -(-n_frames // 16) * 16
    l_enc = l_pad + 20  # pad_frames = 10 at both ends
    lens = torch.full((b,), n_frames + 20, device=dev)
    valid = (torch.arange(l_enc, device=dev)[None] < lens[:, None]).float()
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)

    # K1 at the first encoder layer.
    enc = params["encoder"]["bigru1"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    x = rnd(b, l_enc, cfg.input_frame_size) * valid[:, :, None]
    xf = cells.gru_input_proj(enc["fwd"], x).contiguous()
    xb = cells.gru_input_proj(enc["bwd"], x).contiguous()
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    k1 = Case(
        "bigru_scan2", ("bigru_scan2_kernel",), gru_scan.bigru_scan2, gru_scan.bigru_scan2_plain,
        (xf, xb, wzr2, wh2),
        flops=2 * b * l_enc * (6 * hd * hd + 12 * hd),
        nbytes=4 * (2 * b * l_enc * 3 * hd + 2 * 3 * hd * hd + 2 * b * l_enc * hd),
    )

    # K2 at a beam step.
    dec = params["decoder"]
    acfg = cfg.attention_config()
    a, s_dim, st, v = acfg.annotation_depth, acfg.score_depth, acfg.state_depth, acfg.output_depth
    h = rnd(b, l_enc, a) * valid[:, :, None]
    vh = attention.precompute_vh(dec, h).contiguous()
    alpha0 = torch.softmax(rnd(b, BEAM_K, l_enc), -1)
    s0 = rnd(b, BEAM_K, st) * 0.3
    y = torch.nn.functional.one_hot(
        torch.randint(0, v, (b, BEAM_K), generator=gen), v).float().to(dev)
    state = (alpha0, s0, torch.zeros_like(s0))
    step_args = (dec, acfg, state, y, vh, h, valid)
    mo_w = dec["readout"][-2]["w"]
    read = [dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
            dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"],
            *[t for layer in dec["readout"] for t in layer.values()]]
    w_bytes = 4 * sum(t.numel() for t in read)  # the weights the kernel reads
    mvs = (st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st + mo_w.numel()
           + cfg.mlp_depth * v)
    k2 = Case(
        "fused_attention_step", ("attention_step_kernel",),
        lambda *args: _step_outputs(attention_step.fused_attention_step(*args)),
        lambda *args: _step_outputs(attention_step.fused_attention_step_plain(*args)),
        step_args,
        flops=b * BEAM_K * (4 * l_enc * s_dim + 2 * l_enc * a + 2 * mvs),
        nbytes=4 * (b * l_enc * (s_dim + a + 1) + 2 * b * BEAM_K * st
                    + b * BEAM_K * (l_enc + a + st + v)) + w_bytes,
    )

    # K3 on a bucket of 3.5 s utterances, reflect-padded as logmel_fused does.
    n_samp = l_pad * 512 - 1
    y_pcm = rnd(b, n_samp) * 0.1
    yp = torch.nn.functional.pad(y_pcm[:, None], (1024, 1024), mode="reflect")[:, 0].contiguous()
    _, melw, lo, hi = logmel._consts(SR, str(dev))
    taps = int((hi - lo).sum())  # the kernel reads each filter's [lo, hi) only
    frames = 1 + (yp.shape[1] - 2048) // 512
    fft = 2.5 * 2048 * math.log2(2048)  # real-input FFT
    k3 = Case(
        "stft_logmel_power", ("stft_logmel_kernel",),
        lambda yp_: logmel.stft_logmel_power(yp_, SR),
        lambda yp_: logmel.stft_logmel_power_plain(yp_, SR),
        (yp,),
        flops=b * frames * (fft + 3 * 1025 + 2 * int((melw != 0).sum()) + 1025 + 2 * 128),
        nbytes=4 * (yp.numel() + 2048 + taps + lo.numel() + hi.numel() + b * frames * 129),
    )
    return [k1, k2, k3]


def _step_outputs(res):
    (_, _, _), out = res
    return out["alpha"], out["c"], out["s"], out["logp"]


def train_batch(b: int, seed: int):
    """One padded training batch (x, x_len, y, dec_mask) at the training
    shape, on the CPU: seeded features, encoder lengths ragged in
    96..L and label lengths in 20..T (the first row at full length)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, TRAIN_L, 123).astype(np.float32)
    x_len = rng.randint(96, TRAIN_L + 1, b)
    labels = rng.randint(20, TRAIN_T + 1, b)
    x_len[0], labels[0] = TRAIN_L, TRAIN_T
    y = rng.randint(0, 62, (b, TRAIN_T))
    dec_mask = (np.arange(TRAIN_T)[None] < labels[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, x_len.astype(np.int64), y, dec_mask))


def train_cases(params, cfg, batch, gen: torch.Generator):
    """K6, K4 and K5 at the training shape, for the model of `cfg` with
    weights `params`: K6 on the first encoder layer's projections of the
    batch, K4 and K5 on the batch's encoder output (computed without
    gradient), with random cotangents."""
    from seq2seq_attention_asr_tpu_torch.models import chorowski
    from seq2seq_attention_asr_tpu_torch.ops import attention, cells, readout
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
    from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

    dev = torch.device("cuda")
    x, x_len, y, dec_mask = (t.to(dev) for t in batch)
    b, l, _ = x.shape
    t_len = y.shape[1]
    enc_mask = length_mask(x_len, l)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)

    # K6 at the first encoder layer: inputs zero past each row's length,
    # as bigru_layer hands them over, and so are the output cotangents.
    enc = params["encoder"]["bigru1"]
    hd = enc["fwd"]["w_zr"].shape[1] // 2
    xm = x * enc_mask[:, :, None]
    xf = cells.gru_input_proj(enc["fwd"], xm).contiguous()
    xb = cells.gru_input_proj(enc["bwd"], xm).contiguous()
    wzr2 = torch.stack([enc["fwd"]["w_zr"][:hd], enc["bwd"]["w_zr"][:hd]]).contiguous()
    wh2 = torch.stack([enc["fwd"]["w_h"][:hd], enc["bwd"]["w_h"][:hd]]).contiguous()
    with torch.no_grad():
        ysf, ysb = gru_scan.bigru_scan2_plain(xf, xb, wzr2, wh2)
    dys = [rnd(b, l, hd) * enc_mask[:, :, None] for _ in range(2)]
    rows = b * l
    k6 = Case(
        "bigru_scan2_bwd", ("bigru_scan2_bwd_kernel", "atb_kernel"), gru_scan.bigru_scan2_bwd,
        gru_scan.bigru_scan2_bwd_plain, (xf, xb, wzr2, wh2, ysf, ysb, *dys),
        # Per row step and direction: the two recompute products (6 H^2),
        # the two transposed products (6 H^2), the weight-gradient outer
        # products (6 H^2) and ~30 H elementwise.
        flops=2 * rows * (18 * hd * hd + 30 * hd),
        nbytes=4 * (2 * rows * 3 * hd + 4 * rows * hd + 2 * 3 * hd * hd  # inputs
                    + 2 * rows * 3 * hd + 2 * 3 * hd * hd),  # dx and dW
        backward=True,
    )

    # K4 and K5 on the encoder output of the batch.
    dec = params["decoder"]
    with torch.no_grad():
        h = chorowski.encode(params, cfg, x, x_len).contiguous()
        vh = attention.precompute_vh(dec, h).contiguous()
        onehot = (torch.nn.functional.one_hot(y.long(), cfg.output_depth).float()
                  * dec_mask[..., None])
        y_prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], dim=1)
        yin = readout.linear_apply(dec["y_in"], y_prev).contiguous()
    weights = (dec["ws"]["w"], dec["ws"]["b"], dec["w_e"], dec["c_in"]["w"], dec["c_in"]["b"],
               dec["dec_in"]["w"], dec["dec_in"]["b"], dec["cell"]["w_zr"], dec["cell"]["w_h"])
    s_dim, a, st = vh.shape[2], h.shape[2], yin.shape[2]
    scan_args = (vh, h, enc_mask, yin, *weights)
    w_floats = sum(w.numel() for w in weights)
    steps = b * t_len
    # One step's weight products (s -> Ws, c_in, dec_in, the gates, the
    # candidate), as multiply-adds.
    step_mv = st * s_dim + a * st + 2 * st * st + 4 * st * st + 2 * st * st
    in_floats = b * l * (s_dim + a + 1) + steps * st + w_floats
    k4 = Case(
        "attention_decode_scan_fwd", ("scan_fwd_kernel",), attention_scan.attention_decode_scan,
        attention_scan.attention_decode_scan_plain, scan_args,
        # Per step: energies (add, tanh, multiply-add) 4 L S, context 2 L A,
        # the weight products, softmax ~5 L and ~10 St elementwise.
        flops=steps * (4 * l * s_dim + 2 * l * a + 2 * step_mv + 5 * l + 10 * st),
        nbytes=4 * (in_floats + steps * (st + a + l)),
    )
    with torch.no_grad():
        s_seq, c_seq, _ = attention_scan.attention_decode_scan_plain(*scan_args)
    cot = (rnd(b, t_len, st) * dec_mask[..., None], rnd(b, t_len, a) * dec_mask[..., None],
           rnd(b, t_len, l) * dec_mask[..., None])
    k5 = Case(
        "attention_decode_scan_bwd", ("scan_bwd_kernel", "atb_kernel"),
        attention_scan.attention_decode_scan_bwd, attention_scan.attention_decode_scan_bwd_plain,
        (*scan_args, s_seq, c_seq, *cot),
        # Per step: the recompute (the forward's work without the
        # context), the energies' backward (~6 L S), the context's backward
        # (4 L A), the softmax's (~4 L), and the same weight products
        # twice more, transposed and as weight-gradient outer products.
        flops=steps * (4 * l * s_dim + 5 * l + 10 * st + 6 * l * s_dim + 4 * l * a + 4 * l
                       + 3 * 2 * step_mv),
        nbytes=4 * (in_floats + steps * (2 * st + 2 * a + l)  # inputs, saved and cotangents
                    + b * l * (s_dim + a) + steps * st + w_floats),  # dvh, dh, dyin, dW
        backward=True,
    )
    return [k6, k4, k5]


def make_trainer(params_cpu, device: str):
    """The recipe's train state and step on `device`, from the CPU
    weights `params_cpu`."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    exp = experiment.timit_chorowski_normnll_colnorm()
    model = exp.build_model()
    tx = optim.build_optimizer(exp.optim)
    init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                               model.output_depth)
    return init_fn(interop.to_torch(params_cpu, device), torch.Generator().manual_seed(SEED)), step_fn


def train_phase(kernels, params_cpu, card: str):
    """Phase 6: 3 steps on the card and on the CPU, the launch counts of
    each card step, then 30 more card steps. Returns the launch counts
    of the first card step."""
    batch = train_batch(TRAIN_B, SEED + 3)
    runs, first_counts = {}, None
    for dev in ("cuda", "cpu"):
        state, step_fn = make_trainer(params_cpu, dev)
        b = tuple(t.to(dev) for t in batch)
        runs[dev] = []
        for i in range(3):
            for k in kernels.values():
                k.launches = 0
            state, m = step_fn(state, b)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = {n: k.launches for n, k in kernels.items()}
                print(f"train step {i + 1} on the card: launches {counts}")
                if counts != STEP_LAUNCHES:
                    raise SystemExit(f"train step: launch counts {counts}, expected {STEP_LAUNCHES}")
                first_counts = first_counts or counts
            runs[dev].append({k: float(v) for k, v in m.items()})
        if dev == "cuda":
            card_state, card_step, card_batch = state, step_fn, b
    for i, (got, want) in enumerate(zip(runs["cuda"], runs["cpu"])):
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "nll", "grad_norm", "param_norm")}
        print(f"train step {i + 1}: card {got}, CPU {want}, relative differences "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tol {TRAIN_RTOL})")
        if not all(np.isfinite(v) for v in got.values()) or max(rel.values()) > TRAIN_RTOL:
            raise SystemExit(f"train step {i + 1}: the card disagrees with the CPU run")
    losses = [r["loss"] for r in runs["cuda"]]
    for _ in range(MORE_STEPS):
        card_state, m = card_step(card_state, card_batch)
        losses.append(float(m["loss"]))
    print(f"train: loss over {len(losses)} card steps on one batch: first {losses[0]:.6f}, "
          f"last {losses[-1]:.6f}, every fifth {[round(v, 6) for v in losses[::5]]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit("train: the loss did not fall")
    return first_counts


def train_timing(params_cpu, b: int, card: str) -> None:
    """Phase 8 for training: p50 of 10 steps after 3 warm-up steps, audio
    seconds per second, the device time of one profiled step (device
    activity only) and the idle share 1 - device / p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, step_fn = make_trainer(params_cpu, "cuda")
    batch = tuple(t.cuda() for t in train_batch(b, SEED + 5))
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    p50 = statistics.median(lat)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    idle = f"{1 - busy / p50:.4f}" if dev_events else "not measured"
    audio_s = b * TRAIN_L * HOP / SR
    print(f"train step B={b} L={TRAIN_L} T={TRAIN_T}: p50 {p50:.2f} ms (min {min(lat):.2f}, "
          f"max {max(lat):.2f}) over 10 steps; {audio_s / (p50 / 1e3):.1f} audio s/s "
          f"({audio_s:.3f} s of audio per step); device busy {busy:.2f} ms in {len(dev_events)} "
          f"device ops of one profiled step, idle share 1 - busy/p50 = {idle}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB ({card})")
    # The step's device time by kernel; atb_kernel is the weight-gradient
    # reduction of both K5 (one launch) and K6 (three).
    groups = {}
    for e in dev_events:
        key = next((s for s in STEP_KERNELS if s in e.name), "other device ops")
        n, ms = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    print(f"train step B={b}: device time by kernel: " + ", ".join(
        f"{key} {ms:.2f} ms in {n} ({ms / busy:.1%})"
        for key, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from seq2seq_attention_asr_tpu_torch import interop, serve
    from seq2seq_attention_asr_tpu_torch.data import features
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step, build,
                                                          gru_scan, logmel)
    from seq2seq_attention_asr_tpu_torch.train import experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")

    kernels = {k.name: k for k in (gru_scan.KERNEL, attention_step.KERNEL, logmel.KERNEL,
                                   gru_scan.KERNEL_BWD, attention_scan.KERNEL_FWD,
                                   attention_scan.KERNEL_BWD)}
    t0 = time.perf_counter()
    build.build_all(kernels.values())
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(kernels)} kernels")
    for k in kernels.values():
        took = "already built" if k.build_seconds is None else f"{k.build_seconds:.1f} s"
        print(f"build {k.name} ({k.source.name}): {took}")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    model = registry.build("chorowski")
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(SEED), device="cuda")
    # The training recipe's weights: orthogonal init from the seed, on the CPU.
    train_params = experiment.timit_chorowski_normnll_colnorm().init_params(
        torch.Generator().manual_seed(SEED), device="cpu")

    # Phase 3: each kernel against its plain version, at the serving
    # shapes (K1-K3) and at the training shape (K4-K6).
    errs = {name: 0.0 for name in kernels}
    timing = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    all_cases = {b: cases(params, cfg, b, gen) for b in (1, 8)}
    recipe = experiment.timit_chorowski_normnll_colnorm()
    all_cases["train"] = train_cases(interop.to_torch(train_params, "cuda"),
                                     recipe.build_model().cfg, train_batch(TRAIN_B, SEED + 3), gen)
    for b, cs in all_cases.items():
        for c in cs:
            with torch.no_grad():
                got = c.kernel(*c.args)
                want = c.plain(*c.args)
            torch.cuda.synchronize()
            tag = f"B={b}" if b != "train" else f"B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}"
            errs[c.name] = max(errs[c.name], c.check(got, want, tag))

    # Phases 4 and 5: serve on the card, then the same requests on the CPU.
    # The "eos" weights raise the readout's bias at eos, so that
    # hypotheses finish on eos; the seeded random weights alone never
    # pick eos.
    pcms = make_pcm(8, SEED + 2)
    feats = features.logmel_rfft(torch.from_numpy(np.stack(pcms)), SR)
    mean = feats.mean(dim=(0, 1)).numpy()
    std = feats.std(dim=(0, 1)).numpy()
    kw = dict(eos_id=EOS_ID, mean=mean, std=std, beam_k=BEAM_K)
    weights = {"random": params}
    for bias in EOS_BIASES:
        weights[f"eos+{bias}"] = copy.deepcopy(params)
        weights[f"eos+{bias}"]["decoder"]["readout"][-1]["b"][EOS_ID] += bias
    # A hypothesis forced to finish at max_steps holds max_steps + 1 tokens.
    max_steps = features.frames_for_samples(len(pcms[0])) + 2 * PAD_FRAMES
    main_launches, eos_steps = None, []
    runs = [(False, 1), (False, 8), (True, 1)]
    eos_runs = [(f"eos+{bias}", False, 8) for bias in EOS_BIASES]
    for name, exact, b in [("random", *r) for r in runs] + eos_runs:
        tr = serve.Transcriber(model, weights[name], exact=exact, pad_frames=PAD_FRAMES, **kw)
        for k in kernels.values():
            k.launches = 0
        with torch.no_grad():
            out = tr.transcribe(pcms[:b])
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        tag = f"serve {name} exact={exact} b={b}"
        print(f"{tag}: launches {counts}, tokens {[len(r.ids) for r in out]}, "
              f"scores {[round(r.score, 3) for r in out]}")
        if not all(np.isfinite(r.score) and r.ids.ndim == 1 and
                   (r.ids.size == 0 or 0 <= r.ids.min() and r.ids.max() < cfg.output_depth)
                   for r in out):
            raise SystemExit(f"{tag}: malformed transcription")
        if (name, exact, b) == ("random", False, 1):
            main_launches = counts
        ref = serve.Transcriber(model, interop.to_torch(weights[name], "cpu"), exact=exact,
                                pad_frames=PAD_FRAMES, device="cpu", **kw)
        ref_out, steps = cpu_transcribe(ref, pcms[:b])
        same = all(np.array_equal(r.ids, q.ids) for r, q in zip(out, ref_out))
        dscore = max(abs(r.score - q.score) for r, q in zip(out, ref_out))
        print(f"{tag}: tokens equal to the CPU run: {same}, max score diff {dscore:.3e} "
              f"(tol {SCORE_TOL}), beam steps on the CPU {steps}")
        if not same or not dscore <= SCORE_TOL:
            raise SystemExit(f"{tag}: the card disagrees with the CPU run")
        want = dict.fromkeys(kernels, 0)
        want.update({"bigru_scan2": 3, "fused_attention_step": steps,
                     "stft_logmel_power": 0 if exact else 1})
        if counts != want:
            raise SystemExit(f"{tag}: launch counts {counts}, expected {want}")
        if name != "random":
            on_eos = sum(len(r.ids) < max_steps for r in out)
            print(f"{tag}: {on_eos} of {b} best hypotheses finished on eos, the beam took "
                  f"{steps} of {max_steps + 1} steps")
            if not on_eos:
                raise SystemExit(f"{tag}: no hypothesis finished on eos")
            eos_steps.append(steps)
    if min(eos_steps) > max_steps:
        raise SystemExit("serve eos: the beam never left its loop before max_steps")

    # Phase 6: train on the card, against the CPU.
    train_launches = train_phase(kernels, train_params, card)

    # Phase 7: times at the shapes of each kernel's path, kernel and plain in turns.
    iters = {"bigru_scan2": 20, "fused_attention_step": 200, "stft_logmel_power": 200,
             "bigru_scan2_bwd": 10, "attention_decode_scan_fwd": 10,
             "attention_decode_scan_bwd": 10}
    for b, cs in all_cases.items():
        for c in cs:
            n = iters[c.name]
            with torch.no_grad():
                call_ms = time_ms(lambda: c.kernel(*c.args), n)
                plain_ms = time_ms(lambda: c.plain(*c.args), max(3, n // 10))
                ms = device_ms(lambda: c.kernel(*c.args), c.symbols, n)
            b_ms, b_by = bound(c.flops, c.nbytes)
            timing[(c.name, b)] = (ms, plain_ms, b_ms, b_by)
            tag = f"B={b}" if b != "train" else f"B={TRAIN_B} L={TRAIN_L} T={TRAIN_T}"
            print(f"time {c.name} {tag}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
                  f"per wrapper call), plain {plain_ms:.4f} ms per call, bound {b_ms:.4f} ms "
                  f"({b_by}: {c.flops:.3e} flop, {c.nbytes:.3e} B), library null ({card})")
    for name, why in NO_LIBRARY.items():
        print(f"library null for {name}: {why}")
    print("the recurrences' bounds ignore the dependency chain of their steps; every time is "
          "warm (back-to-back launches, weights resident in L2, as in the beam loop and the "
          "train step); kernel times are device times from the profiler, per-call times are "
          "CUDA events over back-to-back calls and include the host's work between launches")

    # Phase 8: request latency and train-step time, each with the
    # device's idle share: the device time of one request or step,
    # traced with a device-only profiler, over the unprofiled p50.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for exact, b in runs:
        tr = serve.Transcriber(model, params, exact=exact, pad_frames=PAD_FRAMES, **kw)
        lat = []
        with torch.no_grad():
            tr.transcribe(pcms[:b])
            for _ in range(10):
                t0 = time.perf_counter()
                tr.transcribe(pcms[:b])
                lat.append(1e3 * (time.perf_counter() - t0))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.transcribe(pcms[:b])
                wall = 1e3 * (time.perf_counter() - t0)
        p50 = statistics.median(lat)
        dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
        idle = f"{1 - busy / p50:.4f}" if dev_events else "not measured"
        print(f"serve exact={exact} b={b}: p50 {p50:.2f} ms (min {min(lat):.2f}, max "
              f"{max(lat):.2f}) over 10 sequential requests of {PCM_SECONDS} s PCM; device "
              f"busy {busy:.2f} ms in {len(dev_events)} device ops of one profiled request "
              f"({wall:.2f} ms wall under the profiler), idle share 1 - busy/p50 = {idle} "
              f"({card})")
    for b in (TRAIN_B, BIG_B):
        train_timing(train_params, b, card)

    report = []
    for name in kernels:
        ms, plain_ms, b_ms, b_by = timing.get((name, 1)) or timing[(name, "train")]
        launches = (main_launches if (name, 1) in timing else train_launches)[name]
        report.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
