"""Where a step of the decoder-scan backwards K5, K11, K13 and K15, of the
LSTM decoder forwards K10 and K14, of the GRU decoder forwards K12 and
K4, of the beam steps K2 and K8, of the forward GRU walk behind K1,
K16 and K18, of the forward LSTM walk K7, or of the log-mel front end K3,
goes, on the card.

    python3 tools/scan_phases.py [SOURCE ...]
    python3 tools/scan_phases.py --lstm-bwd [SOURCE ...]
    python3 tools/scan_phases.py --gru-bwd [SOURCE ...]
    python3 tools/scan_phases.py --lstm-fwd [SOURCE ...]
    python3 tools/scan_phases.py --gru-dec-fwd [SOURCE ...]
    python3 tools/scan_phases.py --k2 [SOURCE ...]
    python3 tools/scan_phases.py --k8 [SOURCE ...]
    python3 tools/scan_phases.py --gru-fwd [HEADER ...]
    python3 tools/scan_phases.py --lstm-enc-fwd [SOURCE ...]
    python3 tools/scan_phases.py --k3 [SOURCE ...]

Nsight Compute does not run on every machine, so this measures the walk
from inside: it copies csrc/attention_scan_loc_lstm.cu (or each SOURCE
given, a variant of it, with the headers beside it), turns every
``// [phase] name`` comment of scan_bwd into a read of the SM's cycle
counter by thread 0 of block 0 (each marker follows a block barrier, so
the difference between two reads is the time of the phase between
them), builds the copy, and runs K13 at flagship_loc's training shape,
at B=16 and 128, on chip_smoke.py's cases (the recipe's seeded weights,
its training batch, random cotangents). It prints the cycles a step of
each phase, the time per call (CUDA events over 5 calls), and each
call's parity with the plain version (the backward tolerance). The
counter adds two instructions of one thread a phase. Exits nonzero
without a card.

With --lstm-bwd it instruments decoder_walk, the cluster walk of K11,
K15 and K5 in the same source (or each SOURCE), whose markers follow the
step's block barriers and its waits for the peers' pushes, and runs K11
and K15 at the conv+BiLSTM recipe's training shape (with and without the
location term) at B=16 and 128 on chip_smoke.py's cases: the plan each
ran, the cycles a step of block 0 of cluster 0 by phase (the wait for
the staged inputs, then each exchange with the work before it; a phase
of the other cell's, which the walk does not run, is left out), the
time per call (CUDA events over 5 calls) and the parity (the backward
tolerance). With --gru-bwd it does the same for the GRU instance of the
walk, K5, at the flagship recipe's training shape (L = 144, T = 56) at
B=16 and 128.

With --lstm-fwd it instruments decoder_fwd_walk, the forward walk of
K10 and K14 in the same source (or each SOURCE), whose markers follow
the step's block barriers and its waits for the peers' pushes, and runs
K10 and K14 at the conv+BiLSTM recipe's training shape at B=16 and 128
on chip_smoke.py's cases: the plan each ran (C, R, W_cx resident or
streamed), the cycles a step of block 0 of cluster 0 by phase (the wait
for the staged P, exchange 1, ws and the energies, the softmax's shares,
s_prev @ w_h with exchange 2, the combine, c @ W_cx, the cell, the ws
partial with exchange 1's push; a phase of the other cell's, which the
walk does not run, is left out), the time per call (CUDA events over 5
calls) and the max abs error against the plain version (1e-4). With
--gru-dec-fwd it does the same for the walk's GRU instances, K12 and K4,
at the flagship recipe's training shape (L = 144, T = 56) with and
without the location term (flagship_loc's and the flagship's cases) at
B=16 and 128; their step has s_prev @ w_zr[:St] with exchange 2, and
after c @ W_cx the gates, exchange 3 (rg s_prev), the candidate's product
and the update in place of the cell.

With --k2 it does the same for attention_step_kernel of
csrc/attention_step.cu (or each SOURCE), whose markers follow the
cluster barriers of the step, and runs K2 at the flagship serving shape
at b=1 (chip_smoke.py's case): the cycles of one step of block 0 of
cluster 0 by phase, the time per call (CUDA events over 20 calls), and
the parity with the plain version (1e-4 abs). A source without markers
in that kernel, such as the single-block step before it ran on a
cluster, gets one after each top-level statement that ends in a block
barrier (STEP_BARRIERS), named by its call, and is called without the
cluster size its C entry point does not take.

With --k8 it does the same for cluster_step_loc_lstm_kernel, K8's
cluster step in the same source (or each SOURCE), whose markers follow
the step's cluster barriers (a phase inside the readout's layer loop
adds up over its layers), and runs its <LSTM, location> instance at the
conv+BiLSTM serving shape at b=1 (chip_smoke.py's case: the recipe's
weights, L' = 14, K = 5): the plan it ran, the cycles of one step of
block 0 of cluster 0 by phase (a phase of the GRU's, which the instance
does not run, is left out), the time per call (CUDA events over 20
calls) and the parity with the plain version (1e-4 abs).

With --gru-fwd it instruments gru_walk_fwd of csrc/gru_walk.cuh (or of
each HEADER, a variant with the other headers and bigru_scan2.cu beside
it), whose markers follow the step's block barriers and its waits for
the peers' pushes, builds K1
(bigru_scan2.cu) against the copy, and runs it on seeded random inputs at
the flagship encoder's width (H = 256) at B = 1, L = 132 (serving) and
B = 16 and 128, L = 144 (training): the plan it ran, the cycles a step
of block 0 of cluster 0 of direction 0 by phase (the wait for the staged
x, the gate products, the r * h push and the wait for the peers', the
candidate product, the h push and its wait), the time per call (CUDA
events over 20 calls) and the parity with the plain version (1e-4 abs).

With --lstm-enc-fwd it instruments bilstm_scan_kernel, K7's walk in
csrc/bilstm_scan.cu (or in each SOURCE, a variant with the headers
beside it), whose markers follow the prologue's block barrier and, in
the step, the block barrier after the gate products and the cell and
the wait for the peers' h. It runs K7 on seeded random inputs at the
conv+BiLSTM recipe's width (H = 128) at B = 1 and 8, L' = 14 (serving)
and B = 16 and 128, L' = 16 (training): the plan it ran, the cycles of
block 0 of cluster 0 of direction 0 before the walk (once a call) and a
step by phase, the time per call (CUDA events over 20 calls) and the
parity with the plain version (1e-4 abs).

With --k3 it instruments stft_logmel_kernel, K3's body in
csrc/logmel.cu (or in each SOURCE, a variant of it), whose markers follow
its block barriers (the copy adds a block barrier before the last
marker, so that the last phase ends with the block's slowest thread).
It builds three copies of each source: as it is, instrumented, and with
an empty body (the floor: a launch of the same grid and block that does
nothing), and calls each through the source's own C entry point, whose
argument list it reads from the source and fills from
ops/cuda/logmel.py's _consts by parameter name. It runs them on chip_smoke.py's input, the 3.5 s
bucket (112 frames a row) at b = 1 and 8: the block size, the device
time of the kernel and of the floor (profiler, 200 calls), the time per
call (CUDA events over 200 calls), the cycles of block 0 by phase
(thread 0's clock, from the top of the body) and the parity with the
plain version (1e-4 abs).
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, build  # noqa: E402

SOURCE = build.CSRC_DIR / "attention_scan_loc_lstm.cu"
PROBE = r'''
__device__ unsigned long long g_phase_cycles[32];
extern "C" int read_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[32] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
  }
  return (int)e;
}
'''
MARK = re.compile(r"^(\s*)// \[phase\] (.+)$", re.M)
K2_SOURCE = build.CSRC_DIR / "attention_step.cu"
K2_SIG = "attention_step_kernel(const Args a) {"
K8_SIG = "cluster_step_loc_lstm_kernel(const Args8 a) {"
# Calls that end in a barrier of the whole block (or cluster), at the top
# level of a beam-step kernel's body: a marker after each times what came
# before it.
STEP_BARRIERS = ("__syncthreads", "cluster.sync", "cluster_wait", "attend", "context",
                 "decoder_cell", "matvec")
STEP_CALL = re.compile(r"^  ([\w.]+)(?:<\w+>)?\((.*)\);$")
# The kernel attribute of ops/cuda/attention_scan.py each instrumented
# entry point stands in for, by chip_smoke.py's case name.
ENTRY = {"attention_decode_scan_loc_bwd": ("K13", "KERNEL_LOC_BWD"),
         "attention_decode_scan_loc_lstm_fwd": ("K10", "KERNEL_LOC_LSTM_FWD"),
         "attention_decode_scan_lstm_fwd": ("K14", "KERNEL_LSTM_FWD"),
         "attention_decode_scan_loc_fwd": ("K12", "KERNEL_LOC_FWD"),
         "attention_decode_scan_fwd": ("K4", "KERNEL_FWD"),
         "attention_decode_scan_loc_lstm_bwd": ("K11", "KERNEL_LOC_LSTM_BWD"),
         "attention_decode_scan_lstm_bwd": ("K15", "KERNEL_LSTM_BWD"),
         "attention_decode_scan_bwd": ("K5", "KERNEL_BWD")}
# The mode's entry points, by chip_smoke.py's case name, and the trace
# names of its instrumented kernels (for ptxas's spill lines).
MODES = {"k13": (("attention_decode_scan_loc_bwd",), ("scan_loc_gru_bwd",)),
         "lstm": (("attention_decode_scan_loc_lstm_bwd", "attention_decode_scan_lstm_bwd"),
                  ("loc_lstm_bwd_kernel", "scan_lstm_bwd_kernel")),
         "gru": (("attention_decode_scan_bwd",), ("content_gru_walk_kernel",)),
         "lstm_fwd": (("attention_decode_scan_loc_lstm_fwd", "attention_decode_scan_lstm_fwd"),
                      ("loc_lstm_fwd_kernel", "scan_lstm_fwd_kernel")),
         "gru_dec_fwd": (("attention_decode_scan_loc_fwd", "attention_decode_scan_fwd"),
                         ("loc_gru_fwd_kernel", "content_gru_fwd_kernel"))}
# The modes on decoder_fwd_walk.
FWD_MODES = ("lstm_fwd", "gru_dec_fwd")
WALK_SIG = "__device__ __forceinline__ void decoder_walk(float* sm, const BwdArgs& a) {"
WALK_LOOP = "  for (int s = 0; s < T; ++s) {"
FWD_WALK_SIG = ("__device__ __forceinline__ void decoder_fwd_walk(float* sm, const FwdArgsT<IO>& "
                "a,\n                                                 const FwdScratch& x, int "
                "resident) {")
FWD_WALK_LOOP = "  for (int t = 0; t < T; ++t) {"


def instrument(src: str):
    """The source with a cycle read at each phase marker of scan_bwd, and
    the phases' names in order."""
    head, body = src.split("scan_bwd(float* sm, const BwdArgs& a) {", 1)
    body, tail = body.split("\n}\n", 1)
    names = MARK.findall(body)
    if not names:
        raise ValueError("no // [phase] markers in scan_bwd")
    counter = iter(range(len(names)))

    def read(m):
        i = next(counter)
        return (f"{m.group(1)}if (threadIdx.x == 0 && blockIdx.x == 0) {{ const long long c_ = "
                f"clock64(); g_phase_cycles[{i}] += c_ - phase_t0_; phase_t0_ = c_; }}")

    body = MARK.sub(read, body)
    body = body.replace("  for (int t = d.T - 1; t >= 0; --t) {",
                        "  long long phase_t0_ = clock64();\n"
                        "  for (int t = d.T - 1; t >= 0; --t) {", 1)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return head + "scan_bwd(float* sm, const BwdArgs& a) {" + body + "\n}\n" + tail, \
        [n for _, n in names]


def _clock_read(i: int, indent: str, block: str = "blockIdx.x == 0") -> str:
    return (f"{indent}if (threadIdx.x == 0 && {block}) {{ const long long c_ = "
            f"clock64(); g_phase_cycles[{i}] += c_ - phase_t0_; phase_t0_ = c_; }}")


def instrument_k2(src: str):
    """The source with a cycle read at each phase marker of
    attention_step_kernel (markers added after its top-level barrier
    calls where it has none), and the phases' names in order."""
    head, rest = src.split(K2_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    if not MARK.search(body):
        lines, seen = [], {}
        for line in body.split("\n"):
            lines.append(line)
            m = STEP_CALL.match(line)
            if m and m.group(1) in STEP_BARRIERS:
                name = m.group(1)
                if name == "matvec":  # by the weight it reads
                    name += " " + m.group(2).split(",")[0].replace("a.", "")
                seen[name] = seen.get(name, 0) + 1
                lines.append(f"  // [phase] {name}" + (f" {seen[name]}" if seen[name] > 1 else ""))
        lines.append("  // [phase] end")
        body = "\n".join(lines)
    names = [n for _, n in MARK.findall(body)]
    counter = iter(range(len(names)))
    body = MARK.sub(lambda m: _clock_read(next(counter), m.group(1)), body)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return (head + K2_SIG + "\n  long long phase_t0_ = clock64();" + body + "\n}\n" + tail,
            names)


def instrument_k8(src: str):
    """The source with a cycle read by thread 0 of block 0 at each phase
    marker of cluster_step_loc_lstm_kernel (K8), the clock started at the
    top of its body, and the phases' names in order."""
    head, rest = src.split(K8_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    names = [n for _, n in MARK.findall(body)]
    if not names:
        raise ValueError("no // [phase] markers in cluster_step_loc_lstm_kernel")
    counter = iter(range(len(names)))
    body = MARK.sub(lambda m: _clock_read(next(counter), m.group(1)), body)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return (head + K8_SIG + "\n  long long phase_t0_ = clock64();" + body + "\n}\n" + tail,
            names)


GRU_FWD_SOURCE = build.CSRC_DIR / "gru_walk.cuh"
GRU_FWD_SIG = ("__device__ void gru_walk_fwd(const GruFwdDirT<T>& a, int B, int L, int H, "
               "bool resident,\n                             float* smem) {")
GRU_FWD_LOOP = "  for (int s = 0; s < L; ++s) {"
# K1's shapes in the flagship's paths: (B, L).
GRU_FWD_SHAPES = ((1, 132), (16, 144), (128, 144))


def instrument_gru_fwd(src: str):
    """The header with a cycle read by thread 0 of block 0 of direction
    0 at each phase marker of gru_walk_fwd, and the phases' names in
    order."""
    head, rest = src.split(GRU_FWD_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    names = MARK.findall(body)
    if not names:
        raise ValueError("no // [phase] markers in gru_walk_fwd")
    counter = iter(range(len(names)))

    def read(m):
        return (f"{m.group(1)}if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {{ "
                f"const long long c_ = clock64(); g_phase_cycles[{next(counter)}] += c_ - "
                f"phase_t0_; phase_t0_ = c_; }}")

    body = MARK.sub(read, body)
    if body.count(GRU_FWD_LOOP) != 1:
        raise ValueError("gru_walk_fwd has no single step loop")
    body = body.replace(GRU_FWD_LOOP, "  long long phase_t0_ = clock64();\n" + GRU_FWD_LOOP, 1)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return head + GRU_FWD_SIG + body + "\n}\n" + tail, [n for _, n in names]


def instrument_walk(src: str, sig: str = WALK_SIG, loop: str = WALK_LOOP,
                    name: str = "decoder_walk"):
    """The source with a cycle read by thread 0 of block 0 at each phase
    marker of decoder_walk (K11's, K15's and K5's walk; or of the walk
    whose signature and step loop are `sig` and `loop`, named `name`), and
    the phases' names in order."""
    head, rest = src.split(sig, 1)
    body, tail = rest.split("\n}\n", 1)
    names = MARK.findall(body)
    if not names:
        raise ValueError(f"no // [phase] markers in {name}")
    counter = iter(range(len(names)))
    body = MARK.sub(lambda m: _clock_read(next(counter), m.group(1)), body)
    if body.count(loop) != 1:
        raise ValueError(f"{name} has no single step loop")
    body = body.replace(loop, "  long long phase_t0_ = clock64();\n" + loop, 1)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return head + sig + body + "\n}\n" + tail, [n for _, n in names]


def instrument_fwd_walk(src: str):
    """instrument_walk for decoder_fwd_walk, the forward walk of K10, K14,
    K12 and K4."""
    return instrument_walk(src, FWD_WALK_SIG, FWD_WALK_LOOP, "decoder_fwd_walk")


LSTM_ENC_SOURCE = build.CSRC_DIR / "bilstm_scan.cu"
LSTM_ENC_SIG = "bilstm_scan_kernel(const LstmFwd a, int resident) {"
LSTM_ENC_LOOP = "  for (int s = 0; s < L; ++s) {"
# K7's shapes in the conv+BiLSTM recipe's paths, (B, L'): serving one and
# eight utterances of 3.5 s, and the training batches of 144 frames.
LSTM_ENC_SHAPES = ((1, 14), (8, 14), (16, 16), (128, 16))


def instrument_lstm_enc_fwd(src: str):
    """The source with a cycle read by thread 0 of block 0 of direction 0
    at each phase marker of bilstm_scan_kernel (K7's walk), the clock
    started at the top of its body, and the phases' names in order, each
    with whether it lies in the step loop (read every step) or before it
    (read once a call)."""
    head, rest = src.split(LSTM_ENC_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    if body.count(LSTM_ENC_LOOP) != 1:
        raise ValueError("bilstm_scan_kernel has no single step loop")
    loop_at = body.index(LSTM_ENC_LOOP)
    marks = [(m.group(2), m.start() > loop_at) for m in MARK.finditer(body)]
    if not marks:
        raise ValueError("no // [phase] markers in bilstm_scan_kernel")
    counter = iter(range(len(marks)))
    body = MARK.sub(lambda m: _clock_read(next(counter), m.group(1),
                                          "blockIdx.x == 0 && blockIdx.y == 0"), body)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return (head + LSTM_ENC_SIG + "\n  long long phase_t0_ = clock64();" + body + "\n}\n" + tail,
            marks)


def _card() -> str:
    """The card's name, power limit and top SM clock (nvidia-smi)."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def cases(mode: str):
    """chip_smoke.py's cases of `mode` at B=16 and 128: K13 at
    flagship_loc's training shape ("k13"), K11 and K15 ("lstm") or K10
    and K14 ("lstm_fwd") at the conv+BiLSTM recipe's, with and without
    the location term, K5 at the flagship recipe's ("gru"), or K12 and K4
    at flagship_loc's and the flagship recipe's ("gru_dec_fwd")."""
    import chip_smoke as smoke
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import experiment

    gen = torch.Generator().manual_seed(smoke.SEED + 1)
    out = []
    lstm = ((experiment.timit_conv_bilstm, smoke.cb_train_cases),
            (smoke.conv_bilstm_content, smoke.cbc_train_cases))
    recipes = {"lstm": lstm, "lstm_fwd": lstm,
               "k13": ((smoke.flagship_loc, smoke.loc_train_cases),),
               "gru": ((experiment.timit_chorowski_normnll_colnorm, smoke.train_cases),),
               "gru_dec_fwd": ((smoke.flagship_loc, smoke.loc_train_cases),
                               (experiment.timit_chorowski_normnll_colnorm, smoke.train_cases))
               }[mode]
    names = MODES[mode][0]
    for recipe, make in recipes:
        exp = recipe()
        params = interop.to_torch(
            exp.init_params(torch.Generator().manual_seed(smoke.SEED), device="cpu"), "cuda")
        cfg = exp.build_model().cfg
        for b in (smoke.TRAIN_B, smoke.BIG_B):
            out += [c for c in make(params, cfg, smoke.train_batch(b, smoke.SEED + 3), gen)
                    if c.name in names]
    return out


def main(sources, mode: str = "k13") -> int:
    """The default mode ("k13": K13's scan_bwd), the --lstm-bwd ("lstm":
    K11 and K15) or --gru-bwd ("gru": K5) mode, on decoder_walk, or the
    --lstm-fwd ("lstm_fwd": K10 and K14) or --gru-dec-fwd ("gru_dec_fwd":
    K12 and K4) mode, on decoder_fwd_walk."""
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    kernels = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    entries, walks = MODES[mode]
    for src in map(pathlib.Path, sources):
        text, names = {"k13": instrument, "lstm_fwd": instrument_fwd_walk,
                       "gru_dec_fwd": instrument_fwd_walk}.get(mode, instrument_walk)(
            src.read_text())
        headers = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh"))}
        digest = hashlib.sha1((text + "".join(headers.values())).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in headers.items():
            (copy / name).write_text(header)
        out = copy / f"{src.stem}_{digest}.cu"
        out.write_text(text)
        kernels[src] = (names, {
            ENTRY[e][0]: build.Kernel(f"{ENTRY[e][0]} phases", str(out), e,
                                      getattr(attention_scan, ENTRY[e][1]).argtypes,
                                      getattr(attention_scan, ENTRY[e][1]).defines)
            for e in entries})
    t0 = time.perf_counter()
    build.build_all(k for _, ks in kernels.values() for k in ks.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    for src, (_, ks) in kernels.items():
        # ptxas -v: each kernel's "Compiling entry" line, then its registers and spills.
        kernel = None
        for line in next(iter(ks.values())).build_log.splitlines():
            if "Compiling entry" in line:
                kernel = next((k for k in walks if k in line), None)
            elif kernel and ("spill" in line or "registers" in line):
                print(f"scan_phases {src} {kernel}: {line.split(':', 1)[-1].strip()}")
    for c in cases(mode):
        name, attr = ENTRY[c.name]
        vh, yin = c.args[0], c.args[3]
        b, l, t = vh.shape[0], vh.shape[1], yin.shape[1]
        with torch.no_grad():
            want = c.plain(*c.args)
        default = getattr(attention_scan, attr)
        for src, (names, ks) in kernels.items():
            setattr(attention_scan, attr, ks[name])
            plan = ""
            try:
                # wconv (F, FM) after vh, h, mask, yin and the 7 step and 3
                # (LSTM) or 2 (GRU) cell weights.
                wconv = {"K10": 14, "K11": 14, "K12": 13}.get(name)
                fm, f = (c.args[wconv].shape[1], c.args[wconv].shape[0]) if wconv else (0, 0)
                dims = (b, l, vh.shape[2], c.args[1].shape[2], yin.shape[2], fm, f, vh.device)
                if mode in FWD_MODES:
                    run = attention_scan.fwd_plan_on(ks[name], *dims)
                    plan = (f" (plan C={run.cluster} R={run.rows} W_cx "
                            f"{'resident' if run.resident else 'streamed'}, {run.waves} waves)")
                elif mode != "k13":
                    run = attention_scan.scan_plan_on(ks[name], *dims)
                    plan = f" (plan C={run.cluster} R={run.rows}, {run.waves} waves)"
                read = ks[name].helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
                with torch.no_grad():
                    got = c.kernel(*c.args)
                    torch.cuda.synchronize()
                    # The forward's tolerance, 1e-4 abs, as an excess over it; the
                    # backward's, max|got - plain| <= 5e-4 max|plain| + 5e-5.
                    fwd = mode in FWD_MODES
                    excess = max(float((g - w).abs().max()) - (1e-4 - 5e-5 if fwd else
                                                               5e-4 * float(w.abs().max()))
                                 for g, w in zip(got, want))
                    cycles = (ctypes.c_ulonglong * 32)()
                    read(cycles, 1)
                    c.kernel(*c.args)
                    torch.cuda.synchronize()
                    read(cycles, 1)
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(5):
                        c.kernel(*c.args)
                    stop.record()
                    torch.cuda.synchronize()
            finally:
                setattr(attention_scan, attr, default)
            # The walk's phases of the other cell never run: left out.
            ran = [(p, n / t) for p, n in zip(names, cycles[:len(names)])
                   if n or mode == "k13"]
            print(f"scan_phases {src} {name} B={b} L={l} T={t}{plan}: "
                  f"{start.elapsed_time(stop) / 5:.4f} ms per call, parity excess {excess:.3e} "
                  f"({'ok' if excess <= 5e-5 else 'FAILS'}); cycles a step of block 0: "
                  f"{sum(n for _, n in ran):.0f} = " + ", ".join(
                      f"{p} {n:.0f}" for p, n in ran) + f" ({card})")
            if excess > 5e-5:
                return 1
    return 0


class _NoCluster:
    """A K2 kernel whose C entry point takes no cluster size (the
    single-block step): the wrapper's launch with that argument dropped."""

    def __init__(self, kernel):
        self.kernel = kernel

    def launch(self, *args):
        self.kernel.launch(*args[:-2], args[-1])


def main_k2(sources) -> int:
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {}
    for src in map(pathlib.Path, sources):
        raw = src.read_text()
        text, names = instrument_k2(raw)
        headers = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh"))}
        digest = hashlib.sha1((text + "".join(headers.values())).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in headers.items():
            (copy / name).write_text(header)
        out = copy / f"{src.stem}_{digest}.cu"
        out.write_text(text)
        clustered = "int cluster, cudaStream_t stream" in raw
        argtypes = attention_step.KERNEL.argtypes
        k = build.Kernel("K2 phases", str(out), "fused_attention_step",
                         argtypes if clustered else argtypes[:-2] + argtypes[-1:])
        kernels[src] = (names, k, k if clustered else _NoCluster(k))
    t0 = time.perf_counter()
    build.build_all(k for _, k, _ in kernels.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    model = registry.build("chorowski")
    params = model.init(torch.Generator().manual_seed(smoke.SEED), device="cuda")
    loc_dec = registry.build("chorowski", feature_maps=16, filt_size=10).init(
        torch.Generator().manual_seed(smoke.SEED))["decoder"]
    c = next(c for c in smoke.cases(params, model.cfg, loc_dec, 1,
                                    torch.Generator().manual_seed(smoke.SEED + 1))
             if c.name == "fused_attention_step")
    with torch.no_grad():
        want = c.plain(*c.args)
    default = attention_step.KERNEL
    for src, (names, k, shim) in kernels.items():
        for line in k.build_log.splitlines():
            if "spill" in line or "registers" in line:
                print(f"scan_phases {src} K2: {line.split(':', 1)[-1].strip()}")
        attention_step.KERNEL = shim
        try:
            read = k.helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
            with torch.no_grad():
                got = c.kernel(*c.args)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                cycles = (ctypes.c_ulonglong * 32)()
                read(cycles, 1)
                c.kernel(*c.args)
                torch.cuda.synchronize()
                read(cycles, 1)
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    c.kernel(*c.args)
                stop.record()
                torch.cuda.synchronize()
        finally:
            attention_step.KERNEL = default
        print(f"scan_phases {src} K2 B=1 K={smoke.BEAM_K} L={c.args[4].shape[1]}: "
              f"{start.elapsed_time(stop) / 20:.4f} ms per call, max abs err {err:.3e} "
              f"({'ok' if err <= smoke.TOL else 'FAILS'}); cycles of the step in block 0: "
              f"{sum(cycles[:len(names)])} = " + ", ".join(
                  f"{p} {n}" for p, n in zip(names, cycles[:len(names)])) + f" ({card})")
        if err > smoke.TOL:
            return 1
    return 0


def k8_case():
    """chip_smoke.py's K8 case on the conv+BiLSTM recipe's decoder at the
    serving shape, b=1: the BiLSTM's output of 3.5 s of PCM (L' = 14), K
    = 5, the recipe's seeded weights."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.train import experiment

    import chip_smoke as smoke

    _, feats, mean, std = smoke.serve_setup()
    norm = ((feats - torch.from_numpy(mean)) / torch.from_numpy(std)).cuda()
    exp = experiment.timit_conv_bilstm()
    params = interop.to_torch(
        exp.init_params(torch.Generator().manual_seed(smoke.SEED), device="cpu"), "cuda")
    noloc = registry.build("conv_bilstm", feature_maps=0).init(
        torch.Generator().manual_seed(smoke.SEED))["decoder"]
    cases, _ = smoke.conv_bilstm_cases(params, exp.build_model().cfg, noloc, norm[:1],
                                       torch.Generator().manual_seed(smoke.SEED + 1))
    return next(c for c in cases if c.label == "fused_attention_step_loc_lstm[lstm+loc]")


def main_k8(sources) -> int:
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {}
    for src in map(pathlib.Path, sources):
        text, names = instrument_k8(src.read_text())
        headers = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh"))}
        digest = hashlib.sha1((text + "".join(headers.values())).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in headers.items():
            (copy / name).write_text(header)
        out = copy / f"{src.stem}_{digest}.cu"
        out.write_text(text)
        kernels[src] = (names, build.Kernel("K8 phases", str(out), "fused_attention_step_loc_lstm",
                                            attention_step.KERNEL_LOC_LSTM.argtypes))
    t0 = time.perf_counter()
    build.build_all(k for _, k in kernels.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    c = k8_case()
    dec, acfg, state, _, vh = c.args[:5]
    b, k, l = vh.shape[0], state[1].shape[1], vh.shape[1]
    with torch.no_grad():
        want = c.plain(*c.args)
    default = attention_step.KERNEL_LOC_LSTM
    for src, (names, kern) in kernels.items():
        for line in kern.build_log.splitlines():
            if "spill" in line or "registers" in line:
                print(f"scan_phases {src} K8: {line.split(':', 1)[-1].strip()}")
        attention_step.KERNEL_LOC_LSTM = kern
        try:
            plan = attention_step.step_loc_lstm_plan_on(
                b, k, l, acfg.score_depth, acfg.annotation_depth, acfg.state_depth,
                acfg.feature_maps, acfg.filt_size, True,
                attention_step.k8_dense(attention_step.k8_layers(acfg)), vh.device)
            read = kern.helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
            with torch.no_grad():
                got = c.kernel(*c.args)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                cycles = (ctypes.c_ulonglong * 32)()
                read(cycles, 1)
                c.kernel(*c.args)
                torch.cuda.synchronize()
                read(cycles, 1)
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    c.kernel(*c.args)
                stop.record()
                torch.cuda.synchronize()
        finally:
            attention_step.KERNEL_LOC_LSTM = default
        # The GRU's phases never run in the LSTM instance: left out.
        ran = [(p, n) for p, n in zip(names, cycles[:len(names)]) if n]
        print(f"scan_phases {src} K8 <LSTM, location> B={b} K={k} L={l} (plan C={plan.cluster}, "
              f"{plan.waves} wave(s)): {start.elapsed_time(stop) / 20:.4f} ms per call, max abs "
              f"err {err:.3e} ({'ok' if err <= 1e-4 else 'FAILS'}); cycles of the step in block "
              f"0: {sum(n for _, n in ran)} = " + ", ".join(f"{p} {n}" for p, n in ran)
              + f" ({card})")
        if err > 1e-4:
            return 1
    return 0


def main_gru_fwd(headers) -> int:
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan, walk

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {}
    for src in map(pathlib.Path, headers):
        text, names = instrument_gru_fwd(src.read_text())
        others = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh")) if h != src}
        k1 = (src.parent / "bigru_scan2.cu").read_text()
        digest = hashlib.sha1((text + "".join(others.values()) + k1).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in others.items():
            (copy / name).write_text(header)
        (copy / "gru_walk.cuh").write_text(text)
        out = copy / f"bigru_scan2_{digest}.cu"
        out.write_text(k1)
        kernels[src] = (names, build.Kernel("K1 phases", str(out), "bigru_scan2_fwd",
                                            gru_scan.KERNEL.argtypes))
    t0 = time.perf_counter()
    build.build_all(k for _, k in kernels.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    h, dev = 256, torch.device("cuda")
    default = gru_scan.KERNEL
    for b, l in GRU_FWD_SHAPES:
        gen = torch.Generator().manual_seed(b * 1000 + l)
        rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
        args = (rnd(b, l, 3 * h), rnd(b, l, 3 * h), rnd(2, h, 2 * h, scale=h ** -0.5),
                rnd(2, h, h, scale=h ** -0.5))
        want = gru_scan.bigru_scan2_plain(*args)
        for src, (names, k) in kernels.items():
            for line in k.build_log.splitlines():
                if b == 1 and ("spill" in line or "registers" in line):
                    print(f"scan_phases {src} K1: {line.split(':', 1)[-1].strip()}")
            plan = walk.plan_on(k, b, h, "gru_fwd", 2, dev)
            gru_scan.KERNEL = k
            try:
                read = k.helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
                got = gru_scan.bigru_scan2(*args)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                cycles = (ctypes.c_ulonglong * 32)()
                read(cycles, 1)
                gru_scan.bigru_scan2(*args)
                torch.cuda.synchronize()
                read(cycles, 1)
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    gru_scan.bigru_scan2(*args)
                stop.record()
                torch.cuda.synchronize()
            finally:
                gru_scan.KERNEL = default
            per_step = [n / l for n in cycles[:len(names)]]
            print(f"scan_phases {src} K1 B={b} L={l} H={h} (plan C={plan.cluster} R={plan.rows} "
                  f"{'resident' if plan.resident else 'streamed'}): "
                  f"{start.elapsed_time(stop) / 20:.4f} ms per call, max abs err {err:.3e} "
                  f"({'ok' if err <= 1e-4 else 'FAILS'}); cycles a step of block 0: "
                  f"{sum(per_step):.0f} = " + ", ".join(
                      f"{p} {n:.0f}" for p, n in zip(names, per_step)) + f" ({card})")
            if err > 1e-4:
                return 1
    return 0


def main_lstm_enc_fwd(sources) -> int:
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan, walk

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {}
    for src in map(pathlib.Path, sources):
        text, marks = instrument_lstm_enc_fwd(src.read_text())
        headers = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh"))}
        digest = hashlib.sha1((text + "".join(headers.values())).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in headers.items():
            (copy / name).write_text(header)
        out = copy / f"{src.stem}_{digest}.cu"
        out.write_text(text)
        kernels[src] = (marks, build.Kernel("K7 phases", str(out), "bilstm_scan_fwd",
                                            lstm_scan.KERNEL.argtypes))
    t0 = time.perf_counter()
    build.build_all(k for _, k in kernels.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    h, dev = 128, torch.device("cuda")
    default = lstm_scan.KERNEL
    for b, l in LSTM_ENC_SHAPES:
        gen = torch.Generator().manual_seed(b * 1000 + l)
        rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
        args = (rnd(2, b, l, 4 * h), rnd(2, b, h, scale=0.5), rnd(2, b, h, scale=0.5),
                rnd(2, h, 4 * h, scale=h ** -0.5))
        want = lstm_scan.bilstm_scan_plain(*args)
        for src, (marks, k) in kernels.items():
            for line in k.build_log.splitlines():
                if b == 1 and ("spill" in line or "registers" in line):
                    print(f"scan_phases {src} K7: {line.split(':', 1)[-1].strip()}")
            plan = walk.plan_on(k, b, h, "lstm_fwd", 2, dev)
            lstm_scan.KERNEL = k
            try:
                read = k.helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
                got = lstm_scan.bilstm_scan(*args)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                cycles = (ctypes.c_ulonglong * 32)()
                read(cycles, 1)
                lstm_scan.bilstm_scan(*args)
                torch.cuda.synchronize()
                read(cycles, 1)
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    lstm_scan.bilstm_scan(*args)
                stop.record()
                torch.cuda.synchronize()
            finally:
                lstm_scan.KERNEL = default
            once = [(p, n) for (p, looped), n in zip(marks, cycles) if not looped]
            step = [(p, n / l) for (p, looped), n in zip(marks, cycles) if looped]
            print(f"scan_phases {src} K7 B={b} L={l} H={h} (plan C={plan.cluster} R={plan.rows} "
                  f"{'resident' if plan.resident else 'streamed'}): "
                  f"{start.elapsed_time(stop) / 20:.4f} ms per call, max abs err {err:.3e} "
                  f"({'ok' if err <= 1e-4 else 'FAILS'}); cycles of block 0 before the walk: "
                  + (", ".join(f"{p} {n}" for p, n in once) or "not marked")
                  + f"; a step: {sum(n for _, n in step):.0f} = "
                  + ", ".join(f"{p} {n:.0f}" for p, n in step) + f" ({card})")
            if err > 1e-4:
                return 1
    return 0


K3_SOURCE = build.CSRC_DIR / "logmel.cu"
K3_KERNEL = "stft_logmel_kernel("
K3_ENTRY = re.compile(r'extern "C" int stft_logmel_power\((.*?)\)\s*\{', re.S)
# K3's batches on the 3.5 s bucket (chip_smoke.k3_input): one and eight
# utterances.
K3_BATCHES = (1, 8)


def _k3_body(src: str):
    """(head, body, tail) of stft_logmel_kernel's definition: the body
    runs from its opening brace to the first line that is a lone "}"."""
    at = src.index(K3_KERNEL)
    start = src.index(") {\n", at) + 3
    end = src.index("\n}\n", start)
    return src[:start], src[start:end], src[end:]


def instrument_k3(src: str):
    """The source with a cycle read by thread 0 of block 0 at each phase
    marker of stft_logmel_kernel (a block barrier added before the last),
    the clock started at the top of its body, and the phases' names in
    order."""
    head, body, tail = _k3_body(src)
    if not MARK.search(body):
        raise ValueError("no // [phase] markers in stft_logmel_kernel")
    # The last phase ends when the block's last thread is done.
    last = list(MARK.finditer(body))[-1]
    body = body[:last.start()] + f"{last.group(1)}__syncthreads();\n" + body[last.start():]
    names = [n for _, n in MARK.findall(body)]
    counter = iter(range(len(names)))
    body = MARK.sub(lambda m: _clock_read(next(counter), m.group(1),
                                          "blockIdx.x == 0 && blockIdx.y == 0"), body)
    head = head.replace("namespace {", PROBE + "\nnamespace {", 1)
    return head + "\n  long long phase_t0_ = clock64();" + body + tail, names


def floor_k3(src: str) -> str:
    """The source with stft_logmel_kernel's body emptied: its launch costs
    the least any body can."""
    head, _, tail = _k3_body(src)
    return head + tail


def k3_argtypes(src: str):
    """The parameter names of the source's C entry point and their ctypes
    (a pointer or the stream: c_void_p; else c_int)."""
    params = [p.strip() for p in K3_ENTRY.search(src).group(1).split(",")]
    names = [re.findall(r"\w+", p)[-1] for p in params]
    types = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p else ctypes.c_int for p in params]
    return names, types


def k3_tables(sr: int, device):
    """The tables of ops/cuda/logmel.py's _consts that K3's entry point
    takes, by parameter name."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    c = logmel._consts(sr, str(device))
    return {"window": c.window, "fft_tw": c.fft_tw, "split_tw": c.split_tw, "taps": c.taps,
            "tap_start": c.tap_start, "mel_first": c.mel_first, "nchunks": c.nchunks}


def main_k3(sources) -> int:
    import chip_smoke as smoke
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = _card()
    kernels = {}
    for src in map(pathlib.Path, sources):
        raw = src.read_text()
        text, names = instrument_k3(raw)
        params, argtypes = k3_argtypes(raw)
        digest = hashlib.sha1(raw.encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        built = {}
        for kind, body in (("as is", raw), ("phases", text), ("floor", floor_k3(raw))):
            out = copy / f"{src.stem}_{kind.replace(' ', '_')}_{digest}.cu"
            out.write_text(body)
            built[kind] = build.Kernel(f"K3 {kind}", str(out), "stft_logmel_power", argtypes)
        kernels[src] = (names, params, smoke.k3_threads(raw), built)
    t0 = time.perf_counter()
    build.build_all(k for *_, ks in kernels.values() for k in ks.values())
    print(f"scan_phases: built {len(kernels)} sources, 3 copies each, in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    dev = torch.device("cuda")
    tables = k3_tables(smoke.SR, dev)
    stream = build.stream_of(tables["window"])
    for b in K3_BATCHES:
        yp = smoke.k3_input(b, torch.Generator().manual_seed(smoke.SEED + 1))
        s = yp.shape[1]
        frames = 1 + (s - logmel.N_FFT) // logmel.HOP
        want = logmel.stft_logmel_power_plain(yp, smoke.SR)
        lm = torch.empty(b, frames, logmel.N_MELS, device=dev)
        energy = torch.empty(b, frames, device=dev)
        named = dict(tables, yp=yp, lm=lm, energy=energy, B=b, S=s, nframes=frames,
                     nfreq=logmel.NFREQ, stream=stream)
        for src, (names, params, threads, ks) in kernels.items():
            if b == K3_BATCHES[0]:
                for line in ks["as is"].build_log.splitlines():
                    if "spill" in line or "registers" in line:
                        print(f"scan_phases {src} K3: {line.split(':', 1)[-1].strip()}")
            args = [build.ptr(named[p]) if torch.is_tensor(named[p]) else named[p] for p in params]
            calls = {kind: (lambda k=k: k.launch(*args)) for kind, k in ks.items()}
            err = 0.0
            for kind in ("as is", "phases"):
                lm.fill_(float("nan"))
                energy.fill_(float("nan"))
                calls[kind]()
                torch.cuda.synchronize()
                for g, w in zip((lm, energy), want):
                    e = float((g - w).abs().max())
                    err = max(err, e if e == e else float("inf"))  # NaN: a frame not written
            read = ks["phases"].helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
            cycles = (ctypes.c_ulonglong * 32)()
            read(cycles, 1)
            calls["phases"]()
            torch.cuda.synchronize()
            read(cycles, 1)
            ms = {kind: smoke.device_ms(calls[kind], ("stft_logmel_kernel",), 200)
                  for kind in ("as is", "floor")}
            call_ms = smoke.time_ms(calls["as is"], 200)
            phases = list(zip(names, cycles[:len(names)]))
            print(f"scan_phases {src} K3 B={b} frames={frames} block {threads} threads: kernel "
                  f"{ms['as is']:.4f} ms on the device ({call_ms:.4f} ms per call), floor "
                  f"{ms['floor']:.4f} ms, max abs err {err:.3e} "
                  f"({'ok' if err <= smoke.TOL else 'FAILS'}); cycles of block 0: "
                  f"{sum(n for _, n in phases)} = " + ", ".join(f"{p} {n}" for p, n in phases)
                  + f" ({card})")
            if err > smoke.TOL:
                return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k3"]:
        sys.exit(main_k3(sys.argv[2:] or [str(K3_SOURCE)]))
    if sys.argv[1:2] == ["--lstm-enc-fwd"]:
        sys.exit(main_lstm_enc_fwd(sys.argv[2:] or [str(LSTM_ENC_SOURCE)]))
    if sys.argv[1:2] == ["--gru-fwd"]:
        sys.exit(main_gru_fwd(sys.argv[2:] or [str(GRU_FWD_SOURCE)]))
    if sys.argv[1:2] == ["--k2"]:
        sys.exit(main_k2(sys.argv[2:] or [str(K2_SOURCE)]))
    if sys.argv[1:2] == ["--k8"]:
        sys.exit(main_k8(sys.argv[2:] or [str(K2_SOURCE)]))
    if sys.argv[1:2] == ["--lstm-bwd"]:
        sys.exit(main(sys.argv[2:] or [str(SOURCE)], "lstm"))
    if sys.argv[1:2] == ["--gru-bwd"]:
        sys.exit(main(sys.argv[2:] or [str(SOURCE)], "gru"))
    if sys.argv[1:2] == ["--lstm-fwd"]:
        sys.exit(main(sys.argv[2:] or [str(SOURCE)], "lstm_fwd"))
    if sys.argv[1:2] == ["--gru-dec-fwd"]:
        sys.exit(main(sys.argv[2:] or [str(SOURCE)], "gru_dec_fwd"))
    sys.exit(main(sys.argv[1:] or [str(SOURCE)]))
