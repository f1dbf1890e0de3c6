"""Where a step of the decoder-scan backwards K11 and K13 goes, on the card.

    python3 tools/scan_phases.py [SOURCE ...]

Nsight Compute does not run on every machine, so this measures the walk
from inside: it copies csrc/attention_scan_loc_lstm.cu (or each SOURCE
given, a variant of it, with the headers beside it), turns every
``// [phase] name`` comment of scan_bwd into a read of the SM's cycle
counter by thread 0 of block 0 (each marker follows a block barrier, so
the difference between two reads is the time of the phase between
them), builds the copy, and runs K13 at flagship_loc's training shape
and K11 at the conv+BiLSTM recipe's, at B=16 and 128, on chip_smoke.py's
cases (the recipes' seeded weights, its training batch, random
cotangents). It prints the cycles a step of each phase, the time per
call (CUDA events over 5 calls), and each call's parity with the plain
version (the backward tolerance). The counter adds two instructions of
one thread a phase. Exits nonzero without a card.
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
# The entry point each kernel's wrapper calls, by chip_smoke.py's case name.
ENTRY = {"attention_decode_scan_loc_bwd": ("K13", "KERNEL_LOC_BWD"),
         "attention_decode_scan_loc_lstm_bwd": ("K11", "KERNEL_LOC_LSTM_BWD")}


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


def cases():
    """chip_smoke.py's K13 cases at flagship_loc's training shape and K11
    cases at the conv+BiLSTM recipe's, at B=16 and 128."""
    import chip_smoke as smoke
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.train import experiment

    gen = torch.Generator().manual_seed(smoke.SEED + 1)
    out = []
    for recipe, make in ((smoke.flagship_loc, smoke.loc_train_cases),
                         (experiment.timit_conv_bilstm, smoke.cb_train_cases)):
        exp = recipe()
        params = interop.to_torch(
            exp.init_params(torch.Generator().manual_seed(smoke.SEED), device="cpu"), "cuda")
        cfg = exp.build_model().cfg
        for b in (smoke.TRAIN_B, smoke.BIG_B):
            out += [c for c in make(params, cfg, smoke.train_batch(b, smoke.SEED + 3), gen)
                    if c.name in smoke.LOC_BWDS]
    return out


def main(sources) -> int:
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    kernels = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for src in map(pathlib.Path, sources):
        text, names = instrument(src.read_text())
        headers = {h.name: h.read_text() for h in sorted(src.parent.glob("*.cuh"))}
        digest = hashlib.sha1((text + "".join(headers.values())).encode()).hexdigest()[:12]
        copy = build.BUILD_DIR / "phases" / digest
        copy.mkdir(parents=True, exist_ok=True)
        for name, header in headers.items():
            (copy / name).write_text(header)
        out = copy / f"{src.stem}_{digest}.cu"
        out.write_text(text)
        kernels[src] = (names, {
            "K13": build.Kernel("K13 phases", str(out), "attention_decode_scan_loc_bwd",
                                attention_scan.KERNEL_LOC_BWD.argtypes),
            "K11": build.Kernel("K11 phases", str(out), "attention_decode_scan_loc_lstm_bwd",
                                attention_scan.KERNEL_LOC_LSTM_BWD.argtypes)})
    t0 = time.perf_counter()
    build.build_all(k for _, ks in kernels.values() for k in ks.values())
    print(f"scan_phases: built {len(kernels)} copies in {time.perf_counter() - t0:.1f} s ({card})")
    for src, (_, ks) in kernels.items():
        # ptxas -v: each kernel's "Compiling entry" line, then its registers and spills.
        kernel = None
        for line in ks["K13"].build_log.splitlines():
            if "Compiling entry" in line:
                kernel = next((k for k in ("scan_loc_gru_bwd", "loc_lstm_bwd") if k in line), None)
            elif kernel and ("spill" in line or "registers" in line):
                print(f"scan_phases {src} {kernel}: {line.split(':', 1)[-1].strip()}")
    for c in cases():
        name, attr = ENTRY[c.name]
        vh, yin = c.args[0], c.args[3]
        b, l, t = vh.shape[0], vh.shape[1], yin.shape[1]
        with torch.no_grad():
            want = c.plain(*c.args)
        default = getattr(attention_scan, attr)
        for src, (names, ks) in kernels.items():
            setattr(attention_scan, attr, ks[name])
            try:
                read = ks[name].helper("read_phase_cycles", [ctypes.c_void_p, ctypes.c_int])
                with torch.no_grad():
                    got = c.kernel(*c.args)
                    torch.cuda.synchronize()
                    excess = max(float((g - w).abs().max()) - 5e-4 * float(w.abs().max())
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
            per_step = [n / t for n in cycles[:len(names)]]
            print(f"scan_phases {src} {name} B={b} L={l} T={t}: "
                  f"{start.elapsed_time(stop) / 5:.4f} ms per call, parity excess {excess:.3e} "
                  f"({'ok' if excess <= 5e-5 else 'FAILS'}); cycles a step of block 0: "
                  f"{sum(per_step):.0f} = " + ", ".join(
                      f"{p} {n:.0f}" for p, n in zip(names, per_step)) + f" ({card})")
            if excess > 5e-5:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(SOURCE)]))
