"""tools/scan_phases.py rewrites the kernels' sources: a read of the SM's
cycle counter at each `// [phase]` comment of the walk or step a mode
times. These hold that rewrite to the sources as they stand, on the CPU
(the copy is built and run only on the card)."""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "attention_scan_loc_lstm.cu"


def _tool():
    spec = importlib.util.spec_from_file_location("scan_phases", ROOT / "tools" / "scan_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_instrument_reads_the_clock_at_every_phase_of_scan_bwd():
    """The default mode times K13, which walks on decoder_walk<R, false,
    true> (the source has no one-block scan_bwd): its entry point and
    limits helper are in the instrumented source, its walk kernel is that
    instance, and the mode's rewrite reads the clock at every phase marker
    of the walk (the GRU's w_h^T phase and the location term's dfeat
    phase among them) and nowhere else; K13 shares the walk with K5's
    --gru-bwd mode."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    tool = _tool()
    (entry,), (walk,) = tool.MODES["k13"]
    name, attr = tool.ENTRY[entry]
    kernel = getattr(attention_scan, attr)
    assert (name, kernel.symbol, kernel.source) == ("K13", entry, tool.SOURCE)
    src = SOURCE.read_text()
    assert re.search(r"__global__ void __launch_bounds__\(kThreads, 1\) " + walk +
                     r"\(const BwdArgs a\) \{\n.*\n  decoder_walk<R, false, true>\(sm, a\);", src)
    assert f'extern "C" int {entry}(' in src and f'extern "C" int {entry}_limits(' in src
    assert not re.search(r"\bscan_bwd\(", src) and "carve_bwd" not in src
    text, names = tool.instrument_mode("k13", src)
    assert (text, names) == tool.instrument_walk(src)
    assert names == WALK_PHASES
    assert len(names) <= 32  # g_phase_cycles' length
    assert {"w_h^T, da_zr exchange", "dfeat"} <= set(names)
    reads = re.findall(r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", text)
    assert [int(i) for i in reads] == list(range(len(names)))
    assert text.count("long long phase_t0_ = clock64();") == 1
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_instrument_refuses_a_source_without_markers():
    """The default mode (K13) refuses a source whose decoder_walk has no
    phase markers."""
    tool = _tool()
    src = SOURCE.read_text()
    head, rest = src.split(tool.WALK_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    stripped = head + tool.WALK_SIG + re.sub(r"// \[phase\] .*", "", body) + "\n}\n" + tail
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in decoder_walk"):
        tool.instrument_mode("k13", stripped)


K2_SOURCE = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "attention_step.cu"
K2_PHASES = ["load", "ws", "energies", "softmax, context partials", "context", "c_in", "dec_in",
             "gates", "candidate", "maxout", "linear", "log_softmax"]


def _k2_body(text):
    return text.split("attention_step_kernel(const Args a) {", 1)[1].split("\n}\n", 1)[0]


def test_instrument_k2_reads_the_clock_after_every_cluster_barrier():
    tool = _tool()
    src = K2_SOURCE.read_text()
    text, names = tool.instrument_k2(src)
    assert names == K2_PHASES
    assert "// [phase]" not in _k2_body(text)
    reads = re.findall(r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", text)
    assert [int(i) for i in reads] == list(range(len(K2_PHASES)))
    assert _k2_body(text).startswith("\n  long long phase_t0_ = clock64();")
    # Each marker follows a barrier of the block or of the cluster (the
    # energies end with one), or ends the body.
    lines = _k2_body(src).split("\n")
    for i, line in enumerate(lines):
        if "// [phase]" in line:
            before = [x.strip() for x in lines[:i] if x.strip()][-1]
            assert before in ("cluster.sync();", "cluster_wait();", "__syncthreads();") or \
                before.startswith("energies<") or "// [phase]" not in "".join(lines[i + 1:]), before
    # K2's nine cluster barriers (K8's kernel in the same source has its own).
    assert _k2_body(text).count("cluster.sync();") == _k2_body(src).count("cluster.sync();") == 9
    assert text.count("cluster.sync();") == src.count("cluster.sync();")
    # Outside the kernel's body, only the probe is added.
    head, rest = src.split("attention_step_kernel(const Args a) {", 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.endswith(rest.split("\n}\n", 1)[1])


def test_instrument_k2_marks_a_single_block_step():
    """A step without markers (the single-block K2 before clusters) gets
    one after each top-level barrier call, and one at the end."""
    old = ("namespace {\n__global__ void attention_step_kernel(const Args a) {\n"
           "  for (int i = tid; i < S; i += kThreads) we[i] = a.w_e[i];\n  __syncthreads();\n"
           "  attend(w, bufs, vh, K, L, S, St);\n  context(bufs, h, K, L, A, St);\n"
           "  decoder_cell(w, bufs, K, A, St);\n"
           "  matvec<kNone>(a.mo_w, a.mo_b, XO, M * W, xo, XO, mop, M * W, K, scratch);\n"
           "  __syncthreads();\n"
           "  matvec<kNone>(a.lin_w, a.lin_b, M, V, mo, M, lg, V, K, scratch);\n"
           "  if (warp < K) {\n    m = warp_max(m);\n  }\n}\n}  // namespace\n")
    text, names = _tool().instrument_k2(old)
    assert names == ["__syncthreads", "attend", "context", "decoder_cell", "matvec mo_w",
                     "__syncthreads 2", "matvec lin_w", "end"]
    assert len(re.findall(r"g_phase_cycles\[\d+\]", text)) == len(names) + 1  # and the probe's


GRU_WALK = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "gru_walk.cuh"
GRU_FWD_PHASES = ["staging wait", "zr product", "rh push", "candidate product", "h push"]


def _gru_fwd_body(text):
    return text.split("__device__ void gru_walk_fwd(", 1)[1].split("\n}\n", 1)[0]


def test_instrument_gru_fwd_reads_the_clock_after_every_wait():
    """The forward GRU walk's step: a cycle read after each of its
    waits (the staging wait's block barrier, the gate products' block
    barrier, the wait for the peers' r * h, the candidate product's block
    barrier and the wait for the peers' h), each by thread 0 of block 0 of
    direction 0, and the clock started once, before the step loop.
    Outside the walk's body only the probe is added."""
    tool = _tool()
    src = GRU_WALK.read_text()
    text, names = tool.instrument_gru_fwd(src)
    assert names == GRU_FWD_PHASES
    body = _gru_fwd_body(text)
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.y == 0\) \{ const long long c_ = clock64\(\); "
                       r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(GRU_FWD_PHASES)))
    assert body.count("long long phase_t0_ = clock64();") == 1
    assert body.index("long long phase_t0_ = clock64();") < body.index(tool.GRU_FWD_LOOP)
    lines = _gru_fwd_body(src).split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    assert len(marked) == len(GRU_FWD_PHASES)
    before = [[x.strip() for x in lines[:i] if x.strip()][-1] for i in marked]
    assert before == ["__syncthreads();", "__syncthreads();", "mbar_wait(&bars[0], s & 1);",
                      "__syncthreads();", "mbar_wait(&bars[1], s & 1);"]
    # Every marker is inside the step loop.
    loop = next(i for i, line in enumerate(lines) if line == tool.GRU_FWD_LOOP)
    assert all(i > loop for i in marked)
    head, rest = src.split(tool.GRU_FWD_SIG, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(rest.split("\n}\n", 1)[1])
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_instrument_gru_fwd_refuses_a_walk_without_markers():
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in gru_walk_fwd"):
        _tool().instrument_gru_fwd(re.sub(r"// \[phase\] .*", "", GRU_WALK.read_text()))


LSTM_ENC = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "bilstm_scan.cu"
LSTM_ENC_PHASES = [("before the walk", False), ("gates and cell", True),
                   ("push and wait", True)]


def _lstm_enc_body(text, tool):
    return text.split(tool.LSTM_ENC_SIG, 1)[1].split("\n}\n", 1)[0]


def test_instrument_lstm_enc_fwd_reads_the_clock_after_every_wait():
    """K7's walk (--lstm-enc-fwd): a cycle read by thread 0 of block 0 of
    direction 0 at each marker, the clock started once at the top of the
    body; the prologue's marker follows its block barrier and is read
    once a call, the step's follow its block barrier and its wait for the
    peers' h and are read every step. Outside the kernel's body only the
    probe is added."""
    tool = _tool()
    src = LSTM_ENC.read_text()
    text, marks = tool.instrument_lstm_enc_fwd(src)
    assert marks == LSTM_ENC_PHASES
    body = _lstm_enc_body(text, tool)
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.x == 0 && blockIdx.y == 0\) \{ const long long c_ = "
                       r"clock64\(\); g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(LSTM_ENC_PHASES)))
    assert body.startswith("\n  long long phase_t0_ = clock64();")
    assert body.count("long long phase_t0_ = clock64();") == 1
    lines = _lstm_enc_body(src, tool).split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    before = [[x.strip() for x in lines[:i] if x.strip() and not x.strip().startswith("//")][-1]
              for i in marked]
    assert before == ["__syncthreads();", "__syncthreads();", "}"]
    wait = [x.strip() for x in lines[:marked[2]] if "mbar_wait(" in x]
    assert wait == ["mbar_wait(bar, (s >> 1) & 1);"]
    head, rest = src.split(tool.LSTM_ENC_SIG, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(rest.split("\n}\n", 1)[1])
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_instrument_lstm_enc_fwd_refuses_a_walk_without_markers():
    tool = _tool()
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in bilstm_walk"):
        tool.instrument_lstm_enc_fwd(re.sub(r"// \[phase\] .*", "", LSTM_ENC.read_text()))
    src = LSTM_ENC.read_text().replace(tool.LSTM_ENC_LOOP, "  while (true) {")
    with pytest.raises(ValueError, match="no single step loop"):
        tool.instrument_lstm_enc_fwd(src)


# The walk's phases: the GRU-only "w_h^T, da_zr exchange" reads 0 cycles
# in an LSTM walk, and the location term's "dfeat" next to nothing
# without it.
WALK_PHASES = ["staging wait", "cell, E1 exchange", "w_h^T, da_zr exchange",
               "cell products, dr exchange", "dec_w^T, dcc exchange", "c_w^T, dc exchange",
               "context", "energies", "dfeat", "dws exchange", "ws_w^T"]


def _walk_body(text, tool):
    return text.split(tool.WALK_SIG, 1)[1].split("\n}\n", 1)[0]


def test_instrument_lstm_reads_the_clock_after_every_wait():
    """The decoder backwards' walk's step (K11, K15 and K5): a cycle read
    after the staging wait's block barrier, after each exchange's wait for
    the peers' pushes, and after each block barrier between, by thread 0
    of block 0, and the clock started once, before the step loop. Outside
    the walk's body only the probe is added."""
    tool = _tool()
    src = SOURCE.read_text()
    text, names = tool.instrument_walk(src)
    assert names == WALK_PHASES
    body = _walk_body(text, tool)
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.x == 0\) \{ const long long c_ = clock64\(\); "
                       r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(WALK_PHASES)))
    assert body.count("long long phase_t0_ = clock64();") == 1
    assert body.index("long long phase_t0_ = clock64();") < body.index(tool.WALK_LOOP)
    lines = _walk_body(src, tool).split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    before = [[x.strip() for x in lines[:i] if x.strip() and not x.strip().startswith("//")][-1]
              for i in marked]
    waits = [f"if (tid == 0 && s + 1 < T) mbar_expect(&sh.bars[{k}], tx[{k}]);"
             for k in ("0", "eDr", "eDcc", "eDws")]
    assert before == [
        "if (s + 1 < T) stage_step<R, kLstm, kLoc>(a, c, staged(sh, (s + 1) & 1), t - 1);",
        waits[0], "__syncthreads();  // dcin[St:], formed by other warps", waits[1], waits[2],
        "__syncthreads();  // this block's own share of the sum", "__syncthreads();",
        "__syncthreads();", "}", waits[3], "__syncthreads();"]
    loop = next(i for i, line in enumerate(lines) if line == tool.WALK_LOOP)
    assert all(i > loop for i in marked)
    head, rest = src.split(tool.WALK_SIG, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(rest.split("\n}\n", 1)[1])
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_instrument_lstm_refuses_a_walk_without_markers():
    src = SOURCE.read_text()
    head, rest = src.split(_tool().WALK_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in decoder_walk"):
        _tool().instrument_walk(head + _tool().WALK_SIG + re.sub(r"// \[phase\] .*", "", body)
                                + "\n}\n" + tail)


def test_gru_mode_instruments_the_walk_k5_runs():
    """--gru-bwd times K5: its entry point is in the instrumented source,
    its walk kernel is an instance of decoder_walk there, and the
    GRU-only phase (w_h^T before the da_zr exchange) sits in the branch of
    the walk that only the GRU compiles."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    tool = _tool()
    (entry,), (walk,) = tool.MODES["gru"]
    name, attr = tool.ENTRY[entry]
    kernel = getattr(attention_scan, attr)
    assert (name, kernel.symbol, kernel.source) == ("K5", entry, tool.SOURCE)
    src = SOURCE.read_text()
    assert re.search(r"__global__ void __launch_bounds__\(kThreads, 1\) " + walk +
                     r"\(const BwdArgs a\) \{\n.*\n  decoder_walk<R, false, false>\(sm, a\);", src)
    assert f'extern "C" int {entry}(' in src and f'extern "C" int {entry}_limits(' in src
    body = _walk_body(src, tool)
    gru = body.index("if constexpr (kLstm) {", body.index("// [phase] cell, E1 exchange"))
    gru = body.index("} else {", gru)
    assert gru < body.index("// [phase] w_h^T, da_zr exchange") < body.index(
        "// [phase] cell products, dr exchange")
    text, names = tool.instrument_walk(src)
    assert names.index("w_h^T, da_zr exchange") == 2


# The forward walk's phases (K10, K14, K12, K4): the LSTM-only "cell" reads
# 0 cycles in a GRU walk, and the GRU-only "gates", "E3 exchange",
# "candidate" and "update" in an LSTM walk.
FWD_WALK_PHASES = ["staging wait", "E1 exchange", "ws, energies", "softmax shares",
                   "s_prev product, E2 exchange", "combine", "c W_cx", "cell", "gates",
                   "E3 exchange", "candidate", "update", "ws_w, E1 push"]


def test_instrument_lstm_fwd_reads_the_clock_after_every_wait():
    """The decoder forwards' walk (K10 and K14, --lstm-fwd; K12 and K4,
    --gru-dec-fwd): a cycle read after the staging wait's block barrier,
    after each exchange's wait, after each block barrier between and after
    the last push, by thread 0 of block 0, the clock started once, before
    the step loop; outside the walk's body only the probe is added."""
    tool = _tool()
    src = SOURCE.read_text()
    text, names = tool.instrument_fwd_walk(src)
    assert names == FWD_WALK_PHASES
    body = text.split(tool.FWD_WALK_SIG, 1)[1].split("\n}\n", 1)[0]
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.x == 0\) \{ const long long c_ = clock64\(\); "
                       r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(FWD_WALK_PHASES)))
    assert body.count("long long phase_t0_ = clock64();") == 1
    assert body.index("long long phase_t0_ = clock64();") < body.index(tool.FWD_WALK_LOOP)
    lines = src.split(tool.FWD_WALK_SIG, 1)[1].split("\n}\n", 1)[0].split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    before = [[x.strip() for x in lines[:i] if x.strip() and not x.strip().startswith("//")][-1]
              for i in marked]
    waits = [f"if (tid == 0 && t + 1 < T) mbar_expect(&sh.bars[{k}], tx{k + 1});"
             for k in (0, 1, 2)]
    assert before == [
        "if (t + 1 < T) stage(t + 1, (t + 1) & 1);", "}", "__syncthreads();",
        "__syncthreads();", waits[1], "__syncthreads();", "__syncthreads();",
        "__syncthreads();", "__syncthreads();", waits[2], "__syncthreads();",
        "__syncthreads();", "}"]
    assert waits[0] in lines[marked[1] - 2]
    head, rest = src.split(tool.FWD_WALK_SIG, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.endswith(rest.split("\n}\n", 1)[1])
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_lstm_fwd_mode_instruments_the_walk_k10_and_k14_run():
    """--lstm-fwd times K10 and K14: their entry points are in the
    instrumented source, and their walk kernels are instances of
    decoder_fwd_walk there."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    tool = _tool()
    entries, walks = tool.MODES["lstm_fwd"]
    src = SOURCE.read_text()
    for entry, walk, loc in zip(entries, walks, ("true", "false")):
        name, attr = tool.ENTRY[entry]
        kernel = getattr(attention_scan, attr)
        assert (kernel.symbol, kernel.source) == (entry, tool.SOURCE)
        assert re.search(r"__global__ void __launch_bounds__\(kThreads, 1\)\n    " + walk +
                         r"\(const FwdArgs a, const FwdScratch x, int resident\) \{\n.*\n"
                         r"  decoder_fwd_walk<R, true, " + loc + r">\(sm, a, x, resident\);", src)
        assert f'extern "C" int {entry}(' in src and f'extern "C" int {entry}_limits(' in src
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in decoder_fwd_walk"):
        head, rest = src.split(tool.FWD_WALK_SIG, 1)
        body, tail = rest.split("\n}\n", 1)
        tool.instrument_fwd_walk(head + tool.FWD_WALK_SIG + re.sub(r"// \[phase\] .*", "", body)
                                 + "\n}\n" + tail)


def test_gru_dec_fwd_mode_instruments_the_walk_k12_and_k4_run():
    """--gru-dec-fwd times K12 and K4: their entry points and limits
    helpers are in the instrumented source, their walk kernels are the
    GRU instances of decoder_fwd_walk there, and the GRU-only phases (the
    gates, the E3 exchange, the candidate's product, the update) sit in
    the branch of the walk that only the GRU compiles, after c @ W_cx and
    before the E1 push, where the LSTM's cell sits in the other."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    tool = _tool()
    entries, walks = tool.MODES["gru_dec_fwd"]
    assert "gru_dec_fwd" in tool.FWD_MODES
    src = SOURCE.read_text()
    for entry, walk, loc, name in zip(entries, walks, ("true", "false"), ("K12", "K4")):
        assert tool.ENTRY[entry][0] == name
        kernel = getattr(attention_scan, tool.ENTRY[entry][1])
        assert (kernel.symbol, kernel.source, kernel.defines) == (entry, tool.SOURCE,
                                                                  ("GRU_FWD_ONLY",))
        assert re.search(r"__global__ void __launch_bounds__\(kThreads, 1\)\n    " + walk +
                         r"\(const FwdArgs a, const FwdScratch x, int resident\) \{\n.*\n"
                         r"  decoder_fwd_walk<R, false, " + loc + r">\(sm, a, x, resident\);", src)
        assert f'extern "C" int {entry}(' in src and f'extern "C" int {entry}_limits(' in src
    body = src.split(tool.FWD_WALK_SIG, 1)[1].split("\n}\n", 1)[0]
    branch = body.index("if constexpr (kLstm) {", body.index("// [phase] c W_cx"))
    cell = body.index("// [phase] cell", branch)
    gru = body.index("} else {", cell)
    phases = [body.index(f"// [phase] {p}") for p in ("gates", "E3 exchange", "candidate",
                                                     "update", "ws_w, E1 push")]
    assert branch < cell < gru < phases[0] < phases[1] < phases[2] < phases[3] < phases[4]
    text, names = tool.instrument_fwd_walk(src)
    assert names == FWD_WALK_PHASES


# K8's step (cluster_step_loc_lstm_kernel): the LSTM's "cell" reads 0
# cycles in a GRU instance, and the GRU's "gates, r candidate product" and
# "candidate" in an LSTM one; "readout layer" adds up over the layers but
# the last.
K8_PHASES = ["load", "ws, s_prev product", "energies", "softmax, context partials, yin product",
             "context", "c_in", "dec_in", "cell", "gates, r candidate product", "candidate",
             "readout layer", "last layer, log_softmax"]


def _k8_body(text, tool):
    return text.split(tool.K8_SIG, 1)[1].split("\n}\n", 1)[0]


def test_instrument_k8_reads_the_clock_after_every_cluster_barrier():
    """K8's step (--k8): a cycle read by thread 0 of block 0 at each
    marker, each after a barrier of the cluster (or the block's last
    work), the clock started once at the top of the body; K2's kernel and
    the rest of the source are left as they are but for the probe."""
    tool = _tool()
    src = K2_SOURCE.read_text()
    text, names = tool.instrument_k8(src)
    assert names == K8_PHASES
    body = _k8_body(text, tool)
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.x == 0\) \{ const long long c_ = clock64\(\); "
                       r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(K8_PHASES)))
    assert body.startswith("\n  long long phase_t0_ = clock64();")
    assert body.count("long long phase_t0_ = clock64();") == 1
    lines = _k8_body(src, tool).split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    before = [[x.strip() for x in lines[:i] if x.strip() and not x.strip().startswith("//")][-1]
              for i in marked]
    assert before[:-1] == ["cluster_wait();", "cluster_wait();", "energies<1>(vhb, ws, we, e, "
                           "pos.n, Lc, K, S);", "cluster_wait();", "cluster.sync();",
                           "cluster.sync();", "cluster.sync();", "cluster.sync();",
                           "cluster_wait();", "cluster.sync();", "cluster.sync();"]
    # K2's kernel keeps its markers as comments; only the probe is added.
    head, rest = src.split(tool.K8_SIG, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(rest.split("\n}\n", 1)[1])
    assert tool.instrument_k2(src)[1] == K2_PHASES
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)


def test_instrument_k8_refuses_a_kernel_without_markers():
    tool = _tool()
    src = K2_SOURCE.read_text()
    head, rest = src.split(tool.K8_SIG, 1)
    body, tail = rest.split("\n}\n", 1)
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in cluster_step_loc_lstm"):
        tool.instrument_k8(head + tool.K8_SIG + re.sub(r"// \[phase\] .*", "", body) + "\n}\n"
                           + tail)


K3_SOURCE = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "logmel.cu"
K3_PHASES = ["loads, pass 1", "passes 2, 3", "split, power, energy", "mel chunks",
             "filters, store"]


def _k3_body(text):
    return _tool()._k3_body(text)[1]


def test_instrument_k3_reads_the_clock_after_every_barrier():
    """K3 (--k3): a cycle read by thread 0 of block 0 at each marker, the
    clock started once at the top of the body; each marker but the last
    follows a block barrier, and the copy adds one before the last, so
    that it reads the block's slowest thread. Outside the kernel's body
    only the probe is added."""
    tool = _tool()
    src = K3_SOURCE.read_text()
    text, names = tool.instrument_k3(src)
    assert names == K3_PHASES
    body = _k3_body(text)
    assert "// [phase]" not in body
    reads = re.findall(r"blockIdx.x == 0 && blockIdx.y == 0\) \{ const long long c_ = "
                       r"clock64\(\); g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", body)
    assert [int(i) for i in reads] == list(range(len(K3_PHASES)))
    assert body.startswith("\n  long long phase_t0_ = clock64();")
    assert body.count("long long phase_t0_ = clock64();") == 1
    lines = _k3_body(src).split("\n")
    marked = [i for i, line in enumerate(lines) if "// [phase]" in line]
    before = [[x.strip() for x in lines[:i] if x.strip() and not x.strip().startswith("//")][-1]
              for i in marked]
    assert before[:-1] == ["__syncthreads();"] * (len(K3_PHASES) - 1)
    assert body.count("__syncthreads();") == _k3_body(src).count("__syncthreads();") + 1
    last = body.split("\n")[-1]
    assert "g_phase_cycles[4]" in last and body.split("\n")[-2].strip() == "__syncthreads();"
    head, _, tail = tool._k3_body(src)
    assert head.endswith("int S, int nframes, int nchunks) {") and tail.startswith("\n}\n")
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(tail)


def test_instrument_k3_refuses_a_kernel_without_markers():
    head, body, tail = _tool()._k3_body(K3_SOURCE.read_text())
    with pytest.raises(ValueError, match="no // \\[phase\\] markers in stft_logmel_kernel"):
        _tool().instrument_k3(head + re.sub(r"// \[phase\] .*", "", body) + tail)


def test_floor_k3_empties_the_kernels_body_only():
    tool = _tool()
    src = K3_SOURCE.read_text()
    floor = tool.floor_k3(src)
    assert _k3_body(floor).strip() == ""
    head, body, tail = tool._k3_body(src)
    assert body.strip() and floor == head + tail
    assert 'extern "C" int stft_logmel_power(' in tail


def test_k3_argtypes_read_the_entry_points_parameters():
    import ctypes

    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    names, types = _tool().k3_argtypes(K3_SOURCE.read_text())
    assert names == ["yp", "window", "fft_tw", "split_tw", "taps", "tap_start", "mel_first",
                     "lm", "energy", "B", "S", "nframes", "nfreq", "nchunks", "stream"]
    assert types == logmel.KERNEL.argtypes
    assert all(t is ctypes.c_void_p or t is ctypes.c_int for t in types)


def test_k3_block_size_is_read_from_the_source():
    """chip_smoke.py and --k3 print K3's block size from its source's
    kThreads, the size its entry point launches."""
    import chip_smoke

    src = K3_SOURCE.read_text()
    assert chip_smoke.k3_threads(src) == 128
    assert "<<<(unsigned)frames, kThreads, 0, stream>>>" in src
