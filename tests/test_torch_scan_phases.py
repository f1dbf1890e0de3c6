"""tools/scan_phases.py rewrites the decoder-scan backward's source: a
read of the SM's cycle counter at each `// [phase]` comment of scan_bwd.
These hold that rewrite to the source as it stands, on the CPU (the
copy is built and run only on the card)."""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "seq2seq_attention_asr_tpu_torch" / "csrc" / "attention_scan_loc_lstm.cu"
PHASES = ["load", "recompute", "cell", "dec_w^T", "c_w^T", "context", "softmax", "energies",
          "dfeat", "carry, conv, ws_w^T", "stash"]


def _tool():
    spec = importlib.util.spec_from_file_location("scan_phases", ROOT / "tools" / "scan_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_instrument_reads_the_clock_at_every_phase_of_scan_bwd():
    tool = _tool()
    src = SOURCE.read_text()
    text, names = tool.instrument(src)
    assert names == PHASES
    assert len(names) <= 32  # g_phase_cycles' length
    assert "// [phase]" not in text
    reads = re.findall(r"g_phase_cycles\[(\d+)\] \+= c_ - phase_t0_", text)
    assert [int(i) for i in reads] == list(range(len(PHASES)))
    assert text.count("long long phase_t0_ = clock64();") == 1
    for a, b in ("{}", "()"):
        assert text.count(a) - text.count(b) == src.count(a) - src.count(b)
    # Outside scan_bwd's body, only the probe is added, before the
    # anonymous namespace.
    sig = "scan_bwd(float* sm, const BwdArgs& a) {"
    head, rest = src.split(sig, 1)
    assert text.replace(tool.PROBE + "\n", "", 1).startswith(head)
    assert text.index(tool.PROBE) < text.index("namespace {")
    assert text.endswith(rest.split("\n}\n", 1)[1])


def test_instrument_refuses_a_source_without_markers():
    with pytest.raises(ValueError, match="no // \\[phase\\] markers"):
        _tool().instrument(re.sub(r"// \[phase\] .*", "", SOURCE.read_text()))
