"""The port stands on its own: no module of it, neither chip_smoke.py
nor tools/scan_phases.py, and no tools/*_torch.py script imports JAX or
the JAX package; its entry points need a card unless
asked for the CPU; its kernel wrappers never fall back quietly."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The package's sources; its _build/ (git-ignored) holds build products
# and throwaway copies, which are not the port.
PORT_FILES = sorted(p for p in (ROOT / "seq2seq_attention_asr_tpu_torch").rglob("*.py")
                    if "_build" not in p.relative_to(ROOT).parts) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "scan_phases.py"] + sorted(
    (ROOT / "tools").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "seq2seq_attention_asr_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"serve.py", "beam.py", "features.py", "chip_smoke.py", "gru_scan.py",
            "attention_scan.py", "trainer.py", "optim.py", "initializers.py", "experiment.py",
            "loss.py", "tree.py", "lstm_scan.py", "conv.py", "conv_bilstm.py", "metrics.py",
            "batching.py", "synthetic.py", "timit.py", "greedy.py", "checkpoint.py",
            "debug.py", "monotonic.py", "awn.py", "convergence_torch.py", "audio.py", "flac.py",
            "librispeech.py", "build.py", "editdist.py", "packing.py", "flacdec.py",
            "preprocess_timit_torch.py", "preprocess_librispeech_torch.py",
            "extract_alpha_torch.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from seq2seq_attention_asr_tpu_torch import resolve_device
    from seq2seq_attention_asr_tpu_torch.decode import beam
    from seq2seq_attention_asr_tpu_torch.models import registry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = registry.build("chorowski", hidden_frame_size=4, output_frame_size=4, score_depth=4,
                           state_depth=4, mlp_depth=2, output_depth=3)
    with pytest.raises(RuntimeError):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError):
        beam.beam_search(params["decoder"], model.attention_cfg, torch.zeros(1, 3, 8),
                         torch.tensor([3]), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError):  # asked for the card, given CPU tensors
        beam.beam_search(params["decoder"], model.attention_cfg, torch.zeros(1, 3, 8),
                         torch.tensor([3]), 2)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_take_cpu_or_cuda_tensors_only():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed with the plain version."""
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step, gru_scan,
                                                          logmel, lstm_scan)

    meta = lambda *s: torch.empty(*s, device="meta")
    gru = (meta(1, 2, 12), meta(1, 2, 12), meta(2, 4, 8), meta(2, 4, 4))
    with pytest.raises(ValueError):
        gru_scan.bigru_scan2(*gru)
    with pytest.raises(ValueError):
        gru_scan.bigru_scan2_bwd(*gru, *[meta(1, 2, 4)] * 4)
    one = [(1, 2, 12), (1, 4), (4, 8), (4, 4)]
    one_bwd = [(1, 2, 12), (1, 2, 4), (1, 2, 4), (4, 8), (4, 4)]
    for fn, shapes in ((gru_scan.gru_scan, one), (gru_scan.gru_scan_bwd, one_bwd),
                       (gru_scan.bigru_scan, [(2, *s) for s in one]),
                       (gru_scan.bigru_scan_bwd, [(2, *s) for s in one_bwd])):
        with pytest.raises(ValueError):
            fn(*[meta(*s) for s in shapes])
    with pytest.raises(ValueError):
        logmel.stft_logmel_power(meta(1, 4096), 16000)
    b, t, l, s, a, st = 1, 2, 3, 4, 5, 6
    scan = (meta(b, l, s), meta(b, l, a), meta(b, l), meta(b, t, st), meta(st, s), meta(s),
            meta(s), meta(a, st), meta(st), meta(2 * st, st), meta(st), meta(2 * st, 2 * st),
            meta(2 * st, st))
    with pytest.raises(ValueError):
        attention_scan.attention_decode_scan(*scan)
    with pytest.raises(ValueError):
        attention_scan.attention_decode_scan_bwd(*scan, meta(b, t, st), meta(b, t, a),
                                                 meta(b, t, l), meta(b, t, st), meta(b, t, a),
                                                 meta(b, t, l))
    with pytest.raises(ValueError):
        lstm_scan.bilstm_scan(meta(2, 1, 3, 16), meta(2, 1, 4), meta(2, 1, 4), meta(2, 4, 16))
    cfg = attention.AttentionConfig(score_depth=s, state_depth=st, annotation_depth=a,
                                    output_depth=3, readout=(("linear", 4), ("relu",),
                                                             ("linear", 3)),
                                    feature_maps=2, filt_size=3, cell="lstm")
    params = attention.attention_init(torch.Generator().manual_seed(0), cfg)
    assert not attention_step.uses_k2(cfg)  # K8's configuration
    with pytest.raises(ValueError):
        attention_step.fused_attention_step(
            params, cfg, (meta(b, 2, l), meta(b, 2, st), meta(b, 2, st)), meta(b, 2, 3),
            meta(b, l, s), meta(b, l, a), meta(b, l))
