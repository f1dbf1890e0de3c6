"""Beams wider than one cluster's hypotheses in K2 and K8
(ops/cuda/attention_step.py, csrc/attention_step.cu): a beam of K > 8
hypotheses is cut into hyp_groups(K) balanced groups, one cluster a
(batch row, group), and each block is sized for the largest group. The
plan is a plain function of the shapes and of two numbers of the device,
so this runs on the CPU; the card test holds the kernels to their plain
versions at K = 10 and 16."""

import pathlib
import re

import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"
SMEM = 232448  # opt-in shared memory of a block on an H100
RESIDENT = {16: 7, 8: 15}  # clusters an H100 holds at a block's full shared memory
FLAGSHIP = (512, 512, 256, 64, 7, 62)  # K2's S, A, St, maxout M x W, V


def _groups(k):
    """The hypotheses of each group, as csrc/attention_step.cu's HypGroup
    cuts a row of k: group g takes [g k / G, (g + 1) k / G)."""
    g, _ = step.hyp_groups(k)
    return [list(range(i * k // g, (i + 1) * k // g)) for i in range(g)]


@pytest.mark.parametrize("k,want", [(1, (1, 1)), (5, (1, 5)), (8, (1, 8)), (9, (2, 5)),
                                    (10, (2, 5)), (16, (2, 8)), (17, (3, 6)), (40, (5, 8))])
def test_groups_are_balanced_and_cover_the_beam(k, want):
    """ceil(K / 8) groups, none over 8 hypotheses, sizes within one of each
    other, every hypothesis in exactly one group, in order."""
    assert step.hyp_groups(k) == want
    groups = _groups(k)
    assert [h for grp in groups for h in grp] == list(range(k))
    sizes = [len(grp) for grp in groups]
    assert max(sizes) == want[1] <= step.MAX_K and max(sizes) - min(sizes) <= 1


def test_the_c_source_cuts_the_beam_as_the_plan_counts():
    """hyp_groups in the C source is ceil(K / kMaxK), kMaxK is MAX_K, each
    kernel reads its (row, group) from HypGroup, and each launch takes B G
    clusters with blocks sized for ceil(K / G) hypotheses."""
    src = (CSRC / "attention_step.cu").read_text()
    common = (CSRC / "common.cuh").read_text()
    assert re.search(r"constexpr int kMaxK = (\d+);", common).group(1) == str(step.MAX_K)
    assert "constexpr int hyp_groups(int K) { return cdiv(K, kMaxK); }" in src
    assert src.count("const HypGroup hg(C, a.K, a.G);") == 2
    assert src.count("const size_t row = (size_t)b * a.K + hg.k0;") == 2
    assert src.count("dim3(a.B * a.G * cluster)") == 2
    assert "step_smem_floats(cdiv(a.K, a.G)," in src
    assert "step_loc_lstm_smem_floats(cdiv(a.K, a.G)," in src
    assert "a.K > kMaxK" not in src


@pytest.mark.parametrize("b,k,want", [
    (1, 5, step.StepPlan(16, 1)), (1, 10, step.StepPlan(16, 1)),  # 2 clusters of 16
    (1, 16, step.StepPlan(16, 1)), (4, 10, step.StepPlan(8, 1)),  # 8 clusters: 8 fits one wave
    (8, 16, step.StepPlan(8, 2)),                                 # 16 clusters of 8: two waves
    (2, 17, step.StepPlan(16, 1)),                                # 6 clusters of 16
])
def test_k2_plans_b_times_g_clusters(monkeypatch, b, k, want):
    """K2's plan on the card's numbers counts B G clusters and sizes a
    block for the largest group: K = 16 needs what K = 8 needs."""
    monkeypatch.setattr(step, "step_limits", lambda device: (SMEM, RESIDENT))
    s, a, st, m, w, v = FLAGSHIP
    got = step.step_plan_on(b, k, 132, s, a, st, m, w, v, torch.device("cpu"))
    assert got == want
    g, kg = step.hyp_groups(k)
    smem = {c: step.step_smem_bytes(kg, 132, s, a, st, m, w, v, c) for c in step.CLUSTERS}
    assert got == step.step_plan(b * g, smem, SMEM, RESIDENT)
    if k == 16:
        assert smem == {c: step.step_smem_bytes(8, 132, s, a, st, m, w, v, c)
                        for c in step.CLUSTERS}


# The conv+BiLSTM recipe's decoder (S, A, St, FM, F, lstm) with its readout.
CB = (150, 256, 400, 16, 5, True)
CB_DENSE = [(step.LAYER_KINDS["linear"], 124, 1), (step.LAYER_KINDS["linear"], 62, 1)]


@pytest.mark.parametrize("b,k,want", [
    (2, 10, step.StepPlan(16, 1)), (2, 16, step.StepPlan(16, 1)), (8, 16, step.StepPlan(8, 2)),
    (1, 24, step.StepPlan(16, 1)), (5, 10, step.StepPlan(8, 1)),
])
def test_k8_plans_b_times_g_clusters(monkeypatch, b, k, want):
    monkeypatch.setattr(step, "step_loc_lstm_limits", lambda device, lstm, loc: (SMEM, RESIDENT))
    s, a, st, fm, f, lstm = CB
    got = step.step_loc_lstm_plan_on(b, k, 14, s, a, st, fm, f, lstm, CB_DENSE,
                                     torch.device("cpu"))
    assert got == want
    g, kg = step.hyp_groups(k)
    smem = {c: step.step_loc_lstm_smem_bytes(kg, 14, s, a, st, fm, f, c, lstm, CB_DENSE)
            for c in step.CLUSTERS}
    assert got == step.step_plan(b * g, smem, SMEM, RESIDENT)


def _step_case(cfg, b, k, l, seed):
    gen = torch.Generator().manual_seed(seed)
    params = attention.attention_init(gen, cfg)
    h = torch.randn(b, l, cfg.annotation_depth, generator=gen)
    vh = attention.precompute_vh(params, h)
    mask = (torch.arange(l)[None] < torch.tensor([l, max(1, l - 3)][:b])[:, None]).float()
    st = cfg.state_depth
    state = (torch.softmax(torch.randn(b, k, l, generator=gen), -1),
             0.3 * torch.randn(b, k, st, generator=gen), 0.3 * torch.randn(b, k, st, generator=gen))
    y = torch.nn.functional.one_hot(torch.randint(0, cfg.output_depth, (b, k), generator=gen),
                                    cfg.output_depth).float()
    return params, (state, y, vh, h, mask)


@pytest.mark.parametrize("cell,fm,readout", [
    ("gru", 0, (("maxout", 4, 3), ("linear", 9))),                   # K2's configuration
    ("lstm", 3, (("linear", 11), ("relu",), ("linear", 9))),          # K8's <LSTM, location>
    ("gru", 0, (("maxout", 4, 3), ("linear", 6), ("maxout", 4, 2), ("linear", 9))),  # VGG's
])
@pytest.mark.parametrize("k", [10, 16])
def test_a_wide_beam_step_is_its_groups_steps(cell, fm, readout, k):
    """What the kernels rely on: the step of K > 8 hypotheses equals the
    steps of its hyp_groups taken apart (each group reads the row's vh, h
    and mask), on the plain version that CPU tensors take, within 1e-6
    (the CPU's products block a batch of 2 K rows other than one of 2 K /
    G)."""
    cfg = attention.AttentionConfig(score_depth=12, state_depth=10, annotation_depth=14,
                                    output_depth=9, readout=readout, feature_maps=fm,
                                    filt_size=4, cell=cell)
    params, (state, y, vh, h, mask) = _step_case(cfg, 2, k, 7, seed=k)
    assert step.uses_k2(cfg) == (cell == "gru" and len(readout) == 2)
    (wa, ws, wm), want = step.fused_attention_step(params, cfg, state, y, vh, h, mask)
    for grp in _groups(k):
        sel = lambda t: t[:, grp]
        (ga, gs, gm), got = step.fused_attention_step(params, cfg, tuple(map(sel, state)), sel(y),
                                                      vh, h, mask)
        for key in ("alpha", "c", "s", "logp"):
            np.testing.assert_allclose(got[key].numpy(), sel(want[key]).numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(gm.numpy(), sel(wm).numpy(), rtol=0, atol=1e-6)
        assert np.isfinite(got["logp"].numpy()).all()
