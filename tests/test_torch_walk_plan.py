"""The plan of the cluster walks of the backward recurrences (K6, K17,
K19 and K9; ops/cuda/walk.py), pinned at the recipes' shapes on the H100's
numbers: 232,448 bytes of opt-in shared memory a block and 15 resident
clusters of 8 blocks, as cudaOccupancyMaxActiveClusters gives them on an
H100 80GB HBM3. The plan is a plain function, so this runs on the CPU."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

SMEM, CLUSTERS = 232448, 15
CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"


@pytest.mark.parametrize("b,h,cell,directions,want", [
    (16, 256, "gru", 2, walk.Plan(8, 4, True)),     # the flagship's K6 at its batch: 8 clusters
    (128, 256, "gru", 2, walk.Plan(8, 8, True)),    # K6 at B=128: 32 clusters in 3 waves
    (16, 256, "gru", 1, walk.Plan(8, 2, True)),     # K17, one direction
    (1, 256, "gru", 2, walk.Plan(8, 1, True)),      # one utterance
    (16, 128, "lstm", 2, walk.Plan(8, 4, True)),    # the conv+BiLSTM recipe's K9
    (16, 1024, "gru", 2, walk.Plan(8, 4, False)),   # the widest state: slices streamed
    (16, 1024, "lstm", 2, walk.Plan(8, 4, False)),
    (3, 400, "gru", 2, walk.Plan(8, 1, False)),     # just above the fit
    (3, 5, "gru", 2, walk.Plan(5, 1, True)),        # fewer units than blocks: C = H
])
def test_plan_at_the_recipes_shapes(b, h, cell, directions, want):
    assert walk.plan(b, h, cell, directions, SMEM, CLUSTERS) == want


@pytest.mark.parametrize("b,clusters,rows", [
    (16, 32, 1), (16, 16, 2), (16, 15, 4), (16, 8, 4), (16, 4, 8), (16, 2, 16), (16, 1, 16),
    (128, 15, 8), (128, 16, 16), (33, 15, 8)])
def test_rows_take_the_fewest_step_costs(b, clusters, rows):
    """Over two directions: the smallest R whose clusters fit one wave
    where one wave holds them; past that, waves * (STEP_ROWS + R) decides
    (B=128 on 15 clusters: R=8 in 3 waves costs 36, R=16 in 2 waves 40,
    R=4 in 5 waves 40)."""
    assert walk.plan(b, 256, "gru", 2, SMEM, clusters).rows == rows


def test_smem_bytes_at_the_flagship_width():
    """H = 256, C = 8: 32 rows of Wzr | Wh (96 KiB), the gathered R x 3H
    cotangents, two buffers of five staged inputs and three held values
    per unit."""
    assert walk.smem_bytes("gru", 256, 8, 4, True) == 4 * (32 * 768 + 4 * 768 + 13 * 4 * 32)
    assert walk.smem_bytes("gru", 256, 8, 16, True) == 174080
    assert walk.smem_bytes("gru", 256, 8, 16, False) == 174080 - 4 * 32 * 768
    assert walk.smem_bytes("lstm", 128, 8, 4, True) == 4 * (16 * 512 + 2 * 4 * 512 + 16 * 4 * 16)


def test_a_streamed_plan_takes_fewer_rows_until_it_fits():
    assert walk.plan(512, 1024, "gru", 2, SMEM, CLUSTERS) == walk.Plan(8, 8, False)
    assert walk.smem_bytes("gru", 1024, 8, 16, False) > SMEM
    with pytest.raises(ValueError):
        walk.plan(1, 1024, "lstm", 2, 4096, CLUSTERS)


def test_the_kernels_lay_out_what_the_plan_counts():
    """csrc's walk_smem_bytes calls carry the same per-cell counts as
    walk.py, so the plan's fit is the kernel's."""
    for cell, path in (("gru", "gru_walk.cuh"), ("lstm", "bilstm_scan_bwd.cu")):
        m = re.search(r"walk_smem_bytes\(p, H, (\d) \* H, (\d), (\d), (\d)\)",
                      (CSRC / path).read_text())
        assert m, path
        assert tuple(int(v) for v in m.groups()) == (walk.WIDTH[cell], walk.GATHERED[cell],
                                                     walk.STAGED[cell], walk.HELD[cell])
