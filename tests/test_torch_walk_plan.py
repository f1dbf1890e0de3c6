"""The plan of the cluster walks of the recurrences (ops/cuda/walk.py):
the GRU forward (K1, K16, K18), the GRU backward (K6, K17, K19), the
LSTM forward (K7) and the LSTM backward (K9), pinned at the recipes'
shapes on the H100's numbers:
232,448 bytes of opt-in shared memory a block and 15 resident clusters of
8 blocks, as cudaOccupancyMaxActiveClusters gives them on an H100 80GB
HBM3. The plan is a plain function, so this runs on the CPU."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

SMEM, CLUSTERS = 232448, 15
# The forward walk's kernels hold their two mbarriers (16 bytes) in static
# shared memory, which their limits helper takes off the opt-in size.
SMEM_FWD = SMEM - 16
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
    walk.py, so the plan's fit is the kernel's: the backward GRU walk's
    (gru_walk_smem_bytes), the forward's (gru_fwd_smem_bytes), the LSTM
    backward's and the LSTM forward's (lstm_fwd_smem_bytes)."""
    for cell, path, fn in (("gru", "gru_walk.cuh", "gru_walk_smem_bytes"),
                           ("gru_fwd", "gru_walk.cuh", "gru_fwd_smem_bytes"),
                           ("lstm", "bilstm_scan_bwd.cu", "lstm_walk_smem_bytes"),
                           ("lstm_fwd", "bilstm_scan.cu", "lstm_fwd_smem_bytes")):
        m = re.search(fn + r"\(const WalkPlan& p, int H\) \{\n  return walk_smem_bytes\(p, H, "
                      r"(\d) \* H, (\d) \* H, (\d), (\d)\);", (CSRC / path).read_text())
        assert m, (path, fn)
        assert tuple(int(v) for v in m.groups()) == (walk.WIDTH[cell], walk.GATHERED[cell],
                                                     walk.STAGED[cell], walk.HELD[cell])


def test_the_forward_kernels_size_their_launch_by_the_forward_cell():
    """Each forward source sizes its shared memory with
    gru_fwd_smem_bytes (through run_gru_fwd), and each wrapper asks
    walk.py for the "gru_fwd" plan of its directions."""
    walk_src = (CSRC / "gru_walk.cuh").read_text()
    run = walk_src.split("cudaError_t run_gru_fwd(", 1)[1].split("\n}\n", 1)[0]
    assert "gru_fwd_smem_bytes(p, g.H)" in run
    for source in ("bigru_scan2.cu", "gru_scan.cu"):
        assert "run_gru_fwd(" in (CSRC / source).read_text(), source
    wrappers = (CSRC.parent / "ops" / "cuda" / "gru_scan.py").read_text()
    assert 'walk.plan_on(KERNEL, b, h, "gru_fwd", 2, dev)' in wrappers
    assert 'walk.plan_on(kernel, b, h, "gru_fwd", lead[0] if lead else 1, dev)' in wrappers


# The forward walk (K1 two directions, K16 one, K18 two) at the recipes'
# batches and H = 256, and at the widths of the card tests. K1 at B=128
# takes 32 clusters of 8 rows in 3 waves; K16 at B=128 16 clusters of 8
# rows in 2 waves, not 8 clusters of 16 rows in one (the forward's R = 16
# step costs 2.8 times its R = 8 step). H = 300 still fits (hm = 38 units a
# block: 136.8 KB of weights), H = 400 does not (240 KB), nor H = 1024.
@pytest.mark.parametrize("b,h,directions,want", [
    (1, 256, 2, walk.Plan(8, 1, True)),      # K1 serving one utterance
    (8, 256, 2, walk.Plan(8, 2, True)),      # K1 serving a batch of 8
    (16, 256, 2, walk.Plan(8, 4, True)),     # K1 and K18 at the recipes' batch
    (128, 256, 2, walk.Plan(8, 8, True)),    # K1 at B=128: 3 waves
    (1, 256, 1, walk.Plan(8, 1, True)),      # K16, one direction
    (8, 256, 1, walk.Plan(8, 1, True)),
    (16, 256, 1, walk.Plan(8, 2, True)),
    (128, 256, 1, walk.Plan(8, 8, True)),     # K16 at B=128: 2 waves
    (16, 300, 2, walk.Plan(8, 4, True)),     # unequal slices of 37 and 38 units, resident
    (3, 400, 2, walk.Plan(8, 1, False)),     # just above the fit: streamed
    (16, 1024, 2, walk.Plan(8, 4, False)),   # the widest state: streamed
    (16, 1024, 1, walk.Plan(8, 2, False)),
    (16, 387, 1, walk.Plan(8, 2, False)),     # resident only up to R = 1 at H = 387
    (1, 387, 1, walk.Plan(8, 1, True)),
    (3, 5, 2, walk.Plan(5, 1, True)),        # fewer units than blocks: C = H
    (16, 7, 1, walk.Plan(7, 2, True)),
    (5, 16, 2, walk.Plan(8, 1, True)),       # C = 8 blocks of 2 units
])
def test_forward_plan_at_the_recipes_shapes(b, h, directions, want):
    assert walk.plan(b, h, "gru_fwd", directions, SMEM_FWD, CLUSTERS) == want


def test_forward_smem_bytes_at_the_flagship_width():
    """H = 256, C = 8: the 32 units' columns of Wzr and Wh (96 KiB), the
    gathered h and r * h (R x 2H), two buffers of three staged inputs and
    z per unit."""
    assert walk.smem_bytes("gru_fwd", 256, 8, 1, True) == 4 * (32 * 768 + 512 + 7 * 32)
    assert walk.smem_bytes("gru_fwd", 256, 8, 16, True) == 145408
    assert walk.smem_bytes("gru_fwd", 256, 8, 16, False) == 145408 - 4 * 32 * 768
    # The widest resident state at C = 8 is narrower as R grows.
    fits = lambda h, r: walk.smem_bytes("gru_fwd", h, 8, r, True) <= SMEM_FWD
    assert fits(387, 1) and not fits(388, 1)
    assert fits(376, 4) and not fits(377, 4)


def test_a_streamed_forward_plan_fits_every_width_the_kernels_take():
    """Streamed at H = MAX_H, any R the cost picks fits: R x (2H + 7 H/C)
    floats fit a block at R = 16."""
    assert walk.smem_bytes("gru_fwd", 1024, 8, 16, False) <= SMEM_FWD
    assert walk.plan(512, 1024, "gru_fwd", 2, SMEM_FWD, CLUSTERS) == walk.Plan(8, 8, False)


@pytest.mark.parametrize("b,clusters,directions,rows", [
    (128, 15, 1, 8), (128, 15, 2, 8), (256, 15, 1, 8), (16, 15, 2, 4), (16, 15, 1, 2),
    (8, 15, 2, 2), (16, 2, 2, 8), (16, 1, 2, 8)])
def test_forward_rows_take_the_fewest_measured_step_costs(b, clusters, directions, rows):
    """The forward's waves * STEP_COST["gru_fwd"][R]. Doubling R at most
    halves the waves, and a wave at R = 16 costs 2.75 times one at R = 8,
    so the plan never takes R = 16: B=16 on one cluster at a time takes
    R=8 in 4 waves (27.6) over R=16 in 2 (38.0)."""
    assert walk.plan(b, 256, "gru_fwd", directions, SMEM_FWD, clusters).rows == rows


# The LSTM forward walk (K7, cell "lstm_fwd"), two directions, at the
# conv+BiLSTM recipe's batches and H = 128, and at the widths of the card
# tests. Its kernel, like the GRU forward's, holds two mbarriers in static
# shared memory. H = 336 is the widest resident state at R = 1 (its 42
# units' four gate columns take 225.8 KB), H = 1024 streams.
@pytest.mark.parametrize("b,h,want", [
    (1, 128, walk.Plan(8, 1, True)),      # serving one utterance: 2 clusters
    (8, 128, walk.Plan(8, 2, True)),      # serving eight: 8 clusters in one wave
    (16, 128, walk.Plan(8, 4, True)),     # the recipe's training batch: 8 clusters
    (128, 128, walk.Plan(8, 8, True)),    # B=128: 32 clusters in 3 waves
    (33, 128, walk.Plan(8, 8, True)),     # a part-empty last row group
    (3, 5, walk.Plan(5, 1, True)),        # fewer units than blocks: C = H
    (3, 40, walk.Plan(8, 1, True)),       # 5 units a block
    (3, 336, walk.Plan(8, 1, True)),
    (3, 337, walk.Plan(8, 1, False)),     # just above the fit: streamed
    (16, 1024, walk.Plan(8, 4, False)),   # the widest state
    (1, 1024, walk.Plan(8, 1, False)),
])
def test_lstm_forward_plan_at_the_recipes_shapes(b, h, want):
    assert walk.plan(b, h, "lstm_fwd", 2, SMEM_FWD, CLUSTERS) == want


def test_lstm_forward_smem_bytes_at_the_recipes_width():
    """H = 128, C = 8: the 16 units' four gate columns of W_h (32 KiB),
    two buffers of the gathered h (R x H each), two buffers of the four
    staged gate inputs and c per unit; streamed at H = MAX_H, R = 16 still
    fits."""
    assert walk.smem_bytes("lstm_fwd", 128, 8, 1, True) == 4 * (16 * 512 + 2 * 128 + 9 * 16)
    assert walk.smem_bytes("lstm_fwd", 128, 8, 16, True) == 58368
    assert walk.smem_bytes("lstm_fwd", 128, 8, 16, False) == 58368 - 4 * 16 * 512
    fits = lambda h, r: walk.smem_bytes("lstm_fwd", h, 8, r, True) <= SMEM_FWD
    assert fits(336, 1) and not fits(337, 1)
    assert fits(328, 4) and not fits(329, 4)
    assert walk.smem_bytes("lstm_fwd", 1024, 8, 16, False) <= SMEM_FWD


@pytest.mark.parametrize("b,clusters,rows", [
    (1, 15, 1), (8, 15, 2), (16, 15, 4), (128, 15, 8), (256, 15, 8), (16, 2, 8), (16, 1, 8),
    (8, 4, 4)])
def test_lstm_forward_rows_take_the_fewest_measured_step_costs(b, clusters, rows):
    """The LSTM forward's waves * STEP_COST["lstm_fwd"][R]: the smallest R
    that fits one wave where one does (B=8: R=2, 8 clusters), R=8 in 3
    waves at B=128; never R = 16, whose step (its 4 x 16 sums a lane spill
    into a stack frame) costs 3.8 times the one at R = 8."""
    assert walk.plan(b, 128, "lstm_fwd", 2, SMEM_FWD, clusters).rows == rows


def test_the_lstm_forward_sizes_its_launch_by_its_cell():
    """bilstm_scan.cu sizes K7's shared memory with lstm_fwd_smem_bytes,
    launches its walk on clusters and keeps no one-block body, for both
    of its entries (float32 and bf16); its wrapper asks walk.py for the
    "lstm_fwd" plan of two directions for both."""
    src = (CSRC / "bilstm_scan.cu").read_text()
    run = src.split("int bilstm_scan_run(", 1)[1].split("\n}\n", 1)[0]
    assert "lstm_fwd_smem_bytes(plan, a.H)" in run and "launch_cluster(" in run
    for entry in ("bilstm_scan_fwd(", "bilstm_scan_fwd_bf16("):
        body = src.split(f'extern "C" int {entry}', 1)[1].split("\n}\n", 1)[0]
        assert "return bilstm_scan_run(" in body
    assert "matvec" not in src and "kRows" not in src
    wrapper = (CSRC.parent / "ops" / "cuda" / "lstm_scan.py").read_text()
    assert 'walk.plan_on(KERNEL, b, h, "lstm_fwd", 2, dev)' in wrapper
