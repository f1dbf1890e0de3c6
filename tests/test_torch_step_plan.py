"""The plan of the flagship's beam step K2 (ops/cuda/attention_step.py):
the cluster size C per batch row and the shared memory of a block,
pinned at the flagship's widths. The plan is a plain function of the
shapes and of two numbers of the device, so this runs on the CPU."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"
SMEM = 232448  # opt-in shared memory of a block on an H100
# The flagship's decoder: score 512, annotation 512, state 256, maxout
# 64 groups of 7, 62 outputs.
S, A, ST, M, W, V = 512, 512, 256, 64, 7, 62


def flagship_smem(k, l, c):
    return step.step_smem_bytes(k, l, S, A, ST, M, W, V, c)


def flagship_plan(b, resident, smem_limit=SMEM, k=5, l=132):
    return step.step_plan(b, {c: flagship_smem(k, l, c) for c in step.CLUSTERS}, smem_limit,
                          resident)


@pytest.mark.parametrize("b,resident,want", [
    (1, {16: 7, 8: 15}, step.StepPlan(16, 1)),
    (8, {16: 7, 8: 15}, step.StepPlan(8, 1)),    # 8 clusters of 16 do not fit one wave
    (16, {16: 7, 8: 15}, step.StepPlan(8, 2)),   # nor of 8: 8 in waves
    (8, {16: 8, 8: 16}, step.StepPlan(16, 1)),
    (16, {16: 8, 8: 16}, step.StepPlan(8, 1)),
    (40, {16: 7, 8: 15}, step.StepPlan(8, 3)),
    (1, {16: 0, 8: 15}, step.StepPlan(8, 1)),    # a card that refuses clusters of 16
    (16, {16: 7, 8: 0}, step.StepPlan(16, 3)),   # only 16 fits: 16 in waves
])
def test_plan_takes_the_largest_cluster_that_fits_one_wave(b, resident, want):
    assert flagship_plan(b, resident) == want


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), ({8: 15}, 48 * 1024)])
def test_plan_raises_when_no_cluster_fits(resident, smem_limit):
    with pytest.raises(RuntimeError, match="no cluster of 16 or 8 blocks fits the device"):
        flagship_plan(1, resident, smem_limit)


def test_smem_bytes_at_the_flagship_width():
    """The gathered vectors K (7 St + S + A + M + V), w_e, ceil(L / C)
    positions' mask and energies, C K (ceil(A / C) + 3) exchanged
    floats, K clamped sums, the local gates, the block's bias columns,
    the warp partials."""
    gathered = 7 * ST + S + A + M + V
    for k in (5, 8):
        assert flagship_smem(k, 132, 16) == 4 * (k * gathered + S + 9 * (k + 1) + 16 * k * 35 + k
                                                 + k * 32 + (32 + 2 * 16 + 4 * 7 + V)
                                                 + 16 * k * 62)
        assert flagship_smem(k, 132, 8) == 4 * (k * gathered + S + 17 * (k + 1) + 8 * k * 67 + k
                                                + k * 64 + (64 + 2 * 32 + 8 * 7 + V)
                                                + 16 * k * 64)
    assert flagship_smem(5, 132, 16) == 93420
    assert flagship_smem(8, 132, 8) == 149788


@pytest.mark.parametrize("c", step.CLUSTERS)
@pytest.mark.parametrize("k", [1, 5, 8])
def test_no_buffer_grows_with_the_full_length(c, k):
    """L enters only through a block's ceil(L / C) positions, (K + 1)
    floats each; L = 1500 at K = 8 fits."""
    base = flagship_smem(k, 132, c)
    for l in (1, 3, 37, 131, 1500, 4000):
        assert flagship_smem(k, l, c) - base == 4 * (k + 1) * (-(-l // c) - -(-132 // c))
    assert flagship_smem(8, 1500, c) <= SMEM
    assert flagship_plan(1, {16: 7, 8: 15}, k=8, l=1500).waves == 1


def _c_smem_floats():
    """csrc/attention_step.cu's step_smem_floats as a Python function,
    from its source."""
    src = (CSRC / "attention_step.cu").read_text()
    body = re.search(r"long long step_smem_floats\((.*?)\) \{\s*return (.*?);\n\}", src, re.S)
    assert body, "step_smem_floats not found"
    params = re.findall(r"long long (\w+)", body.group(1))
    expr = body.group(2).replace("std::max", "max").replace("std::min", "min")
    expr = expr.replace("128LL", "128").replace("kWarps", str(step.WARPS))
    return eval(f"lambda {', '.join(params)}: ({expr})", {"cdiv": lambda n, d: -(-n // d)})


@pytest.mark.parametrize("shape", [
    (5, 132, S, A, ST, M, W, V), (8, 1500, S, A, ST, M, W, V), (1, 3, 16, 24, 16, 8, 3, 6),
    (5, 37, 16, 20, 12, 4, 2, 7), (8, 64, 64, 48, 32, 8, 7, 10)])
@pytest.mark.parametrize("c", step.CLUSTERS)
def test_the_kernel_lays_out_what_the_plan_counts(shape, c):
    assert 4 * _c_smem_floats()(*shape, c) == step.step_smem_bytes(*shape, c)
