"""The LSTM decoder forwards K10 and K14 (ops/cuda/attention_scan.py
fwd_plan): the plan of their walk on thread-block clusters (the cluster
size C, the batch rows R of a cluster, and whether a block holds its
slice of W_cx in shared memory), the shared memory of a block and the
global scratch of the pre-pass, pinned at the conv+BiLSTM recipe's
widths and held to the C source's counts; and the pre-pass's fold of the
decoder input into the gates (lstm_fold_plain) against the plain scan.
The plan is a plain function of the shapes and two numbers of the device,
so this runs on the CPU."""

import pathlib
import re

import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as scan
from seq2seq_attention_asr_tpu_torch.ops.masking import masked_softmax

CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"
SMEM = 232448  # opt-in shared memory of a block on an H100
RESIDENT = {16: 7, 8: 15}  # clusters of 16 and of 8 blocks an H100 holds at full shared memory
# The conv+BiLSTM recipe's decoder at its training shape: L' = 16 encoder
# positions (144 frames), score 150, annotation 256, state 400; with the
# location term (K10) 16 maps of filter 5, without it (K14) none.
L, S, A, ST = 16, 150, 256, 400
LOC, CONTENT = (16, 5), (0, 0)


def plan(b, resident=RESIDENT, smem_limit=SMEM, loc=LOC, l=L):
    return scan.fwd_plan(b, l, S, A, ST, *loc, smem_limit, resident)


@pytest.mark.parametrize("loc", [LOC, CONTENT])
@pytest.mark.parametrize("b,resident,want", [
    (16, RESIDENT, scan.FwdPlan(8, 2, False, 1)),   # the recipe's batch: 8 clusters of 8
    (128, RESIDENT, scan.FwdPlan(8, 4, False, 3)),  # no plan fills one wave: 32 of 8 in 3
    (1, RESIDENT, scan.FwdPlan(16, 1, True, 1)),    # W_cx's slice fits a block at R = 1
    (5, RESIDENT, scan.FwdPlan(16, 1, True, 1)),    # 5 clusters of one row each
    (16, {16: 0, 8: 15}, scan.FwdPlan(8, 2, False, 1)),  # a card that refuses clusters of 16
    (5, {16: 0, 8: 15}, scan.FwdPlan(8, 1, False, 1)),
    (128, {16: 8, 8: 16}, scan.FwdPlan(8, 8, False, 1)),
    (128, {16: 7, 8: 3}, scan.FwdPlan(16, 4, False, 5)),  # few clusters of 8: 32 of 16 in 5
])
def test_fwd_plan_at_the_recipes_batches(loc, b, resident, want):
    assert plan(b, resident, loc=loc) == want
    assert want.args() == (want.cluster, want.rows, int(want.resident))


@pytest.mark.parametrize("b", [1, 2, 3, 5, 7, 8, 16, 28, 56])
def test_fwd_plan_fills_one_wave_where_it_can(b):
    got = plan(b)
    assert got.waves == 1
    assert -(-b // got.rows) <= RESIDENT[got.cluster]


@pytest.mark.parametrize("loc", [LOC, CONTENT])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_w_cx_resident_exactly_where_it_fits(loc, c, r):
    """A block holds its 4 ceil(St / C) rows of W_cx^T (A floats each) in
    shared memory where the layout with them fits; the plan takes that
    layout whenever it can."""
    streamed = scan.fwd_smem_bytes(r, c, L, S, A, ST, *loc)
    held = scan.fwd_smem_bytes(r, c, L, S, A, ST, *loc, resident=True)
    assert held - streamed == 4 * 4 * -(-ST // 4 // c) * 4 * A
    one = {c: 64, 24 - c: 0}  # only clusters of C: the plan takes some R of them
    got = scan.fwd_plan(1, L, S, A, ST, *loc, SMEM, one, {(cc, rr): float(rr != r)
                                                           for cc in scan.WALK_CLUSTERS
                                                           for rr in scan.WALK_ROWS})
    if streamed <= SMEM:
        assert (got.cluster, got.rows) == (c, r)
        assert got.resident == (held <= SMEM)


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), (RESIDENT, 16 * 1024)])
@pytest.mark.parametrize("loc", [LOC, CONTENT])
def test_fwd_plan_raises_when_no_cluster_fits(resident, smem_limit, loc):
    with pytest.raises(RuntimeError, match="LSTM decoder scan forward: no cluster of 16 or 8 "
                                           "blocks fits the device"):
        plan(1, resident, smem_limit, loc)


def test_fwd_smem_bytes_at_the_recipe():
    """K10 and K14 at the recipe's widths: every R but 8 fits a block on
    clusters of 16 (the blocks' softmax shares, C x R rows of A + 2
    floats, and ws partials take 215 KB of it at R = 8), every R on
    clusters of 8; W_cx's slice fits beside the rest only on clusters of
    16 at R <= 2."""
    got = {(c, r): (scan.fwd_smem_bytes(r, c, L, S, A, ST, *LOC),
                    scan.fwd_smem_bytes(r, c, L, S, A, ST, *CONTENT),
                    scan.fwd_smem_bytes(r, c, L, S, A, ST, *LOC, resident=True))
           for c in scan.WALK_CLUSTERS for r in scan.WALK_ROWS}
    assert got == {
        (16, 1): (61296, 50208, 175984), (16, 2): (94064, 82928, 208752),
        (16, 4): (159616, 148384, 274304), (16, 8): (290800, 279344, 405488),
        (8, 1): (63728, 52640, 276720), (8, 2): (84528, 73392, 297520),
        (8, 4): (126224, 114960, 339216), (8, 8): (209616, 198096, 422608)}


@pytest.mark.parametrize("loc", [LOC, CONTENT])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
@pytest.mark.parametrize("resident", [False, True])
def test_no_fwd_buffer_grows_with_the_full_length(loc, c, r, resident):
    """L enters only through a block's ceil(L / C) positions (and the
    filter's window, whose reach is fixed): lengths with the same
    ceil(L / C) take the same bytes, and each further position of a block
    adds the same few floats a row whatever L is: the energies and their
    exponentials, the mask, and with the location term alpha_prev and the
    peers' energies."""
    smem = lambda l: scan.fwd_smem_bytes(r, c, l, S, A, ST, *loc, resident)
    for p in (1, 2, 5, 40):
        assert smem(c * (p - 1) + 1) == smem(c * p)
    per = (smem(c * 400) - smem(c * 200)) / 200
    assert per == pytest.approx((smem(c * 4000) - smem(c * 2000)) / 2000, rel=0.01)
    assert per == pytest.approx(4 * r * (5 if loc[0] else 3), rel=0.01)


# The longest encoder output of one batch row (B = 1: C = 16, R = 1,
# W_cx streamed at that length), from the formula: K10 and K14 took one
# row's whole step in a block before (K14 L' <= 25,554); the card test
# runs the longest and sees one more refused.
@pytest.mark.parametrize("loc,l_max", [(LOC, 136960), (CONTENT, 243008)])
def test_the_longest_encoder_output(loc, l_max):
    assert scan.fwd_smem_bytes(1, 16, l_max, S, A, ST, *loc) <= SMEM
    assert scan.fwd_smem_bytes(1, 16, l_max + 1, S, A, ST, *loc) > SMEM
    assert plan(1, loc=loc, l=l_max) == scan.FwdPlan(16, 1, False, 1)
    with pytest.raises(RuntimeError):
        plan(1, loc=loc, l=l_max + 1)


def _c_function(name):
    """A function of csrc/attention_scan_loc_lstm.cu that returns one
    expression of its long long parameters, as a Python function; kBarsFwd
    read from the source and held to FWD_BARS, kWarps from common.cuh's
    kThreads and held to FWD_WARPS."""
    src = (CSRC / "attention_scan_loc_lstm.cu").read_text()
    body = re.search(r"long long " + name + r"\((.*?)\) \{\s*return (.*?);\n\}", src, re.S)
    assert body, f"{name} not found"
    bars = re.findall(r"constexpr int kBarsFwd = (\d+);", src)
    assert [int(b) for b in bars] == [scan.FWD_BARS]
    threads = re.findall(r"constexpr int kThreads = (\d+);", (CSRC / "common.cuh").read_text())
    assert [int(t) // 32 for t in threads] == [scan.FWD_WARPS]
    params = re.findall(r"long long (\w+)", body.group(1))
    expr = re.sub(r"\bkBarsFwd\b", bars[0], body.group(2))
    expr = re.sub(r"\bkWarps\b", str(scan.FWD_WARPS), expr)
    return eval(f"lambda {', '.join(params)}: ({expr})",
                {"cdiv": lambda n, d: -(-n // d), "r4": lambda n: -(-n // 4) * 4,
                 "cspan": lambda n, c: -(-n // c) if n % 4 else 4 * -(-(n // 4) // c)})


# (L, S, A, St, FM, F): the recipe's widths with and without the location
# term; St and A not multiples of 4; L < C; FM not a multiple of 4; S not
# one; the longest encoder outputs.
@pytest.mark.parametrize("shape", [
    (L, S, A, ST, 16, 5), (L, S, A, ST, 0, 0), (1, 17, 12, 9, 3, 4), (3, 17, 12, 9, 0, 0),
    (37, 64, 40, 33, 0, 0), (20, 600, 24, 33, 4, 5), (40, 40, 24, 33, 20, 31),
    (136960, S, A, ST, 16, 5), (243008, S, A, ST, 0, 0), (37, 64, 42, 36, 0, 0),
    (5, 7, 5, 3, 3, 6)])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
@pytest.mark.parametrize("resident", [0, 1])
def test_the_forward_walk_lays_out_what_the_plan_counts(shape, c, r, resident):
    l, s, a, st, fm, f = shape
    assert 4 * _c_function("fwd_smem_floats")(r, c, l, s, a, st, fm, f, int(fm > 0), resident) \
        == scan.fwd_smem_bytes(r, c, l, s, a, st, fm, f, bool(resident))


@pytest.mark.parametrize("b,t,a,st", [(16, 56, 256, 400), (128, 56, 256, 400), (3, 5, 12, 9),
                                      (1, 1, 5, 3), (5, 7, 42, 33)])
def test_the_forward_scratch_is_what_the_kernel_carves(b, t, a, st):
    assert _c_function("fwd_scratch_floats")(b, t, a, st) == scan.fwd_scratch_floats(b, t, a, st)


def test_forward_scratch_at_the_recipe():
    """The pre-pass's scratch at the recipe's training shape: 11.8 MB at
    B=16 and 62.0 MB at B=128."""
    assert scan.fwd_scratch_floats(16, 56, A, ST) == 2_944_000
    assert scan.fwd_scratch_floats(128, 56, A, ST) == 15_488_000


def _folded_scan(vh, h, enc_mask, yin, weights, loc):
    """The LSTM scan as the kernels compute it: P and W_cx from the
    pre-pass (lstm_fold_plain), then each step's gates s_prev @ w_h + P[:,
    t] + c @ W_cx."""
    ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b, w_h, w_x, b = weights[:10]
    p, w_cx = scan.lstm_fold_plain(yin, c_w, c_b, dec_w, dec_b, w_x, b)
    s = yin.new_zeros(yin.shape[0], yin.shape[2])
    mem, alpha = torch.zeros_like(s), vh.new_zeros(vh.shape[:2])
    outs = ([], [], [], [])
    for t in range(yin.shape[1]):
        z = vh + (s @ ws_w + ws_b)[:, None, :]
        if loc:
            z = z + scan._loc_features(alpha, weights[10], weights[11]) @ weights[12]
        alpha = masked_softmax(torch.tanh(z) @ w_e, enc_mask)
        c = torch.einsum("bl,bla->ba", alpha, h)
        g_in, g_forget, g_cell, g_out = (s @ w_h + p[:, t] + c @ w_cx).chunk(4, dim=-1)
        mem = torch.sigmoid(g_forget) * mem + torch.sigmoid(g_in) * torch.tanh(g_cell)
        s = torch.sigmoid(g_out) * torch.tanh(mem)
        for seq, v in zip(outs, (s, c, alpha, mem)):
            seq.append(v)
    return tuple(torch.stack(x, dim=1) for x in outs)


@pytest.mark.parametrize("loc", [True, False])
def test_the_fold_computes_the_plain_scan(loc):
    """On a small seeded case with ragged encoder lengths and a row whose
    every position is masked, the folded form gives _scan_plain's four
    sequences within 1e-5 (the kernels' forward tolerance is 1e-4), and
    that row's alpha and c are exactly 0."""
    rng = np.random.RandomState(3)
    b, t, l, s_dim, a_dim, st, fm, f = 3, 6, 7, 11, 9, 5, 3, 4
    rnd = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32))
    vh, h, yin = rnd(b, l, s_dim), rnd(b, l, a_dim, scale=0.5), rnd(b, t, st, scale=0.5)
    mask = torch.from_numpy((np.arange(l)[None] < np.array([7, 4, 0])[:, None]).astype(np.float32))
    weights = [rnd(st, s_dim, scale=st ** -0.5), rnd(s_dim, scale=0.3),
               rnd(s_dim, scale=s_dim ** -0.5), rnd(a_dim, st, scale=a_dim ** -0.5),
               rnd(st, scale=0.3), rnd(2 * st, st, scale=(2 * st) ** -0.5), rnd(st, scale=0.3),
               rnd(st, 4 * st, scale=st ** -0.5), rnd(st, 4 * st, scale=st ** -0.5),
               rnd(4 * st, scale=0.3)]
    if loc:
        weights += [rnd(f, fm, scale=0.5), rnd(fm, scale=0.3), rnd(fm, s_dim, scale=fm ** -0.5)]
    want = scan._scan_plain(vh, h, mask, yin, weights, lstm=True)
    got = _folded_scan(vh, h, mask, yin, weights, loc)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5
    assert not got[1][2].any() and not got[2][2].any()
    p, w_cx = scan.lstm_fold_plain(yin, *weights[3:7], *weights[8:10])
    assert p.shape == (b, t, 4 * st) and w_cx.shape == (a_dim, 4 * st)
