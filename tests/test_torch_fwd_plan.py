"""The decoder forwards K10 and K14 (the LSTM cell) and K12 and K4 (the
GRU) (ops/cuda/attention_scan.py fwd_plan): the plan of their walk on
thread-block clusters (the cluster size C, the batch rows R of a cluster,
and whether a block holds its slice of W_cx in shared memory), the shared
memory of a block and the global scratch of the pre-pass, pinned at the
conv+BiLSTM recipe's widths (K10, K14) and at the flagship's (K12, K4)
and held to the C source's counts; and the pre-pass's fold of the
decoder input into the gates (lstm_fold_plain, gru_fold_plain) against
the plain scan. The plan is a plain function of the shapes, the cell and
two numbers of the device, so this runs on the CPU."""

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
# The flagship's decoder at its training shape: L = 144 frames, score 512,
# annotation 512, state 256; with the location term (K12, flagship_loc) 16
# maps of the recipe's filter 10, without it (K4) none.
FL, FS, FA, FST = 144, 512, 512, 256
FLOC = (16, 10)
WIDTHS = {"lstm": (L, S, A, ST), "gru": (FL, FS, FA, FST)}
# The forward walk's four instances, (cell, (FM, F)): K10 and K14 under the
# ids their cases had before the GRU's joined them, then K12 and K4.
KINDS = [pytest.param("lstm", LOC, id="loc0"), pytest.param("lstm", CONTENT, id="loc1"),
         pytest.param("gru", FLOC, id="K12"), pytest.param("gru", CONTENT, id="K4")]


def plan(b, resident=RESIDENT, smem_limit=SMEM, loc=LOC, l=None, cell="lstm"):
    l0, s, a, st = WIDTHS[cell]
    return scan.fwd_plan(b, l0 if l is None else l, s, a, st, *loc, smem_limit, resident,
                         cell=cell)


# The plans by instance (K10, K14, K12, K4) at each batch and device.
P = scan.FwdPlan


@pytest.mark.parametrize("cell,loc", KINDS)
@pytest.mark.parametrize("b,resident,want", [
    # the recipes' batch: 8 clusters of 8
    (16, RESIDENT, {"loc0": P(8, 2, False, 1), "loc1": P(8, 2, False, 1),
                    "K12": P(8, 2, False, 1), "K4": P(8, 2, False, 1)}),
    # no plan fills one wave: 32 clusters of 8 (K12: 64)
    (128, RESIDENT, {"loc0": P(8, 4, False, 3), "loc1": P(8, 4, False, 3),
                     "K12": P(8, 2, False, 5), "K4": P(8, 4, False, 3)}),
    # W_cx's slice fits a block at R = 1 (the GRU's only without the location term)
    (1, RESIDENT, {"loc0": P(16, 1, True, 1), "loc1": P(16, 1, True, 1),
                   "K12": P(16, 1, False, 1), "K4": P(16, 1, True, 1)}),
    # 5 clusters of one row each
    (5, RESIDENT, {"loc0": P(16, 1, True, 1), "loc1": P(16, 1, True, 1),
                   "K12": P(16, 1, False, 1), "K4": P(16, 1, True, 1)}),
    # a card that refuses clusters of 16
    (16, {16: 0, 8: 15}, {"loc0": P(8, 2, False, 1), "loc1": P(8, 2, False, 1),
                          "K12": P(8, 2, False, 1), "K4": P(8, 2, False, 1)}),
    (5, {16: 0, 8: 15}, {"loc0": P(8, 1, False, 1), "loc1": P(8, 1, False, 1),
                         "K12": P(8, 1, False, 1), "K4": P(8, 1, False, 1)}),
    (128, {16: 8, 8: 16}, {"loc0": P(8, 8, False, 1), "loc1": P(8, 8, False, 1),
                           "K12": P(8, 2, False, 4), "K4": P(8, 4, False, 2)}),
    # few clusters of 8: 32 of 16 in 5 (the GRU: 64 of 16 in 10)
    (128, {16: 7, 8: 3}, {"loc0": P(16, 4, False, 5), "loc1": P(16, 4, False, 5),
                          "K12": P(16, 2, False, 10), "K4": P(16, 2, False, 10)}),
], ids=["16-resident0-want0", "128-resident1-want1", "1-resident2-want2", "5-resident3-want3",
        "16-resident4-want4", "5-resident5-want5", "128-resident6-want6", "128-resident7-want7"])
def test_fwd_plan_at_the_recipes_batches(request, cell, loc, b, resident, want):
    kind = request.node.callspec.id.split("-")[-1]
    got = plan(b, resident, loc=loc, cell=cell)
    assert got == want[kind]
    assert got.args() == (got.cluster, got.rows, int(got.resident))


@pytest.mark.parametrize("b", [1, 2, 3, 5, 7, 8, 16, 28, 56])
def test_fwd_plan_fills_one_wave_where_it_can(b):
    got = plan(b)
    assert got.waves == 1
    assert -(-b // got.rows) <= RESIDENT[got.cluster]


@pytest.mark.parametrize("cell,loc", KINDS)
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_w_cx_resident_exactly_where_it_fits(cell, loc, c, r):
    """A block holds its G ceil(St / C) rows of W_cx^T (A floats each; G
    = 4 gates for the LSTM, 3 for the GRU) in shared memory where the
    layout with them fits; the plan takes that layout whenever it can."""
    l, s, a, st = WIDTHS[cell]
    streamed = scan.fwd_smem_bytes(r, c, l, s, a, st, *loc, cell=cell)
    held = scan.fwd_smem_bytes(r, c, l, s, a, st, *loc, resident=True, cell=cell)
    assert held - streamed == 4 * scan.FWD_GATES[cell] * 4 * -(-st // 4 // c) * a
    one = {c: 64, 24 - c: 0}  # only clusters of C: the plan takes some R of them
    got = scan.fwd_plan(1, l, s, a, st, *loc, SMEM, one, {(cc, rr): float(rr != r)
                                                          for cc in scan.WALK_CLUSTERS
                                                          for rr in scan.WALK_ROWS}, cell)
    if streamed <= SMEM:
        assert (got.cluster, got.rows) == (c, r)
        assert got.resident == (held <= SMEM)


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), (RESIDENT, 16 * 1024)])
@pytest.mark.parametrize("cell,loc", KINDS)
def test_fwd_plan_raises_when_no_cluster_fits(resident, smem_limit, cell, loc):
    with pytest.raises(RuntimeError, match="^decoder scan forward: no cluster of 16 or 8 "
                                           "blocks fits the device"):
        plan(1, resident, smem_limit, loc, cell=cell)


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


def test_gru_fwd_smem_bytes_at_the_flagship():
    """K12 and K4 at the flagship's widths (S = A = 512 take C x R x 512
    floats of ws partials and C x R x 516 of softmax shares, and a block's
    ws_w rows 512 floats a unit): R <= 2 fits a block on clusters of 16
    and of 8, and K4's R = 4 on clusters of 8 (with 3,040 bytes to spare,
    the E3 buffer in ws's floats); W_cx's slice (48 rows of 512 floats on
    clusters of 16) fits beside the rest only for K4 at C = 16, R = 1."""
    got = {(c, r): (scan.fwd_smem_bytes(r, c, FL, FS, FA, FST, *FLOC, cell="gru"),
                    scan.fwd_smem_bytes(r, c, FL, FS, FA, FST, *CONTENT, cell="gru"),
                    scan.fwd_smem_bytes(r, c, FL, FS, FA, FST, *CONTENT, True, "gru"))
           for c in scan.WALK_CLUSTERS for r in scan.WALK_ROWS}
    assert got == {
        (16, 1): (142272, 107584, 205888), (16, 2): (215104, 180256, 278560),
        (16, 4): (360832, 325616, 423920), (16, 8): (652320, 616384, 714688),
        (8, 1): (142848, 108096, 304704), (8, 2): (183536, 148512, 345120),
        (8, 4): (264912, 229408, 426016), (8, 8): (427712, 391200, 587808)}


@pytest.mark.parametrize("cell,loc", KINDS)
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
@pytest.mark.parametrize("resident", [False, True])
def test_no_fwd_buffer_grows_with_the_full_length(cell, loc, c, r, resident):
    """L enters only through a block's ceil(L / C) positions (and the
    filter's window, whose reach is fixed): lengths with the same
    ceil(L / C) take the same bytes, and each further position of a block
    adds the same few floats a row whatever L is: the energies and their
    exponentials, the mask, and with the location term alpha_prev and the
    peers' energies."""
    _, s, a, st = WIDTHS[cell]
    smem = lambda l: scan.fwd_smem_bytes(r, c, l, s, a, st, *loc, resident, cell)
    for p in (1, 2, 5, 40):
        assert smem(c * (p - 1) + 1) == smem(c * p)
    per = (smem(c * 400) - smem(c * 200)) / 200
    assert per == pytest.approx((smem(c * 4000) - smem(c * 2000)) / 2000, rel=0.01)
    assert per == pytest.approx(4 * r * (5 if loc[0] else 3), rel=0.01)


# The longest encoder output of one batch row (B = 1: C = 16, R = 1,
# W_cx streamed at that length), from the formula: K10 and K14 took one
# row's whole step in a block before (K14 L' <= 25,554), and K12 and K4
# too (K12 L <= 14,359, K4 L <= 25,856); the card test runs the longest
# and sees one more refused.
@pytest.mark.parametrize("cell,loc,l_max", [
    pytest.param("lstm", LOC, 136960, id="loc0-136960"),
    pytest.param("lstm", CONTENT, 243008, id="loc1-243008"),
    pytest.param("gru", FLOC, 72304, id="K12-72304"),
    pytest.param("gru", CONTENT, 166656, id="K4-166656")])
def test_the_longest_encoder_output(cell, loc, l_max):
    _, s, a, st = WIDTHS[cell]
    assert scan.fwd_smem_bytes(1, 16, l_max, s, a, st, *loc, cell=cell) <= SMEM
    assert scan.fwd_smem_bytes(1, 16, l_max + 1, s, a, st, *loc, cell=cell) > SMEM
    assert plan(1, loc=loc, l=l_max, cell=cell) == scan.FwdPlan(16, 1, False, 1)
    with pytest.raises(RuntimeError):
        plan(1, loc=loc, l=l_max + 1, cell=cell)


def _c_function(name):
    """A function of csrc/attention_scan_loc_lstm.cu that returns one
    expression of its long long parameters, as a Python function;
    kBarsFwdLstm and kBarsFwdGru read from the source and held to
    FWD_BARS, kWarps from common.cuh's kThreads and held to FWD_WARPS."""
    src = (CSRC / "attention_scan_loc_lstm.cu").read_text()
    body = re.search(r"long long " + name + r"\((.*?)\) \{\s*return (.*?);\n\}", src, re.S)
    assert body, f"{name} not found"
    bars = re.findall(r"constexpr int kBarsFwdLstm = (\d+), kBarsFwdGru = (\d+);", src)
    assert [tuple(map(int, b)) for b in bars] == [(scan.FWD_BARS["lstm"], scan.FWD_BARS["gru"])]
    threads = re.findall(r"constexpr int kThreads = (\d+);", (CSRC / "common.cuh").read_text())
    assert [int(t) // 32 for t in threads] == [scan.FWD_WARPS]
    params = re.findall(r"long long (\w+)", body.group(1))
    expr = re.sub(r"\bkBarsFwdLstm\b", bars[0][0], body.group(2))
    expr = re.sub(r"\bkBarsFwdGru\b", bars[0][1], expr)
    expr = re.sub(r"\bkWarps\b", str(scan.FWD_WARPS), expr)
    return eval(f"lambda {', '.join(params)}: ({expr})",
                {"cdiv": lambda n, d: -(-n // d), "r4": lambda n: -(-n // 4) * 4,
                 "cspan": lambda n, c: -(-n // c) if n % 4 else 4 * -(-(n // 4) // c),
                 "lmax": max})


# (cell, L, S, A, St, FM, F): the recipe's widths with and without the
# location term; St and A not multiples of 4; L < C; FM not a multiple
# of 4; S not one; the longest encoder outputs; then the same for the GRU,
# at the flagship's widths (filter 10) and the longest encoder outputs of
# K12 and K4.
SHAPES = [
    ("lstm", L, S, A, ST, 16, 5), ("lstm", L, S, A, ST, 0, 0), ("lstm", 1, 17, 12, 9, 3, 4),
    ("lstm", 3, 17, 12, 9, 0, 0), ("lstm", 37, 64, 40, 33, 0, 0), ("lstm", 20, 600, 24, 33, 4, 5),
    ("lstm", 40, 40, 24, 33, 20, 31), ("lstm", 136960, S, A, ST, 16, 5),
    ("lstm", 243008, S, A, ST, 0, 0), ("lstm", 37, 64, 42, 36, 0, 0), ("lstm", 5, 7, 5, 3, 3, 6),
    ("gru", FL, FS, FA, FST, 16, 10), ("gru", FL, FS, FA, FST, 0, 0),
    ("gru", 1, 17, 12, 9, 3, 4), ("gru", 3, 17, 12, 9, 0, 0), ("gru", 37, 64, 40, 33, 0, 0),
    ("gru", 20, 600, 24, 33, 4, 5), ("gru", 40, 40, 24, 33, 20, 31),
    ("gru", 72304, FS, FA, FST, 16, 10), ("gru", 166656, FS, FA, FST, 0, 0),
    ("gru", 37, 64, 42, 36, 0, 0), ("gru", 5, 7, 5, 3, 3, 6)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"shape{i}" for i in range(len(SHAPES))])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
@pytest.mark.parametrize("resident", [0, 1])
def test_the_forward_walk_lays_out_what_the_plan_counts(shape, c, r, resident):
    cell, l, s, a, st, fm, f = shape
    assert 4 * _c_function("fwd_smem_floats")(r, c, l, s, a, st, fm, f, int(fm > 0), resident,
                                              int(cell == "lstm")) \
        == scan.fwd_smem_bytes(r, c, l, s, a, st, fm, f, bool(resident), cell)


@pytest.mark.parametrize("cell,b,t,a,st", [
    pytest.param("lstm", 16, 56, 256, 400, id="16-56-256-400"),
    pytest.param("lstm", 128, 56, 256, 400, id="128-56-256-400"),
    pytest.param("lstm", 3, 5, 12, 9, id="3-5-12-9"),
    pytest.param("lstm", 1, 1, 5, 3, id="1-1-5-3"),
    pytest.param("lstm", 5, 7, 42, 33, id="5-7-42-33"),
    pytest.param("gru", 16, 56, 512, 256, id="gru-16-56-512-256"),
    pytest.param("gru", 128, 56, 512, 256, id="gru-128-56-512-256"),
    pytest.param("gru", 3, 5, 12, 9, id="gru-3-5-12-9"),
    pytest.param("gru", 1, 1, 5, 3, id="gru-1-1-5-3"),
    pytest.param("gru", 5, 7, 42, 33, id="gru-5-7-42-33")])
def test_the_forward_scratch_is_what_the_kernel_carves(cell, b, t, a, st):
    assert _c_function("fwd_scratch_floats")(b, t, a, st, scan.FWD_GATES[cell]) \
        == scan.fwd_scratch_floats(b, t, a, st, cell)


def test_forward_scratch_at_the_recipe():
    """The pre-pass's scratch at the recipe's training shape: 11.8 MB at
    B=16 and 62.0 MB at B=128."""
    assert scan.fwd_scratch_floats(16, 56, A, ST) == 2_944_000
    assert scan.fwd_scratch_floats(128, 56, A, ST) == 15_488_000


def test_gru_forward_scratch_at_the_flagship():
    """K12's and K4's scratch at the flagship's training shape: 6.6 MB at
    B=16 and 32.2 MB at B=128."""
    assert scan.fwd_scratch_floats(16, 56, FA, FST, "gru") == 1_638_400
    assert scan.fwd_scratch_floats(128, 56, FA, FST, "gru") == 8_060_928


def _folded_scan(vh, h, enc_mask, yin, weights, cell, loc):
    """The scan as the kernels compute it: P and W_cx from the pre-pass
    (lstm_fold_plain or gru_fold_plain), then each step's gates from x =
    P[:, t] + c @ W_cx: the LSTM's s_prev @ w_h + x; the GRU's
    sigmoid(s_prev @ w_zr[:St] + x[:, :2St]), then the candidate
    tanh((rg s_prev) @ w_h[:St] + x[:, 2St:])."""
    ws_w, ws_b, w_e, c_w, c_b, dec_w, dec_b = weights[:7]
    st = yin.shape[2]
    if cell == "lstm":
        w_h, w_x, b = weights[7:10]
        p, w_cx = scan.lstm_fold_plain(yin, c_w, c_b, dec_w, dec_b, w_x, b)
        loc_w = weights[10:]
    else:
        gru_wzr, gru_wh = weights[7:9]
        p, w_cx = scan.gru_fold_plain(yin, c_w, c_b, dec_w, dec_b, gru_wzr, gru_wh)
        loc_w = weights[9:]
    s = yin.new_zeros(yin.shape[0], st)
    mem, alpha = torch.zeros_like(s), vh.new_zeros(vh.shape[:2])
    outs = ([], [], [], [])
    for t in range(yin.shape[1]):
        z = vh + (s @ ws_w + ws_b)[:, None, :]
        if loc:
            z = z + scan._loc_features(alpha, loc_w[0], loc_w[1]) @ loc_w[2]
        alpha = masked_softmax(torch.tanh(z) @ w_e, enc_mask)
        c = torch.einsum("bl,bla->ba", alpha, h)
        x = p[:, t] + c @ w_cx
        if cell == "lstm":
            g_in, g_forget, g_cell, g_out = (s @ w_h + x).chunk(4, dim=-1)
            mem = torch.sigmoid(g_forget) * mem + torch.sigmoid(g_in) * torch.tanh(g_cell)
            s = torch.sigmoid(g_out) * torch.tanh(mem)
        else:
            zr = torch.sigmoid(s @ gru_wzr[:st] + x[:, :2 * st])
            zg, rg = zr[:, :st], zr[:, st:]
            s = (1.0 - zg) * s + zg * torch.tanh((rg * s) @ gru_wh[:st] + x[:, 2 * st:])
        for seq, v in zip(outs, (s, c, alpha, mem)):
            seq.append(v)
    return tuple(torch.stack(x, dim=1) for x in outs[:4 if cell == "lstm" else 3])


@pytest.mark.parametrize("cell,loc", [pytest.param("lstm", True, id="True"),
                                      pytest.param("lstm", False, id="False"),
                                      pytest.param("gru", True, id="gru-True"),
                                      pytest.param("gru", False, id="gru-False")])
def test_the_fold_computes_the_plain_scan(cell, loc):
    """On a small seeded case with ragged encoder lengths and a row whose
    every position is masked, the folded form gives _scan_plain's
    sequences (four for the LSTM, three for the GRU) within 1e-5 (the
    kernels' forward tolerance is 1e-4), and that row's alpha and c are
    exactly 0."""
    rng = np.random.RandomState(3)
    b, t, l, s_dim, a_dim, st, fm, f = 3, 6, 7, 11, 9, 5, 3, 4
    rnd = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32))
    vh, h, yin = rnd(b, l, s_dim), rnd(b, l, a_dim, scale=0.5), rnd(b, t, st, scale=0.5)
    mask = torch.from_numpy((np.arange(l)[None] < np.array([7, 4, 0])[:, None]).astype(np.float32))
    weights = [rnd(st, s_dim, scale=st ** -0.5), rnd(s_dim, scale=0.3),
               rnd(s_dim, scale=s_dim ** -0.5), rnd(a_dim, st, scale=a_dim ** -0.5),
               rnd(st, scale=0.3), rnd(2 * st, st, scale=(2 * st) ** -0.5), rnd(st, scale=0.3)]
    if cell == "lstm":
        weights += [rnd(st, 4 * st, scale=st ** -0.5), rnd(st, 4 * st, scale=st ** -0.5),
                    rnd(4 * st, scale=0.3)]
    else:
        weights += [rnd(2 * st, 2 * st, scale=(2 * st) ** -0.5),
                    rnd(2 * st, st, scale=(2 * st) ** -0.5)]
    if loc:
        weights += [rnd(f, fm, scale=0.5), rnd(fm, scale=0.3), rnd(fm, s_dim, scale=fm ** -0.5)]
    want = scan._scan_plain(vh, h, mask, yin, weights, lstm=cell == "lstm")
    got = _folded_scan(vh, h, mask, yin, weights, cell, loc)
    assert len(got) == len(want) == (4 if cell == "lstm" else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5
    assert not got[1][2].any() and not got[2][2].any()
    if cell == "lstm":
        p, w_cx = scan.lstm_fold_plain(yin, *weights[3:7], *weights[8:10])
    else:
        p, w_cx = scan.gru_fold_plain(yin, *weights[3:9])
    g = scan.FWD_GATES[cell]
    assert p.shape == (b, t, g * st) and w_cx.shape == (a_dim, g * st)
