"""The plan of the decoder scans' backward walk, K11 and K15 (the LSTM
cell) and K5 and K13 (the GRU, K13 with the location term)
(ops/cuda/attention_scan.py scan_plan): the cluster size C and the batch
rows R of a cluster, and the shared memory of a block, pinned at the
conv+BiLSTM recipe's widths and at the flagship's, with and without the
location term. The plan is a plain function of the shapes, the cell and
two numbers of the device, so this runs on the CPU."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as scan

CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"
SMEM = 232448  # opt-in shared memory of a block on an H100
RESIDENT = {16: 7, 8: 15}  # clusters of 16 and of 8 blocks an H100 holds at full shared memory
# The conv+BiLSTM recipe's decoder at its training shape: L' = 16 encoder
# positions (144 frames), score 150, annotation 256, state 400; with the
# location term (K11) 16 maps of filter 5, without it (K15) none.
L, S, A, ST = 16, 150, 256, 400
LOC, CONTENT = (16, 5), (0, 0)
# The flagship's decoder at its training shape (K5): L = 144 frames, score
# 512, annotation 512 (the BiGRU's two directions of 256), state 256; with
# the location term (flagship_loc, K13) 16 maps of filter 10.
FL, FS, FA, FST = 144, 512, 512, 256
FLOC = (16, 10)


def smem_table(l=L, loc=LOC, s=S, a=A, st=ST, cell="lstm"):
    return {(c, r): scan.walk_smem_bytes(cell, r, c, l, s, a, st, *loc)
            for c in scan.WALK_CLUSTERS for r in scan.WALK_ROWS}


def plan(b, resident=RESIDENT, smem_limit=SMEM, loc=LOC, l=L):
    return scan.scan_plan(b, smem_table(l, loc), smem_limit, resident, scan.STEP_COST["lstm"])


def gru_plan(b, resident=RESIDENT, smem_limit=SMEM, l=FL):
    return scan.scan_plan(b, smem_table(l, CONTENT, FS, FA, FST, "gru"), smem_limit, resident,
                          scan.STEP_COST["gru"])


def loc_gru_plan(b, resident=RESIDENT, smem_limit=SMEM, l=FL):
    """K13's plan: the GRU walk's shared memory with the location term,
    and its own step costs."""
    cost = scan.STEP_COST[scan.WALK_COST[scan.KERNEL_LOC_BWD.symbol]]
    return scan.scan_plan(b, smem_table(l, FLOC, FS, FA, FST, "gru"), smem_limit, resident, cost)


@pytest.mark.parametrize("loc", [LOC, CONTENT])
@pytest.mark.parametrize("b,resident,want", [
    (16, RESIDENT, scan.ScanPlan(16, 4, 1)),    # the recipe's batch: 4 clusters of 16
    (128, RESIDENT, scan.ScanPlan(8, 8, 2)),    # no plan fills one wave: 16 clusters of 8 in 2
    (1, RESIDENT, scan.ScanPlan(16, 1, 1)),
    (5, RESIDENT, scan.ScanPlan(16, 1, 1)),     # 5 clusters of one row each
    (16, {16: 0, 8: 15}, scan.ScanPlan(8, 2, 1)),  # a card that refuses clusters of 16
    (128, {16: 8, 8: 16}, scan.ScanPlan(8, 8, 1)),
])
def test_plan_at_the_recipes_batches(loc, b, resident, want):
    assert plan(b, resident, loc=loc) == want


@pytest.mark.parametrize("b", [1, 2, 3, 5, 7, 8, 16, 28, 56])
def test_plan_fills_one_wave_where_it_can(b):
    """Up to 7 clusters of 8 rows or 15 of 8, one wave holds the batch;
    the plan takes such a one, and the fewest rows of the cost's best."""
    got = plan(b)
    assert got.waves == 1
    assert -(-b // got.rows) <= RESIDENT[got.cluster]


def test_plan_takes_fewer_rows_where_a_block_does_not_fit():
    """At L' = 3000, R = 4 and 8 no longer fit a block (on clusters of 16
    or of 8); of what does, 8 clusters of 8 blocks with 2 rows each fill
    one wave."""
    table = smem_table(l=3000)
    assert max(table[(c, 4)] for c in scan.WALK_CLUSTERS) > SMEM >= table[(16, 2)]
    assert scan.scan_plan(16, table, SMEM, RESIDENT, scan.STEP_COST["lstm"]) == \
        scan.ScanPlan(8, 2, 1)


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), (RESIDENT, 16 * 1024)])
def test_plan_raises_when_no_cluster_fits(resident, smem_limit):
    with pytest.raises(RuntimeError, match="no cluster of 16 or 8 blocks fits the device"):
        plan(1, resident, smem_limit)


def test_partials_are_one_row_a_block():
    assert scan.ScanPlan(16, 4).partials(16) == 64
    assert scan.ScanPlan(8, 8).partials(128) == 128
    assert scan.ScanPlan(8, 4).partials(5) == 16  # a part-empty last group has its rows too


def test_smem_bytes_at_the_recipe():
    """K11 and K15 at the recipe's widths, every (C, R): all fit a block."""
    got = {key: (smem_table(loc=LOC)[key], smem_table(loc=CONTENT)[key])
           for key in [(8, 1), (8, 8), (16, 1), (16, 4), (16, 8)]}
    assert got == {(8, 1): (43296, 22752), (8, 8): (197232, 172784), (16, 1): (46176, 25760),
                   (16, 4): (120624, 98960), (16, 8): (220016, 196656)}


@pytest.mark.parametrize("loc", [LOC, CONTENT])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_no_buffer_grows_with_the_full_length(loc, c, r):
    """L enters only through a block's ceil(L / C) positions (and the
    dfeat halo, whose size is fixed): lengths with the same ceil(L / C)
    take the same bytes, and each further position of a block adds the
    same few floats a row whatever L is."""
    smem = lambda l: scan.walk_smem_bytes("lstm", r, c, l, S, A, ST, *loc)
    for p in (1, 2, 5, 40):
        assert smem(c * (p - 1) + 1) == smem(c * p)
    per = (smem(c * 400) - smem(c * 200)) / 200
    assert per == pytest.approx((smem(c * 4000) - smem(c * 2000)) / 2000, rel=0.01)
    assert per <= 4 * r * (8 + 2 * loc[0]) + 4 * 16


# The longest encoder output of one batch row (B = 1: C = 16, R = 1): the
# largest L' that fits a block, from the formula; the card test runs it
# and sees L' + 1 refused.
@pytest.mark.parametrize("loc,l_max", [(LOC, 18640), (CONTENT, 137856)])
def test_the_longest_encoder_output(loc, l_max):
    assert scan.walk_smem_bytes("lstm", 1, 16, l_max, S, A, ST, *loc) <= SMEM
    assert scan.walk_smem_bytes("lstm", 1, 16, l_max + 1, S, A, ST, *loc) > SMEM
    assert plan(1, loc=loc, l=l_max) == scan.ScanPlan(16, 1, 1)
    with pytest.raises(RuntimeError):
        plan(1, loc=loc, l=l_max + 1)


@pytest.mark.parametrize("b,resident,want", [
    (16, RESIDENT, scan.ScanPlan(8, 2, 1)),    # the recipe's batch: 8 clusters of 8
    (128, RESIDENT, scan.ScanPlan(8, 4, 3)),   # R = 8 fits no block: 32 clusters of 8 in 3
    (1, RESIDENT, scan.ScanPlan(16, 1, 1)),
    (5, RESIDENT, scan.ScanPlan(16, 1, 1)),    # 5 clusters of one row each
    (16, {16: 0, 8: 15}, scan.ScanPlan(8, 2, 1)),
    (128, {16: 8, 8: 16}, scan.ScanPlan(8, 4, 2)),
])
def test_gru_plan_at_the_flagship_batches(b, resident, want):
    """K5's plan at the flagship's widths, from the GRU walk's step costs."""
    assert gru_plan(b, resident) == want


def test_gru_smem_bytes_at_the_flagship():
    """K5 at the flagship's widths, every (C, R): R = 8 fits no block (the
    blocks' dws partials, C x R rows of S = 512 floats, take 256 KB on
    clusters of 16 and 128 KB on clusters of 8), the rest do."""
    assert smem_table(FL, CONTENT, FS, FA, FST, "gru") == {
        (16, 1): 51984, (16, 2): 99728, (16, 4): 195216, (16, 8): 386288,
        (8, 1): 37168, (8, 2): 70096, (8, 4): 136048, (8, 8): 267952}


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), (RESIDENT, 16 * 1024)])
def test_gru_plan_raises_when_no_cluster_fits(resident, smem_limit):
    with pytest.raises(RuntimeError, match="no cluster of 16 or 8 blocks fits the device"):
        gru_plan(1, resident, smem_limit)


@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_no_gru_buffer_grows_with_the_full_length(c, r):
    """As for the LSTM walk: lengths with the same ceil(L / C) take the same
    bytes, and each further position of a block adds 6 floats a row (alpha
    and its cotangent, staged twice; the carry and de)."""
    smem = lambda l: scan.walk_smem_bytes("gru", r, c, l, FS, FA, FST)
    for p in (1, 2, 5, 40):
        assert smem(c * (p - 1) + 1) == smem(c * p)
    assert (smem(c * 400) - smem(c * 200)) / 200 == pytest.approx(4 * 6 * r, rel=0.01)


def test_the_longest_flagship_encoder_output():
    """K5 at one batch row (C = 16, R = 1) fits L <= 120448 frames (about
    64 min at 32 ms a frame; the one-block walk it replaces refused L above
    11836); the card test runs it and sees L + 1 refused."""
    l_max = 120448
    assert gru_plan(1, l=l_max) == scan.ScanPlan(16, 1, 1)
    assert scan.walk_smem_bytes("gru", 1, 16, l_max + 1, FS, FA, FST) > SMEM
    with pytest.raises(RuntimeError):
        gru_plan(1, l=l_max + 1)


@pytest.mark.parametrize("b,resident,want", [
    (16, RESIDENT, scan.ScanPlan(8, 2, 1)),    # the recipe's batch: 8 clusters of 8
    (128, RESIDENT, scan.ScanPlan(8, 4, 3)),   # R = 4 on clusters of 8 at most: 32 in 3 waves
    (1, RESIDENT, scan.ScanPlan(16, 1, 1)),
    (16, {16: 0, 8: 15}, scan.ScanPlan(8, 2, 1)),
])
def test_loc_gru_plan_at_the_flagship_loc_batches(b, resident, want):
    """K13's plan at flagship_loc's widths, from its own step costs."""
    assert loc_gru_plan(b, resident) == want


def test_loc_gru_smem_bytes_at_flagship_loc():
    """K13 at flagship_loc's widths, every (C, R): U and the block's dU
    sum (FM x S = 8,192 floats each, 64 KB together) sit in every block
    beside K5's buffers, so R = 4 no longer fits on clusters of 16 and R
    = 8 on neither size."""
    table = smem_table(FL, FLOC, FS, FA, FST, "gru")
    assert table == {
        (16, 1): 120816, (16, 2): 170416, (16, 4): 269648, (16, 8): 468208,
        (8, 1): 107216, (8, 2): 143248, (8, 4): 215376, (8, 8): 359664}
    content = smem_table(FL, CONTENT, FS, FA, FST, "gru")
    assert all(table[key] - content[key] >= 2 * 4 * 16 * FS for key in table)
    assert {key for key, n in table.items() if n <= SMEM} == {(16, 1), (16, 2), (8, 1), (8, 2),
                                                              (8, 4)}


def test_the_longest_flagship_loc_encoder_output():
    """K13 at one batch row (C = 16, R = 1) fits L <= 11312 frames (about
    6 min at 32 ms a frame), ceil(L / 16) = 707 positions a block: of a
    block's 232,448 bytes (58,112 floats), the buffers that do not grow
    with L take about 29,844 floats (U and the dU sum 16,384 of them, the
    blocks' dws partials 8,192), and each position 40 more (alpha, its
    cotangent and alpha_prev staged twice, the carry, de, and 16 maps of
    features and of dfeat): 707 positions fit, 708 do not. The one-block
    body it replaces refused L above 1018. The card test runs the cap and
    sees L + 1 refused, by the plan, before a launch."""
    l_max = 11312
    assert loc_gru_plan(1, l=l_max) == scan.ScanPlan(16, 1, 1)
    assert scan.walk_smem_bytes("gru", 1, 16, l_max, FS, FA, FST, *FLOC) <= SMEM
    assert scan.walk_smem_bytes("gru", 1, 16, l_max + 1, FS, FA, FST, *FLOC) > SMEM
    with pytest.raises(RuntimeError):
        loc_gru_plan(1, l=l_max + 1)


@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_no_loc_gru_buffer_grows_with_the_full_length(c, r):
    """As for the other walks: lengths with the same ceil(L / C) take the
    same bytes; each further position of a block adds 40 floats a row
    (alpha, its cotangent and alpha_prev staged twice, the carry, de, and
    16 maps of features and of dfeat)."""
    smem = lambda l: scan.walk_smem_bytes("gru", r, c, l, FS, FA, FST, *FLOC)
    for p in (1, 2, 5, 40):
        assert smem(c * (p - 1) + 1) == smem(c * p)
    assert (smem(c * 400) - smem(c * 200)) / 200 == pytest.approx(4 * 40 * r, rel=0.01)


def _c_smem_floats():
    """csrc/attention_scan_loc_lstm.cu's walk_smem_floats as a Python
    function, from its source, its per-cell mbarrier counts kBarsLstm and
    kBarsGru read from the source and held to WALK_BARS."""
    src = (CSRC / "attention_scan_loc_lstm.cu").read_text()
    body = re.search(r"long long walk_smem_floats\((.*?)\) \{\s*return (.*?);\n\}", src, re.S)
    assert body, "walk_smem_floats not found"
    bars = re.findall(r"constexpr int kBarsLstm = (\d+), kBarsGru = (\d+);", src)
    assert len(bars) == 1, "kBarsLstm, kBarsGru not found"
    assert {"lstm": int(bars[0][0]), "gru": int(bars[0][1])} == scan.WALK_BARS
    params = re.findall(r"long long (\w+)", body.group(1))
    expr = re.sub(r"\bkBarsLstm\b", bars[0][0], body.group(2))
    expr = re.sub(r"\bkBarsGru\b", bars[0][1], expr)
    return eval(f"lambda {', '.join(params)}: ({expr})",
                {"cdiv": lambda n, d: -(-n // d), "r4": lambda n: -(-n // 4) * 4,
                 "cspan": lambda n, c: -(-n // c) if n % 4 else 4 * -(-(n // 4) // c)})


@pytest.mark.parametrize("shape", [
    (L, S, A, ST, 16, 5), (L, S, A, ST, 0, 0), (1, 17, 12, 9, 3, 4), (3, 17, 12, 9, 0, 0),
    (37, 64, 40, 33, 0, 0), (20, 600, 24, 33, 4, 5), (40, 40, 24, 33, 20, 31),
    (18640, S, A, ST, 16, 5), (137856, S, A, ST, 0, 0), (37, 64, 42, 36, 0, 0)])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_the_kernel_lays_out_what_the_plan_counts(shape, c, r):
    l, s, a, st, fm, f = shape
    assert 4 * _c_smem_floats()(r, c, l, s, a, st, fm, f, int(fm > 0), 1) == \
        scan.walk_smem_bytes("lstm", r, c, l, s, a, st, fm, f)


# The GRU walk: K5 without the location term, then K13 with it (filters
# of 10, even, and 5 and 31, odd).
@pytest.mark.parametrize("shape", [
    (FL, FS, FA, FST), (L, S, A, ST), (3, 17, 12, 9), (37, 64, 40, 33), (1, 600, 24, 33),
    (120448, FS, FA, FST), (37, 64, 42, 36), (5, 7, 5, 3), (FL, FS, FA, FST, *FLOC),
    (11312, FS, FA, FST, *FLOC), (13, 17, 12, 9, 3, 4), (40, 24, 33, 36, 4, 5),
    (40, 40, 24, 33, 20, 31)])
@pytest.mark.parametrize("c", scan.WALK_CLUSTERS)
@pytest.mark.parametrize("r", scan.WALK_ROWS)
def test_the_gru_walk_lays_out_what_the_plan_counts(shape, c, r):
    l, s, a, st, fm, f = (*shape, 0, 0)[:6]
    assert 4 * _c_smem_floats()(r, c, l, s, a, st, fm, f, int(fm > 0), 0) == \
        scan.walk_smem_bytes("gru", r, c, l, s, a, st, fm, f)


def _libraries():
    """The entry points of each of the source's six builds, by the macro
    that selects it (None for K11's, K13's and K15's), from the source's
    #if / #elif / #else around its entry points."""
    src = scan.KERNEL_BWD.source.read_text()
    entries = src[src.index('extern "C"'):]
    head = src[:src.index('extern "C"')].rstrip()
    assert head.endswith("#if defined(LSTM_FWD_ONLY)")
    lstm_fwd, rest = entries.split("\n#elif defined(GRU_FWD_ONLY)\n")
    gru_fwd, rest = rest.split("\n#elif defined(CONTENT_GRU_BWD_BF16)\n")
    k5_bf16, rest = rest.split("\n#elif defined(DECODER_BWD_BF16)\n")
    bwd_bf16, rest = rest.split("\n#elif !defined(CONTENT_GRU_BWD_ONLY)\n")
    others, k5 = rest.split("\n#else\n")
    assert src.rstrip().endswith("#endif")
    names = lambda text: set(re.findall(r'extern "C" int (\w+)\(', text))
    return {"LSTM_FWD_ONLY": names(lstm_fwd), "GRU_FWD_ONLY": names(gru_fwd),
            "CONTENT_GRU_BWD_BF16": names(k5_bf16), "DECODER_BWD_BF16": names(bwd_bf16),
            "CONTENT_GRU_BWD_ONLY": names(k5), None: names(others)}


def test_k5s_bf16_entry_builds_a_library_of_its_own():
    """K5's bf16 entry builds from the same source with
    CONTENT_GRU_BWD_BF16 defined into a library of its own, beside K5's
    and the others: that build holds its entry point and limits helper and
    no other, and its walk's cell is K5's (the GRU)."""
    k = scan.KERNEL_BWD_BF16
    assert k.source == scan.KERNEL_BWD.source and k.defines == ("CONTENT_GRU_BWD_BF16",)
    assert k.library_path() not in {x.library_path() for x in (
        scan.KERNEL_BWD, scan.KERNEL_FWD, scan.KERNEL_LOC_LSTM_FWD, scan.KERNEL_LSTM_BWD)}
    assert _libraries()["CONTENT_GRU_BWD_BF16"] == {k.symbol, k.symbol + "_limits"}
    assert scan.WALK_CELL[k.symbol] == scan.WALK_CELL[scan.KERNEL_BWD.symbol] == "gru"


def test_decoder_bf16_backwards_build_a_library_of_their_own():
    """The bf16 entries of K11, K13 and K15 build from the same source
    with DECODER_BWD_BF16 defined into one library of their own, beside
    their float32 kernels' and K5's bf16 entry's: it holds their entry
    points and limits helpers and no other; each walk's cell and cost row
    is its float32 kernel's."""
    bf16 = (scan.KERNEL_LOC_LSTM_BWD_BF16, scan.KERNEL_LOC_BWD_BF16, scan.KERNEL_LSTM_BWD_BF16)
    floats = (scan.KERNEL_LOC_LSTM_BWD, scan.KERNEL_LOC_BWD, scan.KERNEL_LSTM_BWD)
    assert all(k.defines == ("DECODER_BWD_BF16",) for k in bf16)
    assert len({k.library_path() for k in bf16}) == 1
    assert bf16[0].library_path() not in {k.library_path() for k in (
        *floats, scan.KERNEL_BWD_BF16, scan.KERNEL_FWD)}
    assert _libraries()["DECODER_BWD_BF16"] == {k.symbol + x for k in bf16
                                                for x in ("", "_limits")}
    for k, f in zip(bf16, floats):
        assert k.symbol == f.symbol + "_bf16"
        assert scan.WALK_CELL[k.symbol] == scan.WALK_CELL[f.symbol]
        assert scan.WALK_COST.get(k.symbol) == scan.WALK_COST.get(f.symbol)


_CTYPE = {"int": "c_int", "cudaStream_t": "c_void_p"}


@pytest.mark.parametrize("kernel", [
    scan.KERNEL_FWD, scan.KERNEL_BWD, scan.KERNEL_FWD_BF16, scan.KERNEL_BWD_BF16,
    scan.KERNEL_LOC_LSTM_FWD, scan.KERNEL_LOC_LSTM_BWD, scan.KERNEL_LOC_FWD, scan.KERNEL_LOC_BWD,
    scan.KERNEL_LSTM_FWD, scan.KERNEL_LSTM_BWD, scan.KERNEL_LOC_LSTM_FWD_BF16,
    scan.KERNEL_LOC_FWD_BF16, scan.KERNEL_LSTM_FWD_BF16, scan.KERNEL_LOC_LSTM_BWD_BF16,
    scan.KERNEL_LOC_BWD_BF16, scan.KERNEL_LSTM_BWD_BF16], ids=lambda k: k.symbol)
def test_wrapper_argtypes_match_the_c_signature(kernel):
    """Each decoder scan's wrapper binds as many pointers and ints, in the
    same order, as its C entry point takes (the bf16 forwards' alpha32
    and c32, the bf16 backwards' c32 and float32 sums among them)."""
    src = kernel.source.read_text()
    sig = re.search(r'extern "C" int ' + kernel.symbol + r"\((.*?)\) \{", src, re.S)
    assert sig, kernel.symbol
    want = []
    for param in sig.group(1).split(","):
        decl = " ".join(param.split())
        want.append("c_void_p" if "*" in decl else _CTYPE[decl.rsplit(" ", 1)[0]])
    assert [t.__name__ for t in kernel.argtypes] == want


def test_k5_builds_a_library_of_its_own():
    """K5 shares its source with K4 and K10-K15 but builds with
    CONTENT_GRU_BWD_ONLY defined into a library of its own, which nvcc
    compiles beside the others: that build holds K5's two entry points and
    no other; K10's and K14's build (LSTM_FWD_ONLY) their four, K12's and
    K4's (GRU_FWD_ONLY) theirs, and the default build every other entry
    point."""
    assert scan.KERNEL_BWD.source == scan.KERNEL_LSTM_BWD.source
    assert scan.KERNEL_BWD.library_path() != scan.KERNEL_LSTM_BWD.library_path()
    assert "-DCONTENT_GRU_BWD_ONLY" in scan.KERNEL_BWD.flags
    assert not any("CONTENT_GRU_BWD_ONLY" in f for f in scan.KERNEL_LSTM_BWD.flags)
    libs = _libraries()
    assert libs["CONTENT_GRU_BWD_ONLY"] == {"attention_decode_scan_bwd_limits",
                                            "attention_decode_scan_bwd"}
    walks = (scan.KERNEL_LOC_LSTM_BWD, scan.KERNEL_LSTM_BWD, scan.KERNEL_LOC_BWD)
    assert libs[None] == {k.symbol + x for k in walks for x in ("", "_limits")}
    assert {scan.WALK_CELL[k.symbol] for k in walks} == {"lstm", "gru"}


def test_k10_and_k14_build_a_library_of_their_own():
    """K10 and K14 (the forward walk's LSTM instances and its pre-pass,
    the bf16 entries of K10 and K14 among them) build with LSTM_FWD_ONLY
    defined into one library of their own, beside K5's, K12's and K4's and
    the rest's; it holds their entry points and limits helpers and no
    other."""
    fwds = (scan.KERNEL_LOC_LSTM_FWD, scan.KERNEL_LSTM_FWD, scan.KERNEL_LOC_LSTM_FWD_BF16,
            scan.KERNEL_LSTM_FWD_BF16)
    assert all(k.defines == ("LSTM_FWD_ONLY",) for k in fwds)
    assert len({k.library_path() for k in fwds}) == 1
    assert len({k.library_path() for k in (fwds[0], scan.KERNEL_BWD, scan.KERNEL_LSTM_BWD,
                                           scan.KERNEL_FWD)}) == 4
    assert _libraries()["LSTM_FWD_ONLY"] == {k.symbol + x for k in fwds for x in ("", "_limits")}


def test_k12_and_k4_build_a_library_of_their_own():
    """K12 and K4 (the forward walk's GRU instances and its pre-pass, the
    bf16 entries of K4 and K12 among them) build from the same source with
    GRU_FWD_ONLY defined into one library of their own, beside K10's and
    K14's, K5's and the rest's; it holds their entry points and limits
    helpers and no other, and the walk's cell of each is the GRU."""
    fwds = (scan.KERNEL_LOC_FWD, scan.KERNEL_FWD, scan.KERNEL_FWD_BF16, scan.KERNEL_LOC_FWD_BF16)
    assert all(k.defines == ("GRU_FWD_ONLY",) for k in fwds)
    assert all(k.source == scan.KERNEL_BWD.source for k in fwds)
    assert len({k.library_path() for k in fwds}) == 1
    assert fwds[0].library_path() not in {k.library_path() for k in (
        scan.KERNEL_LOC_LSTM_FWD, scan.KERNEL_BWD, scan.KERNEL_LSTM_BWD)}
    assert _libraries()["GRU_FWD_ONLY"] == {k.symbol + x for k in fwds for x in ("", "_limits")}
    assert {scan.FWD_CELL[k.symbol] for k in fwds} == {"gru"}
