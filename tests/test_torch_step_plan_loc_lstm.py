"""The plan of K8, the beam step of the location-aware and LSTM decoders
(ops/cuda/attention_step.py): the cluster size C per batch row and the
shared memory of a block, pinned at the conv+BiLSTM recipe's and the
flagship_loc widths and held to csrc/attention_step.cu's count. The plan
is a plain function of the shapes and of two numbers of the device, so
this runs on the CPU."""

import pathlib
import re

import pytest

from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"
SMEM = 232448  # opt-in shared memory of a block on an H100
LIN, MAXOUT, RELU = (step.LAYER_KINDS[k] for k in ("linear", "maxout", "relu"))
# (S, A, St, FM, F, lstm, readout): the conv+BiLSTM recipe's decoder
# (linear 124 -> relu -> linear 62), flagship_loc's (maxout 64 x 7 ->
# linear 62), and each without the location term.
CB = (150, 256, 400, 16, 5, True, (("linear", 124), ("relu",), ("linear", 62)))
FLOC = (512, 512, 256, 16, 10, False, (("dropout", 0.5), ("maxout", 64, 7), ("linear", 62)))
CBC = (150, 256, 400, 0, 0, True, CB[-1])
GRU = (512, 512, 256, 0, 0, False, FLOC[-1])
RESIDENT = {16: 7, 8: 15}  # clusters an H100 holds at a block's full shared memory (K2's)


def _cfg(dims, v=62):
    s, a, st, fm, f, lstm, ro = dims
    return attention.AttentionConfig(score_depth=s, state_depth=st, annotation_depth=a,
                                     output_depth=v, readout=ro, feature_maps=fm,
                                     filt_size=f or 5, cell="lstm" if lstm else "gru")


def _dense(dims):
    return step.k8_dense(step.k8_layers(_cfg(dims)))


def smem(dims, k, l, c):
    s, a, st, fm, f, lstm, _ = dims
    return step.step_loc_lstm_smem_bytes(k, l, s, a, st, fm, f, c, lstm, _dense(dims))


def plan(dims, b, resident=RESIDENT, smem_limit=SMEM, k=5, l=14):
    return step.step_plan(b, {c: smem(dims, k, l, c) for c in step.CLUSTERS}, smem_limit,
                          resident)


def test_readout_layers_and_their_sizes():
    """Dropout dropped, relu keeps its input's width; the dense layers
    split over the blocks but the last, which block 0 takes whole."""
    assert step.k8_layers(_cfg(CB)) == [(LIN, 124, 1), (RELU, 124, 1), (LIN, 62, 1)]
    assert step.k8_layers(_cfg(FLOC)) == [(MAXOUT, 64, 7), (LIN, 62, 1)]
    # (widest output, maxout pre-activations a block holds, columns of a
    # block's share of a product): 124 over 16 blocks is 8 (groups of 4),
    # 64 maxout groups of 7 over 16 blocks 4 groups, over 8 blocks 8.
    assert step.readout_dims(_dense(CB), 16) == (124, 0, 62)
    assert step.readout_dims(_dense(CB), 8) == (124, 0, 62)
    assert step.readout_dims(_dense(FLOC), 16) == (64, 28, 62)
    assert step.readout_dims(_dense(FLOC), 8) == (64, 56, 62)
    wide = [(LIN, 300, 1), (MAXOUT, 20, 3)]  # a maxout last: block 0's 60 pre-activations
    assert step.readout_dims(wide, 16) == (300, 60, 60)
    assert step.readout_dims([(LIN, 302, 1), (LIN, 7, 1)], 16) == (302, 0, 19)  # 302: single items


def test_smem_bytes_at_the_recipes_widths():
    """The buffers of one block at the conv+BiLSTM serving shape (K = 5, L'
    = 14, clusters of 16: 28 state units a block, in groups of 4; 10 score
    columns; one position), each rounded up to 16 bytes."""
    # ws, w_e, s | r, c_in | yin, s | c, two readout outputs
    gathered = 752 + 152 + 4000 + 4000 + 5 * 656 + 2 * 5 * 124
    positions = 4 + 8  # the mask and energies of ceil(14 / 16) = 1 position
    exchanged = 16 * 5 * 16 + 2 * 16 * 5 + 16 * 5 + 8  # context partials, (max, sum), scales, sums
    units = 5 * 4 * 28 + 5 * 28 + 5 * 28  # the four gates, the cell state, dec_in's yin half
    bias = 12 + 28 + 28 + 4 * 28  # ws, c_in, dec_in, the gates
    loc = 28 + 16 * 150 + 5 * 16 + 16 + 16 * 16  # alpha_prev's window, U, taps, bias, features
    partials = 16 * 5 * 62  # the warps' partial sums of the widest product (the last layer's 62)
    assert smem(CB, 5, 14, 16) == 4 * (gathered + positions + exchanged + units + bias + loc
                                       + partials) == 94896
    assert smem(CB, 5, 14, 8) == 111376
    assert smem(CBC, 5, 14, 16) == 83776
    assert smem(FLOC, 5, 132, 16) == 123200
    assert smem(FLOC, 5, 132, 8) == 124928
    assert smem(GRU, 5, 132, 16) == 88336
    for dims, l in ((CB, 14), (FLOC, 132)):
        for c in step.CLUSTERS:
            assert smem(dims, 8, l, c) <= SMEM


@pytest.mark.parametrize("dims", [CB, FLOC, CBC, GRU], ids=["cb", "floc", "cbc", "gru"])
@pytest.mark.parametrize("c", step.CLUSTERS)
@pytest.mark.parametrize("k", [1, 5, 8])
def test_no_buffer_grows_with_the_full_length(dims, c, k):
    """L enters only through a block's ceil(L / C) positions: their mask,
    energies and, with the location term, alpha_prev on them and their
    F - 1 halo. K = 8 at L = 1500 fits at every width."""
    r4 = lambda n: -(-n // 4) * 4
    fm, f = dims[3], dims[4]
    per_l = lambda l: 4 * (r4(-(-l // c)) + r4(k * -(-l // c))
                           + (r4(k * (-(-l // c) + f - 1)) if fm else 0))
    base = smem(dims, k, 14, c)
    for l in (1, 3, 37, 144, 1500, 4000):
        assert smem(dims, k, l, c) - base == per_l(l) - per_l(14)
    assert smem(dims, 8, 1500, c) <= SMEM


def test_length_cap_at_the_conv_bilstm_widths():
    """At K = 8 one batch row fits L' = 20,736 positions on clusters of 16
    (tests/test_torch_cuda.py's K8_CAP), and not one more on either size."""
    assert smem(CB, 8, 20736, 16) <= SMEM < smem(CB, 8, 20737, 16)
    assert smem(CB, 8, 20737, 8) > SMEM
    with pytest.raises(RuntimeError, match="no cluster of 16 or 8 blocks fits the device"):
        plan(CB, 1, k=8, l=20737)
    assert plan(CB, 1, k=8, l=20736) == step.StepPlan(16, 1)


@pytest.mark.parametrize("dims", [CB, FLOC], ids=["cb", "floc"])
@pytest.mark.parametrize("b,resident,want", [
    (1, {16: 7, 8: 15}, step.StepPlan(16, 1)),
    (8, {16: 7, 8: 15}, step.StepPlan(8, 1)),    # 8 clusters of 16 do not fit one wave
    (16, {16: 7, 8: 15}, step.StepPlan(8, 2)),   # nor of 8: 8 in waves
    (8, {16: 8, 8: 16}, step.StepPlan(16, 1)),
    (16, {16: 8, 8: 16}, step.StepPlan(8, 1)),
    (1, {16: 0, 8: 15}, step.StepPlan(8, 1)),    # a card that refuses clusters of 16
    (16, {16: 7, 8: 0}, step.StepPlan(16, 3)),   # only 16 fits: 16 in waves
])
def test_plan_takes_the_largest_cluster_that_fits_one_wave(dims, b, resident, want):
    assert plan(dims, b, resident, l=14 if dims is CB else 132) == want


@pytest.mark.parametrize("resident,smem_limit", [({16: 0, 8: 0}, SMEM), ({8: 15}, 64 * 1024)])
def test_plan_raises_when_no_cluster_fits(resident, smem_limit):
    with pytest.raises(RuntimeError, match="no cluster of 16 or 8 blocks fits the device"):
        plan(CB, 1, resident, smem_limit)


def _c_smem_floats():
    """csrc/attention_step.cu's step_loc_lstm_smem_floats as a Python
    function, from its source."""
    src = (CSRC / "attention_step.cu").read_text()
    body = re.search(r"long long step_loc_lstm_smem_floats\((.*?)\) \{\s*return (.*?);\n\}", src,
                     re.S)
    assert body, "step_loc_lstm_smem_floats not found"
    params = re.findall(r"long long (\w+)", body.group(1))
    expr = body.group(2).replace("std::max", "max").replace("std::min", "min")
    expr = expr.replace("128LL", "128").replace("kWarps", str(step.WARPS))
    cdiv = lambda n, d: -(-n // d)
    env = {"cdiv": cdiv, "r4": lambda n: cdiv(n, 4) * 4,
           "cspan": lambda n, c: cdiv(n, c) if n % 4 else 4 * cdiv(n // 4, c)}
    return eval(f"lambda {', '.join(params)}: ({expr})", env)


@pytest.mark.parametrize("shape", [
    (5, 14, *CB[:6]), (8, 1500, *CB[:6]), (5, 132, *FLOC[:6]), (8, 37, *CBC[:6]),
    (1, 3, *GRU[:6]), (5, 37, 13, 18, 10, 3, 4, True), (8, 64, 16, 20, 12, 0, 0, False),
    (3, 9, 17, 12, 9, 3, 4, False), (1, 1, 64, 40, 33, 16, 5, True)])
@pytest.mark.parametrize("readout", [CB[-1], FLOC[-1], (("relu",), ("maxout", 5, 3), ("relu",),
                                                       ("linear", 62))])
@pytest.mark.parametrize("c", step.CLUSTERS)
def test_the_kernel_lays_out_what_the_plan_counts(shape, readout, c):
    k, l, s, a, st, fm, f, lstm = shape
    dense = step.k8_dense(step.k8_layers(_cfg((s, a, st, fm, f, lstm, readout))))
    want = step.step_loc_lstm_smem_bytes(k, l, s, a, st, fm, f, c, lstm, dense)
    got = _c_smem_floats()(k, l, s, a, st, fm, f, c, int(lstm), int(fm > 0),
                           *step.readout_dims(dense, c))
    assert 4 * got == want


_CTYPE = {"int": "c_int", "cudaStream_t": "c_void_p"}


def _c_argtypes(entry):
    """The ctypes of the C entry point `entry`'s parameters, from its
    signature in csrc/attention_step.cu: a pointer or the stream a
    c_void_p, an int a c_int."""
    src = (CSRC / "attention_step.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\) \{", src, re.S)
    assert sig, entry
    out = []
    for param in sig.group(1).split(","):
        decl = " ".join(param.split())
        out.append("c_void_p" if "*" in decl else _CTYPE[decl.rsplit(" ", 1)[0]])
    return out


@pytest.mark.parametrize("kernel", [step.KERNEL, step.KERNEL_LOC_LSTM], ids=["K2", "K8"])
def test_wrapper_argtypes_match_the_c_signature(kernel):
    """The wrapper binds as many pointers and ints, in the same order, as
    the C entry point takes (K8 gained the cluster size)."""
    got = [t.__name__ for t in kernel.argtypes]
    assert got == _c_argtypes(kernel.symbol)
    if kernel is step.KERNEL_LOC_LSTM:
        assert got[-2:] == ["c_int", "c_void_p"] and len(got) == 44


def test_limits_helpers_take_the_cluster_size():
    """Each kernel's limits helper takes C and two outputs; K8's first
    names its instance (lstm, loc)."""
    assert _c_argtypes("fused_attention_step_limits") == ["c_int", "c_void_p", "c_void_p"]
    assert _c_argtypes("fused_attention_step_loc_lstm_limits") == ["c_int"] * 3 + ["c_void_p"] * 2
