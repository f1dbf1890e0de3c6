"""The CUDA kernels on the card, each held to its plain PyTorch version.

Run on a machine with an NVIDIA GPU and nvcc:
    python -m pytest -m cuda tests/test_torch_cuda.py
Elsewhere every test skips (the `card` fixture decides, at run time).

Tolerance: 1e-4 abs (float32, sums taken in another order than the
plain version's matmuls); serving tokens identical to the CPU run.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


def _max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


# The forward walk's regimes (csrc/gru_walk.cuh, plan cell "gru_fwd"):
# C = 8 blocks of 2 units (H = 16), one row a cluster (B = 1), unequal
# slices of 37 and 38 units (H = 300) and of 12 and 13 with 4-byte staging
# (H = 100), a part-empty last row group (B = 33), several waves (B = 128,
# 32 clusters of 8 rows), fewer units than blocks (H = 5, C = 5), and
# slices streamed from L2 (H just above the fit, and the widest H).
FWD_CASES = [(1, 7, 16, "resident"), (3, 20, 256, "resident"), (5, 9, 300, "resident"),
             (8, 132, 256, "resident"), (1, 132, 256, "resident"), (3, 9, 100, "resident"),
             (33, 20, 256, "partial"), (128, 16, 256, "groups"), (2, 6, 5, "resident"),
             (3, 9, 400, "streamed"), (4, 11, 1024, "streamed")]


@pytest.mark.parametrize("b,l,h,regime", FWD_CASES)
def test_bigru_scan2_kernel(card, b, l, h, regime):
    """K1 against its plain version within TOL, one launch a call, a
    second call bitwise equal (fixed-order sums), and the backward
    direction exactly 0 on the zero-padded tail."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    _check_regime(gru_scan.KERNEL, b, h, "gru_fwd", 2, regime, card)

    gen = torch.Generator().manual_seed(b * 1000 + h)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    valid = (torch.arange(l, device=card)[None] < lens[:, None]).float()[:, :, None]
    xf = _rand(gen, b, l, 3 * h) * valid
    xb = _rand(gen, b, l, 3 * h) * valid
    wzr2 = _rand(gen, 2, h, 2 * h, scale=h ** -0.5)
    wh2 = _rand(gen, 2, h, h, scale=h ** -0.5)
    before = gru_scan.KERNEL.launches
    got = gru_scan.bigru_scan2(xf, xb, wzr2, wh2)
    want = gru_scan.bigru_scan2_plain(xf, xb, wzr2, wh2)
    torch.cuda.synchronize()
    assert gru_scan.KERNEL.launches == before + 1
    assert _max_err(got, want) <= TOL
    assert not (got[1] * (1 - valid)).any()  # bwd direction holds 0 on padding
    again = gru_scan.bigru_scan2(xf, xb, wzr2, wh2)
    torch.cuda.synchronize()
    assert gru_scan.KERNEL.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


FLAGSHIP_STEP = (512, 256, 512, 62, 64, 7)  # score, state, annotation, outputs, maxout


def _k2_case(card, b, k, l, dims, dead=None):
    """Inputs of K2 at (B, K, L) and the widths `dims`, encoder lengths
    ragged; every position of batch row `dead` masked."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops import attention

    s_dim, st, a, v, m, win = dims
    cfg = attention.AttentionConfig(score_depth=s_dim, state_depth=st, annotation_depth=a,
                                    output_depth=v, readout=(("dropout", 0.5), ("maxout", m, win),
                                                             ("linear", v)))
    gen = torch.Generator().manual_seed(b * 100 + k)
    params = interop.to_torch(attention.attention_init(gen, cfg), card)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    if dead is not None:
        mask[dead] = 0.0
    h = _rand(gen, b, l, a)
    vh = attention.precompute_vh(params, h).contiguous()
    state = (torch.softmax(_rand(gen, b, k, l), -1), _rand(gen, b, k, st, scale=0.3),
             _rand(gen, b, k, st))
    y = torch.nn.functional.one_hot(torch.randint(0, v, (b, k), generator=gen), v).float().cuda()
    return params, cfg, (state, y, vh, h, mask)


# K2 runs a batch row on a cluster of 16 or 8 blocks, each taking 1/C of
# the encoder positions and of the outputs: L < C, L not a multiple of C,
# a row with every position masked, K = 1 and 8, B = 16 (more clusters of
# 16 than one wave holds), L = 1500 at K = 8, beyond one block's shared
# memory, fewer outputs than blocks (6), and word vocabularies (V =
# 34,000 over 35 s at K = 5 and 8; V = 4,001, no multiple of 4); beams of
# more than 8 hypotheses, a cluster a (row, group): K = 9 (groups of 4
# and 5), 10 and 16.
@pytest.mark.parametrize("b,k,l,dims,dead", [
    (1, 1, 8, (16, 16, 24, 6, 8, 3), None),
    (3, 5, 37, (16, 12, 20, 7, 4, 2), None),
    (2, 8, 64, (64, 32, 48, 10, 8, 7), None),
    (8, 5, 132, FLAGSHIP_STEP, None),
    (2, 5, 3, FLAGSHIP_STEP, None),
    (3, 5, 37, FLAGSHIP_STEP, 1),
    (8, 1, 132, FLAGSHIP_STEP, None),
    (8, 8, 132, FLAGSHIP_STEP, 7),
    (16, 5, 132, FLAGSHIP_STEP, None),
    (1, 8, 1500, FLAGSHIP_STEP, None),
    (16, 5, 1094, FLAGSHIP_STEP[:3] + (34000,) + FLAGSHIP_STEP[4:], 3),
    (16, 8, 1094, FLAGSHIP_STEP[:3] + (34000,) + FLAGSHIP_STEP[4:], None),
    (3, 5, 37, (16, 12, 20, 4001, 4, 2), 2),
    (3, 9, 37, (16, 12, 20, 7, 4, 2), 1),
    (2, 10, 132, FLAGSHIP_STEP, None),
    (2, 16, 132, FLAGSHIP_STEP, 1),
    (8, 16, 1094, FLAGSHIP_STEP[:3] + (34000,) + FLAGSHIP_STEP[4:], None),
])
def test_fused_attention_step_kernel(card, b, k, l, dims, dead):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    params, cfg, (state, y, vh, h, mask) = _k2_case(card, b, k, l, dims, dead)
    before = attention_step.KERNEL.launches
    (ga, gs, gm), got = attention_step.fused_attention_step(params, cfg, state, y, vh, h, mask)
    _, want = attention_step.fused_attention_step_plain(params, cfg, state, y, vh, h, mask)
    torch.cuda.synchronize()
    assert attention_step.KERNEL.launches == before + 1
    for key in ("alpha", "c", "s", "logp"):
        assert _max_err([got[key]], [want[key]]) <= TOL, key
    assert gm is state[2]
    if dead is not None:  # no valid position: alpha and the context are 0
        assert not got["alpha"][dead].any() and not got["c"][dead].any()
    # Fixed-order sums, no atomics: a second call gives the same bits.
    _, again = attention_step.fused_attention_step(params, cfg, state, y, vh, h, mask)
    torch.cuda.synchronize()
    assert attention_step.KERNEL.launches == before + 2
    for key in ("alpha", "c", "s", "logp"):
        assert torch.equal(got[key], again[key]), key


def test_fused_attention_step_plan_on_the_card(card):
    """The card holds clusters of 8 blocks of K2 (and says how many of
    16); the flagship's serving batches run in one wave."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    smem_limit, resident = attention_step.step_limits(card)
    assert resident[8] >= 8 and smem_limit >= 227 * 1024, resident
    for b in (1, 8):
        plan = attention_step.step_plan_on(b, 5, 132, *FLAGSHIP_STEP[:3], 64, 7, 62, card)
        assert plan.waves == 1 and plan.cluster in attention_step.CLUSTERS, plan


def test_fused_attention_step_refuses_without_a_cluster(card, monkeypatch):
    """Where no cluster plan fits, a CUDA call raises; it never takes
    the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    params, cfg, args = _k2_case(card, 1, 5, 20, FLAGSHIP_STEP)
    smem_limit, _ = attention_step.step_limits(card)
    monkeypatch.setattr(attention_step, "step_limits", lambda device: (smem_limit, {16: 0, 8: 0}))
    before = attention_step.KERNEL.launches
    with pytest.raises(RuntimeError, match="no cluster"):
        attention_step.fused_attention_step(params, cfg, *args)
    assert attention_step.KERNEL.launches == before


def test_gru_forward_walks_refuse_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 8 blocks of a forward walk
    (K1, K16, K18), a CUDA call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan, walk

    gen = torch.Generator().manual_seed(3)
    h = 16
    x, w_zr, w_h = _rand(gen, 2, 2, 5, 3 * h), _rand(gen, 2, h, 2 * h), _rand(gen, 2, h, h)
    h0 = _rand(gen, 2, 2, h)
    calls = {gru_scan.KERNEL: lambda: gru_scan.bigru_scan2(x[0], x[1], w_zr, w_h),
             gru_scan.KERNEL_GRU: lambda: gru_scan.gru_scan(x[0], h0[0], w_zr[0], w_h[0]),
             gru_scan.KERNEL_BI: lambda: gru_scan.bigru_scan(x, h0, w_zr, w_h)}
    monkeypatch.setattr(walk, "_LIMITS", {})
    for kernel, call in calls.items():
        monkeypatch.setattr(kernel, "helper", lambda symbol, argtypes: lambda *args: 0)
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no cluster"):
            call()
        assert kernel.launches == before


def _check_stft_logmel(yp):
    """K3 on the padded PCM `yp` against its plain version within TOL,
    one launch a call, and a second call bitwise equal."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    before = logmel.KERNEL.launches
    got = logmel.stft_logmel_power(yp, 16000)
    torch.cuda.synchronize()
    assert logmel.KERNEL.launches == before + 1
    frames = 1 + (yp.shape[1] - 2048) // 512
    assert got[0].shape == (yp.shape[0], frames, 128) and got[1].shape == (yp.shape[0], frames)
    assert _max_err(got, logmel.stft_logmel_power_plain(yp, 16000)) <= TOL
    again = logmel.stft_logmel_power(yp, 16000)
    torch.cuda.synchronize()
    assert logmel.KERNEL.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))


# (rows, PCM samples a row): a short utterance, the 3.5 s bucket at b = 3
# and 8 (odd rows start off an 8-byte boundary), and 60 s (1,876 frames).
@pytest.mark.parametrize("b,n", [(1, 8191), (3, 57343), (8, 57343), (1, 60 * 16000)])
def test_stft_logmel_power_kernel(card, b, n):
    gen = torch.Generator().manual_seed(n)
    t = torch.arange(n) / 16000.0
    y = (0.3 * torch.sin(2 * np.pi * 440 * t) + 0.05 * torch.randn(b, n, generator=gen)).cuda()
    yp = torch.nn.functional.pad(y[:, None], (1024, 1024), mode="reflect")[:, 0].contiguous()
    _check_stft_logmel(yp)


# Padded input given directly, one frame a row: 2 rows, and 65,536 rows
# (more than a grid's y extent; 512 MB on the card).
@pytest.mark.parametrize("b", [2, 65536])
def test_stft_logmel_power_kernel_on_single_frames(card, b):
    gen = torch.Generator().manual_seed(b)
    _check_stft_logmel((0.1 * torch.randn(b, 2048, generator=gen)).cuda())


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan, logmel, lstm_scan

    x = torch.zeros(2, 4, 12, device=card)
    w1, w2 = torch.zeros(2, 4, 8, device=card), torch.zeros(2, 4, 4, device=card)
    with pytest.raises(TypeError):
        gru_scan.bigru_scan2(x.double(), x.double(), w1.double(), w2.double())
    with pytest.raises(ValueError):
        gru_scan.bigru_scan2(x, x.transpose(0, 1).contiguous().transpose(0, 1), w1, w2)
    with pytest.raises(ValueError):
        gru_scan.bigru_scan2(x, x.cpu(), w1, w2)
    with pytest.raises(ValueError):
        logmel.stft_logmel_power(torch.zeros(1, 100, device=card), 16000)
    gen = torch.Generator().manual_seed(0)
    x, hp, dys, wh = (_rand(gen, 2, 2, 3, 16), _rand(gen, 2, 2, 3, 4), _rand(gen, 2, 2, 3, 4),
                      _rand(gen, 2, 4, 16))
    with pytest.raises(TypeError):
        lstm_scan.bilstm_scan_bwd(x.double(), hp.double(), hp.double(), dys.double(), wh.double())
    with pytest.raises(ValueError):
        lstm_scan.bilstm_scan_bwd(x, hp, hp, dys[:, :, :2].contiguous(), wh)
    with pytest.raises(ValueError):
        lstm_scan.bilstm_scan_bwd(x, hp, hp.cpu(), dys, wh)
    vh, h, mask, yin, weights = _loc_lstm_case(card, gen, 2, 5, 3, 6, 4, 3, 2, 3)
    with pytest.raises(TypeError):
        attention_scan.attention_decode_scan_loc_lstm(vh, h, mask.double(), yin, *weights)
    with pytest.raises(ValueError):
        attention_scan.attention_decode_scan_loc_lstm(vh, h, mask, yin, *weights[:-1],
                                                      weights[-1][:, :5].contiguous())
    with pytest.raises(ValueError):
        attention_scan.attention_decode_scan_loc_lstm(vh, h.cpu(), mask, yin, *weights)
    outs = attention_scan.attention_decode_scan_loc_lstm_plain(vh, h, mask, yin, *weights)
    with pytest.raises(ValueError):
        attention_scan.attention_decode_scan_loc_lstm_bwd(
            vh, h, mask, yin, *weights, *outs, outs[0][:, :2].contiguous(), None, None, None)
    # K16-K19: a state wider than 1024, float64, tensors on two devices.
    one = (_rand(gen, 2, 3, 12), _rand(gen, 2, 4), _rand(gen, 4, 8), _rand(gen, 4, 4))
    one_bwd = (one[0], _rand(gen, 2, 3, 4), _rand(gen, 2, 3, 4), *one[2:])
    two, two_bwd = (tuple(torch.stack([t, t]) for t in a) for a in (one, one_bwd))
    for fn, args in ((gru_scan.gru_scan, one), (gru_scan.gru_scan_bwd, one_bwd),
                     (gru_scan.bigru_scan, two), (gru_scan.bigru_scan_bwd, two_bwd)):
        with pytest.raises(ValueError):
            fn(torch.zeros(*args[0].shape[:-1], 3 * 1025, device=card), *args[1:])
        with pytest.raises(TypeError):
            fn(*[a.double() for a in args])
        with pytest.raises(ValueError):
            fn(args[0], args[1].cpu(), *args[2:])


@pytest.mark.parametrize("exact,beam_k", [(False, 3), (True, 3), (False, 10)])
def test_transcriber_on_the_card_matches_the_cpu(card, exact, beam_k):
    """The flagship's Transcriber on the card gives the CPU's tokens, with
    a beam of 3 and of 10 hypotheses (K2 on two groups of 5 a row)."""
    from seq2seq_attention_asr_tpu_torch import serve
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step, gru_scan, logmel

    model = registry.build("chorowski", hidden_frame_size=32, output_frame_size=32,
                           score_depth=32, state_depth=32, mlp_depth=16, output_depth=9)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    pcms = [(0.1 * rng.randn(n)).astype(np.float32) for n in (9000, 20000, 9500)]
    kw = dict(eos_id=8, pad_frames=3, beam_k=beam_k, exact=exact)
    for kern in (gru_scan.KERNEL, attention_step.KERNEL, logmel.KERNEL):
        kern.launches = 0
    got = serve.Transcriber(model, params, **kw).transcribe(pcms)
    assert gru_scan.KERNEL.launches == 3 * 2  # two frame buckets
    assert logmel.KERNEL.launches == (0 if exact else 2)
    assert attention_step.KERNEL.launches >= 2
    want = serve.Transcriber(model, params, device="cpu", **kw).transcribe(pcms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert abs(g.score - w.score) <= 1e-3


def _bwd_close(got, want, name):
    """Backward outputs: max|got - plain| <= 5e-4 * max|plain| + 5e-5
    (sums over B*L or B*T rows taken in another order)."""
    for i, (g, w) in enumerate(zip(got, want)):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= 5e-4 * scale + 5e-5, (name, i, err, scale)


def _check_regime(kernel, b, h, cell, directions, regime, device):
    """The cluster walk's plan for these shapes takes the regime a card
    case is there for: the weight slices "resident" or "streamed", a last
    row group only "partial"ly filled, or several "groups" of rows."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

    plan = walk.plan_on(kernel, b, h, cell, directions, device)
    assert plan.resident == (regime != "streamed"), (regime, plan)
    if regime == "partial":
        assert b % plan.rows, plan
    if regime == "groups":
        assert b > plan.rows, plan


# The backward walks' regimes (csrc/cluster_walk.cuh): more blocks than
# units, the recipe's shape, B = 1, a partly filled last row group,
# several groups of 16 rows, and slices streamed from L2 (H above the fit,
# and the widest H).
WALK_CASES = [(3, 13, 8, "resident"), (16, 144, 256, "resident"), (1, 30, 256, "resident"),
              (33, 20, 256, "partial"), (128, 24, 256, "groups"), (3, 9, 400, "streamed"),
              (4, 11, 1024, "streamed")]


@pytest.mark.parametrize("b,l,h,regime", WALK_CASES)
def test_bigru_scan2_bwd_kernel(card, b, l, h, regime):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    _check_regime(gru_scan.KERNEL_BWD, b, h, "gru", 2, regime, card)

    gen = torch.Generator().manual_seed(b * 7 + h)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    valid = (torch.arange(l, device=card)[None] < lens[:, None]).float()[:, :, None]
    xf = _rand(gen, b, l, 3 * h) * valid
    xb = _rand(gen, b, l, 3 * h) * valid
    wzr2 = _rand(gen, 2, h, 2 * h, scale=h ** -0.5)
    wh2 = _rand(gen, 2, h, h, scale=h ** -0.5)
    ysf, ysb = gru_scan.bigru_scan2_plain(xf, xb, wzr2, wh2)
    dysf, dysb = _rand(gen, b, l, h) * valid, _rand(gen, b, l, h) * valid
    args = (xf, xb, wzr2, wh2, ysf, ysb, dysf, dysb)
    before = gru_scan.KERNEL_BWD.launches
    got = gru_scan.bigru_scan2_bwd(*args)
    want = gru_scan.bigru_scan2_bwd_plain(*args)
    torch.cuda.synchronize()
    assert gru_scan.KERNEL_BWD.launches == before + 1
    _bwd_close(got, want, "bigru_scan2_bwd")


def _scan_case(card, gen, b, l, t, s, a, st):
    """Decoder-scan inputs with ragged encoder lengths, weights at the
    scale of torch's default init."""
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    h = _rand(gen, b, l, a, scale=0.5) * mask[:, :, None]
    u = lambda *shape: _rand(gen, *shape, scale=shape[0] ** -0.5)
    vh = (h @ u(a, s)).contiguous()
    weights = (u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0], u(2 * st, 2 * st), u(2 * st, st))
    return vh, h, mask, _rand(gen, b, t, st, scale=0.5), tuple(w.contiguous() for w in weights)


@pytest.mark.parametrize("b,l,t,dims", [(3, 13, 5, (16, 24, 8)), (16, 144, 56, (512, 512, 256))])
def test_attention_decode_scan_kernels(card, b, l, t, dims):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    s, a, st = dims
    gen = torch.Generator().manual_seed(b * 13 + l)
    vh, h, mask, yin, weights = _scan_case(card, gen, b, l, t, s, a, st)
    fwd, bwd = attention_scan.KERNEL_FWD.launches, attention_scan.KERNEL_BWD.launches
    got = attention_scan.attention_decode_scan(vh, h, mask, yin, *weights)
    want = attention_scan.attention_decode_scan_plain(vh, h, mask, yin, *weights)
    torch.cuda.synchronize()
    assert attention_scan.KERNEL_FWD.launches == fwd + 1
    assert _max_err(got, want) <= TOL
    cot = (_rand(gen, b, t, st), _rand(gen, b, t, a), _rand(gen, b, t, l))
    args = (vh, h, mask, yin, *weights, *want, *cot)
    got = attention_scan.attention_decode_scan_bwd(*args)
    want = attention_scan.attention_decode_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    assert attention_scan.KERNEL_BWD.launches == bwd + 1
    _bwd_close(got, want, "attention_decode_scan_bwd")


# K5 on its cluster walk, (B, L, T, (S, A, St), plan): B = 1; a partly
# filled last row group (B = 5 on 4 rows a cluster); several waves (B =
# 128 at the flagship's widths); L = 1, L = 3 < C and L = 37 not a
# multiple of C; S above the block's 512 threads; St not a multiple of 4
# (the exchanges store a value at a time); then a forced plan for each
# (C, R). `plan` is a ScanPlan (C, R) to run, or "plan" for the wrapper's
# own, whose (C, R) the case's last entry pins.
GRU_SCAN_CASES = [
    (1, 144, 56, (512, 512, 256), "plan", (16, 1)),
    (5, 16, 9, (40, 24, 32), (8, 4), None),
    (128, 144, 56, (512, 512, 256), "plan", (8, 4)),
    (2, 1, 7, (17, 12, 8), "plan", (16, 1)),
    (3, 3, 6, (40, 24, 32), "plan", (16, 1)),
    (4, 37, 9, (64, 40, 36), "plan", (16, 1)),
    (3, 20, 6, (600, 24, 32), "plan", (16, 1)),
    (3, 13, 5, (17, 12, 9), "plan", (16, 1)),
    (5, 37, 4, (17, 12, 9), (8, 2), None),
] + [(6, 29, 5, (40, 20, 36), (c, r), None) for c in (16, 8) for r in (1, 2, 4, 8)]


@pytest.mark.parametrize("case", range(len(GRU_SCAN_CASES)))
def test_gru_scan_backward_on_its_cluster_walk(card, monkeypatch, case):
    """K5 on the plan each case names, against its plain version (the
    backward tolerance), twice with the same bits and one launch a call."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, l, t, (s, a, st), run, want = GRU_SCAN_CASES[case]
    gen = torch.Generator().manual_seed(b * 37 + l + st)
    vh, h, mask, yin, weights = _scan_case(card, gen, b, l, t, s, a, st)
    plan = _walk_plan(card, monkeypatch, attention_scan.KERNEL_BWD, b, l, s, a, st, 0, 0, run,
                      want)
    saved = attention_scan.attention_decode_scan_plain(vh, h, mask, yin, *weights)
    cot = (_rand(gen, b, t, st), _rand(gen, b, t, a), _rand(gen, b, t, l))
    args = (vh, h, mask, yin, *weights, *saved, *cot)
    before = attention_scan.KERNEL_BWD.launches
    got = _bwd_twice(attention_scan.attention_decode_scan_bwd, args, plan, "K5")
    want_b = attention_scan.attention_decode_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    assert attention_scan.KERNEL_BWD.launches == before + 2
    _bwd_close(got, want_b, f"attention_decode_scan_bwd {plan}")


def test_gru_scan_backward_is_bitwise_deterministic(card):
    """K5 at the flagship's training shape, twice on the same inputs:
    every gradient bitwise equal (the walk's sums over a cluster's blocks
    and the reductions are taken in a fixed order, no atomics)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(11)
    vh, h, mask, yin, weights = _scan_case(card, gen, 16, 144, 56, 512, 512, 256)
    saved = attention_scan.attention_decode_scan(vh, h, mask, yin, *weights)
    cot = [_rand(gen, *t.shape) for t in saved]
    args = (vh, h, mask, yin, *weights, *saved, *cot)
    first, second = (attention_scan.attention_decode_scan_bwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(first, second)):
        assert torch.equal(x, y), i


def test_gru_scan_backward_refuses_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 16 or 8 blocks of K5's walk, a
    CUDA call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(6)
    vh, h, mask, yin, weights = _scan_case(card, gen, 2, 7, 3, 17, 12, 8)
    saved = attention_scan.attention_decode_scan_plain(vh, h, mask, yin, *weights)
    cot = [torch.ones_like(x) for x in saved]
    smem_limit, _ = attention_scan.scan_limits(attention_scan.KERNEL_BWD, card)
    monkeypatch.setattr(attention_scan, "scan_limits",
                        lambda kernel, device: (smem_limit, {16: 0, 8: 0}))
    before = attention_scan.KERNEL_BWD.launches
    with pytest.raises(RuntimeError, match="no cluster"):
        attention_scan.attention_decode_scan_bwd(vh, h, mask, yin, *weights, *saved, *cot)
    assert attention_scan.KERNEL_BWD.launches == before


def test_train_step_on_the_card_matches_the_cpu(card):
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    exp = experiment.timit_chorowski_normnll_colnorm()
    exp.model_kwargs.update(input_frame_size=10, hidden_frame_size=32, output_frame_size=32,
                            score_depth=32, state_depth=32, mlp_depth=16, output_depth=9)
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randn(4, 24, 10).astype(np.float32)),
             torch.tensor([24, 17, 9, 20]), torch.from_numpy(rng.randint(0, 9, (4, 6))),
             (torch.arange(6)[None] < torch.tensor([6, 3, 5, 1])[:, None]).float())
    runs = {}
    for dev in ("cpu", "cuda"):
        tx = optim.build_optimizer(exp.optim)
        init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                                   model.output_depth)
        state = init_fn(interop.to_torch(params, dev), torch.Generator().manual_seed(1))
        kernels = (gru_scan.KERNEL, gru_scan.KERNEL_BWD, attention_scan.KERNEL_FWD,
                   attention_scan.KERNEL_BWD)
        runs[dev] = []
        for _ in range(2):
            before = [k.launches for k in kernels]
            state, m = step_fn(state, tuple(x.to(dev) for x in batch))
            torch.cuda.synchronize()
            launched = [k.launches - n for k, n in zip(kernels, before)]
            assert launched == ([3, 3, 1, 1] if dev == "cuda" else [0, 0, 0, 0])
            runs[dev].append({k: float(v) for k, v in m.items()})
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for key in ("loss", "nll", "grad_norm", "param_norm"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got, want)


# K7's cluster walk (csrc/bilstm_scan.cu, plan cell "lstm_fwd"), from
# nonzero initial states: the serving shapes (B = 1 and 8, L' = 14), 5
# units a block (H = 40) and 32 (H = 256), fewer units than blocks (H = 5,
# C = 5), a part-empty last row group (B = 33 on R = 8), several waves
# (B = 128), one step (L = 1), and slices streamed from L2 (H = 337, just
# above the fit, in unequal slices of 42 and 43 units with 4-byte copies,
# and the widest H).
LSTM_FWD_CASES = [(1, 14, 128, "resident"), (8, 14, 128, "resident"), (3, 9, 40, "resident"),
                  (5, 20, 256, "resident"), (3, 7, 5, "resident"), (33, 9, 128, "partial"),
                  (128, 16, 128, "groups"), (5, 1, 128, "resident"), (3, 9, 337, "streamed"),
                  (2, 5, 1024, "streamed")]


def _lstm_fwd_case(b, l, h, seed):
    gen = torch.Generator().manual_seed(seed)
    return (_rand(gen, 2, b, l, 4 * h), _rand(gen, 2, b, h, scale=0.5),
            _rand(gen, 2, b, h, scale=0.5), _rand(gen, 2, h, 4 * h, scale=h ** -0.5))


def _check_lstm_fwd(args):
    """K7 on `args` against its plain version within TOL (hidden and cell
    states), one launch a call and a second call bitwise equal."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan

    before = lstm_scan.KERNEL.launches
    got = lstm_scan.bilstm_scan(*args)
    again = lstm_scan.bilstm_scan(*args)
    want = lstm_scan.bilstm_scan_plain(*args)
    torch.cuda.synchronize()
    assert lstm_scan.KERNEL.launches == before + 2
    assert _max_err(got, want) <= TOL
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("b,l,h,regime", LSTM_FWD_CASES)
def test_bilstm_scan_kernel(card, b, l, h, regime):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan, walk

    _check_regime(lstm_scan.KERNEL, b, h, "lstm_fwd", 2, regime, card)
    assert walk.plan_on(lstm_scan.KERNEL, b, h, "lstm_fwd", 2, card).cluster == min(8, h)
    _check_lstm_fwd(_lstm_fwd_case(b, l, h, b * 31 + h))


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
def test_bilstm_scan_forward_on_every_plan(card, monkeypatch, b, rows):
    """K7 at the conv+BiLSTM recipe's training shape (L' = 16, H = 128)
    under each row count its walk takes, forced in place of the plan's."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import walk

    monkeypatch.setattr(walk, "plan_on", lambda *_: walk.Plan(8, rows, True))
    _check_lstm_fwd(_lstm_fwd_case(b, 16, 128, b + rows))


def test_bilstm_scan_forward_refuses_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 8 blocks of K7's walk, a CUDA
    call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan, walk

    args = _lstm_fwd_case(2, 5, 16, 4)
    monkeypatch.setattr(walk, "_LIMITS", {})
    monkeypatch.setattr(lstm_scan.KERNEL, "helper", lambda symbol, argtypes: lambda *args: 0)
    before = lstm_scan.KERNEL.launches
    with pytest.raises(RuntimeError, match="no cluster"):
        lstm_scan.bilstm_scan(*args)
    assert lstm_scan.KERNEL.launches == before


# (cell, feature_maps, filt_size, (S, St, A, V), readout): the conv+BiLSTM
# recipe's decoder, the flagship's widths with location-aware attention
# (an even filter), the recipe without the location term, small odd
# widths of each, and VGG's decoder with its four-layer readout over a
# character vocabulary.
LOC_LSTM_CASES = [
    ("lstm", 16, 5, (150, 400, 256, 62), (("linear", 124), ("relu",), ("linear", 62))),
    ("gru", 16, 10, (512, 256, 512, 62), (("dropout", 0.5), ("maxout", 64, 7), ("linear", 62))),
    ("lstm", 0, 5, (150, 400, 256, 62), (("linear", 124), ("relu",), ("linear", 62))),
    ("lstm", 3, 4, (13, 10, 18, 7), (("maxout", 5, 3), ("relu",), ("linear", 7))),
    ("gru", 0, 5, (16, 12, 20, 6), (("linear", 9), ("relu",), ("linear", 6))),
    ("gru", 0, 10, (512, 256, 512, 30), (("maxout", 64, 7), ("linear", 64), ("maxout", 64, 7),
                                          ("linear", 30))),
]


def _k8_case(card, case, b, k, l, dead=None):
    """K8's configuration LOC_LSTM_CASES[case] and its inputs at (B, K, L),
    encoder lengths ragged; every position of batch row `dead` masked."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops import attention

    cell, fm, f, (s_dim, st, a, v), ro = LOC_LSTM_CASES[case]
    cfg = attention.AttentionConfig(score_depth=s_dim, state_depth=st, annotation_depth=a,
                                    output_depth=v, readout=ro, feature_maps=fm, filt_size=f,
                                    cell=cell)
    gen = torch.Generator().manual_seed(b * 100 + k * 10 + case)
    params = interop.to_torch(attention.attention_init(gen, cfg), card)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    if dead is not None:
        mask[dead] = 0.0
    h = _rand(gen, b, l, a)
    vh = attention.precompute_vh(params, h).contiguous()
    state = (torch.softmax(_rand(gen, b, k, l), -1), _rand(gen, b, k, st, scale=0.3),
             _rand(gen, b, k, st, scale=0.3))
    y = torch.nn.functional.one_hot(torch.randint(0, v, (b, k), generator=gen), v).float().cuda()
    return params, cfg, (state, y, vh, h, mask)


def _k8_plans(card, cfg, b, k, l):
    """Every plan K8 can take at this shape on the card: each cluster size
    the card holds whose shared memory fits, in the waves it needs."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    lstm, fm, f = cfg.cell == "lstm", cfg.feature_maps, cfg.filt_size if cfg.feature_maps else 0
    smem_limit, resident = step.step_loc_lstm_limits(card, lstm, fm > 0)
    dense = step.k8_dense(step.k8_layers(cfg))
    groups, kg = step.hyp_groups(k)
    return [step.StepPlan(c, -(-b * groups // resident[c])) for c in step.CLUSTERS
            if resident[c] >= 1 and step.step_loc_lstm_smem_bytes(
                kg, l, cfg.score_depth, cfg.annotation_depth, cfg.state_depth, fm, f, c, lstm,
                dense) <= smem_limit]


# K8 runs a batch row on a cluster of 16 or 8 blocks, as K2 does: the
# serving shapes (L' = 14), K = 8 at L = 37 and 144, and K2's edges: L < C,
# L not a multiple of C with a row whose every position is masked, K = 1
# with a masked row, and B = 16, K = 8, L = 1500; beams of 10 and 16
# hypotheses (a cluster a row and group); each under every cluster size
# the card holds.
@pytest.mark.parametrize("case", range(len(LOC_LSTM_CASES)))
@pytest.mark.parametrize("b,k,l,dead", [(1, 5, 14, None), (8, 5, 14, None), (3, 8, 37, None),
                                        (1, 8, 144, None), (2, 5, 3, None), (3, 5, 37, 1),
                                        (8, 1, 14, 7), (16, 8, 1500, None), (2, 10, 37, None),
                                        (2, 16, 14, 1)])
def test_fused_attention_step_loc_lstm_kernel(card, monkeypatch, case, b, k, l, dead):
    """K8 against its plain version within TOL under each cluster size,
    one launch a call, a second call bitwise equal (fixed-order sums), and
    alpha and c exactly 0 on a row with no valid position."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    params, cfg, (state, y, vh, h, mask) = _k8_case(card, case, b, k, l, dead)
    (_, _, wm), want = attention_step.fused_attention_step_plain(params, cfg, state, y, vh, h,
                                                                 mask)
    plans = _k8_plans(card, cfg, b, k, l)
    assert len(plans) == len(attention_step.CLUSTERS), plans
    for plan in plans:
        monkeypatch.setattr(attention_step, "step_loc_lstm_plan_on", lambda *_, p=plan: p)
        k2, k8 = attention_step.KERNEL.launches, attention_step.KERNEL_LOC_LSTM.launches
        (ga, gs, gm), got = attention_step.fused_attention_step(params, cfg, state, y, vh, h,
                                                                mask)
        torch.cuda.synchronize()
        assert attention_step.KERNEL_LOC_LSTM.launches == k8 + 1
        assert attention_step.KERNEL.launches == k2
        for key in ("alpha", "c", "s", "logp"):
            assert _max_err([got[key]], [want[key]]) <= TOL, (plan, key)
        assert _max_err([gm], [wm]) <= TOL, plan
        assert (gm is state[2]) == (cfg.cell == "gru")
        if dead is not None:
            assert not got["alpha"][dead].any() and not got["c"][dead].any(), plan
        (_, _, gm2), again = attention_step.fused_attention_step(params, cfg, state, y, vh, h,
                                                                 mask)
        torch.cuda.synchronize()
        assert attention_step.KERNEL_LOC_LSTM.launches == k8 + 2
        for key in ("alpha", "c", "s", "logp"):
            assert torch.equal(got[key], again[key]), (plan, key)
        assert torch.equal(gm, gm2), plan


# K8 keeps a block's ceil(L / C) positions in shared memory, 17 floats
# each at K = 8 with the location term: at the conv+BiLSTM
# recipe's widths one batch row fits L' up to this many positions, on
# clusters of 16 (step_loc_lstm_smem_bytes; tests/test_torch_step_plan_loc_lstm.py).
K8_CAP = 21456


def test_fused_attention_step_loc_lstm_refuses_what_does_not_fit(card):
    """At the conv+BiLSTM recipe's widths and K = 8, K8 serves one batch
    row up to L' = K8_CAP on the card (the count's cap under the card's
    shared memory), and a CUDA call one position longer raises before any
    launch; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    params, cfg, _ = _k8_case(card, 0, 1, 8, 14)
    dense = step.k8_dense(step.k8_layers(cfg))
    smem_limit, resident = step.step_loc_lstm_limits(card, True, True)
    fits = lambda l: any(resident[c] >= 1 and step.step_loc_lstm_smem_bytes(
        8, l, 150, 256, 400, 16, 5, c, True, dense) <= smem_limit for c in step.CLUSTERS)
    assert fits(K8_CAP) and not fits(K8_CAP + 1), smem_limit
    for l in (K8_CAP, K8_CAP + 1):
        _, _, (state, y, vh, h, mask) = _k8_case(card, 0, 1, 8, l)
        before = step.KERNEL_LOC_LSTM.launches
        if l == K8_CAP:
            _, got = step.fused_attention_step(params, cfg, state, y, vh, h, mask)
            _, want = step.fused_attention_step_plain(params, cfg, state, y, vh, h, mask)
            torch.cuda.synchronize()
            assert step.KERNEL_LOC_LSTM.launches == before + 1
            for key in ("alpha", "c", "s", "logp"):
                assert _max_err([got[key]], [want[key]]) <= TOL, key
            continue
        with pytest.raises(RuntimeError, match="no cluster"):
            step.fused_attention_step(params, cfg, state, y, vh, h, mask)
        assert step.KERNEL_LOC_LSTM.launches == before


# VGG's decoder (content-only GRU, maxout 64 x 7 -> linear 64 -> maxout
# 64 x 7 -> linear V) on its 543 encoder positions for 35 s: a LibriSpeech
# word vocabulary at K = 5 and 8, and V = 3,125, one past the cap of the
# layout that kept the last layer in one block.
@pytest.mark.parametrize("b,k,v,dead", [(16, 5, 34000, 3), (16, 8, 34000, None),
                                        (4, 5, 3125, 1), (2, 16, 34000, None)])
def test_fused_attention_step_loc_lstm_serves_vgg_over_words(card, b, k, v, dead):
    """K8 spreads its last readout layer over the cluster: VGG over a word
    vocabulary runs in one launch a call, within TOL of its plain version,
    a second call bitwise equal."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step as step

    cfg = attention.AttentionConfig(score_depth=512, state_depth=256, annotation_depth=512,
                                    output_depth=v, readout=(("maxout", 64, 7), ("linear", 64),
                                                             ("maxout", 64, 7), ("linear", v)))
    gen = torch.Generator().manual_seed(v + k)
    params = interop.to_torch(attention.attention_init(gen, cfg), card)
    l = 543
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    if dead is not None:
        mask[dead] = 0.0
    h = _rand(gen, b, l, 512)
    vh = attention.precompute_vh(params, h).contiguous()
    state = (torch.softmax(_rand(gen, b, k, l), -1), _rand(gen, b, k, 256, scale=0.3),
             _rand(gen, b, k, 256, scale=0.3))
    y = torch.nn.functional.one_hot(torch.randint(0, v, (b, k), generator=gen), v).float().cuda()
    args = (params, cfg, state, y, vh, h, mask)
    assert not step.uses_k2(cfg)
    before = step.KERNEL_LOC_LSTM.launches
    _, got = step.fused_attention_step(*args)
    _, want = step.fused_attention_step_plain(*args)
    torch.cuda.synchronize()
    assert step.KERNEL_LOC_LSTM.launches == before + 1
    for key in ("alpha", "c", "s", "logp"):
        assert _max_err([got[key]], [want[key]]) <= TOL, key
    assert torch.isfinite(got["logp"]).all()
    _, again = step.fused_attention_step(*args)
    torch.cuda.synchronize()
    for key in ("alpha", "c", "s", "logp"):
        assert torch.equal(got[key], again[key]), key


def test_beam_search_ties_on_the_card_match_the_cpu(card):
    """A zeroed last readout layer makes every log-prob tie: the card's
    beam picks the same tokens as its CPU run (lower flat index first)."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.decode import beam
    from seq2seq_attention_asr_tpu_torch.ops import attention

    cfg = attention.AttentionConfig(score_depth=16, state_depth=16, annotation_depth=24,
                                    output_depth=62, readout=(("maxout", 8, 3), ("linear", 62)))
    params = attention.attention_init(torch.Generator().manual_seed(0), cfg)
    params["readout"][-1] = {key: torch.zeros_like(t) for key, t in params["readout"][-1].items()}
    h = torch.randn(2, 12, 24, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([12, 7])
    got = beam.beam_search(interop.to_torch(params, card), cfg, h.cuda(), lens.cuda(), 61, k=5)
    want = beam.beam_search(params, cfg, h, lens, 61, k=5, device="cpu")
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert torch.equal(got.lengths.cpu(), want.lengths)


@pytest.mark.parametrize("exact", [False, True])
def test_conv_bilstm_transcriber_on_the_card_matches_the_cpu(card, exact):
    from seq2seq_attention_asr_tpu_torch import serve
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step, gru_scan, logmel, lstm_scan
    from seq2seq_attention_asr_tpu_torch.train import experiment

    exp = experiment.timit_conv_bilstm()
    exp.model_kwargs.update(hidden_frame_size=32, output_frame_size=16, score_depth=24,
                            feature_maps=4, state_depth=32, output_depth=9)
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")
    params["decoder"]["readout"][-1]["b"][8] -= 2.0  # keep eos from ending every hypothesis at once
    rng = np.random.RandomState(0)
    pcms = [(0.1 * rng.randn(n)).astype(np.float32) for n in (9000, 20000, 9500)]
    kw = dict(eos_id=8, pad_frames=10, beam_k=3, exact=exact)
    kernels = (gru_scan.KERNEL, attention_step.KERNEL, attention_step.KERNEL_LOC_LSTM,
               logmel.KERNEL, lstm_scan.KERNEL)
    for kern in kernels:
        kern.launches = 0
    got = serve.Transcriber(model, params, **kw).transcribe(pcms)
    assert lstm_scan.KERNEL.launches == 2  # two frame buckets
    assert logmel.KERNEL.launches == (0 if exact else 2)
    assert gru_scan.KERNEL.launches == attention_step.KERNEL.launches == 0
    assert attention_step.KERNEL_LOC_LSTM.launches >= 2
    want = serve.Transcriber(model, params, device="cpu", **kw).transcribe(pcms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert abs(g.score - w.score) <= 1e-3


@pytest.mark.parametrize("b,l,h,regime", [
    (16, 16, 128, "resident"), (3, 9, 40, "resident"), (1, 14, 128, "resident"),
    (33, 7, 128, "partial"), (128, 16, 128, "groups"), (2, 5, 1024, "streamed")])
def test_bilstm_scan_bwd_kernel(card, b, l, h, regime):
    """K9 from nonzero initial states, h_prev and c_prev from K7's plain
    forward shifted by one step, as BiLSTMScan forms them, in each regime
    of its cluster walk."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan

    _check_regime(lstm_scan.KERNEL_BWD, b, h, "lstm", 2, regime, card)

    gen = torch.Generator().manual_seed(b * 17 + h)
    xproj2 = _rand(gen, 2, b, l, 4 * h)
    h02, c02 = _rand(gen, 2, b, h, scale=0.5), _rand(gen, 2, b, h, scale=0.5)
    wh2 = _rand(gen, 2, h, 4 * h, scale=h ** -0.5)
    hs, cs = lstm_scan.bilstm_scan_plain(xproj2, h02, c02, wh2)
    h_prev = torch.cat([h02[:, :, None], hs[:, :, :-1]], dim=2)
    c_prev = torch.cat([c02[:, :, None], cs[:, :, :-1]], dim=2)
    args = (xproj2, h_prev, c_prev, _rand(gen, 2, b, l, h), wh2)
    before = lstm_scan.KERNEL_BWD.launches
    got = lstm_scan.bilstm_scan_bwd(*args)
    want = lstm_scan.bilstm_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    assert lstm_scan.KERNEL_BWD.launches == before + 1
    _bwd_close(got, want, "bilstm_scan_bwd")


def _loc_lstm_case(card, gen, b, l, t, s, a, st, fm, f):
    """Loc-LSTM scan inputs with ragged encoder lengths, weights at the
    scale of torch's default init."""
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    lens[0] = l
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    h = _rand(gen, b, l, a, scale=0.5) * mask[:, :, None]
    u = lambda *shape: _rand(gen, *shape, scale=shape[0] ** -0.5)
    vh = (h @ u(a, s)).contiguous()
    weights = (u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0], u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0], u(f, fm),
               u(f, fm)[0], u(fm, s))
    return vh, h, mask, _rand(gen, b, t, st, scale=0.5), tuple(w.contiguous() for w in weights)


# (B, L, T, (S, A, St, FM, F), plan): the conv+BiLSTM recipe's training
# shape at its batch, at B=128 (several waves) and at B=1, and small odd
# widths with an even filter; then two score units a thread (S above the
# block's 512 threads), more dwconv and dbconv entries than threads (FM
# 16, F 32; FM 20, F 31), FM = 3, L' = 1, L' = 3 < C, L' = 37 not a
# multiple of C, and a part-filled last row group (B = 5 on 4 rows a
# cluster). `plan` is the walk's: a ScanPlan (C, R) to run, or "plan" for
# the wrapper's own, whose (C, R) at each batch LSTM_PLANS pins.
LOC_LSTM_SCAN_CASES = [
    (16, 16, 56, (150, 256, 400, 16, 5), "plan"), (3, 13, 5, (17, 12, 9, 3, 4), "plan"),
    (128, 16, 56, (150, 256, 400, 16, 5), "plan"), (1, 16, 56, (150, 256, 400, 16, 5), "plan"),
    (3, 20, 6, (600, 24, 33, 4, 5), "plan"), (2, 40, 5, (64, 24, 33, 16, 32), "plan"),
    (2, 40, 5, (40, 24, 33, 20, 31), "plan"), (2, 1, 7, (17, 12, 9, 4, 5), "plan"),
    (3, 3, 6, (40, 24, 33, 4, 6), (8, 2)), (4, 37, 9, (64, 40, 33, 16, 5), (16, 8)),
    (5, 16, 9, (150, 256, 400, 16, 5), (8, 4)), (5, 37, 4, (17, 12, 9, 3, 4), (8, 1)),
]
# The wrapper's (C, R) by batch on an H100 (7 resident clusters of 16
# blocks, 15 of 8).
LSTM_PLANS = {1: (16, 1), 2: (16, 1), 3: (16, 1), 4: (16, 1), 5: (16, 1), 16: (16, 4), 128: (8, 8)}


def _walk_plan(card, monkeypatch, kernel, b, l, s, a, st, fm, f, run, want=None):
    """The ScanPlan a K11, K15 or K5 case runs: the wrapper's, held to
    `want` (for K11 and K15 by default LSTM_PLANS'), or `run`'s (C, R),
    which the wrappers then take in place of scan_plan_on's."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    plan = attention_scan.scan_plan_on(kernel, b, l, s, a, st, fm, f, card)
    if run == "plan":
        assert (plan.cluster, plan.rows) == (want or LSTM_PLANS[b]), plan
        return plan
    plan = attention_scan.ScanPlan(*run)
    monkeypatch.setattr(attention_scan, "scan_plan_on", lambda *_: plan)
    return plan


def _bwd_twice(bwd, args, plan, name):
    """bwd's outputs on `args` (run on `plan`), after a second call on the
    same inputs gave the same bits (sums in a fixed order, no atomics)."""
    first, second = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(first, second)):
        assert torch.equal(x, y), (name, plan, i)
    return first


@pytest.mark.parametrize("case", range(len(LOC_LSTM_SCAN_CASES)))
def test_attention_decode_scan_loc_lstm_kernels(card, monkeypatch, case):
    """K10 against its plain version (1e-4 abs), then K11 on its plan with
    cotangents on s, c and alpha (and on mem, or none), against its plain
    version, each backward twice with the same bits; and K11 once more on
    the sequences K10 saved."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    b, l, t, (s, a, st, fm, f), run = LOC_LSTM_SCAN_CASES[case]
    gen = torch.Generator().manual_seed(b * 29 + l)
    vh, h, mask, yin, weights = _loc_lstm_case(card, gen, b, l, t, s, a, st, fm, f)
    plan = _walk_plan(card, monkeypatch, attention_scan.KERNEL_LOC_LSTM_BWD, b, l, s, a, st,
                      fm, f, run)
    fwd = attention_scan.KERNEL_LOC_LSTM_FWD.launches
    bwd = attention_scan.KERNEL_LOC_LSTM_BWD.launches
    got = attention_scan.attention_decode_scan_loc_lstm(vh, h, mask, yin, *weights)
    want = attention_scan.attention_decode_scan_loc_lstm_plain(vh, h, mask, yin, *weights)
    torch.cuda.synchronize()
    assert attention_scan.KERNEL_LOC_LSTM_FWD.launches == fwd + 1
    assert _max_err(got, want) <= TOL
    for dmem in (None, _rand(gen, b, t, st)):
        cot = (_rand(gen, b, t, st), _rand(gen, b, t, a), _rand(gen, b, t, l), dmem)
        args = (vh, h, mask, yin, *weights, *want, *cot)
        got_b = _bwd_twice(attention_scan.attention_decode_scan_loc_lstm_bwd, args, plan, "K11")
        want_b = attention_scan.attention_decode_scan_loc_lstm_bwd_plain(*args)
        torch.cuda.synchronize()
        _bwd_close(got_b, want_b, f"attention_decode_scan_loc_lstm_bwd {plan}")
    args = (vh, h, mask, yin, *weights, *got, *cot)
    _bwd_close(attention_scan.attention_decode_scan_loc_lstm_bwd(*args),
               attention_scan.attention_decode_scan_loc_lstm_bwd_plain(*args),
               f"attention_decode_scan_loc_lstm_bwd on K10's sequences {plan}")
    assert attention_scan.KERNEL_LOC_LSTM_BWD.launches == bwd + 5


def test_lstm_scan_backwards_refuse_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 16 or 8 blocks of K11's or
    K15's walk, a CUDA call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(5)
    vh, h, mask, yin, weights = _loc_lstm_case(card, gen, 2, 7, 3, 17, 12, 9, 4, 5)
    saved = attention_scan.attention_decode_scan_loc_lstm_plain(vh, h, mask, yin, *weights)
    cot = (torch.ones_like(saved[0]), None, None, None)
    calls = {attention_scan.KERNEL_LOC_LSTM_BWD: lambda: attention_scan.
             attention_decode_scan_loc_lstm_bwd(vh, h, mask, yin, *weights, *saved, *cot),
             attention_scan.KERNEL_LSTM_BWD: lambda: attention_scan.
             attention_decode_scan_lstm_bwd(vh, h, mask, yin, *weights[:10], *saved, *cot)}
    smem_limit, _ = attention_scan.scan_limits(attention_scan.KERNEL_LOC_LSTM_BWD, card)
    monkeypatch.setattr(attention_scan, "scan_limits",
                        lambda kernel, device: (smem_limit, {16: 0, 8: 0}))
    for kernel, call in calls.items():
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no cluster"):
            call()
        assert kernel.launches == before


# (kind, B, L, T, (S, A, St, FM, F)): the LSTM decoder forwards K10
# ("loc") and K14 ("lstm") on their cluster walk, each under every plan
# (C, R, W_cx resident or streamed) that fits: the conv+BiLSTM recipe's
# training shape at its batch and at B=128; L' = 13 < C with St = 9, A =
# 12 (not multiples of 4), FM = 3 and an even filter; L' = 37, not a
# multiple of C, at B = 5 (not a multiple of R) with St = 33; L' = 1; S
# above the block's 512 threads; a filter of 31 whose window spans many
# blocks. The last row of every case has every position masked.
FWD_SCAN_CASES = [
    ("loc", 16, 16, 56, (150, 256, 400, 16, 5)), ("lstm", 16, 16, 56, (150, 256, 400, 0, 0)),
    ("loc", 128, 16, 56, (150, 256, 400, 16, 5)), ("lstm", 128, 16, 56, (150, 256, 400, 0, 0)),
    ("loc", 3, 13, 5, (17, 12, 9, 3, 4)), ("lstm", 3, 13, 5, (17, 12, 9, 0, 0)),
    ("loc", 5, 37, 9, (64, 40, 33, 16, 5)), ("lstm", 5, 37, 9, (64, 40, 33, 0, 0)),
    ("lstm", 2, 1, 7, (17, 12, 9, 0, 0)), ("loc", 3, 20, 6, (600, 24, 36, 4, 5)),
    ("loc", 2, 40, 5, (40, 24, 33, 20, 31)),
]


def _fwd_scan(kind):
    """(the forward, its plain version, its kernel) of K10 or K14."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as a

    if kind == "loc":
        return (a.attention_decode_scan_loc_lstm, a.attention_decode_scan_loc_lstm_plain,
                a.KERNEL_LOC_LSTM_FWD)
    return a.attention_decode_scan_lstm, a.attention_decode_scan_lstm_plain, a.KERNEL_LSTM_FWD


@pytest.mark.parametrize("case", range(len(FWD_SCAN_CASES)))
def test_lstm_scan_forwards_on_every_plan(card, monkeypatch, case):
    """K10 or K14 under each plan that fits the card, forced in place of
    fwd_plan_on's, against the plain version (1e-4 abs): one launch a
    call, two calls with the same bits, and alpha and c exactly 0 on the
    row whose every position is masked; then on the wrapper's own plan."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    kind, b, l, t, (s, a, st, fm, f) = FWD_SCAN_CASES[case]
    fwd, plain, kernel = _fwd_scan(kind)
    gen = torch.Generator().manual_seed(b * 37 + l)
    if kind == "loc":
        vh, h, mask, yin, weights = _loc_lstm_case(card, gen, b, l, t, s, a, st, fm, f)
    else:
        vh, h, mask, yin, weights = _decoder_case(card, gen, b, l, t, s, a, st, "lstm")
    mask[-1] = 0
    want = plain(vh, h, mask, yin, *weights)
    smem_limit, resident = attention_scan.scan_limits(kernel, card)
    runs = [attention_scan.FwdPlan(c, r, held)
            for c in attention_scan.WALK_CLUSTERS for r in attention_scan.WALK_ROWS
            for held in (False, True)
            if resident[c] >= 1 and attention_scan.fwd_smem_bytes(
                r, c, l, s, a, st, fm, f, held) <= smem_limit]
    assert len(runs) >= 4, runs
    default = attention_scan.fwd_plan_on
    for run in runs + [None]:
        monkeypatch.setattr(attention_scan, "fwd_plan_on",
                            default if run is None else lambda *_, run=run: run)
        before = kernel.launches
        got, again = fwd(vh, h, mask, yin, *weights), fwd(vh, h, mask, yin, *weights)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2, run
        assert _max_err(got, want) <= TOL, (run, _max_err(got, want))
        for x, y in zip(got, again):
            assert torch.equal(x, y), run
        assert not got[1][-1].any() and not got[2][-1].any(), run


def test_lstm_scan_forwards_refuse_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 16 or 8 blocks of K10's or
    K14's walk, a CUDA call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(6)
    vh, h, mask, yin, weights = _loc_lstm_case(card, gen, 2, 7, 3, 17, 12, 9, 4, 5)
    calls = {attention_scan.KERNEL_LOC_LSTM_FWD: lambda: attention_scan.
             attention_decode_scan_loc_lstm(vh, h, mask, yin, *weights),
             attention_scan.KERNEL_LSTM_FWD: lambda: attention_scan.
             attention_decode_scan_lstm(vh, h, mask, yin, *weights[:10])}
    smem_limit, _ = attention_scan.scan_limits(attention_scan.KERNEL_LOC_LSTM_FWD, card)
    monkeypatch.setattr(attention_scan, "scan_limits",
                        lambda kernel, device: (smem_limit, {16: 0, 8: 0}))
    for kernel, call in calls.items():
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no cluster"):
            call()
        assert kernel.launches == before


def test_gru_scan_forwards_refuse_without_a_cluster(card, monkeypatch):
    """Where the device holds no cluster of 16 or 8 blocks of K12's or
    K4's walk, a CUDA call raises; it never takes the plain path."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(8)
    vh, h, mask, yin, weights = _decoder_case(card, gen, 2, 7, 3, 17, 12, 9, "gru", 4, 5)
    calls = {attention_scan.KERNEL_LOC_FWD: lambda: attention_scan.
             attention_decode_scan_loc(vh, h, mask, yin, *weights),
             attention_scan.KERNEL_FWD: lambda: attention_scan.
             attention_decode_scan(vh, h, mask, yin, *weights[:9])}
    smem_limit, _ = attention_scan.scan_limits(attention_scan.KERNEL_LOC_FWD, card)
    monkeypatch.setattr(attention_scan, "scan_limits",
                        lambda kernel, device: (smem_limit, {16: 0, 8: 0}))
    for kernel, call in calls.items():
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no cluster"):
            call()
        assert kernel.launches == before


def test_lstm_scan_plan_on_the_card(card):
    """The card holds clusters of 16 and of 8 blocks of K11's, K15's and
    K5's walks, and of K10's, K14's, K12's and K4's, at full shared
    memory, as LSTM_PLANS, GRU_SCAN_CASES and tests/test_torch_fwd_plan.py
    assume."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    for kernel in (attention_scan.KERNEL_LOC_LSTM_BWD, attention_scan.KERNEL_LSTM_BWD,
                   attention_scan.KERNEL_BWD, attention_scan.KERNEL_LOC_LSTM_FWD,
                   attention_scan.KERNEL_LSTM_FWD, attention_scan.KERNEL_LOC_FWD,
                   attention_scan.KERNEL_FWD):
        smem_limit, resident = attention_scan.scan_limits(kernel, card)
        assert smem_limit == 232448 and resident == {16: 7, 8: 15}, (kernel.name, resident)


def test_conv_bilstm_train_step_on_the_card_matches_the_cpu(card):
    """Two steps of timit_conv_bilstm at small widths: one launch each of
    K7, K9, K10 and K11 per card step and no other kernel; metrics within
    1e-4 relative of the CPU run."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step,
                                                          gru_scan, logmel, lstm_scan)
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    exp = experiment.timit_conv_bilstm()
    exp.model_kwargs.update(input_frame_size=10, hidden_frame_size=32, output_frame_size=16,
                            score_depth=24, feature_maps=4, state_depth=32, output_depth=9)
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randn(4, 80, 10).astype(np.float32)),
             torch.tensor([80, 61, 72, 50]), torch.from_numpy(rng.randint(0, 9, (4, 6))),
             (torch.arange(6)[None] < torch.tensor([6, 3, 5, 1])[:, None]).float())
    kernels = (lstm_scan.KERNEL, lstm_scan.KERNEL_BWD, attention_scan.KERNEL_LOC_LSTM_FWD,
               attention_scan.KERNEL_LOC_LSTM_BWD, gru_scan.KERNEL, gru_scan.KERNEL_BWD,
               attention_scan.KERNEL_FWD, attention_scan.KERNEL_BWD, attention_step.KERNEL,
               attention_step.KERNEL_LOC_LSTM, logmel.KERNEL)
    runs = {}
    for dev in ("cpu", "cuda"):
        tx = optim.build_optimizer(exp.optim)
        init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                                   model.output_depth)
        state = init_fn(interop.to_torch(params, dev), torch.Generator().manual_seed(1))
        runs[dev] = []
        for _ in range(2):
            before = [k.launches for k in kernels]
            state, m = step_fn(state, tuple(x.to(dev) for x in batch))
            torch.cuda.synchronize()
            launched = [k.launches - n for k, n in zip(kernels, before)]
            assert launched == ([1, 1, 1, 1] + [0] * 7 if dev == "cuda" else [0] * 11)
            runs[dev].append({k: float(v) for k, v in m.items()})
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for key in ("loss", "nll", "grad_norm", "param_norm"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got, want)


def _decoder_case(card, gen, b, l, t, s, a, st, cell, fm=0, f=0):
    """Decoder-scan inputs for the GRU ("gru": with the location term where
    fm > 0) or the LSTM ("lstm"): ragged encoder lengths, weights at the
    scale of torch's default init."""
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    lens[0] = l
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    h = _rand(gen, b, l, a, scale=0.5) * mask[:, :, None]
    u = lambda *shape: _rand(gen, *shape, scale=shape[0] ** -0.5)
    vh = (h @ u(a, s)).contiguous()
    weights = [u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
               u(2 * st, st)[0]]
    weights += ([u(2 * st, 2 * st), u(2 * st, st)] if cell == "gru"
                else [u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0]])
    if fm:
        weights += [u(f, fm), u(f, fm)[0], u(fm, s)]
    return vh, h, mask, _rand(gen, b, t, st, scale=0.5), tuple(w.contiguous() for w in weights)


def _decoder_scans(cell):
    """(forward, backward, their plain versions, the two kernels) of the
    location-aware GRU scan ("gru": K12, K13), the content-only GRU scan
    ("content_gru": K4, K5) or the content-only LSTM scan ("lstm": K14,
    K15)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as a

    if cell == "gru":
        return (a.attention_decode_scan_loc, a.attention_decode_scan_loc_bwd,
                a.attention_decode_scan_loc_plain, a.attention_decode_scan_loc_bwd_plain,
                a.KERNEL_LOC_FWD, a.KERNEL_LOC_BWD)
    if cell == "content_gru":
        return (a.attention_decode_scan, a.attention_decode_scan_bwd,
                a.attention_decode_scan_plain, a.attention_decode_scan_bwd_plain,
                a.KERNEL_FWD, a.KERNEL_BWD)
    return (a.attention_decode_scan_lstm, a.attention_decode_scan_lstm_bwd,
            a.attention_decode_scan_lstm_plain, a.attention_decode_scan_lstm_bwd_plain,
            a.KERNEL_LSTM_FWD, a.KERNEL_LSTM_BWD)


# (cell, B, L, T, (S, A, St, FM, F)[, plan]): the location-aware GRU at
# the flagship's training shape (filter 10) at its batch, at B=128 and at
# B=1, and at small odd widths with filters 4 and 5; then the ways the
# walk sums the location term's weight gradients, as in
# LOC_LSTM_SCAN_CASES (S above 512; FM 16 with F 32; FM 20 with F 31); and
# on forced plans: the flagship's widths with filter 10 on clusters of 16
# (9 positions a block, a halo of 9) and of 8 with a part-filled last row
# group, L = 40 on clusters of 16 (2 or 3 positions a block: the dfeat
# halo reaches past the nearest neighbours), L = 9 < C with filter 10 and
# FM = 3 (empty blocks; the halo stored a value at a time), and an odd
# filter at L = 37 not a multiple of C; the
# content-only LSTM at the conv+BiLSTM recipe's training shape at its
# batch, at B=128 and at B=1, and at small odd widths, on the plan of
# LOC_LSTM_SCAN_CASES ("plan" where none is given): L' = 1, L' = 3 < C,
# L' = 37 not a multiple of C, S above 512 threads, a part-filled last row
# group; then the content-only GRU (K4, K5) at the flagship's training
# shape at B = 1, 16 and 128, and at small odd widths: L = 13 < C with St =
# 9 and A = 12 (not multiples of 4), L = 37 not a multiple of C at B = 5.
# The GRU forwards (K12, K4) run on their cluster walk under every plan
# that fits the card.
DECODER_SCAN_CASES = [
    ("gru", 16, 144, 56, (512, 512, 256, 16, 10)), ("gru", 3, 13, 5, (17, 12, 9, 3, 4)),
    ("gru", 5, 40, 9, (40, 24, 33, 4, 5)), ("lstm", 16, 16, 56, (150, 256, 400, 0, 0)),
    ("lstm", 3, 13, 5, (17, 12, 9, 0, 0)), ("lstm", 4, 37, 9, (64, 40, 33, 0, 0)),
    ("gru", 128, 144, 56, (512, 512, 256, 16, 10)), ("gru", 1, 144, 56, (512, 512, 256, 16, 10)),
    ("gru", 3, 20, 6, (600, 24, 33, 4, 5)), ("gru", 2, 40, 5, (64, 24, 33, 16, 32)),
    ("gru", 2, 40, 5, (40, 24, 33, 20, 31)),
    ("gru", 5, 144, 9, (512, 512, 256, 16, 10), (16, 2)),
    ("gru", 5, 144, 9, (512, 512, 256, 16, 10), (8, 4)),
    ("gru", 3, 40, 6, (64, 24, 36, 16, 10), (16, 1)),
    ("gru", 2, 9, 4, (17, 12, 9, 3, 10), (16, 1)),
    ("gru", 5, 37, 5, (40, 24, 33, 4, 5), (8, 2)),
    ("lstm", 128, 16, 56, (150, 256, 400, 0, 0)), ("lstm", 1, 16, 56, (150, 256, 400, 0, 0)),
    ("lstm", 2, 1, 7, (17, 12, 9, 0, 0)), ("lstm", 3, 3, 6, (40, 24, 33, 0, 0), (8, 2)),
    ("lstm", 4, 37, 9, (64, 40, 33, 0, 0), (16, 8)), ("lstm", 3, 20, 6, (600, 24, 33, 0, 0)),
    ("lstm", 5, 16, 9, (150, 256, 400, 0, 0), (8, 4)),
    ("lstm", 5, 37, 4, (17, 12, 9, 0, 0), (8, 1)),
    ("content_gru", 1, 144, 56, (512, 512, 256, 0, 0)),
    ("content_gru", 16, 144, 56, (512, 512, 256, 0, 0)),
    ("content_gru", 128, 144, 56, (512, 512, 256, 0, 0)),
    ("content_gru", 3, 13, 5, (17, 12, 9, 0, 0)), ("content_gru", 5, 37, 9, (64, 40, 33, 0, 0)),
]


def _fwd_on_every_plan(monkeypatch, fwd, fwd_plain, kernel, args, dims):
    """The GRU forward `fwd` (K12 or K4) under each plan that fits the card,
    forced in place of fwd_plan_on's, then on the wrapper's own, on `args`
    with the last row's every position masked: against the plain version
    (1e-4 abs), one launch a call, two calls with the same bits, and alpha
    and c exactly 0 on that row."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    vh, h, mask, yin, weights = args
    mask = mask.clone()
    mask[-1] = 0
    want = fwd_plain(vh, h, mask, yin, *weights)
    smem_limit, resident = attention_scan.scan_limits(kernel, vh.device)
    runs = [attention_scan.FwdPlan(c, r, held)
            for c in attention_scan.WALK_CLUSTERS for r in attention_scan.WALK_ROWS
            for held in (False, True)
            if resident[c] >= 1 and attention_scan.fwd_smem_bytes(
                r, c, *dims, held, "gru") <= smem_limit]
    assert len(runs) >= 4, runs
    default = attention_scan.fwd_plan_on
    for run in runs + [None]:
        monkeypatch.setattr(attention_scan, "fwd_plan_on",
                            default if run is None else lambda *_, run=run: run)
        before = kernel.launches
        got, again = fwd(vh, h, mask, yin, *weights), fwd(vh, h, mask, yin, *weights)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2, run
        assert _max_err(got, want) <= TOL, (run, _max_err(got, want))
        for x, y in zip(got, again):
            assert torch.equal(x, y), run
        assert not got[1][-1].any() and not got[2][-1].any(), run
    monkeypatch.setattr(attention_scan, "fwd_plan_on", default)


@pytest.mark.parametrize("case", range(len(DECODER_SCAN_CASES)))
def test_decoder_scan_kernels(card, monkeypatch, case):
    """K12, K4 or K14 against its plain version (1e-4 abs), K12 and K4
    also under every plan (_fwd_on_every_plan); then K13, K5 or K15 with
    cotangents on every output, and with none on alpha (and mem; zeros for
    K5, whose wrapper takes every one), against its plain version, on
    their plan (K15's the one LSTM_PLANS gives, or a case's forced one),
    each backward twice with the same bits; and each backward once more on
    the sequences its forward saved."""
    cell, b, l, t, (s, a, st, fm, f), *run = DECODER_SCAN_CASES[case]
    fwd, bwd, fwd_plain, bwd_plain, k_fwd, k_bwd = _decoder_scans(cell)
    gen = torch.Generator().manual_seed(b * 31 + l)
    kind = "lstm" if cell == "lstm" else "gru"
    vh, h, mask, yin, weights = _decoder_case(card, gen, b, l, t, s, a, st, kind, fm, f)
    if cell != "lstm":
        _fwd_on_every_plan(monkeypatch, fwd, fwd_plain, k_fwd, (vh, h, mask, yin, weights),
                           (l, s, a, st, fm, f))
    n_fwd, n_bwd = k_fwd.launches, k_bwd.launches
    got = fwd(vh, h, mask, yin, *weights)
    want = fwd_plain(vh, h, mask, yin, *weights)
    torch.cuda.synchronize()
    assert k_fwd.launches == n_fwd + 1
    assert len(got) == len(want) == (4 if cell == "lstm" else 3)
    assert _max_err(got, want) <= TOL
    widths = (st, a, l, st)[:len(want)]
    plan = "plan"
    if cell == "lstm" or run:
        plan = _walk_plan(card, monkeypatch, k_bwd, b, l, s, a, st, fm, f,
                          run[0] if run else "plan")
    for partial in (False, True):
        cot = [_rand(gen, b, t, n) for n in widths]
        if partial:
            none = torch.zeros_like if cell == "content_gru" else lambda x: None
            cot[2:] = [none(x) for x in cot[2:]]
        args = (vh, h, mask, yin, *weights, *want, *cot)
        got_b = _bwd_twice(bwd, args, plan, cell)
        want_b = bwd_plain(*args)
        torch.cuda.synchronize()
        _bwd_close(got_b, want_b, f"{cell} scan bwd")
    args = (vh, h, mask, yin, *weights, *got, *cot)
    _bwd_close(bwd(*args), bwd_plain(*args), f"{cell} scan bwd on its forward's sequences")
    assert k_bwd.launches == n_bwd + 5


@pytest.mark.parametrize("kind", ["loc", "loc_lstm", "lstm"])
def test_loc_scan_backwards_are_bitwise_deterministic(card, kind):
    """K13 at flagship_loc's training shape and K11 and K15 at the
    conv+BiLSTM recipe's, twice on the same inputs: every gradient bitwise
    equal (the location term's sums and the walk's sums over a cluster's
    blocks are taken in a fixed order, no atomics)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as a

    gen = torch.Generator().manual_seed(7)
    if kind == "loc":
        vh, h, mask, yin, weights = _decoder_case(card, gen, 16, 144, 56, 512, 512, 256, "gru",
                                                  16, 10)
        fwd, bwd = a.attention_decode_scan_loc, a.attention_decode_scan_loc_bwd
    elif kind == "loc_lstm":
        vh, h, mask, yin, weights = _loc_lstm_case(card, gen, 16, 16, 56, 150, 256, 400, 16, 5)
        fwd, bwd = a.attention_decode_scan_loc_lstm, a.attention_decode_scan_loc_lstm_bwd
    else:
        vh, h, mask, yin, weights = _decoder_case(card, gen, 16, 16, 56, 150, 256, 400, "lstm")
        fwd, bwd = a.attention_decode_scan_lstm, a.attention_decode_scan_lstm_bwd
    saved = fwd(vh, h, mask, yin, *weights)
    cot = [_rand(gen, *t.shape) for t in saved]
    args = (vh, h, mask, yin, *weights, *saved, *cot)
    first, second = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(first, second)):
        assert torch.equal(x, y), (kind, i)


def test_decoder_scans_refuse_what_does_not_fit(card):
    """The backward walks keep ceil(L / C) positions a block (232,448
    bytes of shared memory on an H100): at one batch row (C = 16, R = 1)
    and the conv+BiLSTM recipe's widths, K11 fits L' <= 18640 and K15 L'
    <= 137856, and at the flagship's widths K5 L <= 120448 and K13 (16
    maps, filter 10) L <= 11312 (walk_smem_bytes;
    tests/test_torch_scan_plan.py pins them); so do the forwards: K10 and
    K14 fit L' <= 136960 and 243008, K12 and K4 at the flagship's widths L
    <= 72304 and 166656 (fwd_smem_bytes; tests/test_torch_fwd_plan.py).
    The largest L runs, one more is refused by the plan, before a launch,
    and not counted."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    flagship, conv_bilstm = (512, 512, 256), (150, 256, 400)
    for cell, dims, fm, f, kernel, l_max in (("gru", flagship, 16, 10, "bwd", 11312),
                                            ("gru", flagship, 16, 10, "fwd", 72304),
                                            ("content_gru", flagship, 0, 0, "fwd", 166656),
                                            ("lstm", conv_bilstm, 0, 0, "bwd", 137856),
                                            ("loc_lstm", conv_bilstm, 16, 5, "bwd", 18640),
                                            ("lstm", conv_bilstm, 0, 0, "fwd", 243008),
                                            ("loc_lstm", conv_bilstm, 16, 5, "fwd", 136960),
                                            ("content_gru", flagship, 0, 0, "bwd", 120448)):
        if cell == "loc_lstm":
            fwd, bwd = (attention_scan.attention_decode_scan_loc_lstm,
                        attention_scan.attention_decode_scan_loc_lstm_bwd)
            fwd_plain, k = (attention_scan.attention_decode_scan_loc_lstm_plain,
                            attention_scan.KERNEL_LOC_LSTM_BWD if kernel == "bwd"
                            else attention_scan.KERNEL_LOC_LSTM_FWD)
        elif cell == "content_gru":
            fwd, bwd = (attention_scan.attention_decode_scan,
                        attention_scan.attention_decode_scan_bwd)
            fwd_plain, k = (attention_scan.attention_decode_scan_plain,
                            attention_scan.KERNEL_BWD if kernel == "bwd"
                            else attention_scan.KERNEL_FWD)
        else:
            fwd, bwd, fwd_plain, _, k_fwd, k_bwd = _decoder_scans(cell)
            k = k_bwd if kernel == "bwd" else k_fwd
        for l in (l_max, l_max + 1):
            gen = torch.Generator().manual_seed(l)
            if cell == "loc_lstm":
                vh, h, mask, yin, weights = _loc_lstm_case(card, gen, 1, l, 1, *dims, fm, f)
            else:
                kind = "gru" if cell == "content_gru" else cell
                vh, h, mask, yin, weights = _decoder_case(card, gen, 1, l, 1, *dims, kind, fm, f)
            before = k.launches
            if kernel == "fwd":
                call = lambda: fwd(vh, h, mask, yin, *weights)
            else:
                saved = fwd_plain(vh, h, mask, yin, *weights)
                # K5's wrapper takes every cotangent (its autograd function
                # materialises them): zeros where the others take None.
                none = torch.zeros_like if cell == "content_gru" else lambda x: None
                cot = [torch.ones_like(saved[0])] + [none(x) for x in saved[1:]]
                call = lambda: bwd(vh, h, mask, yin, *weights, *saved, *cot)
            if l == l_max:
                call()
                torch.cuda.synchronize()
                assert k.launches == before + 1, (cell, kernel, l)
            else:
                with pytest.raises(RuntimeError):
                    call()
                assert k.launches == before, (cell, kernel, l)


# name: (recipe, small widths with the changed option, frames of the
# batch, the kernels that each card step launches once per count).
LOC_DECODER_RECIPES = {
    "flagship_loc": ("timit_chorowski_normnll_colnorm",
                     dict(input_frame_size=10, hidden_frame_size=32, output_frame_size=32,
                          score_depth=32, state_depth=32, mlp_depth=16, output_depth=9,
                          feature_maps=4), 24),
    "conv_bilstm_content": ("timit_conv_bilstm",
                            dict(input_frame_size=10, hidden_frame_size=32, output_frame_size=16,
                                 score_depth=24, feature_maps=0, state_depth=32, output_depth=9),
                            80),
}


@pytest.mark.parametrize("name", sorted(LOC_DECODER_RECIPES))
def test_loc_decoder_train_step_on_the_card_matches_the_cpu(card, name):
    """Two steps of the flagship recipe with location-aware attention (K1
    and K6 three times, K12 and K13 once a step) and of the conv+BiLSTM
    recipe without the location term (K7, K9, K14 and K15 once a step), at
    small widths, and no other kernel; metrics within 1e-4 relative of
    the CPU run."""
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step,
                                                          gru_scan, logmel, lstm_scan)
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    recipe, small, frames = LOC_DECODER_RECIPES[name]
    exp = getattr(experiment, recipe)()
    exp.model_kwargs.update(small)
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    lens = torch.tensor([frames, frames * 3 // 4, frames // 2, frames * 5 // 8])
    batch = (torch.from_numpy(rng.randn(4, frames, 10).astype(np.float32)), lens,
             torch.from_numpy(rng.randint(0, 9, (4, 6))),
             (torch.arange(6)[None] < torch.tensor([6, 3, 5, 1])[:, None]).float())
    kernels = {k.name: k for k in (
        gru_scan.KERNEL, gru_scan.KERNEL_BWD, lstm_scan.KERNEL, lstm_scan.KERNEL_BWD,
        attention_scan.KERNEL_FWD, attention_scan.KERNEL_BWD, attention_scan.KERNEL_LOC_LSTM_FWD,
        attention_scan.KERNEL_LOC_LSTM_BWD, attention_scan.KERNEL_LOC_FWD,
        attention_scan.KERNEL_LOC_BWD, attention_scan.KERNEL_LSTM_FWD,
        attention_scan.KERNEL_LSTM_BWD, attention_step.KERNEL, attention_step.KERNEL_LOC_LSTM,
        logmel.KERNEL)}
    expected = dict.fromkeys(kernels, 0)
    if name == "flagship_loc":
        expected.update(bigru_scan2=3, bigru_scan2_bwd=3, attention_decode_scan_loc_fwd=1,
                        attention_decode_scan_loc_bwd=1)
    else:
        expected.update(bilstm_scan=1, bilstm_scan_bwd=1, attention_decode_scan_lstm_fwd=1,
                        attention_decode_scan_lstm_bwd=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        tx = optim.build_optimizer(exp.optim)
        init_fn, step_fn = trainer.make_train_step(model.forward, tx, exp.optim, exp.train,
                                                   model.output_depth)
        state = init_fn(interop.to_torch(params, dev), torch.Generator().manual_seed(1))
        runs[dev] = []
        for _ in range(2):
            before = {n: k.launches for n, k in kernels.items()}
            state, m = step_fn(state, tuple(x.to(dev) for x in batch))
            torch.cuda.synchronize()
            launched = {n: k.launches - before[n] for n, k in kernels.items()}
            assert launched == (expected if dev == "cuda" else dict.fromkeys(kernels, 0))
            runs[dev].append({k: float(v) for k, v in m.items()})
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for key in ("loss", "nll", "grad_norm", "param_norm"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got, want)


@pytest.mark.parametrize("b,l,h,regime", [
    (1, 132, 256, "resident"), (5, 37, 256, "resident"), (16, 144, 256, "resident"),
    (3, 20, 100, "resident"), (33, 20, 256, "partial"), (128, 16, 256, "groups"),
    (3, 9, 1024, "streamed"), (1, 7, 16, "resident"), (5, 9, 300, "resident"),
    (2, 9, 400, "streamed")])
def test_gru_scan_kernels(card, b, l, h, regime):
    """K16-K19 from nonzero initial states against their plain versions:
    forward within TOL, backward (dxproj, dh0, dWzr, dWh) within the
    backward tolerance, one launch each, and a second forward call bitwise
    equal. B = 1 takes one row a cluster, H = 16 two units a block, H =
    100 and 300 unequal slices; both walks, forward and backward, run in
    each regime (checked for K16, K18, K17 and K19 alike)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    _check_regime(gru_scan.KERNEL_GRU, b, h, "gru_fwd", 1, regime, card)
    _check_regime(gru_scan.KERNEL_BI, b, h, "gru_fwd", 2, regime, card)
    _check_regime(gru_scan.KERNEL_GRU_BWD, b, h, "gru", 1, regime, card)
    _check_regime(gru_scan.KERNEL_BI_BWD, b, h, "gru", 2, regime, card)

    gen = torch.Generator().manual_seed(b * 37 + l)
    xproj2 = _rand(gen, 2, b, l, 3 * h)
    h02 = _rand(gen, 2, b, h, scale=0.5)
    wzr2 = _rand(gen, 2, h, 2 * h, scale=h ** -0.5)
    wh2 = _rand(gen, 2, h, h, scale=h ** -0.5)
    dys2 = _rand(gen, 2, b, l, h)
    kernels = (gru_scan.KERNEL_GRU, gru_scan.KERNEL_GRU_BWD, gru_scan.KERNEL_BI,
               gru_scan.KERNEL_BI_BWD)
    before = [k.launches for k in kernels]
    ys2 = gru_scan.bigru_scan_plain(xproj2, h02, wzr2, wh2)
    h_prevs2 = torch.cat([h02[:, :, None], ys2[:, :, :-1]], dim=2)
    one = lambda *ts: [t[0] for t in ts]
    got1 = gru_scan.gru_scan(*one(xproj2, h02, wzr2, wh2))
    got2 = gru_scan.bigru_scan(xproj2, h02, wzr2, wh2)
    assert _max_err([got1], [ys2[0]]) <= TOL
    assert _max_err([got2], [ys2]) <= TOL
    assert torch.equal(gru_scan.gru_scan(*one(xproj2, h02, wzr2, wh2)), got1)
    assert torch.equal(gru_scan.bigru_scan(xproj2, h02, wzr2, wh2), got2)
    bwd = one(xproj2, h_prevs2, dys2, wzr2, wh2)
    _bwd_close(gru_scan.gru_scan_bwd(*bwd), gru_scan.gru_scan_bwd_plain(*bwd), "gru_scan_bwd")
    args = (xproj2, h_prevs2, dys2, wzr2, wh2)
    _bwd_close(gru_scan.bigru_scan_bwd(*args), gru_scan.bigru_scan_bwd_plain(*args),
               "bigru_scan_bwd")
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [2, 1, 2, 1]


@pytest.mark.parametrize("path", ["per_direction", "stacked"])
def test_encoder_paths_on_the_card_match_bigru_layer(card, path):
    """Three BiGRU layers at the flagship encoder's widths (123 -> 256 and
    512 -> 256 per direction), B = 5, L = 37 with ragged lengths, built
    as chip_smoke.py builds them: one gru_layer per direction (K16 and
    K17 6x each) or the stacked scan (K18 and K19 3x each), and neither
    K1 nor K6; output equal to bigru_layer's (K1, K6) at valid positions
    within TOL and 0 at masked ones, gradients of sum(out * cot) within
    the backward tolerance."""
    import chip_smoke
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops import rnn
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    gen = torch.Generator().manual_seed(11)
    enc = {n: interop.to_torch(rnn.bigru_init(gen, i, 256), card)
           for n, i in zip(chip_smoke.ENC_LAYERS, (123, 512, 512))}
    x, cot = _rand(gen, 5, 37, 123), _rand(gen, 5, 37, 512)
    lens = torch.tensor([37, 20, 31, 5, 37], device=card)
    kernels = (gru_scan.KERNEL, gru_scan.KERNEL_BWD, gru_scan.KERNEL_GRU, gru_scan.KERNEL_GRU_BWD,
               gru_scan.KERNEL_BI, gru_scan.KERNEL_BI_BWD)
    before = [k.launches for k in kernels]
    out, grads = chip_smoke.encoder_call(path, enc, x, lens, cot)()
    torch.cuda.synchronize()
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert launched == ([0, 0, 6, 6, 0, 0] if path == "per_direction" else [0, 0, 0, 0, 3, 3])
    want, want_grads = chip_smoke.encoder_call("bigru_layer", enc, x, lens, cot)()
    valid = (torch.arange(37, device=card)[None] < lens[:, None])[:, :, None].expand_as(out)
    assert float((out - want)[valid].abs().max()) <= TOL
    assert not out[~valid].any()
    _bwd_close(grads, want_grads, path)


# The bf16 entries of K1, K4 and K2 (a compute_dtype="bfloat16" model's
# evaluation): each held to its exact plain twin element by element within
# chip_smoke.BF16_ULPS bf16 ulps (at max(|twin|, 1)), and by the
# ground-truth rule to the plain bf16 version at the JAX kernel's rounding
# points: each output's relative L2 distance from the float32 plain
# version on the upcast inputs at most 2 x the plain version's + 0.02
# (K4's twin folds c_in and dec_in into the gates as its entry does, so it
# does not round cc or r; K1's and K2's twin is the plain version); bf16
# out (K2's logp float32), one launch a call, a second call bitwise equal.
def _to_bf16(tree):
    from seq2seq_attention_asr_tpu_torch import tree as tree_lib

    return tree_lib.tree_map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
                             tree)


def _upcast(tree):
    from seq2seq_attention_asr_tpu_torch import tree as tree_lib

    return tree_lib.tree_map(lambda t: t.float() if isinstance(t, torch.Tensor) and
                             t.dtype == torch.bfloat16 else t, tree)


def _bf16_close(name, got, twin, plain, truth):
    import chip_smoke

    rel = lambda g, t: float((g.float() - t.float()).norm()) / max(float(t.float().norm()), 1e-6)
    for i, (g, w, p, t) in enumerate(zip(got, twin, plain, truth)):
        assert g.dtype == w.dtype and bool(torch.isfinite(g.float()).all()), i
        ulps, _ = chip_smoke.bf16_ulps(g, w)
        assert ulps <= chip_smoke.BF16_ULPS[name], (i, ulps)
        assert rel(g, t) <= 2.0 * rel(p, t) + 0.02, (i, rel(g, t), rel(p, t))


def _bf16_twice(kernel, call, args):
    """call(*args) twice: one launch each, the same bits; the first result."""
    before = kernel.launches
    got = call(*args)
    again = call(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return got


# K1: one row at an odd length, the flagship's batch, a part-empty last
# row group, fewer units than blocks, and slices streamed from L2 (the
# bf16 weights read by columns there).
@pytest.mark.parametrize("b,l,h", [(1, 131, 256), (16, 144, 256), (33, 20, 256), (2, 6, 5),
                                   (3, 9, 400), (4, 11, 1024)])
def test_bigru_scan2_bf16_entry(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    gen = torch.Generator().manual_seed(b * 1000 + h)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    valid = (torch.arange(l, device=card)[None] < lens[:, None]).float()[:, :, None]
    args = _to_bf16([_rand(gen, b, l, 3 * h) * valid, _rand(gen, b, l, 3 * h) * valid,
                     _rand(gen, 2, h, 2 * h, scale=h ** -0.5), _rand(gen, 2, h, h, scale=h ** -0.5)])
    got = _bf16_twice(gru_scan.KERNEL_BF16, gru_scan.bigru_scan2, args)
    plain = gru_scan.bigru_scan2_plain(*args)
    _bf16_close("bigru_scan2_bf16", got, plain, plain, gru_scan.bigru_scan2_plain(*_upcast(args)))
    assert not (got[1].float() * (1 - valid)).any()  # the backward direction holds 0 on padding


# K4: small widths (St = 8), St and S not multiples of 4 (the exchanges
# store a value at a time), and the flagship's training shape.
@pytest.mark.parametrize("b,l,t,dims", [(3, 13, 5, (16, 24, 8)), (4, 37, 9, (17, 12, 9)),
                                        (16, 144, 56, (512, 512, 256))])
def test_attention_decode_scan_bf16_entry(card, b, l, t, dims):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    gen = torch.Generator().manual_seed(b * 13 + l)
    vh, h, mask, yin, weights = _scan_case(card, gen, b, l, t, *dims)
    args = _to_bf16([vh, h, mask, yin, *weights])
    got = _bf16_twice(attention_scan.KERNEL_FWD_BF16, attention_scan.attention_decode_scan, args)
    _bf16_close("attention_decode_scan_fwd_bf16", got, attention_scan.gru_folded_scan_plain(*args),
                attention_scan.attention_decode_scan_plain(*args),
                attention_scan.attention_decode_scan_plain(*_upcast(args)))


# K2: K = 1 at small widths, L not a multiple of C, a row with every
# position masked (alpha and c exactly 0), and L = 1500 at K = 8.
@pytest.mark.parametrize("b,k,l,dims,dead", [
    (1, 1, 8, (16, 16, 24, 6, 8, 3), None),
    (3, 5, 37, (16, 12, 20, 7, 4, 2), None),
    (8, 8, 132, FLAGSHIP_STEP, 7),
    (1, 8, 1500, FLAGSHIP_STEP, None),
])
def test_fused_attention_step_bf16_entry(card, b, k, l, dims, dead):
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    params, cfg, (state, y, _, h, mask) = _k2_case(card, b, k, l, dims, dead)
    params, state, y, h, mask = _to_bf16([params, list(state), y, h, mask])
    args = (params, cfg, state, y, attention.precompute_vh(params, h).contiguous(), h, mask)
    step = lambda *a: _outputs(attention_step.fused_attention_step(*a))
    got = _bf16_twice(attention_step.KERNEL_BF16, step, args)
    plain = _outputs(attention_step.fused_attention_step_plain(*args))
    _bf16_close("fused_attention_step_bf16", got, plain, plain,
                _outputs(attention_step.fused_attention_step_plain(*_upcast(args))))
    assert got[3].dtype == torch.float32
    if dead is not None:
        assert not got[0][dead].float().any() and not got[1][dead].float().any()


def _outputs(res):
    _, out = res
    return out["alpha"], out["c"], out["s"], out["logp"]


# The bf16 entries of K7, K10, K12, K14 and K8 (the bf16 evaluation of
# conv_bilstm, flagship_loc, vgg and conv_bilstm_content), held as K1's,
# K4's and K2's are above. K7's outputs are float32 (the JAX kernel's
# are) and it rounds nothing: its twin is the plain version on the
# widened inputs. K10's, K12's and K14's twin folds c_in and dec_in into
# the gates as their entries do (folded_scan_plain); K8 forms every
# operand, so its twin is its plain bf16 version.
@pytest.mark.parametrize("b,l,h", [(1, 14, 128), (16, 16, 128), (33, 9, 128), (3, 7, 5),
                                   (3, 9, 337)])
def test_bilstm_scan_bf16_entry(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan

    xproj2, h02, c02, wh2 = _lstm_fwd_case(b, l, h, b * 31 + h)
    args = (xproj2.to(torch.bfloat16), h02, c02, wh2.to(torch.bfloat16))
    got = _bf16_twice(lstm_scan.KERNEL_BF16, lstm_scan.bilstm_scan, args)
    plain = lstm_scan.bilstm_scan_plain(*args)
    assert got[0].dtype == got[1].dtype == torch.float32
    _bf16_close("bilstm_scan_bf16", got, plain, plain, plain)


# (cell, B, L, T, (S, A, St, FM, F)): the conv+BiLSTM recipe's decoder at
# its training shape, B = 1 and small odd widths with an even filter;
# flagship_loc's at its training shape and at small odd widths; then
# conv_bilstm_content's (the LSTM without the location term, K14) at the
# recipe's training shape, B = 1, L' < C at small odd widths and a
# part-filled last row group.
LOC_BF16_CASES = [("lstm", 16, 16, 56, (150, 256, 400, 16, 5)),
                  ("lstm", 1, 16, 56, (150, 256, 400, 16, 5)),
                  ("lstm", 3, 13, 5, (17, 12, 9, 3, 4)),
                  ("gru", 16, 144, 56, (512, 512, 256, 16, 10)),
                  ("gru", 3, 13, 5, (17, 12, 9, 3, 4)), ("gru", 5, 40, 9, (40, 24, 33, 4, 5)),
                  ("lstm", 16, 16, 56, (150, 256, 400, 0, 0)),
                  ("lstm", 1, 16, 56, (150, 256, 400, 0, 0)),
                  ("lstm", 3, 13, 5, (17, 12, 9, 0, 0)), ("lstm", 5, 37, 9, (64, 40, 33, 0, 0))]
# Each decoder's bf16 entry: (name, Kernel attribute, wrapper), by (cell,
# location term).
SCAN_BF16 = {("lstm", True): ("attention_decode_scan_loc_lstm_fwd_bf16",
                              "KERNEL_LOC_LSTM_FWD_BF16", "attention_decode_scan_loc_lstm"),
             ("gru", True): ("attention_decode_scan_loc_fwd_bf16", "KERNEL_LOC_FWD_BF16",
                             "attention_decode_scan_loc"),
             ("lstm", False): ("attention_decode_scan_lstm_fwd_bf16", "KERNEL_LSTM_FWD_BF16",
                               "attention_decode_scan_lstm")}


@pytest.mark.parametrize("case", range(len(LOC_BF16_CASES)))
def test_loc_decoder_scan_bf16_entries(card, case):
    """The bf16 entries of K10, K12 and K14 (LOC_BF16_CASES)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    cell, b, l, t, (s, a, st, fm, f) = LOC_BF16_CASES[case]
    lstm = cell == "lstm"
    gen = torch.Generator().manual_seed(b * 17 + l)
    vh, h, mask, yin, weights = _decoder_case(card, gen, b, l, t, s, a, st, cell, fm, f)
    args = _to_bf16([vh, h, mask, yin, *weights])
    name, kernel, fwd = SCAN_BF16[(cell, fm > 0)]
    kernel, fwd = getattr(attention_scan, kernel), getattr(attention_scan, fwd)
    got = _bf16_twice(kernel, fwd, args)
    plain = lambda *x: attention_scan._scan_plain(*x[:4], tuple(x[4:]), lstm)
    _bf16_close(name, got, attention_scan.folded_scan_plain(*args[:4], tuple(args[4:]), lstm),
                plain(*args), plain(*_upcast(args)))


# K8's four bf16 instances (LOC_LSTM_CASES 0, 1, 5 and 2: <LSTM,
# location>, <GRU, location>, <GRU, content> with VGG's readout, <LSTM,
# content>) at the serving shapes, K = 8 at L = 37, a row with every
# position masked, and B = 32 at L = 144, K = 5 (an evaluation batch).
@pytest.mark.parametrize("case", [0, 1, 5, 2])
@pytest.mark.parametrize("b,k,l,dead", [(1, 5, 14, None), (8, 5, 14, None), (3, 8, 37, 1),
                                        (32, 5, 144, None)])
def test_fused_attention_step_loc_lstm_bf16_entry(card, case, b, k, l, dead):
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    params, cfg, (state, y, _, h, mask) = _k8_case(card, case, b, k, l, dead)
    params, state, y, h, mask = _to_bf16([params, list(state), y, h, mask])
    args = (params, cfg, state, y, attention.precompute_vh(params, h).contiguous(), h, mask)
    step = lambda *a: _k8_bf16_outputs(attention_step.fused_attention_step(*a))
    got = _bf16_twice(attention_step.KERNEL_LOC_LSTM_BF16, step, args)
    plain = _k8_bf16_outputs(attention_step.fused_attention_step_plain(*args))
    _bf16_close("fused_attention_step_loc_lstm_bf16", got, plain, plain,
                _k8_bf16_outputs(attention_step.fused_attention_step_plain(*_upcast(args))))
    assert got[3].dtype == torch.float32 and got[4].dtype == torch.bfloat16
    if dead is not None:
        assert not got[0][dead].float().any() and not got[1][dead].float().any()


def _k8_bf16_outputs(res):
    """alpha, c, s, logp and the new mem (the LSTM's cell state, the GRU's
    mem passed through)."""
    (_, _, mem), out = res
    return out["alpha"], out["c"], out["s"], out["logp"], mem


def test_vgg_float32_forward_is_full_float32_under_default_flags(card):
    """A float32 VGG forward under PyTorch's default
    torch.backends.cudnn.allow_tf32 (True) is bitwise the one with it off
    (ops/conv.py keeps float32 convolutions out of TF32), its gradients
    within 1e-5 relative L2 of them (cuDNN's weight-gradient algorithms
    may sum in another order from call to call; TF32 would put them
    ~1e-3 apart), and the flag is as the caller set it after each."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.models import registry

    model = registry.build("vgg", output_depth=30)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator().manual_seed(1)
    b, l, t = 4, 120, 12
    x = _rand(gen, b, l, 40, 3)
    x_len = torch.tensor([120, 100, 80, 64], device=card)
    oh = torch.nn.functional.one_hot(torch.randint(0, 30, (b, t), generator=gen), 30).float().cuda()
    dm = torch.ones(b, t, device=card)
    leaves = tree.leaves(params)
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    runs = {}
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = flag
            with torch.enable_grad():
                p = tree.tree_map(lambda a: a.detach().requires_grad_(), params)
                out = model.forward(p, x, x_len, oh, dm)
                grads = torch.autograd.grad(out["logprobs"].sum(), tree.leaves(p))
            torch.cuda.synchronize()
            assert cudnn.allow_tf32 == flag
            runs[flag] = [out["logprobs"].detach(), *grads]
    finally:
        cudnn.allow_tf32 = before
    assert len(runs[True]) == len(leaves) + 1
    assert torch.equal(runs[True][0], runs[False][0])
    for i, (got, want) in enumerate(zip(runs[True][1:], runs[False][1:])):
        assert float((got - want).norm()) <= 1e-5 * float(want.norm()), i


def test_bf16_evaluation_sums_in_float32_under_either_flag(card):
    """The committed checkpoint as a bf16 model through Trainer.evaluate on
    the first held-out batch: the same PER, NLL and accuracy under
    PyTorch's default allow_bf16_reduced_precision_reduction (True) as
    with it off (the model's bf16 products sum in float32 either way), and
    the flag as the caller left it afterwards."""
    import chip_smoke
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.train import checkpoint, experiment, optim, trainer

    _, valid, batcher, vocab = chip_smoke.held_out_split("cuda")
    first = next(iter(batcher.batches(valid, shuffle=False)))

    class First:
        def batches(self, ds, **kw):
            return iter([first])

    kw = dict(experiment.timit_chorowski_normnll_colnorm().model_kwargs, dropout=0.5)
    tcfg = trainer.TrainConfig(batch_size=32, normalize_nll=True, beam_k=5, seed=1)
    tr = trainer.Trainer(registry.build("chorowski", compute_dtype="bfloat16", **kw),
                         optim.OptimConfig(), tcfg, vocab=vocab, device="cuda")
    tr.init(checkpoint.load_params_npz(str(chip_smoke.HELD_OUT_NPZ), "cuda"))
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    rows = {}
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            rows[flag] = tr.evaluate(valid, First())
            assert matmul.allow_bf16_reduced_precision_reduction == flag
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    for key in ("valid_per", "valid_nll", "valid_accuracy"):
        assert rows[True][key] == rows[False][key], key
    assert rows[True]["valid_per"] < 0.25


# K6's bf16 entry: one row at an odd length, the flagship's batch, a
# part-empty last row group, fewer units than blocks, and slices streamed
# from L2 (the bf16 weights read by rows there). Its twin is its plain
# bf16 version, which rounds where the entry rounds.
@pytest.mark.parametrize("b,l,h", [(1, 131, 256), (16, 144, 256), (33, 20, 256), (2, 6, 5),
                                   (3, 9, 400), (4, 11, 1024)])
def test_bigru_scan2_bwd_bf16_entry(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

    gen = torch.Generator().manual_seed(b * 1000 + h + 7)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    valid = (torch.arange(l, device=card)[None] < lens[:, None]).float()[:, :, None]
    ins = _to_bf16([_rand(gen, b, l, 3 * h) * valid, _rand(gen, b, l, 3 * h) * valid,
                    _rand(gen, 2, h, 2 * h, scale=h ** -0.5), _rand(gen, 2, h, h, scale=h ** -0.5)])
    ys = gru_scan.bigru_scan2(*ins)
    dys = _to_bf16([_rand(gen, b, l, h, scale=0.1) * valid for _ in range(2)])
    args = [*ins, *ys, *dys]
    got = _bf16_twice(gru_scan.KERNEL_BWD_BF16, gru_scan.bigru_scan2_bwd, args)
    plain = gru_scan.bigru_scan2_bwd_plain(*args)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _bf16_close("bigru_scan2_bwd_bf16", got, plain, plain,
                gru_scan.bigru_scan2_bwd_plain(*_upcast(args)))


def _k5_bf16_args(card, gen, b, l, t, dims):
    """K5's bf16 entry's arguments: bf16 scan inputs, K4's bf16 outputs
    with its float32 alpha and c (c32 last), random bf16 cotangents."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    s, a, st = dims
    vh, h, mask, yin, weights = _scan_case(card, gen, b, l, t, s, a, st)
    ins = _to_bf16([vh, h, mask, yin, *weights])
    (s_seq, c_seq, _), (alpha32, c32) = attention_scan.attention_decode_scan_train(*ins)
    cots = _to_bf16([_rand(gen, b, t, n, scale=0.1) for n in (st, a, l)])
    return [*ins, s_seq, c_seq, alpha32, *cots, c32]


# K5's bf16 entry: small widths, St and S not multiples of 4 (the
# exchanges store a value at a time), and the flagship's training shape;
# its twin forms the softmax's sum as the entry does, from the float32 c.
@pytest.mark.parametrize("b,l,t,dims", [(3, 13, 5, (16, 24, 8)), (4, 37, 9, (17, 12, 9)),
                                        (16, 144, 56, (512, 512, 256))])
def test_attention_decode_scan_bwd_bf16_entry(card, b, l, t, dims):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    args = _k5_bf16_args(card, torch.Generator().manual_seed(b * 13 + l + 5), b, l, t, dims)
    got = _bf16_twice(attention_scan.KERNEL_BWD_BF16,
                      lambda *a: attention_scan.attention_decode_scan_bwd(*a[:-1], c32=a[-1]),
                      args)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _bf16_close("attention_decode_scan_bwd_bf16", got,
                attention_scan.attention_decode_scan_bwd_twin_bf16(*args),
                attention_scan.attention_decode_scan_bwd_plain_bf16(*args[:-1]),
                attention_scan.attention_decode_scan_bwd_plain(*_upcast(args[:-1])))
    with pytest.raises(ValueError, match="float32 alpha"):
        attention_scan.attention_decode_scan_bwd(*args[:-1])  # no c32: refused, no fallback


def test_bf16_train_step_sums_in_float32_under_either_flag(card):
    """A bf16 flagship train step at small widths on the card: the bf16
    entries of K1, K6, K4 and K5 only (3, 3, 1, 1 launches), the same
    metrics and gradients bit for bit under either value of
    allow_bf16_reduced_precision_reduction, and the caller's flag
    restored; the float32 masters get float32 gradients."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, attention_step, gru_scan
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    exp = experiment.timit_chorowski_normnll_colnorm()
    exp.model_kwargs.update(hidden_frame_size=32, output_frame_size=32, score_depth=48,
                            state_depth=32, mlp_depth=16, compute_dtype="bfloat16")
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator().manual_seed(3)
    b, l, t = 8, 40, 12
    x = _rand(gen, b, l, 123)
    x_len = torch.tensor([40, 31, 40, 17, 25, 40, 9, 33], device=card)
    y = torch.randint(0, 62, (b, t), generator=gen).cuda()
    dec_mask = (torch.arange(t)[None] < torch.tensor([12, 7, 12, 3, 9, 12, 2, 11])[:, None])
    batch = (x, x_len, y, dec_mask.float().cuda())
    tx = optim.Transform(lambda p: tree.tree_map(torch.zeros_like, p),
                         lambda g, s, p=None: (tree.tree_map(torch.zeros_like, g), g))
    step = trainer.make_step_core(model.forward, tx, exp.optim, exp.train, model.output_depth)
    kernels = (gru_scan.KERNEL_BF16, gru_scan.KERNEL_BWD_BF16, attention_scan.KERNEL_FWD_BF16,
               attention_scan.KERNEL_BWD_BF16, gru_scan.KERNEL, gru_scan.KERNEL_BWD,
               attention_scan.KERNEL_FWD, attention_scan.KERNEL_BWD, attention_step.KERNEL_BF16)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    runs = {}
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            counts = [k.launches for k in kernels]
            state, m = step((params, tx.init(params), torch.Generator(device="cuda")), batch)
            torch.cuda.synchronize()
            assert [k.launches - c for k, c in zip(kernels, counts)] == [3, 3, 1, 1, 0, 0, 0, 0, 0]
            assert matmul.allow_bf16_reduced_precision_reduction is flag
            runs[flag] = (float(m["loss"]), tree.leaves(state[1]))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert runs[True][0] == runs[False][0]
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in runs[True][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


def _f32_backward_digests(device="cuda"):
    """sha1 of the float32 outputs of K6, K5, K17 and K9 (each with its
    reduce_atb.cuh reduction) on seeded inputs: the bf16 operand path must
    leave them bit for bit as they were (F32_BACKWARD_DIGESTS). Only the
    public wrappers are called, so the same function digests another
    checkout's kernels."""
    import hashlib

    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan, gru_scan, lstm_scan

    gen = torch.Generator().manual_seed(28)
    r = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(device)
    b, l, h = 5, 33, 256
    k6 = gru_scan.bigru_scan2_bwd(r(b, l, 3 * h), r(b, l, 3 * h), r(2, h, 2 * h, scale=h ** -0.5),
                                  r(2, h, h, scale=h ** -0.5), r(b, l, h, scale=0.5),
                                  r(b, l, h, scale=0.5), r(b, l, h), r(b, l, h))
    bb, ll, t, s, a, st = 4, 37, 9, 24, 32, 16
    u = lambda *shape: r(*shape, scale=shape[0] ** -0.5)
    k5 = attention_scan.attention_decode_scan_bwd(
        r(bb, ll, s), r(bb, ll, a, scale=0.5), torch.ones(bb, ll, device=device),
        r(bb, t, st, scale=0.5), u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0],
        u(2 * st, st), u(2 * st, st)[0], u(2 * st, 2 * st), u(2 * st, st),
        r(bb, t, st, scale=0.5), r(bb, t, a, scale=0.5),
        torch.softmax(r(bb, t, ll), dim=-1).contiguous(), r(bb, t, st, scale=0.1),
        r(bb, t, a, scale=0.1), r(bb, t, ll, scale=0.1))
    k17 = gru_scan.gru_scan_bwd(r(b, l, 3 * h), r(b, l, h, scale=0.5), r(b, l, h),
                                r(h, 2 * h, scale=h ** -0.5), r(h, h, scale=h ** -0.5))
    hh = 128
    k9 = lstm_scan.bilstm_scan_bwd(r(2, b, l, 4 * hh), r(2, b, l, hh, scale=0.5),
                                   r(2, b, l, hh, scale=0.5), r(2, b, l, hh),
                                   r(2, hh, 4 * hh, scale=hh ** -0.5))
    return {name: hashlib.sha1(b"".join(o.detach().cpu().numpy().tobytes() for o in outs))
            .hexdigest()[:16] for name, outs in (("K6", k6), ("K5", k5), ("K17", k17), ("K9", k9))}


# The digests of the commit before the bf16 operand path, on an NVIDIA
# H100 80GB HBM3 (the commit with it gave the same, and the same bits for
# K4-K6 and K9-K19 and K4's bf16 entry at chip_smoke.py's training shapes,
# B = 16 and 128).
F32_BACKWARD_DIGESTS = {"K6": "5f9b7f0048f1a90b", "K5": "bd63f6fab1c2cac9",
                        "K17": "f6d7f7c90e32486f", "K9": "7c18395daf24dbda"}


def test_float32_backwards_are_bit_for_bit_as_before(card):
    """K6's, K5's, K17's and K9's float32 results (their reductions
    included) are the bits the kernels gave before the bf16 operand path
    of reduce_atb.cuh and the bf16 instances of the walks existed."""
    assert _f32_backward_digests() == F32_BACKWARD_DIGESTS


# K9's bf16 entry: one row, the conv+BiLSTM recipe's batches (L' = 16),
# a part-empty last row group, fewer units than blocks, and slices
# streamed from L2. It rounds nothing: its twin and its plain bf16 version
# are bilstm_scan_bwd_plain on the widened inputs, and its outputs are
# float32, as the JAX kernel's.
@pytest.mark.parametrize("b,l,h", [(1, 16, 128), (16, 16, 128), (128, 16, 128), (33, 20, 128),
                                   (2, 6, 5), (4, 11, 1024)])
def test_bilstm_scan_bwd_bf16_entry(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import lstm_scan

    xproj2, h02, c02, wh2 = _lstm_fwd_case(b, l, h, b * 37 + h)
    x16, w16 = xproj2.to(torch.bfloat16), wh2.to(torch.bfloat16)
    hs, cs = lstm_scan.bilstm_scan(x16, h02, c02, w16)
    gen = torch.Generator().manual_seed(b + h)
    dys = _rand(gen, 2, b, l, h, scale=0.1).to(torch.bfloat16).float()
    args = (x16, torch.cat([h02[:, :, None], hs[:, :, :-1]], 2),
            torch.cat([c02[:, :, None], cs[:, :, :-1]], 2), dys, w16)
    got = _bf16_twice(lstm_scan.KERNEL_BWD_BF16, lstm_scan.bilstm_scan_bwd, args)
    plain = lstm_scan.bilstm_scan_bwd_plain(*args)
    assert all(g.dtype == torch.float32 for g in got)
    _bf16_close("bilstm_scan_bwd_bf16", got, plain, plain, plain)


# The bf16 backward entries of K11, K13 and K15, by (cell, location term).
SCAN_BWD_BF16 = {("lstm", True): ("attention_decode_scan_loc_lstm_bwd_bf16",
                                  "KERNEL_LOC_LSTM_BWD_BF16", "attention_decode_scan_loc_lstm"),
                 ("gru", True): ("attention_decode_scan_loc_bwd_bf16", "KERNEL_LOC_BWD_BF16",
                                 "attention_decode_scan_loc"),
                 ("lstm", False): ("attention_decode_scan_lstm_bwd_bf16", "KERNEL_LSTM_BWD_BF16",
                                   "attention_decode_scan_lstm")}


@pytest.mark.parametrize("case", range(len(LOC_BF16_CASES)))
def test_decoder_scan_bwd_bf16_entries(card, case):
    """The bf16 entries of K11, K13 and K15 at LOC_BF16_CASES' shapes, on
    their forwards' bf16 outputs with the float32 alpha and c (the
    forwards' f32 outputs) and random bf16 cotangents (the LSTM's mem too
    where B is odd): within BF16_ULPS of the exact twin, by the
    ground-truth rule against the plain bf16 version, bf16 out, one launch
    a call, a second call bitwise equal; without c32 the wrapper refuses
    (no fallback)."""
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan

    cell, b, l, t, (s, a, st, fm, f) = LOC_BF16_CASES[case]
    lstm = cell == "lstm"
    gen = torch.Generator().manual_seed(b * 19 + l + 3)
    vh, h, mask, yin, weights = _decoder_case(card, gen, b, l, t, s, a, st, cell, fm, f)
    ins = _to_bf16([vh, h, mask, yin, *weights])
    name, kernel, fwd = SCAN_BWD_BF16[(cell, fm > 0)]
    fwd_kernels = (getattr(attention_scan, SCAN_BF16[(cell, fm > 0)][1][:-len("_BF16")]),
                   getattr(attention_scan, SCAN_BF16[(cell, fm > 0)][1]))
    outs, (alpha32, c32) = attention_scan._scan(*fwd_kernels, lstm, *ins[:4], tuple(ins[4:]),
                                                f32=True)
    assert all(torch.equal(o, p) for o, p in zip(outs, getattr(attention_scan, fwd)(*ins)))
    saved = [outs[0], outs[1], alpha32, *outs[3:]]
    cots = _to_bf16([_rand(gen, b, t, n, scale=0.1) for n in (st, a, l)])
    cots += ([_to_bf16(_rand(gen, b, t, st, scale=0.1)) if b % 2 else None] if lstm else [])
    args = [*ins, *saved, *cots, c32]
    bwd = getattr(attention_scan, fwd + "_bwd")
    got = _bf16_twice(getattr(attention_scan, kernel), lambda *x: bwd(*x[:-1], c32=x[-1]), args)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _bf16_close(name, got, getattr(attention_scan, fwd + "_bwd_twin_bf16")(*args),
                getattr(attention_scan, fwd + "_bwd_plain_bf16")(*args[:-1]),
                getattr(attention_scan, fwd + "_bwd_plain")(*_upcast(args[:-1])))
    with pytest.raises(ValueError, match="float32 alpha"):
        bwd(*args[:-1])


# The small-width bf16 train step of each other configuration: its
# recipe, its model_kwargs, its input width and the bf16 entries it
# launches (each once, K1's and K6's three times).
OTHER_BF16_STEPS = {
    "conv_bilstm": ("timit_conv_bilstm", dict(hidden_frame_size=64, output_frame_size=32,
                                              score_depth=40, feature_maps=4, state_depth=48),
                    {"bilstm_scan_bf16": 1, "bilstm_scan_bwd_bf16": 1,
                     "attention_decode_scan_loc_lstm_fwd_bf16": 1,
                     "attention_decode_scan_loc_lstm_bwd_bf16": 1}),
    "conv_bilstm_content": ("timit_conv_bilstm",
                            dict(hidden_frame_size=64, output_frame_size=32, score_depth=40,
                                 feature_maps=0, state_depth=48),
                            {"bilstm_scan_bf16": 1, "bilstm_scan_bwd_bf16": 1,
                             "attention_decode_scan_lstm_fwd_bf16": 1,
                             "attention_decode_scan_lstm_bwd_bf16": 1}),
    "flagship_loc": ("timit_chorowski_normnll_colnorm",
                     dict(hidden_frame_size=32, output_frame_size=32, score_depth=48,
                          state_depth=32, mlp_depth=16, feature_maps=4, penalty_lambda=0.5),
                     {"bigru_scan2_bf16": 3, "bigru_scan2_bwd_bf16": 3,
                      "attention_decode_scan_loc_fwd_bf16": 1,
                      "attention_decode_scan_loc_bwd_bf16": 1}),
}


@pytest.mark.parametrize("config", list(OTHER_BF16_STEPS))
def test_other_bf16_train_steps_under_either_flag(card, config):
    """A bf16 train step of conv_bilstm, conv_bilstm_content and
    flagship_loc (with the monotonic penalty) at small widths on the card:
    the bf16 entries of its kernels only, the same metrics and gradients
    bit for bit under either value of allow_bf16_reduced_precision_reduction,
    the caller's flag restored, and finite float32 gradients on every
    master."""
    from seq2seq_attention_asr_tpu_torch import tree
    from seq2seq_attention_asr_tpu_torch.ops.cuda import (attention_scan, attention_step,
                                                          gru_scan, lstm_scan)
    from seq2seq_attention_asr_tpu_torch.train import experiment, optim, trainer

    recipe, kwargs, launches = OTHER_BF16_STEPS[config]
    exp = getattr(experiment, recipe)()
    exp.model_kwargs.update(kwargs, compute_dtype="bfloat16")
    model = exp.build_model()
    params = exp.init_params(torch.Generator().manual_seed(0), device="cuda")
    gen = torch.Generator().manual_seed(5)
    b, l, t = 8, 144, 12
    x = _rand(gen, b, l, 123)
    x_len = torch.tensor([144, 131, 144, 97, 120, 144, 88, 133], device=card)
    y = torch.randint(0, 62, (b, t), generator=gen).cuda()
    dec_mask = (torch.arange(t)[None] < torch.tensor([12, 7, 12, 3, 9, 12, 2, 11])[:, None])
    batch = (x, x_len, y, dec_mask.float().cuda())
    tx = optim.Transform(lambda p: tree.tree_map(torch.zeros_like, p),
                         lambda g, s, p=None: (tree.tree_map(torch.zeros_like, g), g))
    step = trainer.make_step_core(model.forward, tx, exp.optim, exp.train, model.output_depth)
    kernels = {k.name: k for mod in (attention_scan, attention_step, gru_scan, lstm_scan)
               for k in vars(mod).values() if isinstance(k, type(lstm_scan.KERNEL))}
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    runs = {}
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            counts = {n: k.launches for n, k in kernels.items()}
            state, m = step((params, tx.init(params), torch.Generator(device="cuda")), batch)
            torch.cuda.synchronize()
            ran = {n: k.launches - counts[n] for n, k in kernels.items()
                   if k.launches != counts[n]}
            assert ran == launches
            assert matmul.allow_bf16_reduced_precision_reduction is flag
            runs[flag] = (float(m["loss"]), tree.leaves(state[1]))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert runs[True][0] == runs[False][0]
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in runs[True][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


def _decoder_digests(device="cuda"):
    """sha1 of the outputs of the float32 decoder scans K10-K15 (each
    backward on its forward's outputs) and of the bf16 forwards of K10,
    K12 and K14 on seeded inputs, through the public wrappers only, so
    that another checkout's kernels digest the same way."""
    import hashlib

    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_scan as sc

    gen = torch.Generator().manual_seed(29)
    r = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(device)
    u = lambda *shape: r(*shape, scale=shape[0] ** -0.5)
    b, l, t, s, a, st, fm, f = 5, 37, 9, 40, 24, 16, 4, 5
    mask = (torch.arange(l)[None] < torch.tensor([37, 20, 37, 9, 30])[:, None]).float().to(device)
    h = r(b, l, a, scale=0.5) * mask[:, :, None]
    vh = (h @ u(a, s)).contiguous()
    yin = r(b, t, st, scale=0.5)
    common = [u(st, s), u(st, s)[0], u(s, s)[0], u(a, st), u(a, st)[0], u(2 * st, st),
              u(2 * st, st)[0]]
    lstm_w = [u(st, 4 * st), u(st, 4 * st), u(st, 4 * st)[0]]
    gru_w = [u(2 * st, 2 * st), u(2 * st, st)]
    loc = [u(f, fm), u(f, fm)[0], u(fm, s)]
    out = {}
    for name, scan, weights in (("K10", sc.attention_decode_scan_loc_lstm, common + lstm_w + loc),
                                ("K12", sc.attention_decode_scan_loc, common + gru_w + loc),
                                ("K14", sc.attention_decode_scan_lstm, common + lstm_w)):
        weights = [w.contiguous() for w in weights]
        ins = [vh, h, mask, yin, *weights]
        outs = scan(*ins)
        cots = [r(*o.shape, scale=0.1) for o in outs]
        grads = getattr(sc, scan.__name__ + "_bwd")(*ins, *outs, *cots)
        bf = scan(*[x.to(torch.bfloat16) for x in ins])
        for tag, res in ((name, outs), ("K1" + str(int(name[-1]) + 1), grads),
                         (name + " bf16", bf)):
            out[tag] = hashlib.sha1(b"".join(o.detach().float().cpu().numpy().tobytes()
                                             for o in res)).hexdigest()[:16]
    return out


# The digests of the commit before the bf16 backwards of K11, K13 and K15
# (and the float32 alpha and c of the bf16 forwards), on an NVIDIA H100
# 80GB HBM3 (the commit with them gave the same).
DECODER_DIGESTS = {"K10": "63622ca7e40a4333", "K11": "3b2ee8641120ef2e",
                   "K10 bf16": "3cd2ca363f170b82", "K12": "ffa687cd63b6a90e",
                   "K13": "3b8d2d050fab56aa", "K12 bf16": "a4919ed371e55d97",
                   "K14": "fd5e486c3bd3b1dd", "K15": "0bed5cbf13db7bb4",
                   "K14 bf16": "fc6121deb30477bd"}


def test_decoder_scans_are_bit_for_bit_as_before(card):
    """The float32 results of K10-K15 and the bf16 forwards' outputs of
    K10, K12 and K14 are the bits the kernels gave before the bf16
    backwards of K11, K13 and K15 existed and the bf16 forwards wrote the
    float32 alpha and c."""
    assert _decoder_digests() == DECODER_DIGESTS
