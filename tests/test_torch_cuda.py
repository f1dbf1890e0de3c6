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


@pytest.mark.parametrize("b,l,h", [(1, 7, 16), (3, 20, 256), (5, 9, 300), (8, 132, 256)])
def test_bigru_scan2_kernel(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

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


@pytest.mark.parametrize("b,k,l,dims", [
    (1, 1, 8, (16, 16, 24, 6, 8, 3)),
    (3, 5, 37, (16, 12, 20, 7, 4, 2)),
    (2, 8, 64, (64, 32, 48, 10, 8, 7)),
    (8, 5, 132, (512, 256, 512, 62, 64, 7)),
])
def test_fused_attention_step_kernel(card, b, k, l, dims):
    from seq2seq_attention_asr_tpu_torch import interop
    from seq2seq_attention_asr_tpu_torch.ops import attention
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step

    s_dim, st, a, v, m, win = dims
    cfg = attention.AttentionConfig(score_depth=s_dim, state_depth=st, annotation_depth=a,
                                    output_depth=v, readout=(("dropout", 0.5), ("maxout", m, win),
                                                             ("linear", v)))
    gen = torch.Generator().manual_seed(b * 100 + k)
    params = interop.to_torch(attention.attention_init(gen, cfg), card)
    lens = torch.randint(1, l + 1, (b,), generator=gen).cuda()
    mask = (torch.arange(l, device=card)[None] < lens[:, None]).float()
    h = _rand(gen, b, l, a)
    vh = attention.precompute_vh(params, h).contiguous()
    state = (torch.softmax(_rand(gen, b, k, l), -1), _rand(gen, b, k, st, scale=0.3),
             _rand(gen, b, k, st))
    y = torch.nn.functional.one_hot(torch.randint(0, v, (b, k), generator=gen), v).float().cuda()
    before = attention_step.KERNEL.launches
    (ga, gs, gm), got = attention_step.fused_attention_step(params, cfg, state, y, vh, h, mask)
    _, want = attention_step.fused_attention_step_plain(params, cfg, state, y, vh, h, mask)
    torch.cuda.synchronize()
    assert attention_step.KERNEL.launches == before + 1
    for key in ("alpha", "c", "s", "logp"):
        assert _max_err([got[key]], [want[key]]) <= TOL, key
    assert gm is state[2]


@pytest.mark.parametrize("b,n", [(1, 8191), (3, 57343)])
def test_stft_logmel_power_kernel(card, b, n):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel

    gen = torch.Generator().manual_seed(n)
    t = torch.arange(n) / 16000.0
    y = (0.3 * torch.sin(2 * np.pi * 440 * t) + 0.05 * torch.randn(b, n, generator=gen)).cuda()
    yp = torch.nn.functional.pad(y[:, None], (1024, 1024), mode="reflect")[:, 0].contiguous()
    before = logmel.KERNEL.launches
    got = logmel.stft_logmel_power(yp, 16000)
    want = logmel.stft_logmel_power_plain(yp, 16000)
    torch.cuda.synchronize()
    assert logmel.KERNEL.launches == before + 1
    assert _max_err(got, want) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan, logmel

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


@pytest.mark.parametrize("exact", [False, True])
def test_transcriber_on_the_card_matches_the_cpu(card, exact):
    from seq2seq_attention_asr_tpu_torch import serve
    from seq2seq_attention_asr_tpu_torch.models import registry
    from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step, gru_scan, logmel

    model = registry.build("chorowski", hidden_frame_size=32, output_frame_size=32,
                           score_depth=32, state_depth=32, mlp_depth=16, output_depth=9)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    pcms = [(0.1 * rng.randn(n)).astype(np.float32) for n in (9000, 20000, 9500)]
    kw = dict(eos_id=8, pad_frames=3, beam_k=3, exact=exact)
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


@pytest.mark.parametrize("b,l,h", [(3, 13, 8), (16, 144, 256)])
def test_bigru_scan2_bwd_kernel(card, b, l, h):
    from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan

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
    args = (vh, h, mask, yin, *weights, want[0], want[1], *cot)
    got = attention_scan.attention_decode_scan_bwd(*args)
    want = attention_scan.attention_decode_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    assert attention_scan.KERNEL_BWD.launches == bwd + 1
    _bwd_close(got, want, "attention_decode_scan_bwd")


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
