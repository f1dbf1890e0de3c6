"""K3's tables and its transform's algebra, on the CPU.

csrc/logmel.cu forms the real 2048-point spectrum of a windowed frame as
a 1024-point complex FFT of z[n] = x[2n] + i x[2n+1] (two 512-point
FFTs of z's even and odd points, three radix-8 passes each) and a split
step, with twiddles and mel taps from ops/cuda/logmel.py's _consts. The
kernel runs only on the card; these hold its tables and, in numpy, its
algebra and index maps to np.fft.rfft.

Tolerances: twiddles within 1e-7 of the float64 values (a float32
rounding is at most 6e-8); the mel product through the chunked taps
within 1e-6 relative of the dense product (sums of at most 64 float32
products in another order); the spectra within 1e-12 max|X| in float64
(rounding of ~20 operations a bin) and 1e-6 max|X| in float32.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest

from seq2seq_attention_asr_tpu_torch.data import features
from seq2seq_attention_asr_tpu_torch.ops.cuda import logmel
from test_torch_kernels import _pcm

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch"
          / "csrc" / "logmel.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _tables(sr=16000):
    return logmel._consts(sr, "cpu")


def _complex(tab, dtype=np.complex128):
    t = tab.numpy().astype(np.float64)
    return (t[:, 0] + 1j * t[:, 1]).astype(dtype)


@pytest.mark.parametrize("name,n,count", [("fft_tw", 1024, 1024), ("split_tw", 2048, 257)])
def test_twiddle_tables_are_exp_minus_2_pi_i_k_over_n(name, n, count):
    tab = getattr(_tables(), name)
    assert tuple(tab.shape) == (count, 2) and str(tab.dtype) == "torch.float32"
    want = np.exp(-2j * np.pi * np.arange(count) / n)
    got = _complex(tab)
    assert np.abs(got.real - want.real).max() <= 1e-7
    assert np.abs(got.imag - want.imag).max() <= 1e-7


def _mel_through_taps(power, c):
    """The kernel's mel product: chunk c's sum over its TAP_RUN bins from
    tap_start[c], then each filter's chunks in order."""
    taps, start, first = (t.numpy() for t in (c.taps, c.tap_start, c.mel_first))
    bins = start[:, None] + np.arange(logmel.TAP_RUN)[None]
    part = np.einsum("...ck,ck->...c", power[..., bins], taps.astype(np.float64))
    return np.stack([part[..., first[m]:first[m + 1]].sum(-1) for m in range(logmel.N_MELS)], -1)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_chunked_taps_reproduce_the_dense_mel_product(sr):
    c = _tables(sr)
    melw = features.mel_filterbank(sr, logmel.N_FFT, logmel.N_MELS).astype(np.float32)
    power = np.random.RandomState(sr).exponential(size=(3, 5, logmel.NFREQ))
    want = power @ melw.T.astype(np.float64)
    got = _mel_through_taps(power, c)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= 1e-6 * np.abs(want)).all()


@pytest.mark.parametrize("sr", [16000, 8000])
def test_chunks_hold_every_tap_once_and_stay_in_range(sr):
    c = _tables(sr)
    taps, start, first = (t.numpy() for t in (c.taps, c.tap_start, c.mel_first))
    melw = features.mel_filterbank(sr, logmel.N_FFT, logmel.N_MELS).astype(np.float32)
    assert (taps != 0).sum() == (melw != 0).sum()
    if sr == 16000:
        assert (taps != 0).sum() == 2020 and c.nchunks == 190
    assert first[0] == 0 and first[-1] == c.nchunks <= logmel.TAP_SLOTS
    assert (np.diff(first) > 0).all()  # every filter has taps, and the offsets rise
    assert (start >= 0).all() and (start + logmel.TAP_RUN <= logmel.NFREQ).all()
    assert not taps[c.nchunks:].any()
    # Chunk by chunk, the weights are the filter's at the bins they read.
    for m in range(logmel.N_MELS):
        dense = np.zeros(logmel.NFREQ, np.float32)
        for k in range(first[m], first[m + 1]):
            assert (dense[start[k]:start[k] + logmel.TAP_RUN][taps[k] != 0] == 0).all()
            dense[start[k]:start[k] + logmel.TAP_RUN] += taps[k]
        np.testing.assert_array_equal(dense, melw[m])


def test_the_kernels_constants_and_arguments_are_the_wrappers():
    assert _const("kRun") == logmel.TAP_RUN and _const("kSlots") == logmel.TAP_SLOTS
    assert _const("kMels") == logmel.N_MELS and _const("kN") == logmel.N_FFT
    params = re.search(r'extern "C" int stft_logmel_power\((.*?)\)\s*\{', SOURCE, re.S).group(1)
    kinds = ["p" if "*" in p or "cudaStream_t" in p else "i" for p in params.split(",")]
    assert kinds == ["p" if t is ctypes.c_void_p else "i" for t in logmel.KERNEL.argtypes]
    assert "sincospif" not in SOURCE and "melw" not in SOURCE and "gridDim.y" not in SOURCE
    assert _const("kRow") == ROW and "kSpecO = kSub + 8;" in SOURCE


def _frames(dtype):
    """The windowed frames of K3's input for the _pcm signals."""
    y = _pcm(2, 16 * 512 - 1, 3)
    yp = np.pad(y, ((0, 0), (1024, 1024)), mode="reflect")
    idx = np.arange(logmel.N_FFT)[None] + logmel.HOP * np.arange(
        1 + (yp.shape[1] - logmel.N_FFT) // logmel.HOP)[:, None]
    return (yp[:, idx].astype(np.float64) * features.hann_window()).astype(dtype)


def _split_twiddles(tab):
    """exp(-2 pi i k / 2048) for k <= 1024 from the table's k <= 256, as
    the kernel derives them: 1024 - k: -conj s; 512 - k: -i conj s;
    512 + k: -i s."""
    s = np.zeros(1025, tab.dtype)
    k = np.arange(257)
    s[k], s[1024 - k] = tab, -np.conj(tab)
    s[512 - k], s[512 + k] = -1j * np.conj(tab), -1j * tab
    return s


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_even_odd_packing_and_split_give_the_real_spectrum(dtype, rtol):
    """X[k] = (Z[k] + conj Z[1024-k]) / 2 - i W^k (Z[k] - conj Z[1024-k]) / 2,
    W = exp(-2 pi i / 2048), Z the 1024-point FFT of x[2n] + i x[2n+1]."""
    cdtype = np.complex128 if dtype == np.float64 else np.complex64
    x = _frames(dtype)
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(cdtype)
    Z = np.fft.fft(z, axis=-1)
    assert Z.dtype == cdtype
    k = np.arange(logmel.NFREQ)
    zk, zc = Z[..., k % 1024], np.conj(Z[..., (1024 - k) % 1024])
    if dtype == np.float64:
        w = np.exp(-2j * np.pi * k / 2048)
    else:
        w = _split_twiddles(_complex(_tables().split_tw, cdtype))
    X = 0.5 * (zk + zc) - 0.5j * w * (zk - zc)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert np.abs(X - want).max() <= rtol * np.abs(want).max()


W8 = np.exp(-2j * np.pi * np.arange(8) / 8)
ROW, RUN, SPEC_O = 72, 9, 512 + 8  # csrc/logmel.cu kRow, a run of the warp exchange, kSpecO


def _swz(b):
    return b ^ ((b >> 3) & 7)


def _kernel_power(x):
    """The kernel's transform of one windowed frame (float64), thread by
    thread through its shared-memory index maps: (power (1025,), the
    buffers' indices written by each pass)."""
    tw = np.exp(-2j * np.pi * np.arange(1024) / 1024)
    sw = np.exp(-2j * np.pi * np.arange(257) / 2048)
    dft8 = lambda v: W8[(np.arange(8)[:, None] * np.arange(8)[None]) % 8] @ v
    t = np.arange(128)
    g, u = t & 1, t >> 1
    k1, lo3 = u >> 3, u & 7
    buf1, buf2, spec = (np.full(n, np.nan, complex) for n in (16 * ROW, 16 * ROW, SPEC_O + 512))
    written = {}
    # Pass 1: z_g[u + 64 m] = x[4 (u + 64 m) + 2 g] + i x[... + 1].
    n = 4 * (u[:, None] + 64 * np.arange(8)[None]) + 2 * g[:, None]
    v = dft8((x[n] + 1j * x[n + 1]).T)  # (8 outputs, 128 threads)
    v *= tw[(2 * np.arange(8)[:, None] * u[None]) % 1024]
    idx = (2 * np.arange(8)[:, None] + g[None]) * ROW + u[None]
    buf1[idx] = v
    written["buf1"] = idx
    # Pass 2: thread (k1, j1): outputs k1 at u' = j1 + 8 j2; then W64^(j1 q1).
    v = dft8(buf1[(2 * k1 + g)[None] * ROW + lo3[None] + 8 * np.arange(8)[:, None]])
    v *= tw[(16 * lo3[None] * np.arange(8)[:, None]) % 1024]
    idx = (2 * k1 + g)[None] * ROW + lo3[None] * RUN + np.arange(8)[:, None]
    buf2[idx] = v
    written["buf2"] = idx
    # Pass 3: thread (k1, q1): over j1, to bin k1 + 8 q1 + 64 q2.
    v = dft8(buf2[(2 * k1 + g)[None] * ROW + np.arange(8)[:, None] * RUN + lo3[None]])
    idx = g[None] * SPEC_O + _swz(k1[None] + 8 * lo3[None] + 64 * np.arange(8)[:, None])
    spec[idx] = v
    written["spec"] = idx
    # The split: groups k <= 256, bins k, 1024-k, 512-k, 512+k.
    pw = np.full(1025, np.nan)
    for k in range(257):
        k2 = (512 - k) & 511
        e1, o1, e2, o2 = (spec[off + _swz(b)] for off, b in ((0, k), (SPEC_O, k), (0, k2),
                                                              (SPEC_O, k2)))
        w = sw[k] ** 2
        z0, z2 = e1 + w * o1, e1 - w * o1
        z1, z3 = e2 - np.conj(w) * o2, e2 + np.conj(w) * o2
        s = sw[k]
        for a, b, sk, bin_ in ((z0, z3, s, k), (z3, z0, -np.conj(s), 1024 - k),
                               (z1, z2, -1j * np.conj(s), 512 - k), (z2, z1, -1j * s, 512 + k)):
            pw[bin_] = abs(0.5 * (a + np.conj(b)) - 0.5j * sk * (a - np.conj(b))) ** 2
    return pw, written


def test_the_kernels_passes_and_split_give_the_power_spectrum():
    x = _frames(np.float64)[0, 3]
    pw, written = _kernel_power(x)
    want = np.abs(np.fft.rfft(x)) ** 2
    assert np.abs(pw - want).max() <= 1e-12 * want.max()
    # Each pass writes 1024 distinct slots, inside its buffer.
    for name, idx in written.items():
        assert np.unique(idx).size == 1024, name


@pytest.mark.parametrize("access", ["buf1 store", "buf1 load", "buf2 store", "buf2 load",
                                    "spec store"])
def test_each_pass_is_free_of_bank_conflicts(access):
    """8-byte shared accesses: within each half-warp, the 16 lanes' float2
    slots are distinct modulo 16 (32 banks of 4 bytes)."""
    t = np.arange(128)
    g, u = t & 1, t >> 1
    k1, lo3 = u >> 3, u & 7
    for step in range(8):
        slot = {"buf1 store": (2 * step + g) * ROW + u,
                "buf1 load": (2 * k1 + g) * ROW + lo3 + 8 * step,
                "buf2 store": (2 * k1 + g) * ROW + lo3 * RUN + step,
                "buf2 load": (2 * k1 + g) * ROW + step * RUN + lo3,
                "spec store": g * SPEC_O + _swz(k1 + 8 * lo3 + 64 * step)}[access]
        for half in slot.reshape(-1, 16):
            assert np.unique(half % 16).size == 16, (access, step)
