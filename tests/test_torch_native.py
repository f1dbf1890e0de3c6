"""The port's native C++ helpers (seq2seq_attention_asr_tpu_torch/native/)
against the JAX package's: the edit distance, the batch packer and the
FLAC decoder, each built by g++ from the port's own sources into its
_build/ at first use; and the port's FLAC decoders (native and pure
Python) against the JAX package's pure-Python decoder on every stream
kind tests/flac_encoder.py writes, plus hand-built frames with wasted
bits, escaped residual partitions and an unknown length. A bad CRC
raises FlacError in the port (the JAX package does not check CRCs)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flac_encoder import BitWriter, _rice_write, crc8, crc16, encode_flac  # noqa: E402
from seq2seq_attention_asr_tpu.data import flac as jflac  # noqa: E402
from seq2seq_attention_asr_tpu.decode import metrics as jmetrics  # noqa: E402
from seq2seq_attention_asr_tpu.native import packing as jpacking  # noqa: E402
from seq2seq_attention_asr_tpu_torch.data import batching, flac  # noqa: E402
from seq2seq_attention_asr_tpu_torch.decode import metrics  # noqa: E402
from seq2seq_attention_asr_tpu_torch.native import build, editdist, flacdec, packing  # noqa: E402


def test_libraries_build_from_the_port_sources_into_its_build_dir():
    """Each library's name carries a digest of its source: the port's own
    build, never the JAX package's committed .so."""
    for name in build.SOURCES:
        path = build.build(name)
        assert path.parent == build.BUILD_DIR and path.exists()
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert "seq2seq_attention_asr_tpu_torch" in str(path)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet numpy fallback: a source that does not compile raises."""
    (tmp_path / "broken.cpp").write_text("int f() { return undefined_name; }\n")
    monkeypatch.setattr(build, "HERE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(build.SOURCES, "broken", "broken.cpp")
    with pytest.raises(RuntimeError, match="undefined_name"):
        build.build("broken")
    assert not list((tmp_path / "_build").glob("*.so")) and not list(
        (tmp_path / "_build").glob("*.tmp"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build("broken")


def test_edit_distances_match_jax():
    """Native and numpy, one pair and a padded batch, against the JAX
    package's numpy distance; error_rate goes through the native scorer."""
    rng = np.random.RandomState(7)
    for _ in range(200):
        a = rng.randint(0, 6, size=rng.randint(0, 20))
        b = rng.randint(0, 6, size=rng.randint(0, 20))
        want = jmetrics.edit_distance_np(a, b)
        assert metrics.edit_distance(a, b) == metrics.edit_distance_np(a, b) == want
    a = rng.randint(0, 5, size=(16, 12)).astype(np.int32)
    b = rng.randint(0, 5, size=(16, 9)).astype(np.int32)
    al, bl = rng.randint(0, 13, size=16), rng.randint(0, 10, size=16)
    before = editdist.calls
    got = metrics.batch_edit_distance(a, al, b, bl)
    assert editdist.calls == before + 1
    np.testing.assert_array_equal(got, jmetrics.batch_edit_distance(a, al, b, bl))
    preds = [rng.randint(0, 5, size=rng.randint(1, 9)) for _ in range(8)]
    targets = [rng.randint(0, 5, size=rng.randint(1, 9)) for _ in range(8)]
    before = editdist.calls
    assert metrics.error_rate(preds, None, targets) == jmetrics.error_rate(preds, None, targets)
    assert editdist.calls == before + 8


def test_packer_matches_jax_and_numpy():
    rng = np.random.RandomState(9)
    utts = [rng.randn(rng.randint(3, 15), 4).astype(np.float32) for _ in range(10)]
    labs = [rng.randint(0, 9, size=rng.randint(1, 7)).astype(np.int32) for _ in range(10)]
    sel = [7, 2, 9, 0]
    got = packing.pack_batch(packing.RaggedFeatures(utts), sel, 12)
    want = jpacking.pack_batch(jpacking.RaggedFeatures(utts), sel, 12)
    got_y = packing.pack_labels(packing.RaggedLabels(labs), sel, 8)
    want_y = jpacking.pack_labels(jpacking.RaggedLabels(labs), sel, 8)
    for g, w in zip(got + got_y, want + want_y):
        np.testing.assert_array_equal(g, w)


@dataclasses.dataclass
class _DS:
    uids: list
    x: list
    y: list
    y39: list

    def __len__(self):
        return len(self.x)


@pytest.mark.parametrize("with_y39", [True, False])
def test_bucketed_batches_are_the_same_by_either_packer(with_y39, monkeypatch):
    """The native path (2-D features) and _pad_np give identical batches,
    and both equal the JAX package's batches; longer utterances are cut
    to the last bucket either way."""
    from seq2seq_attention_asr_tpu.data import batching as jbatching

    rng = np.random.RandomState(11)
    n = 23
    ys = [rng.randint(1, 9, size=rng.randint(2, 8)).astype(np.int32) for _ in range(n)]
    ds = _DS(uids=[f"u{i}" for i in range(n)],
             x=[rng.randn(rng.randint(4, 40), 5).astype(np.float32) for _ in range(n)], y=ys,
             y39=[(y % 5).astype(np.int32) for y in ys] if with_y39 else None)
    b = batching.BucketedBatcher(l_buckets=[8, 16, 32], batch_size=4)
    jb = jbatching.BucketedBatcher(l_buckets=[8, 16, 32], batch_size=4)
    native = list(b.batches(ds, shuffle=True, seed=3))
    assert getattr(ds, "_ragged_views", None) is not None
    monkeypatch.setattr(batching.BucketedBatcher, "_pad_native",
                        lambda self, d, idxs, l_pad, t_pad: self._pad_np(d, idxs, l_pad, t_pad))
    plain = list(b.batches(ds, shuffle=True, seed=3))
    jds = _DS(ds.uids, ds.x, ds.y, ds.y39)
    jax_batches = list(jb.batches(jds, shuffle=True, seed=3))
    assert len(native) == len(plain) == len(jax_batches) == 7
    for got, np_, want in zip(native, plain, jax_batches):
        for key in ("x", "x_len", "y", "y_len", "y39"):
            g, p, w = getattr(got, key), getattr(np_, key), getattr(want, key)
            if w is None:
                assert g is None and p is None
                continue
            assert g.dtype == p.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
            np.testing.assert_array_equal(p, w, err_msg=key)
        assert got.uids == np_.uids == want.uids


def _signal(n=5000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    return (2500 * np.sin(t / 40.0) + 150 * rng.randn(n)).astype(np.int32)


def _stereo(n=3000):
    left = _signal(n, seed=1)
    return np.stack([left, (left * 0.6).astype(np.int32) + _signal(n, seed=2) // 10], axis=1)


# Every stream kind the test encoder writes: each subframe type, Rice
# codes over 1-8 partitions, a short last block (5,000 samples in blocks
# of 256, 512, 1,024 and 192), the three stereo decorrelations and
# independent stereo.
STREAMS = {
    "constant": lambda: encode_flac(np.full(1000, -777, np.int32), mode="constant"),
    "verbatim": lambda: encode_flac(_signal(), mode="verbatim", blocksize=192),
    "fixed0": lambda: encode_flac(_signal(), mode="fixed0"),
    "fixed1": lambda: encode_flac(_signal(), mode="fixed1", npart_order=2),
    "fixed2": lambda: encode_flac(_signal(), mode="fixed2"),
    "fixed3": lambda: encode_flac(_signal(), mode="fixed3", blocksize=512),
    "fixed4": lambda: encode_flac(_signal(), mode="fixed4", npart_order=3),
    "lpc2": lambda: encode_flac(_signal(), mode="lpc2", npart_order=3, blocksize=1024),
    "left_side": lambda: encode_flac(_stereo(), mode="left_side"),
    "right_side": lambda: encode_flac(_stereo(), mode="right_side"),
    "mid_side": lambda: encode_flac(_stereo(), mode="mid_side"),
    "stereo_fixed2": lambda: encode_flac(_stereo(), mode="fixed2"),
}


def _custom_stream(blocks, total_known=True):
    """A mono 16-bit stream of hand-built frames: in each, a VERBATIM
    subframe with `arg` wasted bits, or a FIXED order-2 subframe whose
    residual's first partition is escaped (raw `arg`-bit values, 0: all
    zero) and its second Rice-coded (an odd block: one escaped
    partition). blocks: [(kind, samples, arg)].
    STREAMINFO's total is 0 (unknown) unless total_known."""
    si = BitWriter()
    si.write(1, 1), si.write(0, 7), si.write(34, 24)
    si.write(16, 16), si.write(4096, 16), si.write(0, 24), si.write(0, 24)
    si.write(16000, 20), si.write(0, 3), si.write(15, 5)
    si.write(sum(len(x) for _, x, _ in blocks) if total_known else 0, 36)
    for _ in range(16):
        si.write(0, 8)
    out = bytearray(b"fLaC" + si.getvalue())
    for idx, (kind, x, arg) in enumerate(blocks):
        hdr = BitWriter()
        hdr.write(0x3FFE, 14), hdr.write(0, 1), hdr.write(0, 1)
        hdr.write(7, 4), hdr.write(0, 4), hdr.write(0, 4), hdr.write(4, 3), hdr.write(0, 1)
        hdr.write(idx, 8)  # frame number, < 128
        hdr.write(len(x) - 1, 16)
        head = hdr.getvalue()
        bw = BitWriter()
        for byte in head + bytes([crc8(head)]):
            bw.write(byte, 8)
        bw.write(0, 1)  # padding
        if kind == "wasted":
            bw.write(1, 6), bw.write(1, 1)  # VERBATIM, wasted bits follow
            if arg > 1:
                bw.write(0, arg - 1)
            bw.write(1, 1)
            for v in x:
                assert v % (1 << arg) == 0
                bw.write_signed(int(v) >> arg, 16 - arg)
        else:
            bw.write(10, 6), bw.write(0, 1)  # FIXED order 2, no wasted bits
            bw.write_signed(int(x[0]), 16), bw.write_signed(int(x[1]), 16)
            res = [int(x[i]) - 2 * int(x[i - 1]) + int(x[i - 2]) for i in range(2, len(x))]
            two = len(x) % 2 == 0  # an odd block takes one partition
            half = len(x) // 2 - 2 if two else len(res)
            bw.write(0, 2), bw.write(int(two), 4)  # Rice, one or two partitions
            bw.write(15, 4), bw.write(arg, 5)  # escaped
            for r in res[:half]:
                assert arg or r == 0
                if arg:
                    bw.write_signed(r, arg)
            if two:
                bw.write(6, 4)
                _rice_write(bw, res[half:], 6)
        bw.align()
        body = head + bytes([crc8(head)]) + bw.getvalue()[len(head) + 1:]
        out += body + crc16(body).to_bytes(2, "big")
    return bytes(out)


def _custom_blocks():
    rng = np.random.RandomState(5)
    smooth = np.cumsum(rng.randint(-40, 41, 600)).astype(np.int64)
    ramp = 1230 + 2 * np.arange(300, dtype=np.int64)  # second differences all 0
    return [("wasted", (_signal(400, seed=3) // 8) * 8, 3),
            ("escape", smooth, 12),
            ("wasted", np.full(256, -512, np.int64), 9),
            ("escape", ramp, 0),
            ("escape", smooth[:97], 10)]  # a short, odd last block


@pytest.mark.parametrize("kind", sorted(STREAMS) + ["custom", "custom_unknown_length"])
def test_flac_decoders_match_jax(kind):
    """decode_flac_py and the native decode_flac equal the JAX package's
    decode_flac_py, sample for sample, and read_flac's scale is its."""
    if kind.startswith("custom"):
        data = _custom_stream(_custom_blocks(), total_known=kind == "custom")
    else:
        data = STREAMS[kind]()
    want, sr = jflac.decode_flac_py(data)
    before = flacdec.decodes
    for got, got_sr in (flac.decode_flac_py(data), flac.decode_flac(data)):
        assert got_sr == sr == 16000 and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert flacdec.decodes == before + 1
    if kind.startswith("custom"):
        np.testing.assert_array_equal(want[:, 0], np.concatenate([x for _, x, _ in
                                                                  _custom_blocks()]))
    assert flac.parse_streaminfo(data) == jflac.parse_streaminfo(data)


@pytest.mark.parametrize("where", ["header", "body", "frame_crc"])
def test_a_bad_crc_raises_flac_error(where):
    """Flip one bit of a frame's header (its CRC-8 fails), of its
    subframes or of its CRC-16 (the CRC-16 fails): both port decoders
    raise FlacError; the native decoder never falls back."""
    data = bytearray(encode_flac(_signal(), mode="fixed2"))
    _, off = flac.parse_streaminfo(bytes(data))
    second = bytes(data).index(b"\xff\xf8", off + 2)  # the second frame's sync
    pos = {"header": off + 4, "body": off + 12, "frame_crc": second - 1}[where]
    data[pos] ^= 0x10
    for decode in (flac.decode_flac_py, flac.decode_flac):
        with pytest.raises(flac.FlacError, match="CRC"):
            decode(bytes(data))


def test_read_flac_and_read_audio_match_jax(tmp_path):
    from seq2seq_attention_asr_tpu.data import audio as jaudio
    from seq2seq_attention_asr_tpu_torch.data import audio

    p = str(tmp_path / "utt.flac")
    with open(p, "wb") as f:
        f.write(STREAMS["lpc2"]())
    got, sr = audio.read_audio(p)
    want, jsr = jaudio.read_audio(p)
    assert sr == jsr and got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(flac.read_flac(p)[0], want)
