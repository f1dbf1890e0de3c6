"""FLAC decoding, LibriSpeech's audio (seq2seq_attention_asr_tpu/data/flac.py).

The reference decodes FLAC through scikits.audiolab/libsndfile
(librispeech/preprocess.py:116-140). No external codec is assumed: this
is a self-contained decoder for the FLAC stream format (constant /
verbatim / fixed-predictor / LPC subframes, Rice and Rice2 residual
coding with escaped partitions, left-side / right-side / mid-side stereo
decorrelation, wasted bits). Two implementations:

  - `decode_flac_py`: pure Python, the bit-exact reference (slow; the
    tests' oracle and an explicit caller's choice);
  - `decode_flac`: the port's C++ decoder (native/flacdec.cpp through
    ctypes), the production path, built at first use.

Unlike the JAX package's decoder, both check each frame's CRC-8 (over
its header) and CRC-16 (over the whole frame): a corrupt stream raises
FlacError. And `decode_flac` does not fall back to the Python decoder:
a native build failure raises, and so does a stream the native decoder
refuses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class FlacError(RuntimeError):
    pass


def _crc_table(bits: int, poly: int):
    top, mask = 1 << (bits - 1), (1 << bits) - 1
    table = []
    for byte in range(256):
        c = byte << (bits - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return table


# FLAC's frame checks: CRC-8 (x^8 + x^2 + x + 1) over the frame header,
# CRC-16 (x^16 + x^15 + x^2 + 1) over the whole frame, MSB first from 0.
_CRC8 = _crc_table(8, 0x07)
_CRC16 = _crc_table(16, 0x8005)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ b]
    return c


class _BitReader:
    __slots__ = ("data", "pos", "acc", "navail")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # next byte index
        self.acc = 0
        self.navail = 0

    def read_uint(self, n: int) -> int:
        while self.navail < n:
            if self.pos >= len(self.data):
                raise FlacError("unexpected end of stream")
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.navail += 8
        self.navail -= n
        v = (self.acc >> self.navail) & ((1 << n) - 1)
        self.acc &= (1 << self.navail) - 1
        return v

    def read_signed(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while self.read_uint(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        self.navail -= self.navail % 8
        self.acc &= (1 << self.navail) - 1

    def at_end(self) -> bool:
        return self.pos >= len(self.data) and self.navail < 8

    def byte_pos(self) -> int:
        """The byte offset of the next bit to read (at a byte boundary)."""
        return self.pos - self.navail // 8


def _read_utf8_number(br: _BitReader) -> int:
    """UTF-8-style variable-length frame/sample number (up to 7 bytes)."""
    b0 = br.read_uint(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n == 0:
        raise FlacError("invalid UTF-8 coded number")
    v = b0 & (mask - 1)
    for _ in range(n):
        c = br.read_uint(8)
        if (c & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation")
        v = (v << 6) | (c & 0x3F)
    return v


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _read_residual(br: _BitReader, blocksize: int, order: int) -> list:
    method = br.read_uint(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read_uint(4)
    nparts = 1 << po
    res = []
    for p in range(nparts):
        n = blocksize >> po
        if p == 0:
            n -= order
        if n < 0:
            raise FlacError("partition smaller than predictor order")
        param = br.read_uint(plen)
        if param == escape:
            rbps = br.read_uint(5)
            if rbps == 0:
                res.extend([0] * n)
            else:
                res.extend(br.read_signed(rbps) for _ in range(n))
        else:
            for _ in range(n):
                q = br.read_unary()
                r = br.read_uint(param) if param else 0
                v = (q << param) | r
                res.append((v >> 1) ^ -(v & 1))  # zigzag
    return res


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> list:
    if br.read_uint(1):
        raise FlacError("subframe padding bit set")
    stype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
    eff = bps - wasted
    if stype == 0:  # CONSTANT
        out = [br.read_signed(eff)] * blocksize
    elif stype == 1:  # VERBATIM
        out = [br.read_signed(eff) for _ in range(blocksize)]
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        out = [br.read_signed(eff) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for i, r in enumerate(res):
            t = i + order
            out.append(r + sum(c * out[t - 1 - j] for j, c in enumerate(coefs)))
    elif stype >= 32:  # LPC order 1-32
        order = stype - 31
        out = [br.read_signed(eff) for _ in range(order)]
        prec = br.read_uint(4)
        if prec == 15:
            raise FlacError("invalid LPC precision")
        prec += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        for i, r in enumerate(res):
            t = i + order
            acc = sum(c * out[t - 1 - j] for j, c in enumerate(coefs))
            out.append(r + (acc >> shift))
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


_BLOCKSIZE_CODES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}


def _decode_frame(br: _BitReader, si: dict) -> np.ndarray:
    """One frame -> (blocksize, channels) int32; FlacError on a CRC
    mismatch."""
    start = br.byte_pos()
    sync = br.read_uint(14)
    if sync != 0x3FFE:
        raise FlacError(f"bad frame sync 0x{sync:x}")
    if br.read_uint(1):
        raise FlacError("reserved frame bit set")
    br.read_uint(1)  # blocking strategy
    bs_code = br.read_uint(4)
    sr_code = br.read_uint(4)
    ch_code = br.read_uint(4)
    ss_code = br.read_uint(3)
    if br.read_uint(1):
        raise FlacError("reserved frame bit set")
    _read_utf8_number(br)
    if bs_code == 0:
        raise FlacError("reserved blocksize code 0")
    elif bs_code == 6:
        blocksize = br.read_uint(8) + 1
    elif bs_code == 7:
        blocksize = br.read_uint(16) + 1
    else:
        blocksize = _BLOCKSIZE_CODES[bs_code]
    if sr_code == 12:
        br.read_uint(8)
    elif sr_code in (13, 14):
        br.read_uint(16)
    bps_tab = {0: si["bps"], 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
    if ss_code not in bps_tab:
        raise FlacError(f"reserved sample-size code {ss_code}")
    bps = bps_tab[ss_code]
    header_end = br.byte_pos()
    if br.read_uint(8) != crc8(br.data[start:header_end]):
        raise FlacError("frame header CRC-8 mismatch")

    if ch_code < 8:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
    elif ch_code in (8, 9, 10):
        # side channel carries one extra bit
        if ch_code == 8:  # left/side
            a = _decode_subframe(br, blocksize, bps)
            s = _decode_subframe(br, blocksize, bps + 1)
            chans = [a, [x - y for x, y in zip(a, s)]]
        elif ch_code == 9:  # right/side
            s = _decode_subframe(br, blocksize, bps + 1)
            b = _decode_subframe(br, blocksize, bps)
            chans = [[x + y for x, y in zip(b, s)], b]
        else:  # mid/side
            m = _decode_subframe(br, blocksize, bps)
            s = _decode_subframe(br, blocksize, bps + 1)
            left, right = [], []
            for mm, ss in zip(m, s):
                mm = (mm << 1) | (ss & 1)
                left.append((mm + ss) >> 1)
                right.append((mm - ss) >> 1)
            chans = [left, right]
    else:
        raise FlacError(f"reserved channel assignment {ch_code}")
    br.align()
    frame_end = br.byte_pos()
    if br.read_uint(16) != crc16(br.data[start:frame_end]):
        raise FlacError("frame CRC-16 mismatch")
    return np.asarray(chans, np.int64).T.astype(np.int32)


def parse_streaminfo(data: bytes) -> Tuple[dict, int]:
    """Returns (streaminfo dict, offset of first frame byte)."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    br = _BitReader(data, 4)
    si = None
    while True:
        last = br.read_uint(1)
        btype = br.read_uint(7)
        blen = br.read_uint(24)
        if btype == 0:
            br.read_uint(16)  # min blocksize
            br.read_uint(16)  # max blocksize
            br.read_uint(24)  # min framesize
            br.read_uint(24)  # max framesize
            sr = br.read_uint(20)
            nch = br.read_uint(3) + 1
            bps = br.read_uint(5) + 1
            total = br.read_uint(36)
            for _ in range(16):
                br.read_uint(8)  # MD5
            si = {
                "sample_rate": sr, "channels": nch,
                "bps": bps, "total_samples": total,
            }
        else:
            for _ in range(blen):
                br.read_uint(8)
        if last:
            break
    if si is None:
        raise FlacError("missing STREAMINFO")
    return si, br.pos


def decode_flac_py(data: bytes) -> Tuple[np.ndarray, int]:
    """Pure-Python decode: (samples (N, channels) int32, sample_rate)."""
    si, off = parse_streaminfo(data)
    br = _BitReader(data, off)
    frames = []
    got = 0
    total = si["total_samples"]
    while (total == 0 or got < total) and not br.at_end():
        f = _decode_frame(br, si)
        frames.append(f)
        got += f.shape[0]
    pcm = (
        np.concatenate(frames, axis=0)
        if frames
        else np.zeros((0, si["channels"]), np.int32)
    )
    if total and pcm.shape[0] > total:
        pcm = pcm[:total]
    return pcm, si["sample_rate"]


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode through the port's C++ decoder (native/flacdec.cpp): the
    same samples as decode_flac_py. FlacError where the stream is
    malformed or fails a CRC; a build failure raises as it is."""
    from ..native import flacdec

    try:
        return flacdec.decode(data)
    except ValueError as e:
        raise FlacError(str(e)) from None


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Read a FLAC file -> (float64 mono samples in [-1, 1), rate).

    Multi-channel audio keeps channel 0 (LibriSpeech is mono; the
    reference's Sndfile read is likewise per-frame channel-major,
    preprocess.py:127-131).
    """
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_flac(data)
    si, _ = parse_streaminfo(data)
    mono = pcm[:, 0].astype(np.float64) / float(1 << (si["bps"] - 1))
    return mono, sr
