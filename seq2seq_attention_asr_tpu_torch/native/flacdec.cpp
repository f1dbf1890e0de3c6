// FLAC decoder on the host, the port's copy of
// seq2seq_attention_asr_tpu/native/flacdec.cpp (the same C ABI), the
// production path for LibriSpeech ingestion. The reference decodes FLAC
// through audiolab/libsndfile (librispeech/preprocess.py:116-140); this
// is a self-contained decoder for the subset of the format real encoders
// emit: constant / verbatim / fixed / LPC subframes, Rice + Rice2
// residuals (incl. escaped raw partitions), independent and left-side /
// right-side / mid-side stereo, wasted bits. Bit-exact parity with the
// pure-Python decoder (data/flac.py::decode_flac_py) is asserted in
// tests/test_torch_native.py. Unlike the JAX package's copy, it checks
// each frame's CRC-8 (header) and CRC-16 (frame), as data/flac.py does:
// a mismatch is a decode error.
//
// Exposed functions:
//   asr_flac_info(data, size, info[5]) -> 0 | negative error
//     info = {total_samples, sample_rate, channels, bps, frame_offset}
//   asr_flac_decode(data, size, out, capacity) -> n_per_channel | -err
//     out: interleaved int32, capacity in total int32 slots; -2 a
//     malformed frame, -3 out of capacity, -4 a CRC mismatch.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;     // next byte
  uint64_t acc = 0;
  int navail = 0;
  bool error = false;

  uint32_t read(int n) {
    while (navail < n) {
      if (pos >= size) { error = true; return 0; }
      acc = (acc << 8) | data[pos++];
      navail += 8;
    }
    navail -= n;
    uint32_t v = (uint32_t)((acc >> navail) & ((n == 32) ? 0xFFFFFFFFull
                                                         : ((1ull << n) - 1)));
    acc &= (1ull << navail) - 1;
    return v;
  }

  int64_t read_signed(int n) {
    int64_t v = (int64_t)read(n);
    if (v >= (1ll << (n - 1))) v -= (1ll << n);
    return v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read(1) == 0) q++;
    return q;
  }

  void align() {
    navail -= navail % 8;
    acc &= (1ull << navail) - 1;
  }

  // The byte offset of the next bit to read (at a byte boundary).
  int64_t byte_pos() const { return pos - navail / 8; }

  bool at_end() const { return pos >= size && navail < 8; }
};

bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.read(8);
  if (br.error) return false;
  if (b0 < 0x80) { *out = b0; return true; }
  int n = 0;
  uint32_t mask = 0x40;
  while (b0 & mask) { n++; mask >>= 1; }
  if (n == 0) return false;
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n; i++) {
    uint32_t c = br.read(8);
    if (br.error || (c & 0xC0) != 0x80) return false;
    v = (v << 6) | (c & 0x3F);
  }
  *out = v;
  return true;
}

// The frame checks of the FLAC format: CRC-8 (polynomial x^8 + x^2 + x +
// 1) over the frame header, CRC-16 (x^16 + x^15 + x^2 + 1) over the whole
// frame, both MSB first from 0.
uint32_t crc(const uint8_t* p, int64_t n, int bits, uint32_t poly) {
  const uint32_t top = 1u << (bits - 1), mask = (bits == 32) ? ~0u : (1u << bits) - 1;
  uint32_t c = 0;
  for (int64_t i = 0; i < n; i++) {
    c ^= (uint32_t)p[i] << (bits - 8);
    for (int k = 0; k < 8; k++) c = (c & top) ? ((c << 1) ^ poly) & mask : (c << 1) & mask;
  }
  return c;
}

const int kFixedOrderMax = 4;
const int64_t kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool read_residual(BitReader& br, int blocksize, int order,
                   std::vector<int64_t>& res) {
  uint32_t method = br.read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1;
  uint32_t po = br.read(4);
  int nparts = 1 << po;
  res.clear();
  res.reserve(blocksize - order);
  for (int p = 0; p < nparts; p++) {
    int n = blocksize >> po;
    if (p == 0) n -= order;
    if (n < 0) return false;
    uint32_t param = br.read(plen);
    if (param == escape) {
      uint32_t rbps = br.read(5);
      for (int i = 0; i < n; i++)
        res.push_back(rbps ? br.read_signed(rbps) : 0);
    } else {
      for (int i = 0; i < n; i++) {
        uint32_t q = br.read_unary();
        uint32_t r = param ? br.read(param) : 0;
        uint64_t v = ((uint64_t)q << param) | r;
        res.push_back((int64_t)(v >> 1) ^ -(int64_t)(v & 1));
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read(1)) return false;  // padding bit must be 0
  uint32_t stype = br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = 1 + (int)br.read_unary();
  int eff = bps - wasted;
  if (eff <= 0 || br.error) return false;
  out.clear();
  out.reserve(blocksize);
  std::vector<int64_t> res;
  if (stype == 0) {  // CONSTANT
    int64_t v = br.read_signed(eff);
    out.assign(blocksize, v);
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out.push_back(br.read_signed(eff));
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    int order = stype - 8;
    if (order > kFixedOrderMax || order > blocksize) return false;
    for (int i = 0; i < order; i++) out.push_back(br.read_signed(eff));
    if (!read_residual(br, blocksize, order, res)) return false;
    const int64_t* c = kFixedCoefs[order];
    for (size_t i = 0; i < res.size(); i++) {
      int64_t acc = res[i];
      size_t t = i + order;
      for (int j = 0; j < order; j++) acc += c[j] * out[t - 1 - j];
      out.push_back(acc);
    }
  } else if (stype >= 32) {  // LPC
    int order = stype - 31;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out.push_back(br.read_signed(eff));
    uint32_t prec = br.read(4);
    if (prec == 15) return false;
    prec += 1;
    int64_t shift = br.read_signed(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; i++) coefs[i] = br.read_signed(prec);
    if (!read_residual(br, blocksize, order, res)) return false;
    for (size_t i = 0; i < res.size(); i++) {
      int64_t acc = 0;
      size_t t = i + order;
      for (int j = 0; j < order; j++) acc += coefs[j] * out[t - 1 - j];
      out.push_back(res[i] + (acc >> shift));
    }
  } else {
    return false;  // reserved
  }
  if (br.error) return false;
  if (wasted)
    for (auto& v : out) v <<= wasted;
  return true;
}

const int kBlocksizeCodes[16] = {0,   192,  576,  1152, 2304, 4608, -1, -2,
                                 256, 512,  1024, 2048, 4096, 8192,
                                 16384, 32768};

struct StreamInfo {
  int64_t total_samples = 0;
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  int64_t frame_offset = 0;
};

bool parse_streaminfo(const uint8_t* data, int64_t size, StreamInfo* si) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return false;
  BitReader br{data, size, 4};
  bool have = false;
  while (!br.error) {
    uint32_t last = br.read(1);
    uint32_t btype = br.read(7);
    uint32_t blen = br.read(24);
    if (br.error) return false;
    if (btype == 0) {
      br.read(16); br.read(16); br.read(24); br.read(24);
      si->sample_rate = (int)br.read(20);
      si->channels = (int)br.read(3) + 1;
      si->bps = (int)br.read(5) + 1;
      uint64_t hi = br.read(4), lo = br.read(32);
      si->total_samples = (int64_t)((hi << 32) | lo);
      for (int i = 0; i < 16; i++) br.read(8);
      have = true;
    } else {
      if (br.pos + blen > size) return false;
      br.pos += blen;
    }
    if (last) break;
  }
  si->frame_offset = br.pos;
  return have && !br.error;
}

// Decode one frame; appends interleaved samples. Returns blocksize, -1
// for a malformed frame or -2 for a CRC mismatch.
int decode_frame(BitReader& br, const StreamInfo& si,
                 std::vector<int32_t>& pcm) {
  const int64_t start = br.byte_pos();
  if (br.read(14) != 0x3FFE) return -1;
  if (br.read(1)) return -1;
  br.read(1);  // blocking strategy
  uint32_t bs_code = br.read(4);
  uint32_t sr_code = br.read(4);
  uint32_t ch_code = br.read(4);
  uint32_t ss_code = br.read(3);
  if (br.read(1)) return -1;
  uint64_t num;
  if (!read_utf8_number(br, &num)) return -1;
  int blocksize;
  if (bs_code == 0) return -1;
  else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
  else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
  else blocksize = kBlocksizeCodes[bs_code];
  if (sr_code == 12) br.read(8);
  else if (sr_code == 13 || sr_code == 14) br.read(16);
  int bps;
  switch (ss_code) {
    case 0: bps = si.bps; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }
  const int64_t header_end = br.byte_pos();
  const uint32_t crc8 = br.read(8);
  if (br.error || blocksize <= 0) return -1;
  if (crc8 != crc(br.data + start, header_end - start, 8, 0x07)) return -2;

  std::vector<std::vector<int64_t>> chans;
  if (ch_code < 8) {
    int nch = (int)ch_code + 1;
    if (nch != si.channels) return -1;
    chans.resize(nch);
    for (int c = 0; c < nch; c++)
      if (!decode_subframe(br, blocksize, bps, chans[c])) return -1;
  } else if (ch_code <= 10) {
    if (si.channels != 2) return -1;
    chans.resize(2);
    std::vector<int64_t> a, s;
    if (ch_code == 8) {  // left/side
      if (!decode_subframe(br, blocksize, bps, a)) return -1;
      if (!decode_subframe(br, blocksize, bps + 1, s)) return -1;
      chans[0] = a;
      chans[1].resize(blocksize);
      for (int i = 0; i < blocksize; i++) chans[1][i] = a[i] - s[i];
    } else if (ch_code == 9) {  // right/side
      if (!decode_subframe(br, blocksize, bps + 1, s)) return -1;
      if (!decode_subframe(br, blocksize, bps, a)) return -1;
      chans[1] = a;
      chans[0].resize(blocksize);
      for (int i = 0; i < blocksize; i++) chans[0][i] = a[i] + s[i];
    } else {  // mid/side
      if (!decode_subframe(br, blocksize, bps, a)) return -1;
      if (!decode_subframe(br, blocksize, bps + 1, s)) return -1;
      chans[0].resize(blocksize);
      chans[1].resize(blocksize);
      for (int i = 0; i < blocksize; i++) {
        int64_t m = (a[i] << 1) | (s[i] & 1);
        chans[0][i] = (m + s[i]) >> 1;
        chans[1][i] = (m - s[i]) >> 1;
      }
    }
  } else {
    return -1;
  }
  br.align();
  const int64_t frame_end = br.byte_pos();
  const uint32_t crc16 = br.read(16);
  if (br.error) return -1;
  if (crc16 != crc(br.data + start, frame_end - start, 16, 0x8005)) return -2;
  size_t nch = chans.size();
  size_t base = pcm.size();
  pcm.resize(base + (size_t)blocksize * nch);
  for (int i = 0; i < blocksize; i++)
    for (size_t c = 0; c < nch; c++)
      pcm[base + (size_t)i * nch + c] = (int32_t)chans[c][i];
  return blocksize;
}

}  // namespace

extern "C" {

int64_t asr_flac_info(const uint8_t* data, int64_t size, int64_t* info) {
  StreamInfo si;
  if (!parse_streaminfo(data, size, &si)) return -1;
  info[0] = si.total_samples;
  info[1] = si.sample_rate;
  info[2] = si.channels;
  info[3] = si.bps;
  info[4] = si.frame_offset;
  return 0;
}

int64_t asr_flac_decode(const uint8_t* data, int64_t size, int32_t* out,
                        int64_t capacity) {
  StreamInfo si;
  if (!parse_streaminfo(data, size, &si)) return -1;
  BitReader br{data, size, si.frame_offset};
  std::vector<int32_t> pcm;
  if (si.total_samples > 0)
    pcm.reserve((size_t)si.total_samples * si.channels);
  int64_t got = 0;
  while ((si.total_samples == 0 || got < si.total_samples) && !br.at_end()) {
    int n = decode_frame(br, si, pcm);
    if (n == -2) return -4;
    if (n < 0) return -2;
    got += n;
  }
  if (si.total_samples > 0 && got > si.total_samples) {
    got = si.total_samples;
    pcm.resize((size_t)got * si.channels);
  }
  if ((int64_t)pcm.size() > capacity) return -3;
  memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  return got;
}

}  // extern "C"
