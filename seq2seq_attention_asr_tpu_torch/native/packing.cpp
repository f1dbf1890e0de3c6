// Batch packing on the host, the port's copy of
// seq2seq_attention_asr_tpu/native/packing.cpp (the same C ABI).
//
// The reference's data path is torch-hdf5's C library feeding one
// utterance at a time (timit/timit.lua:42-75). Here the hot host-side
// loop pads variable-length utterances into a bucket's batch buffers;
// this does the strided copies in C++ (data/batching.py's
// BucketedBatcher._pad_native; _pad_np is the numpy version).
//
// C ABI:
//   void asr_pack_batch(const float* src, const int64_t* offsets,
//                       const int64_t* lengths, const int64_t* select,
//                       int64_t batch, int64_t l_pad, int64_t dim,
//                       float* out, int64_t* out_len);
//   void asr_pack_labels(const int32_t* src, const int64_t* offsets,
//                        const int64_t* lengths, const int64_t* select,
//                        int64_t batch, int64_t t_pad, int32_t* out,
//                        int64_t* out_len);

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// src: ragged utterances concatenated along time; utterance u occupies
// rows [offsets[u], offsets[u] + lengths[u]) of width `dim`.
// select: which utterances go in this batch. out: (batch, l_pad, dim)
// zero-filled then copied; out_len: clamped true lengths.
void asr_pack_batch(const float* src, const int64_t* offsets,
                    const int64_t* lengths, const int64_t* select,
                    int64_t batch, int64_t l_pad, int64_t dim, float* out,
                    int64_t* out_len) {
  std::memset(out, 0, sizeof(float) * batch * l_pad * dim);
  for (int64_t i = 0; i < batch; ++i) {
    const int64_t u = select[i];
    const int64_t n = std::min(lengths[u], l_pad);
    std::memcpy(out + i * l_pad * dim, src + offsets[u] * dim,
                sizeof(float) * n * dim);
    out_len[i] = n;
  }
}

void asr_pack_labels(const int32_t* src, const int64_t* offsets,
                     const int64_t* lengths, const int64_t* select,
                     int64_t batch, int64_t t_pad, int32_t* out,
                     int64_t* out_len) {
  std::memset(out, 0, sizeof(int32_t) * batch * t_pad);
  for (int64_t i = 0; i < batch; ++i) {
    const int64_t u = select[i];
    const int64_t n = std::min(lengths[u], t_pad);
    std::memcpy(out + i * t_pad, src + offsets[u], sizeof(int32_t) * n);
    out_len[i] = n;
  }
}

}  // extern "C"
