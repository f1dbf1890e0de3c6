// Levenshtein edit distance on the host, the port's copy of
// seq2seq_attention_asr_tpu/native/editdist.cpp (the same C ABI).
//
// Replaces the reference's Lua Wagner-Fischer scorer (utils.lua:3-27),
// which allocates an (m+1)x(n+1) tensor per utterance and loops in
// interpreted Lua. Decoding metrics (PER/CER) are host-side; this keeps
// corpus-level scoring off the Python interpreter. Two-row DP,
// O(min(m,n)) memory. decode/metrics.py::edit_distance_np is the numpy
// version of the same function.
//
// C ABI for ctypes:
//   int64_t asr_edit_distance(const int32_t* a, int64_t m,
//                             const int32_t* b, int64_t n);
//   void asr_batch_edit_distance(const int32_t* a, const int64_t* a_len,
//                                const int32_t* b, const int64_t* b_len,
//                                int64_t batch, int64_t a_stride,
//                                int64_t b_stride, int64_t* out);

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int64_t asr_edit_distance(const int32_t* a, int64_t m, const int32_t* b,
                          int64_t n) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (n > m) {  // keep the row short
    std::swap(a, b);
    std::swap(m, n);
  }
  std::vector<int64_t> row(n + 1);
  for (int64_t j = 0; j <= n; ++j) row[j] = j;
  for (int64_t i = 1; i <= m; ++i) {
    int64_t diag = row[0];  // d[i-1][j-1]
    row[0] = i;
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= n; ++j) {
      const int64_t up = row[j];  // d[i-1][j]
      const int64_t sub = diag + (b[j - 1] != ai);
      row[j] = std::min(sub, std::min(up, row[j - 1]) + 1);
      diag = up;
    }
  }
  return row[n];
}

// Padded batch scoring: a is (batch, a_stride), b is (batch, b_stride),
// true lengths in a_len/b_len; distances written to out[batch].
void asr_batch_edit_distance(const int32_t* a, const int64_t* a_len,
                             const int32_t* b, const int64_t* b_len,
                             int64_t batch, int64_t a_stride,
                             int64_t b_stride, int64_t* out) {
  for (int64_t i = 0; i < batch; ++i) {
    out[i] = asr_edit_distance(a + i * a_stride, a_len[i], b + i * b_stride,
                               b_len[i]);
  }
}

}  // extern "C"
