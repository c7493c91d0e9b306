// Levenshtein edit distance over int64 token sequences.
// Native replacement for the `editdistance` C++ package the reference uses
// for WER/CER (the reference audio8 ctc.py:76,94,141), exposed through a
// plain C ABI consumed via ctypes (audio8_tpu_torch/csrc/native.py).
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int64_t a8t_edit_distance(const int64_t* a, int64_t na,
                                     const int64_t* b, int64_t nb) {
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const int64_t ca = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}
