// CTC prefix beam search (Hannun et al. 2014) over (T, V) log-probs.
// Native replacement for the ctcdecode C++ decoder the reference wraps
// (the reference audio8 ctc.py:11-60): blank-aware prefix merging,
// top-K symbol pruning per frame, word-insertion bonus `beta` counted at
// `space_idx` boundaries (LM fusion hook kept host-side). Prefixes live in
// a trie so beam states are O(1) to extend and compare.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kLog0 = -1e30;

inline double LogAdd(double a, double b) {
  if (a < b) std::swap(a, b);
  if (b <= kLog0 / 2) return a;
  return a + std::log1p(std::exp(b - a));
}

struct TrieNode {
  int32_t parent;   // index into trie, -1 for root
  int32_t sym;      // symbol extending the parent
  int32_t n_words;  // number of completed words (space count)
};

struct Cand {
  double p_b;   // prob of prefix ending in blank
  double p_nb;  // prob of prefix ending in non-blank
};

}  // namespace

extern "C" int64_t a8t_prefix_beam_search(
    const float* lp, int64_t T, int64_t V, int64_t blank, int64_t beam,
    int64_t space_idx, float /*alpha*/, float beta, int64_t n_best,
    int64_t* out_ids, int64_t* out_lens, int64_t out_stride) {
  std::vector<TrieNode> trie;
  trie.push_back({-1, -1, 0});  // root = empty prefix

  // child lookup: (node, sym) -> node
  std::unordered_map<int64_t, int32_t> children;
  auto child = [&](int32_t node, int32_t sym) -> int32_t {
    const int64_t key = (static_cast<int64_t>(node) << 20) | sym;
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    const int32_t idx = static_cast<int32_t>(trie.size());
    // a space completes a word only when it terminates a non-empty one:
    // leading/repeated spaces earn no insertion bonus (ctcdecode
    // semantics; parity with arpa_lm.cc's n_words and ops/beam.py)
    const bool ends_word = sym == space_idx && node != 0 &&
                           trie[node].sym != space_idx;
    const int32_t words = trie[node].n_words + (ends_word ? 1 : 0);
    trie.push_back({node, sym, words});
    children.emplace(key, idx);
    return idx;
  };

  std::unordered_map<int32_t, Cand> beams;
  beams[0] = {0.0f, kLog0};

  const int64_t k = std::min<int64_t>(V, std::max<int64_t>(beam, 16));
  std::vector<int32_t> order(V);
  std::vector<std::pair<double, int32_t>> scored;
  std::unordered_map<int32_t, Cand> next;

  for (int64_t t = 0; t < T; ++t) {
    const float* row = lp + t * V;
    // top-k symbols this frame
    for (int64_t v = 0; v < V; ++v) order[v] = static_cast<int32_t>(v);
    std::partial_sort(order.begin(), order.begin() + k, order.end(),
                      [&](int32_t a, int32_t b) { return row[a] > row[b]; });

    next.clear();
    for (const auto& [node, cand] : beams) {
      const double p_tot = LogAdd(cand.p_b, cand.p_nb);
      const int32_t last = trie[node].sym;
      {  // blank extends the same prefix
        Cand& nb = next.try_emplace(node, Cand{kLog0, kLog0}).first->second;
        nb.p_b = LogAdd(nb.p_b, p_tot + row[blank]);
      }
      for (int64_t i = 0; i < k; ++i) {
        const int32_t c = order[i];
        if (c == blank) continue;
        const double p_sym = row[c];
        if (c == last) {
          // repeat collapses into the same prefix unless preceded by blank
          Cand& same = next.try_emplace(node, Cand{kLog0, kLog0}).first->second;
          same.p_nb = LogAdd(same.p_nb, cand.p_nb + p_sym);
          const int32_t ext = child(node, c);
          Cand& nw = next.try_emplace(ext, Cand{kLog0, kLog0}).first->second;
          nw.p_nb = LogAdd(nw.p_nb, cand.p_b + p_sym);
        } else {
          const int32_t ext = child(node, c);
          Cand& nw = next.try_emplace(ext, Cand{kLog0, kLog0}).first->second;
          nw.p_nb = LogAdd(nw.p_nb, p_tot + p_sym);
        }
      }
    }
    // prune to beam width by score = p_tot + beta * n_words
    scored.clear();
    scored.reserve(next.size());
    for (const auto& [node, cand] : next) {
      const double score =
          LogAdd(cand.p_b, cand.p_nb) + beta * trie[node].n_words;
      scored.emplace_back(score, node);
    }
    const size_t keep = std::min<size_t>(beam, scored.size());
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b) { return a.first > b.first; });
    beams.clear();
    for (size_t i = 0; i < keep; ++i) beams[scored[i].second] = next[scored[i].second];
  }

  // rank final beams
  scored.clear();
  for (const auto& [node, cand] : beams) {
    scored.emplace_back(LogAdd(cand.p_b, cand.p_nb) + beta * trie[node].n_words,
                        node);
  }
  std::sort(scored.begin(), scored.end(),
            [](const auto& a, const auto& b) { return a.first > b.first; });

  const int64_t n_out = std::min<int64_t>(n_best, scored.size());
  std::vector<int64_t> seq;
  for (int64_t i = 0; i < n_out; ++i) {
    seq.clear();
    for (int32_t node = scored[i].second; node != 0; node = trie[node].parent)
      seq.push_back(trie[node].sym);
    std::reverse(seq.begin(), seq.end());
    const int64_t len = std::min<int64_t>(seq.size(), out_stride);
    out_lens[i] = len;
    std::memcpy(out_ids + i * out_stride, seq.data(), len * sizeof(int64_t));
  }
  return n_out;
}
