// ARPA backoff n-gram language model + LM-fused CTC prefix beam search.
// Native completion of the reference's ctcdecode+KenLM decode path
// (the reference audio8 ctc.py:11-30): loads a (possibly gzipped is NOT
// supported here — plain-text ARPA) model, interns words, and scores
// completed words during the prefix search with weight alpha plus a
// word-insertion bonus beta. Mirrors audio8_tpu_torch/ops/lm.py semantics.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "lm_iface.h"

namespace {

constexpr double kLog0 = -1e30;
constexpr double kLn10 = 2.302585092994046;

inline double LogAdd(double a, double b) {
  if (a < b) std::swap(a, b);
  if (b <= kLog0 / 2) return a;
  return a + std::log1p(std::exp(b - a));
}

struct NgramKey {
  // packed word ids (up to 6-gram), FNV-hashed
  uint64_t hash;
  bool operator==(const NgramKey& o) const { return hash == o.hash; }
};

struct NgramKeyHash {
  size_t operator()(const NgramKey& k) const { return k.hash; }
};

uint64_t HashIds(const int32_t* ids, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(ids[i]) + 0x9e3779b97f4a7c15ull;
    h *= 1099511628211ull;
  }
  return h;
}

struct Arpa : public Lm {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<NgramKey, std::pair<float, float>, NgramKeyHash> ngrams;

  int32_t Intern(const std::string& w) {
    auto it = vocab.find(w);
    if (it != vocab.end()) return it->second;
    const int32_t id = static_cast<int32_t>(vocab.size());
    vocab.emplace(w, id);
    return id;
  }

  int32_t Lookup(const std::string& w) const override {
    auto it = vocab.find(w);
    return it != vocab.end() ? it->second : -1;
  }

  const std::pair<float, float>* Find(const int32_t* ids, int n) const {
    auto it = ngrams.find(NgramKey{HashIds(ids, n)});
    return it != ngrams.end() ? &it->second : nullptr;
  }

  // ln P(word | context) with standard backoff
  float LogP(int32_t word, const int32_t* ctx, int ctx_len) const override {
    if (ctx_len > order - 1) {
      ctx += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    float backoff_acc = 0.0f;
    while (true) {
      std::vector<int32_t> key(ctx, ctx + ctx_len);
      key.push_back(word);
      const auto* e = Find(key.data(), static_cast<int>(key.size()));
      if (e != nullptr) return backoff_acc + e->first;
      if (ctx_len == 0) {
        if (word != unk_id && unk_id >= 0) {
          int32_t u = unk_id;
          const auto* eu = Find(&u, 1);
          if (eu != nullptr) return backoff_acc + eu->first;
        }
        return backoff_acc + static_cast<float>(-100.0 * kLn10);
      }
      const auto* bo = Find(ctx, ctx_len);
      if (bo != nullptr) backoff_acc += bo->second;
      ++ctx;
      --ctx_len;
    }
  }
};

}  // namespace

extern "C" void* a8t_lm_load(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) return nullptr;
  auto* lm = new Arpa();
  char line[65536];
  int section = 0;
  while (fgets(line, sizeof(line), f)) {
    // strip trailing whitespace
    size_t len = strlen(line);
    while (len && (line[len - 1] == '\n' || line[len - 1] == '\r' ||
                   line[len - 1] == ' '))
      line[--len] = 0;
    if (len == 0) continue;
    if (line[0] == '\\') {
      if (strstr(line, "-grams:")) {
        section = atoi(line + 1);
        lm->order = std::max(lm->order, section);
      } else if (strcmp(line, "\\end\\") == 0) {
        break;
      }
      continue;
    }
    if (section == 0) continue;
    // fields: prob \t w1 [w2...] [\t backoff]  (whitespace-separated ok)
    std::vector<char*> tok;
    for (char* p = strtok(line, " \t"); p; p = strtok(nullptr, " \t"))
      tok.push_back(p);
    if (static_cast<int>(tok.size()) < section + 1) continue;
    const float prob = static_cast<float>(atof(tok[0]) * kLn10);
    std::vector<int32_t> ids(section);
    for (int i = 0; i < section; ++i) ids[i] = lm->Intern(tok[1 + i]);
    float backoff = 0.0f;
    if (static_cast<int>(tok.size()) > section + 1)
      backoff = static_cast<float>(atof(tok[section + 1]) * kLn10);
    lm->ngrams[NgramKey{HashIds(ids.data(), section)}] = {prob, backoff};
  }
  fclose(f);
  lm->unk_id = lm->Lookup("<unk>");
  return static_cast<Lm*>(lm);
}

extern "C" void a8t_lm_free(void* lm) { delete static_cast<Lm*>(lm); }

extern "C" float a8t_lm_logp(void* lm_ptr, const char* word,
                             const char* context /* space-separated */) {
  auto* lm = static_cast<Lm*>(lm_ptr);
  std::vector<int32_t> ctx;
  std::string s(context ? context : "");
  size_t pos = 0;
  while (pos < s.size()) {
    size_t sp = s.find(' ', pos);
    if (sp == std::string::npos) sp = s.size();
    if (sp > pos) {
      const int32_t id = lm->Lookup(s.substr(pos, sp - pos));
      ctx.push_back(id >= 0 ? id : lm->unk_id);
    }
    pos = sp + 1;
  }
  int32_t wid = lm->Lookup(word);
  if (wid < 0) wid = lm->unk_id >= 0 ? lm->unk_id : -2;
  return lm->LogP(wid, ctx.data(), static_cast<int>(ctx.size()));
}

// ---------------------------------------------------------------------------
// LM-fused prefix beam search. Mirrors beam.cc but each trie node carries
// an LM score and word context; completed words (at space_idx) are scored
// with weight alpha.

namespace {

struct TrieNodeLM {
  int32_t parent;
  int32_t sym;
  int32_t n_words;
  double lm_score;          // accumulated ln P of completed words
  std::vector<int32_t> ctx; // last (order-1) completed word ids
  std::string word;         // chars of the in-progress word
};

struct CandLM {
  double p_b;
  double p_nb;
};

}  // namespace

extern "C" int64_t a8t_prefix_beam_search_lm(
    const float* lp, int64_t T, int64_t V, int64_t blank, int64_t beam,
    int64_t space_idx, float alpha, float beta, int64_t n_best,
    const char* vocab_buf, const int64_t* vocab_offsets, void* lm_ptr,
    int64_t* out_ids, int64_t* out_lens, int64_t out_stride) {
  auto* lm = static_cast<Lm*>(lm_ptr);
  auto piece = [&](int32_t sym) -> std::string {
    const int64_t a = vocab_offsets[sym];
    const int64_t b = vocab_offsets[sym + 1];
    return std::string(vocab_buf + a, vocab_buf + b);
  };

  std::vector<TrieNodeLM> trie;
  trie.push_back({-1, -1, 0, 0.0, {}, ""});
  std::unordered_map<int64_t, int32_t> children;

  auto child = [&](int32_t node, int32_t sym) -> int32_t {
    const int64_t key = (static_cast<int64_t>(node) << 20) | sym;
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    const int32_t idx = static_cast<int32_t>(trie.size());
    TrieNodeLM n;
    n.parent = node;
    n.sym = sym;
    n.n_words = trie[node].n_words;
    n.lm_score = trie[node].lm_score;
    n.ctx = trie[node].ctx;
    n.word = trie[node].word;
    if (sym == space_idx) {
      if (!n.word.empty() && lm != nullptr) {
        int32_t wid = lm->Lookup(n.word);
        if (wid < 0) wid = lm->unk_id;
        if (wid >= 0) {
          n.lm_score += lm->LogP(wid, n.ctx.data(),
                                 static_cast<int>(n.ctx.size()));
          n.ctx.push_back(wid);
          const int keep = std::max(lm->order - 1, 0);
          if (static_cast<int>(n.ctx.size()) > keep)
            n.ctx.erase(n.ctx.begin(),
                        n.ctx.end() - keep);
        }
      }
      if (!n.word.empty()) ++n.n_words;
      n.word.clear();
    } else {
      n.word += piece(sym);
    }
    trie.push_back(std::move(n));
    children.emplace(key, idx);
    return idx;
  };

  std::unordered_map<int32_t, CandLM> beams;
  beams[0] = {0.0f, kLog0};
  const int64_t k = std::min<int64_t>(V, std::max<int64_t>(beam, 16));
  std::vector<int32_t> order(V);
  std::vector<std::pair<double, int32_t>> scored;
  std::unordered_map<int32_t, CandLM> next;

  auto rank = [&](int32_t node, const CandLM& c) -> double {
    return LogAdd(c.p_b, c.p_nb) + alpha * trie[node].lm_score +
           beta * trie[node].n_words;
  };

  for (int64_t t = 0; t < T; ++t) {
    const float* row = lp + t * V;
    for (int64_t v = 0; v < V; ++v) order[v] = static_cast<int32_t>(v);
    std::partial_sort(order.begin(), order.begin() + k, order.end(),
                      [&](int32_t a, int32_t b) { return row[a] > row[b]; });
    next.clear();
    for (const auto& [node, cand] : beams) {
      const double p_tot = LogAdd(cand.p_b, cand.p_nb);
      const int32_t last = trie[node].sym;
      CandLM& nb = next.try_emplace(node, CandLM{kLog0, kLog0}).first->second;
      nb.p_b = LogAdd(nb.p_b, p_tot + row[blank]);
      for (int64_t i = 0; i < k; ++i) {
        const int32_t c = order[i];
        if (c == blank) continue;
        const double p_sym = row[c];
        if (c == last) {
          CandLM& same = next.try_emplace(node, CandLM{kLog0, kLog0}).first->second;
          same.p_nb = LogAdd(same.p_nb, cand.p_nb + p_sym);
          const int32_t ext = child(node, c);
          CandLM& nw = next.try_emplace(ext, CandLM{kLog0, kLog0}).first->second;
          nw.p_nb = LogAdd(nw.p_nb, cand.p_b + p_sym);
        } else {
          const int32_t ext = child(node, c);
          CandLM& nw = next.try_emplace(ext, CandLM{kLog0, kLog0}).first->second;
          nw.p_nb = LogAdd(nw.p_nb, p_tot + p_sym);
        }
      }
    }
    scored.clear();
    scored.reserve(next.size());
    for (const auto& [node, cand] : next)
      scored.emplace_back(rank(node, cand), node);
    const size_t keep = std::min<size_t>(beam, scored.size());
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b) { return a.first > b.first; });
    beams.clear();
    for (size_t i = 0; i < keep; ++i) beams[scored[i].second] = next[scored[i].second];
  }

  scored.clear();
  for (const auto& [node, cand] : beams) scored.emplace_back(rank(node, cand), node);
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
