// KenLM binary model readers (PROBING + TRIE/QUANT_TRIE) for the
// native LM-fused prefix beam search. C++ twin of
// audio8_tpu/ops/kenlm_bin.py (same published format-version-5
// layouts, differential-tested against it); completes the reference's
// ctcdecode+KenLM-binary decode path natively
// (the reference audio8 ctc.py:22-30). The file is mmap'd and scored
// in place. PROBING: murmur-hashed vocab probing table, direct-indexed
// unigram ProbBackoff array, CombineWordHash-keyed linear-probing
// tables for the middle orders and the longest order. TRIE
// (lm/search_trie.cc, lm/trie.hh): hash-sorted vocab, reversed-n-gram
// bit-packed per-order sorted arrays walked predicted-word-first, with
// optional SeparatelyQuantize center tables (lm/quantize.hh).
//
// On any structural mismatch (bad magic, sanity reference values,
// unsupported model type, section layout inconsistent with the file
// size) the loader returns nullptr — callers fall back to the Python
// reader, whose errors name the fix (ops/kenlm_bin.py).
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "lm_iface.h"

namespace {

constexpr double kLn10 = 2.302585092994046;

const char kMagic[] = "mmap lm http://kheafield.com/code format version 5\n";
// sizeof in C counts the implicit NUL (53), aligned up to 56 on disk.
constexpr size_t kMagicField = 56;

inline size_t Align8(size_t n) { return (n + 7) / 8 * 8; }

inline uint64_t LoadU64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t LoadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline float LoadF32(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

// MurmurHash64A (Appleby), seed 0 — kenlm's portable vocab word hash.
uint64_t Murmur64A(const void* key, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ull;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const auto* data = static_cast<const uint8_t*>(key);
  const size_t n8 = len / 8 * 8;
  for (size_t i = 0; i < n8; i += 8) {
    uint64_t k = LoadU64(data + i);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  const uint8_t* tail = data + n8;
  switch (len & 7) {
    case 7: h ^= static_cast<uint64_t>(tail[6]) << 48; [[fallthrough]];
    case 6: h ^= static_cast<uint64_t>(tail[5]) << 40; [[fallthrough]];
    case 5: h ^= static_cast<uint64_t>(tail[4]) << 32; [[fallthrough]];
    case 4: h ^= static_cast<uint64_t>(tail[3]) << 24; [[fallthrough]];
    case 3: h ^= static_cast<uint64_t>(tail[2]) << 16; [[fallthrough]];
    case 2: h ^= static_cast<uint64_t>(tail[1]) << 8; [[fallthrough]];
    case 1: h ^= static_cast<uint64_t>(tail[0]); h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// kenlm lm/search_hashed.hh CombineWordHash.
inline uint64_t CombineWordHash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ull) ^
         ((1ull + next) * 17894857484156487943ull);
}

// util/probing_hash_table.hh Size(): replicate kenlm's float32
// arithmetic exactly so section offsets match byte-for-byte. Returns
// false (instead of invoking float->uint64 conversion UB or wrapping
// entries+1 to 0) when a corrupt/crafted counts[] would produce a
// bucket count above `limit` — callers pass the file size, since every
// bucket occupies >= 8 bytes and a larger table cannot possibly fit.
inline bool BucketsChecked(uint64_t entries, float multiplier,
                           uint64_t limit, uint64_t* out) {
  if (entries >= limit) return false;  // also rules out entries+1 wrap
  const double scaled_d =
      static_cast<double>(multiplier) * static_cast<double>(
          static_cast<float>(entries));
  if (!(scaled_d >= 0.0) || scaled_d > static_cast<double>(limit))
    return false;
  const uint64_t scaled =
      static_cast<uint64_t>(multiplier * static_cast<float>(entries));
  *out = entries + 1 > scaled ? entries + 1 : scaled;
  return *out > 0 && *out <= limit;
}

// Shared skeleton: owns the mmap and implements kenlm's backoff chain
// over a format-specific exact-n-gram lookup.
struct BackoffBinaryLm : public Lm {
  const uint8_t* base = nullptr;
  size_t size = 0;
  int fd = -1;

  ~BackoffBinaryLm() override {
    if (base != nullptr) munmap(const_cast<uint8_t*>(base), size);
    if (fd >= 0) close(fd);
  }

  // (prob10, backoff10) of the exact n-gram ctx+word, or false.
  // ctx_len == 0 (unigram) must always succeed: rows exist for every
  // id either reader hands out.
  virtual bool Find(const int32_t* ctx, int ctx_len, int32_t word,
                    float* p, float* b) const = 0;

  float LogP(int32_t word, const int32_t* ctx, int ctx_len) const override {
    if (word < 0) word = 0;  // OOV -> <unk>, kenlm semantics
    if (ctx_len > order - 1) {
      ctx += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    double acc = 0.0;
    float p, b;
    while (true) {
      if (Find(ctx, ctx_len, word, &p, &b)) return (acc + p) * kLn10;
      // ctx_len == 0 always resolves above (unigram is an array), so
      // reaching here implies ctx_len >= 1: add the backoff weight of
      // the context n-gram ctx[0..ctx_len) itself (its last word
      // conditioned on the preceding ones), then drop the oldest word.
      if (Find(ctx, ctx_len - 1, ctx[ctx_len - 1], &p, &b)) acc += b;
      ++ctx;
      --ctx_len;
    }
  }
};

struct KenLmBinary : public BackoffBinaryLm {
  const uint8_t* vocab_tab = nullptr;  // 12-byte (u64 key, u32 id) entries
  uint64_t vocab_buckets = 0;
  uint64_t vocab_bound = 0;            // counts[0] + 1 (unigram rows)
  const uint8_t* unigram = nullptr;    // (f32 prob, f32 backoff) per id
  std::vector<const uint8_t*> middles;  // 16-byte (u64, f32, f32) entries
  std::vector<uint64_t> middle_buckets;
  const uint8_t* longest = nullptr;    // 12-byte (u64 key, f32 prob) entries
  uint64_t longest_buckets = 0;

  int32_t Lookup(const std::string& w) const override {
    const uint64_t key = Murmur64A(w.data(), w.size());
    uint64_t i = key % vocab_buckets;
    // probe count bounded by the table size: a corrupt table saturated
    // with nonzero non-matching keys must resolve as OOV, not hang the
    // linear probe forever (reachable at load time via the vocab
    // spot-check)
    for (uint64_t n = 0; n < vocab_buckets; ++n) {
      const uint64_t k = LoadU64(vocab_tab + i * 12);
      if (k == key) {
        const uint32_t id = LoadU32(vocab_tab + i * 12 + 8);
        // a corrupt table must not hand out ids past the unigram array
        return id < vocab_bound ? static_cast<int32_t>(id) : -1;
      }
      if (k == 0) return -1;  // OOV; callers substitute unk_id (= 0)
      i = (i + 1) % vocab_buckets;
    }
    return -1;
  }

  bool Find(const int32_t* ctx, int ctx_len, int32_t word, float* p,
            float* b) const override {
    if (ctx_len == 0) {  // unigram rows exist for every id structurally
      *p = LoadF32(unigram + word * 8);
      *b = LoadF32(unigram + word * 8 + 4);
      return true;
    }
    uint64_t key = static_cast<uint32_t>(word);
    for (int i = ctx_len - 1; i >= 0; --i)
      key = CombineWordHash(key, static_cast<uint32_t>(ctx[i]));
    if (key == 0) return false;  // collides with the empty-bucket marker
    const int n = ctx_len + 1;
    const uint8_t* tab;
    uint64_t buckets;
    size_t stride, prob_off;
    bool has_backoff;
    if (n == order) {
      tab = longest;
      buckets = longest_buckets;
      stride = 12;
      prob_off = 8;
      has_backoff = false;
    } else {
      tab = middles[n - 2];
      buckets = middle_buckets[n - 2];
      stride = 16;
      prob_off = 8;
      has_backoff = true;
    }
    uint64_t i = key % buckets;
    // bounded like Lookup: a saturated corrupt table means not-found,
    // never an infinite probe
    for (uint64_t n = 0; n < buckets; ++n) {
      const uint64_t k = LoadU64(tab + i * stride);
      if (k == key) {
        *p = LoadF32(tab + i * stride + prob_off);
        *b = has_backoff ? LoadF32(tab + i * stride + prob_off + 4) : 0.0f;
        return true;
      }
      if (k == 0) return false;
      i = (i + 1) % buckets;
    }
    return false;
  }
};

// --- TRIE / QUANT_TRIE -----------------------------------------------

// util/bit_packing.hh ReadInt57 semantics on little-endian: shift the
// 64-bit window at byte (bit >> 3) right by (bit & 7). Every bit-packed
// section carries kenlm's +8 tail slack, so the window never runs past
// its section.
inline uint64_t ReadBits(const uint8_t* sec, uint64_t bit, uint8_t nbits) {
  uint64_t window;
  std::memcpy(&window, sec + (bit >> 3), 8);
  return (window >> (bit & 7)) &
         (nbits >= 64 ? ~0ull : ((1ull << nbits) - 1));
}

constexpr uint32_t kSignBit = 0x80000000u;

inline float F32FromBits(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint8_t RequiredBits(uint64_t max_value) {
  uint8_t ret = 0;
  while (max_value) {
    ++ret;
    max_value >>= 1;
  }
  return ret;
}

struct TrieLevel {
  const uint8_t* sec = nullptr;
  uint64_t count = 0;
  uint32_t total_bits = 0;
  uint8_t word_bits = 0;
  // Unquantized: prob is a sign-stripped float31, backoff a float32.
  // Quantized: prob/backoff are center-table indices.
  const float* prob_table = nullptr;     // null -> float31
  uint8_t prob_bits = 31;
  const float* backoff_table = nullptr;  // null -> float32
  uint8_t backoff_bits = 32;
  bool has_backoff = true;               // longest level has none
  uint32_t next_off = 0;                 // bit offset of the child ptr
  uint8_t next_bits = 0;

  uint64_t Word(uint64_t idx) const {
    return ReadBits(sec, idx * total_bits, word_bits);
  }
  uint64_t Next(uint64_t idx) const {
    return ReadBits(sec, idx * total_bits + next_off, next_bits);
  }
  void Values(uint64_t idx, float* p, float* b) const {
    uint64_t bit = idx * total_bits + word_bits;
    if (prob_table == nullptr) {
      *p = F32FromBits(
          static_cast<uint32_t>(ReadBits(sec, bit, 31)) | kSignBit);
      bit += 31;
    } else {
      *p = prob_table[ReadBits(sec, bit, prob_bits)];
      bit += prob_bits;
    }
    if (!has_backoff) {
      *b = 0.0f;
    } else if (backoff_table == nullptr) {
      *b = F32FromBits(static_cast<uint32_t>(ReadBits(sec, bit, 32)));
    } else {
      *b = backoff_table[ReadBits(sec, bit, backoff_bits)];
    }
  }
};

struct TrieKenLm : public BackoffBinaryLm {
  const uint64_t* vocab_hashes = nullptr;  // sorted, ids are pos + 1
  uint64_t n_vocab = 0;
  const uint8_t* unigram = nullptr;  // 16-byte (f32, f32, u64 next) rows
  std::vector<TrieLevel> levels;     // orders 2..N (last = longest)

  int32_t Lookup(const std::string& w) const override {
    const uint64_t key = Murmur64A(w.data(), w.size());
    const uint64_t* end = vocab_hashes + n_vocab;
    const uint64_t* it = std::lower_bound(vocab_hashes, end, key);
    if (it != end && *it == key)
      return static_cast<int32_t>(it - vocab_hashes) + 1;
    return -1;  // OOV; callers substitute unk_id (= 0)
  }

  // Walk the reversed path: unigram of the newest word, then context
  // words newest to oldest (lm/model.cc ScoreExceptBackoff order).
  bool Find(const int32_t* ctx, int ctx_len, int32_t word, float* p,
            float* b) const override {
    const uint8_t* row = unigram + static_cast<uint64_t>(word) * 16;
    if (ctx_len == 0) {
      *p = LoadF32(row);
      *b = LoadF32(row + 4);
      return true;
    }
    uint64_t begin = LoadU64(row + 8);
    uint64_t end = LoadU64(row + 24);
    for (int depth = 0; depth < ctx_len; ++depth) {
      const TrieLevel& t = levels[depth];
      const uint64_t want = static_cast<uint64_t>(
          static_cast<uint32_t>(ctx[ctx_len - 1 - depth]));
      // binary search `want` in the word-sorted range [begin, end)
      uint64_t lo = begin, hi = end, at = ~0ull;
      while (lo < hi) {
        const uint64_t mid = lo + (hi - lo) / 2;
        const uint64_t wv = t.Word(mid);
        if (wv < want) {
          lo = mid + 1;
        } else if (wv > want) {
          hi = mid;
        } else {
          at = mid;
          break;
        }
      }
      if (at == ~0ull) return false;
      if (depth == ctx_len - 1) {
        t.Values(at, p, b);
        return true;
      }
      begin = t.Next(at);
      end = t.Next(at + 1);
    }
    return false;  // unreachable
  }
};

// Python-split semantics for the trailing vocab-string section
// (ops/kenlm_bin.py KenLMBinaryLM.__init__): segments between NULs,
// trailing empty segments (zero padding) dropped. Both readers must
// agree on accept/refuse, and the native one is tried first.
uint64_t CountVocabWords(const uint8_t* tail, uint64_t len) {
  uint64_t last_nonzero = 0;
  bool any = false;
  for (uint64_t i = 0; i < len; ++i)
    if (tail[i] != 0) { last_nonzero = i; any = true; }
  if (!any) return 0;
  // kept segments = NULs strictly before the last nonzero byte, plus
  // the segment holding that byte itself
  uint64_t n = 1;
  for (uint64_t i = 0; i < last_nonzero; ++i) n += (tail[i] == 0);
  return n;
}

// Byte range of NUL-separated segment `wid` of the id-ordered strings.
bool VocabSegment(const uint8_t* tail, uint64_t len, uint64_t wid,
                  const uint8_t** seg, uint64_t* seg_len) {
  uint64_t idx = 0, start = 0;
  for (uint64_t i = 0; i <= len; ++i) {
    if (i == len || tail[i] == 0) {
      if (idx == wid) {
        *seg = tail + start;
        *seg_len = i - start;
        return true;
      }
      ++idx;
      start = i + 1;
    }
  }
  return false;
}

}  // namespace

extern "C" void* a8t_lm_load_kenlm(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  const size_t size = static_cast<size_t>(st.st_size);
  void* mem = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  const auto* base = static_cast<const uint8_t*>(mem);
  auto fail = [&]() -> void* {
    munmap(mem, size);
    close(fd);
    return nullptr;
  };

  // Sanity struct: magic[56], 3 reference floats, 2 word indices, u64.
  const size_t sanity_size = Align8(kMagicField + 12 + 8) + 8;  // 88
  if (size < sanity_size + 20) return fail();
  if (std::memcmp(base, kMagic, sizeof(kMagic) - 1) != 0) return fail();
  const uint8_t* s = base + kMagicField;
  if (LoadF32(s) != 0.0f || LoadF32(s + 4) != 1.0f ||
      LoadF32(s + 8) != -0.5f || LoadU32(s + 12) != 1 ||
      LoadU32(s + 16) != 0xFFFFFFFFu || LoadU64(s + 24) != 1)
    return fail();

  // FixedWidthParameters: order u8, multiplier f32, model_type i32,
  // has_vocabulary bool, search_version u32.
  const uint8_t* fx = base + sanity_size;
  const int order = fx[0];
  const float multiplier = LoadF32(fx + 4);
  const int32_t model_type = static_cast<int32_t>(LoadU32(fx + 8));
  const bool has_vocab = fx[12] != 0;
  const uint32_t search_version = LoadU32(fx + 16);
  const bool is_probing = model_type == 0;
  const bool is_trie = model_type == 2 || model_type == 3;
  if (!(is_probing || is_trie) || order < 1 || (is_trie && order < 2))
    return fail();
  // kenlm bumps the per-search layout version on change: HashedSearch
  // kVersion 0, TrieSearch kVersion 1 — an unknown version means an
  // unknown layout, refuse rather than guess.
  if (search_version != (is_probing ? 0u : 1u)) return fail();
  if (is_probing && (!(multiplier > 1.0f) || !(multiplier < 1e6f)))
    return fail();
  const size_t counts_off = sanity_size + 20;
  if (size < counts_off + 8 * order) return fail();
  std::vector<uint64_t> counts(order);
  // sane ceiling before any section math can wrap (a crafted counts[]
  // must fail loudly, not pass need() via uint64 overflow and read out
  // of the mmap): a PROBING entry occupies >= 8 bytes; a (quantized)
  // trie entry can be as small as ~2 bits, so allow 4 entries/byte
  // there. The per-section need() checks do the exact validation.
  const uint64_t count_limit =
      is_probing ? size / 8 : static_cast<uint64_t>(size) * 4;
  for (int i = 0; i < order; ++i) {
    counts[i] = LoadU64(base + counts_off + 8 * i);
    if (counts[i] == 0 || counts[i] > count_limit) return fail();
  }

  uint64_t off = Align8(counts_off + 8 * order);
  // overflow-checked "section of n entries x stride bytes fits at off"
  auto need = [&](uint64_t entries, uint64_t stride) {
    uint64_t bytes, end;
    if (__builtin_mul_overflow(entries, stride, &bytes)) return false;
    if (__builtin_add_overflow(off, bytes, &end)) return false;
    return end <= size;
  };

  if (is_trie) {
    auto* lm = new TrieKenLm();
    lm->base = base;
    lm->size = size;
    lm->fd = fd;
    lm->order = order;
    lm->unk_id = 0;
    auto drop = [&]() -> void* {
      delete lm;  // unmaps + closes
      return nullptr;
    };
    // SortedVocabulary: u64 entry count (excl. <unk>), then counts[0]
    // hash slots (the last is zero slack when <unk> is in the ARPA).
    if (!need(1, 8) || !need(counts[0] + 1, 8)) return drop();
    lm->n_vocab = LoadU64(base + off);
    if (lm->n_vocab + 1 < counts[0] || lm->n_vocab > counts[0])
      return drop();
    lm->vocab_hashes = reinterpret_cast<const uint64_t*>(base + off + 8);
    for (uint64_t i = 1; i < lm->n_vocab; ++i)
      if (lm->vocab_hashes[i - 1] >= lm->vocab_hashes[i]) return drop();
    off += 8 + 8 * counts[0];
    const uint64_t str_bound = lm->n_vocab + 1;

    // Quant center tables (QUANT_TRIE): u8 prob_bits, u8 backoff_bits,
    // 6 pad, then per middle order a prob + backoff f32 table and the
    // longest order's prob table (lm/quantize.hh SeparatelyQuantize).
    uint8_t prob_bits = 31, backoff_bits = 32;
    std::vector<std::pair<const float*, const float*>> mid_tabs;
    const float* long_tab = nullptr;
    if (model_type == 3) {
      if (!need(1, 8)) return drop();
      prob_bits = base[off];
      backoff_bits = base[off + 1];
      if (prob_bits < 1 || prob_bits > 25 || backoff_bits < 1 ||
          backoff_bits > 25)
        return drop();
      off += 8;
      for (int m = 2; m < order; ++m) {
        if (!need(1ull << prob_bits, 4) ) return drop();
        const float* pt = reinterpret_cast<const float*>(base + off);
        off += 4ull << prob_bits;
        if (!need(1ull << backoff_bits, 4)) return drop();
        const float* bt = reinterpret_cast<const float*>(base + off);
        off += 4ull << backoff_bits;
        mid_tabs.emplace_back(pt, bt);
      }
      if (!need(1ull << prob_bits, 4)) return drop();
      long_tab = reinterpret_cast<const float*>(base + off);
      off += 4ull << prob_bits;
    }

    // Unigram: (f32 prob, f32 backoff, u64 next) x (counts[0] + 2).
    if (!need(counts[0] + 2, 16)) return drop();
    lm->unigram = base + off;
    off += (counts[0] + 2) * 16;

    // Bit-packed middle arrays (orders 2..N-1) and the longest array.
    const uint8_t word_bits = RequiredBits(counts[0]);
    for (int m = 2; m <= order; ++m) {
      TrieLevel t;
      t.count = counts[m - 1];
      t.word_bits = word_bits;
      const bool longest = m == order;
      if (model_type == 3) {
        t.prob_table = longest ? long_tab : mid_tabs[m - 2].first;
        t.prob_bits = prob_bits;
        t.backoff_table = longest ? nullptr : mid_tabs[m - 2].second;
        t.backoff_bits = backoff_bits;
      }
      const uint32_t qw = longest
          ? (model_type == 3 ? prob_bits : 31)
          : (model_type == 3 ? uint32_t(prob_bits) + backoff_bits : 63u);
      t.has_backoff = !longest;
      t.next_bits = longest ? 0 : RequiredBits(counts[m]);
      t.next_off = word_bits + qw;
      t.total_bits = word_bits + qw + t.next_bits;
      const uint64_t nbytes =
          ((t.count + 1) * t.total_bits + 7) / 8 + 8;
      if (!need(nbytes, 1)) return drop();
      t.sec = base + off;
      off += nbytes;
      lm->levels.push_back(t);
    }
    // Load-time structural validation of everything the query walk
    // will trust — a corrupt child pointer must refuse here, not read
    // gigabytes past the mmap inside a binary search; a corrupt word
    // ordering must refuse, not silently mis-score via a missed match.
    {
      uint64_t prev = LoadU64(lm->unigram + 8);
      for (uint64_t id = 1; id <= str_bound; ++id) {
        const uint64_t nx = LoadU64(lm->unigram + id * 16 + 8);
        if (nx < prev) return drop();
        prev = nx;
      }
      if (prev != counts[1]) return drop();
    }
    for (int m = 2; m <= order; ++m) {
      const TrieLevel& t = lm->levels[m - 2];
      if (t.next_bits) {  // child pointers: nondecreasing partition
        uint64_t prev = t.Next(0);
        for (uint64_t i = 1; i <= t.count; ++i) {
          const uint64_t nx = t.Next(i);
          if (nx < prev) return drop();
          prev = nx;
        }
        if (prev != counts[m]) return drop();
      }
      // branching words: strictly ascending within each node's child
      // range (the binary search's invariant), ids within the vocab
      auto range_ok = [&](uint64_t begin, uint64_t end) {
        if (begin > end || end > t.count) return false;
        uint64_t prev_w = ~0ull;
        for (uint64_t i = begin; i < end; ++i) {
          const uint64_t w = t.Word(i);
          if (w > counts[0]) return false;
          if (prev_w != ~0ull && w <= prev_w) return false;
          prev_w = w;
        }
        return true;
      };
      if (m == 2) {
        for (uint64_t id = 0; id < str_bound; ++id) {
          if (!range_ok(LoadU64(lm->unigram + id * 16 + 8),
                        LoadU64(lm->unigram + (id + 1) * 16 + 8)))
            return drop();
        }
      } else {
        const TrieLevel& p = lm->levels[m - 3];
        for (uint64_t i = 0; i < p.count; ++i) {
          if (!range_ok(p.Next(i), p.Next(i + 1))) return drop();
        }
      }
    }
    if (!has_vocab && off != size) return drop();
    if (has_vocab && off < size) {
      // Mirror the Python reader's exact checks (ops/kenlm_bin.py
      // KenLMBinaryLM.__init__): exactly str_bound NUL-terminated
      // words, and a hash round-trip spot-check — a section-layout
      // shortfall absorbed into the string tail must refuse here too,
      // not load natively while the Python reader refuses it.
      const uint8_t* tail = base + off;
      const uint64_t tail_len = size - off;
      if (CountVocabWords(tail, tail_len) != str_bound) return drop();
      if (str_bound > 1) {
        // trie word ids are assigned in sorted-hash order, so word
        // wid's string must hash to vocab_hashes[wid - 1]
        const uint64_t wids[3] = {1, str_bound / 2, str_bound - 1};
        for (uint64_t wid : wids) {
          if (wid < 1) continue;
          const uint8_t* seg;
          uint64_t seg_len;
          if (!VocabSegment(tail, tail_len, wid, &seg, &seg_len))
            return drop();
          if (Murmur64A(seg, seg_len) != lm->vocab_hashes[wid - 1])
            return drop();
        }
      }
    }
    return static_cast<Lm*>(lm);
  }

  auto* lm = new KenLmBinary();
  lm->base = base;
  lm->size = size;
  lm->fd = fd;
  lm->order = order;
  lm->unk_id = 0;
  lm->vocab_bound = counts[0] + 1;

  // Vocab: u64 bound header + probing table of counts[0] entries.
  if (!need(1, 8)) { delete lm; return nullptr; }
  const uint64_t str_bound = LoadU64(base + off);  // highest word id + 1
  if (str_bound > counts[0] + 1) { delete lm; return nullptr; }
  off += 8;
  if (!BucketsChecked(counts[0], multiplier, size, &lm->vocab_buckets) ||
      !need(lm->vocab_buckets, 12)) { delete lm; return nullptr; }
  lm->vocab_tab = base + off;
  off += lm->vocab_buckets * 12;

  // Unigram: counts[0] + 1 ProbBackoff rows.
  if (!need(counts[0] + 1, 8)) { delete lm; return nullptr; }
  lm->unigram = base + off;
  off += (counts[0] + 1) * 8;

  for (int n = 2; n < order; ++n) {
    uint64_t buckets;
    if (!BucketsChecked(counts[n - 1], multiplier, size, &buckets) ||
        !need(buckets, 16)) { delete lm; return nullptr; }
    lm->middles.push_back(base + off);
    lm->middle_buckets.push_back(buckets);
    off += buckets * 16;
  }
  if (order > 1) {
    if (!BucketsChecked(counts[order - 1], multiplier, size,
                        &lm->longest_buckets) ||
        !need(lm->longest_buckets, 12)) { delete lm; return nullptr; }
    lm->longest = base + off;
    off += lm->longest_buckets * 12;
  }
  if (!has_vocab && off != size) { delete lm; return nullptr; }
  // has_vocab: mirror the Python reader's exact checks (ops/kenlm_bin.py
  // KenLMBinaryLM.__init__) — exactly str_bound NUL-terminated words
  // plus a hash round-trip spot-check through the probing table. A
  // section-layout shortfall under-running into the string area must
  // fail loudly here too, for consistent accept/refuse semantics.
  if (has_vocab && off < size) {
    const uint8_t* tail = base + off;
    const uint64_t tail_len = size - off;
    if (CountVocabWords(tail, tail_len) != str_bound) {
      delete lm;
      return nullptr;
    }
    if (str_bound > 1) {
      const uint64_t wids[3] = {1, str_bound / 2, str_bound - 1};
      for (uint64_t wid : wids) {
        if (wid < 1) continue;
        const uint8_t* seg;
        uint64_t seg_len;
        bool ok = VocabSegment(tail, tail_len, wid, &seg, &seg_len);
        if (ok) {
          const int32_t id = lm->Lookup(std::string(
              reinterpret_cast<const char*>(seg), seg_len));
          ok = id == static_cast<int32_t>(wid);
        }
        if (!ok) {
          delete lm;
          return nullptr;
        }
      }
    }
  }
  return static_cast<Lm*>(lm);
}
