// Zstandard frame decoder (RFC 8878) and the checksums of Orbax
// checkpoints: CRC32C (Castagnoli) for OCDBT files, XXH64 for zstd's
// content checksum.
//
// The JAX package writes its checkpoints through tensorstore: OCDBT
// files whose bodies are zstd frames, holding zarr v2 chunks that are
// zstd frames again. This decoder reads them without a zstd library.
// It decodes every frame of its input (skippable frames are skipped):
// raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded with a
// table or treeless, in 1 or 4 streams; sequences with predefined, RLE,
// FSE-coded and repeated tables; repeat offsets. It checks the content
// size and the XXH64 content checksum when the frame carries them, and
// raises on a corrupt frame and on a dictionary ID (no dictionary is
// ever given). It decodes only: the port never compresses.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Corrupt(what); }

inline int high_bit(uint64_t v) { return 63 - __builtin_clzll(v); }

// Up to 8 bytes little-endian from p, of which `avail` exist.
inline uint64_t load_le(const uint8_t* p, int64_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
    return v;
  }
  for (int64_t i = 0; i < avail; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// Bits [off, off + n) of src, least significant first; bits past the end
// read as 0. n <= 56.
inline uint64_t bits_at(const uint8_t* src, int64_t len, int64_t off, int n) {
  if (n == 0) return 0;
  const int64_t byte = off >> 3;
  const uint64_t v = load_le(src + byte, len - byte) >> (off & 7);
  return v & ((uint64_t(1) << n) - 1);
}

// A bitstream read from its end towards its start (FSE and Huffman
// streams). `off` is the number of bits not yet read; reading past the
// start gives zeros and makes it negative.
struct BackwardBits {
  const uint8_t* src;
  int64_t len;
  int64_t off;
  BackwardBits(const uint8_t* s, int64_t n) : src(s), len(n) {
    if (n <= 0) fail("zstd: empty bitstream");
    const uint8_t last = s[n - 1];
    if (last == 0) fail("zstd: bitstream without its end mark");
    off = n * 8 - (8 - high_bit(last));
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    off -= n;
    if (off >= 0) return bits_at(src, len, off, n);
    const int64_t have = n + off;
    const uint64_t v = have > 0 ? bits_at(src, len, 0, int(have)) : 0;
    return -off >= 64 ? 0 : v << -off;
  }
};

struct FseTable {
  int log = 0;
  bool valid = false;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  uint32_t next[256];
  uint32_t high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      if (high == 0) fail("zstd: FSE table overfull");
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint32_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("zstd: FSE probabilities do not fill the table");
  for (uint32_t i = 0; i < size; ++i) {
    const uint32_t d = next[t.sym[i]]++;
    if (d == 0) fail("zstd: FSE state without a probability");
    const int nb = log - high_bit(d);
    if (nb < 0) fail("zstd: FSE state overflow");
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((d << nb) - size);
  }
  t.valid = true;
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.sym.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
  t.valid = true;
}

// An FSE table description (RFC 8878 4.1.1) -> its table; returns the
// bytes it took.
int64_t read_fse_header(const uint8_t* src, int64_t len, int max_log,
                        int max_sym, FseTable& t) {
  int64_t off = 0;
  auto rd = [&](int n) {
    const uint64_t v = bits_at(src, len, off, n);
    off += n;
    return uint32_t(v);
  };
  if (len < 1) fail("zstd: FSE table description past its block");
  const int log = 5 + int(rd(4));
  if (log > max_log) fail("zstd: FSE accuracy log too large");
  int32_t remaining = 1 << log;
  int16_t freq[256];
  int s = 0;
  while (remaining > 0 && s <= max_sym) {
    const int bits = high_bit(uint64_t(remaining) + 1) + 1;
    uint32_t val = rd(bits);
    const uint32_t lower = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      off -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    const int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[s++] = int16_t(proba);
    if (proba == 0) {
      uint32_t rep = rd(2);
      while (true) {
        for (uint32_t i = 0; i < rep; ++i) {
          if (s > max_sym) fail("zstd: FSE symbols past the alphabet");
          freq[s++] = 0;
        }
        if (rep != 3) break;
        rep = rd(2);
      }
    }
  }
  if (remaining != 0) fail("zstd: FSE probabilities do not sum up");
  const int64_t used = (off + 7) / 8;
  if (used > len) fail("zstd: FSE table description past its block");
  build_fse(t, freq, s, log);
  return used;
}

struct HufTable {
  int max_bits = 0;
  bool valid = false;
  std::vector<uint8_t> sym, nbits;
};

// A Huffman tree description (RFC 8878 4.2.1) -> its decoding table;
// returns the bytes it took.
int64_t read_huf_tree(const uint8_t* src, int64_t len, HufTable& h) {
  if (len < 1) fail("zstd: Huffman tree past its block");
  const uint8_t hb = src[0];
  uint8_t w[260];
  int nw = 0;
  int64_t used;
  if (hb >= 128) {
    nw = hb - 127;
    const int64_t nbytes = (nw + 1) / 2;
    if (1 + nbytes > len) fail("zstd: Huffman weights past their block");
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? b >> 4 : b & 15;
    }
    used = 1 + nbytes;
  } else {
    if (hb == 0 || 1 + int64_t(hb) > len)
      fail("zstd: Huffman weights past their block");
    const uint8_t* p = src + 1;
    FseTable t;
    const int64_t hdr = read_fse_header(p, hb, 6, 255, t);
    BackwardBits b(p + hdr, hb - hdr);
    uint32_t s1 = uint32_t(b.read(t.log)), s2 = uint32_t(b.read(t.log));
    while (true) {
      if (nw > 253) fail("zstd: too many Huffman weights");
      w[nw++] = t.sym[s1];
      s1 = t.base[s1] + uint32_t(b.read(t.nbits[s1]));
      if (b.off < 0) {
        w[nw++] = t.sym[s2];
        break;
      }
      w[nw++] = t.sym[s2];
      s2 = t.base[s2] + uint32_t(b.read(t.nbits[s2]));
      if (b.off < 0) {
        w[nw++] = t.sym[s1];
        break;
      }
    }
    used = 1 + hb;
  }
  if (nw > 255) fail("zstd: too many Huffman weights");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("zstd: Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("zstd: Huffman tree without weights");
  const int max_bits = high_bit(total) + 1;
  if (max_bits > 11) fail("zstd: Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("zstd: Huffman weights do not complete a tree");
  w[nw++] = uint8_t(high_bit(left) + 1);
  int bits[256], rank_count[13] = {0};
  for (int s = 0; s < nw; ++s) {
    bits[s] = w[s] ? max_bits + 1 - w[s] : 0;
    rank_count[bits[s]]++;
  }
  uint32_t rank_idx[13] = {0};
  for (int i = max_bits; i >= 1; --i)
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
  const uint32_t size = 1u << max_bits;
  if (rank_idx[0] != size) fail("zstd: Huffman codes do not fill the table");
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.nbits.assign(size, 0);
  for (int s = 0; s < nw; ++s) {
    if (!bits[s]) continue;
    const uint32_t code = rank_idx[bits[s]], n = 1u << (max_bits - bits[s]);
    std::memset(&h.sym[code], s, n);
    std::memset(&h.nbits[code], bits[s], n);
    rank_idx[bits[s]] += n;
  }
  h.valid = true;
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* src, int64_t len,
                uint8_t* out, int64_t count) {
  BackwardBits b(src, len);
  const uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = uint32_t(b.read(h.max_bits));
  for (int64_t i = 0; i < count; ++i) {
    out[i] = h.sym[state];
    const int nb = h.nbits[state];
    state = ((state << nb) | uint32_t(b.read(nb))) & mask;
  }
  if (b.off != -h.max_bits) fail("zstd: Huffman stream not read exactly");
}

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  FseTable ll, ml, of;
  Defaults() {
    build_fse(ll, kLLDefault, 36, 6);
    build_fse(ml, kMLDefault, 53, 6);
    build_fse(of, kOFDefault, 29, 5);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

constexpr int64_t kBlockMax = 128 * 1024;

// What a frame's blocks carry over to the next block.
struct FrameState {
  HufTable huf;
  FseTable ll, ml, of;
  uint64_t rep[3] = {1, 4, 8};
  int64_t window = 0;
  size_t start = 0;  // where the frame's output begins
};

int64_t read_literals(const uint8_t* src, int64_t len, FrameState& f,
                      std::vector<uint8_t>& lit) {
  if (len < 1) fail("zstd: literals section past its block");
  const uint8_t b0 = src[0];
  const int type = b0 & 3, sf = (b0 >> 2) & 3;
  if (type <= 1) {
    int64_t regen, hdr;
    if ((sf & 1) == 0) {
      regen = b0 >> 3;
      hdr = 1;
    } else if (sf == 1) {
      if (len < 2) fail("zstd: literals header past its block");
      regen = (b0 >> 4) + (int64_t(src[1]) << 4);
      hdr = 2;
    } else {
      if (len < 3) fail("zstd: literals header past its block");
      regen = (b0 >> 4) + (int64_t(src[1]) << 4) + (int64_t(src[2]) << 12);
      hdr = 3;
    }
    if (regen > kBlockMax) fail("zstd: literals larger than a block");
    if (type == 0) {
      if (hdr + regen > len) fail("zstd: raw literals past their block");
      lit.assign(src + hdr, src + hdr + regen);
      return hdr + regen;
    }
    if (hdr + 1 > len) fail("zstd: RLE literals past their block");
    lit.assign(size_t(regen), src[hdr]);
    return hdr + 1;
  }
  const int streams = sf == 0 ? 1 : 4;
  const int hdr = sf <= 1 ? 3 : sf == 2 ? 4 : 5;
  const int each = sf <= 1 ? 10 : sf == 2 ? 14 : 18;
  if (len < hdr) fail("zstd: literals header past its block");
  uint64_t h = 0;
  for (int i = 0; i < hdr; ++i) h |= uint64_t(src[i]) << (8 * i);
  const uint64_t mask = (uint64_t(1) << each) - 1;
  const int64_t regen = int64_t((h >> 4) & mask);
  const int64_t comp = int64_t((h >> (4 + each)) & mask);
  if (regen > kBlockMax) fail("zstd: literals larger than a block");
  if (hdr + comp > len) fail("zstd: Huffman literals past their block");
  const uint8_t* p = src + hdr;
  int64_t plen = comp;
  if (type == 2) {
    const int64_t used = read_huf_tree(p, plen, f.huf);
    p += used;
    plen -= used;
  } else if (!f.huf.valid) {
    fail("zstd: treeless literals without an earlier tree");
  }
  lit.resize(size_t(regen));
  if (streams == 1) {
    huf_stream(f.huf, p, plen, lit.data(), regen);
  } else {
    if (plen < 6) fail("zstd: literals jump table past its block");
    const int64_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                  s3 = p[4] | (p[5] << 8);
    const int64_t s4 = plen - 6 - s1 - s2 - s3;
    if (s4 < 1) fail("zstd: literal streams past their block");
    const int64_t per = (regen + 3) / 4;
    if (per * 3 > regen) fail("zstd: too few literals for four streams");
    const uint8_t* q = p + 6;
    huf_stream(f.huf, q, s1, lit.data(), per);
    huf_stream(f.huf, q + s1, s2, lit.data() + per, per);
    huf_stream(f.huf, q + s1 + s2, s3, lit.data() + 2 * per, per);
    huf_stream(f.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * per,
               regen - 3 * per);
  }
  return hdr + comp;
}

int64_t read_table(const uint8_t* src, int64_t len, int mode, int max_log,
                   int max_sym, const FseTable& predefined, FseTable& t) {
  switch (mode) {
    case 0:
      t = predefined;
      return 0;
    case 1:
      if (len < 1) fail("zstd: RLE sequence table past its block");
      if (src[0] > max_sym) fail("zstd: RLE symbol past the alphabet");
      rle_fse(t, src[0]);
      return 1;
    case 2:
      return read_fse_header(src, len, max_log, max_sym, t);
    default:
      if (!t.valid) fail("zstd: repeated sequence table without an earlier one");
      return 0;
  }
}

void append(std::vector<uint8_t>& out, const uint8_t* p, size_t n) {
  out.insert(out.end(), p, p + n);
}

void read_sequences(const uint8_t* src, int64_t len, FrameState& f,
                    const std::vector<uint8_t>& lit, std::vector<uint8_t>& out) {
  if (len < 1) fail("zstd: sequences section past its block");
  int64_t pos;
  int64_t nseq;
  const uint8_t b0 = src[0];
  if (b0 < 128) {
    nseq = b0;
    pos = 1;
  } else if (b0 < 255) {
    if (len < 2) fail("zstd: sequences header past its block");
    nseq = ((b0 - 128) << 8) + src[1];
    pos = 2;
  } else {
    if (len < 3) fail("zstd: sequences header past its block");
    nseq = src[1] + (src[2] << 8) + 0x7F00;
    pos = 3;
  }
  if (nseq == 0) {
    append(out, lit.data(), lit.size());
    return;
  }
  if (pos >= len) fail("zstd: sequences header past its block");
  const uint8_t modes = src[pos++];
  if (modes & 3) fail("zstd: reserved bits of the sequence modes set");
  const Defaults& d = defaults();
  pos += read_table(src + pos, len - pos, modes >> 6, 9, 35, d.ll, f.ll);
  pos += read_table(src + pos, len - pos, (modes >> 4) & 3, 8, 31, d.of, f.of);
  pos += read_table(src + pos, len - pos, (modes >> 2) & 3, 9, 52, d.ml, f.ml);
  if (pos >= len) fail("zstd: sequence bitstream missing");
  BackwardBits b(src + pos, len - pos);
  const FseTable &ll = f.ll, &of = f.of, &ml = f.ml;
  uint32_t sll = uint32_t(b.read(ll.log)), sof = uint32_t(b.read(of.log)),
           sml = uint32_t(b.read(ml.log));
  size_t lit_pos = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    const int ofc = of.sym[sof], llc = ll.sym[sll], mlc = ml.sym[sml];
    if (ofc > 31) fail("zstd: offset code above 31");
    const uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
    const uint64_t mlv = kMLBase[mlc] + b.read(kMLBits[mlc]);
    const uint64_t llv = kLLBase[llc] + b.read(kLLBits[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      const int idx = int(ofv) - 1 + (llv == 0 ? 1 : 0);
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (idx > 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = ll.base[sll] + uint32_t(b.read(ll.nbits[sll]));
      sml = ml.base[sml] + uint32_t(b.read(ml.nbits[sml]));
      sof = of.base[sof] + uint32_t(b.read(of.nbits[sof]));
    }
    if (lit_pos + llv > lit.size()) fail("zstd: sequence past its literals");
    append(out, lit.data() + lit_pos, size_t(llv));
    lit_pos += size_t(llv);
    const uint64_t produced = out.size() - f.start;
    if (offset == 0 || offset > produced ||
        (f.window > 0 && offset > uint64_t(f.window)))
      fail("zstd: match offset outside the window");
    const size_t at = out.size();
    out.resize(at + size_t(mlv));
    uint8_t* dst = out.data() + at;
    const uint8_t* from = dst - offset;
    if (offset >= mlv) {
      std::memcpy(dst, from, size_t(mlv));
    } else {
      for (uint64_t k = 0; k < mlv; ++k) dst[k] = from[k];
    }
  }
  if (b.off != 0) fail("zstd: sequence bitstream not read exactly");
  append(out, lit.data() + lit_pos, lit.size() - lit_pos);
}

void read_block(const uint8_t* src, int64_t len, FrameState& f,
                std::vector<uint8_t>& out) {
  std::vector<uint8_t> lit;
  const int64_t used = read_literals(src, len, f, lit);
  const size_t before = out.size();
  read_sequences(src + used, len - used, f, lit, out);
  if (int64_t(out.size() - before) > kBlockMax)
    fail("zstd: block decodes to more than 128 KiB");
}

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

void decode_frames(const uint8_t* src, int64_t n, std::vector<uint8_t>& out) {
  int64_t pos = 0;
  if (n == 0) fail("zstd: empty input");
  while (pos < n) {
    if (pos + 4 > n) fail("zstd: truncated frame");
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (pos + 8 > n) fail("zstd: truncated skippable frame");
      pos += 8 + int64_t(rd32(src + pos + 4));
      if (pos > n) fail("zstd: truncated skippable frame");
      continue;
    }
    if (magic != 0xFD2FB528u) fail("zstd: not a zstd frame");
    pos += 4;
    if (pos >= n) fail("zstd: truncated frame header");
    const uint8_t fhd = src[pos++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    const int checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail("zstd: reserved frame header bit set");
    FrameState f;
    if (!single) {
      if (pos >= n) fail("zstd: truncated frame header");
      const uint8_t wd = src[pos++];
      const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
      f.window = int64_t(base + (base / 8) * (wd & 7));
    }
    const int did_size = did_flag == 3 ? 4 : did_flag;
    const int fcs_size =
        fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
    if (pos + did_size + fcs_size > n) fail("zstd: truncated frame header");
    uint64_t did = 0, fcs = 0;
    for (int i = 0; i < did_size; ++i) did |= uint64_t(src[pos + i]) << (8 * i);
    pos += did_size;
    if (did != 0) fail("zstd: frame needs a dictionary");
    for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
    pos += fcs_size;
    if (fcs_flag == 1) fcs += 256;
    if (single) f.window = int64_t(fcs);
    f.start = out.size();
    if (fcs_size && fcs < (uint64_t(1) << 34)) out.reserve(f.start + size_t(fcs));
    bool last = false;
    while (!last) {
      if (pos + 3 > n) fail("zstd: truncated block header");
      const uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      pos += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const int64_t size = bh >> 3;
      if (size > kBlockMax) fail("zstd: block larger than 128 KiB");
      if (type == 0) {
        if (pos + size > n) fail("zstd: truncated raw block");
        append(out, src + pos, size_t(size));
        pos += size;
      } else if (type == 1) {
        if (pos + 1 > n) fail("zstd: truncated RLE block");
        out.insert(out.end(), size_t(size), src[pos]);
        pos += 1;
      } else if (type == 2) {
        if (pos + size > n) fail("zstd: truncated compressed block");
        read_block(src + pos, size, f, out);
        pos += size;
      } else {
        fail("zstd: reserved block type");
      }
    }
    const size_t produced = out.size() - f.start;
    if (fcs_size && produced != fcs) fail("zstd: content size mismatch");
    if (checksum) {
      if (pos + 4 > n) fail("zstd: truncated content checksum");
      const uint32_t want = rd32(src + pos);
      pos += 4;
      const uint32_t got = uint32_t(xxh64(out.data() + f.start, produced, 0));
      if (want != got) fail("zstd: content checksum mismatch");
    }
  }
}

uint32_t crc_table[8][256];

void init_crc() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
}

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const bool ready = (init_crc(), true);
  (void)ready;
  uint32_t c = ~crc;
  while (n >= 8) {
    const uint64_t v = rd64(p) ^ c;
    c = crc_table[7][v & 0xFF] ^ crc_table[6][(v >> 8) & 0xFF] ^
        crc_table[5][(v >> 16) & 0xFF] ^ crc_table[4][(v >> 24) & 0xFF] ^
        crc_table[3][(v >> 32) & 0xFF] ^ crc_table[2][(v >> 40) & 0xFF] ^
        crc_table[1][(v >> 48) & 0xFF] ^ crc_table[0][v >> 56];
    p += 8;
    n -= 8;
  }
  for (; n; --n, ++p) c = (c >> 8) ^ crc_table[0][(c ^ *p) & 0xFF];
  return ~c;
}

void set_error(char* err, int64_t cap, const char* what) {
  if (err && cap > 0) {
    std::strncpy(err, what, size_t(cap - 1));
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decode every frame of src[0:n] into a malloc'd buffer of *out_len bytes
// (free it with a8t_free); null with the reason in err on a corrupt input.
uint8_t* a8t_zstd_decompress(const uint8_t* src, int64_t n, int64_t* out_len,
                             char* err, int64_t err_cap) {
  try {
    std::vector<uint8_t> out;
    decode_frames(src, n, out);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size() ? out.size() : 1));
    if (!buf) fail("zstd: out of memory");
    if (!out.empty()) std::memcpy(buf, out.data(), out.size());
    *out_len = int64_t(out.size());
    return buf;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return nullptr;
  }
}

void a8t_free(void* p) { std::free(p); }

// CRC32C of src[0:n], continuing from `crc` (0 to start).
uint32_t a8t_crc32c(const uint8_t* src, int64_t n, uint32_t crc) {
  return crc32c(src, size_t(n), crc);
}

uint64_t a8t_xxh64(const uint8_t* src, int64_t n, uint64_t seed) {
  return xxh64(src, size_t(n), seed);
}

}  // extern "C"
