"""KenLM binary language models written by the port
(``audio8_tpu/ops/kenlm_bin.py``'s writer): kenlm's ``build_binary``
format version 5 for the PROBING, TRIE and QUANT_TRIE search types, byte
for byte the files the JAX package writes from the same ARPA. The port
reads them with its host library (``csrc/kenlm_bin.cc`` through
``csrc.native.NativeKenLM``); ``cli.build_binary`` is the command line.

PROBING:

  [Sanity header][FixedWidthParameters][uint64 counts[order]]  (ALIGN8)
  [ProbingVocabularyHeader][vocab hash table: (u64 murmur, u32 id)]
  [unigram: (f32 prob, f32 backoff) x (counts[0]+1)]
  [order-n hash table, n=2..order-1: (u64 key, f32 prob, f32 backoff)]
  [order-N hash table: (u64 key, f32 prob)]
  [optional NUL-separated vocab strings, id order]

TRIE / QUANT_TRIE (``build_binary trie [-q]``, kenlm lm/search_trie.cc,
lm/trie.hh, lm/quantize.hh):

  [Sanity header][FixedWidthParameters][uint64 counts[order]]  (ALIGN8)
  [SortedVocabulary: u64 n, then counts[0] u64 slots of sorted hashes]
  [quant tables, QUANT_TRIE only: u8 prob_bits, u8 backoff_bits, 6 pad,
   per middle order a f32[2^pb] prob + f32[2^bb] backoff table,
   then the longest order's f32[2^pb] prob table]
  [unigram: (f32 prob, f32 backoff, u64 next) x (counts[0]+2)]
  [bit-packed middle array per order 2..N-1:
   word | prob | backoff | next-index, (counts[n-1]+1) entries]
  [bit-packed longest array: word | prob, (counts[N-1]+1) entries]
  [optional NUL-separated vocab strings, id order]

Word keys are MurmurHash64A(word, seed=0). PROBING n-gram keys chain
``CombineWordHash`` from the last word id backwards (kenlm
lm/search_hashed.hh) into linear-probing tables (``start = key %
buckets``, key 0 = empty bucket). The TRIE stores reversed n-grams (the
root branches on the predicted word, then the context newest first) as
sorted bit-packed per-order arrays; probabilities are stored
sign-stripped in 31 bits and backoffs as f32, or both as indices into
per-order center tables when quantized.
"""
from __future__ import annotations

import bisect
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from audio8_tpu_torch.ops.lm import ArpaLM

LOG10 = math.log(10.0)

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
# char magic[ALIGN8(sizeof(kMagicBytes))]: sizeof counts C's implicit
# trailing NUL (53), aligned up to 56 zero-padded bytes on disk.
_MAGIC_FIELD = MAGIC.ljust((len(MAGIC) + 1 + 7) // 8 * 8, b"\x00")
_SANITY = struct.Struct("<" + str(len(_MAGIC_FIELD)) + "s fff II 4x Q")
# order, multiplier, model type, vocab strings?, search version
_FIXED = struct.Struct("<B 3x f i ? 3x I")

MODEL_PROBING = 0
MODEL_TRIE = 2
MODEL_QUANT_TRIE = 3
# lm/search_hashed.hh HashedSearch::kVersion / lm/search_trie.hh
# TrieSearch::kVersion: bumped by kenlm on layout changes.
_SEARCH_VERSION = {MODEL_PROBING: 0, MODEL_TRIE: 1, MODEL_QUANT_TRIE: 1}
_SIGN_BIT = 0x80000000

_VOCAB_ENTRY = np.dtype([("key", "<u8"), ("val", "<u4")])          # pack(4): 12 B
_MIDDLE_ENTRY = np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4")])
_LONGEST_ENTRY = np.dtype([("key", "<u8"), ("prob", "<f4")])       # pack(4): 12 B

_M64 = (1 << 64) - 1
_COMBINE_A = 8978948897894561157
_COMBINE_B = 17894857484156487943


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def _required_bits(max_value: int) -> int:
    """util/bit_packing.hh RequiredBits: bits to hold ``max_value``."""
    return max_value.bit_length()


def _write_bits(buf: bytearray, bit_off: int, nbits: int, value: int) -> None:
    byte = bit_off >> 3
    shift = bit_off & 7
    span = (shift + nbits + 7) // 8
    cur = int.from_bytes(buf[byte:byte + span], "little")
    mask = ((1 << nbits) - 1) << shift
    cur = (cur & ~mask) | ((value << shift) & mask)
    buf[byte:byte + span] = cur.to_bytes(span, "little")


def _bits_from_f32(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A (Appleby), kenlm's portable word hash
    (util/murmur_hash.cc, seed 0 via lm/vocab HashForVocab)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _M64)) & _M64
    n8 = len(data) // 8 * 8
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i:i + 8], "little")
        k = (k * m) & _M64
        k ^= k >> r
        k = (k * m) & _M64
        h = ((h ^ k) * m) & _M64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _M64
    h ^= h >> r
    h = (h * m) & _M64
    h ^= h >> r
    return h


def combine_word_hash(current: int, next_word: int) -> int:
    """kenlm lm/search_hashed.hh CombineWordHash: extend an n-gram key
    by one more-distant context word id."""
    return ((current * _COMBINE_A) ^ (((1 + next_word) * _COMBINE_B) & _M64)) & _M64


def ngram_key(ids: Sequence[int]) -> int:
    """Hash key of an n-gram (oldest..newest word ids), n >= 2: start
    from the newest word's id and chain backwards through the context,
    mirroring kenlm's scoring walk (lm/model.cc ScoreExceptBackoff)."""
    key = ids[-1]
    for w in reversed(ids[:-1]):
        key = combine_word_hash(key, w)
    return key


def _buckets(entries: int, multiplier: float) -> int:
    """util/probing_hash_table.hh Size(): bucket count replicates the
    float32 arithmetic so reader/writer agree with kenlm bit-for-bit."""
    return max(entries + 1,
               int(np.float32(multiplier) * np.float32(entries)))


def _probe_insert(keys: np.ndarray, key: int, store) -> None:
    n = len(keys)
    i = key % n
    while keys[i] != 0:
        i = (i + 1) % n
    store(i)


def write_kenlm_binary(arpa_path: str, out_path: str,
                       probing_multiplier: float = 1.5,
                       write_vocab_strings: bool = True,
                       search: str = "probing",
                       quantize: bool = False,
                       prob_bits: int = 8,
                       backoff_bits: int = 8) -> Dict[str, int]:
    """Build a KenLM binary from an ARPA file (kenlm ``build_binary``;
    the JAX package's ``write_kenlm_binary``, byte for byte). ``search``
    picks the layout: "probing" (the default, as build_binary's) or
    "trie" (build_binary's ``trie`` argument); ``quantize`` with trie
    stores probs and backoffs as ``prob_bits``/``backoff_bits``-wide
    table indices (build_binary ``trie -q``). Returns the order, the
    per-order n-gram counts written, the word-id bound and the model
    type.

    Word ids: <unk> (or <UNK>) is id 0 and is not inserted into the
    vocab table (kenlm lm/vocab.cc Insert); other unigrams get 1, 2,
    ... in ARPA order (probing) or murmur-hash-sorted order (trie,
    lm/vocab.cc SortedVocabulary). An ARPA without <unk> gets an id-0
    row with prob -100 (kenlm's OOV floor).
    """
    lm = ArpaLM(arpa_path)
    order = max(1, lm.order)
    by_order: List[List[Tuple[Tuple[str, ...], float, float]]] = \
        [[] for _ in range(order)]
    for gram, (p_ln, b_ln) in lm.ngrams.items():
        by_order[len(gram) - 1].append((gram, p_ln / LOG10, b_ln / LOG10))

    if search == "trie":
        return _write_trie(out_path, order, by_order, write_vocab_strings,
                           quantize, prob_bits, backoff_bits)
    if search != "probing":
        raise ValueError(f"unknown search type {search!r} "
                         "(use 'probing' or 'trie')")
    if quantize:
        raise ValueError("quantization applies to the trie layout only "
                         "(kenlm build_binary trie -q); probing stores "
                         "full f32 probs")

    word_ids: Dict[str, int] = {}
    unk_row = (-100.0, 0.0)
    next_id = 1
    uni_rows: Dict[int, Tuple[float, float]] = {}
    for (w,), p10, b10 in by_order[0]:
        if w in ("<unk>", "<UNK>"):
            unk_row = (p10, b10)
            continue
        word_ids[w] = next_id
        uni_rows[next_id] = (p10, b10)
        next_id += 1
    bound = next_id
    counts = [len(g) for g in by_order]

    # --- vocab table ---
    vb = _buckets(counts[0], probing_multiplier)
    vocab = np.zeros(vb, dtype=_VOCAB_ENTRY)
    for w, wid in word_ids.items():
        key = murmur_hash64a(w.encode("utf-8"))
        if key == 0:
            raise ValueError(f"word {w!r} murmur-hashes to the reserved "
                             "empty-bucket key 0")
        def put(i, key=key, wid=wid):
            vocab["key"][i] = key
            vocab["val"][i] = wid
        _probe_insert(vocab["key"], key, put)

    # --- unigram array ---
    unigram = np.zeros((counts[0] + 1, 2), dtype="<f4")
    unigram[0] = unk_row
    for wid, row in uni_rows.items():
        unigram[wid] = row

    def ids_of(gram: Tuple[str, ...]) -> Tuple[int, ...]:
        return tuple(word_ids.get(w, 0) for w in gram)

    def checked_key(gram: Tuple[str, ...]) -> int:
        key = ngram_key(ids_of(gram))
        if key == 0:
            # astronomically rare, but a key-0 entry is indistinguishable
            # from an empty bucket: unreadable, and later probe inserts
            # could overwrite it. Refuse rather than emit a table that
            # silently drops/mis-scores this n-gram.
            raise ValueError(
                f"n-gram {gram!r} hash-chains to the reserved "
                "empty-bucket key 0; cannot be stored in a PROBING "
                "binary — drop it from the ARPA or use the ARPA directly")
        return key

    # --- middle tables ---
    middles = []
    for n in range(2, order):
        mb = _buckets(counts[n - 1], probing_multiplier)
        tab = np.zeros(mb, dtype=_MIDDLE_ENTRY)
        for gram, p10, b10 in by_order[n - 1]:
            key = checked_key(gram)
            def put(i, key=key, p10=p10, b10=b10, tab=tab):
                tab["key"][i] = key
                tab["prob"][i] = p10
                tab["backoff"][i] = b10
            _probe_insert(tab["key"], key, put)
        middles.append(tab)

    # --- longest table ---
    longest = None
    if order > 1:
        lb = _buckets(counts[order - 1], probing_multiplier)
        longest = np.zeros(lb, dtype=_LONGEST_ENTRY)
        for gram, p10, _ in by_order[order - 1]:
            key = checked_key(gram)
            def put(i, key=key, p10=p10):
                longest["key"][i] = key
                longest["prob"][i] = p10
            _probe_insert(longest["key"], key, put)

    # --- header ---
    sanity = _SANITY.pack(_MAGIC_FIELD, 0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1)
    fixed = _FIXED.pack(order, np.float32(probing_multiplier),
                        MODEL_PROBING, bool(write_vocab_strings), 0)
    counts_blob = struct.pack("<" + "Q" * order, *counts)
    header = sanity + fixed + counts_blob
    header += b"\x00" * (_align8(len(header)) - len(header))

    with open(out_path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<Q", bound))
        f.write(vocab.tobytes())
        f.write(unigram.tobytes())
        for tab in middles:
            f.write(tab.tobytes())
        if longest is not None:
            f.write(longest.tobytes())
        if write_vocab_strings:
            names = ["<unk>"] + [""] * (bound - 1)
            for w, wid in word_ids.items():
                names[wid] = w
            f.write(b"".join(w.encode("utf-8") + b"\x00" for w in names))
    return {"order": order, "counts": counts, "bound": bound,
            "model_type": MODEL_PROBING}


def _quant_table(values: Sequence[float], bits: int,
                 reserve_zeros: bool) -> np.ndarray:
    """Quantization center table (lm/quantize.hh SeparatelyQuantize).
    Backoff tables reserve bins 0/1 for -0.0/+0.0 (kenlm's
    no-extension/extension markers, numerically equal). When the
    distinct values fit the capacity the table is exact and
    quantization is lossless; otherwise kenlm's MakeBins scheme:
    equal-count chunks of the sorted values, center = chunk mean."""
    cap = 1 << bits
    reserved = [-0.0, 0.0] if reserve_zeros else []
    vals = sorted({float(np.float32(v)) for v in values
                   if not (reserve_zeros and np.float32(v) == 0.0)})
    avail = cap - len(reserved)
    if avail <= 0 and vals:
        raise ValueError(
            f"{bits}-bit quantization leaves no room beyond the "
            "reserved zero bins; raise backoff_bits")
    if len(vals) <= avail:
        fill = vals[-1] if vals else 0.0
        centers = vals + [fill] * (avail - len(vals))
    else:
        arr = np.sort(np.asarray(
            [float(np.float32(v)) for v in values
             if not (reserve_zeros and np.float32(v) == 0.0)],
            dtype=np.float64))
        chunks = np.array_split(arr, avail)
        centers, last = [], 0.0
        for c in chunks:
            last = float(c.mean()) if len(c) else last
            centers.append(last)
    return np.asarray(reserved + centers, dtype="<f4")


def _quant_encoder(table: np.ndarray):
    """Vectorized nearest-center encoder for one quant table: values ->
    bin indices in one searchsorted pass (the per-entry argmin scan was
    O(2^bits) per n-gram — hours on a real LM at prob_bits=16)."""
    t64 = table.astype(np.float64)
    order = np.argsort(t64, kind="stable")
    sorted_t = t64[order]

    def encode(values) -> np.ndarray:
        v = np.asarray(values, dtype=np.float32).astype(np.float64)
        pos = np.searchsorted(sorted_t, v)
        lo = np.clip(pos - 1, 0, len(sorted_t) - 1)
        hi = np.clip(pos, 0, len(sorted_t) - 1)
        pick = np.where(np.abs(v - sorted_t[lo]) <= np.abs(v - sorted_t[hi]),
                        lo, hi)
        return order[pick]

    return encode


def _write_trie(out_path: str, order: int, by_order, write_vocab_strings,
                quantize: bool, prob_bits: int,
                backoff_bits: int) -> Dict[str, int]:
    """TRIE / QUANT_TRIE body shared by ``write_kenlm_binary``: the
    reversed-n-gram sorted trie of lm/search_trie.cc (layout details in
    the module docstring)."""
    if order < 2:
        raise ValueError("TRIE binaries need order >= 2 (kenlm's trie "
                         "has no longest-only layout); use "
                         "search='probing' for a unigram LM")
    if quantize and not (1 <= prob_bits <= 25 and 2 <= backoff_bits <= 25):
        raise ValueError("quantization bits must be in 1..25 (kenlm's "
                         "range), backoff_bits >= 2 for the reserved "
                         "zero bins")

    # --- sorted vocabulary (lm/vocab.cc SortedVocabulary) ---
    unk_row = (-100.0, 0.0)
    vocab_entries: List[Tuple[int, str, float, float]] = []
    for (w,), p10, b10 in by_order[0]:
        if w in ("<unk>", "<UNK>"):
            unk_row = (p10, b10)
            continue
        vocab_entries.append((murmur_hash64a(w.encode("utf-8")), w,
                              p10, b10))
    vocab_entries.sort()
    for (ha, *_), (hb, wb, *_) in zip(vocab_entries, vocab_entries[1:]):
        if ha == hb:
            raise ValueError(
                f"two vocabulary words murmur-hash identically "
                f"(near {wb!r}); a sorted-hash TRIE vocab cannot "
                "distinguish them — use search='probing'")
    word_ids = {w: i + 1 for i, (_, w, _, _) in enumerate(vocab_entries)}
    n_vocab = len(vocab_entries)
    bound = n_vocab + 1
    counts = [len(g) for g in by_order]

    # --- per-order reversed paths, lexicographically sorted: an
    # n-gram (w1..wn) lives at path (wn, w(n-1), ..., w1) — the root
    # branches on the predicted word, then the context newest-first ---
    levels: List[List[Tuple[Tuple[int, ...], float, float, int]]] = []
    for m in range(2, order + 1):
        entries = []
        for gram, p10, b10 in by_order[m - 1]:
            ids = tuple(word_ids.get(w, 0) for w in gram)
            entries.append((tuple(reversed(ids)), p10, b10, 0))
        entries.sort(key=lambda e: e[0])
        for (pa, *_), (pb, *_) in zip(entries, entries[1:]):
            if pa == pb:
                raise ValueError(
                    f"duplicate {m}-gram after vocab id mapping (an "
                    "n-gram references a word absent from the "
                    "unigrams?); refusing to build a TRIE")
        levels.append(entries)

    # --- parent linkage (entry at level m+1 -> its level-m prefix) ---
    for li in range(1, len(levels)):
        parent_of = {e[0]: i for i, e in enumerate(levels[li - 1])}
        linked = []
        for path, p10, b10, _ in levels[li]:
            pi = parent_of.get(path[:-1])
            if pi is None:
                n = li + 2
                raise ValueError(
                    f"ARPA is not suffix-closed: a {n}-gram's "
                    f"{n - 1}-gram suffix is missing (pruned LM). "
                    "kenlm fills such holes with blank entries; "
                    "re-estimate unpruned (cli.train_ngram) or use "
                    "search='probing'")
            linked.append((path, p10, b10, pi))
        levels[li] = linked

    # --- quantization tables ---
    quant_blob = b""
    mid_tabs: List[Tuple[np.ndarray, np.ndarray]] = []
    long_tab: Optional[np.ndarray] = None
    if quantize:
        parts = [bytes([prob_bits, backoff_bits]) + b"\x00" * 6]
        for m in range(2, order):
            lv = levels[m - 2]
            pt = _quant_table([e[1] for e in lv], prob_bits, False)
            bt = _quant_table([e[2] for e in lv], backoff_bits, True)
            mid_tabs.append((pt, bt))
            parts.append(pt.tobytes())
            parts.append(bt.tobytes())
        long_tab = _quant_table([e[1] for e in levels[order - 2]],
                                prob_bits, False)
        parts.append(long_tab.tobytes())
        quant_blob = b"".join(parts)

    # --- unigram array: prob/backoff rows + child begin pointers ---
    uni = np.zeros(counts[0] + 2,
                   dtype=np.dtype([("prob", "<f4"), ("backoff", "<f4"),
                                   ("next", "<u8")]))
    uni["prob"][0], uni["backoff"][0] = unk_row
    for _, w, p10, b10 in vocab_entries:
        wid = word_ids[w]
        uni["prob"][wid] = p10
        uni["backoff"][wid] = b10
    parents = [e[0][0] for e in levels[0]]
    for w in range(counts[0] + 2):
        uni["next"][w] = bisect.bisect_left(parents, w)

    # --- bit-packed middle arrays and the longest array ---
    word_bits = _required_bits(counts[0])
    secs: List[bytes] = []
    for m in range(2, order):
        qw = (prob_bits + backoff_bits) if quantize else 63
        next_bits = _required_bits(counts[m])
        total = word_bits + qw + next_bits
        buf = bytearray(((counts[m - 1] + 1) * total + 7) // 8 + 8)
        child_parents = [e[3] for e in levels[m - 1]]
        if quantize:
            pt, bt = mid_tabs[m - 2]
            p_idx = _quant_encoder(pt)([e[1] for e in levels[m - 2]])
            b_idx = _quant_encoder(bt)([e[2] for e in levels[m - 2]])
        for j, (path, p10, b10, _) in enumerate(levels[m - 2]):
            bit = j * total
            _write_bits(buf, bit, word_bits, path[-1])
            if quantize:
                _write_bits(buf, bit + word_bits, prob_bits,
                            int(p_idx[j]))
                _write_bits(buf, bit + word_bits + prob_bits,
                            backoff_bits, int(b_idx[j]))
            else:
                _write_bits(buf, bit + word_bits, 31,
                            _bits_from_f32(p10) & ~_SIGN_BIT)
                _write_bits(buf, bit + word_bits + 31, 32,
                            _bits_from_f32(b10))
            _write_bits(buf, bit + word_bits + qw, next_bits,
                        bisect.bisect_left(child_parents, j))
        # sentinel entry: only its next field is meaningful (the end
        # pointer of the last real entry's child range)
        _write_bits(buf, counts[m - 1] * total + word_bits + qw,
                    next_bits, counts[m])
        secs.append(bytes(buf))
    qw = prob_bits if quantize else 31
    total = word_bits + qw
    buf = bytearray(((counts[order - 1] + 1) * total + 7) // 8 + 8)
    if quantize:
        p_idx = _quant_encoder(long_tab)(
            [e[1] for e in levels[order - 2]])
    for j, (path, p10, _b, _) in enumerate(levels[order - 2]):
        bit = j * total
        _write_bits(buf, bit, word_bits, path[-1])
        if quantize:
            _write_bits(buf, bit + word_bits, prob_bits, int(p_idx[j]))
        else:
            _write_bits(buf, bit + word_bits, 31,
                        _bits_from_f32(p10) & ~_SIGN_BIT)
    secs.append(bytes(buf))

    # --- assemble ---
    model_type = MODEL_QUANT_TRIE if quantize else MODEL_TRIE
    sanity = _SANITY.pack(_MAGIC_FIELD, 0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1)
    fixed = _FIXED.pack(order, np.float32(1.5), model_type,
                        bool(write_vocab_strings),
                        _SEARCH_VERSION[model_type])
    header = sanity + fixed + struct.pack("<" + "Q" * order, *counts)
    header += b"\x00" * (_align8(len(header)) - len(header))
    with open(out_path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<Q", n_vocab))
        f.write(np.asarray([h for h, *_ in vocab_entries],
                           dtype="<u8").tobytes())
        f.write(b"\x00" * (8 * (counts[0] - n_vocab)))
        f.write(quant_blob)
        f.write(uni.tobytes())
        for sec in secs:
            f.write(sec)
        if write_vocab_strings:
            names = ["<unk>"] + [w for _, w, _, _ in vocab_entries]
            f.write(b"".join(w.encode("utf-8") + b"\x00" for w in names))
    return {"order": order, "counts": counts, "bound": bound,
            "model_type": model_type}
