// Abstract word-level n-gram LM used by the LM-fused prefix beam search
// (arpa_lm.cc). Two implementations: ARPA text (arpa_lm.cc) and KenLM
// PROBING binary (kenlm_bin.cc) — the two artifact formats the
// reference's ctcdecode/kenlm stack consumes
// (the reference audio8 ctc.py:22-30). The C ABI handles
// (a8t_lm_load / a8t_lm_load_kenlm / a8t_lm_logp / a8t_lm_free and the
// lm_ptr of a8t_prefix_beam_search_lm) are `Lm*`.
#ifndef AUDIO8_TPU_CSRC_LM_IFACE_H_
#define AUDIO8_TPU_CSRC_LM_IFACE_H_

#include <cstdint>
#include <string>

struct Lm {
  int order = 0;
  int32_t unk_id = -1;  // id to substitute for OOV words (<unk>)
  virtual ~Lm() = default;
  // Word id in this LM's own id space, or -1 when OOV.
  virtual int32_t Lookup(const std::string& w) const = 0;
  // ln P(word | ctx) with backoff; ids from Lookup (word >= 0).
  virtual float LogP(int32_t word, const int32_t* ctx, int ctx_len) const = 0;
};

#endif  // AUDIO8_TPU_CSRC_LM_IFACE_H_
