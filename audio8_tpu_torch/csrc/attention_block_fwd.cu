// Attention block, forward: out = sum_h core(x Wq_h + bq_h, x Wk_h + bk_h,
// x Wv_h + bv_h) Wo_h + bo, for one self-attention layer.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_block_kernel.py:
// _fwd_kernel (driven by attention_block_nheads, one grid step per
// (batch, head) with the four projections inside the kernel). Same
// function, term by term:
//
//   * x is taken on the T_pad = round_up(T, 128) grid with zero rows past
//     T, so a padded row of q, k, v is its bias;
//   * q = round(x Wq_h) + bq_h (bias added after rounding to the input
//     dtype), k and v the same;
//   * the core is attention_fwd.cu's, run on the (B, H, T_pad, dh) grid
//     with the keys at or past T masked (the caller's (B, T_pad) key mask
//     has zeros there): the same -1e9 scores, f32 softmax, uniform 1/T_pad
//     weights for a row with no valid key (over v rows that are bv past
//     T), and the same hash-dropout mask (seed + b*H + h, row stride
//     T_pad; b the global row b0 + b under data parallelism) as the TPU
//     kernel's _probs;
//   * out = sum over heads of o_h Wo_h in f32, plus bo, rounded once.
//
// What bounds it on H100: at the pretraining shape (20, 222, 768), 12
// heads, the four projections are 8 B T D^2 = 2.1e10 FLOP and the core
// 4 B H T^2 dh = 3.0e9 on the real rows: operations, 0.36 ms in f32 at
// 67 TFLOP/s and 0.024 ms in bf16 (the padded grid, T_pad = 256, adds
// 15-33% to that work).
// The TPU kernel runs twelve narrow (D, dh) products per (b, h); here the
// decomposition is three launches on one stream, each over the whole
// batch and all heads at once:
//   1. q, k, v: one GEMM over the padded rows (z = which of the three),
//      written head-major for the core;
//   2. the attention core (attention_fwd.cu's device code, included);
//   3. out = [o_1 .. o_H] Wo^T + bo: one GEMM over K = H*dh reading o
//      head-major, so the sum over heads is the GEMM's f32 sum.
// The GEMMs take attention_block_gemm.cuh's route for the shape
// (block_route): in bf16 at head dim 64 or 128 tma_gemm.cuh's wgmma
// kernel fed by TMA (its M tiles on the padded grid for both products,
// the output projection's rows past T dropped in its epilogue), else
// mma.sync tiles; in f32 the 128 x 128 SIMT tile, full f32 sums. With
// `stats` the core also writes its row statistics (and with `o32` its
// f32 output, for bf16), which the backward (attention_block_bwd.cu)
// reads with q, k, v and o.

#include "attention_fwd.cu"
#include "attention_block_gemm.cuh"

namespace {

using blockgemm::kWgmma;

// The two products on the wgmma route (bf16).
int projections_wgmma(const void* x, const void* const* w3,
                      const void* const* b3, const void* wo, const void* bo,
                      void* const* qkv, const void* o, void* out,
                      bool output, int batch, int t, int d_model, int heads,
                      int dh, cudaStream_t s) {
  using namespace blockgemm;
  using namespace tmagemm;
  using bf16 = __nv_bfloat16;
  const int t_pad = (t + 127) / 128 * 128, hd = heads * dh;
  const int lg = log2_exact(dh);
  Maps m{};
  int err;
  if (!output) {
    err = encode_rows(&m.a[0], x, batch, t, d_model);
    for (int z = 0; z < 3 && err == 0; ++z)
      err = encode_matrix(&m.b[z], w3[z], hd, d_model);
    if (err != 0) return err;
    const int nk = (d_model + 63) / 64;
    const HeadOut<bf16> e{{(bf16*)qkv[0], (bf16*)qkv[1], (bf16*)qkv[2]},
                          {(const bf16*)b3[0], (const bf16*)b3[1],
                           (const bf16*)b3[2]},
                          t_pad, heads, lg};
    return wgmma_gemm(m, TmaPaddedRows{t_pad}, TmaWeightRows{1, nk}, e,
                      batch * t_pad, hd, 3, 1, nk, s);
  }
  err = encode_heads(&m.a[0], o, batch, heads, t_pad, dh);
  if (err == 0) err = encode_matrix(&m.b[0], wo, d_model, hd);
  if (err != 0) return err;
  const PaddedRowOut e{(bf16*)out, (const bf16*)bo, d_model, t, t_pad};
  return wgmma_gemm(m, TmaHeadCols{t_pad, dh, hd / 64},
                    TmaWeightRows{0, hd / 64}, e, batch * t_pad, d_model, 1,
                    1, hd / 64, s);
}

template <typename T>
int block_fwd(const void* x, const void* wq, const void* bq, const void* wk,
              const void* bk, const void* wv, const void* bv, const void* wo,
              const void* bo, const void* key_valid, void* q, void* k,
              void* v, void* o, void* stats, void* o32, void* out, int batch,
              int t, int d_model, int heads, int dh, int dtype, float scale,
              float inv_keep, uint32_t threshold, uint32_t seed,
              uint32_t bh0, uint32_t hs, int dropout, int route, cudaStream_t s) {
  using namespace blockgemm;
  const int t_pad = (t + 127) / 128 * 128, hd = heads * dh;
  const int lg = log2_exact(dh);
  if (lg < 0) return (int)cudaErrorInvalidValue;
  const void* w3[3] = {wq, wk, wv};
  const void* b3[3] = {bq, bk, bv};
  void* qkv[3] = {q, k, v};
  // 1. q, k, v = round(x W^T) + b on the padded grid, head-major
  int err;
  if (route == kWgmma) {
    err = projections_wgmma(x, w3, b3, wo, bo, qkv, o, out, false, batch, t,
                            d_model, heads, dh, s);
  } else {
    const PaddedRows<T> xa{(const T*)x, t, t_pad, d_model};
    const WeightRows<T> wb{{(const T*)wq, (const T*)wk, (const T*)wv},
                           d_model, 1};
    const HeadOut<T> qe{{(T*)q, (T*)k, (T*)v},
                        {(const T*)bq, (const T*)bk, (const T*)bv},
                        t_pad, heads, lg};
    err = gemm<T>(route, xa, wb, qe, batch * t_pad, hd, d_model, d_model,
                  d_model, 3, 1, s);
  }
  if (err != 0) return err;
  // 2. the attention core on (B, H, T_pad, dh)
  err = run_fwd(q, k, v, key_valid, o, stats, o32, batch, heads, t_pad, dh,
                dtype, scale, inv_keep, threshold, seed, bh0, hs, dropout, 0, 0, s);
  if (err != 0) return err;
  // 3. out = [o_1 .. o_H] Wo^T + bo over the real rows
  if (route == kWgmma)
    return projections_wgmma(x, w3, b3, wo, bo, qkv, o, out, true, batch, t,
                             d_model, heads, dh, s);
  const HeadCols<T> oa{{(const T*)o, nullptr, nullptr}, t, t_pad, heads, lg};
  const WeightRows<T> wob{{(const T*)wo, nullptr, nullptr}, hd, 0};
  const RowOut<T> oe{(T*)out, (const T*)bo, d_model};
  return gemm<T>(route, oa, wob, oe, batch * t, d_model, hd, hd, hd, 1, 1,
                 s);
}

}  // namespace

// The GEMM route block_route gives the shape: 0 = SIMT, 1 = mma.sync, 2 =
// wgmma (ops/attention_block.py:gemm_route mirrors it).
extern "C" int a8t_attention_block_route(int dtype, int d_model, int heads,
                                         int dh) {
  return blockgemm::block_route(dtype, d_model, heads, dh);
}

// x, out: (B, T, D); wq, wk, wv: (H*dh, D) and wo: (D, H*dh) (Dense
// layout, out x in); bq, bk, bv: (H*dh); bo: (D); key_valid: (B, T_pad)
// uint8, zero past T; q, k, v, o: (B, H, T_pad, dh) scratch, kept for the
// backward; stats: (B*H*T_pad, 2) f32 or NULL; o32: (B, H, T_pad, dh) f32
// or NULL (bf16 only). All contiguous and 16-byte aligned, one dtype (0 =
// float32, 1 = bfloat16). inv_keep = 1 / (1 - rate); threshold and seed
// are the uint32 dropout parameters (dropout = 0 skips the hash), bh0 and
// hs place the rows and heads in a larger tensor's (global_head of
// attention_fwd.cu; b0 * H_glob + h0 and H_glob), as in a8t_attention_fwd. route
// must be block_route's for the shape. Returns the cudaError_t of the
// three launches.
extern "C" int a8t_attention_block_fwd(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, const void* key_valid, void* q, void* k, void* v, void* o,
    void* stats, void* o32, void* out, int batch, int t, int d_model,
    int heads, int dh, int dtype, float scale, float inv_keep,
    uint32_t threshold, uint32_t seed, uint32_t bh0, uint32_t hs, int dropout, int route,
    void* stream) {
  if (batch <= 0 || t <= 0 || d_model <= 0 || heads <= 0 || dh <= 0 ||
      route != blockgemm::block_route(dtype, d_model, heads, dh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return block_fwd<float>(x, wq, bq, wk, bk, wv, bv, wo, bo, key_valid, q,
                            k, v, o, stats, o32, out, batch, t, d_model,
                            heads, dh, dtype, scale, inv_keep, threshold,
                            seed, bh0, hs, dropout, route, s);
  if (dtype == 1)
    return block_fwd<__nv_bfloat16>(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                    key_valid, q, k, v, o, stats, o32, out,
                                    batch, t, d_model, heads, dh, dtype,
                                    scale, inv_keep, threshold, seed, bh0, hs,
                                    dropout, route, s);
  return (int)cudaErrorInvalidValue;
}
