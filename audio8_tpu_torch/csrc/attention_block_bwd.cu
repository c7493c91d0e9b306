// Attention block, backward: dx and the partials of the weight and bias
// gradients of out = sum_h core(q_h, k_h, v_h) Wo_h + bo with q =
// round(x Wq^T) + bq (k and v the same).
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_block_kernel.py:
// _bwd_kernel (the block's custom VJP, one grid step per (batch, head),
// recomputing q/k/v and p). Same function, term by term:
//
//   * dxo = round(dout Wo_h^T) on the T_pad grid (zero past T);
//   * dWo: o_h^T dout in f32, o_h being the core's rounded output;
//   * the core backward is attention_bwd.cu's (its "kernel" semantics),
//     on the (B, H, T_pad, dh) grid with the forward's key mask, row
//     statistics and f32 output: p regenerated, the same hash-dropout
//     mask, ds not zeroed at masked keys (so a row with no valid key
//     gives the padded keys a dk and dv, as on the TPU); its dq, dk, dv
//     are written rounded to the input dtype and, for bf16, also in f32;
//   * dW{q,k,v}: x^T d{q,k,v} from the ROUNDED gradients, in f32;
//   * db{q,k,v} partials: column sums of the f32 gradients over all T_pad
//     rows;
//   * dx = sum_h dq_h Wq_h^T + dk_h Wk_h^T + dv_h Wv_h^T from the rounded
//     gradients, in f32, rounded once.
// The TPU kernel keeps per-(b, h) partials because its grid runs in order;
// here dWo and dW{q,k,v} are each one product over the rows of all batch
// rows at once, split into a fixed number of K slices (s_wo, s_w: the
// caller's, from the shape, enough to fill the card's SMs) whose f32
// partials the caller sums by fixed-order reductions; the bias partials
// are per batch row; dbo is the caller's f32 sum of dout.
//
// What bounds it on H100: at the pretraining shape (20, 222, 768), 12
// heads, the projections' gradients are 16 B T D^2 = 4.2e10 FLOP and the
// core's recomputed scores and four products 10 B H T^2 dh = 7.6e9 on
// the real rows: operations, 0.74 ms in f32, 0.05 ms in bf16. Unlike the TPU
// kernel this one does not recompute the forward: the forward kernel
// keeps q, k, v, o and the core's row statistics (about 4 x 16 MB per
// layer at that shape). Eight launches on one stream, each over the whole
// batch and all heads:
//   1. dxo: GEMM of the padded dout rows with Wo, written head-major;
//   2. dWo partials: one GEMM over the rows of all batch rows (z = K
//      slice);
//   3-5. the core backward (attention_bwd.cu: D, the fused pass, the dq
//      reduction);
//   6. dW{q,k,v} partials: one GEMM over the rows of all batch rows (z =
//      which of the three x K slice);
//   7. dx: one GEMM over K = 3 H dh, the three products as K segments;
//   8. bias partials: one CTA per (head, batch row, which), fixed-order
//      sums.
// No atomics: the result does not depend on scheduling. The GEMMs take
// attention_block_gemm.cuh's route for the shape (block_route): in bf16
// at head dim 64 or 128 tma_gemm.cuh's wgmma kernel fed by TMA, every
// operand in its stored layout (dxo's Wo, both operands of dWo and
// dW{q,k,v} and dx's W{q,k,v} MN-major), M tiles on the padded grid
// and K = B * T_pad for the weight gradients, whose zero dout and x rows
// past T add exact zeros; else mma.sync tiles, and in f32 the 128 x 128
// SIMT tile, both taking the weight gradients' K as one segment of T_pad
// per batch row whose k tiles past T are skipped.

#include "attention_bwd.cu"
#include "attention_block_gemm.cuh"

namespace {

// part[b, which, h * dh + d] = sum over the T_pad rows t of
// g_which[b, h, t, d]; 256 threads: dh columns x 256 / dh row groups.
__global__ void __launch_bounds__(256)
    bias_partials_kernel(const float* __restrict__ g0,
                         const float* __restrict__ g1,
                         const float* __restrict__ g2,
                         float* __restrict__ part, int heads, int t_pad,
                         int dh) {
  __shared__ float sums[256];
  const int h = blockIdx.x, b = blockIdx.y, which = blockIdx.z;
  const int d = threadIdx.x % dh, rg = threadIdx.x / dh;
  const int groups = blockDim.x / dh;
  const float* g = which == 0 ? g0 : (which == 1 ? g1 : g2);
  g += ((size_t)b * heads + h) * t_pad * dh;
  float acc = 0.f;
  for (int t = rg; t < t_pad; t += groups) acc += g[(size_t)t * dh + d];
  sums[threadIdx.x] = acc;
  __syncthreads();
  if (rg == 0) {
    float total = 0.f;
    for (int r = 0; r < groups; ++r) total += sums[r * dh + d];
    part[((size_t)b * 3 + which) * heads * dh + h * dh + d] = total;
  }
}

// The four products on the wgmma route (bf16); `which` picks one: 0 =
// dxo, 1 = dWo, 2 = dW{q,k,v}, 3 = dx.
int products_wgmma(int which, const void* x, const void* const* w3,
                   const void* wo, const void* dout, const void* o,
                   const void* const* g3, void* dxo, void* dx, float* dw_part,
                   float* dwo_part, int batch, int t, int d_model, int heads,
                   int dh, int s_w, int s_wo, cudaStream_t s) {
  using namespace blockgemm;
  using namespace tmagemm;
  using bf16 = __nv_bfloat16;
  const int t_pad = (t + 127) / 128 * 128, hd = heads * dh;
  const int row_tiles = (t + 63) / 64, nk_rows = batch * row_tiles;
  Maps m{};
  int err = 0;
  if (which == 0) {  // dxo = round(dout Wo), head-major
    err = encode_rows(&m.a[0], dout, batch, t, d_model);
    if (err == 0) err = encode_matrix(&m.b[0], wo, d_model, hd);
    if (err != 0) return err;
    const int nk = (d_model + 63) / 64;
    const HeadOut<bf16> e{{(bf16*)dxo, nullptr, nullptr},
                          {nullptr, nullptr, nullptr}, t_pad, heads,
                          log2_exact(dh)};
    return wgmma_gemm(m, TmaPaddedRows{t_pad}, TmaWeightCols{nk}, e,
                      batch * t_pad, hd, 1, 1, nk, s);
  }
  if (which == 1) {  // dWo = dout^T o: (s_wo, D, H*dh)
    err = encode_rows(&m.a[0], dout, batch, t, d_model);
    if (err == 0) err = encode_heads(&m.b[0], o, batch, heads, t_pad, dh);
    if (err != 0) return err;
    const Partial e{dwo_part, (long long)d_model * hd, hd};
    return wgmma_gemm(m, TmaRowCols{row_tiles}, TmaHeadRows{row_tiles, dh},
                      e, d_model, hd, 1, s_wo, nk_rows, s);
  }
  for (int z = 0; z < 3 && err == 0; ++z)
    err = encode_heads(&m.a[z], g3[z], batch, heads, t_pad, dh);
  if (err != 0) return err;
  if (which == 2) {  // dW{q,k,v} = d{q,k,v}^T x: (3, s_w, H*dh, D)
    err = encode_rows(&m.b[0], x, batch, t, d_model);
    if (err != 0) return err;
    const Partial e{dw_part, (long long)hd * d_model, d_model};
    return wgmma_gemm(m, TmaHeadRows{row_tiles, dh}, TmaRowCols{row_tiles},
                      e, hd, d_model, 3, s_w, nk_rows, s);
  }
  // dx = dq Wq + dk Wk + dv Wv over the real rows
  for (int z = 0; z < 3 && err == 0; ++z)
    err = encode_matrix(&m.b[z], w3[z], hd, d_model);
  if (err != 0) return err;
  const PaddedRowOut e{(bf16*)dx, nullptr, d_model, t, t_pad};
  return wgmma_gemm(m, TmaHeadCols{t_pad, dh, hd / 64}, TmaWeightCols{hd / 64},
                    e, batch * t_pad, d_model, 1, 1, 3 * hd / 64, s);
}

template <typename T>
int block_bwd(const void* x, const void* wq, const void* wk, const void* wv,
              const void* wo, const void* key_valid, const void* dout,
              const void* q, const void* k, const void* v, const void* o,
              const void* o32, const void* stats, void* dxo, void* dvec,
              void* dq_part, void* dq, void* dk, void* dv, void* dq32,
              void* dk32, void* dv32, void* dx, float* dw_part,
              float* dwo_part, float* db_part, int batch, int t, int d_model,
              int heads, int dh, int dtype, float scale, float inv_keep,
              uint32_t threshold, uint32_t seed, uint32_t bh0, uint32_t hs, int dropout,
              int route, int s_w, int s_wo, cudaStream_t s) {
  using namespace blockgemm;
  const int t_pad = (t + 127) / 128 * 128, hd = heads * dh;
  const int lg = log2_exact(dh);
  if (lg < 0 || 256 % dh != 0) return (int)cudaErrorInvalidValue;
  const void* w3[3] = {wq, wk, wv};
  const void* g3[3] = {dq, dk, dv};
  const bool tma = route == kWgmma;
  auto wgmma = [&](int which) {
    return products_wgmma(which, x, w3, wo, dout, o, g3, dxo, dx, dw_part,
                          dwo_part, batch, t, d_model, heads, dh, s_w, s_wo,
                          s);
  };
  // 1. dxo = round(dout Wo) on the padded grid, head-major
  const PaddedRows<T> da{(const T*)dout, t, t_pad, d_model};
  const WeightCols<T> wot{{(const T*)wo, nullptr, nullptr}, hd};
  const HeadOut<T> dxe{{(T*)dxo, nullptr, nullptr}, {nullptr, nullptr,
                                                      nullptr},
                       t_pad, heads, lg};
  int err = tma ? wgmma(0)
                : gemm<T>(route, da, wot, dxe, batch * t_pad, hd, d_model,
                          d_model, d_model, 1, 1, s);
  if (err != 0) return err;
  // 2. dWo partials (s_wo, D, H*dh): dout^T o over the rows of all batch
  // rows, one K segment of T_pad (T real) per batch row
  const RowCols<T> dat{(const T*)dout, t, d_model};
  const HeadRows<T> ob{{(const T*)o, nullptr, nullptr}, t_pad, heads, lg};
  const Partial pwo{dwo_part, (long long)d_model * hd, hd};
  err = tma ? wgmma(1)
            : gemm<T>(route, dat, ob, pwo, d_model, hd, batch * t_pad, t_pad,
                      t, 1, s_wo, s);
  if (err != 0) return err;
  // 3-5. the core backward on (B, H, T_pad, dh), "kernel" semantics
  err = run_bwd(q, k, v, o32, dxo, key_valid, stats, dvec, dq_part, dq, dk,
                dv, dq32, dk32, dv32, batch, heads, t_pad, dh, dtype, scale,
                inv_keep, threshold, seed, bh0, hs, dropout, 0, 0, s);
  if (err != 0) return err;
  // 6. dW{q,k,v} partials (3, s_w, H*dh, D): d{q,k,v}^T x over the rows
  // of all batch rows
  const HeadRows<T> ga{{(const T*)dq, (const T*)dk, (const T*)dv}, t_pad,
                       heads, lg};
  const RowCols<T> xb{(const T*)x, t, d_model};
  const Partial pw{dw_part, (long long)hd * d_model, d_model};
  err = tma ? wgmma(2)
            : gemm<T>(route, ga, xb, pw, hd, d_model, batch * t_pad, t_pad, t,
                      3, s_w, s);
  if (err != 0) return err;
  // 7. dx = dq Wq + dk Wk + dv Wv over the real rows
  const HeadCols<T> gc{{(const T*)dq, (const T*)dk, (const T*)dv}, t, t_pad,
                       heads, lg};
  const WeightCols<T> w3c{{(const T*)wq, (const T*)wk, (const T*)wv},
                          d_model};
  const RowOut<T> xe{(T*)dx, nullptr, d_model};
  err = tma ? wgmma(3)
            : gemm<T>(route, gc, w3c, xe, batch * t, d_model, 3 * hd, hd, hd,
                      1, 1, s);
  if (err != 0) return err;
  // 8. bias partials from the f32 gradients
  const float* g32[3] = {(const float*)(dq32 ? dq32 : dq),
                         (const float*)(dk32 ? dk32 : dk),
                         (const float*)(dv32 ? dv32 : dv)};
  bias_partials_kernel<<<dim3((unsigned)heads, (unsigned)batch, 3), 256, 0,
                         s>>>(g32[0], g32[1], g32[2], db_part, heads, t_pad,
                              dh);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dout, dx: (B, T, D); wq, wk, wv: (H*dh, D), wo: (D, H*dh); key_valid:
// the forward's (B, T_pad) uint8 mask; q, k, v, o, stats, o32: the
// forward's (o32 = o for float32); dxo, dq, dk, dv: (B, H, T_pad, dh)
// scratch in the input dtype; dvec: (B*H*T_pad) f32 scratch; dq_part:
// (B*H, T_pad/64, T_pad, dh) f32 scratch; dq32, dk32,
// dv32: (B, H, T_pad, dh) f32 scratch for bfloat16, NULL for float32;
// dw_part: (3, s_w, H*dh, D), dwo_part: (s_wo, D, H*dh), db_part: (B, 3,
// H*dh), all f32; every pointer 16-byte aligned. dtype, scale, the
// dropout parameters and route as in the forward; s_w and s_wo the
// number of K slices of dW{q,k,v} and dWo (at least 1). Returns the
// cudaError_t of the eight launches.
extern "C" int a8t_attention_block_bwd(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* key_valid, const void* dout, const void* q,
    const void* k, const void* v, const void* o, const void* o32,
    const void* stats, void* dxo, void* dvec, void* dq_part, void* dq,
    void* dk, void* dv, void* dq32, void* dk32, void* dv32, void* dx,
    void* dw_part, void* dwo_part, void* db_part, int batch, int t,
    int d_model, int heads, int dh, int dtype, float scale, float inv_keep,
    uint32_t threshold, uint32_t seed, uint32_t bh0, uint32_t hs, int dropout, int route,
    int s_w, int s_wo, void* stream) {
  if (batch <= 0 || t <= 0 || d_model <= 0 || heads <= 0 || dh <= 0 ||
      s_w <= 0 || s_wo <= 0 ||
      route != blockgemm::block_route(dtype, d_model, heads, dh))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (dq32 == nullptr || dk32 == nullptr || dv32 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return block_bwd<float>(x, wq, wk, wv, wo, key_valid, dout, q, k, v, o,
                            o32, stats, dxo, dvec, dq_part, dq, dk, dv,
                            nullptr, nullptr, nullptr, dx, (float*)dw_part,
                            (float*)dwo_part, (float*)db_part, batch, t,
                            d_model, heads, dh, dtype, scale, inv_keep,
                            threshold, seed, bh0, hs, dropout, route, s_w, s_wo, s);
  if (dtype == 1)
    return block_bwd<__nv_bfloat16>(
        x, wq, wk, wv, wo, key_valid, dout, q, k, v, o, o32, stats, dxo, dvec,
        dq_part, dq, dk, dv, dq32, dk32, dv32, dx, (float*)dw_part,
        (float*)dwo_part, (float*)db_part, batch, t, d_model, heads, dh,
        dtype, scale, inv_keep, threshold, seed, bh0, hs, dropout, route, s_w, s_wo,
        s);
  return (int)cudaErrorInvalidValue;
}
