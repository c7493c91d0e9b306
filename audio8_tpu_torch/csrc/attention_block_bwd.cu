// Attention block, backward: dx and the per-batch-row partials of the
// weight and bias gradients of out = sum_h core(q_h, k_h, v_h) Wo_h + bo
// with q = round(x Wq^T) + bq (k and v the same).
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_block_kernel.py:
// _bwd_kernel (the block's custom VJP, one grid step per (batch, head),
// recomputing q/k/v and p). Same function, term by term:
//
//   * dxo = round(dout Wo_h^T) on the T_pad grid (zero past T);
//   * dWo partials: o_h^T dout in f32, o_h being the core's rounded output;
//   * the core backward is attention_bwd.cu's (its "kernel" semantics),
//     on the (B, H, T_pad, dh) grid with the forward's key mask, row
//     statistics and f32 output: p regenerated, the same hash-dropout
//     mask, ds not zeroed at masked keys (so a row with no valid key
//     gives the padded keys a dk and dv, as on the TPU); its dq, dk, dv
//     are written rounded to the input dtype and, for bf16, also in f32;
//   * dW{q,k,v} partials: x^T d{q,k,v} from the ROUNDED gradients, in f32;
//   * db{q,k,v} partials: column sums of the f32 gradients over all T_pad
//     rows;
//   * dx = sum_h dq_h Wq_h^T + dk_h Wk_h^T + dv_h Wv_h^T from the rounded
//     gradients, in f32, rounded once.
// The partials are per batch row z (the TPU kernel's are per (b, h)) and
// are summed by the caller; dbo is the caller's f32 sum of dout.
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
//   2. dWo partials: GEMM over each batch row's T rows (z = batch row);
//   3-5. the core backward (attention_bwd.cu: D, the fused pass, the dq
//      reduction);
//   6. dW{q,k,v} partials: GEMM over each batch row's T rows (z = which
//      of the three x batch row);
//   7. dx: one GEMM over K = 3 H dh, the three products as K segments;
//   8. bias partials: one CTA per (head, batch row, which), fixed-order
//      sums.
// No atomics: the result does not depend on scheduling. The GEMMs are
// attention_block_gemm.cuh's 64 x 64 tile (SIMT for f32, mma.sync for
// bf16); wgmma is later work.

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

template <typename T>
int block_bwd(const void* x, const void* wq, const void* wk, const void* wv,
              const void* wo, const void* key_valid, const void* dout,
              const void* q, const void* k, const void* v, const void* o,
              const void* o32, const void* stats, void* dxo, void* dvec,
              void* dq_part, void* dq, void* dk, void* dv, void* dq32, void* dk32,
              void* dv32, void* dx, float* dw_part, float* dwo_part,
              float* db_part, int batch, int t, int d_model, int heads,
              int dh, int dtype, float scale, float inv_keep,
              uint32_t threshold, uint32_t seed, int dropout,
              cudaStream_t s) {
  using namespace blockgemm;
  const int t_pad = (t + 127) / 128 * 128, hd = heads * dh;
  const int lg = log2_exact(dh);
  if (lg < 0 || 256 % dh != 0) return (int)cudaErrorInvalidValue;
  // 1. dxo = round(dout Wo) on the padded grid, head-major
  const PaddedRows<T> da{(const T*)dout, t, t_pad, d_model};
  const WeightCols<T> wot{{(const T*)wo, nullptr, nullptr}, hd};
  const HeadOut<T> dxe{{(T*)dxo, nullptr, nullptr}, {nullptr, nullptr,
                                                      nullptr},
                       t_pad, heads, lg};
  int err = gemm<T>(da, wot, dxe, batch * t_pad, hd, d_model, d_model, 1, s);
  if (err != 0) return err;
  // 2. dWo partials (B, D, H*dh): dout^T o per batch row
  const RowCols<T> dat{(const T*)dout, t, d_model, batch};
  const HeadRows<T> ob{{(const T*)o, nullptr, nullptr}, t_pad, heads, lg,
                       batch};
  const Partial pwo{dwo_part, (long long)d_model * hd, hd};
  err = gemm<T>(dat, ob, pwo, d_model, hd, t, t, batch, s);
  if (err != 0) return err;
  // 3-5. the core backward on (B, H, T_pad, dh), "kernel" semantics
  err = run_bwd(q, k, v, o32, dxo, key_valid, stats, dvec, dq_part, dq, dk,
                dv, dq32, dk32, dv32, batch, heads, t_pad, dh, dtype, scale,
                inv_keep, threshold, seed, dropout, 0, 0, s);
  if (err != 0) return err;
  // 6. dW{q,k,v} partials (3, B, H*dh, D): d{q,k,v}^T x per batch row
  const HeadRows<T> ga{{(const T*)dq, (const T*)dk, (const T*)dv}, t_pad,
                       heads, lg, batch};
  const RowCols<T> xb{(const T*)x, t, d_model, batch};
  const Partial pw{dw_part, (long long)hd * d_model, d_model};
  err = gemm<T>(ga, xb, pw, hd, d_model, t, t, 3 * batch, s);
  if (err != 0) return err;
  // 7. dx = dq Wq + dk Wk + dv Wv over the real rows
  const HeadCols<T> gc{{(const T*)dq, (const T*)dk, (const T*)dv}, t, t_pad,
                       heads, lg};
  const WeightCols<T> w3{{(const T*)wq, (const T*)wk, (const T*)wv},
                         d_model};
  const RowOut<T> xe{(T*)dx, nullptr, d_model};
  err = gemm<T>(gc, w3, xe, batch * t, d_model, 3 * hd, hd, 1, s);
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
// dw_part: (3, B, H*dh, D), dwo_part: (B, D, H*dh), db_part: (B, 3, H*dh),
// all f32. dtype, scale and the dropout parameters as in the forward.
// Returns the cudaError_t of the eight launches.
extern "C" int a8t_attention_block_bwd(
    const void* x, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* key_valid, const void* dout, const void* q,
    const void* k, const void* v, const void* o, const void* o32,
    const void* stats, void* dxo, void* dvec, void* dq_part, void* dq,
    void* dk, void* dv, void* dq32, void* dk32, void* dv32, void* dx, void* dw_part,
    void* dwo_part, void* db_part, int batch, int t, int d_model, int heads,
    int dh, int dtype, float scale, float inv_keep, uint32_t threshold,
    uint32_t seed, int dropout, void* stream) {
  if (batch <= 0 || t <= 0 || d_model <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (dq32 == nullptr || dk32 == nullptr || dv32 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return block_bwd<float>(x, wq, wk, wv, wo, key_valid, dout, q, k, v, o,
                            o32, stats, dxo, dvec, dq_part, dq, dk, dv,
                            nullptr,
                            nullptr, nullptr, dx, (float*)dw_part,
                            (float*)dwo_part, (float*)db_part, batch, t,
                            d_model, heads, dh, dtype, scale, inv_keep,
                            threshold, seed, dropout, s);
  if (dtype == 1)
    return block_bwd<__nv_bfloat16>(
        x, wq, wk, wv, wo, key_valid, dout, q, k, v, o, o32, stats, dxo, dvec,
        dq_part, dq, dk, dv, dq32, dk32, dv32, dx, (float*)dw_part, (float*)dwo_part,
        (float*)db_part, batch, t, d_model, heads, dh, dtype, scale,
        inv_keep, threshold, seed, dropout, s);
  return (int)cudaErrorInvalidValue;
}
