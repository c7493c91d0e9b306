// Attention core, backward: dq, dk, dv of
// o = softmax(q k^T * scale, key mask) [hash dropout] v, in one pass.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_kernel.py:
// _bwd_kernel, launched through pl.pallas_call in _call (:211) by
// _attn_bwd. Same function, term by term:
//
//   * p is recomputed from q, k and the forward's row statistics
//     (attention_fwd.cu writes the row max m and the row sum l):
//     p = exp(s - m) / l with s = q.k * scale;
//   * "kernel" semantics (xla = 0), the TPU kernel's: an invalid or
//     padded key's score is -1e9, so a row whose keys are all invalid is
//     the uniform 1/T_pad, and ds is NOT zeroed at masked columns (such a
//     row gets a dq and its keys a dk); dropout keeps column c of query
//     row r iff murmur(r * T_pad + c ^ (seed + b*H + h)) >= threshold;
//   * "xla" semantics (xla = 1), the JAX package's XLA attention
//     (audio8_tpu/nn/transformer.py, fused_attention=None): padded keys
//     (c >= T) are out of the softmax, invalid keys take -1e9, ds is zero
//     at every masked column (the gradient of jnp.where: a row with no
//     valid key gets no dq and gives no dk), dropout keeps (b, h, r, c)
//     iff murmur((((b*H + h)*T + r)*T + c) mod 2^32 ^ seed) >= threshold;
//     round_logits rounds the scaled logits to bf16 (bf16_softmax);
//   * pd = keep * p / (1 - rate), dp = keep * (dO.v) / (1 - rate),
//     ds = p * (dp - D) with D = rowsum(dp * p) = dO . o, taken from the
//     forward output in f32 (the forward's o32 copy for bf16 inputs);
//   * dv = pd^T dO, dq = ds k * scale, dk = ds^T q * scale, with pd and
//     ds rounded to the input dtype before their products as in the TPU
//     kernel (a no-op in f32), and f32 accumulation.
//
// What bounds it on H100: operations. Per head the work is five
// T x T x dh products, 10 B H T^2 dh FLOP (17.2 GFLOP at (4, 12, 749,
// 64): 0.257 ms at the 67 TFLOP/s f32 CUDA-core peak, 0.017 ms at the
// 989 TFLOP/s bf16 tensor-core peak); the (T, T) probabilities must
// never reach device memory. Three launches on one stream, no atomics,
// so the result does not depend on scheduling:
//   1. D prepass: D = rowsum(dO * o) in f32, one warp per row (bytes);
//   2. main kernel: one CTA per (batch*head, 64-key tile) keeps its K
//      and V tiles in shared memory and loops over the 64-query tiles,
//      the next tile's Q and dO (cp.async) and row statistics in flight
//      while the current one is computed. Per query tile: S^T = K Q^T
//      and dP^T = V dO^T; p, pd and ds from the row statistics and the
//      regenerated mask and dropout; dV += pd^T dO and dK += ds^T Q in
//      registers; this key tile's dQ contribution ds K, written in f32
//      to the key tile's slot of a workspace. Five products, each once
//      (the two-kernel design this replaces recomputed S and dP, seven);
//   3. dQ reduction: dq = scale * (sum of the partials in key-tile
//      order), also in f32 to dq32 when asked (the attention block's
//      bias gradients). (Summing in the main kernel, by the CTA that
//      finishes a head's last key tile, measured slower: one CTA per head
//      sums at the kernel's tail.)
// Two variants of the main kernel:
//   * bfloat16: the products on the tensor cores with wgmma (m64nNk16,
//     f32 accumulation), one warpgroup per CTA. S^T and dP^T accumulate
//     in registers with the keys as rows, so P^T and dS^T go straight
//     from the accumulators into bf16 A-operand registers for dV and dK;
//     dS^T also goes to shared memory, where the dQ product reads it
//     transposed. K, V, Q and dO are staged by 16-byte cp.async copies
//     into wgmma's canonical no-swizzle layout (8-row x 16-byte core
//     matrices), which serves as the K-major operand of S^T and dP^T and
//     as the transposed (MN-major) operand of dV, dK and dQ. Every head
//     dim the wrapper takes (16, 32, 64, 128) is a wgmma N, so no shape
//     falls back to mma.sync; misaligned tensors are copied to aligned
//     ones by the wrapper. Each product is waited for before the next
//     one (no producer warp, no swizzle: later work);
//   * float32: the CUDA cores (TF32 is not f32), 256 threads in two warp
//     groups, each thread an 8 x 4 block of one product: group 0 S^T,
//     group 1 dP^T (12 float4 reads for 128 FMAs, against 16 when every
//     thread took 4 x 4 of both); both go to shared memory, where all 256
//     threads take 16 elements each of the element step (p, pd, ds)
//     and write pd and ds in their place; then group 0 accumulates dV and
//     group 1 dK, 8 keys x dh/16 columns per thread (3 float4 reads for
//     32 FMAs at dh = 64, against 4). The dQ partial is one 64 x dh
//     product per tile over all 256 threads, 4 x dh/16 each: a larger
//     block would leave half the threads idle. Tiles arrive by cp.async,
//     double-buffered up to dh = 64 (dh = 128 single-buffered: two
//     stages would not fit). The 8 x 8 tile of attention_block_gemm.cuh
//     would need 128-query steps, whose tiles do not fit twice in shared
//     memory.
// With 64-key tiles the dq workspace is (B*H, ceil(T/64), T, dh) f32:
// 110 MB at (4, 12, 749, 64), written once and read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;  // desc, the wgmma instructions and their fences

constexpr int BQ = 64;   // query rows per step of the loop
constexpr int BKV = 64;  // keys per CTA: one dq partial each
constexpr float NEG = -1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ bool hash_keep(uint32_t idx, uint32_t seed,
                                          uint32_t threshold) {
  uint32_t x = idx ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const uint8_t* key_valid;  // (B, T) or null
  const float* stats;        // (B*H*T, 2): row max, row sum
  const float* dvec;         // (B*H*T): D = rowsum(dO * o)
  float* dq_part;            // (B*H, n_key_tiles, T, dh) f32 dq partials
  // f32 copies of dk and dv before their rounding to the input dtype,
  // each (B, H, T, dh) or null (the attention block's bias gradients)
  float* dk32;
  float* dv32;
  int n_heads, t, t_pad, n_kt;
  float scale, inv_keep;
  uint32_t threshold, seed;
  int dropout, xla, round_logits;
};

// First hash index of query row `row` of head bh (see the header).
__device__ __forceinline__ uint32_t drop_row(const Params& P, int bh,
                                             int row) {
  return P.xla ? ((uint32_t)bh * (uint32_t)P.t + (uint32_t)row) *
                     (uint32_t)P.t
               : (uint32_t)row * (uint32_t)P.t_pad;
}

// 1 / l of a row's softmax sum, 0 for a row past t (its staged l is 0;
// its q is zero, so s is finite and p = 0). Each staged pair is turned
// into (m, 1 / l) by the thread that copied it, after its wait.
__device__ __forceinline__ float inv_sum(float l) {
  return l > 0.f ? __frcp_rn(l) : 0.f;
}

// exp(x) by the hardware's ex2.approx (about 2 ulp; its output is rounded
// to bf16 before any product): the bf16 kernel's p.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// pd and ds of one (query row, key c) element of head bh from the raw
// products s = q.k and dpd = dO.v. key_real: c < T; key_ok: it is also
// valid. FAST: p from fast_exp (bf16) instead of expf (f32).
template <bool FAST>
__device__ __forceinline__ void element_grads(const Params& P, float s,
                                              float dpd, float m, float il,
                                              float d, bool key_real,
                                              bool key_ok, int bh, int row,
                                              int c, uint32_t seed_g,
                                              float& pd, float& ds) {
  float v = s * P.scale;
  if (P.round_logits) v = __bfloat162float(__float2bfloat16(v));
  const float x = (key_ok ? v : NEG) - m;
  const float e = FAST ? fast_exp(x) : expf(x);
  const float p = (P.xla && !key_real) ? 0.f : e * il;
  float dp = dpd;
  pd = p;
  if (P.dropout) {
    const bool keep = hash_keep(drop_row(P, bh, row) + (uint32_t)c, seed_g,
                                P.threshold);
    pd = keep ? p * P.inv_keep : 0.f;
    dp = keep ? dp * P.inv_keep : 0.f;
  }
  ds = (P.xla && !key_ok) ? 0.f : p * (dp - d);
}

// ------------------------------------ async copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 8 or 4 bytes global -> shared through L1; zeros when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The row statistics of query rows [q0, q0 + 64) into a stage of shared
// memory, in the tiles' cp.async group: the forward's (m, l) pairs as
// they lie in `stats` (ml[2 r], ml[2 r + 1]) and D (d[r]), zeros past t.
// Thread r < 64 copies pair r (and later turns its l into 1 / l), threads
// 64-127 the D values.
__device__ __forceinline__ void load_rows_async(float* ml, float* d,
                                                const Params& P, int bh,
                                                int q0) {
  const int r = threadIdx.x % 64, row = q0 + r;
  const bool in = row < P.t;
  const size_t i = (size_t)bh * P.t + (in ? row : 0);
  if (threadIdx.x < 64)
    cp_async8(smem_u32(ml + 2 * r), P.stats + 2 * i, in);
  else if (threadIdx.x < 128)
    cp_async4(smem_u32(d + r), P.dvec + i, in);
}

// ------------------------------------ 1. D = rowsum(dO * o)

template <typename T>
__global__ void __launch_bounds__(256)
    rowdot_kernel(const T* __restrict__ dout, const float* __restrict__ o,
                  float* __restrict__ dvec, int rows, int dh) {
  const int row = (blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps
  const size_t off = (size_t)row * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc += to_f32(dout[off + d]) * o[off + d];
  acc = warp_sum(acc);
  if (lane == 0) dvec[row] = acc;
}

// ------------------------------------ 3. dq = scale * sum of partials

// One float4 of dq per thread: the key tiles' partials summed in key-tile
// order, scaled, rounded to T, and in f32 to dq32 when asked.
template <typename T>
__global__ void __launch_bounds__(256)
    dq_reduce_kernel(const float* __restrict__ part, T* __restrict__ dq,
                     float* __restrict__ dq32, long long per_bh4, int n_kt,
                     long long total4, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total4) return;
  const long long bh = i / per_bh4;
  const float4* src = reinterpret_cast<const float4*>(part) +
                      bh * n_kt * per_bh4 + (i - bh * per_bh4);
  float4 acc = src[0];
  for (int kt = 1; kt < n_kt; ++kt) {
    const float4 v = src[(long long)kt * per_bh4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const float r[4] = {acc.x * scale, acc.y * scale, acc.z * scale,
                      acc.w * scale};
#pragma unroll
  for (int e = 0; e < 4; ++e) store(dq + 4 * i + e, r[e]);
  if (dq32 != nullptr)
    reinterpret_cast<float4*>(dq32)[i] = make_float4(r[0], r[1], r[2], r[3]);
}

// ------------------------------------ 2a. float32 on the CUDA cores

// Shared-memory plan of the f32 kernel, in floats: K, V (64 x dh each),
// STAGES x (Q, dO), pd and dp - D, then ds in its place ([query][key]),
// ds again ([key][query], for float4 reads of four queries), STAGES x
// ((m, l) pairs, D).
template <int DH>
struct F32Plan {
  static constexpr int LD = DH + 4;    // tile row pitch: float4 reads of
                                       // 8 consecutive rows hit distinct
                                       // banks
  static constexpr int PLD = BKV + 4;  // [query][key] pitch
  static constexpr int TLD = BQ + 8;   // [key][query] pitch: the element
                                       // step's writes hit distinct banks
  static constexpr int STAGES = DH == 128 ? 1 : 2;
  static constexpr int TILE = BQ * LD;
  static constexpr int K = 0, V = TILE, Q = 2 * TILE;  // dO = Q + TILE
  static constexpr int PD = Q + 2 * STAGES * TILE;
  static constexpr int DS = PD + BQ * PLD;
  static constexpr int DST = DS + BQ * PLD;
  static constexpr int ROWS = DST + BKV * TLD;
  static constexpr int FLOATS = ROWS + STAGES * 3 * BQ;
};

// Rows [r0, r0 + 64) of a (t, DH) f32 slab into a (64, DH + 4) tile,
// 16-byte copies along the rows, zeros past t.
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int t) {
  constexpr int CH = DH / 4, LD = DH + 4;
  for (int i = threadIdx.x; i < BQ * CH; i += 256) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < t;
    cp_async16(smem_u32(dst + r * LD + 4 * c),
               in ? src + (size_t)(r0 + r) * DH + 4 * c : src, in);
  }
}

// n = DJ consecutive floats of shared memory as float4/float2/float reads.
template <int DJ>
__device__ __forceinline__ void read_run(float (&out)[DJ], const float* p) {
  if constexpr (DJ % 4 == 0) {
#pragma unroll
    for (int j = 0; j < DJ; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else if constexpr (DJ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DH>
__global__ void __launch_bounds__(256, 1)
    attention_bwd_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             float* __restrict__ dk, float* __restrict__ dv,
                             Params P) {
  using L = F32Plan<DH>;
  constexpr int LD = L::LD, PLD = L::PLD, TLD = L::TLD, DJ = DH / 16;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, lane = tid % 32, w = (tid / 32) % 4;
  // two warp groups: group 0 (warps 0-3) takes S^T, then dV; group 1
  // (warps 4-7) dP^T, then dK
  const bool g1 = tid >= 128;
  // products S^T and dP^T: keys tk + 8 i, queries tq + 16 j
  const int tk = lane / 8 + 4 * (w % 2), tq = lane % 8 + 8 * (w / 2);
  // dV and dK: keys 4 ka + i and 32 + 4 ka + i, columns DJ kb + j
  const int ka = lane % 8, kb = lane / 8 + 4 * w;
  // the dQ partial: queries 4 ty + i, columns DJ tx + j
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, kt = blockIdx.x, c0 = kt * BKV, t = P.t;
  const int nq = (t + BQ - 1) / BQ;
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb =
      P.key_valid ? P.key_valid + (size_t)(bh / P.n_heads) * t : nullptr;
  const uint32_t seed_g = P.xla ? P.seed : P.seed + (uint32_t)bh;
  float* ks = fsm + L::K;
  float* vs = fsm + L::V;
  float* pds = fsm + L::PD;
  float* dss = fsm + L::DS;
  float* dst = fsm + L::DST;

  load_rows_f32<DH>(ks, k + base, c0, t);
  load_rows_f32<DH>(vs, v + base, c0, t);
  load_rows_f32<DH>(fsm + L::Q, q + base, 0, t);
  load_rows_f32<DH>(fsm + L::Q + L::TILE, dout + base, 0, t);
  load_rows_async(fsm + L::ROWS, fsm + L::ROWS + 2 * BQ, P, bh, 0);
  cp_commit();
  bool key_real[8], key_ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + tk + 8 * i;
    key_real[i] = c < t;
    key_ok[i] = key_real[i] && (kvb == nullptr || kvb[c] != 0);
  }
  float acc[8][DJ];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int stage = L::STAGES == 2 ? (qt & 1) : 0, q0 = qt * BQ;
    if (L::STAGES == 2 && qt + 1 < nq) {
      float* nqs = fsm + L::Q + 2 * (stage ^ 1) * L::TILE;
      float* nrs = fsm + L::ROWS + (stage ^ 1) * 3 * BQ;
      load_rows_f32<DH>(nqs, q + base, q0 + BQ, t);
      load_rows_f32<DH>(nqs + L::TILE, dout + base, q0 + BQ, t);
      load_rows_async(nrs, nrs + 2 * BQ, P, bh, q0 + BQ);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    float* rs = fsm + L::ROWS + stage * 3 * BQ;
    // each of threads 0-63 copied one (m, l) pair: l -> 1 / l in place
    if (tid < BQ) rs[2 * tid + 1] = inv_sum(rs[2 * tid + 1]);
    __syncthreads();
    const float* qs = fsm + L::Q + 2 * stage * L::TILE;
    const float* dos = qs + L::TILE;

    // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1): an 8 x 4 block
    // per thread, 12 float4 reads for 128 FMAs
    const float* ar = g1 ? vs : ks;
    const float* br = g1 ? dos : qs;
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 a4[8], b4[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a4[i] = *reinterpret_cast<const float4*>(ar + (tk + 8 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b4[j] = *reinterpret_cast<const float4*>(br + (tq + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = dot4(a4[i], b4[j], x[i][j]);
    }
    // s (group 0) and dp (group 1) to shared memory, where the element
    // step reads them and writes pd and ds in their place
    float* xs = g1 ? dss : pds;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xs[(tq + 16 * j) * PLD + tk + 8 * i] = x[i][j];
    __syncthreads();
    // the element step over all 256 threads: keys tk + 8 i, queries
    // eq + 32 j (lanes hit distinct banks in all three layouts)
    const int eq = lane % 8 + 8 * (tid / 64);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ql = eq + 32 * j;
      const float m = rs[2 * ql], il = rs[2 * ql + 1];
      const float dd = rs[2 * BQ + ql];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = tk + 8 * i, o = ql * PLD + key;
        float pd, ds;
        element_grads<false>(P, pds[o], dss[o], m, il, dd, key_real[i],
                             key_ok[i], bh, q0 + ql, c0 + key, seed_g, pd,
                             ds);
        pds[o] = pd;
        dss[o] = ds;
        dst[key * TLD + ql] = ds;
      }
    }
    __syncthreads();

    // dV += pd^T dO (group 0), dK += ds^T Q (group 1): 8 x DJ per thread
    {
      const float* pr = g1 ? dss : pds;
      const float* yr = g1 ? qs : dos;
#pragma unroll 4
      for (int ql = 0; ql < BQ; ++ql) {
        const float4 p0 =
            *reinterpret_cast<const float4*>(pr + ql * PLD + 4 * ka);
        const float4 p1 =
            *reinterpret_cast<const float4*>(pr + ql * PLD + 32 + 4 * ka);
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float yv[DJ];
        read_run<DJ>(yv, yr + ql * LD + DJ * kb);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            acc[i][j] = fmaf(pv[i], yv[j], acc[i][j]);
      }
    }
    // this key tile's dQ partial for queries q0 + 4 ty + i: one 64 x DH
    // product over all 256 threads, 4 x DJ each
    float aq[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) aq[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(dst + c * TLD + 4 * ty);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float kv[DJ];
      read_run<DJ>(kv, ks + c * LD + DJ * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) aq[i][j] = fmaf(sv[i], kv[j], aq[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row >= t) continue;
      float* part = P.dq_part + (((size_t)bh * P.n_kt + kt) * t + row) * DH +
                    DJ * tx;
#pragma unroll
      for (int j = 0; j < DJ; ++j) part[j] = aq[i][j];
    }
    __syncthreads();
    if (L::STAGES == 1 && qt + 1 < nq) {
      load_rows_f32<DH>(fsm + L::Q, q + base, q0 + BQ, t);
      load_rows_f32<DH>(fsm + L::Q + L::TILE, dout + base, q0 + BQ, t);
      load_rows_async(fsm + L::ROWS, fsm + L::ROWS + 2 * BQ, P, bh,
                      q0 + BQ);
      cp_commit();
    }
  }

  float* out = g1 ? dk : dv;
  float* out32 = g1 ? P.dk32 : P.dv32;
  const float scale = g1 ? P.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + 4 * ka + (i < 4 ? i : 28 + i);
    if (c >= t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t off = base + (size_t)c * DH + DJ * kb + j;
      out[off] = acc[i][j] * scale;
      if (out32 != nullptr) out32[off] = acc[i][j] * scale;
    }
  }
}

// ------------------------------------ 2b. bfloat16 on the tensor cores

// Shared-memory plan of the bf16 kernel, in bytes: K, V, 2 x (Q, dO)
// (64 x dh each, core-matrix layout), dS^T (64 x 64), 2 x ((m, l)
// pairs, D).
template <int DH>
struct WgPlan {
  static constexpr int TILE = BQ * DH * 2;
  static constexpr int RB = DH * 16;  // bytes of 8 tile rows
  static constexpr int K = 0, V = TILE, Q = 2 * TILE;  // dO = Q + TILE
  static constexpr int DS = 6 * TILE;
  static constexpr int ROWS = DS + BKV * BQ * 2;
  static constexpr int BYTES = ROWS + 2 * 3 * BQ * 4;
};

// Rows [r0, r0 + 64) of a (t, DH) bf16 slab into the core-matrix layout:
// the 16-byte chunk c of row r at ((r / 8) * DH / 8 + c) * 128 +
// (r % 8) * 16, zeros past t. Copy i lands at byte 16 i.
template <int DH>
__device__ __forceinline__ void load_core_tile(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               int r0, int t) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += 128) {
    const int r = (i / (8 * CH)) * 8 + i % 8, c = (i / 8) % CH;
    const bool in = r0 + r < t;
    cp_async16(dst + 16 * i, in ? src + (size_t)(r0 + r) * DH + 8 * c : src,
               in);
  }
}

// As a K-major operand (rows along M or N, DH along K), k-step kk of the
// tile at `a`; as an MN-major operand (DH along N, rows along K), k-step
// kk (16 rows), columns from n0 on.
template <int DH>
__device__ __forceinline__ uint64_t kmajor(uint32_t a, int kk) {
  return desc(a + 256 * kk, 128, WgPlan<DH>::RB);
}
template <int DH>
__device__ __forceinline__ uint64_t mnmajor(uint32_t a, int kk, int n0) {
  return desc(a + 2 * WgPlan<DH>::RB * kk + 16 * n0, WgPlan<DH>::RB, 128);
}

template <int DH>
__global__ void __launch_bounds__(128)
    attention_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, Params P) {
  using L = WgPlan<DH>;
  constexpr int NA = DH / 2;              // floats of a 64 x DH accumulator
  constexpr int NC = DH < 64 ? DH : 64;   // columns per dQ product
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sb = smem_u32(smem);
  float* rows = reinterpret_cast<float*>(smem + L::ROWS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int bh = blockIdx.y, kt = blockIdx.x, c0 = kt * BKV, t = P.t;
  const int nq = (t + BQ - 1) / BQ;
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb =
      P.key_valid ? P.key_valid + (size_t)(bh / P.n_heads) * t : nullptr;
  const uint32_t seed_g = P.xla ? P.seed : P.seed + (uint32_t)bh;

  load_core_tile<DH>(sb + L::K, k + base, c0, t);
  load_core_tile<DH>(sb + L::V, v + base, c0, t);
  load_core_tile<DH>(sb + L::Q, q + base, 0, t);
  load_core_tile<DH>(sb + L::Q + L::TILE, dout + base, 0, t);
  load_rows_async(rows, rows + 2 * BQ, P, bh, 0);
  cp_commit();
  // this thread's keys: accumulator rows 16 warp + g + 8 h
  bool key_real[2], key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * warp + g + 8 * h;
    key_real[h] = c < t;
    key_ok[h] = key_real[h] && (kvb == nullptr || kvb[c] != 0);
  }
  float adv[NA], adk[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) adv[e] = adk[e] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int stage = qt & 1, q0 = qt * BQ;
    const uint32_t sq = sb + L::Q + 2 * stage * L::TILE, sdo = sq + L::TILE;
    float* rs = rows + stage * 3 * BQ;
    if (qt + 1 < nq) {
      const uint32_t nqa = sb + L::Q + 2 * (stage ^ 1) * L::TILE;
      float* nrs = rows + (stage ^ 1) * 3 * BQ;
      load_core_tile<DH>(nqa, q + base, q0 + BQ, t);
      load_core_tile<DH>(nqa + L::TILE, dout + base, q0 + BQ, t);
      load_rows_async(nrs, nrs + 2 * BQ, P, bh, q0 + BQ);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    // each of threads 0-63 copied one (m, l) pair: l -> 1 / l in place
    if (tid < BQ) rs[2 * tid + 1] = inv_sum(rs[2 * tid + 1]);
    fence_async_smem();
    __syncthreads();

    // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 queries, K = DH
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    keep_regs(adv);
    keep_regs(adk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<0, 0>(st, kmajor<DH>(sb + L::K, kk), kmajor<DH>(sq, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<0, 0>(dpt, kmajor<DH>(sb + L::V, kk), kmajor<DH>(sdo, kk), 1);
    wg_commit();
    wg_wait<0>();
    keep_regs(st);
    keep_regs(dpt);

    // pd^T and ds^T, rounded to bf16, as A fragments (k-step kk: queries
    // 16 kk .. 16 kk + 15); ds^T also to shared memory
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ql = 8 * j + 2 * u;
      // (m, 1 / l) of queries ql and ql + 1, and their D
      const float4 ml = *reinterpret_cast<const float4*>(rs + 2 * ql);
      const float2 m2 = make_float2(ml.x, ml.z);
      const float2 il2 = make_float2(ml.y, ml.w);
      const float2 d2 = *reinterpret_cast<const float2*>(rs + 2 * BQ + ql);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * warp + g + 8 * h;
        float pd0, ds0, pd1, ds1;
        element_grads<true>(P, st[4 * j + 2 * h], dpt[4 * j + 2 * h], m2.x,
                            il2.x, d2.x, key_real[h], key_ok[h], bh, q0 + ql,
                            c, seed_g, pd0, ds0);
        element_grads<true>(P, st[4 * j + 2 * h + 1], dpt[4 * j + 2 * h + 1],
                            m2.y, il2.y, d2.y, key_real[h], key_ok[h], bh,
                            q0 + ql + 1, c, seed_g, pd1, ds1);
        pa[j / 2][2 * (j % 2) + h] = pack_bf16(pd0, pd1);
        sa[j / 2][2 * (j % 2) + h] = pack_bf16(ds0, ds1);
        // dS^T (key, query) at (key / 8) * 1024 + (query / 8) * 128 +
        // (key % 8) * 16 + (query % 8) * 2: the MN-major A of dS K
        *reinterpret_cast<uint32_t*>(smem + L::DS + (2 * warp + h) * 1024 +
                                     j * 128 + g * 16 + u * 4) =
            sa[j / 2][2 * (j % 2) + h];
      }
    }

    // dV += pd^T dO, dK += ds^T Q: 64 keys x DH, K = 64 queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(adv, pa[kk], mnmajor<DH>(sdo, kk, 0), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(adk, sa[kk], mnmajor<DH>(sq, kk, 0), 1);
    wg_commit();
    fence_async_smem();
    __syncthreads();  // dS^T is in shared memory

    // this key tile's dQ partial: dS (64 queries x 64 keys) K, NC columns
    // at a time
#pragma unroll
    for (int n0 = 0; n0 < DH; n0 += NC) {
      float aq[NC / 2];
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) aq[e] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(aq, desc(sb + L::DS + 2048 * kk, 1024, 128),
                       mnmajor<DH>(sb + L::K, kk, n0), 1);
      wg_commit();
      wg_wait<0>();
      keep_regs(aq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 16 * warp + g + 8 * h;
        if (row >= t) continue;
        float* dst = P.dq_part +
                     (((size_t)bh * P.n_kt + kt) * t + row) * DH + n0 + 2 * u;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(aq[4 * j + 2 * h], aq[4 * j + 2 * h + 1]);
      }
    }
    keep_regs(adv);
    keep_regs(adk);
    __syncthreads();  // every product of this tile is done with its tiles
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * warp + g + 8 * h;
    if (c >= t) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const size_t off = base + (size_t)c * DH + 8 * j + 2 * u;
      const float k0 = adk[4 * j + 2 * h] * P.scale;
      const float k1 = adk[4 * j + 2 * h + 1] * P.scale;
      const float v0 = adv[4 * j + 2 * h], v1 = adv[4 * j + 2 * h + 1];
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(k0, k1);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(v0, v1);
      if (P.dk32 != nullptr)
        *reinterpret_cast<float2*>(P.dk32 + off) = make_float2(k0, k1);
      if (P.dv32 != nullptr)
        *reinterpret_cast<float2*>(P.dv32 + off) = make_float2(v0, v1);
    }
  }
}

// ------------------------------------ launches

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               void* dk, void* dv, int bh, const Params& P, cudaStream_t s) {
  const int smem = (int)(sizeof(float) * F32Plan<DH>::FLOATS);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_f32_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_f32_kernel<DH><<<dim3((unsigned)P.n_kt, (unsigned)bh), 256,
                                 smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (float*)dk, (float*)dv, P);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, void* dk, void* dv, int bh,
                 const Params& P, cudaStream_t s) {
  const int smem = WgPlan<DH>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_wgmma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_wgmma_kernel<DH><<<dim3((unsigned)P.n_kt, (unsigned)bh), 128,
                                   smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, P);
  return (int)cudaGetLastError();
}

int launch_main(int dh, int dtype, const void* q, const void* k,
                const void* v, const void* dout, void* dk, void* dv, int bh,
                const Params& P, cudaStream_t s) {
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch_f32<16>(q, k, v, dout, dk, dv, bh, P, s);
      case 32: return launch_f32<32>(q, k, v, dout, dk, dv, bh, P, s);
      case 64: return launch_f32<64>(q, k, v, dout, dk, dv, bh, P, s);
      case 128: return launch_f32<128>(q, k, v, dout, dk, dv, bh, P, s);
    }
  } else {
    switch (dh) {
      case 16: return launch_wgmma<16>(q, k, v, dout, dk, dv, bh, P, s);
      case 32: return launch_wgmma<32>(q, k, v, dout, dk, dv, bh, P, s);
      case 64: return launch_wgmma<64>(q, k, v, dout, dk, dv, bh, P, s);
      case 128: return launch_wgmma<128>(q, k, v, dout, dk, dv, bh, P, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The whole backward on one stream: a8t_attention_bwd's arguments, plus
// optional f32 copies of dq, dk and dv (dq32, dk32, dv32; null = none).
int run_bwd(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* key_valid, const void* stats,
            void* dvec, void* dq_part, void* dq, void* dk, void* dv,
            void* dq32, void* dk32, void* dv32, int batch, int heads, int t,
            int dh, int dtype, float scale, float inv_keep,
            uint32_t threshold, uint32_t seed, int dropout, int xla,
            int round_logits, cudaStream_t s) {
  if (batch <= 0 || heads <= 0 || t <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of every row and vector stores of every output
  const uintptr_t all = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)o | (uintptr_t)dout | (uintptr_t)dq_part |
                        (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv |
                        (uintptr_t)dq32 | (uintptr_t)dk32 | (uintptr_t)dv32;
  if (all % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Params P;
  P.key_valid = (const uint8_t*)key_valid;
  P.stats = (const float*)stats;
  P.dvec = (const float*)dvec;
  P.dq_part = (float*)dq_part;
  P.dk32 = (float*)dk32;
  P.dv32 = (float*)dv32;
  P.n_heads = heads;
  P.t = t;
  P.t_pad = (t + 127) / 128 * 128;
  P.n_kt = (t + BKV - 1) / BKV;
  P.scale = scale;
  P.inv_keep = inv_keep;
  P.threshold = threshold;
  P.seed = seed;
  P.dropout = dropout;
  P.xla = xla;
  P.round_logits = round_logits;
  const int bh = batch * heads, rows = bh * t;
  // 1. D
  if (dtype == 0)
    rowdot_kernel<float><<<(rows + 7) / 8, 256, 0, s>>>(
        (const float*)dout, (const float*)o, (float*)dvec, rows, dh);
  else
    rowdot_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, s>>>(
        (const __nv_bfloat16*)dout, (const float*)o, (float*)dvec, rows, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. dk, dv and the dq partials
  const int main_err = launch_main(dh, dtype, q, k, v, dout, dk, dv, bh, P, s);
  if (main_err != 0) return main_err;
  // 3. dq
  const long long per_bh4 = (long long)t * dh / 4, total4 = bh * per_bh4;
  const unsigned blocks = (unsigned)((total4 + 255) / 256);
  if (dtype == 0)
    dq_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)dq_part, (float*)dq, (float*)dq32, per_bh4, P.n_kt,
        total4, scale);
  else
    dq_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const float*)dq_part, (__nv_bfloat16*)dq, (float*)dq32, per_bh4,
        P.n_kt, total4, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, T, dh) contiguous, 16-byte aligned;
// o: the forward output in f32 (the output itself for f32 inputs, the
// forward's o32 copy for bf16); key_valid: (B, T) uint8 or NULL; stats:
// the forward's (B*H*T, 2) f32 row max and row sum; dvec: (B*H*T) f32
// scratch; dq_part: (B*H, ceil(T/64), T, dh) f32 scratch; dq32, dk32,
// dv32: (B, H, T, dh) f32 copies of the gradients before their rounding,
// or NULL. dtype: 0 = float32, 1 = bfloat16. inv_keep = 1 / (1 - rate);
// threshold and seed as in the forward (dropout = 0 skips the hash); xla
// and round_logits pick the semantics as in the forward. Returns the
// cudaError_t of the launches.
extern "C" int a8t_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* key_valid, const void* stats,
                                 void* dvec, void* dq_part, void* dq,
                                 void* dk, void* dv, void* dq32, void* dk32,
                                 void* dv32, int batch, int heads, int t,
                                 int dh, int dtype, float scale,
                                 float inv_keep, uint32_t threshold,
                                 uint32_t seed, int dropout, int xla,
                                 int round_logits, void* stream) {
  return run_bwd(q, k, v, o, dout, key_valid, stats, dvec, dq_part, dq, dk,
                 dv, dq32, dk32, dv32, batch, heads, t, dh, dtype, scale,
                 inv_keep, threshold, seed, dropout, xla, round_logits,
                 (cudaStream_t)stream);
}
