// Attention core, forward: softmax(q k^T * scale, key mask) [hash dropout] v.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/attention_kernel.py:
// _fwd_kernel (built from _probs and _hash_keep, driven by _attn_fwd /
// attention_core). Same function, term by term:
//
//   * scores in f32; a key column c is invalid when c >= T or
//     key_valid[b, c] == 0, and its score is REPLACED by -1e9 before the
//     row max, as in _probs;
//   * the TPU kernel pads T to T_pad = round_up(T, 128) and softmaxes over
//     all T_pad columns, so a row whose keys are all invalid gives a
//     uniform 1/T_pad. Here only ceil(T/64) key tiles are visited and the
//     missing columns are added to the row sum at the end as
//     (T_pad - visited) * exp(-1e9 - m): zero for a normal row, and the
//     same 1/T_pad weights for an all-invalid row (the zero-length filler
//     rows of a serving batch);
//   * dropout keeps column c of query row r iff
//     murmur(r * T_pad + c ^ (seed + b*H + h)) >= threshold, in uint32
//     arithmetic, exactly as _hash_keep; it applies to the NORMALISED
//     probabilities, so the full un-dropped row sum l is kept and the
//     output is sum(keep * e * v) / (l * (1 - rate));
//   * with bf16 inputs the TPU kernel rounds the probabilities to bf16
//     before P.V; this kernel rounds the un-normalised e = exp(s - m) to
//     bf16 instead (a different rounding point, covered by the stated
//     bf16 tolerance).
//
// With xla = 1 it computes the JAX package's XLA attention instead
// (audio8_tpu/nn/transformer.py:MultiHeadAttention, the path of
// fused_attention=None): padded columns (c >= T) are out of the softmax
// (-inf, no missing term), so a row with no valid key is uniform over its
// T keys; dropout keeps (b, h, r, c) iff murmur((((b*H + h)*T + r)*T + c)
// mod 2^32 ^ seed) >= threshold, one seed per call, as
// nn/dropout.py:_hash_keep_mask over the (B, H, T, T) probabilities; and
// with round_logits the scaled logits are rounded to bf16 before the
// softmax (bf16_softmax under bf16 compute; JAX then runs the softmax in
// bf16, this kernel in f32).
//
// What bounds it on H100: at T' ~ 1500 frames and dh = 64 the work is the
// score and P.V products (4*T^2*dh FLOP per head) with a T^2 probability
// matrix that must never reach device memory (the plain version writes
// and re-reads it several times): operations, 0.028 ms in bf16 and 0.41
// ms in f32 at the serving shape (4, 12, 1499, 64). One CTA per
// (batch*head, query tile) loops over 64-key tiles with the online max
// and sum in f32; the probabilities never leave the SM. Three routes,
// chosen from the dtype, the head dim and the pointers' alignment alone
// (fwd_route, mirrored by ops/attention.py:attention_route):
//   * wgmma (bf16, head dim 64 or 128, 16-byte aligned): FlashAttention-3
//     shaped. 128 query rows per CTA in two consumer warpgroups of 64 and
//     one producer warp that brings Q once and the K and V tiles through
//     a ring of two stages by TMA (rank-3 (dh, T, B*H) tensor maps,
//     128-byte swizzle, rows >= T zero-filled), with full and empty
//     mbarriers. S = Q K^T is wgmma with both operands in shared memory;
//     the scale, the logit rounding, the mask and the online softmax run
//     on the accumulator registers, in log2 units (the scale folded with
//     log2 e, 2^x as one ex2.approx instruction): at head dim 64 the
//     exponentials and the other per-score instructions, not the tensor
//     cores, set the pace, so a tile with no masked key skips the mask
//     (one 64-bit word of valid bits per tile, two warp ballots) and the
//     bf16 rounding takes one packed conversion per two logits. P goes
//     from the S accumulator straight into the register A operand of O
//     += P V (two adjacent n8 column groups are one k16 fragment), V
//     read MN-major through the descriptor's transpose bit. At head dim
//     64 the kernel fits 96 registers, so two CTAs (four consumer
//     warpgroups) share an SM and one's softmax overlaps another's
//     products. The output leaves through shared memory in 16-byte
//     runs;
//   * mma.sync (bf16 at head dim 16 or 32, aligned): mma.sync m16n8k16,
//     4 warps of 16 query rows, scores, probabilities and the output
//     accumulator in registers (the FlashAttention-2 register layout);
//   * SIMT (every f32 call, and misaligned bf16): the products on the
//     CUDA cores in full f32 (TF32 would not be), 64 queries x 64 keys
//     per tile over 128 threads, each holding an 8 x 4 block of S (8
//     queries, keys tx + 16 j) and 8 x dh/16 of O. Q and the K and V
//     tiles stay row-major in shared memory (K padded to dh + 4 floats,
//     so a quarter-warp's float4 reads of four keys hit distinct banks)
//     and each 4-deep step reads float4s: 12 float4 loads per 128 FMA,
//     the Q loads broadcast within a quarter-warp, which is the same
//     count a [d][query] / [d][key] layout gives while letting the tiles
//     arrive by 4-byte cp.async without a transpose. One K and one V
//     tile (67 KB of shared memory in all below head dim 128) lets three
//     CTAs share an SM, and 64-query CTAs fill the SMs' slots in whole
//     waves at the serving shape: this timed faster than 128-query CTAs
//     with the next tile in flight, or two to an SM, and than 8 x 8
//     blocks (PERF.md). The row max and sum are reduced by shuffles
//     among the 16 lanes that share a row; only P goes through shared
//     memory, once, for P.V, and its rows are the writing warp's own. The exponentials are exp2f of
//     round(x * log2e) - round(m * log2e), x the scaled logit and m the
//     row max in natural units: a masked score equal to the row max
//     gives exactly 1, so an all-invalid row stays exactly uniform. bf16
//     inputs are converted on the way in (plain loads).
// On every route a row with no valid key has every score at -1e9 (times
// log2 e on the wgmma route), each weight exactly 1, and `stats` holds
// m = -1e9 exactly.

// When the caller needs the gradient it passes `stats`, (B*H*T, 2) f32,
// and each kernel writes every real row's softmax statistics there: the
// row max m and the full (un-dropped, T_pad-wide) row sum l, so that the
// backward kernel (attention_bwd.cu) recomputes p = exp(s - m) / l
// without a second pass over the keys. Both are kept apart because
// m + log(l) would lose log(T_pad) against m = -1e9 in f32. For bf16
// inputs it may also pass `o32`, (B, H, T, dh) f32, for the output before
// its rounding to bf16: the backward takes D = rowsum(dO * o) from it, as
// the TPU kernel takes D from f32 probabilities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_gemm.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;    // query rows per CTA of the mma.sync route
constexpr int BKV = 64;   // key columns per tile, every route
constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

enum FwdRoute { kFwdSimt = 0, kFwdMma = 1, kFwdWgmma = 2 };

// The route of a call from its dtype (0 = float32, 1 = bfloat16), head
// dim and whether q, k, v and o are 16-byte aligned;
// ops/attention.py:attention_route mirrors it.
__host__ __device__ inline int fwd_route(int dtype, int dh, int aligned) {
  if (dtype != 1 || !aligned) return kFwdSimt;
  return (dh == 64 || dh == 128) ? kFwdWgmma : kFwdMma;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rounds a probability to the P.V operand precision of the input dtype.
__device__ __forceinline__ float operand_round(float v, float) { return v; }
__device__ __forceinline__ float operand_round(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
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

// The scaled logit; with round_logits (the "xla" semantics under
// bf16_softmax) rounded to bf16 as JAX's bf16 einsum output is.
__device__ __forceinline__ float logit(float s, float scale, int round_logits) {
  const float v = s * scale;
  return round_logits ? __bfloat162float(__float2bfloat16(v)) : v;
}

// Score of a key column that is not attended: -1e9 for an invalid key,
// and for a padded column (c >= t) under the "kernel" semantics; -inf
// (out of the softmax) for a padded column under "xla".
__device__ __forceinline__ float masked_score(int c, int t, int xla) {
  return (xla && c >= t) ? -INFINITY : NEG;
}

// exp(x - m) as exp2 of the two log2e-scaled values, each rounded on its
// own (m2 = __fmul_rn(m, LOG2E)), so x == m gives exactly 1.
__device__ __forceinline__ float exp_from(float x, float m2) {
  return exp2f(__fmul_rn(x, LOG2E) - m2);
}

// Row sum of a finished row: the visited columns' sum plus, under the
// "kernel" semantics, the columns [n_tiles * BKV, t_pad) at -1e9.
__device__ __forceinline__ float row_sum(float l, float m, int missing) {
  return missing ? l + (float)missing * exp_from(NEG, __fmul_rn(m, LOG2E))
                 : l;
}

// The wgmma route's softmax runs in log2 units: the masked score -1e9
// times log2(e), 2^x by one MUFU instruction (ex2.approx.ftz, relative
// error about 2^-22, far below the bf16 rounding of P), and two logits
// rounded to bf16 by one packed conversion.
constexpr float NEG2 = NEG * LOG2E;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float masked_score2(int c, int t, int xla) {
  return (xla && c >= t) ? -INFINITY : NEG2;
}
__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void bf16_round2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
}

// First hash index of query row `row`: row * T_pad ("kernel", the TPU
// kernel's per-head mask) or the flat (B, H, T, T) index of (bh, row, 0)
// ("xla", nn/dropout.py's _hash_keep_mask), mod 2^32.
__device__ __forceinline__ uint32_t drop_row(int xla, int bh, int row, int t,
                                             int t_pad) {
  return xla ? ((uint32_t)bh * (uint32_t)t + (uint32_t)row) * (uint32_t)t
             : (uint32_t)row * (uint32_t)t_pad;
}

// Bit c of the result: key c0 + c (c < 64) is attended (c0 + c < t and
// its key_valid byte is set). Every lane of the warp must call it.
__device__ __forceinline__ uint64_t tile_mask(const uint8_t* kvb, int c0,
                                              int t, int lane) {
  const int ca = c0 + lane, cb = c0 + 32 + lane;
  const bool va = ca < t && (kvb == nullptr || kvb[ca] != 0);
  const bool vb = cb < t && (kvb == nullptr || kvb[cb] != 0);
  return (uint64_t)__ballot_sync(0xffffffffu, va) |
         ((uint64_t)__ballot_sync(0xffffffffu, vb) << 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4 bytes global -> shared through L1; zeros when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------ SIMT: float32, and misaligned bf16

constexpr int SQ = 64;  // query rows per CTA: ty = tid / TX owns 8 ty .. + 7
constexpr int TX = 16;   // threads sharing a query row (8 x 4 scores each)
constexpr int SNT = SQ / 8 * TX;

// Shared memory of a CTA, in floats: Q, one K and one V tile, P. Below
// head dim 128 it is 67 KB, so three CTAs (12 warps) share an SM.
template <int DH>
struct SimtPlan {
  static constexpr int KJ = BKV / TX;            // keys per thread
  static constexpr int DJ = DH / TX;             // output columns per thread
  static constexpr int MINB = DH == 128 ? 1 : 3;  // CTAs per SM
  static constexpr int KLD = DH + 4;             // k row pitch, floats
  static constexpr int PLD = SQ + 4;             // p: [key][query]
  static constexpr int Q = 0;
  static constexpr int K = Q + SQ * DH;
  static constexpr int V = K + BKV * KLD;
  static constexpr int P = V + BKV * DH;
  static constexpr int FLOATS = P + BKV * PLD;
};

// Rows [r0, r0 + rows) of a (t, DH) tensor into shared memory with row
// pitch `ld` floats (zeros for rows >= t): 4-byte cp.async for float,
// converted through registers for bf16.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int r0,
                                           int rows, int t) {
  for (int i = threadIdx.x; i < rows * DH; i += SNT) {
    const int r = i / DH, d = i % DH;
    const bool in = r0 + r < t;
    cp_async4(smem_u32(dst + r * ld + d),
              in ? src + (size_t)(r0 + r) * DH + d : src, in);
  }
}
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const __nv_bfloat16* src, int r0,
                                           int rows, int t) {
  for (int i = threadIdx.x; i < rows * DH; i += SNT) {
    const int r = i / DH, d = i % DH;
    dst[r * ld + d] =
        r0 + r < t ? __bfloat162float(src[(size_t)(r0 + r) * DH + d]) : 0.f;
  }
}

// Output column jj (of DJ) of thread tx: runs of 4 at 4 TX g + 4 tx for
// DJ >= 4, else DJ adjacent columns from DJ tx.
template <int DH>
__device__ __forceinline__ int out_col(int tx, int jj) {
  constexpr int DJ = SimtPlan<DH>::DJ;
  return DJ >= 4 ? (jj / 4) * 4 * TX + 4 * tx + jj % 4 : DJ * tx + jj;
}

template <typename T, int DH>
__global__ void __launch_bounds__(SNT, SimtPlan<DH>::MINB)
    attention_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const uint8_t* __restrict__ key_valid,
                              T* __restrict__ o, float* __restrict__ stats,
                              float* __restrict__ o32, int n_heads, int t,
                              int t_pad, float scale, float inv_keep,
                              uint32_t threshold, uint32_t seed, int dropout,
                              int xla, int round_logits) {
  using Plan = SimtPlan<DH>;
  constexpr int KJ = Plan::KJ, DJ = Plan::DJ;
  constexpr int KLD = Plan::KLD, PLD = Plan::PLD;
  extern __shared__ float smem[];
  float* q_s = smem + Plan::Q;
  const float* k_s = smem + Plan::K;
  const float* v_s = smem + Plan::V;
  float* p_s = smem + Plan::P;

  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.y, b = bh / n_heads;
  const int q0 = blockIdx.x * SQ;
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb = key_valid ? key_valid + (size_t)b * t : nullptr;
  const uint32_t seed_g = xla ? seed : seed + (uint32_t)bh;
  const T type_tag{};
  const int n_tiles = (t + BKV - 1) / BKV;

  stage_rows<DH>(q_s, DH, q + base, q0, SQ, t);

  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    if (kt > 0) __syncthreads();  // every thread is done with tile kt - 1
    stage_rows<DH>(smem + Plan::K, KLD, k + base, c0, BKV, t);
    stage_rows<DH>(smem + Plan::V, DH, v + base, c0, BKV, t);
    cp_commit();
    const uint64_t valid = tile_mask(kvb, c0, t, lane);
    cp_wait<0>();
    __syncthreads();

    // S for rows 8 ty + i, keys tx + TX j, 4 deep per step
    float s[8][KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 kk[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kk[j] = *reinterpret_cast<const float4*>(k_s + (tx + TX * j) * KLD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + (8 * ty + i) * DH + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
        }
      }
    }

    // mask, scale, online softmax; a row's TX lanes (same ty) reduce by
    // shuffles over the low lane bits
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int c = tx + TX * j;
        s[i][j] = (valid >> c) & 1 ? logit(s[i][j], scale, round_logits)
                                   : masked_score(c0 + c, t, xla);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float m2 = __fmul_rn(m_new, LOG2E);
      const float alpha = exp2f(__fmul_rn(m_r[i], LOG2E) - m2);
      m_r[i] = m_new;
      float sum = 0.f;
      const uint32_t rowbase =
          dropout ? drop_row(xla, bh, q0 + 8 * ty + i, t, t_pad) : 0u;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float e = exp_from(s[i][j], m2);
        sum += e;
        if (dropout &&
            !hash_keep(rowbase + (uint32_t)(c0 + tx + TX * j), seed_g,
                       threshold))
          e = 0.f;
        s[i][j] = operand_round(e, type_tag);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    // P as [key][query]: rows 8 ty .. 8 ty + 7 are this warp's own
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(p_s + (tx + TX * j) * PLD + 8 * ty +
                                   4 * hh) =
            make_float4(s[4 * hh][j], s[4 * hh + 1][j], s[4 * hh + 2][j],
                        s[4 * hh + 3][j]);
    __syncwarp();

    // acc += P . V
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + c * PLD + 8 * ty);
      const float4 pb =
          *reinterpret_cast<const float4*>(p_s + c * PLD + 8 * ty + 4);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[DJ];
      if constexpr (DJ >= 4) {
#pragma unroll
        for (int g4 = 0; g4 < DJ / 4; ++g4) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              v_s + c * DH + 4 * TX * g4 + 4 * tx);
          vv[4 * g4] = v4.x;
          vv[4 * g4 + 1] = v4.y;
          vv[4 * g4 + 2] = v4.z;
          vv[4 * g4 + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) vv[jj] = v_s[c * DH + DJ * tx + jj];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p[i], vv[jj], acc[i][jj]);
    }
    __syncwarp();  // p_s is read before the next tile's scores land there
  }

  // columns [n_tiles * BKV, t_pad) are -1e9 in the TPU kernel's softmax
  // and out of the XLA attention's
  const int missing = xla ? 0 : t_pad - n_tiles * BKV;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rg = q0 + 8 * ty + i;
    if (rg >= t) continue;
    const float l = row_sum(l_r[i], m_r[i], missing);
    const float inv = inv_keep / l;
    if (stats != nullptr && tx == 0) {
      stats[((size_t)bh * t + rg) * 2] = m_r[i];
      stats[((size_t)bh * t + rg) * 2 + 1] = l;
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const size_t off = base + (size_t)rg * DH + out_col<DH>(tx, jj);
      o[off] = from_f32<T>(acc[i][jj] * inv);
      if (o32 != nullptr) o32[off] = acc[i][jj] * inv;
    }
  }
}

// ------------------------------------ bf16 at head dim 16, 32: mma.sync

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a (16x16 bf16, row) . b (16x8 bf16, col) + d, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// FlashAttention-2 layout: 4 warps, each owning 16 query rows. A lane
// (group g = lane / 4, t4 = lane % 4) holds rows g and g + 8 of every
// m16n8 accumulator, columns 2*t4 and 2*t4 + 1. The S accumulator of two
// adjacent 8-key tiles IS the A operand of P.V for those 16 keys, so the
// probabilities never leave registers; only the k/v tiles go through
// shared memory.
template <int DH>
__global__ void __launch_bounds__(128)
    attention_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const uint8_t* __restrict__ key_valid,
                                  __nv_bfloat16* __restrict__ o,
                                  float* __restrict__ stats,
                                  float* __restrict__ o32, int n_heads,
                                  int t, int t_pad, float scale,
                                  float inv_keep, uint32_t threshold,
                                  uint32_t seed, int dropout, int xla,
                                  int round_logits) {
  constexpr int LD = DH + 8;  // bf16 row pitch of the k/v tiles
  constexpr int NS = BKV / 8;  // 8-key score tiles per key tile
  constexpr int ND = DH / 8;   // 8-wide output tiles
  constexpr int KD = DH / 16;  // 16-deep steps over the head dim
  __shared__ __align__(16) __nv_bfloat16 k_s[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BKV * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8
  const size_t base = (size_t)bh * t * DH;
  const uint8_t* kvb = key_valid ? key_valid + (size_t)b * t : nullptr;
  const uint32_t seed_g = xla ? seed : seed + (uint32_t)bh;

  auto q2 = [&](int r, int c) -> uint32_t {
    return r < t ? *reinterpret_cast<const uint32_t*>(q + base +
                                                      (size_t)r * DH + c)
                 : 0u;
  };
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t4;
    qf[kd][0] = q2(r0, c);
    qf[kd][1] = q2(r0 + 8, c);
    qf[kd][2] = q2(r0, c + 8);
    qf[kd][3] = q2(r0 + 8, c + 8);
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int n_tiles = (t + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous k/v tile
    constexpr int CH = DH / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < BKV * CH; idx += 128) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (c0 + r < t) {
        const size_t off = base + (size_t)(c0 + r) * DH + c;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kv4;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T: score tile n covers keys c0 + 8n .. c0 + 8n + 7
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* kr = &k_s[(n * 8 + g) * LD + 2 * t4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma_bf16(s[n], qf[kd],
                 *reinterpret_cast<const uint32_t*>(kr + kd * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8));
    }

    // scale, key mask, online softmax for rows r0 (e = 0, 1), r0+8 (2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + n * 8 + 2 * t4 + (e & 1);
        const bool ok = c < t && (kvb == nullptr || kvb[c] != 0);
        s[n][e] = ok ? logit(s[n][e], scale, round_logits)
                     : masked_score(c, t, xla);
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_r[e / 2]);
        sum[e / 2] += s[n][e];
        if (dropout) {
          const uint32_t c = (uint32_t)(c0 + n * 8 + 2 * t4 + (e & 1));
          if (!hash_keep(drop_row(xla, bh, r0 + (e / 2) * 8, t, t_pad) + c,
                         seed_g, threshold))
            s[n][e] = 0.f;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P . V, 16 keys per step; P (bf16) straight from s
#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                              pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                              pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                              pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      const __nv_bfloat16* vr = &v_s[(kb * 16 + 2 * t4) * LD + g];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        mma_bf16(acc[j], pa, pack_bf16(vc[0], vc[LD]),
                 pack_bf16(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

  // columns [n_tiles * BKV, t_pad) are -1e9 in the TPU kernel's softmax
  // and out of the XLA attention's
  const float missing = xla ? 0.f : (float)(t_pad - n_tiles * BKV);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + h * 8;
    if (r >= t) continue;
    const float l = l_r[h] + missing * expf(NEG - m_r[h]);
    const float inv = inv_keep / l;
    if (stats != nullptr && t4 == 0) {
      stats[((size_t)bh * t + r) * 2] = m_r[h];
      stats[((size_t)bh * t + r) * 2 + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t off = base + (size_t)r * DH + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(o + off) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      if (o32 != nullptr) {
        o32[off] = acc[j][2 * h] * inv;
        o32[off + 1] = acc[j][2 * h + 1] * inv;
      }
    }
  }
}

// ------------------------------------ bf16 at head dim 64, 128: wgmma fed by TMA
//
// CTA: warps 0-7 are two consumer warpgroups (query rows 0-63 and 64-127
// of the tile), warp 8 the producer (one thread issues the TMA loads).
// Shared memory: Q as 2 x DH/64 boxes of 64 x 64 (row half, 64-wide d
// block), then W_STAGES stages of K and V, each DH/64 boxes of 64 keys x
// 64 d, then the O staging rows. Barriers: Q's, and per stage K's and V's
// full barriers (the producer's expect_tx arrival) and the empty barrier
// (one arrival per consumer warp once its P.V has read the stage).

constexpr int W_STAGES = 2;
constexpr int W_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int W_BOX = 64 * 64 * 2;

template <int DH>
struct WgmmaPlan {
  static constexpr int DB = DH / 64;            // 64-wide d blocks
  static constexpr int KV = DB * W_BOX;         // one K (or V) tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int Q = 0;
  static constexpr int KV0 = Q + 2 * KV;        // the ring
  static constexpr int PITCH = DH + 8;          // staged O row, bf16
  static constexpr int EPI = KV0 + W_STAGES * STAGE;
  static constexpr int BARS = EPI + 2 * 64 * PITCH * 2;
  static constexpr int SMEM = BARS + 8 * (1 + 3 * W_STAGES) + 1024;
  static constexpr int MINB = DH == 64 ? 2 : 1;  // CTAs per SM
};

struct FwdMaps {
  CUtensorMap q, k, v;  // (dh, T, B*H)
};

template <int DH>
__global__ void __launch_bounds__(W_THREADS, WgmmaPlan<DH>::MINB)
    attention_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps,
                               const uint8_t* __restrict__ key_valid,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ stats,
                               float* __restrict__ o32, int n_heads, int t,
                               int t_pad, float scale, float inv_keep,
                               uint32_t threshold, uint32_t seed, int dropout,
                               int xla, int round_logits) {
  using Plan = WgmmaPlan<DH>;
  constexpr int DB = Plan::DB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + Plan::Q;
  const uint32_t bars = base + Plan::BARS;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + W_STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * W_STAGES + st); };
  auto k_tile = [&](int st) { return base + Plan::KV0 + st * Plan::STAGE; };
  auto v_tile = [&](int st) {
    return base + Plan::KV0 + st * Plan::STAGE + Plan::KV;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * 128;
  const int n_tiles = (t + BKV - 1) / BKV;
  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int st = 0; st < W_STAGES; ++st) {
      wg::mbar_init(k_full(st), 1);
      wg::mbar_init(v_full(st), 1);
      wg::mbar_init(empty(st), 8);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      wg::mbar_expect_tx(q_full, 2 * Plan::KV);
      for (int rh = 0; rh < 2; ++rh)
        for (int db = 0; db < DB; ++db)
          wg::tma_load(q_s + (rh * DB + db) * W_BOX, &maps.q, q_full, 64 * db,
                       q0 + 64 * rh, bh);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        wg::mbar_wait(empty(st), phase ^ 1);
        wg::mbar_expect_tx(k_full(st), Plan::KV);
        for (int db = 0; db < DB; ++db)
          wg::tma_load(k_tile(st) + db * W_BOX, &maps.k, k_full(st), 64 * db,
                       kt * BKV, bh);
        wg::mbar_expect_tx(v_full(st), Plan::KV);
        for (int db = 0; db < DB; ++db)
          wg::tma_load(v_tile(st) + db * W_BOX, &maps.v, v_full(st), 64 * db,
                       kt * BKV, bh);
        if (++st == W_STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wi owns query rows q0 + 64 wi .. + 63; this
  // thread rows r_lo and r_lo + 8 (accumulator elements 4 j + 2 h + e,
  // columns 8 j + 2 u + e)
  const int wi = warp / 4, g = lane / 4, u = lane % 4;
  const int r_lo = q0 + 64 * wi + 16 * (warp % 4) + g;
  const uint8_t* kvb =
      key_valid ? key_valid + (size_t)(bh / n_heads) * t : nullptr;
  const uint32_t seed_g = xla ? seed : seed + (uint32_t)bh;
  uint32_t drow[2] = {0u, 0u};
  if (dropout)
    for (int h = 0; h < 2; ++h) drow[h] = drop_row(xla, bh, r_lo + 8 * h, t, t_pad);

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  // the row max in log2 units and the row sum
  float m2[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float scale2 = scale * LOG2E;
  const uint32_t q_wg = q_s + wi * DB * W_BOX;
  wg::mbar_wait(q_full, 0);

  int st = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * BKV;
    const uint64_t word = tile_mask(kvb, c0, t, lane);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::mbar_wait(k_full(st), phase);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wg::wgmma_ss<0, 0>(
          s, tmagemm::tile_desc<0>(q_wg + (kk / 4) * W_BOX, kk % 4),
          tmagemm::tile_desc<0>(k_tile(st) + (kk / 4) * W_BOX, kk % 4), 1);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::keep_regs(s);

    // the logits in log2 units (rounded to bf16 first under round_logits),
    // then the masked columns, on the accumulator
    if (round_logits) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float a = s[i] * scale, c = s[i + 1] * scale;
        bf16_round2(a, c);
        s[i] = a * LOG2E;
        s[i + 1] = c * LOG2E;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
    }
    if (word != ~0ull) {  // bit 8 j + e of `mine`: column 8 j + 2 u + e
      const uint64_t mine = word >> (2 * u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + (e & 1);
          if (!((mine >> cl) & 1))
            s[4 * j + e] = masked_score2(c0 + cl + 2 * u, t, xla);
        }
    }
    // the online softmax in log2 units
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m2[h], mx[h]);
      alpha[h] = ex2_fast(m2[h] - m_new);
      m2[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * j + e];
        x = ex2_fast(x - m2[e / 2]);
        sum[e / 2] += x;
        if (dropout &&
            !hash_keep(drow[e / 2] + (uint32_t)(c0 + 8 * j + 2 * u + (e & 1)),
                       seed_g, threshold))
          x = 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // P (bf16) for keys 16 kb .. 16 kb + 15: score groups 2 kb, 2 kb + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kb][r] = wg::pack_bf16(s[8 * kb + 2 * r], s[8 * kb + 2 * r + 1]);

    wg::mbar_wait(v_full(st), phase);
    wg::wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
      wg::wgmma_rs<1>(acc, pa[kb], tmagemm::tile_desc<1>(v_tile(st), kb), 1);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::keep_regs(acc);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty(st));
    if (++st == W_STAGES) {
      st = 0;
      phase ^= 1;
    }
  }

  // columns [n_tiles * BKV, t_pad) are -1e9 in the TPU kernel's softmax
  // and out of the XLA attention's
  const int missing = xla ? 0 : t_pad - n_tiles * BKV;
  constexpr int PITCH = Plan::PITCH;
  __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(
                          smem_raw + (base - raw) + Plan::EPI) +
                      wi * 64 * PITCH;
  const int rl = 16 * (warp % 4) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const float l =
        l_r[h] + (missing ? (float)missing * ex2_fast(NEG2 - m2[h]) : 0.f);
    const float inv = inv_keep / l;
    if (r < t && stats != nullptr && u == 0) {
      // the row max in natural units: exactly -1e9 for a row with no valid
      // key (whose p = exp(-1e9 - m) / l the backward recomputes as 1 / l),
      // and under round_logits exactly the largest rounded logit, which
      // m2 * ln 2 is within about 2^-22 of, far inside half a bf16 step
      float m = m2[h] * LN2;
      if (round_logits) m = __bfloat162float(__float2bfloat16(m));
      stats[((size_t)bh * t + r) * 2] = m2[h] == NEG2 ? NEG : m;
      stats[((size_t)bh * t + r) * 2 + 1] = l;
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float v0 = acc[4 * j + 2 * h] * inv, v1 = acc[4 * j + 2 * h + 1] * inv;
      *reinterpret_cast<uint32_t*>(ep + (rl + 8 * h) * PITCH + 8 * j + 2 * u) =
          wg::pack_bf16(v0, v1);
      if (r < t && o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + ((size_t)bh * t + r) * DH + 8 * j +
                                   2 * u) = make_float2(v0, v1);
    }
  }
  tmagemm::warpgroup_sync(1 + wi);
  for (int i = threadIdx.x % 128; i < 64 * DH / 8; i += 128) {
    const int rr = i / (DH / 8), c = 8 * (i % (DH / 8));
    const int r = q0 + 64 * wi + rr;
    if (r < t)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * t + r) * DH + c) =
          *reinterpret_cast<const uint4*>(ep + rr * PITCH + c);
  }
}

// ------------------------------------ launches

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, const void* kv,
                 void* o, float* stats, float* o32, int batch, int heads,
                 int t, float scale, float inv_keep, uint32_t threshold,
                 uint32_t seed, int dropout, int xla, int round_logits,
                 cudaStream_t stream) {
  // the shared-memory opt-in is set once per device
  static bool opted[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgmmaPlan<DH>::SMEM);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  FwdMaps maps{};
  const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)t,
                            (uint64_t)batch * heads};
  const uint64_t strides[2] = {(uint64_t)DH, (uint64_t)t * DH};
  int code = tmagemm::encode(&maps.q, q, 3, dims, strides);
  if (code == 0) code = tmagemm::encode(&maps.k, k, 3, dims, strides);
  if (code == 0) code = tmagemm::encode(&maps.v, v, 3, dims, strides);
  if (code != 0) return code;
  const int t_pad = (t + 127) / 128 * 128;
  const dim3 grid((unsigned)((t + 127) / 128), (unsigned)(batch * heads));
  attention_fwd_wgmma_kernel<DH>
      <<<grid, W_THREADS, WgmmaPlan<DH>::SMEM, stream>>>(
          maps, (const uint8_t*)kv, (__nv_bfloat16*)o, stats, o32, heads, t,
          t_pad, scale, inv_keep, threshold, seed, dropout, xla,
          round_logits);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* kv,
               void* o, float* stats, float* o32, int batch, int heads, int t,
               float scale, float inv_keep, uint32_t threshold, uint32_t seed,
               int dropout, int xla, int round_logits, cudaStream_t stream) {
  const int t_pad = (t + 127) / 128 * 128;
  const dim3 grid((unsigned)((t + BQ - 1) / BQ), (unsigned)(batch * heads));
  attention_fwd_bf16_mma_kernel<DH><<<grid, 128, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)kv, (__nv_bfloat16*)o, stats,
      o32, heads, t, t_pad, scale, inv_keep, threshold, seed, dropout, xla,
      round_logits);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_simt(const void* q, const void* k, const void* v, const void* kv,
                void* o, float* stats, float* o32, int batch, int heads,
                int t, float scale, float inv_keep, uint32_t threshold,
                uint32_t seed, int dropout, int xla, int round_logits,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * SimtPlan<DH>::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_simt_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int t_pad = (t + 127) / 128 * 128;
  const dim3 grid((unsigned)((t + SQ - 1) / SQ), (unsigned)(batch * heads));
  attention_fwd_simt_kernel<T, DH>
      <<<grid, SNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kv, (T*)o, stats,
      o32, heads, t, t_pad, scale, inv_keep, threshold, seed, dropout, xla,
      round_logits);
  return (int)cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      void*, float*, float*, int, int, int, float, float,
                      uint32_t, uint32_t, int, int, int, cudaStream_t);

// The launch of (route, dtype, head dim), or null for a head dim the
// route does not take.
Launch launch_of(int route, int dtype, int dh) {
  const int i = dh == 16 ? 0 : dh == 32 ? 1 : dh == 64 ? 2 : dh == 128 ? 3 : -1;
  if (i < 0) return nullptr;
  static const Launch wgmma[4] = {nullptr, nullptr, launch_wgmma<64>,
                                  launch_wgmma<128>};
  static const Launch mma[4] = {launch_mma<16>, launch_mma<32>, nullptr,
                                nullptr};
  static const Launch simt32[4] = {
      launch_simt<float, 16>, launch_simt<float, 32>, launch_simt<float, 64>,
      launch_simt<float, 128>};
  static const Launch simt16[4] = {
      launch_simt<__nv_bfloat16, 16>, launch_simt<__nv_bfloat16, 32>,
      launch_simt<__nv_bfloat16, 64>, launch_simt<__nv_bfloat16, 128>};
  if (route == kFwdWgmma) return wgmma[i];
  if (route == kFwdMma) return mma[i];
  return dtype == 0 ? simt32[i] : simt16[i];
}

// The whole forward on one stream; a8t_attention_fwd's arguments.
int run_fwd(const void* q, const void* k, const void* v,
            const void* key_valid, void* o, void* stats, void* o32,
            int batch, int heads, int t, int dh, int dtype, float scale,
            float inv_keep, uint32_t threshold, uint32_t seed, int dropout,
            int xla, int round_logits, cudaStream_t s) {
  if (batch <= 0 || heads <= 0 || t <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int aligned =
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16) == 0;
  const Launch fn = launch_of(fwd_route(dtype, dh, aligned), dtype, dh);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, key_valid, o, (float*)stats, (float*)o32, batch, heads,
            t, scale, inv_keep, threshold, seed, dropout, xla, round_logits,
            s);
}

}  // namespace

// The route fwd_route gives: 0 = SIMT, 1 = mma.sync, 2 = wgmma
// (ops/attention.py:attention_route mirrors it).
extern "C" int a8t_attention_fwd_route(int dtype, int dh, int aligned) {
  return fwd_route(dtype, dh, aligned);
}

// q, k, v, o: (B, H, T, dh) contiguous; key_valid: (B, T) uint8 or NULL;
// stats: (B*H*T, 2) f32 row max and row sum, or NULL when not needed;
// o32: (B, H, T, dh) f32 copy of the output before rounding, or NULL.
// dtype: 0 = float32, 1 = bfloat16. inv_keep = 1 / (1 - rate); threshold
// and seed are the uint32 dropout parameters (dropout = 0 skips the hash).
// xla = 0: the TPU kernel's semantics, 1: the XLA attention's;
// round_logits = 1 rounds the scaled logits to bf16 (xla under
// bf16_softmax). Returns the cudaError_t of the launch.
extern "C" int a8t_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* key_valid, void* o,
                                 void* stats, void* o32, int batch,
                                 int heads, int t, int dh, int dtype,
                                 float scale, float inv_keep,
                                 uint32_t threshold, uint32_t seed,
                                 int dropout, int xla, int round_logits,
                                 void* stream) {
  return run_fwd(q, k, v, key_valid, o, stats, o32, batch, heads, t, dh,
                 dtype, scale, inv_keep, threshold, seed, dropout, xla,
                 round_logits, (cudaStream_t)stream);
}
