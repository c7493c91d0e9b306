// CTC loss: per-row -log p(y | x) and its gradient, in the log semiring.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/ctc_kernel.py:
// _ctc_kernel (with _prep, which gathers the emissions and builds the
// skip and final-state masks, and _ctc_bwd, which scatters the state
// gradients onto the vocabulary). Same function, term by term:
//
//   * the extended labels are [blank, y1, blank, y2, ..., blank] (S =
//     2U + 1 states); state s may skip from s - 2 iff ext[s] != blank and
//     ext[s] != ext[s - 2]; states at or past 2*U_b + 1 are killed (their
//     emission is NEG_INF); the final states are 2*U_b and, when U_b > 0,
//     2*U_b - 1;
//   * alpha_t(s) = logaddexp3(alpha(s), alpha(s-1), alpha(s-2) if the skip
//     is legal) + E(t, s), with E(t, s) = log_probs[b, t, ext[s]]; at
//     t = 0 only states 0 and 1 start; frames at or past input_length
//     leave the state untouched (so an input_length of 0 gives ll =
//     NEG_INF);
//   * NEG_INF = -1e30 and the double-where logaddexp3 of the TPU kernel
//     (all three inputs at NEG_INF give NEG_INF exactly), not IEEE -inf;
//     everything in f32;
//   * beta_hat(t, s) = beta(t, s) + E(t, s) runs backwards from beta_hat
//     = E at the final states for t = input_length - 1, and dE(t, s) =
//     -exp(min(alpha + beta_hat - E - ll, 0)), zero where t >=
//     input_length or ll = NEG_INF; grad log_probs[b, t, v] = g[b] * sum
//     over s with ext[s] = v of dE(t, s).
//
// What bounds it on H100: not bytes (the log-probs are read once, about
// 400 KB at the training shapes) but the chain of dependent time steps,
// each a handful of operations on S states, and the instructions a step
// issues (PERF.md §6 lists the designs timed). The design follows that:
//
//   * alpha and beta_hat are independent recursions, so the sweep launch
//     runs them at the same time, one CTA each per batch row (grid (B,
//     2)): each row's chain is T steps, not 2T. Each CTA parks its
//     recursion in its own (B, T, S) f32 workspace (fire-and-forget
//     stores); the alpha CTA writes ll. Without a gradient the grid is
//     (B, 1), alpha only, and nothing is parked;
//   * one state per thread (S rounded up to whole warps, up to 1024
//     states; two per thread above), the recursion double-buffered in
//     shared memory behind two NEG_INF pads at each end, one barrier per
//     step; a step has no branch: every slot is updated, only the live
//     states (s < 2 U_b + 1) are parked, and only frames t < input_length
//     are stepped through;
//   * no global load on a step's chain: each thread loads the emission
//     E(t, s) = log_probs[b, t, ext[s]] of its own states 16 steps ahead
//     (8 at two states per thread, which keeps the ring in the 64
//     registers a 1024-thread CTA allows) into a register ring, the time
//     loop unrolled by as many;
//   * logaddexp3 in log2 units: the max term contributes exactly 1, so an
//     update is m + log2(1 + 2^(x - m) + 2^(y - m)): two ex2.approx and
//     one lg2.approx (MUFU instructions, about 2^-22 relative error) and
//     a few adds, min/max and one select. The recursion and its parked
//     values are in log2 units (E * log2 e, rounded once, the same product
//     in both launches); ll leaves in natural units;
//   * the gradient launch (ctc_finish_kernel) is fully parallel: one warp
//     per (b, t) row computes dE for the row's live states into shared
//     memory from alpha, beta_hat, E and ll, then sums dE onto the labels
//     in a fixed order (the blank's even states by the whole warp, each
//     label's target positions by its lane in increasing u), the one-hot
//     product of _ctc_bwd.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_STATES = 2048;  // 2U + 1: two slots of 1024 threads
constexpr int AHEAD = 16;         // emissions in flight per thread
constexpr int FROWS = 4;          // (b, t) rows per gradient CTA

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2(2^a + 2^b + 2^c) with the TPU kernel's double where: NEG_INF when
// the largest input is at or below NEG_INF / 2. With bc = max(b, c) the
// max is max(a, bc) and the other two inputs are min(a, bc) and min(b, c)
// (two levels of min/max); the max's own term is exactly 1.
__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float bc = fmaxf(b, c);
  const float m = fmaxf(a, bc);
  const float out =
      m + lg2(1.f + ex2(fminf(a, bc) - m) + ex2(fminf(b, c) - m));
  return m > NEG_INF / 2 ? out : NEG_INF;
}

// a read-only global load that the compiler keeps where it is written (the
// register it fills is read steps later)
__device__ __forceinline__ float ldg(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// Shared memory of a sweep CTA of W = blockDim.x * K state slots: two
// recursion buffers of W + 4 (two NEG_INF pads at each end) and the S
// extended labels.
constexpr size_t sweep_smem(int w, int s_n) {
  return (2 * (size_t)(w + 4) + s_n) * 4;
}

struct SweepArgs {
  const float* log_probs;
  const int* input_lengths;
  const int* targets;
  const int* target_lengths;
  float* ll;     // (B,) natural units
  float* alpha;  // (B, T, S) parks in log2 units, or null
  float* beta;
  float* ll2;    // (B,) ll in log2 units, or null
  int t_max, v, u_max, blank;
};

// One recursion of batch row blockIdx.x: alpha from t = 0 (writes ll),
// or (BETA) beta_hat from t = min(input_length, T) - 1. Thread tid owns
// the K state slots s = tid + i * blockDim.x. Every slot is updated each
// step, so a step has no branch; only live states are parked. Slots past
// the row's live states hold values that no live state reads: beta's
// stay at or below NEG_INF (their inputs are NEG_INF pads or dead slots),
// alpha's are read only by higher, dead slots.
template <int K, bool BETA>
__device__ __forceinline__ void sweep(const SweepArgs& p, float* smem) {
  const int nt = blockDim.x, w = nt * K;
  const int s_n = 2 * p.u_max + 1;
  float* buf0 = smem;
  float* buf1 = buf0 + w + 4;
  int* ext = reinterpret_cast<int*>(buf1 + w + 4);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int ulen = p.target_lengths[b];
  const int s_live = min(2 * ulen + 1, s_n);
  const int ilen = p.input_lengths[b];
  const int t_end = max(0, min(ilen, p.t_max));
  const float* lp = p.log_probs + (size_t)b * p.t_max * p.v;
  float* park = BETA ? p.beta : p.alpha;
  const bool parked = park != nullptr && t_end > 0;

  for (int s = tid; s < s_n; s += nt)
    ext[s] = (s & 1) ? p.targets[(size_t)b * p.u_max + s / 2] : p.blank;
  for (int s = tid; s < w + 4; s += nt) buf0[s] = buf1[s] = NEG_INF;
  __syncthreads();

  // per slot: live, label, legal skip (alpha: into s from s - 2; beta:
  // into s + 2 from s), final state
  int lab[K];
  bool live[K], skip[K], fin[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = tid + i * nt, to = BETA ? s + 2 : s;
    live[i] = s < s_live;
    lab[i] = live[i] ? ext[s] : 0;
    skip[i] = live[i] && to >= 2 && to < s_n && ext[to] != p.blank &&
              ext[to] != ext[to - 2];
    fin[i] = s == 2 * ulen || (ulen > 0 && s == 2 * ulen - 1);
  }

  // Step k handles frame t = k (alpha) or t_end - 1 - k (beta). Its
  // emissions are loaded D steps before into a register ring (ring[k %
  // D]; the loop is unrolled by D so that every index is fixed), so no
  // step waits on device memory. The load offset runs one frame per step
  // and is clamped to the row's frames (past the last step it reads a
  // frame that is never used).
  const int dir = BETA ? -1 : 1;
  const int last = max(t_end - 1, 0) * p.v;
  int load_off = (BETA ? t_end - 1 : 0) * p.v;
  auto load = [&](float (&dst)[K]) {
    const float* row = lp + min(max(load_off, 0), last);
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = ldg(row + lab[i]);
    load_off += dir * p.v;
  };
  constexpr int D = AHEAD / K;
  float ring[D][K];
#pragma unroll
  for (int j = 0; j < D; ++j) load(ring[j]);

  float* prev = buf0 + 2;
  float* cur = buf1 + 2;
  float* park_row =
      parked ? park + ((size_t)b * p.t_max + (BETA ? t_end - 1 : 0)) * s_n +
                   tid
             : nullptr;
  // beta's first frame starts from the final states when it is the row's
  // last (input_length <= T), else from NEG_INF everywhere, as the TPU
  // kernel's recursion over frames past T would
  const bool init = !BETA || t_end == ilen;
  auto advance = [&](float (&slot)[K], bool first) {
    float val[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = tid + i * nt;
      const float e = __fmul_rn(slot[i], LOG2E);
      if (first) {
        val[i] = BETA ? ((init && fin[i]) ? 0.f : NEG_INF) + e
                      : (s <= 1 ? e : NEG_INF);
      } else {
        val[i] = logaddexp3(prev[s], prev[s - dir],
                            skip[i] ? prev[s - 2 * dir] : NEG_INF) + e;
      }
    }
    load(slot);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      cur[tid + i * nt] = val[i];
      if (parked && live[i]) park_row[i * nt] = val[i];
    }
    park_row += dir * s_n;
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  };
  if (t_end > 0) advance(ring[0], true);
#pragma unroll 1
  for (int k0 = 0; k0 < t_end; k0 += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int k = k0 + j;
      if (k >= t_end) break;
      if (k > 0) advance(ring[j], false);
    }
  }

  // log-likelihood over the final states (thread 0 of the alpha CTA)
  if (!BETA && tid == 0) {
    const float f1 = 2 * ulen < s_n ? prev[2 * ulen] : NEG_INF;
    const float f2 = ulen > 0 && 2 * ulen - 1 < s_n ? prev[2 * ulen - 1]
                                                    : NEG_INF;
    const float m = fmaxf(f1, f2);
    float sum = 0.f;
    if (f1 > NEG_INF / 2) sum += ex2(f1 - m);
    if (f2 > NEG_INF / 2) sum += ex2(f2 - m);
    const bool ok = m > NEG_INF / 2;
    const float ll2 = ok ? m + lg2(sum) : NEG_INF;
    p.ll[b] = ok ? ll2 * LN2 : NEG_INF;
    if (p.ll2 != nullptr) p.ll2[b] = ll2;
  }
}

// grid (B, 2): blockIdx.y = 0 runs alpha, 1 beta_hat; (B, 1): alpha only
template <int K>
__global__ void __launch_bounds__(1024) ctc_sweep_kernel(const SweepArgs p) {
  extern __shared__ float smem[];
  if (blockIdx.y == 0)
    sweep<K, false>(p, smem);
  else
    sweep<K, true>(p, smem);
}

// one warp-rounded slot per state and thread up to 1024 states, two above
// (at most 25 KB of shared memory)
template <int K>
int launch_sweep(const SweepArgs& p, int batch, int s_n, bool both,
                 cudaStream_t stream) {
  const int nt = ((s_n + K - 1) / K + 31) / 32 * 32;
  const dim3 grid((unsigned)batch, both ? 2u : 1u);
  ctc_sweep_kernel<K><<<grid, nt, sweep_smem(nt * K, s_n), stream>>>(p);
  return (int)cudaGetLastError();
}

// grad[b, t, c] = g[b] * sum_{s : ext[s] == c} dE[b, t, s]: warp w of the
// CTA takes row t = FROWS * blockIdx.x + w of batch row blockIdx.y. The
// sums run in a fixed order: the blank's even states by the whole warp
// (lane l adds s = 2 (l + 32 j) in increasing j, then a butterfly over the
// lanes), then each label's odd states 2u + 1 by its lane in increasing u.
__global__ void __launch_bounds__(32 * FROWS)
    ctc_finish_kernel(const float* __restrict__ log_probs,
                      const int* __restrict__ input_lengths,
                      const int* __restrict__ targets,
                      const int* __restrict__ target_lengths,
                      const float* __restrict__ alpha_ws,
                      const float* __restrict__ beta_ws,
                      const float* __restrict__ ll2_ws,
                      const float* __restrict__ g, float* __restrict__ grad,
                      int t_max, int v, int u_max, int blank) {
  extern __shared__ float smem[];
  const int s_n = 2 * u_max + 1;
  int* tg = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* de = smem + u_max + warp * s_n;
  const int b = blockIdx.y, t = FROWS * blockIdx.x + warp;
  for (int u = threadIdx.x; u < u_max; u += 32 * FROWS)
    tg[u] = targets[(size_t)b * u_max + u];
  __syncthreads();
  if (t >= t_max) return;

  const size_t row = (size_t)b * t_max + t;
  float* out = grad + row * v;
  const float gb = g[b];
  const float ll2 = ll2_ws[b];
  const int ulen = target_lengths[b];
  const int s_live = min(2 * ulen + 1, s_n);
  if (t >= input_lengths[b] || !(ll2 > NEG_INF / 2)) {
    for (int c = lane; c < v; c += 32) out[c] = gb * 0.f;
    return;
  }
  const float* a = alpha_ws + row * s_n;
  const float* bh = beta_ws + row * s_n;
  const float* lp = log_probs + row * v;
#pragma unroll 4
  for (int s = lane; s < s_live; s += 32) {
    const int c = (s & 1) ? tg[s / 2] : blank;
    const float gamma = a[s] + bh[s] - __fmul_rn(lp[c], LOG2E) - ll2;
    de[s] = -ex2(fminf(gamma, 0.f));
  }
  __syncwarp();
  float blank_sum = 0.f;
  for (int s = 2 * lane; s < s_live; s += 64) blank_sum += de[s];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    blank_sum += __shfl_xor_sync(0xffffffffu, blank_sum, o);
  for (int c = lane; c < v; c += 32) {
    float acc = c == blank ? blank_sum : 0.f;
#pragma unroll 4
    for (int u = 0; 2 * u + 1 < s_live; ++u)
      acc += tg[u] == c ? de[2 * u + 1] : 0.f;
    out[c] = gb * acc;
  }
}

}  // namespace

// log_probs: (B, T, V) f32; input_lengths, target_lengths: (B,) int32;
// targets: (B, U) int32; ll: (B,) f32 out. work: null without a gradient
// (alpha only), else 2 B T (2U+1) + B f32 of scratch that the gradient
// launch reads: alpha, beta_hat (log2 units) and ll in log2 units. Needs
// 2U + 1 <= 2048.
extern "C" int a8t_ctc_loss(const void* log_probs, const void* input_lengths,
                            const void* targets, const void* target_lengths,
                            void* ll, void* work, int batch, int t_max,
                            int v, int u_max, int blank, void* stream) {
  const int s_n = 2 * u_max + 1;
  if (batch <= 0 || t_max <= 0 || v <= 0 || u_max < 0 || s_n > MAX_STATES)
    return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  const size_t plane = (size_t)batch * t_max * s_n;
  const SweepArgs p{(const float*)log_probs, (const int*)input_lengths,
                    (const int*)targets, (const int*)target_lengths,
                    (float*)ll, w, w != nullptr ? w + plane : nullptr,
                    w != nullptr ? w + 2 * plane : nullptr, t_max, v, u_max,
                    blank};
  cudaStream_t s = (cudaStream_t)stream;
  const bool both = w != nullptr;
  return s_n <= 1024 ? launch_sweep<1>(p, batch, s_n, both, s)
                     : launch_sweep<2>(p, batch, s_n, both, s);
}

// grad: (B, T, V) f32 out; g: (B,) f32 upstream gradient of each row's
// loss; work: what a8t_ctc_loss left with a workspace; the other inputs
// are a8t_ctc_loss's.
extern "C" int a8t_ctc_loss_bwd(const void* log_probs,
                                const void* input_lengths,
                                const void* targets,
                                const void* target_lengths, const void* work,
                                const void* g, void* grad, int batch,
                                int t_max, int v, int u_max, int blank,
                                void* stream) {
  const int s_n = 2 * u_max + 1;
  if (batch <= 0 || t_max <= 0 || v <= 0 || u_max < 0 || s_n > MAX_STATES ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* w = (const float*)work;
  const size_t plane = (size_t)batch * t_max * s_n;
  // the targets and FROWS rows of dE: at most 37 KB
  const size_t smem = ((size_t)u_max + (size_t)FROWS * s_n) * 4;
  const dim3 grid((unsigned)((t_max + FROWS - 1) / FROWS), (unsigned)batch);
  ctc_finish_kernel<<<grid, 32 * FROWS, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)input_lengths, (const int*)targets,
      (const int*)target_lengths, w, w + plane, w + 2 * plane,
      (const float*)g, (float*)grad, t_max, v, u_max, blank);
  return (int)cudaGetLastError();
}
