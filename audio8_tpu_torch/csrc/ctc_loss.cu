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
//   * NEG_INF = -1e30 and the double-where logaddexp3 of the TPU kernel,
//     not IEEE -inf; everything in f32;
//   * the backward sweep runs beta_hat(t, s) = beta(t, s) + E(t, s), with
//     beta_hat = E at the final states for t = input_length - 1, and
//     writes dE(t, s) = -exp(min(alpha + beta_hat - E - ll, 0)), zero where
//     t >= input_length or ll = NEG_INF; grad log_probs[b, t, v] =
//     g[b] * sum over s with ext[s] = v of dE(t, s).
//
// What bounds it on H100: not bytes (the log-probs are read once, about
// 400 KB at the training shapes) but the chain of 2T dependent time steps,
// each a handful of operations on S states. The design follows that: one
// CTA per batch row (rows are independent; the TPU kernel packs them in
// one (B, S) tile only for its vector layout), the S states spread over
// the threads, one barrier per time step, alpha double-buffered in shared
// memory, each thread prefetching its next emission from device memory
// before the barrier. The forward parks alpha in a (B, T, S) f32
// workspace and the backward sweep overwrites it with dE, as the TPU
// kernel does with its dE buffer. A second, fully parallel kernel then
// sums dE onto the V labels per (b, t) in a fixed order, the one-hot
// product of _ctc_bwd. Without a gradient the backward sweep is skipped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool safe = m > NEG_INF / 2;
  const float m_safe = safe ? m : 0.f;
  const float s = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  const float out = m_safe + logf(s > 0.f ? s : 1.f);
  return safe ? out : NEG_INF;
}

// Shared memory: ext (int), skip (int), two alpha buffers, one beta
// buffer pair reuses them.
__global__ void __launch_bounds__(NT)
    ctc_alpha_beta_kernel(const float* __restrict__ log_probs,
                          const int* __restrict__ input_lengths,
                          const int* __restrict__ targets,
                          const int* __restrict__ target_lengths,
                          float* __restrict__ ll_out,
                          float* __restrict__ work, int t_max, int v,
                          int u_max, int blank, int with_grad) {
  extern __shared__ float smem[];
  const int s_n = 2 * u_max + 1;
  int* ext = reinterpret_cast<int*>(smem);
  int* skip = ext + s_n;
  float* buf0 = reinterpret_cast<float*>(skip + s_n);
  float* buf1 = buf0 + s_n;
  __shared__ float ll_sh;

  const int b = blockIdx.x;
  const int ilen = input_lengths[b];
  const int ulen = target_lengths[b];
  const int s_live = 2 * ulen + 1;
  const float* lp = log_probs + (size_t)b * t_max * v;
  float* wb = work + (size_t)b * t_max * s_n;

  for (int s = threadIdx.x; s < s_n; s += NT) {
    const int e = (s & 1) ? targets[(size_t)b * u_max + s / 2] : blank;
    ext[s] = e;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < s_n; s += NT) {
    const int prev2 = s >= 2 ? ext[s - 2] : -1;
    skip[s] = (ext[s] != blank) && (ext[s] != prev2);
    buf0[s] = NEG_INF;
  }
  __syncthreads();

  auto emit = [&](int t, int s) -> float {
    return s < s_live ? lp[(size_t)t * v + ext[s]] : NEG_INF;
  };

  // ---------------- forward: alpha ----------------
  // each thread owns states tid, tid + NT, ...; at most 8 per thread
  constexpr int MAXS = 8;
  float e_cur[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int s = threadIdx.x + i * NT;
    e_cur[i] = (s < s_n && t_max > 0) ? emit(0, s) : 0.f;
  }
  for (int t = 0; t < t_max; ++t) {
    const float* prev = (t & 1) ? buf1 : buf0;
    float* cur = (t & 1) ? buf0 : buf1;
    float e_next[MAXS];
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      const int s = threadIdx.x + i * NT;
      e_next[i] = (s < s_n && t + 1 < t_max) ? emit(t + 1, s) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      const int s = threadIdx.x + i * NT;
      if (s >= s_n) break;
      const float a0 = prev[s];
      float val;
      if (t == 0) {
        val = s <= 1 ? e_cur[i] : NEG_INF;
      } else {
        const float a1 = s >= 1 ? prev[s - 1] : NEG_INF;
        const float a2 = (s >= 2 && skip[s]) ? prev[s - 2] : NEG_INF;
        val = logaddexp3(a0, a1, a2) + e_cur[i];
      }
      val = t < ilen ? val : a0;
      cur[s] = val;
      wb[(size_t)t * s_n + s] = val;
      e_cur[i] = e_next[i];
    }
    __syncthreads();
  }
  const float* last = (t_max & 1) ? buf1 : buf0;

  // log-likelihood over the final states (thread 0; two values)
  if (threadIdx.x == 0) {
    const float f1 = last[2 * ulen];
    const float f2 = ulen > 0 ? last[2 * ulen - 1] : NEG_INF;
    const float m = fmaxf(f1, f2);
    const float m_safe = m > NEG_INF / 2 ? m : 0.f;
    float sum = 0.f;
    if (f1 > NEG_INF / 2) sum += expf(f1 - m_safe);
    if (f2 > NEG_INF / 2) sum += expf(f2 - m_safe);
    const float ll = m > NEG_INF / 2 ? m_safe + logf(fmaxf(sum, 1e-37f))
                                     : NEG_INF;
    ll_out[b] = ll;
    ll_sh = ll;
  }
  if (!with_grad) return;
  __syncthreads();
  const float ll = ll_sh;
  const bool feasible = ll > NEG_INF / 2;

  // ---------------- backward: beta + dE ----------------
  for (int s = threadIdx.x; s < s_n; s += NT) buf0[s] = NEG_INF;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int s = threadIdx.x + i * NT;
    e_cur[i] = (s < s_n && t_max > 0) ? emit(t_max - 1, s) : 0.f;
  }
  for (int step = 0; step < t_max; ++step) {
    const int t = t_max - 1 - step;
    const float* prev = (step & 1) ? buf1 : buf0;
    float* cur = (step & 1) ? buf0 : buf1;
    float e_next[MAXS];
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      const int s = threadIdx.x + i * NT;
      e_next[i] = (s < s_n && t >= 1) ? emit(t - 1, s) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      const int s = threadIdx.x + i * NT;
      if (s >= s_n) break;
      const float b0 = prev[s];
      float val;
      if (t == ilen - 1) {
        const bool fin = s == 2 * ulen || (ulen > 0 && s == 2 * ulen - 1);
        val = (fin ? 0.f : NEG_INF) + e_cur[i];
      } else {
        const float b1 = s + 1 < s_n ? prev[s + 1] : NEG_INF;
        const float b2 = (s + 2 < s_n && skip[s + 2]) ? prev[s + 2] : NEG_INF;
        val = logaddexp3(b0, b1, b2) + e_cur[i];
      }
      val = t < ilen ? val : b0;
      cur[s] = val;
      const size_t off = (size_t)t * s_n + s;
      const float gamma = wb[off] + val - e_cur[i] - ll;
      const float de = -expf(fminf(gamma, 0.f));
      wb[off] = (t < ilen && feasible) ? de : 0.f;
      e_cur[i] = e_next[i];
    }
    __syncthreads();
  }
}

// grad[b, t, c] = g[b] * sum_{s : ext[s] == c} dE[b, t, s], one thread per
// (b, t, c), s in increasing order.
__global__ void ctc_scatter_kernel(const float* __restrict__ work,
                                   const int* __restrict__ targets,
                                   const float* __restrict__ g,
                                   float* __restrict__ grad, int batch,
                                   int t_max, int v, int u_max, int blank) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)batch * t_max * v;
  if (idx >= total) return;
  const int c = (int)(idx % v);
  const size_t bt = idx / v;
  const int b = (int)(bt / t_max);
  const int s_n = 2 * u_max + 1;
  const float* de = work + bt * s_n;
  const int* tg = targets + (size_t)b * u_max;
  float acc = 0.f;
  if (c == blank)
    for (int s = 0; s < s_n; s += 2) acc += de[s];
  for (int u = 0; u < u_max; ++u)
    if (tg[u] == c) acc += de[2 * u + 1];
  grad[idx] = g[b] * acc;
}

}  // namespace

// log_probs: (B, T, V) f32; input_lengths, target_lengths: (B,) int32;
// targets: (B, U) int32; ll: (B,) f32 out; work: (B, T, 2U+1) f32
// scratch that holds dE on return when with_grad. Needs 2U + 1 <= 2048.
extern "C" int a8t_ctc_loss(const void* log_probs, const void* input_lengths,
                            const void* targets, const void* target_lengths,
                            void* ll, void* work, int batch, int t_max,
                            int v, int u_max, int blank, int with_grad,
                            void* stream) {
  const int s_n = 2 * u_max + 1;
  if (batch <= 0 || t_max <= 0 || v <= 0 || u_max < 0 || s_n > 8 * NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)s_n * (2 * sizeof(int) + 2 * sizeof(float));
  ctc_alpha_beta_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)input_lengths,
      (const int*)targets, (const int*)target_lengths, (float*)ll,
      (float*)work, t_max, v, u_max, blank, with_grad);
  return (int)cudaGetLastError();
}

// grad: (B, T, V) f32 out; g: (B,) f32 upstream gradient of each row's
// loss; work: the dE left by a8t_ctc_loss with with_grad = 1.
extern "C" int a8t_ctc_loss_bwd(const void* work, const void* targets,
                                const void* g, void* grad, int batch,
                                int t_max, int v, int u_max, int blank,
                                void* stream) {
  const size_t total = (size_t)batch * t_max * v;
  if (total == 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  ctc_scatter_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)work, (const int*)targets, (const float*)g, (float*)grad,
      batch, t_max, v, u_max, blank);
  return (int)cudaGetLastError();
}
