// Stride-2, kernel-3 VALID 1-D convolution, forward, channel-last.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/conv_kernel.py:_fwd_kernel
// (driven by _fwd_pallas / conv1d_k3s2):
//
//     y[b, t, :] = x[b, 2t] W0 + x[b, 2t+1] W1 + x[b, 2t+2] W2
//
// With x in (B, T_in, C_in) layout the three input rows of output row
// (b, t) are 3*C_in CONTIGUOUS elements starting at x[b, 2t, 0], and
// W (3, C_in, C_out) is already a row-major (3*C_in, C_out) matrix. So the
// conv is an implicit GEMM (B*T_out x 3C_in) . (3C_in x C_out) whose A rows
// have stride 2*C_in and overlap by C_in. The Pallas kernel's paired
// layout and hand-rolled DMA overlap exist only for the TPU's tiling and
// are not needed here: A rows are addressed directly.
//
// What bounds it on H100: at the wav2vec2 extractor shapes (512 -> 512
// channels, T_out up to 48k per row) the layer is compute-bound
// (~1.5k FLOP per byte read), i.e. by the multiply-add rate. Four routes,
// chosen by dtype, channel counts and alignment at launch (fwd_route,
// mirrored by ops/conv.py:fwd_route):
//   * wgmma (bf16, C_in and C_out multiples of 64, 16-byte aligned
//     pointers): tma_gemm.cuh's TMA-fed wgmma GEMM (a
//     producer warp, a 3-stage mbarrier ring, two consumer warpgroups,
//     128 x 256 tiles where C_out >= 256, a persistent grid) with M = B *
//     T_pad rows on the padded grid (T_pad = T_out rounded up to 128, so
//     no M tile straddles two batch rows), N = C_out and K = 3 C_in in
//     64-deep stages. A is K-major (TmaTapCols): stage ks reads tap z =
//     ks / (C_in / 64) through tap z's (C_in, T_out, B) tensor map over x
//     + z C_in with a row stride of 2 C_in (the wgrad's encode_tap_rows),
//     TMA zero-filling the rows past T_out; B is w as one row-major (3
//     C_in, C_out) matrix read MN-major (TmaWeightCols); the bf16 output
//     is staged through shared memory and only rows t < T_out are
//     written (PaddedRowOut);
//   * mma.sync (other bf16 with C_in and C_out multiples of 8, 16-byte
//     aligned pointers): mma.sync m16n8k16 bf16, f32 accumulation,
//     operands through ldmatrix, 128x128 CTA tile of four 64x64 warp
//     tiles, 64-deep K chunks in a 3-stage cp.async ring (zero-filled at
//     the ragged edges), two CTAs per SM;
//   * simt (f32, C_in and C_out multiples of 4, 16-byte aligned): a SIMT
//     SGEMM, 128x128 CTA tile, 8x8 outputs per thread, 8-deep K chunks
//     double buffered through registers and shared memory, float4
//     traffic. f32 stays on the CUDA cores so that its sums are full f32,
//     like the plain version's (TF32 would not be);
//   * generic (anything else): the simple SIMT kernel, 64x64 tile, 4x4
//     per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_gemm.cuh"

namespace {

enum FwdRoute { kFwdGeneric = 0, kFwdSimt = 1, kFwdMma = 2, kFwdWgmma = 3 };

// The forward's route (dtype 0 = float32, 1 = bfloat16; aligned: every
// pointer on a 16-byte boundary); ops/conv.py:fwd_route mirrors it
inline int fwd_route(int dtype, int c_in, int c_out, int aligned) {
  if (!aligned || (dtype != 0 && dtype != 1)) return kFwdGeneric;
  if (dtype == 0) return c_in % 4 == 0 && c_out % 4 == 0 ? kFwdSimt
                                                          : kFwdGeneric;
  if (c_in % 64 == 0 && c_out % 64 == 0) return kFwdWgmma;
  return c_in % 8 == 0 && c_out % 8 == 0 ? kFwdMma : kFwdGeneric;
}

constexpr int BM = 64;   // output rows (b, t) per CTA
constexpr int BN = 64;   // output channels per CTA
constexpr int BK = 16;   // reduction depth per shared-memory chunk
constexpr int NT = 256;  // threads per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

template <typename T>
__global__ void __launch_bounds__(NT)
    conv_k3s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ y, int t_in, int t_out, int c_in,
                         int c_out, long long m_total) {
  __shared__ float a_s[BK][BM + 4];
  __shared__ float b_s[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16j
  const int ty = tid / 16;  // output rows ty + 16i
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_total = 3 * c_in;

  // A loads: row a_r + 16i of the tile, reduction index a_k of the chunk.
  const int a_k = tid % BK;
  const int a_r = tid / BK;
  const T* a_row[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + a_r + 16 * i;
    a_ok[i] = m < m_total;
    const long long b = a_ok[i] ? m / t_out : 0;
    const long long t = a_ok[i] ? m % t_out : 0;
    a_row[i] = x + (b * t_in + 2 * t) * (long long)c_in;
  }
  // B loads: chunk row b_k + 4i, column b_n.
  const int b_n = tid % BN;
  const int b_k = tid / BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    const int ka = k0 + a_k;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a_s[a_k][a_r + 16 * i] =
          (a_ok[i] && ka < k_total) ? to_f32(a_row[i][ka]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b_k + 4 * i;
      const int k = k0 + kk;
      const int n = n0 + b_n;
      b_s[kk][b_n] = (k < k_total && n < c_out)
                         ? to_f32(w[(long long)k * c_out + n])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < c_out) y[m * c_out + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// ----------------------------------------------------- f32: 128x128 SGEMM

constexpr int FM = 128, FN = 128, FK = 8;

__global__ void __launch_bounds__(NT)
    conv_k3s2_fwd_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ y, int t_in, int t_out,
                             int c_in, int c_out, long long m_total) {
  __shared__ __align__(16) float a_s[2][FK][FM];  // [k][m]
  __shared__ __align__(16) float b_s[2][FK][FN];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const int k_total = 3 * c_in;
  const int n_k = (k_total + FK - 1) / FK;

  // A: one float4 (4 consecutive k) of row a_row per thread
  const int a_row = tid / 2, a_kq = (tid % 2) * 4;
  const long long am = m0 + a_row;
  const bool a_ok = am < m_total;
  const float* a_ptr =
      x + (a_ok ? ((am / t_out) * t_in + 2 * (am % t_out)) * (long long)c_in
                : 0);
  // B: one float4 (4 consecutive n) of chunk row b_k per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;
  const bool b_n_ok = n0 + b_n < c_out;

  float4 a_reg, b_reg;
  auto load = [&](int k0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    a_reg = (a_ok && k0 + a_kq < k_total)
                ? *reinterpret_cast<const float4*>(a_ptr + k0 + a_kq)
                : zero;
    b_reg = (b_n_ok && k0 + b_k < k_total)
                ? *reinterpret_cast<const float4*>(
                      w + (long long)(k0 + b_k) * c_out + n0 + b_n)
                : zero;
  };
  auto store = [&](int buf) {
    a_s[buf][a_kq + 0][a_row] = a_reg.x;
    a_s[buf][a_kq + 1][a_row] = a_reg.y;
    a_s[buf][a_kq + 2][a_row] = a_reg.z;
    a_s[buf][a_kq + 3][a_row] = a_reg.w;
    *reinterpret_cast<float4*>(&b_s[buf][b_k][b_n]) = b_reg;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load((kt + 1) * FK);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(&a[0]) =
          *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) =
          *reinterpret_cast<const float4*>(&a_s[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&b[0]) =
          *reinterpret_cast<const float4*>(&b_s[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(&b[4]) =
          *reinterpret_cast<const float4*>(&b_s[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= m_total) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < c_out)
        *reinterpret_cast<float4*>(y + m * c_out + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------- bf16: mma.sync tensor cores

constexpr int TM = 128, TN = 128, TK = 64;  // CTA tile, K chunk
constexpr int TSTAGES = 3;                 // cp.async ring depth
constexpr int TNT = 128;                   // 4 warps, 2 x 2, 64x64 each
constexpr int A_LD = TK + 8;  // bf16 per shared A row: 144 B, so the 8 row
constexpr int B_LD = TN + 8;  // addresses of an ldmatrix hit 8 bank groups
constexpr int A_TILE = TM * A_LD;
constexpr int B_TILE = TK * B_LD;
constexpr int TC_SMEM = TSTAGES * (A_TILE + B_TILE) * 2;  // 107,520 B

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
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

__global__ void __launch_bounds__(TNT, 2)
    conv_k3s2_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ w,
                                  __nv_bfloat16* __restrict__ y, int t_in,
                                  int t_out, int c_in, int c_out,
                                  long long m_total) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_s = a_s + TSTAGES * A_TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int k_total = 3 * c_in;
  const int n_k = (k_total + TK - 1) / TK;

  // A: 16-byte chunks (row, 8 k) tid + 128r of 128 x 8; each row's window
  // x[b, 2t : 2t + 3, :] is one contiguous run of 3 * c_in elements
  constexpr int A_PER = TM * TK / 8 / TNT;
  const __nv_bfloat16* a_ptr[A_PER];
  int a_off[A_PER], a_kc[A_PER];
  bool a_ok[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const int id = tid + r * TNT;
    const int row = id / (TK / 8);
    a_kc[r] = (id % (TK / 8)) * 8;
    a_off[r] = row * A_LD + a_kc[r];
    const long long m = m0 + row;
    a_ok[r] = m < m_total;
    a_ptr[r] = x + (a_ok[r] ? ((m / t_out) * t_in + 2 * (m % t_out)) *
                                  (long long)c_in
                            : 0);
  }
  auto load = [&](int stage, int k0) {
    __nv_bfloat16* as = a_s + stage * A_TILE;
    __nv_bfloat16* bs = b_s + stage * B_TILE;
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int k = k0 + a_kc[r];
      const bool ok = a_ok[r] && k < k_total;
      cp_async16(as + a_off[r], ok ? a_ptr[r] + k : x, ok);
    }
    // B: chunks (k row, 8 n) tid + 128r of 64 x 16
#pragma unroll
    for (int r = 0; r < TK * TN / 8 / TNT; ++r) {
      const int id = tid + r * TNT;
      const int kr = id / (TN / 8), nc = (id % (TN / 8)) * 8;
      const bool ok = k0 + kr < k_total && n0 + nc < c_out;
      cp_async16(bs + kr * B_LD + nc,
                 ok ? w + (long long)(k0 + kr) * c_out + n0 + nc : w, ok);
    }
  };

  float acc[4][8][4];  // warp tile 64 x 64: 4 m16 x 8 n8 accumulators
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < n_k) load(s, s * TK);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane: A 16x16 tiles (rows lane % 16,
  // k half lane / 16); B transposed 16x16 tiles (k lane % 16, n half lane / 16)
  const int a_lane = (wm * 64 + lane % 16) * A_LD + (lane / 16) * 8;
  const int b_lane = (lane % 16) * B_LD + wn * 64 + (lane / 16) * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<TSTAGES - 2>();  // chunk kt has landed
    __syncthreads();  // ... for every thread, and chunk kt-1 is consumed
    const int nk = kt + TSTAGES - 1;
    if (nk < n_k) load(nk % TSTAGES, nk * TK);
    cp_async_commit();
    const __nv_bfloat16* as = a_s + (kt % TSTAGES) * A_TILE;
    const __nv_bfloat16* bs = b_s + (kt % TSTAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[4][4], bf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + a_lane + i * 16 * A_LD + kk, false);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // bf[j]: n8 tiles 2j and 2j + 1
        ldmatrix_x4(bf[j], bs + b_lane + kk * B_LD + j * 16, true);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                   bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // a lane holds rows g and g + 8, columns 2 t4 and 2 t4 + 1 of each tile
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn * 64 + j * 8 + 2 * t4;
        if (n < c_out)
          *reinterpret_cast<__nv_bfloat162*>(y + m * c_out + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// y (B, T_out, C_out) on the wgmma route: one product over the padded
// grid's B * T_pad rows, 3 C_in / 64 k stages, no K slices
int fwd_wgmma(const void* x, const void* w, void* y, int batch, int t_in,
              int c_in, int c_out, cudaStream_t s) {
  const int t_out = (t_in - 3) / 2 + 1, t_pad = (t_out + 127) / 128 * 128;
  tmagemm::Maps maps{};
  int err = 0;
  for (int z = 0; z < 3 && err == 0; ++z)
    err = tmagemm::encode_tap_rows(&maps.a[z], x, batch, t_in, c_in, z);
  if (err == 0)
    err = tmagemm::encode_matrix(&maps.b[0], w, 3 * c_in, c_out);
  if (err != 0) return err;
  const int nk = 3 * c_in / 64;
  const tmagemm::PaddedRowOut e{
      (__nv_bfloat16*)y, nullptr, c_out, t_out, t_pad};
  return tmagemm::wgmma_gemm(maps, tmagemm::TmaTapCols{t_pad, c_in / 64},
                             tmagemm::TmaWeightCols{nk}, e, batch * t_pad,
                             c_out, 1, 1, nk, s);
}

}  // namespace

// The route fwd_route gives: 0 = generic, 1 = SIMT (f32), 2 = mma.sync,
// 3 = wgmma (ops/conv.py:fwd_route mirrors it).
extern "C" int a8t_conv_k3s2_fwd_route(int dtype, int c_in, int c_out,
                                       int aligned) {
  return fwd_route(dtype, c_in, c_out, aligned);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int a8t_conv_k3s2_fwd(const void* x, const void* w, void* y,
                                 int batch, int t_in, int c_in, int c_out,
                                 int dtype, void* stream) {
  if (batch <= 0 || t_in < 3 || c_in <= 0 || c_out <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - 3) / 2 + 1;
  const long long m_total = (long long)batch * t_out;
  const bool aligned16 =
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int route = fwd_route(dtype, c_in, c_out, aligned16);
  if (route == kFwdWgmma)
    return fwd_wgmma(x, w, y, batch, t_in, c_in, c_out, s);
  if (route == kFwdMma) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_k3s2_fwd_bf16_mma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((m_total + TM - 1) / TM),
                    (unsigned)((c_out + TN - 1) / TN));
    conv_k3s2_fwd_bf16_mma_kernel<<<grid, TNT, TC_SMEM, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        t_in, t_out, c_in, c_out, m_total);
    return (int)cudaGetLastError();
  }
  if (route == kFwdSimt) {
    const dim3 grid((unsigned)((m_total + FM - 1) / FM),
                    (unsigned)((c_out + FN - 1) / FN));
    conv_k3s2_fwd_f32_kernel<<<grid, NT, 0, s>>>(
        (const float*)x, (const float*)w, (float*)y, t_in, t_out, c_in, c_out,
        m_total);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((m_total + BM - 1) / BM),
                  (unsigned)((c_out + BN - 1) / BN));
  if (dtype == 0) {
    conv_k3s2_fwd_kernel<float><<<grid, NT, 0, s>>>(
        (const float*)x, (const float*)w, (float*)y, t_in, t_out, c_in, c_out,
        m_total);
  } else {
    conv_k3s2_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        t_in, t_out, c_in, c_out, m_total);
  }
  return (int)cudaGetLastError();
}
