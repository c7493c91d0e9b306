// Stride-2, kernel-3 VALID 1-D convolution, backward: dgrad and wgrad.
//
// Replaces the TPU kernels audio8_tpu/ops/pallas/conv_kernel.py:
// _dgrad_kernel (driven by _dgrad_pallas) and _wgrad_kernel (driven by
// _wgrad_pallas), the backward of conv1d_k3s2's custom VJP:
//
//     dx[2t]   = dy[t] W0^T + dy[t-1] W2^T
//     dx[2t+1] = dy[t] W1^T
//     dW_j     = sum_{b,t} x[b, 2t+j]^T dy[b, t]       (f32)
//
// On its mma.sync and SIMT routes (below) dgrad is an implicit GEMM over
// paired rows, like the TPU kernel: row (b, t) of A is [dy[t-1] | dy[t]],
// 2*C_out elements that are contiguous in (B, T_out, C_out) memory, and
// the output row is the paired [dx[2t] | dx[2t+1]], 2*C_in contiguous
// elements of dx. B is [[W2^T, 0], [W0^T, W1^T]] read from wt = w^T (3,
// C_out, C_in), which the wrapper makes. A CTA tile that lies wholly in
// the dx[2t+1] half skips the zero block (its K range starts at C_out),
// so only tiles that straddle the halves spend operations on it. t runs
// to T_out inclusive: the extra row t = T_out has A = [dy[T_out-1] | 0],
// which gives the tail rows dx[2 T_out] = dy[T_out-1] W2^T and (even
// T_in) dx[2 T_out + 1] = 0, so one launch writes every row of dx.
// A[.][k < C_out] is zero at t = 0, A[.][k >= C_out] at t = T_out.
//
// wgrad is dW (3C_in x C_out) = X^T DY with X the overlapping im2col view
// the forward reads (row (b, t) = x[b, 2t : 2t+3, :], 3*C_in contiguous
// elements) and K = B*T_out rows. Both operands are rows of contiguous
// M (resp. N) values per reduction index, so tiles land in shared memory
// as [k][m] and [k][n] without transposes. The TPU runs its grid in order
// and accumulates into one revisited output block; here the reduction is
// split over `splits` CTAs per output tile (grid z), each writes an f32
// partial, and a second kernel sums the partials in split order. No
// atomics: the result does not depend on scheduling.
//
// What bounds it on H100: at the wav2vec2 extractor shapes (512 -> 512
// channels, up to 143k rows) both products are compute-bound, by the
// multiply-add rate. In bf16 with channel counts in multiples of 64 both
// run tma_gemm.cuh's TMA-fed wgmma GEMM (below; routes dgrad_route and
// wgrad_route). dgrad there is two products over the rows (b, t) of the
// padded grid (T_pad = T_out + 1 rounded up to 128, so the tail row t =
// T_out lies inside a tile and no tile straddles two batch rows), N =
// C_in, one per half of dx, so the zero block of B is never multiplied:
// the even rows [dy[t-1] | dy[t]] [W2^T; W0^T] (K = 2 C_out), the odd
// rows dy[t] W1^T (K = C_out). A is dy's one (C_out, T_out, B) tensor map
// read K-major with a row shift per K segment (TmaShiftRows: t - 1, then
// t); TMA zero-fills the rows t - 1 = -1 and t >= T_out, which are the
// paired formulation's zero rows, so dy is not padded. B is tap z of w
// (3, C_in, C_out) read K-major as it lies (TmaWeightRows), so this route
// needs no w^T. The bf16 epilogue stages a tile in shared memory and
// stores it by TMA (HalfRowsOut) through a map of every other row of dx
// from row z, (T_in - z + 1) / 2 of them: row (b, t) of half z lands in
// dx[b, 2t + z], TMA drops the rest, and the stores overlap the next
// tile's products. Every row of dx is written once: no memset, no
// atomics. Otherwise two variants, by dtype; both want 16-byte aligned
// pointers and channel rows of whole 16-byte vectors (C_in and C_out
// multiples of 8 for bf16, of 4 for f32), which the wrapper ensures (it
// copies a misaligned input and refuses other channel counts):
//   * bf16: mma.sync m16n8k16 (f32 accumulation), 128x128 CTA tile of
//     four 64x64 warp tiles, 64-deep K chunks in a 3-stage cp.async ring
//     (zero-filled at the ragged edges and at the masked halves of
//     dgrad's A);
//   * f32: a 128x128 SIMT SGEMM with 8x8 outputs per thread, 8-deep K
//     chunks double buffered, float4 traffic, capped at 128 registers so
//     two CTAs share an SM (faster on an H100 than one CTA at 161
//     registers, PERF.md); f32 stays on the CUDA cores so its sums are
//     full f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_gemm.cuh"

namespace {

enum BwdRoute { kSimt = 0, kMma = 1, kWgmma = 2 };

// wgrad's route from the shape alone (dtype 0 = float32, 1 = bfloat16);
// ops/conv.py:wgrad_route mirrors it
inline int wgrad_route(int dtype, int c_in, int c_out) {
  if (dtype != 1) return kSimt;
  return c_in % 64 == 0 && c_out % 64 == 0 ? kWgmma : kMma;
}

// dgrad's route: the same rule (both products want whole 64 x 64 boxes
// of either channel count); ops/conv.py:dgrad_route mirrors it
inline int dgrad_route(int dtype, int c_in, int c_out) {
  return wgrad_route(dtype, c_in, c_out);
}

// ------------------------------------------------------------ problems
//
// Each problem is a GEMM C[m][n] = sum_k A[m][k] B[k][n]: its operands,
// sizes and the K range of a CTA.

// dgrad: m = (b, t) in [0, B*(T_out+1)), n in [0, 2*C_in), k in
// [0, 2*C_out)
template <typename T>
struct Dgrad {
  const T* dy;  // (B, T_out, C_out)
  const T* wt;  // (3, C_out, C_in)
  T* dx;        // (B, T_in, C_in)
  int t_in, t_out, c_in, c_out;
  long long m_total;

  // a tile wholly in the dx[2t+1] half skips B's zero block
  __device__ void k_range(int n0, int, long long& kb, long long& ke) const {
    kb = n0 >= c_in ? c_out : 0;
    ke = 2 * c_out;
  }
};

// wgrad: m in [0, 3*C_in), n in [0, C_out), k = (b, t) in [0, B*T_out),
// split z of the K range into out + z * 3*C_in*C_out (f32)
template <typename T>
struct Wgrad {
  const T* x;   // (B, T_in, C_in)
  const T* dy;  // (B, T_out, C_out)
  float* out;   // (splits, 3*C_in, C_out)
  int t_in, t_out, c_in, c_out;
  long long m_total;  // 3*C_in
  long long k_total;  // B*T_out
  long long k_split;  // rows per split

  __device__ void k_range(int, int z, long long& kb, long long& ke) const {
    kb = (long long)z * k_split;
    ke = kb + k_split < k_total ? kb + k_split : k_total;
  }
  __device__ long long row(long long r) const {  // im2col row of r
    const long long b = r / t_out;
    const long long t = r % t_out;
    return (b * t_in + 2 * t) * (long long)c_in;
  }
  __device__ float* split_out(int z) const {
    return out + (long long)z * m_total * c_out;
  }
};

// ------------------------------------------- f32: 128x128 SIMT SGEMMs

constexpr int FM = 128, FN = 128, FK = 8;
constexpr int NT = 256;  // threads per CTA

// the 8x8 register tile of one thread: rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise with tx
__device__ __forceinline__ void sgemm_chunk(const float (*a_s)[FM],
                                            const float (*b_s)[FN], int tx,
                                            int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < FK; ++k) {
    float a[8], b[8];
    *reinterpret_cast<float4*>(&a[0]) =
        *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
    *reinterpret_cast<float4*>(&a[4]) =
        *reinterpret_cast<const float4*>(&a_s[k][64 + ty * 4]);
    *reinterpret_cast<float4*>(&b[0]) =
        *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
    *reinterpret_cast<float4*>(&b[4]) =
        *reinterpret_cast<const float4*>(&b_s[k][64 + tx * 4]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int sgemm_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

// dgrad, f32: A rows as float4 along k (stored transposed), B rows as
// float4 along n
__global__ void __launch_bounds__(NT, 2)
    dgrad_f32_kernel(Dgrad<float> p) {
  __shared__ __align__(16) float a_s[2][FK][FM];  // [k][m]
  __shared__ __align__(16) float b_s[2][FK][FN];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const int n_total = 2 * p.c_in;
  long long kb, ke;
  p.k_range(n0, 0, kb, ke);
  const int n_k = (int)((ke - kb + FK - 1) / FK);

  // A: one float4 (4 consecutive k) of row a_row per thread
  const int a_row = tid / 2, a_kq = (tid % 2) * 4;
  const long long am = m0 + a_row;
  const bool a_in = am < p.m_total;
  const long long ab = a_in ? am / (p.t_out + 1) : 0;
  const int at = a_in ? (int)(am % (p.t_out + 1)) : 0;
  const long long a_off = (ab * p.t_out + at - 1) * (long long)p.c_out;
  // B: one float4 (4 consecutive n) of chunk row b_k per thread
  const int b_k = tid / 32, b_n = (tid % 32) * 4;
  const int bn = n0 + b_n;
  const bool b_in = bn < n_total;

  float4 a_reg, b_reg;
  auto load = [&](long long k0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long ka = k0 + a_kq;
    const bool a_ok = a_in && ka < ke &&
                      (ka < p.c_out ? at >= 1 : at < p.t_out);
    a_reg = a_ok ? *reinterpret_cast<const float4*>(p.dy + a_off + ka)
                 : zero;
    const long long k = k0 + b_k;
    b_reg = zero;
    if (b_in && k < ke) {
      const float* src = nullptr;
      if (bn < p.c_in)
        src = p.wt + ((k < p.c_out ? 2LL * p.c_out + k : k - p.c_out) *
                          p.c_in + bn);
      else if (k >= p.c_out)
        src = p.wt + ((long long)k * p.c_in + (bn - p.c_in));  // W1^T row
      if (src != nullptr) b_reg = *reinterpret_cast<const float4*>(src);
    }
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

  load(kb);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load(kb + (long long)(kt + 1) * FK);
    sgemm_chunk(a_s[buf], b_s[buf], tx, ty, acc);
    if (kt + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + sgemm_row(i, ty);
    if (m >= p.m_total) continue;
    const long long b = m / (p.t_out + 1);
    const int t = (int)(m % (p.t_out + 1));
    float* row = p.dx + (b * p.t_in + 2 * t) * (long long)p.c_in;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= n_total || (n >= p.c_in && 2 * t + 1 >= p.t_in)) continue;
      *reinterpret_cast<float4*>(row + n) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
    }
  }
}

// wgrad, f32: both operands as float4 rows along m (resp. n)
__global__ void __launch_bounds__(NT, 2)
    wgrad_f32_kernel(Wgrad<float> p) {
  __shared__ __align__(16) float a_s[2][FK][FM];  // [k][m]
  __shared__ __align__(16) float b_s[2][FK][FN];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  long long kb, ke;
  p.k_range(0, blockIdx.z, kb, ke);
  const int n_k = (int)((ke - kb + FK - 1) / FK);

  const int l_k = tid / 32, l_q = (tid % 32) * 4;  // chunk row, 4 columns
  const bool a_in = m0 + l_q < p.m_total;
  const bool b_in = n0 + l_q < p.c_out;

  float4 a_reg, b_reg;
  auto load = [&](long long k0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long r = k0 + l_k;
    const bool ok = r < ke;
    a_reg = ok && a_in ? *reinterpret_cast<const float4*>(
                             p.x + p.row(r) + m0 + l_q)
                       : zero;
    b_reg = ok && b_in ? *reinterpret_cast<const float4*>(
                             p.dy + r * p.c_out + n0 + l_q)
                       : zero;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&a_s[buf][l_k][l_q]) = a_reg;
    *reinterpret_cast<float4*>(&b_s[buf][l_k][l_q]) = b_reg;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (n_k > 0) {
    load(kb);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load(kb + (long long)(kt + 1) * FK);
    sgemm_chunk(a_s[buf], b_s[buf], tx, ty, acc);
    if (kt + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

  float* out = p.split_out(blockIdx.z);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + sgemm_row(i, ty);
    if (m >= p.m_total) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < p.c_out)
        *reinterpret_cast<float4*>(out + m * p.c_out + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------- bf16: mma.sync tensor cores

constexpr int TM = 128, TN = 128, TK = 64;  // CTA tile, K chunk
constexpr int TSTAGES = 3;                 // cp.async ring depth
constexpr int TNT = 128;                   // 4 warps, 2 x 2, 64x64 each
// dgrad A is [m][k] (as in the forward); wgrad A is [k][m]. The +8 pad
// makes the 8 row addresses of an ldmatrix hit 8 different bank groups.
constexpr int MK_LD = TK + 8;
constexpr int KM_LD = TM + 8;
constexpr int KN_LD = TN + 8;
constexpr int DG_A_TILE = TM * MK_LD;
constexpr int WG_A_TILE = TK * KM_LD;
constexpr int B_TILE = TK * KN_LD;
constexpr int DG_SMEM = TSTAGES * (DG_A_TILE + B_TILE) * 2;  // 107,520 B
constexpr int WG_SMEM = TSTAGES * (WG_A_TILE + B_TILE) * 2;  // 104,448 B

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

// One 64-deep chunk of the 64x64 warp tile. a_lane/b_lane: this lane's
// ldmatrix addresses for k = 0; a_kstep: elements between k and k + 16 in
// the A tile (16 for [m][k], 16 rows for [k][m]); a_mstep: between m16
// blocks.
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* a_lane,
                                          int a_kstep, int a_mstep,
                                          bool a_trans,
                                          const __nv_bfloat16* b_lane,
                                          float (&acc)[4][8][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t af[4][4], bf[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldmatrix_x4(af[i], a_lane + kk * a_kstep + i * a_mstep, a_trans);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // bf[j]: n8 tiles 2j and 2j + 1
      ldmatrix_x4(bf[j], b_lane + kk * 16 * KN_LD + j * 16, true);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                 bf[j / 2][(j % 2) * 2 + 1]);
  }
}

__global__ void __launch_bounds__(TNT, 2)
    dgrad_bf16_mma_kernel(Dgrad<__nv_bfloat16> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_s = a_s + TSTAGES * DG_A_TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int n_total = 2 * p.c_in;
  long long kb, ke;
  p.k_range(n0, 0, kb, ke);
  const int n_k = (int)((ke - kb + TK - 1) / TK);

  // A: 16-byte chunks (row, 8 k) tid + 128r of 128 x 8
  constexpr int A_PER = TM * TK / 8 / TNT;
  long long a_base[A_PER];
  int a_off[A_PER], a_kc[A_PER], a_t[A_PER];
  bool a_in[A_PER];
#pragma unroll
  for (int r = 0; r < A_PER; ++r) {
    const int id = tid + r * TNT;
    const int row = id / (TK / 8);
    a_kc[r] = (id % (TK / 8)) * 8;
    a_off[r] = row * MK_LD + a_kc[r];
    const long long m = m0 + row;
    a_in[r] = m < p.m_total;
    const long long b = a_in[r] ? m / (p.t_out + 1) : 0;
    a_t[r] = a_in[r] ? (int)(m % (p.t_out + 1)) : 0;
    a_base[r] = (b * p.t_out + a_t[r] - 1) * (long long)p.c_out;
  }
  auto load = [&](int stage, long long k0) {
    __nv_bfloat16* as = a_s + stage * DG_A_TILE;
    __nv_bfloat16* bs = b_s + stage * B_TILE;
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const long long k = k0 + a_kc[r];
      const bool ok = a_in[r] && k < ke &&
                      (k < p.c_out ? a_t[r] >= 1 : a_t[r] < p.t_out);
      cp_async16(as + a_off[r], ok ? p.dy + a_base[r] + k : p.dy, ok);
    }
    // B: chunks (k row, 8 n) tid + 128r of 64 x 16
#pragma unroll
    for (int r = 0; r < TK * TN / 8 / TNT; ++r) {
      const int id = tid + r * TNT;
      const int kr = id / (TN / 8), nc = (id % (TN / 8)) * 8;
      const long long k = k0 + kr;
      const int n = n0 + nc;
      const __nv_bfloat16* src = p.wt;
      bool ok = k < ke && n < n_total;
      if (ok) {
        if (n < p.c_in)
          src = p.wt + ((k < p.c_out ? 2LL * p.c_out + k : k - p.c_out) *
                            p.c_in + n);
        else if (k >= p.c_out)
          src = p.wt + ((long long)k * p.c_in + (n - p.c_in));
        else
          ok = false;  // the zero block of B
      }
      cp_async16(bs + kr * KN_LD + nc, ok ? src : p.wt, ok);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < n_k) load(s, kb + (long long)s * TK);
    cp_async_commit();
  }
  // A 16x16 tiles from [m][k] (rows lane % 16, k half lane / 16); B
  // transposed 16x16 tiles from [k][n] (k lane % 16, n half lane / 16)
  const int a_lane = (wm * 64 + lane % 16) * MK_LD + (lane / 16) * 8;
  const int b_lane = (lane % 16) * KN_LD + wn * 64 + (lane / 16) * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<TSTAGES - 2>();  // chunk kt has landed
    __syncthreads();  // ... for every thread, and chunk kt-1 is consumed
    const int nk = kt + TSTAGES - 1;
    if (nk < n_k) load(nk % TSTAGES, kb + (long long)nk * TK);
    cp_async_commit();
    mma_chunk(a_s + (kt % TSTAGES) * DG_A_TILE + a_lane, 16, 16 * MK_LD,
              false, b_s + (kt % TSTAGES) * B_TILE + b_lane, acc);
  }
  cp_async_wait<0>();

  // a lane holds rows g and g + 8, columns 2 t4 and 2 t4 + 1 of each tile
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= p.m_total) continue;
      const long long b = m / (p.t_out + 1);
      const int t = (int)(m % (p.t_out + 1));
      __nv_bfloat16* row = p.dx + (b * p.t_in + 2 * t) * (long long)p.c_in;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn * 64 + j * 8 + 2 * t4;
        if (n >= n_total || (n >= p.c_in && 2 * t + 1 >= p.t_in)) continue;
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(TNT, 2)
    wgrad_bf16_mma_kernel(Wgrad<__nv_bfloat16> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_s = a_s + TSTAGES * WG_A_TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  long long kb, ke;
  p.k_range(0, blockIdx.z, kb, ke);
  const int n_k = (int)((ke - kb + TK - 1) / TK);

  // A and B: 16-byte chunks (k row, 8 columns) tid + 128r of 64 x 16
  auto load = [&](int stage, long long k0) {
    __nv_bfloat16* as = a_s + stage * WG_A_TILE;
    __nv_bfloat16* bs = b_s + stage * B_TILE;
#pragma unroll
    for (int r = 0; r < TK * TM / 8 / TNT; ++r) {
      const int id = tid + r * TNT;
      const int kr = id / (TM / 8), c = (id % (TM / 8)) * 8;
      const long long k = k0 + kr;
      const bool kok = k < ke;
      const bool aok = kok && m0 + c < p.m_total;
      cp_async16(as + kr * KM_LD + c, aok ? p.x + p.row(k) + m0 + c : p.x,
                 aok);
      const bool bok = kok && n0 + c < p.c_out;
      cp_async16(bs + kr * KN_LD + c, bok ? p.dy + k * p.c_out + n0 + c : p.dy,
                 bok);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < n_k) load(s, kb + (long long)s * TK);
    cp_async_commit();
  }
  // A from [k][m] through ldmatrix.trans: the four 8x8 matrices of an
  // m16k16 A tile are (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15); lane l addresses k row l % 8 + 8 (l / 16) at m
  // offset 8 ((l / 8) % 2)
  const int a_lane = ((lane % 8) + (lane / 16) * 8) * KM_LD + wm * 64 +
                     ((lane / 8) % 2) * 8;
  const int b_lane = (lane % 16) * KN_LD + wn * 64 + (lane / 16) * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    const int nk = kt + TSTAGES - 1;
    if (nk < n_k) load(nk % TSTAGES, kb + (long long)nk * TK);
    cp_async_commit();
    mma_chunk(a_s + (kt % TSTAGES) * WG_A_TILE + a_lane, 16 * KM_LD, 16,
              true, b_s + (kt % TSTAGES) * B_TILE + b_lane, acc);
  }
  cp_async_wait<0>();

  float* out = p.split_out(blockIdx.z);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= p.m_total) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn * 64 + j * 8 + 2 * t4;
        if (n < p.c_out)
          *reinterpret_cast<float2*>(out + m * p.c_out + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// ------------------------------------ bf16 dgrad on the TMA-fed wgmma GEMM
//
// Row (b, t) of the padded grid (m = b * T_pad + t) of half z's product
// is dx[b, 2t + z]: stored by TMA through the half's map m[0] (C_in,
// (T_in - z + 1) / 2, B) of every other dx row from row z, which drops
// the rows 2t + z >= T_in (so t <= T_out) and the rest of the padded grid.
struct HalfRowsOut {
  static constexpr bool kStaged = true, kTmaStore = true;
  int rows_pad;
  __device__ float value(int, int, float v) const { return v; }
  // the 64 x 64 box of rows m0 .. m0 + 63 (one batch row), columns n
  __device__ void store(const CUtensorMap* m, int, int m0, int n,
                        uint32_t src) const {
    const int b = m0 / rows_pad;
    wg::tma_store(m, src, n, m0 - b * rows_pad, b);
  }
};

// The two halves, one launch each: the even rows over K segments dy[t-1]
// (tap 2) and dy[t] (tap 0), the odd rows over dy[t] (tap 1).
int dgrad_wgmma(const void* dy, const void* w, void* dx, int batch,
                int t_in, int c_in, int c_out, cudaStream_t s) {
  const int t_out = (t_in - 3) / 2 + 1;
  const int t_pad = (t_out + 1 + 127) / 128 * 128, c_stages = c_out / 64;
  const __nv_bfloat16* taps = (const __nv_bfloat16*)w;
  const int tap_of[2][2] = {{2, 0}, {1}};  // [half][K segment]
  for (int z = 0; z < 2; ++z) {
    const int segs = 2 - z;
    tmagemm::Maps maps{};
    int err = tmagemm::encode_rows(&maps.a[0], dy, batch, t_out, c_out);
    if (err == 0)
      err = tmagemm::encode_alternate_rows(&maps.c[0], dx, batch, t_in, c_in,
                                           z, (t_in - z + 1) / 2);
    for (int seg = 0; seg < segs && err == 0; ++seg)
      err = tmagemm::encode_matrix(
          &maps.b[seg], taps + (long long)tap_of[z][seg] * c_in * c_out,
          c_in, c_out);
    if (err == 0)
      err = tmagemm::wgmma_gemm(
          maps, tmagemm::TmaShiftRows{t_pad, c_stages, 1 - z},
          tmagemm::TmaWeightRows{0, c_stages}, HalfRowsOut{t_pad},
          batch * t_pad, c_in, 1, 1, segs * c_stages, s);
    if (err != 0) return err;
  }
  return 0;
}

// ------------------------------------ bf16 wgrad on the TMA-fed wgmma GEMM
//
// dW_z = sum_{b,t} x[b, 2t+z]^T dy[b, t] is tma_gemm.cuh's wgmma_gemm
// with Z = 3 taps, M = C_in, N = C_out and K stages of 64 t
// rows of one batch row ((b, t tile), B * ceil(T_out / 64) of them), cut
// into S fixed slices of consecutive stages. A is tap z's MN-major map
// (C_in, T_out, B) over x with a row stride of 2 C_in (TmaTapRows), B
// reads dy as (C_out, T_out, B) (TmaRowCols); rows past T_out are zero in
// both, so the ragged tile adds exact zeros. Each (tap, slice) writes
// its f32 partial in the (S, 3, C_in, C_out) layout that
// sum_splits_kernel sums in slice order (dw itself when S = 1).
struct TapPartial {
  static constexpr bool kStaged = false;
  float* p;
  int splits;
  long long plane;  // C_in * C_out
  int ld;           // C_out
  __device__ void pair(int zs, int m, int n, float v0, float v1) const {
    const int z = zs / splits, s = zs - z * splits;
    *reinterpret_cast<float2*>(p + ((long long)s * 3 + z) * plane +
                               (long long)m * ld + n) = make_float2(v0, v1);
  }
};

int wgrad_wgmma(const void* x, const void* dy, float* out, int batch,
                int t_in, int c_in, int c_out, int splits,
                cudaStream_t s) {
  const int t_out = (t_in - 3) / 2 + 1, row_tiles = (t_out + 63) / 64;
  tmagemm::Maps maps{};
  int err = 0;
  for (int z = 0; z < 3 && err == 0; ++z)
    err = tmagemm::encode_tap_rows(&maps.a[z], x, batch, t_in, c_in, z);
  if (err == 0)
    err = tmagemm::encode_rows(&maps.b[0], dy, batch, t_out, c_out);
  if (err != 0) return err;
  const TapPartial e{out, splits, (long long)c_in * c_out, c_out};
  return tmagemm::wgmma_gemm(maps, tmagemm::TmaTapRows{row_tiles},
                             tmagemm::TmaRowCols{row_tiles}, e, c_in, c_out,
                             3, splits, batch * row_tiles, s);
}

// dw[i] = sum over s of part[s][i], in split order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long n,
                                  int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(long long)z * n + i];
    dw[i] = s;
  }
}

// the variants' contract: float32 (0) or bfloat16 (1), 16-byte aligned
// pointers, channel rows of whole 16-byte vectors
bool fits(int dtype, const void* a, const void* b, const void* c, int c_in,
          int c_out) {
  if (dtype != 0 && dtype != 1) return false;
  const int vec = dtype == 1 ? 8 : 4;
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16) == 0 &&
         c_in % vec == 0 && c_out % vec == 0;
}

}  // namespace

// dy (B, T_out, C_out) -> dx (B, T_in, C_in), T_out = (T_in - 3) / 2 +
// 1, every row of dx written, from w (3, C_in, C_out) on the wgmma route
// and from wt = w^T (3, C_out, C_in) on the others (the other pointer may
// be null). dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of
// the first failed launch or tensor-map encoding (invalid value for
// inputs off the route's contract).
extern "C" int a8t_conv_k3s2_dgrad(const void* dy, const void* w,
                                   const void* wt, void* dx, int batch,
                                   int t_in, int c_in, int c_out, int dtype,
                                   void* stream) {
  const int route = dgrad_route(dtype, c_in, c_out);
  const void* weight = route == kWgmma ? w : wt;
  if (batch <= 0 || t_in < 3 || c_in <= 0 || c_out <= 0 ||
      weight == nullptr || !fits(dtype, dy, weight, dx, c_in, c_out))
    return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - 3) / 2 + 1;
  const long long m_total = (long long)batch * (t_out + 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kWgmma)
    return dgrad_wgmma(dy, w, dx, batch, t_in, c_in, c_out, s);
  if (route == kMma) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgrad_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DG_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((m_total + TM - 1) / TM),
                    (unsigned)((2 * c_in + TN - 1) / TN));
    dgrad_bf16_mma_kernel<<<grid, TNT, DG_SMEM, s>>>(Dgrad<__nv_bfloat16>{
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)wt,
        (__nv_bfloat16*)dx, t_in, t_out, c_in, c_out, m_total});
  } else {
    const dim3 grid((unsigned)((m_total + FM - 1) / FM),
                    (unsigned)((2 * c_in + FN - 1) / FN));
    dgrad_f32_kernel<<<grid, NT, 0, s>>>(
        Dgrad<float>{(const float*)dy, (const float*)wt, (float*)dx, t_in,
                     t_out, c_in, c_out, m_total});
  }
  return (int)cudaGetLastError();
}

// The route dgrad_route gives: 0 = SIMT, 1 = mma.sync, 2 = wgmma
// (ops/conv.py:dgrad_route mirrors it).
extern "C" int a8t_conv_k3s2_dgrad_route(int dtype, int c_in, int c_out) {
  return dgrad_route(dtype, c_in, c_out);
}

// The route wgrad_route gives: 0 = SIMT, 1 = mma.sync, 2 = wgmma
// (ops/conv.py:wgrad_route mirrors it).
extern "C" int a8t_conv_k3s2_wgrad_route(int dtype, int c_in, int c_out) {
  return wgrad_route(dtype, c_in, c_out);
}

// x (B, T_in, C_in), dy (B, T_out, C_out) -> dw (3, C_in, C_out) float32.
// The B*T_out rows are cut into `splits` ranges of `rows_per_split`; on
// the wgmma route the ranges are whole K stages (rows_per_split = 64 x
// ceil(B ceil(T_out / 64) / splits), the padded rows of a slice). With
// splits > 1 each range's partial goes to part (splits, 3, C_in, C_out)
// and a second kernel sums them into dw, with splits == 1 the GEMM writes
// dw itself (part may be null). Returns the first launch error (invalid
// value for inputs off the variants' contract).
extern "C" int a8t_conv_k3s2_wgrad(const void* x, const void* dy, float* dw,
                                   float* part, int batch, int t_in, int c_in,
                                   int c_out, int splits,
                                   long long rows_per_split, int dtype,
                                   void* stream) {
  if (batch <= 0 || t_in < 3 || c_in <= 0 || c_out <= 0 || splits <= 0 ||
      rows_per_split <= 0 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - 3) / 2 + 1;
  const long long k_total = (long long)batch * t_out;
  if ((long long)splits * rows_per_split < k_total)
    return (int)cudaErrorInvalidValue;
  const long long m_total = 3LL * c_in;
  float* out = splits > 1 ? part : dw;
  if (!fits(dtype, x, dy, out, c_in, c_out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int route = wgrad_route(dtype, c_in, c_out);
  if (route == kWgmma) {
    const long long stages = (long long)batch * ((t_out + 63) / 64);
    if (rows_per_split != 64 * ((stages + splits - 1) / splits))
      return (int)cudaErrorInvalidValue;
    const int err = wgrad_wgmma(x, dy, out, batch, t_in, c_in, c_out, splits,
                                s);
    if (err != 0) return err;
  } else if (route == kMma) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((m_total + TM - 1) / TM),
                    (unsigned)((c_out + TN - 1) / TN), (unsigned)splits);
    wgrad_bf16_mma_kernel<<<grid, TNT, WG_SMEM, s>>>(Wgrad<__nv_bfloat16>{
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, out, t_in, t_out,
        c_in, c_out, m_total, k_total, rows_per_split});
  } else {
    const dim3 grid((unsigned)((m_total + FM - 1) / FM),
                    (unsigned)((c_out + FN - 1) / FN), (unsigned)splits);
    wgrad_f32_kernel<<<grid, NT, 0, s>>>(
        Wgrad<float>{(const float*)x, (const float*)dy, out, t_in, t_out,
                     c_in, c_out, m_total, k_total, rows_per_split});
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = m_total * c_out;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, s>>>(part, dw, n, splits);
  return (int)cudaGetLastError();
}
