// The TMA-fed wgmma GEMM: C(z, m, n) = sum_k A(z, m, k) B(z, k, n) over
// bfloat16 operands with f32 accumulation. Four kernels' bf16 products
// run it: the attention block's (attention_block_gemm.cuh), the k3s2 conv
// forward (conv_k3s2_fwd.cu) and the conv's input and weight gradients
// (conv_k3s2_bwd.cu).
//
// A 128 x BN output tile per CTA (BN = 256 where the product's N allows,
// else 128), two consumer warpgroups issuing wgmma.mma_async m64nBNk16
// (f32 accumulators in registers) over 64-deep k stages, fed by one
// producer warp that keeps TMA loads in flight through a ring of three
// stages with full and empty mbarriers. Every operand arrives by TMA in
// its stored layout, as 64 x 64 boxes with 128-byte swizzle; the wgmma
// descriptor says which operands are MN-major (transposed), so no thread
// touches a tile. A caller describes each operand by a recipe (the Tma*
// structs below: which boxes of which tensor map make k stage ks of the
// rows or columns from mn0) over tensor maps of rank 2 to 4 that it
// encodes on the host per call, and its output by an epilogue functor: a
// bf16 output's value(z, n, sum), staged through shared memory, and
// either the address of 8 adjacent outputs (chunk), which the threads
// store, or a TMA store of each 64 x 64 box through the output's map
// c[z] (store, kTmaStore), which overlaps the next tile's products; or
// an f32 partial's two adjacent columns (pair). M tiles run over a
// padded grid (b, 128 rows of T_pad) where rows are (batch, time), so no
// tile straddles two batch rows; a persistent grid of one CTA per SM
// walks the tiles, so the next tile's loads overlap this tile's
// epilogue. The recipes' names show in the kernel's traced name;
// profile.py:GEMM_CALLERS files each A recipe under the kernel that uses
// it.
//
// What bounds it: operations, at the shapes of its callers (2 M N K per
// product, 989 TFLOP/s bf16 on an H100).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace tmagemm {

// The kernel. CTA: warps 0-7 are two consumer warpgroups (rows 0-63 and
// 64-127 of the 128 x BN tile, BN = 128 or 256), warp 8 the producer (one
// thread issues the TMA loads). A stage holds A as two 64 x 64 boxes (the
// two warpgroups' rows, or for an MN-major A their 64-wide M blocks) and B
// as BN / 64 (its 64-wide N blocks), each 8 KB, 128-byte swizzled. The
// producer waits for a stage's empty barrier (one arrival per consumer warp
// once its wgmma has read the stage), arms the full barrier with the stage's
// bytes and issues the boxes; a consumer waits for the full barrier, issues
// four m64nBNk16 (k = 16 each) and releases the stage before it once the
// group before has completed (one group in flight). Out-of-range boxes or
// rows are zero-filled by TMA and still count their bytes. BN = 256 takes a
// quarter off the bytes each product pulls from L2 into shared memory
// against 128, which is what bounds a 128 x 128 tile here. A bf16 output
// leaves through shared memory: each warpgroup writes its 64 x BN values
// there, then stores them as 16-byte runs along the output's rows (written
// straight from the accumulators, each store instruction puts 4 bytes into 8
// rows, half-sector pieces), or one of its threads stores them by TMA;
// f32 partials are written straight, 8-byte pieces already filling whole
// sectors. Three stages leave room for the
// staging buffer (a fourth bought no time in a trial build).

constexpr int WG_STAGES = 3;
constexpr int WG_BOX = 64 * 64 * 2;   // bytes of one 64 x 64 box
constexpr int WG_A = 2 * WG_BOX;      // A's share of a stage
constexpr int WG_THREADS = 288;       // 2 warpgroups + 1 warp

template <int BN>
struct WgPlan {
  static constexpr int STAGE = WG_A + BN / 64 * WG_BOX;
  static constexpr int BARS = WG_STAGES * STAGE;         // full, empty
  static constexpr int PITCH = BN + 8;                   // staged row, bf16
  static constexpr int EPI = BARS + 2 * WG_STAGES * 8;   // 2 x 64 x PITCH
  static constexpr int SMEM = EPI + 2 * 64 * PITCH * 2 + 1024;
  // a TMA-stored output's 2 x BN / 64 boxes of 64 x 64, 1024-aligned for
  // the 128-byte swizzle, in the same room (SMEM leaves 1024 bytes for
  // aligning the base)
  static constexpr int OUT = BARS + 1024;
  static_assert(OUT + 2 * 64 * BN * 2 <= SMEM - 1024, "TMA output staging");
};

// bar.sync on named barrier `id` among the 128 threads of a warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

struct Maps {
  CUtensorMap a[3];  // A's tensor maps, by K segment or by z
  CUtensorMap b[3];  // B's
  CUtensorMap c[3];  // a TMA-stored output's, by z
};

// Each operand kind loads the NB boxes of k stage ks (64 deep) for the
// 64 NB rows or columns from mn0 into dst (box i at dst + i * WG_BOX),
// completing on bar. MN = 1: the operand is MN-major (transposed).

// K-major: the rows of x or dout (B, T, D) on the padded grid (mn0 = b *
// T_pad + r0), map (D, T, B); k stage = columns 64 ks.
struct TmaPaddedRows {
  static constexpr int MN = 0;
  int rows_pad;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m, bar, 64 * ks, r + 64 * i, b);
  }
};

// K-major: a head-major (B, H, T_pad, dh) tensor as rows (b, r) of the
// padded grid and columns k = seg * H dh + h dh + d, map (dh, T_pad, H,
// B) m[seg]; seg_stages = H dh / 64 k stages per segment.
struct TmaHeadCols {
  static constexpr int MN = 0;
  int rows_pad, dh, seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
    const int h = k / dh, d = k - h * dh;
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + seg, bar, d, r + 64 * i, h, b);
  }
};

// K-major: a Dense weight (N, K) as B of x W^T, map (K, N); m[z] when
// by_z, else m[seg].
struct TmaWeightRows {
  static constexpr int MN = 0;
  int by_z, seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
    const CUtensorMap* map = m + (by_z ? z : seg);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, map, bar, k, mn0 + 64 * i);
  }
};

// MN-major: a Dense weight W (K, N) as B of dy W (element (n, k) = W[k,
// n]), map (N, K) m[seg].
struct TmaWeightCols {
  static constexpr int MN = 1;
  int seg_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / seg_stages, k = 64 * (ks - seg * seg_stages);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + seg, bar, mn0 + 64 * i, k);
  }
};

// MN-major: x or dout (B, T, D) as columns i and K rows (b, r), map (D,
// T, B); k stage ks = 64 rows from r0 of batch row b, (b, r0 / 64) = (ks
// / row_tiles, ks % row_tiles), the rows past T zero-filled.
struct TmaRowCols {
  static constexpr int MN = 1;
  int row_tiles;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m, bar, mn0 + 64 * i, r, b);
  }
};

// MN-major: a head-major (B, H, T_pad, dh) tensor as columns i = h dh + d
// and K rows (b, r) as TmaRowCols's, map (dh, T_pad, H, B) m[z].
struct TmaHeadRows {
  static constexpr int MN = 1;
  int row_tiles, dh;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int n = mn0 + 64 * i, h = n / dh;
      wg::tma_load(dst + i * WG_BOX, m + z, bar, n - h * dh, r, h, b);
    }
  }
};

// MN-major: tap z of a stride-2 conv's input x (B, T_in, C) as columns i
// (channels) and K rows (b, t) holding x[b, 2 t + z], map m[z] (C, T_out,
// B) from encode_tap_rows; k stage ks as TmaRowCols's.
struct TmaTapRows {
  static constexpr int MN = 1;
  int row_tiles;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int z, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int b = ks / row_tiles, r = 64 * (ks - b * row_tiles);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + z, bar, mn0 + 64 * i, r, b);
  }
};

// K-major: the forward's A operand of a stride-2, kernel-3 conv over x
// (B, T_in, C): rows (b, t) on the padded grid (mn0 = b * T_pad + r0) and
// columns k = z C + c holding x[b, 2 t + z, c]; k stage ks reads tap z =
// ks / c_stages (c_stages = C / 64) through m[z] (C, T_out, B) from
// encode_tap_rows, channels 64 (ks % c_stages), the rows past T_out
// zero-filled.
struct TmaTapCols {
  static constexpr int MN = 0;
  int rows_pad, c_stages;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int z = ks / c_stages, k = 64 * (ks - z * c_stages);
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m + z, bar, k, r + 64 * i, b);
  }
};

// K-major: the A operand of a stride-2, kernel-3 conv's input gradient,
// rows (b, t) of dy (B, T, C) on the padded grid (mn0 = b * T_pad + r0)
// and columns k = seg C + c holding dy[b, t - lag + seg, c]; k stage ks
// reads segment seg = ks / c_stages (c_stages = C / 64) through the one
// map (C, T, B) from encode_rows, channels 64 (ks % c_stages). Rows
// outside [0, T) (t - lag + seg = -1 included: TMA takes negative
// coordinates) are zero-filled.
struct TmaShiftRows {
  static constexpr int MN = 0;
  int rows_pad, c_stages, lag;
  template <int NB>
  __device__ void load(const CUtensorMap* m, int, int mn0, int ks,
                       uint32_t dst, uint32_t bar) const {
    const int seg = ks / c_stages, k = 64 * (ks - seg * c_stages);
    const int b = mn0 / rows_pad, r = mn0 - b * rows_pad + seg - lag;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      wg::tma_load(dst + i * WG_BOX, m, bar, k, r + 64 * i, b);
  }
};

// Rows of a bf16 (B, rows, ld) output from the padded grid (a staged
// epilogue): row m = b * rows_pad + r is output row b * rows + r (+
// bias), dropped for r >= rows.
struct PaddedRowOut {
  static constexpr bool kStaged = true, kTmaStore = false;
  __nv_bfloat16* p;
  const __nv_bfloat16* bias;
  int ld, rows, rows_pad;
  __device__ float value(int, int n, float v) const {
    return bias ? v + __bfloat162float(bias[n]) : v;
  }
  __device__ __nv_bfloat16* chunk(int, int m, int n) const {
    const int b = m / rows_pad, r = m - b * rows_pad;
    return r < rows ? p + ((long long)b * rows + r) * ld + n : nullptr;
  }
};

// Whether an epilogue stores its bf16 tiles by TMA (a staged one's
// kTmaStore; the others write f32 pairs straight).
template <class E>
__host__ __device__ constexpr bool tma_stored() {
  if constexpr (E::kStaged)
    return E::kTmaStore;
  else
    return false;
}

// The descriptor of k step kk (16 deep) of a 64-row (A) or BN-column (B)
// operand tile at `tile`: K-major rows of 128 bytes stacked (SBO 1024
// per 8 rows), or MN-major boxes of 64 k rows x 64 values side by side
// (LBO = a box).
template <int MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return MN ? wg::desc_sw128(tile + 2048 * kk, WG_BOX, 1024)
            : wg::desc_sw128(tile + 32 * kk, 16, 1024);
}

// Tiles t = ((z * S + slice) * mtiles + mt) * ntiles + nt of 128 x BN;
// slice s takes k stages [s * per, min(nk, (s + 1) * per)); the epilogue
// gets z * S + s.
template <int BN, class A, class B, class E>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_gemm_kernel(const __grid_constant__ Maps maps, const A a,
                      const B b, const E e, int M, int N, int Z, int S,
                      int nk) {
  constexpr int STAGE = WgPlan<BN>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + WgPlan<BN>::BARS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);                // full
      wg::mbar_init(bars + 8 * (WG_STAGES + s), 8);  // empty
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int mtiles = (M + 127) / 128, ntiles = (N + BN - 1) / BN;
  const int tiles = Z * S * mtiles * ntiles, per = (nk + S - 1) / S;

  if (warp == 8) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t % ntiles, mt = t / ntiles % mtiles;
        const int zs = t / ntiles / mtiles, z = zs / S;
        const int kb = (zs - z * S) * per, ke = min(nk, kb + per);
        for (int ks = kb; ks < ke; ++ks) {
          wg::mbar_wait(bars + 8 * (WG_STAGES + stage), phase ^ 1);
          const uint32_t full = bars + 8 * stage;
          const uint32_t sa = base + stage * STAGE;
          wg::mbar_expect_tx(full, STAGE);
          a.template load<2>(maps.a, z, mt * 128, ks, sa, full);
          b.template load<BN / 64>(maps.b, z, nt * BN, ks, sa + WG_A, full);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wi computes rows 64 wi .. 64 wi + 63 of the tile
  const int wi = warp / 4, g = lane / 4, u = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % ntiles, mt = t / ntiles % mtiles;
    const int zs = t / ntiles / mtiles, z = zs / S;
    const int kb = (zs - z * S) * per, ke = min(nk, kb + per);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int ks = kb; ks < ke; ++ks) {
      wg::mbar_wait(bars + 8 * stage, phase);
      const uint32_t sa = base + stage * STAGE + wi * WG_BOX;
      const uint32_t sb = base + stage * STAGE + WG_A;
      wg::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_ss<A::MN, B::MN>(acc, tile_desc<A::MN>(sa, kk),
                                   tile_desc<B::MN>(sb, kk), 1);
      wg::wg_commit();
      wg::wg_wait<1>();  // the stage before is read
      if (prev >= 0 && lane == 0)
        wg::mbar_arrive(bars + 8 * (WG_STAGES + prev));
      prev = stage;
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wg_wait<0>();
    wg::keep_regs(acc);
    if (prev >= 0 && lane == 0)
      wg::mbar_arrive(bars + 8 * (WG_STAGES + prev));
    // the accumulator: rows 16 (warp % 4) + g (+ 8), columns 8 j + 2 u, +1
    const int rl = 16 * (warp % 4) + g, m0 = mt * 128 + 64 * wi;
    if constexpr (tma_stored<E>()) {
      // this warpgroup's 64 x BN outputs as BN / 64 boxes of 64 x 64 in
      // the 128-byte swizzle of the output's map (16-byte chunk q of row r
      // at chunk q ^ (r % 8): a warp's 4-byte writes hit 32 banks), then
      // one thread stores them by TMA; the next tile's products overlap
      // the stores, and its epilogue waits until they have read the boxes
      const uint32_t out = base + WgPlan<BN>::OUT + wi * 64 * BN * 2;
      uint8_t* op = smem_raw + (out - wg::smem_addr(smem_raw));
      const bool leader = threadIdx.x % 128 == 0;
      if (leader) wg::bulk_wait_read<0>();
      warpgroup_sync(1 + wi);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = nt * BN + 8 * j + 2 * u;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          *reinterpret_cast<uint32_t*>(op + (j / 8) * WG_BOX + r * 128 +
                                       (((j % 8) ^ (r % 8)) << 4) + 4 * u) =
              wg::pack_bf16(e.value(zs, n, acc[4 * j + 2 * h]),
                            e.value(zs, n + 1, acc[4 * j + 2 * h + 1]));
        }
      }
      wg::fence_async_smem();
      warpgroup_sync(1 + wi);
      if (leader) {
        for (int i = 0; i < BN / 64; ++i)
          if (nt * BN + 64 * i < N)
            e.store(maps.c, zs, m0, nt * BN + 64 * i, out + i * WG_BOX);
        wg::bulk_commit();
      }
    } else if constexpr (E::kStaged) {
      constexpr int PITCH = WgPlan<BN>::PITCH;
      __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(
                              smem_raw + (base - wg::smem_addr(smem_raw)) +
                              WgPlan<BN>::EPI) +
                          wi * 64 * PITCH;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * u, n = nt * BN + c;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(ep + (rl + 8 * h) * PITCH + c) =
              wg::pack_bf16(e.value(zs, n, acc[4 * j + 2 * h]),
                            e.value(zs, n + 1, acc[4 * j + 2 * h + 1]));
      }
      warpgroup_sync(1 + wi);
      for (int i = threadIdx.x % 128; i < 64 * BN / 8; i += 128) {
        const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
        const int m = m0 + r, n = nt * BN + c;
        if (m >= M || n >= N) continue;
        __nv_bfloat16* dst = e.chunk(zs, m, n);
        if (dst != nullptr)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(ep + r * PITCH + c);
      }
      warpgroup_sync(1 + wi);  // the buffer is read before the next tile
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = nt * BN + 8 * j + 2 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m0 + rl + 8 * h < M && n < N)
            e.pair(zs, m0 + rl + 8 * h, n, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
      }
    }
  }
  // the last stores have read shared memory before the CTA leaves it
  if constexpr (tma_stored<E>())
    if (threadIdx.x % 128 == 0) wg::bulk_wait<0>();
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map of rank 2-4 whose boxes are 64 x 64 (x 1 x 1), 128-byte
// swizzled, out-of-range elements read as zero. dims innermost first;
// strides in elements of dims 1 .. rank - 1.
inline int encode(CUtensorMap* map, const void* p, int rank,
                  const uint64_t* dims, const uint64_t* strides) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gd[4], gs[3];
  const cuuint32_t box[4] = {64, 64, 1, 1}, es[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) gd[i] = dims[i];
  for (int i = 0; i + 1 < rank; ++i) gs[i] = strides[i] * 2;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(p), gd, gs, box,
                        es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// (B, rows, w): map (w, rows, B)
inline int encode_rows(CUtensorMap* map, const void* p, int batch, int rows,
                       int w) {
  const uint64_t dims[3] = {(uint64_t)w, (uint64_t)rows, (uint64_t)batch};
  const uint64_t strides[2] = {(uint64_t)w, (uint64_t)rows * w};
  return encode(map, p, 3, dims, strides);
}
// every other row of a (B, t_in, c) tensor: rows 2 t + first for t <
// rows, map (c, rows, B) from p + first * c with a row stride of 2 c
// (twice the inner extent, which TMA takes as a pitched row)
inline int encode_alternate_rows(CUtensorMap* map, const void* p, int batch,
                                 int t_in, int c, int first, int rows) {
  const uint64_t dims[3] = {(uint64_t)c, (uint64_t)rows, (uint64_t)batch};
  const uint64_t strides[2] = {2 * (uint64_t)c, (uint64_t)t_in * c};
  return encode(map, (const __nv_bfloat16*)p + (size_t)first * c, 3, dims,
                strides);
}
// tap `tap` of a stride-2, kernel-3 VALID conv's input (B, t_in, c): rows
// 2 t + tap for t < T_out = (t_in - 3) / 2 + 1
inline int encode_tap_rows(CUtensorMap* map, const void* p, int batch,
                           int t_in, int c, int tap) {
  return encode_alternate_rows(map, p, batch, t_in, c, tap,
                               (t_in - 3) / 2 + 1);
}
// head-major (B, H, rows_pad, dh): map (dh, rows_pad, H, B)
inline int encode_heads(CUtensorMap* map, const void* p, int batch, int heads,
                        int rows_pad, int dh) {
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)rows_pad, (uint64_t)heads,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)dh, (uint64_t)rows_pad * dh,
                               (uint64_t)heads * rows_pad * dh};
  return encode(map, p, 4, dims, strides);
}
// a row-major (outer, inner) matrix: map (inner, outer)
inline int encode_matrix(CUtensorMap* map, const void* p, int outer,
                         int inner) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)outer};
  const uint64_t strides[1] = {(uint64_t)inner};
  return encode(map, p, 2, dims, strides);
}

// Launches the product over Z batches of (M, N, nk 64-deep k stages),
// each split into S K slices, on a persistent grid of at most one CTA per
// SM, in 128 x 256 tiles where N is at least 256, else 128 x 128. Returns
// the launch's cudaError_t.
template <int BN, class A, class B, class E>
int wgmma_launch(const Maps& maps, const A& a, const B& b, const E& e, int M,
                 int N, int Z, int S, int nk, cudaStream_t stream) {
  // the SM count and the shared-memory opt-in are queried once per device
  // (the block's backward is host-bound: its host calls count)
  static int sms[64] = {0};
  static bool opted[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess && !opted[dev]) {
    err = cudaFuncSetAttribute(wgmma_gemm_kernel<BN, A, B, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgPlan<BN>::SMEM);
    opted[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)Z * S * ((M + 127) / 128) * ((N + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms[dev] ? tiles : sms[dev]);
  wgmma_gemm_kernel<BN, A, B, E>
      <<<grid, WG_THREADS, WgPlan<BN>::SMEM, stream>>>(maps, a, b, e, M, N,
                                                        Z, S, nk);
  return (int)cudaGetLastError();
}

template <class A, class B, class E>
int wgmma_gemm(const Maps& maps, const A& a, const B& b, const E& e, int M,
               int N, int Z, int S, int nk, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || Z <= 0 || S <= 0 || nk <= 0)
    return (int)cudaErrorInvalidValue;
  return N >= 256 ? wgmma_launch<256>(maps, a, b, e, M, N, Z, S, nk, stream)
                  : wgmma_launch<128>(maps, a, b, e, M, N, Z, S, nk, stream);
}

}  // namespace tmagemm
