// Fused hash dropout: y = keep ? x / (1 - rate) : 0, one pass.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/dropout_kernel.py:
// _dropout_kernel (driven by _run / fast_dropout). That kernel draws its
// keep mask from the TPU core's hardware PRNG (pltpu.prng_random_bits),
// a stream no GPU can reproduce. This kernel keeps its contract instead:
// keep probability 1 - rate, the scale fused into the same pass, and no
// stored mask, since the backward is this same kernel on dy with the same
// scalar seed. The mask is the JAX package's hash dropout
// (audio8_tpu/nn/dropout.py:_hash_keep_mask), so it is bit for bit the
// port's plain version and the JAX package's for one seed:
//
//     h = mix32((base + flat_index) mod 2^32 ^ seed); keep = h >= threshold
//
// base is the flat index of the first element: 0 for a whole tensor, and
// for a data-parallel rank's block of rows the global tensor's index of
// its first row (parallel/sharding.py), so every rank draws the global
// batch's mask. The sum wraps in uint32, as the plain version's int64
// sum masked to 32 bits.
//
// A piece of a larger tensor that is not one contiguous range of its flat
// index (a sequence-parallel rank's (B, T/tp, D) frames, a tensor-parallel
// rank's heads of (B, H, T, T) probabilities: parallel/tensor.py) is rows
// of row_len elements, each row_stride apart in the whole tensor: element
// i draws index base + (i / row_len) * row_stride + i % row_len, so the
// rank draws the whole tensor's mask there. row_len = n (or 0) is the
// contiguous case above.
//
// with threshold = min(rate * 2^32, 2^32 - 1) and the murmur finaliser
// mix32. The value divides by (1 - rate) in f32 (IEEE division, as the
// plain version's division by a 0-dim f32 tensor), then rounds once to
// the tensor's dtype.
//
// What bounds it on H100: memory, 8 bytes per f32 element (one read, one
// write; 4 for bf16) against about 12 integer operations for the hash.
// Each thread moves 16 bytes per step (4 f32 or 8 bf16 values) when the
// pointers are 16-byte aligned, in a grid-stride loop; otherwise one
// element per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

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

// The whole tensor's flat index of element i (mod 2^32).
struct Index {
  uint32_t base, row_stride;
  long long row_len;  // 0: contiguous
  __device__ __forceinline__ uint32_t operator()(long long i) const {
    return row_len == 0 ? base + (uint32_t)i
                        : base + (uint32_t)(i / row_len) * row_stride +
                              (uint32_t)(i % row_len);
  }
};

template <typename T>
__device__ __forceinline__ T drop(T v, long long i, const Index& index,
                                  uint32_t seed, uint32_t threshold,
                                  float den) {
  const bool keep = mix32(index(i) ^ seed) >= threshold;
  return keep ? from_f32<T>(__fdiv_rn(to_f32(v), den)) : from_f32<T>(0.f);
}

// V elements of T per 16-byte vector
template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long n, Index index, uint32_t seed,
                       uint32_t threshold, float den) {
  constexpr int V = 16 / sizeof(T);
  const long long n_vec = n / V;
  const long long stride = (long long)gridDim.x * NT;
  for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < n_vec;
       v += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[v];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j)
      e[j] = drop(e[j], v * V + j, index, seed, threshold, den);
    reinterpret_cast<uint4*>(y)[v] = raw;
  }
  // the ragged tail of fewer than V elements
  for (long long i = n_vec * V + (long long)blockIdx.x * NT + threadIdx.x;
       i < n; i += stride)
    y[i] = drop(x[i], i, index, seed, threshold, den);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   Index index, uint32_t seed, uint32_t threshold,
                   float den) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    y[i] = drop(x[i], i, index, seed, threshold, den);
}

template <typename T>
int launch(const void* x, void* y, long long n, Index index,
           uint32_t seed, uint32_t threshold, float den, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (((uintptr_t)x | (uintptr_t)y) % 16) == 0;
  const long long items = vec ? n / V + 1 : n;
  long long blocks = (items + NT - 1) / NT;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond that
  if (vec)
    dropout_vec_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (T*)y, n, index, seed, threshold, den);
  else
    dropout_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (T*)y, n, index, seed, threshold, den);
  return (int)cudaGetLastError();
}

}  // namespace

// y = keep ? x / den : 0 over n contiguous elements, keep =
// mix32(index(i) ^ seed) >= threshold with index(i) = base + i, or with
// row_len > 0 base + (i / row_len) * row_stride + i % row_len (all mod
// 2^32); x and y do not overlap.
// dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int a8t_dropout(const void* x, void* y, long long n, uint32_t seed,
                           uint32_t base, long long row_len,
                           uint32_t row_stride, uint32_t threshold, float den,
                           int dtype, void* stream) {
  if (n < 0 || row_len < 0 || !(den > 0.f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Index index{base, row_stride, row_len >= n ? 0 : row_len};
  if (dtype == 0)
    return launch<float>(x, y, n, index, seed, threshold, den, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, n, index, seed, threshold, den, s);
  return (int)cudaErrorInvalidValue;
}
