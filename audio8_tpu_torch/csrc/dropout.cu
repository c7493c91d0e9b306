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

template <typename T>
__device__ __forceinline__ T drop(T v, long long i, uint32_t base,
                                  uint32_t seed, uint32_t threshold,
                                  float den) {
  const bool keep = mix32((base + (uint32_t)i) ^ seed) >= threshold;
  return keep ? from_f32<T>(__fdiv_rn(to_f32(v), den)) : from_f32<T>(0.f);
}

// V elements of T per 16-byte vector
template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long n, uint32_t base, uint32_t seed,
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
      e[j] = drop(e[j], v * V + j, base, seed, threshold, den);
    reinterpret_cast<uint4*>(y)[v] = raw;
  }
  // the ragged tail of fewer than V elements
  for (long long i = n_vec * V + (long long)blockIdx.x * NT + threadIdx.x;
       i < n; i += stride)
    y[i] = drop(x[i], i, base, seed, threshold, den);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t base, uint32_t seed, uint32_t threshold,
                   float den) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    y[i] = drop(x[i], i, base, seed, threshold, den);
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t base,
           uint32_t seed, uint32_t threshold, float den, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (((uintptr_t)x | (uintptr_t)y) % 16) == 0;
  const long long items = vec ? n / V + 1 : n;
  long long blocks = (items + NT - 1) / NT;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond that
  if (vec)
    dropout_vec_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (T*)y, n, base, seed, threshold, den);
  else
    dropout_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (T*)y, n, base, seed, threshold, den);
  return (int)cudaGetLastError();
}

}  // namespace

// y = keep ? x / den : 0 over n contiguous elements, keep =
// mix32((base + i) mod 2^32 ^ seed) >= threshold; x and y do not overlap.
// dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int a8t_dropout(const void* x, void* y, long long n, uint32_t seed,
                           uint32_t base, uint32_t threshold, float den,
                           int dtype, void* stream) {
  if (n < 0 || !(den > 0.f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, y, n, base, seed, threshold, den, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, n, base, seed, threshold, den, s);
  return (int)cudaErrorInvalidValue;
}
