// AdamW update, in place, over every parameter leaf in one launch.
//
// Replaces the TPU kernel audio8_tpu/ops/pallas/adamw_kernel.py:
// _adamw_kernel (driven per leaf by _leaf_update from FusedAdamW.apply).
// Same function, with optax.adamw semantics:
//
//   g = grad * gscale            (1/examples times the clip factor)
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p - lr * ((m * inv_bc1) / (sqrt(v * inv_bc2) + eps) + wd * p)
//
// with lr taken from the schedule at the pre-increment step count and the
// bias corrections inv_bc = 1 / (1 - b^count) at the post-increment count:
// one global count for every leaf, as optax keeps it. gscale is read from
// device memory, so the clip factor computed on the card never makes a
// round trip through the host.
//
// What bounds it on H100: bytes. Each element reads g, m, v, p and writes
// m, v, p: 28 bytes, about 2.6 GB for wav2vec2-base's 94.4 M parameters.
// The TPU kernel paid one launch per leaf (about 200); here one launch
// covers all of them: a device table holds each leaf's four pointers, its
// size and the index of its first block, each block finds its leaf by
// binary search and updates one chunk with coalesced loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int64_t CHUNK = 16384;  // elements per block
constexpr int FIELDS = 6;         // p, g, m, v, n, first block

__global__ void __launch_bounds__(NT)
    adamw_kernel(const int64_t* __restrict__ table, int n_leaves, float lr,
                 float b1, float b2, float eps, float wd, float inv_bc1,
                 float inv_bc2, const float* __restrict__ gscale_p) {
  const int64_t bid = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[(size_t)mid * FIELDS + 5] <= bid)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t* e = table + (size_t)lo * FIELDS;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* m = reinterpret_cast<float*>(e[2]);
  float* v = reinterpret_cast<float*>(e[3]);
  const int64_t n = e[4];
  const int64_t start = (bid - e[5]) * CHUNK;
  const int64_t end = start + CHUNK < n ? start + CHUNK : n;
  const float gscale = *gscale_p;
  const float c1 = 1.f - b1, c2 = 1.f - b2;
  for (int64_t i = start + threadIdx.x; i < end; i += NT) {
    const float gi = g[i] * gscale;
    const float mi = b1 * m[i] + c1 * gi;
    const float vi = b2 * v[i] + c2 * gi * gi;
    const float pi = p[i];
    const float upd = (mi * inv_bc1) / (sqrtf(vi * inv_bc2) + eps) + wd * pi;
    m[i] = mi;
    v[i] = vi;
    p[i] = pi - lr * upd;
  }
}

}  // namespace

// table: (n_leaves, 6) int64 on the device: p, g, m, v pointers (f32,
// contiguous), element count, index of the leaf's first block (ascending,
// chunks of 16384 elements); n_blocks: the total block count. gscale: one
// f32 on the device. Returns the cudaError_t of the launch.
extern "C" int a8t_adamw(const void* table, int n_leaves, int n_blocks,
                         float lr, float b1, float b2, float eps, float wd,
                         float inv_bc1, float inv_bc2, const void* gscale,
                         void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  adamw_kernel<<<n_blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, n_leaves, lr, b1, b2, eps, wd, inv_bc1, inv_bc2,
      (const float*)gscale);
  return (int)cudaGetLastError();
}
