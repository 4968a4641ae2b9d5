// Nearest-center pixel grouping for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel empanada_tpu/ops/pallas_group.py (_kernel /
// group_pixels_pallas, the only Pallas kernel of the JAX package).
//
// For every pixel (i, j) of slice b: loc = (i*step + dy, j*step + dx);
// the result is 1 + the index of the center k minimizing
//   d_k = (loc_y - step*cy_k)^2 + (loc_x - step*cx_k)^2   (valid k)
//   d_k = 1e10                                              (invalid k)
// with ties going to the lowest k (strict <), i.e. argmin's first
// minimum; a slice with no valid center gives 0 everywhere.
//
// Exactness: every product and sum is an explicitly rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc cannot contract
// dy*dy + dx*dx into an FMA; the result rounds exactly like the plain
// PyTorch version, which forms dy*dy and dx*dx as separate tensors and
// then adds them. Integer ids are therefore identical, near-ties
// included.
//
// Design (first, simple version): one thread per pixel, grid
// (ceil(H*W / 256), B) so one launch covers a whole block of B slices.
// Each thread block stages its slice's K-entry table (step*cy, step*cx,
// valid) in shared memory (K <= 1024, 9 bytes a center) and every
// thread runs the K loop with a running (best_d, best_k).
//
// Bound at the main path's shapes (B=8, 128x128 grid, K=256): 131,072
// pixels x 256 centers x ~7 f32 operations = 0.24 GFLOP, no tensor
// cores, against ~1.6 MB of traffic (offsets 1 MB, ids 0.5 MB, tables
// 24 KB): bound by operations, not bytes; launch overhead dominates at
// this size. Times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCenters = 1024;

__global__ void group_pixels_kernel(const int32_t* __restrict__ centers,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ offsets,
                                    int32_t* __restrict__ out,
                                    int K, int H, int W, float step) {
  __shared__ float s_cy[kMaxCenters];
  __shared__ float s_cx[kMaxCenters];
  __shared__ uint8_t s_valid[kMaxCenters];
  __shared__ int s_any;

  const int b = blockIdx.y;
  const int hw = H * W;
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int32_t* c = centers + ((size_t)b * K + k) * 2;
    s_cy[k] = __fmul_rn((float)c[0], step);
    s_cx[k] = __fmul_rn((float)c[1], step);
    const uint8_t v = valid[(size_t)b * K + k] != 0;
    s_valid[k] = v;
    if (v) s_any = 1;
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  int32_t* dst = out + (size_t)b * hw + p;
  if (!s_any) {
    *dst = 0;
    return;
  }
  const int i = p / W;
  const int j = p - i * W;
  const float* off = offsets + ((size_t)b * hw + p) * 2;
  const float ly = __fadd_rn(__fmul_rn((float)i, step), off[0]);
  const float lx = __fadd_rn(__fmul_rn((float)j, step), off[1]);

  float best_d = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int k = 0; k < K; ++k) {
    float d;
    if (s_valid[k]) {
      const float dy = __fsub_rn(ly, s_cy[k]);
      const float dx = __fsub_rn(lx, s_cx[k]);
      d = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
    } else {
      d = 1e10f;
    }
    if (d < best_d) {
      best_d = d;
      best_k = k;
    }
  }
  *dst = best_k + 1;
}

}  // namespace

extern "C" int etorch_group_pixels(const void* centers, const void* valid,
                                   const void* offsets, void* out, int B,
                                   int K, int H, int W, float step,
                                   void* stream) {
  if (K < 1 || K > kMaxCenters || B < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int hw = H * W;
  dim3 grid((hw + kThreads - 1) / kThreads, B);
  group_pixels_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)centers, (const uint8_t*)valid, (const float*)offsets,
      (int32_t*)out, K, H, W, step);
  return (int)cudaGetLastError();
}
