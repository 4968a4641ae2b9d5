// Nearest-center pixel grouping for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel empanada_tpu/ops/pallas_group.py (_kernel /
// group_pixels_pallas, the only Pallas kernel of the JAX package).
//
// For every pixel (i, j) of slice b: loc = (i*step + dy, j*step + dx);
// the result is 1 + the index of the center k minimizing
//   d_k = (loc_y - step*cy_k)^2 + (loc_x - step*cx_k)^2   (valid k)
//   d_k = 1e10                                              (invalid k)
// with argmin's rule: the first NaN wins, else the first minimum (strict
// <); a slice with no valid center gives 0 everywhere. Any K >= 1.
//
// Exact rounding: every product and sum of a distance is an explicitly
// rounded intrinsic (__fsub_rn / __fmul_rn / __fadd_rn), so nvcc cannot
// contract dy*dy + dx*dx into an FMA; d_k rounds exactly like the plain
// PyTorch version (two products, then a sum), and the ids are identical,
// near-ties included.
//
// Design: one thread block per (tile of 8 x 32 pixels, slice), 128
// threads, 2 pixels a thread (one column, rows r and r + 4), offsets read
// as coalesced float2 loads. A pixel's nearest center lies near it, so
// the block first prunes the table for its tile:
//   1. box: block min/max of loc_y and loc_x over the tile's pixels;
//   2. pass 1 over the table: for each valid center, UB_k = squared
//      distance to the box's farthest corner, rounded up; U = min_k UB_k;
//   3. pass 2: keep center k iff LB_k <= T, where LB_k = squared distance
//      from the center to the box, rounded down, and
//      T = U * (1 + 2^-18) + 2^-126, rounded up. The kept centers are
//      compacted in index order (warp ballot + prefix sum) into a shared
//      list of (step*cy, step*cx, k);
//   4. scan: each thread runs the exactly rounded distance with strict <
//      over the list only.
// The kernel is latency-bound at these sizes (a few dependent steps per
// block), so the first 512 table slots are loaded into registers with
// the offsets (one memory round trip), the flags ride in the two
// block-wide min reductions, and pass 2 takes one barrier a round.
//
// Why the ids are exact. Let c* be the center whose UB is U. For a pixel
// p of the tile, the computed distance d(p, c) of the scan is the real
// distance D(p, c) of the same f32 operands to within a relative
// (1 +- u)^4, u = 2^-24 (three rounded steps on each axis's path), plus
// at most 2 * 2^-150 absolute from a product that underflows (sums and
// differences of floats are exact in the subnormal range). So
//   d(p, c*) <= U (1+u)^4 + 2^-148
//   d(p, c)  >= D(p, c) (1-u)^4 - 2^-148 >= LB_c (1-u)^4 - 2^-148.
// A pruned center has LB_c > T >= U (1 + 2^-18) + 2^-126. Since
// (1+u)^4 / (1-u)^4 is about 1 + 2^-21 (the margin 2^-18 is 8x that) and
// 2^-126 >> 2^-146, it computes strictly larger than c* at every pixel of
// the tile: it can neither win nor tie. The list keeps index order, so
// the first minimum among the kept centers is argmin's. Invalid centers
// (1e10) are never listed, which is exact only if every pixel's best
// valid distance is below 1e10: guaranteed when T < 1e10, since then
// d(p, c*) < T.
//
// Exhaustive path, inside the kernel: a tile scans the whole table
// (chunks of it staged in the shared list), invalid slots as 1e10 and
// with the NaN rule, when its box is not finite (a NaN or inf offset), a
// valid center is not finite, T >= 1e10 (a valid distance could reach
// 1e10, so an invalid slot could win, e.g. 1e6 offsets), or the kept list
// would overflow its 1024 entries.
//
// Bound: at the main path's shapes (B=8, 128x128 grid, K=256) the bytes
// are ~1.6 MB (offsets 1 MB, ids 0.5 MB, tables 24 KB); the scan's ~7
// rounded f32 instructions per pixel-center pair (no FMA) execute at
// ~33.5 T/s, and pruning cuts the pairs to what each tile needs (the
// optional stats counters report them). No tensor cores: |p|^2 - 2 p.c +
// |c|^2 in TF32 or bf16 would round differently from dy^2 + dx^2 and
// change ids on near-ties. Times are in PERF.md.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;                 // one warp across a tile row
constexpr int kTileH = 8;
constexpr int kRows = 2;                   // pixels a thread
constexpr int kWarps = kTileH / kRows;     // 4
constexpr int kThreads = kWarps * 32;      // 128
constexpr int kHeld = 4;                   // table slots a thread holds
constexpr int kHeldChunk = kHeld * kThreads;
constexpr int kListCap = 1024;             // shared candidate list entries
constexpr float kBig = 1e10f;
constexpr float kRelMargin = 0x1p-18f;     // epsilon of the pruning test
constexpr float kAbsMargin = 0x1p-126f;    // tau: covers underflow

struct __align__(16) Entry {
  float cy, cx;
  int k;
  int valid;
};

__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) <= FLT_MAX;  // false for inf and NaN
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, s));
  }
  return v;
}

// Block-wide minimum of N values a thread; s_red holds N * kWarps floats
// and is not reused by the caller.
template <int N>
__device__ __forceinline__ void block_min(float (&v)[N], float* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    v[n] = warp_min(v[n]);
    if (lane == 0) s_red[n * kWarps + warp] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float m = s_red[n * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fminf(m, s_red[n * kWarps + w]);
    v[n] = m;
  }
}

// Table slot k: its center times step (exactly as the plain version
// rounds it) and whether it is valid; slots past K are invalid.
__device__ __forceinline__ void load_slot(const int32_t* cb,
                                          const uint8_t* vb, int K, int k,
                                          float step, float& cy, float& cx,
                                          bool& v) {
  v = false;
  cy = cx = 0.f;
  if (k < K) {
    v = vb[k] != 0;
    cy = __fmul_rn((float)cb[2 * k], step);
    cx = __fmul_rn((float)cb[2 * k + 1], step);
  }
}

struct Box {
  float ymin, ymax, xmin, xmax;
};

// LB: squared distance from (cy, cx) to the box, rounded down.
__device__ __forceinline__ float lower_bound(const Box& b, float cy,
                                             float cx) {
  const float gy = fmaxf(fmaxf(__fsub_rd(b.ymin, cy), __fsub_rd(cy, b.ymax)),
                         0.f);
  const float gx = fmaxf(fmaxf(__fsub_rd(b.xmin, cx), __fsub_rd(cx, b.xmax)),
                         0.f);
  return __fadd_rd(__fmul_rd(gy, gy), __fmul_rd(gx, gx));
}

// UB: squared distance from (cy, cx) to the farthest corner, rounded up.
__device__ __forceinline__ float upper_bound(const Box& b, float cy,
                                             float cx) {
  const float hy = fmaxf(__fsub_ru(b.ymax, cy), __fsub_ru(cy, b.ymin));
  const float hx = fmaxf(__fsub_ru(b.xmax, cx), __fsub_ru(cx, b.xmin));
  return __fadd_ru(__fmul_ru(hy, hy), __fmul_ru(hx, hx));
}

__device__ __forceinline__ float dist2(float ly, float lx, float cy,
                                       float cx) {
  const float dy = __fsub_rn(ly, cy);
  const float dx = __fsub_rn(lx, cx);
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
}

__global__ void __launch_bounds__(kThreads, 8)
group_pixels_kernel(const int32_t* __restrict__ centers,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ offsets,
                    int32_t* __restrict__ out, int K, int H, int W,
                    float step, int tiles_x,
                    unsigned long long* __restrict__ stats) {
  __shared__ Entry s_list[kListCap];
  __shared__ float s_box[5 * kWarps];
  __shared__ float s_pass1[3 * kWarps];
  __shared__ int s_count[2][kWarps];

  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x;
  const int tx = blockIdx.x - ty * tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = tx * kTileW + lane;
  const int32_t* cb = centers + (size_t)b * K * 2;
  const uint8_t* vb = valid + (size_t)b * K;
  const float inf = __int_as_float(0x7f800000);

  // the first kHeldChunk table slots stay in registers for both passes;
  // their loads are in flight with the offsets'
  float hcy[kHeld], hcx[kHeld];
  bool hv[kHeld];
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    load_slot(cb, vb, K, r * kThreads + threadIdx.x, step, hcy[r], hcx[r],
              hv[r]);
  }

  // 1. this thread's pixels and the tile's box: min of y, x, -y, -x and
  // -1 if a loc is not finite
  float ly[kRows], lx[kRows];
  bool inside[kRows];
  float red_box[5] = {inf, inf, inf, inf, 0.f};
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = ty * kTileH + warp + q * kWarps;
    inside[q] = i < H && j < W;
    ly[q] = 0.f;
    lx[q] = 0.f;
    if (inside[q]) {
      const float2 o = *reinterpret_cast<const float2*>(
          offsets + (((size_t)b * H + i) * W + j) * 2);
      ly[q] = __fadd_rn(__fmul_rn((float)i, step), o.x);
      lx[q] = __fadd_rn(__fmul_rn((float)j, step), o.y);
      if (is_finite(ly[q]) && is_finite(lx[q])) {
        red_box[0] = fminf(red_box[0], ly[q]);
        red_box[1] = fminf(red_box[1], lx[q]);
        red_box[2] = fminf(red_box[2], -ly[q]);
        red_box[3] = fminf(red_box[3], -lx[q]);
      } else {
        red_box[4] = -1.f;
      }
    }
  }
  block_min(red_box, s_box);
  const Box box{red_box[0], -red_box[2], red_box[1], -red_box[3]};

  // 2. pass 1: U = min over valid k of UB_k; -1 if any center is valid;
  // -1 if a valid center is not finite. LB_k of the held slots is kept.
  float red[3] = {inf, 0.f, 0.f};
  float hlb[kHeld];
#pragma unroll
  for (int r = 0; r < kHeld; ++r) hlb[r] = inf;
  for (int base = 0; base < K; base += kHeldChunk) {
#pragma unroll
    for (int r = 0; r < kHeld; ++r) {
      float cy = hcy[r], cx = hcx[r];
      bool v = hv[r];
      if (base > 0) {
        load_slot(cb, vb, K, base + r * kThreads + threadIdx.x, step, cy, cx,
                  v);
      }
      if (!v) continue;
      red[1] = -1.f;
      if (!(is_finite(cy) && is_finite(cx))) red[2] = -1.f;
      red[0] = fminf(red[0], upper_bound(box, cy, cx));
      if (base == 0) hlb[r] = lower_bound(box, cy, cx);
    }
  }
  block_min(red, s_pass1);
  if (red[1] == 0.f) {  // no valid center: 0 everywhere
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = ty * kTileH + warp + q * kWarps;
      if (inside[q]) out[((size_t)b * H + i) * W + j] = 0;
    }
    if (stats != nullptr && threadIdx.x == 0) atomicAdd(&stats[2], 1ull);
    return;
  }
  const float thr = __fadd_ru(__fmul_ru(red[0], 1.0f + kRelMargin),
                              kAbsMargin);
  bool exhaustive = red_box[4] < 0.f || red[2] < 0.f || !(thr < kBig);

  // 3. pass 2: keep the centers with LB_k <= thr, compacted in index
  // order; one barrier a round (the counts are double-buffered)
  int n = 0;
  if (!exhaustive) {
    int round = 0;
    for (int base = 0; base < K && n <= kListCap; base += kHeldChunk) {
#pragma unroll
      for (int r = 0; r < kHeld; ++r) {
        if (base + r * kThreads >= K) break;
        const int k = base + r * kThreads + threadIdx.x;
        float cy = hcy[r], cx = hcx[r];
        bool keep;
        if (base == 0) {
          keep = hlb[r] <= thr;
        } else {
          bool v;
          load_slot(cb, vb, K, k, step, cy, cx, v);
          keep = v && lower_bound(box, cy, cx) <= thr;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        int* count = s_count[round++ & 1];
        if (lane == 0) count[warp] = __popc(mask);
        __syncthreads();
        int pos = n + __popc(mask & ((1u << lane) - 1u));
        int total = n;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int c = count[w];
          pos += w < warp ? c : 0;
          total += c;
        }
        if (keep && pos < kListCap) s_list[pos] = Entry{cy, cx, k, 1};
        n = total;
      }
    }
    __syncthreads();  // the list is complete
    exhaustive = n > kListCap;
  }

  float best_d[kRows];
  int best_k[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    best_d[q] = inf;
    best_k[q] = 0;
  }
  if (!exhaustive) {
    // 4. exact scan over the kept centers: all distances are finite here
#pragma unroll 2
    for (int e = 0; e < n; ++e) {
      const Entry c = s_list[e];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float d = dist2(ly[q], lx[q], c.cy, c.cx);
        if (d < best_d[q]) {
          best_d[q] = d;
          best_k[q] = c.k;
        }
      }
    }
  } else {
    // 5. exhaustive scan over the whole table, chunk by chunk
    for (int base = 0; base < K; base += kListCap) {
      const int len = min(kListCap, K - base);
      __syncthreads();  // the previous chunk has been read
      for (int t = threadIdx.x; t < len; t += kThreads) {
        Entry& e = s_list[t];
        bool v;
        load_slot(cb, vb, K, base + t, step, e.cy, e.cx, v);
        e.k = base + t;
        e.valid = v;
      }
      __syncthreads();
      for (int e = 0; e < len; ++e) {
        const Entry c = s_list[e];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float d = c.valid ? dist2(ly[q], lx[q], c.cy, c.cx) : kBig;
          // argmin: the first NaN wins; else strictly smaller wins
          if (d < best_d[q] || (d != d && best_d[q] == best_d[q])) {
            best_d[q] = d;
            best_k[q] = c.k;
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = ty * kTileH + warp + q * kWarps;
    if (inside[q]) out[((size_t)b * H + i) * W + j] = best_k[q] + 1;
  }
  if (stats != nullptr && threadIdx.x == 0) {
    const unsigned long long pixels =
        (unsigned long long)min(kTileH, H - ty * kTileH) *
        min(kTileW, W - tx * kTileW);
    atomicAdd(&stats[exhaustive ? 1 : 0], 1ull);
    atomicAdd(&stats[exhaustive ? 4 : 3], pixels * (exhaustive ? K : n));
  }
}

}  // namespace

// stats, if not null, points to 5 int64 counters that the launch adds to:
// pruned tiles, exhaustive tiles, tiles of slices without a valid center,
// pixel-center pairs scanned by pruned tiles and by exhaustive tiles.
extern "C" int etorch_group_pixels(const void* centers, const void* valid,
                                   const void* offsets, void* out, int B,
                                   int K, int H, int W, float step,
                                   void* stats, void* stream) {
  if (K < 1 || B < 1 || B > 65535 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, B);
  group_pixels_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)centers, (const uint8_t*)valid, (const float*)offsets,
      (int32_t*)out, K, H, W, step, tiles_x, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}
