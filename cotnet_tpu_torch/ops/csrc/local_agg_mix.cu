// Dual-kernel ("mix") local aggregation for Hopper, sm_90a: the 3x3 and the
// 5x5 aggregation of one input, each SAME zero-padded at stride 1, in one
// launch per pass.
//
//   out[n, (half*heads + head)*C + c, h, w] =
//       sum_{i, j < K} w_half[n, head, c % Cw, i*K + j, h, w]
//                      * x[n, c, h - p + i, w - p + j]
//   with half 0 the 3x3 (K = 3, p = 1) and half 1 the 5x5 (K = 5, p = 2):
//   the output is kernel-major [half, head, c], the reference's layout.
//   x outside the image reads as zero (a bounds check, no padded copy).
//
// Three kernels, built by ops/_build.py with nvcc into the package's
// git-ignored _build/ at their first launch:
//
//   local_agg_mix_fwd: the forward above.  One thread per x element
//     (n, c, h, w) reads x's 5x5 neighbourhood once into registers and
//     writes all 2*heads outputs of that element: x is read once for both
//     kernels, the point of the fused op.
//   local_agg_mix_dx, in gather form:
//     dx[n, c, i, j] = sum_half sum_head sum_taps
//         dy[n, (half*heads + head)*C + c, i - kh + p, j - kw + p]
//         * w_half[n, head, c % Cw, kh*K + kw, i - kh + p, j - kw + p]
//     with both halves in one f32 accumulator, rounded once.
//   local_agg_mix_dw:
//     dw_half[n, head, cw, kh*K + kw, h, w] = sum_{g < C/Cw}
//         x[n, g*Cw + cw, h + kh - p, w + kw - p]
//         * dy[n, (half*heads + head)*C + g*Cw + cw, h, w]
//     one thread per element of dw1 and dw2 together; g is summed in
//     registers in order.
//
// Each weight (and its gradient) is a base pointer plus its taps per
// (n, head, cw) row: 9 for w1 and 25 for w2 when they are separate tensors,
// 34 for both when they are the two halves of the merged weight
// [N, heads, Cw, 9 + 25, H, W] (w2 then starts 9 planes after w1), so the
// merged op reads and writes its one buffer and copies nothing.
//
// Replaces, in cotnet_tpu/ops/local_agg_pallas.py, _mix_fwd_kernel,
// _mix_dx_kernel and _mix_dw_kernel (agg_core_pallas_mix).  Their padded
// VMEM scratch and whole-image blocks exist for the TPU; here the pad is a
// bounds check and every output has one owning thread: no atomics, and the
// result is deterministic.
//
// Arithmetic follows the TPU kernels: every operand widens to f32, products
// and sums are f32, each output is rounded once.
//
// Bound on this card: about one flop per byte (1.75 GFLOP against 373 MB
// at 56x56 C=64 bs128 bf16), so the least time is the bytes over the HBM
// rate; each pass touches x, w1, w2 and dy/out once.  Left for later:
// shared-memory halo tiles of x and dy reused across taps and channel
// groups, 16-byte loads, TMA.

#include "common.cuh"

namespace {

constexpr int kK1 = 3, kK2 = 5;
constexpr int kTaps1 = kK1 * kK1, kTaps2 = kK2 * kK2;

// x, dx [N, C, H, W]; out, dy [N, 2*heads*C, H, W]; w1/dw1 rows of rows1
// taps and w2/dw2 rows of rows2 taps, [N, heads, Cw, rows, H, W].
struct MixGeometry {
  int n, c, h, w, heads, cw, rows1, rows2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_mix_fwd(const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ w2, T* __restrict__ out,
                      MixGeometry g) {
  const int64_t total = int64_t(g.n) * g.c * g.h * g.w;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = int(idx % g.w);
  int64_t r = idx / g.w;
  const int row = int(r % g.h);
  r /= g.h;
  const int c = int(r % g.c);
  const int n = int(r / g.c);

  const int64_t plane = int64_t(g.h) * g.w;
  const T* xp = x + (int64_t(n) * g.c + c) * plane;
  float xv[kTaps2];
#pragma unroll
  for (int i = 0; i < kK2; ++i) {
    const int hh = row - 2 + i;
#pragma unroll
    for (int j = 0; j < kK2; ++j) {
      const int ww = col - 2 + j;
      xv[i * kK2 + j] = (hh >= 0 && hh < g.h && ww >= 0 && ww < g.w)
                            ? to_f32(xp[int64_t(hh) * g.w + ww])
                            : 0.f;
    }
  }
  const int64_t at = int64_t(row) * g.w + col;
  for (int head = 0; head < g.heads; ++head) {
    const int64_t wrow = (int64_t(n) * g.heads + head) * g.cw + c % g.cw;
    // the 3x3's tap (i, j) is the 5x5 window's (i + 1, j + 1)
    const T* wp = w1 + wrow * g.rows1 * plane + at;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kK1; ++i) {
#pragma unroll
      for (int j = 0; j < kK1; ++j) {
        acc += xv[(i + 1) * kK2 + j + 1] * to_f32(wp[(i * kK1 + j) * plane]);
      }
    }
    out[((int64_t(n) * 2 * g.heads + head) * g.c + c) * plane + at] =
        from_f32<T>(acc);
    wp = w2 + wrow * g.rows2 * plane + at;
    acc = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps2; ++k) acc += xv[k] * to_f32(wp[k * plane]);
    out[((int64_t(n) * 2 * g.heads + g.heads + head) * g.c + c) * plane +
        at] = from_f32<T>(acc);
  }
}

// One half's terms of dx at (row, col), added to acc: the outputs whose
// K x K window (pad K/2) holds (row, col), over every head.
template <typename T, int K>
__device__ __forceinline__ float dx_half(const T* __restrict__ w,
                                         const T* __restrict__ dy,
                                         const MixGeometry& g, int rows,
                                         int half, int n, int c, int row,
                                         int col, float acc) {
  constexpr int p = K / 2;
  const int64_t plane = int64_t(g.h) * g.w;
  for (int head = 0; head < g.heads; ++head) {
    const T* dyp =
        dy + ((int64_t(n) * 2 * g.heads + half * g.heads + head) * g.c + c) *
                 plane;
    const T* wp =
        w + ((int64_t(n) * g.heads + head) * g.cw + c % g.cw) * rows * plane;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int ho = row + p - i;
      if (ho < 0 || ho >= g.h) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int wo = col + p - j;
        if (wo < 0 || wo >= g.w) continue;
        const int64_t at = int64_t(ho) * g.w + wo;
        acc += to_f32(dyp[at]) * to_f32(wp[(i * K + j) * plane + at]);
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_mix_dx(const T* __restrict__ w1, const T* __restrict__ w2,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     MixGeometry g) {
  const int64_t total = int64_t(g.n) * g.c * g.h * g.w;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = int(idx % g.w);
  int64_t r = idx / g.w;
  const int row = int(r % g.h);
  r /= g.h;
  const int c = int(r % g.c);
  const int n = int(r / g.c);
  float acc = dx_half<T, kK1>(w1, dy, g, g.rows1, 0, n, c, row, col, 0.f);
  acc = dx_half<T, kK2>(w2, dy, g, g.rows2, 1, n, c, row, col, acc);
  dx[idx] = from_f32<T>(acc);
}

// One thread per element of dw1 and dw2, indexed as one tensor
// [N, heads, Cw, 9 + 25, H, W]: tap k < 9 is dw1's, the rest dw2's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_mix_dw(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dw1, T* __restrict__ dw2,
                     MixGeometry g) {
  const int64_t plane = int64_t(g.h) * g.w;
  const int64_t total =
      int64_t(g.n) * g.heads * g.cw * (kTaps1 + kTaps2) * plane;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = int(idx % g.w);
  int64_t r = idx / g.w;
  const int row = int(r % g.h);
  r /= g.h;
  const int k = int(r % (kTaps1 + kTaps2));
  r /= kTaps1 + kTaps2;
  const int cw = int(r % g.cw);
  r /= g.cw;
  const int head = int(r % g.heads);
  const int n = int(r / g.heads);

  const int half = k >= kTaps1;
  const int kk = half ? kK2 : kK1;
  const int tap = half ? k - kTaps1 : k;
  const int hh = row - kk / 2 + tap / kk;
  const int ww = col - kk / 2 + tap % kk;
  float acc = 0.f;
  if (hh >= 0 && hh < g.h && ww >= 0 && ww < g.w) {
    // channel cw of group 0; the groups are Cw channels apart
    const T* xp = x + (int64_t(n) * g.c + cw) * plane + int64_t(hh) * g.w + ww;
    const T* dyp =
        dy +
        ((int64_t(n) * 2 * g.heads + half * g.heads + head) * g.c + cw) *
            plane +
        int64_t(row) * g.w + col;
    const int groups = g.c / g.cw;
    const int64_t step = int64_t(g.cw) * plane;
    for (int grp = 0; grp < groups; ++grp) {
      acc += to_f32(xp[grp * step]) * to_f32(dyp[grp * step]);
    }
  }
  const int rows = half ? g.rows2 : g.rows1;
  T* out = half ? dw2 : dw1;
  out[(((int64_t(n) * g.heads + head) * g.cw + cw) * rows + tap) * plane +
      int64_t(row) * g.w + col] = from_f32<T>(acc);
}

template <typename T>
int launch_fwd(const void* x, const void* w1, const void* w2, void* out,
               const MixGeometry& g, cudaStream_t stream) {
  const int64_t total = int64_t(g.n) * g.c * g.h * g.w;
  if (total == 0) return int(cudaSuccess);
  unsigned blocks;
  if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
  local_agg_mix_fwd<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w1, const void* w2, const void* dy,
               void* dx, void* dw1, void* dw2, const MixGeometry& g,
               cudaStream_t stream) {
  if (dx != nullptr) {
    const int64_t total = int64_t(g.n) * g.c * g.h * g.w;
    unsigned blocks;
    if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
    if (total > 0) {
      local_agg_mix_dx<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(w1), static_cast<const T*>(w2),
          static_cast<const T*>(dy), static_cast<T*>(dx), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  if (dw1 != nullptr) {
    const int64_t total = int64_t(g.n) * g.heads * g.cw *
                          (kTaps1 + kTaps2) * g.h * g.w;
    unsigned blocks;
    if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
    if (total > 0) {
      local_agg_mix_dw<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dw1), static_cast<T*>(dw2), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  return int(cudaSuccess);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  rows1 / rows2: the taps per
// (n, head, cw) row of w1 / w2 (9 / 25, or 34 each in the merged weight).
// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int local_agg_mix_fwd_launch(int dtype, const void* x,
                                        const void* w1, int rows1,
                                        const void* w2, int rows2, void* out,
                                        int n, int c, int h, int w, int heads,
                                        int cw, void* stream) {
  const MixGeometry g{n, c, h, w, heads, cw, rows1, rows2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(x, w1, w2, out, g, st);
    case 1:
      return launch_fwd<__half>(x, w1, w2, out, g, st);
    case 2:
      return launch_fwd<__nv_bfloat16>(x, w1, w2, out, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The backward: a null dx skips the dx kernel, null dw1 and dw2 the dw
// kernel (both null or neither); dw1 / dw2 have the row strides of w1 / w2.
extern "C" int local_agg_mix_bwd_launch(int dtype, const void* x,
                                        const void* w1, int rows1,
                                        const void* w2, int rows2,
                                        const void* dy, void* dx, void* dw1,
                                        void* dw2, int n, int c, int h, int w,
                                        int heads, int cw, void* stream) {
  if ((dw1 == nullptr) != (dw2 == nullptr)) return int(cudaErrorInvalidValue);
  const MixGeometry g{n, c, h, w, heads, cw, rows1, rows2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, w1, w2, dy, dx, dw1, dw2, g, st);
    case 1:
      return launch_bwd<__half>(x, w1, w2, dy, dx, dw1, dw2, g, st);
    case 2:
      return launch_bwd<__nv_bfloat16>(x, w1, w2, dy, dx, dw1, dw2, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
