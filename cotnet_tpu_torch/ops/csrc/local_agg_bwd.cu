// Local aggregation backward (the CoT "local conv") for Hopper, sm_90a.
//
// Forward (local_agg_fwd.cu):
//   out[n, head*C + c, ho, wo] =
//       sum_{i<Kh, j<Kw} wn[n, head, c % Cw, i*Kw + j, ho, wo]
//                        * x[n, c, ho - ph + i*dh, wo - pw + j*dw]
//   with wn = w, or wn = w * s + b with the GroupNorm affine s, b
//   [N, heads, Cw, Kh*Kw] f32 folded in.
//
// Three kernels, each launched only when a gradient of its is wanted:
//
//   dx[n, c, h, col] = sum_{head} sum_{i, j}
//       dy[n, head*C + c, ho, wo] * wn[n, head, c % Cw, i*Kw + j, ho, wo]
//     with ho = h + ph - i*dh, wo = col + pw - j*dw; terms whose (ho, wo)
//     falls outside [0, Ho) x [0, Wo) are dropped.  AFFINE forms wn in f32
//     from the raw w, as the forward does.
//
//   dw[n, head, cw, i*Kw + j, ho, wo] = sum_{g < C/Cw}
//       x[n, g*Cw + cw, ho - ph + i*dh, wo - pw + j*dw]
//       * dy[n, head*C + g*Cw + cw, ho, wo]
//     with x outside the image read as zero.
//
//   with the affine, that sum is the gradient gn of wn, and one pass gives
//       dw = gn * s                       (rounded once to w's type)
//       ds[n, head, cw, k] = sum_{ho, wo} gn * w      (the raw w; f32)
//       db[n, head, cw, k] = sum_{ho, wo} gn          (f32)
//     so gn, as large as w, is never stored.
//
// Replaces, in cotnet_tpu/ops/local_agg_pallas.py, every TPU kernel that
// computes one or more of these: the fused dx+dw kernels
// _bwd_chwn_strip_g_kernel, _dxdw_chwn_kernel, _dxdw_gather_kernel and
// _dxdw_scatter_kernel; dx alone, _dx_gather_kernel and _dx_kernel; dw
// alone, _dw_kernel and _dw_kernel_dot; the gated 56x56 dw tilings
// _dw_wloop_kernel and _dw_strip_kernel; and the affine pair
// _dx_kernel_affine and _dw_kernel_affine.  Their CHWN transposes, H-strip
// stacks, padded copies of dy and w and the 0/1 group-sum matmul exist for
// the TPU's VMEM budget and lane layout; none is carried over.  All kernels
// work on the reference's own layout (x NCHW, w cw-major, dy NCHW) and
// treat the zero padding as a bounds check, so any padding is allowed (the
// TPU gather kernel needs a non-negative low pad).
//
// Arithmetic follows the TPU kernels: every operand widens to f32 before
// the multiply, the sum is f32, and the result is rounded once at the store.
//
// Bound on this card: about one flop per byte, so the least time is the
// bytes over the HBM rate.  dx reads w and dy (and s, b) and writes dx; dw
// reads x and dy and writes dw; the affine dw reads w and s besides and
// writes ds and db.
//
// Design (simple and right first).  dx and dw: one thread per output
// element, the fastest-varying index on the thread index, so neighbouring
// threads read neighbouring addresses.  The affine dw: one block per
// (n, head, cw, tap) row of ds and db; its threads stride over the row's
// Ho*Wo positions, store dw, and keep private f32 sums that the block then
// reduces through warp shuffles and shared memory in a fixed order.  The
// TPU kernel reduces a whole image inside one grid step; here the row's
// owner is the block.  Each output has exactly one owner: no atomics, and
// the result is deterministic.  Left for later: one launch that reads dy
// once for all gradients, shared-memory tiles (the K*K taps of dw re-read
// the same x and dy planes through L1/L2), 16-byte loads and TMA.

#include "common.cuh"

namespace {

// w [N, heads, Cw, Kh*Kw, Ho, Wo]; s, b [N, heads, Cw, Kh*Kw] f32 (AFFINE
// only); dy [N, heads*C, Ho, Wo]; dx [N, C, Hi, Wi].  One thread per dx
// element.
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dx(const T* __restrict__ w, const float* __restrict__ s,
                     const float* __restrict__ b, const T* __restrict__ dy,
                     T* __restrict__ dx, Geometry g) {
  const int64_t total = int64_t(g.n) * g.c * g.hi * g.wi;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = int(idx % g.wi);
  int64_t r = idx / g.wi;
  const int h = int(r % g.hi);
  r /= g.hi;
  const int c = int(r % g.c);
  const int n = int(r / g.c);

  const int k2 = g.kh * g.kw;
  const int64_t plane = int64_t(g.ho) * g.wo;
  float acc = 0.f;
  for (int head = 0; head < g.heads; ++head) {
    const int64_t nh = int64_t(n) * g.heads + head;
    const T* dyp = dy + (nh * g.c + c) * plane;
    // (n, head, c % Cw, tap 0): the row of s/b, and of w in units of a plane
    const int64_t row = (nh * g.cw + c % g.cw) * k2;
    const T* wp = w + row * plane;
    for (int i = 0; i < g.kh; ++i) {
      const int ho = h + g.ph - i * g.dh;
      if (ho < 0 || ho >= g.ho) continue;
      for (int j = 0; j < g.kw; ++j) {
        const int wo = col + g.pw - j * g.dw;
        if (wo < 0 || wo >= g.wo) continue;
        const int64_t at = int64_t(ho) * g.wo + wo;
        const int k = i * g.kw + j;
        float wk = to_f32(wp[k * plane + at]);
        if (AFFINE) wk = wk * s[row + k] + b[row + k];
        acc += to_f32(dyp[at]) * wk;
      }
    }
  }
  dx[idx] = from_f32<T>(acc);
}

// The gradient of the (normalized) weight at one element:
// sum over the C/Cw channel groups of x's tap times dy; 0 for a tap outside
// the image.
template <typename T>
__device__ __forceinline__ float weight_grad(const T* __restrict__ x,
                                             const T* __restrict__ dy,
                                             const Geometry& g, int n,
                                             int head, int cw, int k, int ho,
                                             int wo) {
  const int h = ho - g.ph + (k / g.kw) * g.dh;
  const int col = wo - g.pw + (k % g.kw) * g.dw;
  if (h < 0 || h >= g.hi || col < 0 || col >= g.wi) return 0.f;
  const int64_t x_plane = int64_t(g.hi) * g.wi;
  const int64_t y_plane = int64_t(g.ho) * g.wo;
  // channel cw of group 0; the groups are Cw channels apart
  const T* xp = x + (int64_t(n) * g.c + cw) * x_plane + int64_t(h) * g.wi + col;
  const T* dyp = dy + ((int64_t(n) * g.heads + head) * g.c + cw) * y_plane +
                 int64_t(ho) * g.wo + wo;
  const int groups = g.c / g.cw;
  float acc = 0.f;
  for (int grp = 0; grp < groups; ++grp) {
    acc += to_f32(xp[int64_t(grp) * g.cw * x_plane]) *
           to_f32(dyp[int64_t(grp) * g.cw * y_plane]);
  }
  return acc;
}

// x [N, C, Hi, Wi]; dy [N, heads*C, Ho, Wo];
// dw [N, heads, Cw, Kh*Kw, Ho, Wo].  One thread per dw element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dw(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dw, Geometry g) {
  const int k2 = g.kh * g.kw;
  const int64_t total = int64_t(g.n) * g.heads * g.cw * k2 * g.ho * g.wo;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int wo = int(idx % g.wo);
  int64_t r = idx / g.wo;
  const int ho = int(r % g.ho);
  r /= g.ho;
  const int k = int(r % k2);
  r /= k2;
  const int cw = int(r % g.cw);
  r /= g.cw;
  const int head = int(r % g.heads);
  const int n = int(r / g.heads);
  dw[idx] = from_f32<T>(weight_grad(x, dy, g, n, head, cw, k, ho, wo));
}

// x, dy as above; w, dw [N, heads, Cw, Kh*Kw, Ho, Wo];
// s, ds, db [N, heads, Cw, Kh*Kw] f32.  One block per (n, head, cw, tap)
// row; blockDim.x is a multiple of 32, at most kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dw_affine(const T* __restrict__ x, const T* __restrict__ dy,
                            const T* __restrict__ w,
                            const float* __restrict__ s, T* __restrict__ dw,
                            float* __restrict__ ds, float* __restrict__ db,
                            Geometry g) {
  const int k2 = g.kh * g.kw;
  const int64_t row = blockIdx.x;
  const int k = int(row % k2);
  int64_t r = row / k2;
  const int cw = int(r % g.cw);
  r /= g.cw;
  const int head = int(r % g.heads);
  const int n = int(r / g.heads);

  const int plane = g.ho * g.wo;
  const float sk = s[row];
  const T* wp = w + row * plane;
  T* dwp = dw + row * plane;
  float sum_gw = 0.f, sum_g = 0.f;
  for (int p = threadIdx.x; p < plane; p += blockDim.x) {
    const float gn =
        weight_grad(x, dy, g, n, head, cw, k, p / g.wo, p % g.wo);
    dwp[p] = from_f32<T>(gn * sk);
    sum_gw += gn * to_f32(wp[p]);
    sum_g += gn;
  }

  __shared__ float part_gw[kThreads / 32], part_g[kThreads / 32];
  sum_gw = warp_sum(sum_gw);
  sum_g = warp_sum(sum_g);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    part_gw[warp] = sum_gw;
    part_g[warp] = sum_g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = blockDim.x / 32;
    float a = 0.f, c = 0.f;
    for (int i = 0; i < warps; ++i) {
      a += part_gw[i];
      c += part_g[i];
    }
    ds[row] = a;
    db[row] = c;
  }
}

template <typename T, bool AFFINE>
int launch_dx(const void* w, const void* s, const void* b, const void* dy,
              void* dx, const Geometry& g, cudaStream_t stream) {
  const int64_t total = int64_t(g.n) * g.c * g.hi * g.wi;
  unsigned blocks;
  if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
  if (total == 0) return int(cudaSuccess);
  local_agg_bwd_dx<T, AFFINE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<const T*>(dy),
      static_cast<T*>(dx), g);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
           const Geometry& g, cudaStream_t stream) {
  if (dx != nullptr) {
    const int err = launch_dx<T, false>(w, nullptr, nullptr, dy, dx, g, stream);
    if (err != int(cudaSuccess)) return err;
  }
  if (dw != nullptr) {
    const int64_t total =
        int64_t(g.n) * g.heads * g.cw * g.kh * g.kw * g.ho * g.wo;
    unsigned blocks;
    if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
    if (total > 0) {
      local_agg_bwd_dw<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dw), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  return int(cudaSuccess);
}

template <typename T>
int launch_affine(const void* x, const void* w, const void* s, const void* b,
                  const void* dy, void* dx, void* dw, void* ds, void* db,
                  const Geometry& g, cudaStream_t stream) {
  if (dx != nullptr) {
    const int err = launch_dx<T, true>(w, s, b, dy, dx, g, stream);
    if (err != int(cudaSuccess)) return err;
  }
  if (dw != nullptr) {
    const int64_t rows = int64_t(g.n) * g.heads * g.cw * g.kh * g.kw;
    const int64_t plane = int64_t(g.ho) * g.wo;
    if (rows > 0x7fffffff || plane > 0x7fffffff) {
      return int(cudaErrorInvalidConfiguration);
    }
    if (rows > 0) {
      // a warp for every 32 positions of the row, up to kThreads
      const int64_t warps = (plane + 31) / 32;
      const unsigned threads =
          unsigned(warps < 1 ? 32 : (warps * 32 > kThreads ? kThreads
                                                           : warps * 32));
      local_agg_bwd_dw_affine<T><<<unsigned(rows), threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<const T*>(w), static_cast<const float*>(s),
          static_cast<T*>(dw), static_cast<float*>(ds),
          static_cast<float*>(db), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  return int(cudaSuccess);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  A null dx or dw skips that
// gradient's kernel (x may be null when dw is, w when dx is).  Returns a
// cudaError_t code; 0 means every requested launch was accepted.
extern "C" int local_agg_bwd_launch(int dtype, const void* x, const void* w,
                                    const void* dy, void* dx, void* dw, int n,
                                    int c, int hi, int wi, int heads, int cw,
                                    int kh, int kw, int ho, int wo, int ph,
                                    int pw, int dh, int dw_, void* stream) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw_};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, dy, dx, dw, g, st);
    case 1:
      return launch<__half>(x, w, dy, dx, dw, g, st);
    case 2:
      return launch<__nv_bfloat16>(x, w, dy, dx, dw, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The same with the affine s, b (f32) folded into the forward.  A null dx
// skips the dx kernel; a null dw skips the kernel that writes dw, ds and db
// together (all three null or none).
extern "C" int local_agg_bwd_affine_launch(
    int dtype, const void* x, const void* w, const void* s, const void* b,
    const void* dy, void* dx, void* dw, void* ds, void* db, int n, int c,
    int hi, int wi, int heads, int cw, int kh, int kw, int ho, int wo, int ph,
    int pw, int dh, int dw_, void* stream) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw_};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dw == nullptr) != (ds == nullptr) || (dw == nullptr) != (db == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return launch_affine<float>(x, w, s, b, dy, dx, dw, ds, db, g, st);
    case 1:
      return launch_affine<__half>(x, w, s, b, dy, dx, dw, ds, db, g, st);
    case 2:
      return launch_affine<__nv_bfloat16>(x, w, s, b, dy, dx, dw, ds, db, g,
                                          st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
