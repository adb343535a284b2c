// Embed 1x1 conv + sub-channel GroupNorm + local aggregation in one op, for
// Hopper, sm_90a.  Eval only (no backward).
//
//   w_raw[n, f, p] = round_T(sum_{cp} w_pre[n, cp, p] * w2[n % G, f, cp]
//                            + b2[n % G, f])            f = cw*K2 + k
//   mean, var[n, cw] over (k, p) of w_raw, one pass, f32,
//       var = max(E[w^2] - E[w]^2, 0), inv = rsqrt(var + eps)
//   wn[n, cw, k, p] = (w_raw - mean) * (inv * gamma[f]) + beta[f]
//   out[n, c, ho, wo] = sum_{i<Kh, j<Kw} wn[n, c % Cw, i*Kw + j, ho, wo]
//                       * x[n, c, ho - ph + i*dh, wo - pw + j*dw]
//
// with p = ho*Wo + wo, x outside the image read as zero, and T the type of
// x, w_pre, w2 and out.  G > 1 is the grouped layer (CoXtLayer): its G
// channel groups are G consecutive images of the batch, image n taking the
// conv weights and GroupNorm parameters of group n % G.  The weight tensor
// w_raw, K2/8 times the size of x, is never stored.
//
// Replaces _fused_embed_kernel in cotnet_tpu/ops/local_agg_pallas.py (one
// image, or a few, per grid step: the product on the MXU into a VMEM
// scratch in the model type, the statistics over that scratch, then the
// normalize and the taps in row chunks).  It keeps that kernel's
// arithmetic: f32 accumulation of the product, w_raw rounded to the model
// type before the statistics see it, subtract-first normalize, f32 taps,
// one rounding of the output.  The TPU plan refuses maps above 28x28; this
// covers every map.
//
// Bound on this card: the bytes of x + w_pre + w2 + out.  The product's
// 2*N*P*Cp*F operations take less than those bytes at the tensor cores'
// rate for 16-bit operands.  This kernel forms the product in f32 FMAs on
// the CUDA cores, and twice (see below), so it is far from that bound.
//
// Design (simple and right first).  A block cannot hold an image's w_raw
// (up to 72 x 3136 values), and the statistics need all of it before the
// first output.  So two kernels that each form w_raw in registers:
//   embed_gn_stats  writes, per (n, cw, pixel tile), the tile's sum and sum
//                   of squares of w_raw;
//   embed_gn_agg    forms the same w_raw again, adds up the tiles' sums in a
//                   fixed order, normalizes and aggregates.
// Both call one device function, embed_w_raw, so the values whose
// statistics are taken are bit for bit the values that are normalized.
// A block is 32 pixels (a warp, along x) by CWB weight channels (along y);
// each thread keeps the K2 taps of one (pixel, cw) in registers.  The
// product runs over Cp in tiles of 32 held in shared memory, so w2 never
// has to fit (at 256 x 576 it would not).  Every sum has one owner and a
// fixed order: no atomics, deterministic.  Left for later: tensor-core
// products (wgmma needs 64-row tiles of w_pre), keeping w_raw in shared
// memory across the two passes for small maps, and x tiles in shared memory.

#include "common.cuh"

namespace {

constexpr int kTilePx = 32;  // pixels per block: one warp along x
constexpr int kTileCp = 32;  // embed channels per shared-memory tile

struct EmbedGeometry {
  int n, groups, c, hi, wi, cp, cw, kh, kw, ho, wo, ph, pw, dh, dw;
  float eps;
};

// The K2 taps of w_raw for this thread's (pixel p0 + tx, cw0 + ty), zero
// where the pixel or the channel is out of range.  Every thread of the
// block must call it (it synchronizes).  w_pre_n [Cp, P]; w2_g [Cw*K2, Cp];
// b2_g [Cw*K2].
template <typename T, int K2, int CWB>
__device__ __forceinline__ void embed_w_raw(const T* __restrict__ w_pre_n,
                                            const T* __restrict__ w2_g,
                                            const float* __restrict__ b2_g,
                                            const EmbedGeometry& g, int p0,
                                            int cw0, float (&w_raw)[K2]) {
  __shared__ float wp_s[kTileCp][kTilePx];
  __shared__ float w2_s[CWB * K2][kTileCp + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTilePx + tx;
  constexpr int kBlock = kTilePx * CWB;
  const int plane = g.ho * g.wo;
  const int f_total = g.cw * K2;

  float acc[K2];
#pragma unroll
  for (int k = 0; k < K2; ++k) acc[k] = 0.f;

  for (int cp0 = 0; cp0 < g.cp; cp0 += kTileCp) {
    for (int i = tid; i < kTileCp * kTilePx; i += kBlock) {
      const int cpl = i / kTilePx, px = i % kTilePx;
      const int cp = cp0 + cpl, p = p0 + px;
      wp_s[cpl][px] = (cp < g.cp && p < plane)
                          ? to_f32(w_pre_n[int64_t(cp) * plane + p])
                          : 0.f;
    }
    for (int i = tid; i < CWB * K2 * kTileCp; i += kBlock) {
      const int fl = i / kTileCp, cpl = i % kTileCp;
      const int f = cw0 * K2 + fl, cp = cp0 + cpl;
      w2_s[fl][cpl] = (f < f_total && cp < g.cp)
                          ? to_f32(w2_g[int64_t(f) * g.cp + cp])
                          : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int cpl = 0; cpl < kTileCp; ++cpl) {
      const float a = wp_s[cpl][tx];
#pragma unroll
      for (int k = 0; k < K2; ++k) {
        acc[k] = fmaf(a, w2_s[ty * K2 + k][cpl], acc[k]);
      }
    }
    __syncthreads();
  }

  const int cw = cw0 + ty;
  const bool valid = cw < g.cw && p0 + tx < plane;
#pragma unroll
  for (int k = 0; k < K2; ++k) {
    // rounded to the model type, as the conv's output would be
    w_raw[k] = valid ? to_f32(from_f32<T>(acc[k] + b2_g[cw * K2 + k])) : 0.f;
  }
}

// partials [N, Cw, tiles, 2] f32: per pixel tile the sum and the sum of
// squares of w_raw over the tile's pixels and the K2 taps.
// Grid (tiles, ceil(Cw / CWB), N); block (32, CWB).
template <typename T, int K2, int CWB>
__global__ void __launch_bounds__(kTilePx* CWB)
    embed_gn_stats(const T* __restrict__ w_pre, const T* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ partials,
                   EmbedGeometry g) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int cw0 = blockIdx.y * CWB;
  const int n = blockIdx.z, grp = n % g.groups;
  const int plane = g.ho * g.wo;
  float w_raw[K2];
  embed_w_raw<T, K2, CWB>(w_pre + int64_t(n) * g.cp * plane,
                          w2 + int64_t(grp) * g.cw * K2 * g.cp,
                          b2 + grp * g.cw * K2, g, tile * kTilePx, cw0, w_raw);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < K2; ++k) {
    s1 += w_raw[k];
    s2 += w_raw[k] * w_raw[k];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int cw = cw0 + threadIdx.y;
  if (threadIdx.x == 0 && cw < g.cw) {
    float* out = partials + ((int64_t(n) * g.cw + cw) * tiles + tile) * 2;
    out[0] = s1;
    out[1] = s2;
  }
}

// x [N, C, Hi, Wi]; out [N, C, Ho, Wo]; gamma, beta [G, Cw*K2] f32.
// Same grid and block as embed_gn_stats.
template <typename T, int K2, int CWB>
__global__ void __launch_bounds__(kTilePx* CWB)
    embed_gn_agg(const T* __restrict__ x, const T* __restrict__ w_pre,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ partials, T* __restrict__ out,
                 EmbedGeometry g) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int cw0 = blockIdx.y * CWB;
  const int n = blockIdx.z, grp = n % g.groups;
  const int plane = g.ho * g.wo;
  float wn[K2];
  embed_w_raw<T, K2, CWB>(w_pre + int64_t(n) * g.cp * plane,
                          w2 + int64_t(grp) * g.cw * K2 * g.cp,
                          b2 + grp * g.cw * K2, g, tile * kTilePx, cw0, wn);

  // the image's statistics for this warp's cw: the tiles' sums, lane by
  // lane and then across the warp, in the same order in every block
  const int cw = cw0 + threadIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (cw < g.cw) {
    const float* part = partials + (int64_t(n) * g.cw + cw) * tiles * 2;
    for (int t = threadIdx.x; t < tiles; t += kTilePx) {
      s1 += part[2 * t];
      s2 += part[2 * t + 1];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int p = tile * kTilePx + threadIdx.x;
  if (cw >= g.cw || p >= plane) return;
  const float count = float(K2) * float(plane);
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  const float inv = rsqrtf(var + g.eps);
  const float* gm = gamma + (grp * g.cw + cw) * K2;
  const float* be = beta + (grp * g.cw + cw) * K2;
#pragma unroll
  for (int k = 0; k < K2; ++k) {
    wn[k] = (wn[k] - mean) * (inv * gm[k]) + be[k];
  }

  const int ho = p / g.wo, wo = p % g.wo;
  const int64_t x_plane = int64_t(g.hi) * g.wi;
  for (int c = cw; c < g.c; c += g.cw) {
    const T* xp = x + (int64_t(n) * g.c + c) * x_plane;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K2; ++k) {
      const int h = ho - g.ph + (k / g.kw) * g.dh;
      const int col = wo - g.pw + (k % g.kw) * g.dw;
      const float xv = (h >= 0 && h < g.hi && col >= 0 && col < g.wi)
                           ? to_f32(xp[int64_t(h) * g.wi + col])
                           : 0.f;
      acc += xv * wn[k];
    }
    out[(int64_t(n) * g.c + c) * plane + p] = from_f32<T>(acc);
  }
}

template <typename T, int K2, int CWB>
int launch(const void* x, const void* w_pre, const void* w2, const void* b2,
           const void* gamma, const void* beta, void* partials, void* out,
           const EmbedGeometry& g, cudaStream_t stream) {
  const int64_t plane = int64_t(g.ho) * g.wo;
  const int64_t tiles = (plane + kTilePx - 1) / kTilePx;
  if (g.n == 0 || g.cw == 0 || plane == 0) return int(cudaSuccess);
  if (tiles > 0x7fffffff || g.n > 65535 || (g.cw + CWB - 1) / CWB > 65535) {
    return int(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(unsigned(tiles), unsigned((g.cw + CWB - 1) / CWB),
                  unsigned(g.n));
  const dim3 block(kTilePx, CWB);
  embed_gn_stats<T, K2, CWB><<<grid, block, 0, stream>>>(
      static_cast<const T*>(w_pre), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(partials), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  embed_gn_agg<T, K2, CWB><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_pre),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(partials), static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

// The taps live in registers, so K2 is a template argument; CWB keeps the
// w2 tile in shared memory near 13 KB at each K2.
template <typename T>
int dispatch_taps(const void* x, const void* w_pre, const void* w2,
                  const void* b2, const void* gamma, const void* beta,
                  void* partials, void* out, const EmbedGeometry& g,
                  cudaStream_t stream) {
  switch (g.kh * g.kw) {
    case 9:
      return launch<T, 9, 8>(x, w_pre, w2, b2, gamma, beta, partials, out, g,
                             stream);
    case 25:
      return launch<T, 25, 4>(x, w_pre, w2, b2, gamma, beta, partials, out, g,
                              stream);
    case 49:
      return launch<T, 49, 2>(x, w_pre, w2, b2, gamma, beta, partials, out, g,
                              stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (x, w_pre, w2, out); b2, gamma,
// beta and partials are f32.  n counts images times groups; c, cp and cw are
// per group.  partials holds n * cw * ceil(ho*wo / 32) * 2 floats of
// scratch.  kh*kw must be 9, 25 or 49.  Returns a cudaError_t code; 0 means
// both launches were accepted.
extern "C" int local_agg_embed_gn_launch(
    int dtype, const void* x, const void* w_pre, const void* w2,
    const void* b2, const void* gamma, const void* beta, void* partials,
    void* out, int n, int groups, int c, int hi, int wi, int cp, int cw,
    int kh, int kw, int ho, int wo, int ph, int pw, int dh, int dw, float eps,
    void* stream) {
  const EmbedGeometry g{n,  groups, c,  hi, wi, cp, cw, kh,
                        kw, ho,     wo, ph, pw, dh, dw, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_taps<float>(x, w_pre, w2, b2, gamma, beta, partials,
                                  out, g, st);
    case 1:
      return dispatch_taps<__half>(x, w_pre, w2, b2, gamma, beta, partials,
                                   out, g, st);
    case 2:
      return dispatch_taps<__nv_bfloat16>(x, w_pre, w2, b2, gamma, beta,
                                          partials, out, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
