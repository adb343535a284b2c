// The aggregation forward's halo-tile walk (common.cuh), shared by the
// forward (local_agg_fwd.cu) and the fused embed op's aggregation
// (local_agg_embed_gn.cu).  The two differ only in where a thread's K*K x V
// tap weights come from: the forward loads them from w (w*s + b with the
// affine), the embed op forms them from its 1x1 conv and GroupNorm.  A
// weight source is a type with
//   static constexpr bool kLate;
//   template <int KT, int V>
//   __device__ void form(float (&wr)[KT * KT][V], const FwdItem& it,
//                        const Geometry& g, const Tiling& t,
//                        char* scratch) const;
// kLate false: called by the active threads only, before the stages are
// issued (the forward).  kLate true: called by every thread of the block
// after the first kStages - 1 stages are issued, so that forming the
// weights hides the copies' latency; it may synchronize the block and use
// ``scratch``, the dynamic shared memory after the stages.

#pragma once

#include "common.cuh"

namespace {

// A thread's item: plane ``p`` of the block (``plane`` of all), output row
// ``ho``, positions wo0 .. wo0 + nv - 1; ``active`` false for a thread past
// the block's planes or rows.  ``plane0`` and ``tile`` are the block's.
struct FwdItem {
  int p, plane, ho, wo0, nv, plane0, tile;
  bool active;
};

// x [N, C, Hi, Wi]; out [N, heads*C, Ho, Wo]; the weights of plane (n *
// heads + head) * Cw + cw from ``weights``.  KC = 3: K = 3 at dilation 1
// and column padding 1, V = 4; KC = 0: any K up to kMaxK, V = 1.
template <typename T, int KC, typename Weights>
__device__ __forceinline__ void fwd_tiles(const T* __restrict__ x,
                                          T* __restrict__ out,
                                          const Geometry& g, const Tiling& t,
                                          const Weights& weights) {
  constexpr int KT = KC == 3 ? 3 : kMaxK;        // taps unrolled per axis
  constexpr int V = KC == 3 ? 4 : 1;             // positions of an item
  constexpr int NE = KC == 3 ? V + KT - 1 : KT;  // x columns an item reads
  const int kh = KC == 3 ? 3 : g.kh, kw = KC == 3 ? 3 : g.kw;
  const int dh = KC == 3 ? 1 : g.dh, dw = KC == 3 ? 1 : g.dw;
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* src[kMaxPlanes];

  // the block: planes plane0 .. plane0 + t.planes - 1 and rows r0 ..
  // r0 + t.rows - 1; staged row 0 is x row ``first``, and x's rows
  // [h_lo, h_hi) are the image's among the staged ones
  const int tile = blockIdx.x % t.tiles;
  const int plane0 = int(blockIdx.x / t.tiles) * t.planes;
  const int planes = g.n * g.heads * g.cw;  // < 2^31: checked at launch
  const int r0 = tile * t.rows;
  const int first = r0 - g.ph;
  const int h_lo = max(0, first), h_hi = min(g.hi, first + t.staged);
  if (threadIdx.x < t.planes) {
    // plane (n * heads + head) * Cw + cw reads x channels n*C + cw + g*Cw
    const int plane = plane0 + threadIdx.x;
    const T* xp = nullptr;
    if (plane < planes) {
      const int nh = plane / g.cw;
      xp = x + (int64_t(nh / g.heads) * g.c + (plane - nh * g.cw)) * hw_in;
    }
    src[threadIdx.x] = xp;
  }
  zero_stages(stages, kStages * t.planes * t.region);

  // the thread: plane p of the block, row ho, positions wo0 .. wo0 + nv - 1
  const int items = t.rows * t.q;
  const int p = threadIdx.x / items;
  const int rem = threadIdx.x - p * items;
  const int row = rem / t.q;
  const int wo0 = (rem - row * t.q) * V;
  const int ho = r0 + row;
  const int plane = plane0 + p;
  const bool active = p < t.planes && plane < planes && ho < g.ho;
  const int nv = min(V, g.wo - wo0);
  const FwdItem it{p, plane, ho, wo0, nv, plane0, tile, active};

  // the K*K weights of the thread's positions, once, into registers
  float wr[KT * KT][V];
  T* op = nullptr;
  if (active) {
    if constexpr (!Weights::kLate) {
      weights.template form<KT, V>(wr, it, g, t, nullptr);
    }
    const int nh = plane / g.cw;
    op = out + (int64_t(nh) * g.c + (plane - nh * g.cw)) * hw_out +
         ho * g.wo + wo0;
  }
  // where tap (0, 0) of position 0 reads in the plane's stage
  const int base = p * (t.region / int(sizeof(T))) + row * t.stride + t.pl +
                   wo0 - g.pw;
  __syncthreads();  // src[], the zeros

  const int groups = g.c / g.cw;
  const int64_t x_step = int64_t(g.cw) * hw_in;  // channel c to c + Cw
  const int64_t out_step = int64_t(g.cw) * hw_out;
  const int stage_bytes = t.planes * t.region;
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < groups) {
      stage_rows(stages + st * stage_bytes, t, src, st * x_step, h_lo, h_hi,
                 first, g.wi);
    }
    cp_async_commit();
  }
  if constexpr (Weights::kLate) {
    weights.template form<KT, V>(wr, it, g, t,
                                 stages + kStages * stage_bytes);
  }
#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    cp_async_wait<kStages - 2>();  // this group's stage has landed
    // every thread is past the previous group's sum, so its buffer is free
    __syncthreads();
    const int ahead = grp + kStages - 1;
    if (ahead < groups) {
      stage_rows(stages + (ahead % kStages) * stage_bytes, t, src,
                 ahead * x_step, h_lo, h_hi, first, g.wi);
    }
    cp_async_commit();
    if (active) {
      const T* buf =
          reinterpret_cast<const T*>(stages + (grp % kStages) * stage_bytes) +
          base;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        if (i < kh) {
          const T* rp = buf + i * dh * t.stride;
          // K = 3: the item's V + 2 columns from the even one before them
          // (pad 1 makes ``buf`` odd), in V/2 + 2 loads of two
          float xs[KC == 3 ? NE + 2 : NE];
          if constexpr (KC == 3) {
            load_pairs<T, V / 2 + 2>(rp - 1, xs);
          } else {
#pragma unroll
            for (int e = 0; e < NE; ++e) {
              xs[e] = e < kw ? to_f32(rp[e * dw]) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j < kw) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[v] += wr[i * KT + j][v] * xs[KC == 3 ? v + j + 1 : j];
              }
            }
          }
        }
      }
      store_vec<T, V>(op + grp * out_step, nv, acc);
    }
  }
}

}  // namespace
