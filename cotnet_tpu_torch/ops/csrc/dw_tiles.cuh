// dw's halo-tile walk (common.cuh), shared by dw (local_agg_bwd_dw), the
// affine dw (local_agg_bwd_dw_affine, dw, ds and db in one pass; both in
// local_agg_bwd.cu) and the mix op's dw (local_agg_mix_dw,
// local_agg_mix.cu), which runs it once for each half of its dy.  The
// design is local_agg_bwd.cu's note on dw.

#pragma once

#include "common.cuh"

namespace {

// The affine dw's store, after dw_tiles' last channel group: acc holds the
// thread's gn sums, K*K rows of V positions at ``at`` = ho*Wo + wo0 of its
// plane (nv of them in the map), ``active`` as there.
// - Each tap's row: w's V values in the widest loads their alignment
//   allows, dw = gn * s stored once in the widest stores, and the thread's
//   partial sums of gn * w and of gn over its positions (v = 0..nv-1 in
//   order), kept in registers as acc's rows die.  An inactive thread's
//   partials are 0.
// - Once every thread is past the last group (a barrier only now, so that
//   no thread waits for the others before its loads and stores), the
//   partials go to shared memory, float2 [K*K][threads], over the stages.
// - The block then sums each (plane, tap) over the plane's ``items``
//   thread items in a fixed order: where a plane has at most 64 items
//   (14x14 and below), one thread a (plane, tap), the items in turn;
//   else a warp, lane l taking items l, l + 32, ... in turn, then the
//   warp's butterfly.  Warps span planes at small maps (7x7: 14 items a
//   plane), so the sums follow the planes, not the warps.
// - With one tile a plane, the sum goes to ds and db; with several, to
//   part[tile], for local_agg_bwd_dw_affine_sums.
// No atomics: the same launch gives the same bits.
template <typename T, int KT, int V>
__device__ __forceinline__ void dw_affine_epilogue(
    float (&acc)[KT * KT][V], const T* __restrict__ w,
    const float* __restrict__ s, T* __restrict__ dw, float* __restrict__ ds,
    float* __restrict__ db, float2* __restrict__ part, char* stages,
    const Geometry& g, const Tiling& t, int kh, int kw, int plane0, int tile,
    int p, int items, bool active, int at, int nv) {
  const int k2 = kh * kw;
  const int hw = g.ho * g.wo;
  const int planes = g.n * g.heads * g.cw;
  const int plane = plane0 + p;
  const int used = t.planes * items;  // the threads of the block's items
  const int64_t row0 = int64_t(plane) * k2;  // (plane, tap 0) of s, ds, db
  float sum_gw[KT * KT], sum_g[KT * KT];
#pragma unroll
  for (int i = 0; i < KT; ++i) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = i * kw + j;
      sum_gw[i * KT + j] = sum_g[i * KT + j] = 0.f;
      if (i < kh && j < kw && active) {
        const int64_t off = (row0 + k) * hw + at;
        float wv[V], dv[V];
        load_vec<T, V>(w + off, nv, wv);
        const float sk = s[row0 + k];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          dv[v] = acc[i * KT + j][v] * sk;
          if (v < nv) {
            sum_gw[i * KT + j] += acc[i * KT + j][v] * wv[v];
            sum_g[i * KT + j] += acc[i * KT + j][v];
          }
        }
        store_vec<T, V>(dw + off, nv, dv);
      }
    }
  }
  float2* sums = reinterpret_cast<float2*>(stages);
  cp_async_wait<0>();  // the groups after the last stage are empty
  __syncthreads();     // every thread is past the last group's sums
  if (int(threadIdx.x) < used) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (i < kh && j < kw) {
          sums[(i * kw + j) * used + threadIdx.x] =
              make_float2(sum_gw[i * KT + j], sum_g[i * KT + j]);
        }
      }
    }
  }
  __syncthreads();
  const bool by_thread = items <= 64;
  const int per_sum = by_thread ? 1 : 32;  // threads a (plane, tap)
  const int lane = threadIdx.x % 32;
  for (int u = threadIdx.x / per_sum; u < t.planes * k2;
       u += blockDim.x / per_sum) {
    const int pp = u / k2, k = u - pp * k2;
    if (plane0 + pp >= planes) break;  // the block's planes past the last
    const float2* src = sums + k * used + pp * items;
    float a = 0.f, c = 0.f;
    for (int it = by_thread ? 0 : lane; it < items; it += per_sum) {
      const float2 v = src[it];
      a += v.x;
      c += v.y;
    }
    if (!by_thread) {
      a = warp_sum(a);
      c = warp_sum(c);
    }
    if (by_thread || lane == 0) {
      const int64_t r = int64_t(plane0 + pp) * k2 + k;
      if (t.tiles == 1) {
        ds[r] = a;
        db[r] = c;
      } else {
        part[int64_t(tile) * planes * k2 + r] = make_float2(a, c);
      }
    }
  }
}

// Ask L2 for w's rows of the affine dw's tile ahead of the epilogue: for
// each of the block's ``np`` planes from plane0 and each tap, rows
// [r0, y_hi) of Wo elements, contiguous in w; a prefetch for every 128-byte
// line of them.
template <typename T>
__device__ __forceinline__ void prefetch_w_rows(const T* w, int plane0,
                                                int np, int k2, int hw,
                                                int r0, int y_hi, int wo) {
  const int bytes = (y_hi - r0) * wo * int(sizeof(T));
  // a row range that starts inside a line reaches one line further
  const int lines = (bytes + 127) / 128 + 1;
  for (int i = threadIdx.x; i < np * k2 * lines; i += blockDim.x) {
    const int chunk = i / lines, line = i - chunk * lines;
    const char* a = reinterpret_cast<const char*>(
        w + (int64_t(plane0) * k2 + chunk) * hw + int64_t(r0) * wo);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a + min(line * 128,
                                                          bytes - 1)));
  }
}

// The mix op's layout (local_agg_mix.cu), where dw_tiles runs one of its
// two halves: dy [N, 2*heads*C, Ho, Wo], half ``half``'s channel c of head
// ``head`` at (n*2*heads + half*heads + head)*C + c; dw rows of ``rows``
// taps (9 or 25 with the weights separate, 34 each when packed).
struct MixHalf {
  int half, rows;
};

// x [N, C, Hi, Wi]; dy [N, heads*C, Ho, Wo];
// dw [N, heads, Cw, Kh*Kw, Ho, Wo].  The halo tiles of common.cuh with the
// forward's planes and tiles (source x, halo included), a stage holding
// dy's rows of the tile besides, after x's halo tile, copied in units of
// ``dy_unit`` bytes.  KC = 3: K = 3 at dilation 1 and column padding 1;
// KC = 5: K = 5 at dilation 1 and column padding 2 (the mix's 5x5 half);
// KC = 0: any K up to kMaxK.  ``block``: the block's index among the
// blocks of this walk (unsigned, as blockIdx.x is: the same code for
// local_agg_bwd_dw and _dw_affine as when they read blockIdx.x).  The body
// of local_agg_bwd_dw and, with AFFINE, of local_agg_bwd_dw_affine: w, s,
// ds, db and part are the affine's (null without it); the affine asks L2
// for w's rows of the tile kStages - 1 groups before the last, and only
// the store differs (dw_affine_epilogue).
// With MIX, the mix op's half ``mix`` (dy and dw as MixHalf says).
template <typename T, int KC, bool AFFINE, bool MIX = false>
__device__ __forceinline__ void dw_tiles(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw,
    const T* __restrict__ w, const float* __restrict__ s,
    float* __restrict__ ds, float* __restrict__ db, float2* __restrict__ part,
    const Geometry& g, const Tiling& t, int dy_unit, unsigned block,
    MixHalf mix = MixHalf{}) {
  constexpr int KT = KC == 0 ? kMaxK : KC;       // taps unrolled per axis
  // positions of an item: at K = 5 its 25 x V sums are 50
  constexpr int V = KC == 3 ? 4 : KC == 5 ? 2 : 1;
  constexpr int NE = KC != 0 ? V + KT - 1 : KT;  // x columns an item reads
  // compile-time K: the item's x columns from the even one at or before
  // the first (column padding 1 makes the first odd at K = 3), in pairs
  constexpr int ODD = KC / 2 % 2;
  constexpr int PAIRS = (NE + ODD + 1) / 2;
  const int kh = KC != 0 ? KC : g.kh, kw = KC != 0 ? KC : g.kw;
  const int dil_h = KC != 0 ? 1 : g.dh, dil_w = KC != 0 ? 1 : g.dw;
  const int k2 = kh * kw;
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* x_src[kMaxPlanes];
  __shared__ const T* dy_src[kMaxPlanes];

  // the block: planes plane0 .. plane0 + t.planes - 1 and rows r0 ..
  // r0 + t.rows - 1; staged row 0 is x row ``first``, x's rows [h_lo, h_hi)
  // are the image's among the staged ones, and dy's rows [r0, y_hi) follow
  // them at staged row t.staged
  const int tile = block % t.tiles;
  const int plane0 = int(block / t.tiles) * t.planes;
  const int planes = g.n * g.heads * g.cw;  // < 2^31: checked at launch
  const int r0 = tile * t.rows;
  const int first = r0 - g.ph;
  const int h_lo = max(0, first), h_hi = min(g.hi, first + t.staged);
  const int y_hi = min(g.ho, r0 + t.rows);
  if (threadIdx.x < t.planes) {
    // plane (n * heads + head) * Cw + cw reads x channels n*C + cw + g*Cw
    // and dy channels (n * heads + head)*C + cw + g*Cw (the mix's half:
    // (n*2*heads + half*heads + head)*C + cw + g*Cw)
    const int plane = plane0 + threadIdx.x;
    const T* xp = nullptr;
    const T* yp = nullptr;
    if (plane < planes) {
      const int nh = plane / g.cw;
      const int cw = plane - nh * g.cw;
      const int dy_nh = MIX ? nh + (nh / g.heads + mix.half) * g.heads : nh;
      xp = x + (int64_t(nh / g.heads) * g.c + cw) * hw_in;
      yp = dy + (int64_t(dy_nh) * g.c + cw) * hw_out;
    }
    x_src[threadIdx.x] = xp;
    dy_src[threadIdx.x] = yp;
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
  // where tap (0, 0) of position 0 reads x, and where position 0 reads dy,
  // in the plane's stage
  const int region = t.region / int(sizeof(T));
  const int x_base = p * region + row * t.stride + t.pl + wo0 - g.pw;
  const int dy_base = p * region + (t.staged + row) * t.stride + wo0;
  // dy's rows sit after x's halo tile, with no zero columns before them
  Tiling ty = t;
  ty.pl = 0;
  ty.unit = dy_unit;
  const int dy_at = t.staged * t.stride * int(sizeof(T));

  float acc[KT * KT][V];
#pragma unroll
  for (int k = 0; k < KT * KT; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
  }
  __syncthreads();  // x_src[], dy_src[], the zeros

  const int groups = g.c / g.cw;
  const int64_t x_step = int64_t(g.cw) * hw_in;  // channel c to c + Cw
  const int64_t dy_step = int64_t(g.cw) * hw_out;
  const int stage_bytes = t.planes * t.region;
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < groups) {
      char* buf = stages + st * stage_bytes;
      stage_rows(buf, t, x_src, st * x_step, h_lo, h_hi, first, g.wi);
      stage_rows(buf + dy_at, ty, dy_src, st * dy_step, r0, y_hi, r0, g.wo);
    } else if (AFFINE && st == groups) {
      prefetch_w_rows(w, plane0, min(t.planes, planes - plane0), k2, hw_out,
                      r0, y_hi, g.wo);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    cp_async_wait<kStages - 2>();  // this group's stage has landed
    // every thread is past the previous group's sums, so its buffer is free
    __syncthreads();
    const int ahead = grp + kStages - 1;
    if (ahead < groups) {
      char* buf = stages + (ahead % kStages) * stage_bytes;
      stage_rows(buf, t, x_src, ahead * x_step, h_lo, h_hi, first, g.wi);
      stage_rows(buf + dy_at, ty, dy_src, ahead * dy_step, r0, y_hi, r0,
                 g.wo);
    } else if (AFFINE && ahead == groups) {
      prefetch_w_rows(w, plane0, min(t.planes, planes - plane0), k2, hw_out,
                      r0, y_hi, g.wo);
    }
    cp_async_commit();
    if (active) {
      const T* buf =
          reinterpret_cast<const T*>(stages + (grp % kStages) * stage_bytes);
      float ys[V];
      if constexpr (V == 1) {
        ys[0] = to_f32(buf[dy_base]);
      } else {
        load_pieces<V * int(sizeof(T))>(buf + dy_base, ys);
      }
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        if (i < kh) {
          const T* rp = buf + x_base + i * dil_h * t.stride;
          // compile-time K: the item's V + K - 1 columns from the even one
          // at or before them (pad 1 makes ``rp`` odd at K = 3), in PAIRS
          // loads of two
          float xs[KC != 0 ? 2 * PAIRS : NE];
          if constexpr (KC != 0) {
            load_pairs<T, PAIRS>(rp - ODD, xs);
          } else {
#pragma unroll
            for (int e = 0; e < NE; ++e) {
              xs[e] = e < kw ? to_f32(rp[e * dil_w]) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j < kw) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[i * KT + j][v] += xs[KC != 0 ? v + j + ODD : j] * ys[v];
              }
            }
          }
        }
      }
    }
  }
  if constexpr (AFFINE) {
    dw_affine_epilogue<T, KT, V>(acc, w, s, dw, ds, db, part, stages, g, t,
                                 kh, kw, plane0, tile, p, items, active,
                                 ho * g.wo + wo0, nv);
  } else if (active) {
    T* dwp = dw + int64_t(plane) * (MIX ? mix.rows : k2) * hw_out +
             ho * g.wo + wo0;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (i < kh && j < kw) {
          store_vec<T, V>(dwp + (i * kw + j) * hw_out, nv, acc[i * KT + j]);
        }
      }
    }
  }
}

}  // namespace
