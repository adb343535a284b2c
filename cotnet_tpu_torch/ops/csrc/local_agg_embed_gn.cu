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
// rate for 16-bit operands; here it is formed in f32 FMAs on the CUDA
// cores (924.8 M multiply-adds at each of cotnet50's maps, about 0.03 ms
// at the card's f32 rate).
//
// Three kernels: embed_gn_stats_rows (the tiled routes) and embed_gn_stats
// (the pointwise route) write, per (n, cw, tile of pixels), the tile's sum
// and sum of squares of w_raw; embed_gn_agg forms the weights, normalizes
// and aggregates.  Three routes, chosen before any launch from
// the geometry and the element size (agg_route with kAggEmbed, common.cuh):
// - ``k3`` (K = 3 at dilation 1 and column padding 1; every main path) and
//   ``general`` (runtime K <= kMaxK, V = 1): embed_gn_agg<T, KC> on the
//   forward's halo tiles (fwd_tiles.cuh).  A block owns planes (n, cw) and
//   a tile of their rows, up to kEmbedTargetItems thread items; it zeroes
//   its stages and issues the first kStages - 1 x stages by cp.async, and
//   only then forms its threads' weights, so that the product hides the
//   copies' latency:
//   - the product: the block stages w_pre's values of its tile (per image
//     of its planes) and w2's rows of its planes in shared memory by
//     cp.async, a chunk of embed channels at a time (plan_embed_scratch),
//     the next chunk in flight while a chunk is summed; w2's chunk is
//     turned to f32 with each channel's K*K values contiguous.  For each
//     cp a thread reads its V values of w_pre and the K*K values of w2
//     (three 16-byte loads at K = 3, the same address across the plane's
//     threads), then makes K*K*V FMAs into registers.  (Reading w_pre from
//     device memory inside that loop left it waiting on each load for
//     most of the kernel's time on the card.)
//   - the statistics: where a block holds whole planes (one row tile a
//     plane: every map up to 28x28 at cotnet50's widths), the block sums
//     w_raw and w_raw^2 by plane in f32 in a fixed order (each thread over
//     its taps and positions, then the plane's threads in turn, or a warp
//     a plane where it has more than 64 items), and no statistics kernel
//     is launched; where a plane spans several row tiles (56x56),
//     embed_gn_stats_rows runs first and one warp reads its partial sums
//     in a fixed order (tile_stats);
//   - the normalize in registers, subtract first, then the forward's walk
//     of the C/Cw channels on the staged halo tiles: f32 taps, one rounding
//     of the output, zero padding from the stages' zeros.
// - ``pointwise`` (every other geometry): embed_gn_stats, then
//   embed_gn_agg_pointwise, a block of 32 pixels by CWB weight channels, a
//   thread the K2 taps of one (pixel, cw), forming w_raw again and reading
//   x's taps through L1 (the op's first design).
// - embed_gn_stats_rows<T, K2>, the tiled routes' statistics: a row tile
//   is as many whole rows of one image as kRowStatsItems thread items
//   hold (spread evenly over the tiles); a block takes every weight
//   channel (fewer where a row each is wider) and walks up to
//   kRowStatsRun row tiles in turn; a thread item is V pixels (V = 8 at
//   K = 3) of one channel.  The block stages w2's rows of its channels
//   once by cp.async and turns them to f32 with each (channel, cp) pair's
//   K2 values contiguous, and w_pre's pixels of its tiles by cp.async,
//   kRowStatsChunk channels a stage, two stages in flight while one is
//   summed (one __syncthreads a stage), across tiles.  Per cp a thread
//   makes one 16-byte load of its V w_pre values and ceil(K2/4) 16-byte
//   loads of w2 (the same address across the channel's threads) for K2*V
//   FMAs, where embed_gn_stats makes one load per FMA.  Its sums
//   go in a fixed order (the thread's, then its channel's threads by a
//   warp), one owner a partial.  Its bound is w_pre's bytes (the product
//   at the tensor cores' rate is shorter); the bit-identity below keeps
//   the product in f32 FMAs, a floor of this design about 3.6 times that
//   bound at cotnet50's 56x56.
// Bit-identity: every kernel forms w_raw with embed_w_raw's arithmetic,
// fmaf over cp = 0 .. Cp-1 in increasing order from 0.f, then + b2,
// rounded to T and widened back to f32.  So the values whose statistics a
// statistics kernel takes are bit for bit the values the aggregation
// normalizes.  Every sum has one owner and a fixed order: no atomics, the
// same bits from run to run.  Left for later: the product on tensor cores
// (wgmma).

#include <numeric>

#include "fwd_tiles.cuh"

namespace {

constexpr int kTilePx = 32;  // pixels per block: one warp along x
constexpr int kTileCp = 32;  // embed channels per shared-memory tile

struct EmbedGeometry {
  int n, groups, c, hi, wi, cp, cw, kh, kw, ho, wo, ph, pw, dh, dw;
  float eps;
};

// The aggregation's geometry (one head) of the op's.
Geometry agg_geometry(const EmbedGeometry& g) {
  return Geometry{g.n,  g.c,  g.hi, g.wi, 1,    g.cw, g.kh,
                  g.kw, g.ho, g.wo, g.ph, g.pw, g.dh, g.dw};
}

// The statistics kernel's pixel tiles.
int64_t stats_tiles(const EmbedGeometry& g) {
  return (int64_t(g.ho) * g.wo + kTilePx - 1) / kTilePx;
}

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

// The image's statistics of weight channel cw from embed_gn_stats' tiles'
// sums, lane by lane and then across the warp, in the same order wherever
// they are read: (mean, 1/std).  Every lane of the warp must call it.
__device__ __forceinline__ float2 tile_stats(const float* __restrict__ part,
                                             int tiles, float count,
                                             float eps) {
  float s1 = 0.f, s2 = 0.f;
  for (int t = threadIdx.x % 32; t < tiles; t += 32) {
    s1 += part[2 * t];
    s2 += part[2 * t + 1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The pointwise route's aggregation.  x [N, C, Hi, Wi]; out [N, C, Ho, Wo];
// gamma, beta [G, Cw*K2] f32.  Same grid and block as embed_gn_stats.
template <typename T, int K2, int CWB>
__global__ void __launch_bounds__(kTilePx* CWB)
    embed_gn_agg_pointwise(const T* __restrict__ x,
                           const T* __restrict__ w_pre,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ partials,
                           T* __restrict__ out, EmbedGeometry g) {
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int cw0 = blockIdx.y * CWB;
  const int n = blockIdx.z, grp = n % g.groups;
  const int plane = g.ho * g.wo;
  float wn[K2];
  embed_w_raw<T, K2, CWB>(w_pre + int64_t(n) * g.cp * plane,
                          w2 + int64_t(grp) * g.cw * K2 * g.cp,
                          b2 + grp * g.cw * K2, g, tile * kTilePx, cw0, wn);

  // the image's statistics for this warp's cw
  const int cw = cw0 + threadIdx.y;
  const float2 st = tile_stats(
      partials + (int64_t(n) * g.cw + min(cw, g.cw - 1)) * tiles * 2, tiles,
      float(K2) * float(plane), g.eps);
  const int p = tile * kTilePx + threadIdx.x;
  if (cw >= g.cw || p >= plane) return;
  const float* gm = gamma + (grp * g.cw + cw) * K2;
  const float* be = beta + (grp * g.cw + cw) * K2;
#pragma unroll
  for (int k = 0; k < K2; ++k) {
    wn[k] = (wn[k] - st.x) * (st.y * gm[k]) + be[k];
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

// Copy ``runs`` runs of ``len`` elements of T, run r from src(r) to
// dst(r) (shared memory): by cp.async in ``unit``-byte pieces (16, 8 or 4;
// every run start a multiple of it, the caller commits the group), pieces
// of a run on consecutive threads; with no unit (0), element by element
// through registers, kBatch loads in flight a thread before their stores.
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void copy_runs(int runs, int len, int unit,
                                          Src src, Dst dst) {
  if (unit == 0) {
    constexpr int kBatch = 4;
    const int total = runs * len;
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
      T v[kBatch];
      T* at[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * blockDim.x;
        at[b] = nullptr;
        if (i < total) {
          const int r = i / len, j = i - r * len;
          v[b] = src(r)[j];
          at[b] = reinterpret_cast<T*>(dst(r)) + j;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (at[b] != nullptr) *at[b] = v[b];
      }
    }
    return;
  }
  const int per_run = len * int(sizeof(T)) / unit;
  const int total = runs * per_run;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per_run, j = i - r * per_run;
    char* to = dst(r) + j * unit;
    const char* from = reinterpret_cast<const char*>(src(r)) + j * unit;
    if (unit == 16) {
      cp_async<16>(to, from);
    } else if (unit == 8) {
      cp_async<8>(to, from);
    } else {
      cp_async<4>(to, from);
    }
  }
}

// ---- the tiled routes' statistics kernel ----------------------------------

constexpr int kRowStatsItems = 256;  // a block's thread items, if a row fits
constexpr int kRowStatsChunk = 32;   // w_pre channels of a stage, at most
constexpr int kRowStatsStages = 3;   // w_pre stages in shared memory at once
constexpr int kRowStatsSmemAim = 64 * 1024;  // a block's, when it can
// row tiles a block walks, at most, spread evenly: w2 is staged once for
// them and w_pre's copies stay in flight from one tile to the next (at
// cotnet50's 56x56, 14 tiles of 4 rows: the card ran 7 12% faster than 1);
// fewer where the grid would hold fewer than kRowStatsBlocks blocks (a
// few images: there the card ran 7 four times slower than the 32-pixel
// embed_gn_stats)
constexpr int kRowStatsRun = 7;
constexpr int kRowStatsBlocks = 256;

// The positions of a thread item at K2 taps: its K2 x V sums stay in
// registers.  At K = 3 the card ran 8 (72 sums) 23% faster than 4.
__host__ __device__ constexpr int row_stats_vec(int k2) {
  return k2 <= 9 ? 8 : k2 <= 25 ? 2 : 1;
}

// embed_gn_stats_rows' blocks: ``cwb`` weight channels (``cblocks`` blocks
// cover Cw) by ``rows`` output rows (``tiles`` row tiles a plane) of one
// image; ``items`` thread items of V pixels a channel.  Dynamic shared
// memory: the block's w2 in f32 at 0, [channel][cp][K2 rounded up to 4],
// ``w2_stride`` floats a channel; at ``w2raw``, the same values as w2
// holds them; from ``wpre``, kRowStatsStages stages of ``chunk`` w_pre
// channels, a channel's pixels of a tile at ``span_bytes``; from
// ``sums``, each thread's two sums; ``bytes`` in all.  A block walks
// ``run`` consecutive row tiles of its image (``runs`` blocks cover a
// plane's tiles).
struct RowStats {
  int rows, tiles, cwb, cblocks, items, chunk, span_bytes, w2_stride;
  int w2raw, wpre, sums, bytes;
  int run, runs;  // row tiles a block walks; blocks a plane's tiles take
};

// The blocks of embed_gn_stats_rows at g with ``elem``-byte elements: every
// weight channel of an image and as many whole rows as kRowStatsItems
// thread items hold (fewer channels where one row each is wider), the
// rows spread evenly over the tiles; w_pre staged in chunks of up to
// kRowStatsChunk channels, halved until the block's shared memory fits
// kRowStatsSmemAim.  False where a row is wider than kMaxThreads items,
// one channel's w2 does not fit a block, or the grid is too large.
inline bool plan_row_stats(const EmbedGeometry& g, int elem, RowStats* s,
                           unsigned* blocks, unsigned* threads) {
  const int k2p = (g.kh * g.kw + 3) / 4 * 4;
  const int vec = row_stats_vec(g.kh * g.kw);
  const int row_items = (g.wo + vec - 1) / vec;
  if (g.ho <= 0 || g.wo <= 0 || g.cp <= 0 || row_items > kMaxThreads) {
    return false;
  }
  const int aim = std::max(kRowStatsItems, row_items);
  for (int cwb = std::min(g.cw, std::max(1, aim / row_items));;
       cwb = (cwb + 1) / 2) {
    int rows = int(std::max<int64_t>(
        1, std::min<int64_t>(g.ho, int64_t(aim / cwb) * vec / g.wo)));
    while (rows > 1 && cwb * ((int64_t(rows) * g.wo + vec - 1) / vec) > aim) {
      --rows;
    }
    const int tiles = (g.ho + rows - 1) / rows;
    rows = (g.ho + tiles - 1) / tiles;
    const int items = int((int64_t(rows) * g.wo + vec - 1) / vec);
    const int64_t nthreads = (int64_t(cwb) * items + 31) / 32 * 32;
    const int64_t w2_stride = int64_t(g.cp) * k2p + 4;
    const int64_t w2raw = round16(cwb * w2_stride * 4);
    const int64_t wpre =
        w2raw + round16(int64_t(cwb) * g.kh * g.kw * g.cp * elem);
    // a channel's pixels of the tile, to a whole item
    const int64_t span_bytes =
        round16((int64_t(rows) * g.wo + vec - 1) / vec * vec * elem);
    for (int chunk = std::min(kRowStatsChunk, g.cp);;
         chunk = (chunk + 1) / 2) {
      const int64_t sums = wpre + kRowStatsStages * chunk * span_bytes;
      const int64_t bytes = sums + nthreads * 8;
      if (bytes > kRowStatsSmemAim && chunk > 1) continue;
      if (bytes > kMaxSmem - kStaticSmem) break;
      const int cblocks = (g.cw + cwb - 1) / cwb;
      const int64_t work = int64_t(g.n) * tiles * cblocks;
      const int most = int(std::max<int64_t>(
          1, std::min<int64_t>(kRowStatsRun, work / kRowStatsBlocks)));
      const int runs = (tiles + most - 1) / most;
      const int run = (tiles + runs - 1) / runs;
      const int64_t count = int64_t(g.n) * runs * cblocks;
      if (count > 0x7fffffff) return false;
      *s = RowStats{rows,           tiles,           cwb,
                    cblocks,        items,           chunk,
                    int(span_bytes), int(w2_stride), int(w2raw),
                    int(wpre),      int(sums),       int(bytes),
                    run,            runs};
      *blocks = unsigned(count);
      *threads = unsigned(nthreads);
      return true;
    }
    if (cwb == 1) return false;
  }
}

// partials [N, Cw, s.tiles, 2] f32: per (image, weight channel, row tile)
// the tile's sum and sum of squares of w_raw over its pixels and the K2
// taps.  A block: image n, row tiles tile0 .. tile0 + nt - 1 in turn,
// weight channels cw0 .. cw0 + s.cwb - 1; a thread item: V of a tile's
// pixels (in their order in the plane, across rows) of one weight
// channel.  w_pre [N, Cp,
// Ho, Wo]; w2 [G, Cw*K2, Cp]; b2 [G, Cw*K2] f32.  ``wpre_unit`` and
// ``w2_unit``: the staging's copy units.
template <typename T, int K2>
__global__ void __launch_bounds__(kMaxThreads)
    embed_gn_stats_rows(const T* __restrict__ w_pre, const T* __restrict__ w2,
                        const float* __restrict__ b2,
                        float* __restrict__ partials, EmbedGeometry g,
                        RowStats s, int wpre_unit, int w2_unit) {
  constexpr int V = row_stats_vec(K2);
  constexpr int K2P = (K2 + 3) / 4 * 4;
  // bytes of a load of w_pre's values: V's, at most 16
  constexpr int kLoad = V * int(sizeof(T)) < 16 ? V * int(sizeof(T)) : 16;
  extern __shared__ __align__(16) char smem[];
  float* w2f = reinterpret_cast<float*>(smem);
  float2* sums = reinterpret_cast<float2*>(smem + s.sums);
  const int hw = g.ho * g.wo;
  const int cblk = blockIdx.x % s.cblocks;
  const int rest = blockIdx.x / s.cblocks;
  const int tile0 = rest % s.runs * s.run;
  const int n = rest / s.runs, grp = n % g.groups;
  const int nt = min(s.run, s.tiles - tile0);
  const int cw0 = cblk * s.cwb;
  const int ncw = min(s.cwb, g.cw - cw0);
  const T* wp = w_pre + int64_t(n) * g.cp * hw;
  const int chunks = (g.cp + s.chunk - 1) / s.chunk;
  const int total = nt * chunks;  // (tile, chunk) steps of the walk

  // Issue step ``k`` (chunk k % chunks of the block's tile k / chunks) of
  // w_pre, its channels' pixels of the tile, into stage k %
  // kRowStatsStages: one run a channel.
  const auto issue = [&](int k) {
    const int tile = tile0 + k / chunks;
    const int c0 = (k % chunks) * s.chunk;
    const int r0 = tile * s.rows;
    const int span = min(s.rows, g.ho - r0) * g.wo;
    char* stage =
        smem + s.wpre + (k % kRowStatsStages) * s.chunk * s.span_bytes;
    copy_runs<T>(
        min(s.chunk, g.cp - c0), span, wpre_unit,
        [&](int r) { return wp + int64_t(c0 + r) * hw + int64_t(r0) * g.wo; },
        [&](int r) { return stage + r * s.span_bytes; });
  };
  // w2's rows of the block's channels, once: one run (they are contiguous
  // in w2), copied with the first step
  const T* w2b = w2 + (int64_t(grp) * g.cw + cw0) * K2 * g.cp;
  const int w2_len = ncw * K2 * g.cp;
  copy_runs<T>(
      1, w2_len, w2_unit, [&](int) { return w2b; },
      [&](int) { return smem + s.w2raw; });
#pragma unroll 1
  for (int i = 0; i < kRowStatsStages - 1; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }

  // the thread: weight channel cw0 + c, pixels p0 .. p0 + V - 1 of a tile
  const int c = threadIdx.x / s.items;
  const int p0 = (threadIdx.x - c * s.items) * V;
  const int step = s.span_bytes / int(sizeof(T));  // channel to channel
  const int lane = threadIdx.x % 32;
  // the product: f32 sums over cp = 0 .. Cp-1 in increasing order, as
  // embed_w_raw forms them, the next steps' copies in flight
  float acc[K2][V];
#pragma unroll
  for (int k = 0; k < K2; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < total; ++k) {
    cp_async_wait<kRowStatsStages - 2>();  // this step has landed
    // every thread's copies of it, and every thread is past the step
    // before, whose stage the next issue takes, and past its sums
    __syncthreads();
    if (k == 0) {
      // w2 to f32, each (channel, cp) pair's K2 values contiguous
      const T* raw = reinterpret_cast<const T*>(smem + s.w2raw);
      for (int j = threadIdx.x; j < w2_len; j += blockDim.x) {
        const int f = j / g.cp, cc = f / K2;
        w2f[cc * s.w2_stride + (j - f * g.cp) * K2P + f - cc * K2] =
            to_f32(raw[j]);
      }
      __syncthreads();
    }
    if (k + kRowStatsStages - 1 < total) issue(k + kRowStatsStages - 1);
    cp_async_commit();
    const int tile = tile0 + k / chunks, i = k % chunks;
    const int span = min(s.rows, g.ho - tile * s.rows) * g.wo;
    const bool active = c < ncw && p0 < span;
    if (active) {
      const T* a_s =
          reinterpret_cast<const T*>(smem + s.wpre + (k % kRowStatsStages) *
                                                         s.chunk *
                                                         s.span_bytes) +
          p0;
      const float* ws = w2f + c * s.w2_stride + i * s.chunk * K2P;
      const int len = min(s.chunk, g.cp - i * s.chunk);
#pragma unroll 4
      for (int cc = 0; cc < len; ++cc) {
        // V values of w_pre in one load; past the tile's pixels (its last
        // item) they are stale, and their sums are not added
        float a[V];
        load_pieces<kLoad, T, V>(a_s + cc * step, a);
        const float4* wc = reinterpret_cast<const float4*>(ws + cc * K2P);
#pragma unroll
        for (int q = 0; q < K2P / 4; ++q) {
          const float4 f = wc[q];
          const float wq[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * q + e < K2) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[4 * q + e][v] = fmaf(a[v], wq[e], acc[4 * q + e][v]);
              }
            }
          }
        }
      }
    }
    if (i == chunks - 1) {
      // the tile's w_raw: + b2, rounded to the model type and widened
      // back, as every kernel of the op forms it; the thread's sums over
      // its taps (in order) and its pixels; then a channel's items in a
      // fixed order, a warp a channel, lane l taking items l, l + 32, ...
      // in turn, then the warp's butterfly: one owner of each partial
      const int nv = min(V, span - p0);
      float s1 = 0.f, s2 = 0.f;
      if (active) {
        const float* bias = b2 + (grp * g.cw + cw0 + c) * K2;
#pragma unroll
        for (int kk = 0; kk < K2; ++kk) {
          const float bk = bias[kk];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float w = to_f32(from_f32<T>(acc[kk][v] + bk));
            if (v < nv) {
              s1 += w;
              s2 += w * w;
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < K2; ++kk) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[kk][v] = 0.f;
      }
      sums[threadIdx.x] = make_float2(s1, s2);
      __syncthreads();
      for (int cc = threadIdx.x / 32; cc < ncw; cc += blockDim.x / 32) {
        float a = 0.f, b = 0.f;
        for (int j = lane; j < s.items; j += 32) {
          const float2 v = sums[cc * s.items + j];
          a += v.x;
          b += v.y;
        }
        a = warp_sum(a);
        b = warp_sum(b);
        if (lane == 0) {
          float* out = partials +
                       ((int64_t(n) * g.cw + cw0 + cc) * s.tiles + tile) * 2;
          out[0] = a;
          out[1] = b;
        }
      }
    }
  }
}

template <typename T, int K2>
int launch_row_stats_taps(const void* w_pre, const void* w2, const void* b2,
                          void* partials, const EmbedGeometry& g,
                          const RowStats& s, unsigned blocks,
                          unsigned threads, cudaStream_t stream) {
  const auto kernel = embed_gn_stats_rows<T, K2>;
  const cudaError_t err = allow_smem(kernel, size_t(s.bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, size_t(s.bytes), stream>>>(
      static_cast<const T*>(w_pre), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(partials), g, s,
      copy_unit(w_pre, int64_t(g.wo) * int(sizeof(T))),
      copy_unit(w2, int64_t(K2) * g.cp * int(sizeof(T))));
  return int(cudaGetLastError());
}

// embed_gn_stats_rows at the instantiation of K2 (taps in registers).
template <typename T>
int launch_row_stats(const void* w_pre, const void* w2, const void* b2,
                     void* partials, const EmbedGeometry& g,
                     const RowStats& s, unsigned blocks, unsigned threads,
                     cudaStream_t stream) {
  switch (g.kh * g.kw) {
    case 9:
      return launch_row_stats_taps<T, 9>(w_pre, w2, b2, partials, g, s,
                                         blocks, threads, stream);
    case 25:
      return launch_row_stats_taps<T, 25>(w_pre, w2, b2, partials, g, s,
                                          blocks, threads, stream);
    case 49:
      return launch_row_stats_taps<T, 49>(w_pre, w2, b2, partials, g, s,
                                          blocks, threads, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The tiled routes' weight source (fwd_tiles.cuh): a thread's K*K x V
// weights formed from the 1x1 conv and normalized, by every thread of the
// block once the first stages are issued.  w_pre [N, Cp, Ho, Wo]; w2
// [G, Cw*K2, Cp]; b2, gamma, beta [G, Cw*K2] f32; partials as
// embed_gn_stats writes them, read only where a plane spans several row
// tiles.  ``scratch``: the EmbedScratch ``e`` of shared memory.
template <typename T, int KC>
struct EmbedWeights {
  static constexpr bool kLate = true;
  const T* __restrict__ w_pre;
  const T* __restrict__ w2;
  const float* __restrict__ b2;
  const float* __restrict__ gamma;
  const float* __restrict__ beta;
  const float* __restrict__ partials;
  int cp, groups, stats_tiles;
  float eps;
  EmbedScratch e;
  int wpre_unit, w2_unit;  // copy units of the staging (0: none)

  template <int KT, int V>
  __device__ __forceinline__ void form(float (&wr)[KT * KT][V],
                                       const FwdItem& it, const Geometry& g,
                                       const Tiling& t, char* scratch) const {
    const int kh = KC == 3 ? 3 : g.kh, kw = KC == 3 ? 3 : g.kw;
    const int k2 = kh * kw;
    const int k2p = (k2 + 3) / 4 * 4;  // a channel's w2 values, 16 bytes
    const int hw = g.ho * g.wo;
    const int planes = g.n * g.cw;
    float* w2f = reinterpret_cast<float*>(scratch + e.w2f);
    float2* sums = reinterpret_cast<float2*>(scratch + e.sums);
    float2* stat = sums + blockDim.x;
    const int n = it.plane / g.cw;
    const int f0 = ((n % groups) * g.cw + (it.plane - n * g.cw)) * k2;
    // the block: images img0 .. img0 + images - 1, planes plane0 .. plane0
    // + np - 1, rows r0 .. r0 + rows - 1 of its tile
    const int img0 = it.plane0 / g.cw;
    const int np = min(t.planes, planes - it.plane0);
    const int images = (it.plane0 + np - 1) / g.cw - img0 + 1;
    const int r0 = it.tile * t.rows;
    const int rows = min(t.rows, g.ho - r0);
    // w2's row of (plane, tap 0), for each of the block's planes
    __shared__ const T* w2_src[kMaxPlanes];
    if (int(threadIdx.x) < np) {
      const int plane = it.plane0 + threadIdx.x, nb = plane / g.cw;
      w2_src[threadIdx.x] =
          w2 + int64_t((nb % groups) * g.cw + plane - nb * g.cw) * k2 * cp;
    }
    __syncthreads();

    // Issue chunk ``i`` of w_pre and w2 into buffer ``buf``: w_pre's
    // channels of the tile, per image one run (whole planes: the chunk's
    // channels are contiguous) or one run a channel (a row tile); w2's
    // rows, one run per (plane, tap).
    const auto issue = [&](int i, int buf) {
      const int c0 = i * e.chunk, len = min(e.chunk, cp - c0);
      char* wpre_s = scratch + e.wpre + buf * e.wpre_buf;
      if (t.tiles == 1) {
        copy_runs<T>(
            images, len * hw, wpre_unit,
            [&](int r) { return w_pre + (int64_t(img0 + r) * cp + c0) * hw; },
            [&](int r) { return wpre_s + r * e.img_stride; });
      } else {
        copy_runs<T>(
            len, rows * g.wo, wpre_unit,
            [&](int r) {
              return w_pre + (int64_t(img0) * cp + c0 + r) * hw + r0 * g.wo;
            },
            [&](int r) { return wpre_s + r * e.span * int(sizeof(T)); });
      }
      char* w2_s = scratch + e.w2raw + buf * e.w2raw_buf;
      copy_runs<T>(
          np * k2, len, w2_unit,
          [&](int r) {
            const int pp = r / k2;
            return w2_src[pp] + int64_t(r - pp * k2) * cp + c0;
          },
          [&](int r) { return w2_s + r * e.cstride * int(sizeof(T)); });
    };

    // the product: f32 sums over cp = 0 .. Cp-1 in increasing order, the
    // next chunk's copies in flight while a chunk is summed
#pragma unroll
    for (int k = 0; k < KT * KT; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) wr[k][v] = 0.f;
    }
    const int chunks = (cp + e.chunk - 1) / e.chunk;
    issue(0, 0);
    cp_async_commit();
    for (int i = 0; i < chunks; ++i) {
      const int buf = i & 1;
      const int len = min(e.chunk, cp - i * e.chunk);
      __syncthreads();  // every thread is past chunk i - 1
      if (i + 1 < chunks) issue(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of chunk i have landed
      __syncthreads();     // and every thread's
      // w2 to f32, [plane][channel][tap]: a warp a (plane, tap) row, its
      // lanes along the channels
      const T* raw =
          reinterpret_cast<const T*>(scratch + e.w2raw + buf * e.w2raw_buf);
      for (int r = threadIdx.x / 32; r < np * k2; r += blockDim.x / 32) {
        const int pp = r / k2;
        float* to = w2f + pp * e.w2_stride + r - pp * k2;
        for (int c = threadIdx.x % 32; c < len; c += 32) {
          to[c * k2p] = to_f32(raw[r * e.cstride + c]);
        }
      }
      __syncthreads();
      if (it.active) {
        const T* wp = reinterpret_cast<const T*>(scratch + e.wpre +
                                                 buf * e.wpre_buf +
                                                 (n - img0) * e.img_stride) +
                      (it.ho - r0) * g.wo + it.wo0;
        const float* ws = w2f + it.p * e.w2_stride;
        // V values of w_pre in one load where every row and channel of the
        // stage starts on V elements (the same for the whole block), else
        // one by one
        const bool whole = it.nv == V && g.wo % V == 0 && e.span % V == 0;
#pragma unroll 4
        for (int c = 0; c < len; ++c) {
          float a[V];
          if (whole) {
            load_pieces<V * int(sizeof(T)), T, V>(wp + c * e.span, a);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              a[v] = v < it.nv ? to_f32(wp[c * e.span + v]) : 0.f;
            }
          }
          const float* wc = ws + c * k2p;
          if constexpr (KC == 3) {
            float w9[12];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const float4 f = reinterpret_cast<const float4*>(wc)[q];
              w9[4 * q] = f.x;
              w9[4 * q + 1] = f.y;
              w9[4 * q + 2] = f.z;
              w9[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int k = 0; k < 9; ++k) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                wr[k][v] = fmaf(a[v], w9[k], wr[k][v]);
              }
            }
          } else {
#pragma unroll
            for (int i2 = 0; i2 < KT; ++i2) {
#pragma unroll
              for (int j = 0; j < KT; ++j) {
                if (i2 < kh && j < kw) {
                  const float wv = wc[i2 * kw + j];
#pragma unroll
                  for (int v = 0; v < V; ++v) {
                    wr[i2 * KT + j][v] = fmaf(a[v], wv, wr[i2 * KT + j][v]);
                  }
                }
              }
            }
          }
        }
      }
    }

    // w_raw: + b2, rounded to the model type, as the conv's output would
    // be; the thread's sums of w_raw and w_raw^2 over its taps (in order)
    // and its positions
    float s1 = 0.f, s2 = 0.f;
    if (it.active) {
#pragma unroll
      for (int i = 0; i < KT; ++i) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (i < kh && j < kw) {
            const float bk = b2[f0 + i * kw + j];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float w = to_f32(from_f32<T>(wr[i * KT + j][v] + bk));
              wr[i * KT + j][v] = w;
              if (v < it.nv) {
                s1 += w;
                s2 += w * w;
              }
            }
          }
        }
      }
    }

    // the statistics of each of the block's planes: (mean, 1/std)
    const float count = float(k2) * float(hw);
    if (t.tiles == 1) {
      // whole planes: the plane's items in turn (a thread a plane), or a
      // warp a plane, lane l taking items l, l + 32, ... in turn, then the
      // warp's butterfly
      const int items = t.rows * t.q;
      if (int(threadIdx.x) < t.planes * items) {
        sums[threadIdx.x] = make_float2(s1, s2);
      }
      __syncthreads();
      const bool by_thread = items <= 64;
      const int per_sum = by_thread ? 1 : 32;
      const int lane = threadIdx.x % 32;
      for (int u = threadIdx.x / per_sum; u < t.planes;
           u += blockDim.x / per_sum) {
        const float2* src = sums + u * items;
        float a = 0.f, b = 0.f;
        for (int i = by_thread ? 0 : lane; i < items; i += per_sum) {
          a += src[i].x;
          b += src[i].y;
        }
        if (!by_thread) {
          a = warp_sum(a);
          b = warp_sum(b);
        }
        if (by_thread || lane == 0) {
          const float mean = a / count;
          const float var = fmaxf(b / count - mean * mean, 0.f);
          stat[u] = make_float2(mean, rsqrtf(var + eps));
        }
      }
    } else if (threadIdx.x < 32) {
      // one plane a block, its row tiles' sums from embed_gn_stats
      const int nb = it.plane0 / g.cw;
      stat[0] = tile_stats(
          partials + (int64_t(nb) * g.cw + it.plane0 - nb * g.cw) *
                         stats_tiles * 2,
          stats_tiles, count, eps);
    }
    __syncthreads();

    // the normalize, subtract first
    if (it.active) {
      const float2 st = stat[it.p];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (i < kh && j < kw) {
            const float sc = st.y * gamma[f0 + i * kw + j];
            const float sh = beta[f0 + i * kw + j];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              wr[i * KT + j][v] = (wr[i * KT + j][v] - st.x) * sc + sh;
            }
          }
        }
      }
    }
  }
};

// x [N, C, Hi, Wi]; out [N, C, Ho, Wo]; the rest as EmbedWeights.  KC = 3:
// K = 3 at dilation 1 and column padding 1; KC = 0: any K up to kMaxK.
template <typename T, int KC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    embed_gn_agg(const T* __restrict__ x, const T* __restrict__ w_pre,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ partials, T* __restrict__ out,
                 Geometry g, Tiling t, int cp, int groups, int stats_tiles,
                 float eps, EmbedScratch e, int wpre_unit, int w2_unit) {
  fwd_tiles<T, KC>(x, out, g, t,
                   EmbedWeights<T, KC>{w_pre, w2, b2, gamma, beta, partials,
                                       cp, groups, stats_tiles, eps, e,
                                       wpre_unit, w2_unit});
}

template <typename T, int K2, int CWB>
int launch_stats(const void* w_pre, const void* w2, const void* b2,
                 void* partials, const EmbedGeometry& g, cudaStream_t stream,
                 dim3* grid) {
  const int64_t tiles = stats_tiles(g);
  if (tiles > 0x7fffffff || g.n > 65535 || (g.cw + CWB - 1) / CWB > 65535) {
    return int(cudaErrorInvalidConfiguration);
  }
  *grid = dim3(unsigned(tiles), unsigned((g.cw + CWB - 1) / CWB),
               unsigned(g.n));
  embed_gn_stats<T, K2, CWB><<<*grid, dim3(kTilePx, CWB), 0, stream>>>(
      static_cast<const T*>(w_pre), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(partials), g);
  return int(cudaGetLastError());
}

// The pointwise route: the statistics kernel, then the pointwise
// aggregation on the same grid.
template <typename T, int K2, int CWB>
int launch_pointwise(const void* x, const void* w_pre, const void* w2,
                     const void* b2, const void* gamma, const void* beta,
                     void* partials, void* out, const EmbedGeometry& g,
                     cudaStream_t stream) {
  dim3 grid;
  const int err =
      launch_stats<T, K2, CWB>(w_pre, w2, b2, partials, g, stream, &grid);
  if (err != int(cudaSuccess)) return err;
  embed_gn_agg_pointwise<T, K2, CWB><<<grid, dim3(kTilePx, CWB), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_pre),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(partials), static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

// The statistics kernel, and with ``pointwise`` the pointwise aggregation
// after it, at the instantiation of K2: the taps live in registers, so K2
// is a template argument; CWB keeps the w2 tile in shared memory near 13 KB
// at each K2.
template <typename T>
int dispatch_taps(bool pointwise, const void* x, const void* w_pre,
                  const void* w2, const void* b2, const void* gamma,
                  const void* beta, void* partials, void* out,
                  const EmbedGeometry& g, cudaStream_t stream) {
  dim3 grid;
  switch (g.kh * g.kw) {
    case 9:
      return pointwise
                 ? launch_pointwise<T, 9, 8>(x, w_pre, w2, b2, gamma, beta,
                                             partials, out, g, stream)
                 : launch_stats<T, 9, 8>(w_pre, w2, b2, partials, g, stream,
                                         &grid);
    case 25:
      return pointwise
                 ? launch_pointwise<T, 25, 4>(x, w_pre, w2, b2, gamma, beta,
                                              partials, out, g, stream)
                 : launch_stats<T, 25, 4>(w_pre, w2, b2, partials, g, stream,
                                          &grid);
    case 49:
      return pointwise
                 ? launch_pointwise<T, 49, 2>(x, w_pre, w2, b2, gamma, beta,
                                              partials, out, g, stream)
                 : launch_stats<T, 49, 2>(w_pre, w2, b2, partials, g, stream,
                                          &grid);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The route of a launch at g: kRouteK3, kRouteGeneral or kRoutePointwise.
int embed_route(const EmbedGeometry& g, int elem) {
  return agg_route(kAggEmbed, agg_geometry(g), elem);
}

// The statistics pass of a launch: none where a block holds whole planes;
// embed_gn_stats (kTilePx-pixel tiles) on the pointwise route; where a
// tiled route's plane spans several row tiles, embed_gn_stats_rows with
// blocks ``rows``, or embed_gn_stats where that does not fit.  ``tiles``:
// the tiles of its partial sums [N, Cw, tiles, 2], 0 where it makes none.
enum StatsPass { kStatsNone, kStatsPixels, kStatsRows };
struct StatsPlan {
  StatsPass pass;
  int64_t tiles;
  RowStats rows;
  unsigned blocks, threads;
};

// The statistics pass of a tiled route at g whose aggregation takes
// ``agg_tiles`` row tiles a plane.
StatsPlan plan_stats(const EmbedGeometry& g, int elem, int agg_tiles) {
  StatsPlan p{kStatsNone, 0, {}, 0, 0};
  if (agg_tiles == 1) return p;
  if (plan_row_stats(g, elem, &p.rows, &p.blocks, &p.threads)) {
    p.pass = kStatsRows;
    p.tiles = p.rows.tiles;
  } else {
    p.pass = kStatsPixels;
    p.tiles = stats_tiles(g);
  }
  return p;
}

// The statistics pass of a launch at g (``pointwise``: of the pointwise
// route, whatever the geometry's), planned as launch_tiles plans it.
StatsPlan stats_pass(const EmbedGeometry& g, int elem, bool pointwise) {
  const StatsPlan pixels{kStatsPixels, stats_tiles(g), {}, 0, 0};
  if (int64_t(g.n) * g.cw * g.ho * g.wo == 0) {
    return StatsPlan{kStatsNone, 0, {}, 0, 0};
  }
  const int route = pointwise ? kRoutePointwise : embed_route(g, elem);
  if (route == kRoutePointwise) return pixels;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggEmbed, agg_geometry(g), elem, route == kRouteK3 ? 4 : 1,
                0, &t, &blocks, &threads, &smem)) {
    return pixels;
  }
  return plan_stats(g, elem, t.tiles);
}

// Launch the statistics pass p, into partials.
template <typename T>
int launch_stats_pass(const StatsPlan& p, const void* w_pre, const void* w2,
                      const void* b2, void* partials, const EmbedGeometry& g,
                      cudaStream_t stream) {
  switch (p.pass) {
    case kStatsNone:
      return int(cudaSuccess);
    case kStatsPixels:
      return dispatch_taps<T>(false, nullptr, w_pre, w2, b2, nullptr, nullptr,
                              partials, nullptr, g, stream);
    default:
      return launch_row_stats<T>(w_pre, w2, b2, partials, g, p.rows, p.blocks,
                                 p.threads, stream);
  }
}

// The tiled routes: where a plane spans several row tiles, the statistics
// pass first (plan_stats); then embed_gn_agg, told the pass' tiles.
template <typename T, int KC>
int launch_tiles(const void* x, const void* w_pre, const void* w2,
                 const void* b2, const void* gamma, const void* beta,
                 void* partials, void* out, const EmbedGeometry& g,
                 cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  const Geometry ag = agg_geometry(g);
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggEmbed, ag, int(sizeof(T)), V,
                copy_unit(x, int64_t(g.wi) * int(sizeof(T))), &t, &blocks,
                &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  // the staging's copy units: every run start a multiple of them (the
  // chunks start at multiples of e.chunk channels)
  EmbedScratch e;
  if (!plan_embed_scratch(ag, t, int(sizeof(T)), threads, &e)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const int64_t elem = int(sizeof(T));
  const int64_t step = std::gcd(int64_t(g.cp), int64_t(e.chunk));
  const int64_t hw = int64_t(g.ho) * g.wo;
  const int wpre_unit =
      t.tiles == 1 ? copy_unit(w_pre, step * hw * elem)
                   : copy_unit(w_pre, int64_t(g.wo) * elem);
  const int w2_unit = copy_unit(w2, step * elem);
  const StatsPlan stats = plan_stats(g, int(elem), t.tiles);
  if (stats.pass != kStatsNone) {
    if (partials == nullptr) return int(cudaErrorInvalidValue);
    const int err =
        launch_stats_pass<T>(stats, w_pre, w2, b2, partials, g, stream);
    if (err != int(cudaSuccess)) return err;
  }
  const auto kernel = embed_gn_agg<T, KC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_pre),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(partials), static_cast<T*>(out), ag, t, g.cp,
      g.groups, int(stats.tiles), g.eps, e, wpre_unit,
      w2_unit);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w_pre, const void* w2,
             const void* b2, const void* gamma, const void* beta,
             void* partials, void* out, const EmbedGeometry& g,
             cudaStream_t stream) {
  if (int64_t(g.n) * g.cw * g.ho * g.wo == 0) return int(cudaSuccess);
  // the statistics and pointwise kernels are compiled for these K*K
  const int k2 = g.kh * g.kw;
  if (k2 != 9 && k2 != 25 && k2 != 49) return int(cudaErrorInvalidValue);
  switch (embed_route(g, int(sizeof(T)))) {
    case kRouteK3:
      return launch_tiles<T, 3>(x, w_pre, w2, b2, gamma, beta, partials, out,
                                g, stream);
    case kRouteGeneral:
      return launch_tiles<T, 0>(x, w_pre, w2, b2, gamma, beta, partials, out,
                                g, stream);
    default:
      if (partials == nullptr) return int(cudaErrorInvalidValue);
      return dispatch_taps<T>(true, x, w_pre, w2, b2, gamma, beta, partials,
                              out, g, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (x, w_pre, w2, out); b2, gamma,
// beta and partials are f32.  n counts images times groups; c, cp and cw are
// per group.  partials: local_agg_embed_gn_workspace's bytes of scratch at
// pointwise 0 (null where that is 0).  kh*kw must be 9, 25 or 49.  Returns
// a cudaError_t code; 0 means every launch was accepted.
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
      return dispatch<float>(x, w_pre, w2, b2, gamma, beta, partials, out, g,
                             st);
    case 1:
      return dispatch<__half>(x, w_pre, w2, b2, gamma, beta, partials, out, g,
                              st);
    case 2:
      return dispatch<__nv_bfloat16>(x, w_pre, w2, b2, gamma, beta, partials,
                                     out, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The route a launch at this geometry runs, decided as the launcher decides
// it: 3 (k3: K = 3, dilation 1, column padding 1), 0 (general: K up to
// kMaxK) or 1 (pointwise: every geometry whose tiles do not fit).
extern "C" int local_agg_embed_gn_variant(int dtype, int n, int groups, int c,
                                          int hi, int wi, int cp, int cw,
                                          int kh, int kw, int ho, int wo,
                                          int ph, int pw, int dh, int dw) {
  const EmbedGeometry g{n,  groups, c,  hi, wi, cp, cw, kh,
                        kw, ho,     wo, ph, pw, dh, dw, 0.f};
  return embed_route(g, elem_size(dtype));
}

// The bytes of f32 scratch a launch at this geometry needs for the
// statistics kernel's partial sums [N, Cw, tiles, 2] (pointwise != 0: of
// the pointwise route's pass, whatever the geometry): 0 where the launch
// makes no statistics launch (a block holds whole planes).
extern "C" long long local_agg_embed_gn_workspace(
    int dtype, int n, int groups, int c, int hi, int wi, int cp, int cw,
    int kh, int kw, int ho, int wo, int ph, int pw, int dh, int dw,
    int pointwise) {
  const EmbedGeometry g{n,  groups, c,  hi, wi, cp, cw, kh,
                        kw, ho,     wo, ph, pw, dh, dw, 0.f};
  return 8 * int64_t(n) * cw *
         stats_pass(g, elem_size(dtype), pointwise != 0).tiles;
}

// That statistics pass alone, into partials (its tiles' floats, f32): no
// aggregation.  For checks that hold one route's statistics against
// another's.  Arguments as local_agg_embed_gn_launch takes them.
extern "C" int local_agg_embed_gn_stats_launch(
    int dtype, const void* w_pre, const void* w2, const void* b2,
    void* partials, int n, int groups, int c, int hi, int wi, int cp, int cw,
    int kh, int kw, int ho, int wo, int ph, int pw, int dh, int dw,
    int pointwise, void* stream) {
  const EmbedGeometry g{n,  groups, c,  hi, wi, cp, cw, kh,
                        kw, ho,     wo, ph, pw, dh, dw, 0.f};
  const int k2 = kh * kw;
  if (k2 != 9 && k2 != 25 && k2 != 49) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StatsPlan p = stats_pass(g, elem_size(dtype), pointwise != 0);
  switch (dtype) {
    case 0:
      return launch_stats_pass<float>(p, w_pre, w2, b2, partials, g, st);
    case 1:
      return launch_stats_pass<__half>(p, w_pre, w2, b2, partials, g, st);
    case 2:
      return launch_stats_pass<__nv_bfloat16>(p, w_pre, w2, b2, partials, g,
                                              st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
