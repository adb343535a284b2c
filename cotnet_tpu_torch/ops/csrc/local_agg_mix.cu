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
// Built by ops/_build.py with nvcc into the package's git-ignored _build/
// at their first launch:
//
//   local_agg_mix_fwd: the forward above.  One thread per x element
//     (n, c, h, w) reads x's 5x5 neighbourhood once into registers and
//     writes all 2*heads outputs of that element: x is read once for both
//     kernels, the point of the fused op.
//   local_agg_mix_dx, in gather form:
//     dx[n, c, i, j] = sum_half sum_head sum_taps
//         dy[n, (half*heads + head)*C + c, i - kh + p, j - kw + p]
//         * w_half[n, head, c % Cw, kh*K + kw, i - kh + p, j - kw + p]
//     with both halves and every head in one f32 accumulator, rounded once.
//   local_agg_mix_dw:
//     dw_half[n, head, cw, kh*K + kw, h, w] = sum_{g < C/Cw}
//         x[n, g*Cw + cw, h + kh - p, w + kw - p]
//         * dy[n, (half*heads + head)*C + g*Cw + cw, h, w]
//     every element with one owner, which sums g in order 0..G-1.
//
// Each weight (and its gradient) is a base pointer plus its taps per
// (n, head, cw) row: 9 for w1 and 25 for w2 when they are separate tensors,
// 34 for both when they are the two halves of the merged weight
// [N, heads, Cw, 9 + 25, H, W] (w2 then starts 9 planes after w1), so the
// merged op reads and writes its one buffer and copies nothing.
//
// Replaces, in cotnet_tpu/ops/local_agg_pallas.py, _mix_fwd_kernel,
// _mix_dx_kernel and _mix_dw_kernel (agg_core_pallas_mix).  Their padded
// VMEM scratch and whole-image blocks exist for the TPU; here the padding is
// zeros in shared memory or a bounds check, and every output has one
// owning thread: no atomics, and the result is deterministic.
//
// Arithmetic follows the TPU kernels: every operand widens to f32, products
// and sums are f32, each output is rounded once.
//
// Bound on this card: about one flop per byte (1.75 GFLOP against 373 MB
// at 56x56 C=64 bs128 bf16), so the least time is the bytes over the HBM
// rate; each pass touches x, w1, w2 and dy/out once.
//
// dx and dw run the halo tiles of common.cuh (route ``tiles``):
// - dw (local_agg_mix_dw) is dw's walk (dw_tiles.cuh) run once for each
//   half, in one launch with two kinds of blocks: the first ``blocks3``
//   run the K = 3 body (V = 4, 36 sums a thread) on half 0's dy and write
//   dw1, the rest a K = 5 body (V = 2, 50 sums) on half 1's and write dw2.
//   Each reads dy's half and x once, so x is read twice: about 1/7.25 of
//   the pass's bytes.  A block stages x's halo tile and dy's rows, kStages
//   groups deep, and sums the groups in order into registers; both bodies
//   run under one cap of 80 registers (blocks of at most kMixDwThreads).
// - dx (local_agg_mix_dx) is the single-K dx's walk turned to two kernel
//   sizes: a block owns (n, cw) planes and a tile of whole dx rows; a
//   thread item is V = 2 neighbouring positions of a row and keeps the
//   34 x V weights its taps read in registers (w1's 9 x V, w2's 25 x V),
//   0 outside the image, read once from device memory for the block (a
//   one-head instantiation, every main path; with heads > 1 another reads
//   them again for every channel group from L1/L2, as the single-K general
//   dx does).  For each channel group one stage holds, for every
//   head, both halves' dy halo tiles of the group's channel (the 5x5's
//   halo: 4 rows and 2 columns a side, which covers the 3x3's), between
//   zero rows and columns written once; the thread adds 9 + 25 taps a head
//   into one accumulator and stores the dx row of channel g*Cw + cw once.
//   A tap row reads the item's V + 4 dy columns in three loads of two.
// The first kernels, one thread per output (local_agg_mix_dx_pointwise,
// local_agg_mix_dw_pointwise), are the route ``pointwise`` for every
// geometry the tiles do not take: a row of more than kMaxThreads items, a
// halo tile beyond shared memory, offsets beyond 32 bits.  mix_route picks
// the route from the geometry before any launch.

#include "dw_tiles.cuh"

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

// The pointwise route of dx: one thread per dx element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_mix_dx_pointwise(const T* __restrict__ w1,
                               const T* __restrict__ w2,
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

// The pointwise route of dw: one thread per element of dw1 and dw2,
// indexed as one tensor [N, heads, Cw, 9 + 25, H, W]: tap k < 9 is dw1's,
// the rest dw2's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_mix_dw_pointwise(const T* __restrict__ x,
                               const T* __restrict__ dy,
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

// ---- the halo-tile routes --------------------------------------------------

constexpr int kMixDxVec = 2;            // dx positions of a thread item
constexpr int kMixDxTargetItems = 256;  // a dx block's thread items
constexpr int kMixMaxSources = 64;      // dy tiles of a dx stage, at most
// dw's threads a block, at most: three blocks of them on an SM hold the
// K = 5 body's 50 sums in 80 registers, which the card ran faster than 64
// (with spills) or 128 (two blocks)
constexpr int kMixDwThreads = 256;

// The weights the K x K taps (pad P = K/2) of a dx item read, of weight row
// ``wrow`` = (n * heads + head) * Cw + cw of w (``rows`` taps a row): tap
// (i, j) of position v at dy row h + P - i (window row a = i + 2 - P) and
// column col0 + v + P - j (window column e = v + P - j + 2), 0 where the
// row (bit a of rmask) or the column (bit e of cmask) is outside the image.
template <typename T, int K, int V>
__device__ __forceinline__ void mix_dx_weights(
    float (&wr)[K * K][V], const T* __restrict__ w, int64_t wrow, int rows,
    int h, int col0, unsigned rmask, unsigned cmask, int width, int hw) {
  constexpr int P = K / 2;
  const T* wp = w + wrow * rows * hw;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool row_ok = rmask >> (i + 2 - P) & 1u;
    // a row or column outside the image is masked: point at row 0,
    // column 0 instead
    const T* row_p = wp + (row_ok ? h + P - i : 0) * width;
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool valid = row_ok && (cmask >> (v + P - j + 2) & 1u);
        const float wv =
            to_f32(row_p[(i * K + j) * hw + (valid ? col0 + P + v - j : 0)]);
        wr[i * K + j][v] = valid ? wv : 0.f;
      }
    }
  }
}

// w1, w2 as the pointwise kernels take them; dy [N, 2*heads*C, H, W];
// dx [N, C, H, W].  The halo tiles of common.cuh with dx as the output and
// dy as the staged source: a plane is one (n, cw) pair; its stage holds the
// 2*heads dy tiles of the group's channel, tile (half*heads + head) of
// plane p at (sub * t.planes + p) * t.region.  Up to 128 registers: the
// thread's 68 weights stay in them through the group walk.  Two
// instantiations: ONE_HEAD (every main path) loads the weights once,
// before the walk; the other loads each head's again for every channel
// group (from L1/L2), and that code in the walk costs registers and spills
// even when it does not run, as in the single-K general dx.
template <typename T, bool ONE_HEAD>
__global__ void __launch_bounds__(kMaxThreads, 1)
    local_agg_mix_dx(const T* __restrict__ w1, const T* __restrict__ w2,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     MixGeometry g, Tiling t) {
  constexpr int V = kMixDxVec;
  constexpr int PAIRS = (V + kK2 - 1 + 1) / 2;  // V + 4 dy columns, in pairs
  const int hw = g.h * g.w;
  const int heads = ONE_HEAD ? 1 : g.heads;
  const int subs = 2 * heads;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* src[kMixMaxSources];

  // the block: planes plane0 .. plane0 + t.planes - 1 and dx rows r0 ..
  // r0 + t.rows - 1; staged row 0 is dy row ``first``, and dy's rows
  // [y_lo, y_hi) are the image's among the staged ones
  const int tile = blockIdx.x % t.tiles;
  const int plane0 = int(blockIdx.x / t.tiles) * t.planes;
  const int planes = g.n * g.cw;  // < 2^31: checked at launch
  const int r0 = tile * t.rows;
  const int first = r0 - 2;
  const int y_lo = max(0, first), y_hi = min(g.h, first + t.staged);
  // stage_rows walks every (sub, plane) tile of a stage
  Tiling ts = t;
  ts.planes = subs * t.planes;
  for (int i = threadIdx.x; i < ts.planes; i += blockDim.x) {
    // plane n * Cw + cw reads dy channels (n*2*heads + sub)*C + cw + g*Cw
    const int sub = i / t.planes;
    const int plane = plane0 + i - sub * t.planes;
    const T* ptr = nullptr;
    if (plane < planes) {
      const int n = plane / g.cw;
      ptr = dy + ((int64_t(n) * subs + sub) * g.c + (plane - n * g.cw)) * hw;
    }
    src[i] = ptr;
  }
  const int stage_bytes = ts.planes * t.region;
  zero_stages(stages, kStages * stage_bytes);

  // the thread: plane p of the block, dx row h, columns col0 .. col0 + nv - 1
  const int items = t.rows * t.q;
  const int p = threadIdx.x / items;
  const int rem = threadIdx.x - p * items;
  const int row = rem / t.q;
  const int col0 = (rem - row * t.q) * V;
  const int h = r0 + row;
  const int plane = plane0 + p;
  const bool active = p < t.planes && plane < planes && h < g.h;
  const int nv = min(V, g.w - col0);
  const int n = plane / g.cw;
  const int cw = plane - n * g.cw;
  // the item's window: dy rows h + 2 - a (a < 5) and columns col0 - 2 + e
  // (e < V + 4), each bit set where it is inside the image
  unsigned rmask = 0, cmask = 0;
  T* dxp = nullptr;
  if (active) {
#pragma unroll
    for (int a = 0; a < kK2; ++a) {
      const int y = h + 2 - a;
      if (y >= 0 && y < g.h) rmask |= 1u << a;
    }
#pragma unroll
    for (int e = 0; e < V + kK2 - 1; ++e) {
      const int col = col0 - 2 + e;
      if (col >= 0 && col < g.w) cmask |= 1u << e;
    }
    dxp = dx + (int64_t(n) * g.c + cw) * hw + h * g.w + col0;
  }
  // where window row 4 (dy row h - 2, staged row ``row``) starts, at window
  // column 0, in the plane's tile of half 0, head 0; the 5x5's tap row i
  // reads window row i, the 3x3's window row i + 1
  const int region = t.region / int(sizeof(T));
  const int base = p * region + row * t.stride + t.pl + col0 - 2;
  const int sub_step = t.planes * region;  // tile sub to sub + 1

  float w3[kTaps1][V], w5[kTaps2][V];
  if (ONE_HEAD && active) {
    mix_dx_weights<T, kK1, V>(w3, w1, plane, g.rows1, h, col0, rmask, cmask,
                              g.w, hw);
    mix_dx_weights<T, kK2, V>(w5, w2, plane, g.rows2, h, col0, rmask, cmask,
                              g.w, hw);
  }
  __syncthreads();  // src[], the zeros

  const int groups = g.c / g.cw;
  const int64_t grp_step = int64_t(g.cw) * hw;  // channel c to c + Cw
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < groups) {
      stage_rows(stages + st * stage_bytes, ts, src, st * grp_step, y_lo,
                 y_hi, first, g.w);
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
      stage_rows(stages + (ahead % kStages) * stage_bytes, ts, src,
                 ahead * grp_step, y_lo, y_hi, first, g.w);
    }
    cp_async_commit();
    if (active) {
      const T* buf =
          reinterpret_cast<const T*>(stages + (grp % kStages) * stage_bytes) +
          base;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 1
      for (int head = 0; head < heads; ++head) {
        if (!ONE_HEAD) {
          const int64_t wrow = (int64_t(n) * heads + head) * g.cw + cw;
          mix_dx_weights<T, kK1, V>(w3, w1, wrow, g.rows1, h, col0, rmask,
                                    cmask, g.w, hw);
          mix_dx_weights<T, kK2, V>(w5, w2, wrow, g.rows2, h, col0, rmask,
                                    cmask, g.w, hw);
        }
        // the 3x3 (tile ``head``): tap (i, j) of position v at window row
        // i + 1, column v + 3 - j
        const T* b3 = buf + head * sub_step + 4 * t.stride;
#pragma unroll
        for (int i = 0; i < kK1; ++i) {
          float ys[2 * PAIRS];
          load_pairs<T, PAIRS>(b3 - (i + 1) * t.stride, ys);
#pragma unroll
          for (int j = 0; j < kK1; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[v] += w3[i * kK1 + j][v] * ys[v + 3 - j];
            }
          }
        }
        // the 5x5 (tile ``heads + head``): tap (i, j) of position v at
        // window row i, column v + 4 - j
        const T* b5 = buf + (heads + head) * sub_step + 4 * t.stride;
#pragma unroll
        for (int i = 0; i < kK2; ++i) {
          float ys[2 * PAIRS];
          load_pairs<T, PAIRS>(b5 - i * t.stride, ys);
#pragma unroll
          for (int j = 0; j < kK2; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[v] += w5[i * kK2 + j][v] * ys[v + 4 - j];
            }
          }
        }
      }
      store_vec<T, V>(dxp + grp * grp_step, nv, acc);
    }
  }
}

// x [N, C, H, W]; dy [N, 2*heads*C, H, W]; dw1 / dw2 rows of rows1 / rows2
// taps.  Blocks 0 .. blocks3 - 1 run dw's K = 3 walk on half 0 (tiling t3
// of geometry g3) and write dw1; the rest its K = 5 walk on half 1 (t5,
// g5) and write dw2.  One register cap for both bodies.
template <typename T>
__global__ void __launch_bounds__(kMixDwThreads, 3)
    local_agg_mix_dw(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dw1, T* __restrict__ dw2, Geometry g3,
                     Tiling t3, Geometry g5, Tiling t5, unsigned blocks3,
                     int rows1, int rows2, int dy_unit) {
  if (blockIdx.x < blocks3) {
    dw_tiles<T, 3, false, true>(x, dy, dw1, nullptr, nullptr, nullptr,
                                nullptr, nullptr, g3, t3, dy_unit,
                                blockIdx.x, MixHalf{0, rows1});
  } else {
    dw_tiles<T, 5, false, true>(x, dy, dw2, nullptr, nullptr, nullptr,
                                nullptr, nullptr, g5, t5, dy_unit,
                                blockIdx.x - blocks3, MixHalf{1, rows2});
  }
}

// The single-K geometry of one half of the mix (K x K, SAME pad K/2).
inline Geometry half_geometry(const MixGeometry& g, int k) {
  return Geometry{g.n, g.c, g.h, g.w, g.heads, g.cw, k, k,
                  g.h, g.w, k / 2, k / 2, 1, 1};
}

// The tiling of the mix's dx at ``elem``-byte elements (``unit``: dy's
// copy unit); false where the tiles do not take the geometry.
inline bool plan_mix_dx(const MixGeometry& g, int elem, int unit, Tiling* t,
                        unsigned* blocks, unsigned* threads, size_t* smem) {
  return plan_tiles(int64_t(g.n) * g.cw, g.h, g.w, g.h, g.w, kK2 - 1, false,
                    -2, 2, elem, kMixDxVec, kMixDxTargetItems, unit, t, blocks,
                    threads, smem, 2 * g.heads) &&
         int64_t(t->planes) * 2 * g.heads <= kMixMaxSources;
}

// The tiling of the half of the mix's dw with kernel size k (``unit``: x's
// copy unit); false where dw's tiles do not take it or a block would have
// more than kMixDwThreads threads.
inline bool plan_mix_dw(const MixGeometry& g, int k, int elem, int unit,
                        Tiling* t, unsigned* blocks, unsigned* threads,
                        size_t* smem) {
  return plan_agg(kAggDw, half_geometry(g, k), elem, k == kK1 ? 4 : 2, unit,
                  t, blocks, threads, smem) &&
         *threads <= unsigned(kMixDwThreads);
}

enum MixKernel { kMixDx, kMixDw };

// The route a launch of the mix's dx or dw takes at geometry g with
// ``elem``-byte elements: kRouteMixTiles where the tiles take it (for dw,
// both halves'), else kRoutePointwise.
inline int mix_route(MixKernel kernel, const MixGeometry& g, int elem) {
  // the tiled kernels' offsets within a plane and a weight row, and their
  // plane numbers, are 32-bit
  const int64_t hw = int64_t(g.h) * g.w;
  if (hw * (kTaps1 + kTaps2) > INT_MAX ||
      int64_t(g.n) * g.heads * g.cw > INT_MAX) {
    return kRoutePointwise;
  }
  Tiling t;
  unsigned blocks3, blocks5, threads;
  size_t smem;
  const bool fits =
      kernel == kMixDx
          ? plan_mix_dx(g, elem, 0, &t, &blocks3, &threads, &smem)
          : plan_mix_dw(g, kK1, elem, 0, &t, &blocks3, &threads, &smem) &&
                plan_mix_dw(g, kK2, elem, 0, &t, &blocks5, &threads, &smem) &&
                int64_t(blocks3) + blocks5 <= 0x7fffffff;
  return fits ? kRouteMixTiles : kRoutePointwise;
}

template <typename T>
int launch_dx_tiles(const void* w1, const void* w2, const void* dy, void* dx,
                    const MixGeometry& g, cudaStream_t stream) {
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_mix_dx(g, int(sizeof(T)),
                   copy_unit(dy, int64_t(g.w) * int(sizeof(T))), &t, &blocks,
                   &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const auto kernel = g.heads == 1 ? local_agg_mix_dx<T, true>
                                    : local_agg_mix_dx<T, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(dy), static_cast<T*>(dx), g, t);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dw_tiles(const void* x, const void* dy, void* dw1, void* dw2,
                    const MixGeometry& g, cudaStream_t stream) {
  const int elem = int(sizeof(T));
  const int x_unit = copy_unit(x, int64_t(g.w) * elem);
  Tiling t3, t5;
  unsigned blocks3, blocks5, threads3, threads5;
  size_t smem3, smem5;
  if (!plan_mix_dw(g, kK1, elem, x_unit, &t3, &blocks3, &threads3, &smem3) ||
      !plan_mix_dw(g, kK2, elem, x_unit, &t5, &blocks5, &threads5, &smem5) ||
      int64_t(blocks3) + blocks5 > 0x7fffffff) {
    return int(cudaErrorInvalidConfiguration);
  }
  const size_t smem = std::max(smem3, smem5);
  const auto kernel = local_agg_mix_dw<T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks3 + blocks5, std::max(threads3, threads5), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dw1), static_cast<T*>(dw2), half_geometry(g, kK1), t3,
      half_geometry(g, kK2), t5, blocks3, g.rows1, g.rows2,
      copy_unit(dy, int64_t(g.w) * elem));
  return int(cudaGetLastError());
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

// ``pointwise``: the pointwise kernels whatever the geometry, else the route
// mix_route picks.
template <typename T>
int launch_bwd(const void* x, const void* w1, const void* w2, const void* dy,
               void* dx, void* dw1, void* dw2, const MixGeometry& g,
               bool pointwise, cudaStream_t stream) {
  const int elem = int(sizeof(T));
  if (dx != nullptr) {
    const int64_t total = int64_t(g.n) * g.c * g.h * g.w;
    if (total > 0 && !pointwise &&
        mix_route(kMixDx, g, elem) == kRouteMixTiles) {
      const int err = launch_dx_tiles<T>(w1, w2, dy, dx, g, stream);
      if (err != int(cudaSuccess)) return err;
    } else if (total > 0) {
      unsigned blocks;
      if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
      local_agg_mix_dx_pointwise<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(w1), static_cast<const T*>(w2),
          static_cast<const T*>(dy), static_cast<T*>(dx), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  if (dw1 != nullptr) {
    const int64_t total = int64_t(g.n) * g.heads * g.cw *
                          (kTaps1 + kTaps2) * g.h * g.w;
    if (total > 0 && !pointwise &&
        mix_route(kMixDw, g, elem) == kRouteMixTiles) {
      return launch_dw_tiles<T>(x, dy, dw1, dw2, g, stream);
    }
    unsigned blocks;
    if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
    if (total > 0) {
      local_agg_mix_dw_pointwise<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dw1), static_cast<T*>(dw2), g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
    }
  }
  return int(cudaSuccess);
}

int bwd(int dtype, const void* x, const void* w1, int rows1, const void* w2,
        int rows2, const void* dy, void* dx, void* dw1, void* dw2, int n,
        int c, int h, int w, int heads, int cw, bool pointwise,
        void* stream) {
  if ((dw1 == nullptr) != (dw2 == nullptr)) return int(cudaErrorInvalidValue);
  const MixGeometry g{n, c, h, w, heads, cw, rows1, rows2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, w1, w2, dy, dx, dw1, dw2, g, pointwise, st);
    case 1:
      return launch_bwd<__half>(x, w1, w2, dy, dx, dw1, dw2, g, pointwise,
                                st);
    case 2:
      return launch_bwd<__nv_bfloat16>(x, w1, w2, dy, dx, dw1, dw2, g,
                                       pointwise, st);
    default:
      return int(cudaErrorInvalidValue);
  }
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
// Each runs the route mix_route picks from the geometry.
extern "C" int local_agg_mix_bwd_launch(int dtype, const void* x,
                                        const void* w1, int rows1,
                                        const void* w2, int rows2,
                                        const void* dy, void* dx, void* dw1,
                                        void* dw2, int n, int c, int h, int w,
                                        int heads, int cw, void* stream) {
  return bwd(dtype, x, w1, rows1, w2, rows2, dy, dx, dw1, dw2, n, c, h, w,
             heads, cw, false, stream);
}

// The same on the pointwise route whatever the geometry,
// to hold the tiles against it and time them beside it.
extern "C" int local_agg_mix_bwd_pointwise_launch(
    int dtype, const void* x, const void* w1, int rows1, const void* w2,
    int rows2, const void* dy, void* dx, void* dw1, void* dw2, int n, int c,
    int h, int w, int heads, int cw, void* stream) {
  return bwd(dtype, x, w1, rows1, w2, rows2, dy, dx, dw1, dw2, n, c, h, w,
             heads, cw, true, stream);
}

// The route a dx or dw launch at this geometry runs, decided as the
// launcher decides it: 4 (tiles) or 1 (pointwise).  dtype as above.
extern "C" int local_agg_mix_dx_variant(int dtype, int n, int c, int h, int w,
                                        int heads, int cw) {
  const MixGeometry g{n, c, h, w, heads, cw, kTaps1, kTaps2};
  return mix_route(kMixDx, g, elem_size(dtype));
}

extern "C" int local_agg_mix_dw_variant(int dtype, int n, int c, int h, int w,
                                        int heads, int cw) {
  const MixGeometry g{n, c, h, w, heads, cw, kTaps1, kTaps2};
  return mix_route(kMixDw, g, elem_size(dtype));
}
