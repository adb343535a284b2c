// The K = 7 halo tiles, the ``k7`` route (common.cuh, plan_k7): the walks
// of the forward (local_agg_fwd.cu) and of dx and dw (local_agg_bwd.cu) at
// K = 7, dilation 1, column padding 3 and one head, SAN19's aggregations
// in its stages 1-4 (Cw = C/8: G = 8 channel groups share a plane's
// weights).  The forward and dx first; dw's walk, which turns the roles
// of the weight and the output round, is described where it is defined.
//
// What held the general instantiation back there (V = 1, runtime K): one
// dependent chain of 49 FMAs a thread and channel, one shared load of one
// element per FMA, and all 49 weights in registers (126-128 registers a
// thread, one block of 16 warps an SM; dx spilled them, and in general it
// reads them again for every head).  Here:
// - A block owns a tile of whole rows of one plane (n, cw), or several
//   whole planes at a small map, at most kK7Threads threads; a thread item
//   is kK7Vec = 4 neighbouring positions of one row.
// - One cp.async stage holds the halo tiles of all G <= kK7Groups channel
//   groups of the block's planes at once (x for the forward, dy for dx;
//   group-major, each staged row between zero columns, rows outside the
//   image zero rows: the zeros are written once, when the block starts), so
//   the block walks the taps and not the groups.
// - The tap rows i are the outer loop.  For row i a thread loads only that
//   row's 7 x V weights, then runs every group against them: it reads the
//   V + 6 source columns its taps share as three aligned loads of four
//   elements (column padding 3 puts column -4 of its first position on a
//   four-element boundary) and adds 7 * V products a group into G x V f32
//   accumulators: 32 independent chains, 3 shared loads per 28 FMAs, 7 x V
//   weights live instead of 49 x V.
// - The weights come in pieces of WA bytes, the widest that every thread's
//   pieces start on (w's address, a row's and a tap plane's bytes: 4
//   elements at 56x56 and 28x28, 2 at 14x14, 1 at 7x7), which the launcher
//   picks, so no load tests an address.  A piece lies wholly inside or
//   wholly outside the map's columns; one outside (or on a row outside, for
//   dx) is not read and counts 0.  The forward's four weights of a tap are
//   one to four pieces; dx's are shifted by 3 - j columns, so a tap reads
//   the pieces of a 12-column window that its four cover (two pieces at
//   four elements, one where j = 3).
// - Each weight is read from HBM once (dx's shifted ones by neighbouring
//   threads of one tile, through L1); x or dy once into shared memory (a
//   tile's 6 halo rows again, from L2); out or dx written once, rounded
//   once, in the widest stores the alignment allows.  Each output element
//   has one owner, which adds its taps in the order (i, j) of the plain
//   version: no atomics, the same bits from launch to launch.
// - The tap-row loop is not unrolled (the taps, groups and positions
//   inside a row are): 116 registers at most, no spills, four blocks of
//   kK7Threads an SM.
// Tried on an H100 (bs128 bf16, SAN19's four maps) and left out: weight
// loads that test each address's alignment (the forward took twice as
// long at 56x56 and 28x28), unrolled tap rows (128 registers, spills in
// five instantiations, slower), the next row's weights loaded ahead, two
// tiles a block, all eight groups without the test on G, and 3 or 5
// blocks an SM: each slower or spilling.

#pragma once

#include "common.cuh"

namespace {

constexpr int kK7 = 7;  // taps along each axis

// The widest piece (bytes, at most four elements) on which every thread's
// weight pieces of the k7 walks start: it divides w's address, a row's
// bytes and a tap plane's bytes (item columns are multiples of four).
inline int k7_weight_piece(const void* w, int wo, int hw, int elem) {
  int wa = 4 * elem;
  while (wa > elem &&
         (reinterpret_cast<uintptr_t>(w) % wa != 0 ||
          int64_t(wo) * elem % wa != 0 || int64_t(hw) * elem % wa != 0)) {
    wa /= 2;
  }
  return wa;
}

// Piece c of WA bytes at p (c pieces on) into v[E*c ..] widened to f32, E =
// WA / sizeof(T) elements; zeros, and no read, where ``load`` is false.
template <typename T, int WA, int N>
__device__ __forceinline__ void load_piece(const T* __restrict__ p, int c,
                                           bool load, float (&v)[N]) {
  using R = typename Raw<WA>::type;
  constexpr int E = WA / int(sizeof(T));
  R raw{};
  if (load) raw = *reinterpret_cast<const R*>(p + c * E);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < E; ++k) v[c * E + k] = to_f32(e[k]);
}

// One tap row for every group gg < groups: the 12 staged columns at buf +
// gg * group_elems (the item's column -4 onwards: three aligned loads of
// four), and acc[gg][v] += wr[j][v] times the column position v's tap j
// reads: element v + j + 1 in the forward (x column +v - 3 + j), v + 7 - j
// in dx (dy column +v + 3 - j).  j ascending, as the plain version adds
// the taps.
template <typename T, bool DX>
__device__ __forceinline__ void k7_row(float (&acc)[kK7Groups][kK7Vec],
                                       const float (&wr)[kK7][kK7Vec],
                                       const T* buf, int group_elems,
                                       int groups) {
#pragma unroll
  for (int gg = 0; gg < kK7Groups; ++gg) {
    if (gg < groups) {
      float xs[kK7Vec + 8];
      load_pieces<4 * int(sizeof(T))>(buf + gg * group_elems, xs);
#pragma unroll
      for (int j = 0; j < kK7; ++j) {
#pragma unroll
        for (int v = 0; v < kK7Vec; ++v) {
          acc[gg][v] += wr[j][v] * xs[DX ? v + kK7 - j : v + j + 1];
        }
      }
    }
  }
}

// The forward's weights of tap row i for a thread's positions: wp points
// at tap 0 of its first position, a tap ``hw`` elements from the one
// before; in pieces of WA bytes, those of the first positions that lie in
// the row (bit c of ``mask``), the rest 0; w*s + b in f32 with the affine
// (sp, bp: the plane's 49 scales and biases).
template <typename T, bool AFFINE, int WA>
__device__ __forceinline__ void fwd_k7_weights(float (&wr)[kK7][kK7Vec],
                                               const T* __restrict__ wp,
                                               const float* __restrict__ sp,
                                               const float* __restrict__ bp,
                                               int i, int hw, unsigned mask) {
  constexpr int E = WA / int(sizeof(T));
#pragma unroll
  for (int j = 0; j < kK7; ++j) {
    const int k = i * kK7 + j;
#pragma unroll
    for (int c = 0; c < kK7Vec / E; ++c) {
      load_piece<T, WA>(wp + k * hw, c, mask >> c & 1u, wr[j]);
    }
    if (AFFINE) {
      const float sk = sp[k], bk = bp[k];
#pragma unroll
      for (int v = 0; v < kK7Vec; ++v) wr[j][v] = wr[j][v] * sk + bk;
    }
  }
}

// dx's weights of tap row i for a thread's positions: position v's tap j
// reads w at row y0 - i and window column 7 - j + v, window column 0 being
// the item's column -4, where wp points on row 0 of tap 0.  The window's
// 12 columns are pieces of E = WA / sizeof(T) elements, bit c of ``mask``
// set where piece c lies inside [0, Wo); a tap reads the pieces its four
// columns cover, none on a row outside [0, ho); a weight of a piece not
// read is 0 (w*s + b in f32 with the affine for the others).
template <typename T, bool AFFINE, int WA>
__device__ __forceinline__ void dx_k7_weights(float (&wr)[kK7][kK7Vec],
                                              const T* __restrict__ wp,
                                              const float* __restrict__ sp,
                                              const float* __restrict__ bp,
                                              int i, int y0, int ho, int wo,
                                              int hw, unsigned mask) {
  constexpr int E = WA / int(sizeof(T));
  const int y = y0 - i;
  const unsigned row_mask = y >= 0 && y < ho ? mask : 0u;
#pragma unroll
  for (int j = 0; j < kK7; ++j) {
    const int k = i * kK7 + j;
    const T* rp = wp + k * hw + y * wo;
    float win[kK7Vec + 8];
#pragma unroll
    for (int c = (kK7 - j) / E; c <= (kK7 + 3 - j) / E; ++c) {
      load_piece<T, WA>(rp, c, row_mask >> c & 1u, win);
    }
    float sk = 1.f, bk = 0.f;
    if (AFFINE) {
      sk = sp[k];
      bk = bp[k];
    }
#pragma unroll
    for (int v = 0; v < kK7Vec; ++v) {
      const float wv = win[kK7 - j + v];
      wr[j][v] = AFFINE ? (row_mask >> ((kK7 - j + v) / E) & 1u ? wv * sk + bk
                                                                : 0.f)
                        : wv;
    }
  }
}

// Piece c of WA bytes of v (E = WA / sizeof(T) elements from v[E*c]),
// rounded to T, to p + c * E; nothing where ``store`` is false.
template <typename T, int WA, int N>
__device__ __forceinline__ void store_piece(T* __restrict__ p, int c,
                                            bool store, const float (&v)[N]) {
  using R = typename Raw<WA>::type;
  constexpr int E = WA / int(sizeof(T));
  if (!store) return;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < E; ++k) e[k] = from_f32<T>(v[c * E + k]);
  *reinterpret_cast<R*>(p + c * E) = raw;
}

// A second source of a stage, after the first's halo tile (dw's dy rows):
// rows [lo, hi) of src's planes, a group ``step`` elements from the one
// before, each of ``width`` elements, staged row 0 being source row lo at
// staged row t.staged, with no zero columns before them, copied in units
// of ``unit`` bytes.
template <typename T>
struct K7Rows {
  const T* const* src;
  int64_t step;
  int lo, hi, width, unit;
};

// The tile's staged source, common to the walks: source rows [lo, hi) of
// the image, staged row 0 being source row ``first``, all G groups of the
// block's planes; src[p] is plane p's group-0 source (null past the last
// plane), a group ``step`` elements from the one before; then, in each
// group's stage, ``more``'s rows where it is given.  Zeros first, then one
// cp.async group, committed.
template <typename T>
__device__ __forceinline__ void stage_all_groups(
    char* stages, const Tiling& t, const T* const* src, int groups,
    int64_t step, int lo, int hi, int first, int width,
    const K7Rows<T>* more = nullptr) {
  const int stage_bytes = t.planes * t.region;
  zero_stages(stages, groups * stage_bytes);
  __syncthreads();  // src[], the zeros
#pragma unroll 1
  for (int gg = 0; gg < groups; ++gg) {
    char* buf = stages + gg * stage_bytes;
    stage_rows(buf, t, src, gg * step, lo, hi, first, width);
    if (more != nullptr) {
      Tiling tm = t;
      tm.pl = 0;
      tm.unit = more->unit;
      stage_rows(buf + t.staged * t.stride * int(sizeof(T)), tm, more->src,
                 gg * more->step, more->lo, more->hi, more->lo, more->width);
    }
  }
  cp_async_commit();
}

// A block of the walks: planes plane0 .. plane0 + t.planes - 1 of the
// planes (n, cw), rows r0 .. r0 + t.rows - 1 of what it writes.
struct K7Block {
  int plane0, planes, r0;
};

__device__ __forceinline__ K7Block k7_block(const Geometry& g,
                                            const Tiling& t) {
  const int tile = blockIdx.x % t.tiles;
  // planes < 2^31: checked at launch
  return {int(blockIdx.x / t.tiles) * t.planes, g.n * g.cw, tile * t.rows};
}

// src[p]: the group-0 channel of the block's plane p in ``base``, a
// tensor [N, C, hw] (null past the last plane); the same in base2 (hw2
// elements a channel) into src2 where it is given.
template <typename T>
__device__ __forceinline__ void k7_sources(const Geometry& g,
                                           const K7Block& b,
                                           const Tiling& t, const T** src,
                                           const T* base, int hw,
                                           const T** src2 = nullptr,
                                           const T* base2 = nullptr,
                                           int hw2 = 0) {
  if (threadIdx.x < t.planes) {
    const int plane = b.plane0 + threadIdx.x;
    const T* sp = nullptr;
    const T* sp2 = nullptr;
    if (plane < b.planes) {
      const int n = plane / g.cw;
      const int64_t ch = int64_t(n) * g.c + (plane - n * g.cw);
      sp = base + ch * hw;
      if (src2 != nullptr) sp2 = base2 + ch * hw2;
    }
    src[threadIdx.x] = sp;
    if (src2 != nullptr) src2[threadIdx.x] = sp2;
  }
}

// A thread's item: plane p of the block (``plane``), row r0 + ``row`` of a
// rows x cols output, its nv <= kK7Vec positions from column col0;
// ``active`` where it has any.
struct K7Item {
  int p, row, col0, plane, nv;
  bool active;
};

__device__ __forceinline__ K7Item k7_item(const K7Block& b, const Tiling& t,
                                          int rows, int cols) {
  const int items = t.rows * t.q;
  const int p = threadIdx.x / items;
  const int rem = threadIdx.x - p * items;
  const int row = rem / t.q;
  const int col0 = (rem - row * t.q) * kK7Vec;
  const int plane = b.plane0 + p;
  return {p, row, col0, plane, min(kK7Vec, cols - col0),
          p < t.planes && plane < b.planes && b.r0 + row < rows};
}

// The pieces of E elements of an item's positions that lie in its row
// (bit c for piece c; the row's width is a multiple of E, so a piece is
// wholly inside or outside).
template <int E>
__device__ __forceinline__ unsigned k7_row_pieces(int nv) {
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < kK7Vec / E; ++c) {
    if (c * E < nv) mask |= 1u << c;
  }
  return mask;
}

// The forward: x [N, C, Hi, Wi]; w [N, 1, Cw, 49, Ho, Wo]; s, b [N, 1, Cw,
// 49] f32 (AFFINE only); out [N, C, Ho, Wo].  A plane is (n, cw).  WA:
// the weight pieces' bytes (k7_weight_piece).
template <typename T, bool AFFINE, int WA>
__device__ __forceinline__ void fwd_k7_tiles(const T* __restrict__ x,
                                             const T* __restrict__ w,
                                             const float* __restrict__ s,
                                             const float* __restrict__ b,
                                             T* __restrict__ out,
                                             const Geometry& g,
                                             const Tiling& t) {
  constexpr int V = kK7Vec;
  constexpr int E = WA / int(sizeof(T));
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;
  const int groups = g.c / g.cw;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* src[kMaxPlanes];

  // the block's output rows; staged row 0 is x row ``first``
  const K7Block blk = k7_block(g, t);
  const int first = blk.r0 - g.ph;
  k7_sources(g, blk, t, src, x, hw_in);
  stage_all_groups(stages, t, src, groups, int64_t(g.cw) * hw_in,
                   max(0, first), min(g.hi, first + t.staged), first, g.wi);

  // the thread: output row ho, positions wo0 .. wo0 + nv - 1
  const K7Item it = k7_item(blk, t, g.ho, g.wo);
  const int p = it.p, row = it.row, wo0 = it.col0, plane = it.plane;
  const int ho = blk.r0 + row;
  const int nv = it.nv;
  cp_async_wait<0>();
  __syncthreads();
  if (!it.active) return;

  // the weight pieces of the positions inside the row
  const unsigned mask = k7_row_pieces<E>(nv);
  const T* wp = w + int64_t(plane) * (kK7 * kK7) * hw_out + ho * g.wo + wo0;
  const float* sp = AFFINE ? s + int64_t(plane) * (kK7 * kK7) : nullptr;
  const float* bp = AFFINE ? b + int64_t(plane) * (kK7 * kK7) : nullptr;
  // column wo0 - 4 of x row ho - ph (tap row 0) in plane p's group-0 stage
  const T* buf = reinterpret_cast<const T*>(stages) +
                 p * (t.region / int(sizeof(T))) + row * t.stride + t.pl +
                 wo0 - 4;
  const int group_elems = t.planes * t.region / int(sizeof(T));
  float acc[kK7Groups][V];
#pragma unroll
  for (int gg = 0; gg < kK7Groups; ++gg) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[gg][v] = 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < kK7; ++i) {
    float wr[kK7][V];
    fwd_k7_weights<T, AFFINE, WA>(wr, wp, sp, bp, i, hw_out, mask);
    k7_row<T, false>(acc, wr, buf + i * t.stride, group_elems, groups);
  }
  T* op = out + (int64_t(plane / g.cw) * g.c + plane % g.cw) * hw_out +
          ho * g.wo + wo0;
#pragma unroll
  for (int gg = 0; gg < kK7Groups; ++gg) {
    if (gg < groups) {
      store_vec<T, V>(op + gg * int64_t(g.cw) * hw_out, nv, acc[gg]);
    }
  }
}

// dx: w [N, 1, Cw, 49, Ho, Wo]; s, b [N, 1, Cw, 49] f32 (AFFINE only); dy
// [N, C, Ho, Wo]; dx [N, C, Hi, Wi].  A plane is (n, cw); tap (i, j) of dx
// position (h, col) reads dy and w at (h + ph - i, col + 3 - j).  WA: the
// weight pieces' bytes (k7_weight_piece).
template <typename T, bool AFFINE, int WA>
__device__ __forceinline__ void dx_k7_tiles(const T* __restrict__ w,
                                            const float* __restrict__ s,
                                            const float* __restrict__ b,
                                            const T* __restrict__ dy,
                                            T* __restrict__ dx,
                                            const Geometry& g,
                                            const Tiling& t) {
  constexpr int V = kK7Vec;
  constexpr int E = WA / int(sizeof(T));
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;
  const int groups = g.c / g.cw;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* src[kMaxPlanes];

  // the block's dx rows; staged row 0 is dy row ``first``
  const K7Block blk = k7_block(g, t);
  const int first = blk.r0 + g.ph - (kK7 - 1);
  k7_sources(g, blk, t, src, dy, hw_out);
  stage_all_groups(stages, t, src, groups, int64_t(g.cw) * hw_out,
                   max(0, first), min(g.ho, first + t.staged), first, g.wo);

  // the thread: dx row h, columns col0 .. col0 + nv - 1
  const K7Item it = k7_item(blk, t, g.hi, g.wi);
  const int p = it.p, row = it.row, col0 = it.col0, plane = it.plane;
  const int h = blk.r0 + row;
  const int nv = it.nv;
  cp_async_wait<0>();
  __syncthreads();
  if (!it.active) return;

  // the window's pieces (columns col0 - 4 .. col0 + 7) inside [0, Wo) (Wo
  // is a multiple of E, so a piece is wholly inside or outside)
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < (V + 8) / E; ++c) {
    const int col = col0 - 4 + c * E;
    if (col >= 0 && col < g.wo) mask |= 1u << c;
  }
  const T* wp = w + int64_t(plane) * (kK7 * kK7) * hw_out + col0 - 4;
  const float* sp = AFFINE ? s + int64_t(plane) * (kK7 * kK7) : nullptr;
  const float* bp = AFFINE ? b + int64_t(plane) * (kK7 * kK7) : nullptr;
  // column col0 - 4 of dy row h + ph (tap row 0) in plane p's group-0
  // stage; tap row i is i rows above it
  const T* buf = reinterpret_cast<const T*>(stages) +
                 p * (t.region / int(sizeof(T))) +
                 (row + kK7 - 1) * t.stride + t.pl + col0 - 4;
  const int group_elems = t.planes * t.region / int(sizeof(T));
  float acc[kK7Groups][V];
#pragma unroll
  for (int gg = 0; gg < kK7Groups; ++gg) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[gg][v] = 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < kK7; ++i) {
    float wr[kK7][V];
    dx_k7_weights<T, AFFINE, WA>(wr, wp, sp, bp, i, h + g.ph, g.ho, g.wo,
                                 hw_out, mask);
    k7_row<T, true>(acc, wr, buf - i * t.stride, group_elems, groups);
  }
  T* dxp = dx + (int64_t(plane / g.cw) * g.c + plane % g.cw) * hw_in +
           h * g.wi + col0;
#pragma unroll
  for (int gg = 0; gg < kK7Groups; ++gg) {
    if (gg < groups) {
      store_vec<T, V>(dxp + gg * int64_t(g.cw) * hw_in, nv, acc[gg]);
    }
  }
}

// dw: x [N, C, Hi, Wi]; dy [N, C, Ho, Wo]; dw [N, 1, Cw, 49, Ho, Wo].  A
// plane is (n, cw); tap (i, j) of position (ho, wo) sums, over the groups
// in order, x at (ho - ph + i, wo - 3 + j) times dy at (ho, wo).
// Its bound is the bytes it writes: dw is 49 / (2G) times as large as x
// and dy together (about 3 / 4 of the bytes at G = 8).  What held the
// general instantiation back (V = 1): 49 f32 sums a thread under
// __launch_bounds__(kMaxThreads, 1), one shared load of one x element per
// FMA, and 49 stores of one element a thread at the end.  Here:
// - The forward's blocks and thread items (plan_k7: a tile of whole rows
//   of one plane or whole planes, V = kK7Vec positions a thread item).
// - One cp.async stage holds, for every group and plane, x's halo tile
//   and then dy's rows of the tile (no zero columns before them, copied
//   in units of ``dy_unit`` bytes), so the block walks the tap rows.
// - The tap rows i are the outer loop, not unrolled.  For row i a thread
//   keeps 7 x V f32 sums; for each group in order it reads its V dy values
//   (one aligned load) and the V + 6 x columns of row ho - ph + i (three
//   aligned loads of four, as k7_row) and adds 7 * V products.  After the
//   last group it rounds row i's 7 tap planes' V values once and stores
//   them, so the stores of one row overlap the sums of the next.
// - dw is stored in pieces of WA bytes, the widest that every thread's
//   pieces start on (dw's address, a row's and a tap plane's bytes: the
//   forward's weight rule, k7_weight_piece, on dw); a piece lies wholly
//   inside or outside the row, one outside is not stored.  Neighbouring
//   threads store neighbouring pieces of a tap plane's row.
// - Each byte of x and dy is read from HBM once (a tile's 6 halo rows
//   again, from L2), each dw element written once by its one owner, which
//   adds the groups in a fixed order, g = 0..G-1: no atomics, the same
//   bits from launch to launch.
template <typename T, int WA>
__device__ __forceinline__ void dw_k7_tiles(const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            T* __restrict__ dw,
                                            const Geometry& g,
                                            const Tiling& t, int dy_unit) {
  constexpr int V = kK7Vec;
  constexpr int E = WA / int(sizeof(T));
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;
  const int groups = g.c / g.cw;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* x_src[kMaxPlanes];
  __shared__ const T* dy_src[kMaxPlanes];

  // the block's rows; staged row 0 is x row ``first``, dy's rows of the
  // tile follow x's halo tile at staged row t.staged
  const K7Block blk = k7_block(g, t);
  const int first = blk.r0 - g.ph;
  k7_sources(g, blk, t, x_src, x, hw_in, dy_src, dy, hw_out);
  const K7Rows<T> dy_rows{dy_src, int64_t(g.cw) * hw_out, blk.r0,
                          min(g.ho, blk.r0 + t.rows), g.wo, dy_unit};
  stage_all_groups(stages, t, x_src, groups, int64_t(g.cw) * hw_in,
                   max(0, first), min(g.hi, first + t.staged), first, g.wi,
                   &dy_rows);

  // the thread: row ho, positions wo0 .. wo0 + nv - 1
  const K7Item it = k7_item(blk, t, g.ho, g.wo);
  const int p = it.p, row = it.row, wo0 = it.col0, plane = it.plane;
  const int ho = blk.r0 + row;
  cp_async_wait<0>();
  __syncthreads();
  if (!it.active) return;

  // the store pieces of the positions inside the row
  const unsigned mask = k7_row_pieces<E>(it.nv);
  // column wo0 - 4 of x row ho - ph (tap row 0), and dy at (ho, wo0), in
  // plane p's group-0 stage
  const T* xb = reinterpret_cast<const T*>(stages) +
                p * (t.region / int(sizeof(T))) + row * t.stride + t.pl +
                wo0 - 4;
  const T* yb = reinterpret_cast<const T*>(stages) +
                p * (t.region / int(sizeof(T))) +
                (t.staged + row) * t.stride + wo0;
  const int group_elems = t.planes * t.region / int(sizeof(T));
  T* dwp = dw + int64_t(plane) * (kK7 * kK7) * hw_out + ho * g.wo + wo0;
#pragma unroll 1
  for (int i = 0; i < kK7; ++i) {
    float acc[kK7][V];
#pragma unroll
    for (int j = 0; j < kK7; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
    }
#pragma unroll
    for (int gg = 0; gg < kK7Groups; ++gg) {
      if (gg < groups) {
        float ys[V], xs[V + 8];
        load_pieces<V * int(sizeof(T))>(yb + gg * group_elems, ys);
        load_pieces<4 * int(sizeof(T))>(
            xb + gg * group_elems + i * t.stride, xs);
#pragma unroll
        for (int j = 0; j < kK7; ++j) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j][v] += xs[v + j + 1] * ys[v];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kK7; ++j) {
#pragma unroll
      for (int c = 0; c < V / E; ++c) {
        store_piece<T, WA>(dwp + (i * kK7 + j) * hw_out, c, mask >> c & 1u,
                           acc[j]);
      }
    }
  }
}

}  // namespace
