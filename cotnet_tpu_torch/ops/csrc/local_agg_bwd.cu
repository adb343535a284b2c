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
// writes ds and db.  At cotnet50's 56x56 C=64 Cw=8 bs128 bf16 dx's bound is
// 0.0479 ms (w 57.8 MB, dy 51.4 MB, dx 51.4 MB).
//
// dx (the halo tiles of common.cuh; the forward's scheme turned round, each
// byte of w, dy and dx read or written from HBM once):
// - A block owns one (n, cw) pair, the "plane" whose G = C/Cw channels
//   c = cw + g*Cw share the weights of channel cw, and a tile of whole dx
//   rows (at most kTargetItems thread items), or at small maps several
//   planes.
// - A thread item is V neighbouring dx positions of one row.  Tap (i, j)
//   of position q reads w and dy at q + (ph - i*dh, pw - j*dw).  The thread
//   reads those shifted weights once (neighbouring threads and tiles share
//   them through L1 and L2), forms w*s + b in f32 once per weight with the
//   affine, 0 where the tap falls outside [0, Ho) x [0, Wo), and keeps them
//   in registers.
// - For each channel group (and head) the block stages dy's halo tile (the
//   tile's rows plus (K-1)*dh, the whole width) in shared memory between
//   zero columns and zero rows, with cp.async in the widest unit the rows
//   allow, kStages deep; it sums the taps into one f32 accumulator per
//   position across heads and taps, and stores the dx row of channel
//   g*Cw + cw once, rounded once, in the widest stores the alignment
//   allows.  At K = 3 a thread reads its V + 2 columns of a row in
//   (V + 4) / 2 shared loads of two elements.
// - Two instantiations, as the forward's: K = 3 at dilation 1, column
//   padding 1 and one head, V = 4, compile-time and unrolled (every main
//   path), and a general one (runtime K <= kMaxK, dilation, padding, heads;
//   V = 1), which reads the weights of each head again for every channel
//   group.
// dw (the halo tiles of common.cuh; the forward's design with the roles of
// the weight and the output swapped, each byte of x (per head), dy and dw
// read or written from HBM once):
// - A block owns one (n, head, cw) plane, whose dw rows sum the G = C/Cw
//   channels c = cw + g*Cw, and a tile of whole rows of it (at most
//   kDwTargetItems thread items, twice the forward's: a whole 28x28 plane),
//   or at small maps several planes: the forward's tiling, source x with
//   its halo.
// - A thread item is V neighbouring positions of one row.  It keeps the
//   K*K x V f32 sums of its dw elements in registers (36 at K = 3, V = 4:
//   the count of weights the forward holds there).
// - The block walks the G groups in order.  For each it stages x's halo
//   tile and dy's rows of the tile (no halo) in one cp.async stage,
//   kStages deep, between the zero columns and zero rows written once; a
//   thread reads its V dy values and, tap row by tap row, its x columns,
//   and adds x * dy, both widened to f32, to each tap's sums.
// - At the end each of the K*K rows of the thread's positions is stored
//   once, rounded once, in the widest stores the alignment allows.  Every
//   dw element has one owner, which sums the groups in order g = 0..G-1 as
//   the pointwise kernel does: no atomics, deterministic.
// - The same two instantiations as the forward (K = 3 at dilation 1 and
//   column padding 1, V = 4, held to 64 registers; general, V = 1).
// dx and dw each have a third route for the geometries their tiles do not
// take (K > kMaxK, a row of more than kMaxThreads items, a halo tile beyond
// shared memory): one thread per output element, the fastest-varying index
// on the thread index, the taps read through L1/L2 with no limit on K,
// width or dilation (local_agg_bwd_dx_pointwise, local_agg_bwd_dw_pointwise).
// The launcher picks the route from the geometry before it launches
// (agg_route, common.cuh) and launches exactly that kernel; so does the
// affine dw's.
// The affine dw (local_agg_bwd_dw_affine, dw, ds and db in one pass) runs
// dw's halo tiles, its group walk and its K*K x V sums; only the store
// differs (dw_affine_epilogue).  For each tap a thread reads its V values
// of w, stores dw = gn * s once and forms its partial sums of gn * w and
// gn; the block sums those by (plane, tap) in a fixed order through the
// shared memory the stages free.  kStages - 1 groups before the last, the
// block asks L2 for its w rows (prefetch.global.L2), so the epilogue's
// loads of w wait less (staging w in shared memory by cp.async instead
// kept more registers live through the group walk, spilled, and the card
// ran it slower).  ds and db sum over a whole plane, and at
// large maps a plane spans several row tiles (4 at 56x56): then each block
// writes its partial sums to a workspace [tiles, planes, K*K] of float2 and
// a second kernel, local_agg_bwd_dw_affine_sums, adds the tiles in order
// 0..tiles-1 (at 28x28 and below a block holds whole planes and writes ds
// and db itself).  The workspace is the caller's (PyTorch's allocator);
// local_agg_bwd_dw_affine_workspace gives its size.  No atomics: the result
// is the same bits from run to run.  Bound as dw's, plus one read of w and
// s and the writes of ds and db.  Its third route,
// local_agg_bwd_dw_affine_pointwise (the first design, one block per (n, head,
// cw, tap) row of ds and db, its threads striding over the row's positions
// and reading x and dy through L1/L2 for each tap), takes what dw's tiles
// do not.  Left for later: one launch that reads dy once for dx and dw.

#include "common.cuh"

namespace {

// The weights that the taps of a dx item read, of weight channel wc: tap
// (i, j) of position v at dy row y0 - i*dh and column c0 + e*step (e = v +
// KT-1 - j at K = 3, e = j in general), 0 where the row (bit i of rmask) or
// the column (bit e of cmask) falls outside [0, Ho) x [0, Wo); w*s + b in
// f32 with the affine.
template <typename T, bool AFFINE, int KC, int KT, int V>
__device__ __forceinline__ void dx_weights(
    float (&wr)[KT * KT][V], const T* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ b, int64_t wc,
    int kh, int kw, int dh, int y0, int c0, int step, unsigned rmask,
    unsigned cmask, int wo, int hw) {
  const int k2 = kh * kw;
  const T* wp = w + wc * k2 * hw;
#pragma unroll
  for (int i = 0; i < KT; ++i) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (i < kh && j < kw) {
        const int k = i * kw + j;
        // a row outside [0, Ho) is masked: point at row 0 instead
        const T* row_p = wp + k * hw + (rmask >> i & 1u ? y0 - i * dh : 0) * wo;
        float sk = 1.f, bk = 0.f;
        if (AFFINE) {
          sk = s[wc * k2 + k];
          bk = b[wc * k2 + k];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int e = KC == 3 ? v + KT - 1 - j : j;
          const bool valid = (rmask >> i & 1u) && (cmask >> e & 1u);
          const float wv = to_f32(row_p[valid ? c0 + e * step : 0]);
          wr[i * KT + j][v] = valid ? (AFFINE ? wv * sk + bk : wv) : 0.f;
        }
      }
    }
  }
}

// w [N, heads, Cw, Kh*Kw, Ho, Wo]; s, b [N, heads, Cw, Kh*Kw] f32 (AFFINE
// only); dy [N, heads*C, Ho, Wo]; dx [N, C, Hi, Wi].  The halo tiles of
// common.cuh, with dx as the output and dy as the staged source: a plane is
// one (n, cw) pair, whose G = C/Cw channels c = cw + g*Cw share its weights.
// KC = 3: K = 3 at dilation 1; KC = 0: any K up to kMaxK.  The K = 3
// instantiation is held to 64 registers (two blocks of kMaxThreads): its
// blocks have at most kTargetItems threads, so eight fit on an SM, and the
// card ran it faster than with more registers and fewer blocks.
template <typename T, bool AFFINE, int KC>
__global__ void __launch_bounds__(kMaxThreads, KC == 3 ? 2 : 1)
    local_agg_bwd_dx(const T* __restrict__ w, const float* __restrict__ s,
                     const float* __restrict__ b, const T* __restrict__ dy,
                     T* __restrict__ dx, Geometry g, Tiling t) {
  constexpr int KT = KC == 3 ? 3 : kMaxK;        // taps unrolled per axis
  constexpr int V = KC == 3 ? 4 : 1;             // positions of an item
  constexpr int NE = KC == 3 ? V + KT - 1 : KT;  // dy columns an item reads
  const int kh = KC == 3 ? 3 : g.kh, kw = KC == 3 ? 3 : g.kw;
  const int dh = KC == 3 ? 1 : g.dh, dw = KC == 3 ? 1 : g.dw;
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* src[kMaxPlanes];

  // the block: planes plane0 .. plane0 + t.planes - 1 and dx rows r0 ..
  // r0 + t.rows - 1; staged row 0 is dy row ``first``, and dy's rows
  // [y_lo, y_hi) are the image's among the staged ones
  const int tile = blockIdx.x % t.tiles;
  const int plane0 = int(blockIdx.x / t.tiles) * t.planes;
  const int planes = g.n * g.cw;  // < 2^31: checked at launch
  const int r0 = tile * t.rows;
  const int first = r0 + g.ph - (kh - 1) * dh;
  const int y_lo = max(0, first), y_hi = min(g.ho, first + t.staged);
  if (threadIdx.x < t.planes) {
    // plane n * Cw + cw reads dy channels (n*heads + head)*C + cw + g*Cw
    const int plane = plane0 + threadIdx.x;
    const T* p = nullptr;
    if (plane < planes) {
      const int n = plane / g.cw;
      p = dy + (int64_t(n) * g.heads * g.c + (plane - n * g.cw)) * hw_out;
    }
    src[threadIdx.x] = p;
  }
  zero_stages(stages, kStages * t.planes * t.region);

  // the thread: plane p of the block, dx row h, columns col0 .. col0 + nv - 1
  const int items = t.rows * t.q;
  const int p = threadIdx.x / items;
  const int rem = threadIdx.x - p * items;
  const int row = rem / t.q;
  const int col0 = (rem - row * t.q) * V;
  const int h = r0 + row;
  const int plane = plane0 + p;
  const bool active = p < t.planes && plane < planes && h < g.hi;
  const int nv = min(V, g.wi - col0);
  const int n = plane / g.cw;
  const int cw = plane - n * g.cw;
  // tap (i, j) of position v reads dy and w at row h + ph - i*dh and column
  // col0 + v + pw - j*dw: item column e is c0 + e * step, tap (j, v) at
  // e = v + KT-1 - j (K = 3) or e = j (general)
  const int c0 = KC == 3 ? col0 + g.pw - (KT - 1) : col0 + g.pw;
  const int step = KC == 3 ? 1 : -dw;
  unsigned rmask = 0, cmask = 0;
  T* dxp = nullptr;
  if (active) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int y = h + g.ph - i * dh;
      if (i < kh && y >= 0 && y < g.ho) rmask |= 1u << i;
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int col = c0 + e * step;
      if ((KC == 3 || e < kw) && col >= 0 && col < g.wo) cmask |= 1u << e;
    }
    dxp = dx + (int64_t(n) * g.c + cw) * hw_in + h * g.wi + col0;
  }
  // where item column 0 of tap row 0 reads in the plane's stage
  const int base = p * (t.region / int(sizeof(T))) +
                   (row + (kh - 1) * dh) * t.stride + t.pl + c0;

  float wr[KT * KT][V];
  if (active && g.heads == 1) {
    dx_weights<T, AFFINE, KC, KT, V>(wr, w, s, b, plane, kh, kw, dh,
                                      h + g.ph, c0, step, rmask, cmask, g.wo,
                                      hw_out);
  }
  __syncthreads();  // src[], the zeros

  // stage st is channel group st / heads of head st % heads
  const int groups = g.c / g.cw;
  const int count = groups * g.heads;
  const int64_t head_step = int64_t(g.c) * hw_out;  // dy channel c to c + C
  const int64_t grp_step = int64_t(g.cw) * hw_out;  // ... to c + Cw
  const int64_t dx_step = int64_t(g.cw) * hw_in;
  const int stage_bytes = t.planes * t.region;
#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < count) {
      const int grp = st / g.heads;
      stage_rows(stages + st * stage_bytes, t, src,
                 grp * grp_step + (st - grp * g.heads) * head_step, y_lo,
                 y_hi, first, g.wo);
    }
    cp_async_commit();
  }
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 1
  for (int st = 0; st < count; ++st) {
    const int grp = st / g.heads, head = st - grp * g.heads;
    if (KC == 0 && active && g.heads > 1) {
      dx_weights<T, AFFINE, KC, KT, V>(
          wr, w, s, b, (int64_t(n) * g.heads + head) * g.cw + cw, kh, kw, dh,
          h + g.ph, c0, step, rmask, cmask, g.wo, hw_out);
    }
    cp_async_wait<kStages - 2>();  // this stage has landed
    // every thread is past the previous stage's sum, so its buffer is free
    __syncthreads();
    const int ahead = st + kStages - 1;
    if (ahead < count) {
      const int agrp = ahead / g.heads;
      stage_rows(stages + (ahead % kStages) * stage_bytes, t, src,
                 agrp * grp_step + (ahead - agrp * g.heads) * head_step,
                 y_lo, y_hi, first, g.wo);
    }
    cp_async_commit();
    if (active) {
      const T* buf =
          reinterpret_cast<const T*>(stages + (st % kStages) * stage_bytes) +
          base;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        if (i < kh) {
          const T* rp = buf - i * dh * t.stride;
          // K = 3: the item's V + 2 columns from the even one before them
          // (pad 1 makes ``buf`` odd), in V/2 + 2 loads of two
          float ys[KC == 3 ? NE + 2 : NE];
          if constexpr (KC == 3) {
            load_pairs<T, V / 2 + 2>(rp - 1, ys);
          } else {
#pragma unroll
            for (int e = 0; e < NE; ++e) {
              ys[e] = e < kw ? to_f32(rp[e * step]) : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j < kw) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[v] += wr[i * KT + j][v] *
                          ys[KC == 3 ? v + KT - j : j];
              }
            }
          }
        }
      }
      if (head == g.heads - 1) {
        store_vec<T, V>(dxp + grp * dx_step, nv, acc);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0.f;
      }
    }
  }
}

// The pointwise route of dx, for the geometries the tiles do not take.  w,
// s, b, dy, dx as above; one thread per dx element.
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dx_pointwise(const T* __restrict__ w,
                               const float* __restrict__ s,
                               const float* __restrict__ b,
                               const T* __restrict__ dy, T* __restrict__ dx,
                               Geometry g) {
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

// x [N, C, Hi, Wi]; dy [N, heads*C, Ho, Wo];
// dw [N, heads, Cw, Kh*Kw, Ho, Wo].  The halo tiles of common.cuh with the
// forward's planes and tiles (source x, halo included), a stage holding
// dy's rows of the tile besides, after x's halo tile, copied in units of
// ``dy_unit`` bytes.  KC = 3: K = 3 at dilation 1; KC = 0: any K up to
// kMaxK.  The body of local_agg_bwd_dw and, with AFFINE, of
// local_agg_bwd_dw_affine: w, s, ds, db and part are the affine's (null
// without it); the affine asks L2 for w's rows of the tile kStages - 1
// groups before the last, and only the store differs (dw_affine_epilogue).
template <typename T, int KC, bool AFFINE>
__device__ __forceinline__ void dw_tiles(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dw,
    const T* __restrict__ w, const float* __restrict__ s,
    float* __restrict__ ds, float* __restrict__ db, float2* __restrict__ part,
    const Geometry& g, const Tiling& t, int dy_unit) {
  constexpr int KT = KC == 3 ? 3 : kMaxK;        // taps unrolled per axis
  constexpr int V = KC == 3 ? 4 : 1;             // positions of an item
  constexpr int NE = KC == 3 ? V + KT - 1 : KT;  // x columns an item reads
  const int kh = KC == 3 ? 3 : g.kh, kw = KC == 3 ? 3 : g.kw;
  const int dil_h = KC == 3 ? 1 : g.dh, dil_w = KC == 3 ? 1 : g.dw;
  const int k2 = kh * kw;
  const int hw_in = g.hi * g.wi, hw_out = g.ho * g.wo;

  extern __shared__ __align__(16) char stages[];
  __shared__ const T* x_src[kMaxPlanes];
  __shared__ const T* dy_src[kMaxPlanes];

  // the block: planes plane0 .. plane0 + t.planes - 1 and rows r0 ..
  // r0 + t.rows - 1; staged row 0 is x row ``first``, x's rows [h_lo, h_hi)
  // are the image's among the staged ones, and dy's rows [r0, y_hi) follow
  // them at staged row t.staged
  const int tile = blockIdx.x % t.tiles;
  const int plane0 = int(blockIdx.x / t.tiles) * t.planes;
  const int planes = g.n * g.heads * g.cw;  // < 2^31: checked at launch
  const int r0 = tile * t.rows;
  const int first = r0 - g.ph;
  const int h_lo = max(0, first), h_hi = min(g.hi, first + t.staged);
  const int y_hi = min(g.ho, r0 + t.rows);
  if (threadIdx.x < t.planes) {
    // plane (n * heads + head) * Cw + cw reads x channels n*C + cw + g*Cw
    // and dy channels (n * heads + head)*C + cw + g*Cw
    const int plane = plane0 + threadIdx.x;
    const T* xp = nullptr;
    const T* yp = nullptr;
    if (plane < planes) {
      const int nh = plane / g.cw;
      const int cw = plane - nh * g.cw;
      xp = x + (int64_t(nh / g.heads) * g.c + cw) * hw_in;
      yp = dy + (int64_t(nh) * g.c + cw) * hw_out;
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
          // K = 3: the item's V + 2 columns from the even one before them
          // (pad 1 makes ``rp`` odd), in V/2 + 2 loads of two
          float xs[KC == 3 ? NE + 2 : NE];
          if constexpr (KC == 3) {
            load_pairs<T, V / 2 + 2>(rp - 1, xs);
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
                acc[i * KT + j][v] += xs[KC == 3 ? v + j + 1 : j] * ys[v];
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
    T* dwp = dw + int64_t(plane) * k2 * hw_out + ho * g.wo + wo0;
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

// The K = 3 instantiation is held to 64 registers, as the forward's.
template <typename T, int KC>
__global__ void __launch_bounds__(kMaxThreads, KC == 3 ? 2 : 1)
    local_agg_bwd_dw(const T* __restrict__ x, const T* __restrict__ dy,
                     T* __restrict__ dw, Geometry g, Tiling t, int dy_unit) {
  dw_tiles<T, KC, false>(x, dy, dw, nullptr, nullptr, nullptr, nullptr,
                         nullptr, g, t, dy_unit);
}

// x, dy as above; w, dw [N, heads, Cw, Kh*Kw, Ho, Wo]; s, ds, db
// [N, heads, Cw, Kh*Kw] f32; part, with a plane of several row tiles,
// [tiles, N*heads*Cw, Kh*Kw] float2 (ds's and db's partial sums, which
// local_agg_bwd_dw_affine_sums then adds).  dw's halo tiles and its
// register budget.
template <typename T, int KC>
__global__ void __launch_bounds__(kMaxThreads, KC == 3 ? 2 : 1)
    local_agg_bwd_dw_affine(const T* __restrict__ x, const T* __restrict__ dy,
                            const T* __restrict__ w,
                            const float* __restrict__ s, T* __restrict__ dw,
                            float* __restrict__ ds, float* __restrict__ db,
                            float2* __restrict__ part, Geometry g, Tiling t,
                            int dy_unit) {
  dw_tiles<T, KC, true>(x, dy, dw, w, s, ds, db, part, g, t, dy_unit);
}

// A plane's ds and db when its row tiles are several blocks: one thread per
// (plane, tap) row adds the tiles' partial sums in the order 0..tiles-1.
// part as above; ``rows`` = N*heads*Cw*Kh*Kw.
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dw_affine_sums(const float2* __restrict__ part,
                                 float* __restrict__ ds,
                                 float* __restrict__ db, int64_t rows,
                                 int tiles) {
  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float a = 0.f, c = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const float2 v = part[tile * rows + r];
    a += v.x;
    c += v.y;
  }
  ds[r] = a;
  db[r] = c;
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

// The pointwise route of dw, for the geometries the tiles do not take.  x,
// dy, dw as above; one thread per dw element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dw_pointwise(const T* __restrict__ x,
                               const T* __restrict__ dy, T* __restrict__ dw,
                               Geometry g) {
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

// The pointwise route of the affine dw, for the geometries the tiles do not
// take.  x, dy, w, dw, s, ds, db as above.  One block per (n, head, cw,
// tap) row; blockDim.x is a multiple of 32, at most kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    local_agg_bwd_dw_affine_pointwise(
        const T* __restrict__ x, const T* __restrict__ dy,
        const T* __restrict__ w, const float* __restrict__ s,
        T* __restrict__ dw, float* __restrict__ ds, float* __restrict__ db,
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

template <typename T, bool AFFINE, int KC>
int launch_dx_variant(const void* w, const void* s, const void* b,
                      const void* dy, void* dx, const Geometry& g,
                      cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggDx, g, int(sizeof(T)), V,
                copy_unit(dy, int64_t(g.wo) * int(sizeof(T))), &t, &blocks,
                &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const auto kernel = local_agg_bwd_dx<T, AFFINE, KC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(s),
      static_cast<const float*>(b), static_cast<const T*>(dy),
      static_cast<T*>(dx), g, t);
  return int(cudaGetLastError());
}

template <typename T, bool AFFINE>
int launch_dx(const void* w, const void* s, const void* b, const void* dy,
              void* dx, const Geometry& g, cudaStream_t stream) {
  const int64_t total = int64_t(g.n) * g.c * g.hi * g.wi;
  if (total == 0) return int(cudaSuccess);
  switch (agg_route(kAggDx, g, int(sizeof(T)))) {
    case kRouteK3:
      return launch_dx_variant<T, AFFINE, 3>(w, s, b, dy, dx, g, stream);
    case kRouteGeneral:
      return launch_dx_variant<T, AFFINE, 0>(w, s, b, dy, dx, g, stream);
    default: {
      unsigned blocks;
      if (!grid_for(total, &blocks)) {
        return int(cudaErrorInvalidConfiguration);
      }
      local_agg_bwd_dx_pointwise<T, AFFINE><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(w), static_cast<const float*>(s),
          static_cast<const float*>(b), static_cast<const T*>(dy),
          static_cast<T*>(dx), g);
      return int(cudaGetLastError());
    }
  }
}

template <typename T, int KC>
int launch_dw_variant(const void* x, const void* dy, void* dw,
                      const Geometry& g, cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  const int elem = int(sizeof(T));
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggDw, g, elem, V, copy_unit(x, int64_t(g.wi) * elem), &t,
                &blocks, &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const auto kernel = local_agg_bwd_dw<T, KC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<T*>(dw), g, t, copy_unit(dy, int64_t(g.wo) * elem));
  return int(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* dy, void* dw, const Geometry& g,
              cudaStream_t stream) {
  const int64_t total =
      int64_t(g.n) * g.heads * g.cw * g.kh * g.kw * g.ho * g.wo;
  if (total == 0) return int(cudaSuccess);
  switch (agg_route(kAggDw, g, int(sizeof(T)))) {
    case kRouteK3:
      return launch_dw_variant<T, 3>(x, dy, dw, g, stream);
    case kRouteGeneral:
      return launch_dw_variant<T, 0>(x, dy, dw, g, stream);
    default: {
      unsigned blocks;
      if (!grid_for(total, &blocks)) {
        return int(cudaErrorInvalidConfiguration);
      }
      local_agg_bwd_dw_pointwise<T><<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<T*>(dw), g);
      return int(cudaGetLastError());
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
           const Geometry& g, cudaStream_t stream) {
  if (dx != nullptr) {
    const int err = launch_dx<T, false>(w, nullptr, nullptr, dy, dx, g, stream);
    if (err != int(cudaSuccess)) return err;
  }
  if (dw != nullptr) return launch_dw<T>(x, dy, dw, g, stream);
  return int(cudaSuccess);
}

// The bytes of ds's and db's partial sums that a launch of the affine dw
// at geometry g writes between its two kernels (tiles x planes x K*K
// float2): 0 unless its route is tiled and a plane spans several row
// tiles.
inline int64_t dw_affine_workspace(const Geometry& g, int elem) {
  const int route = agg_route(kAggDwAffine, g, elem);
  if (route == kRoutePointwise) return 0;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggDwAffine, g, elem, route == kRouteK3 ? 4 : 1, 0, &t,
                &blocks, &threads, &smem) ||
      t.tiles == 1) {
    return 0;
  }
  return int64_t(t.tiles) * g.n * g.heads * g.cw * g.kh * g.kw *
         int64_t(sizeof(float2));
}

template <typename T, int KC>
int launch_dw_affine_variant(const void* x, const void* w, const void* s,
                             const void* dy, void* dw, void* ds, void* db,
                             void* part, int64_t part_bytes,
                             const Geometry& g, cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  const int elem = int(sizeof(T));
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggDwAffine, g, elem, V, copy_unit(x, int64_t(g.wi) * elem),
                &t, &blocks, &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const int64_t rows = int64_t(g.n) * g.heads * g.cw * g.kh * g.kw;
  if (t.tiles > 1 && (part == nullptr ||
                      part_bytes < dw_affine_workspace(g, elem))) {
    return int(cudaErrorInvalidValue);
  }
  const auto kernel = local_agg_bwd_dw_affine<T, KC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(w), static_cast<const float*>(s),
      static_cast<T*>(dw), static_cast<float*>(ds), static_cast<float*>(db),
      static_cast<float2*>(part), g, t, copy_unit(dy, int64_t(g.wo) * elem));
  err = cudaGetLastError();
  if (err != cudaSuccess || t.tiles == 1) return int(err);
  unsigned sum_blocks;
  if (!grid_for(rows, &sum_blocks)) return int(cudaErrorInvalidConfiguration);
  local_agg_bwd_dw_affine_sums<<<sum_blocks, kThreads, 0, stream>>>(
      static_cast<const float2*>(part), static_cast<float*>(ds),
      static_cast<float*>(db), rows, t.tiles);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dw_affine(const void* x, const void* w, const void* s,
                     const void* dy, void* dw, void* ds, void* db, void* part,
                     int64_t part_bytes, const Geometry& g,
                     cudaStream_t stream) {
  const int64_t rows = int64_t(g.n) * g.heads * g.cw * g.kh * g.kw;
  const int64_t plane = int64_t(g.ho) * g.wo;
  if (rows == 0) return int(cudaSuccess);
  switch (agg_route(kAggDwAffine, g, int(sizeof(T)))) {
    case kRouteK3:
      return launch_dw_affine_variant<T, 3>(x, w, s, dy, dw, ds, db, part,
                                            part_bytes, g, stream);
    case kRouteGeneral:
      return launch_dw_affine_variant<T, 0>(x, w, s, dy, dw, ds, db, part,
                                            part_bytes, g, stream);
    default: {
      if (rows > 0x7fffffff || plane > 0x7fffffff) {
        return int(cudaErrorInvalidConfiguration);
      }
      // a warp for every 32 positions of the row, up to kThreads
      const int64_t warps = (plane + 31) / 32;
      const unsigned threads =
          unsigned(warps < 1 ? 32 : (warps * 32 > kThreads ? kThreads
                                                           : warps * 32));
      local_agg_bwd_dw_affine_pointwise<T>
          <<<unsigned(rows), threads, 0, stream>>>(
              static_cast<const T*>(x), static_cast<const T*>(dy),
              static_cast<const T*>(w), static_cast<const float*>(s),
              static_cast<T*>(dw), static_cast<float*>(ds),
              static_cast<float*>(db), g);
      return int(cudaGetLastError());
    }
  }
}

template <typename T>
int launch_affine(const void* x, const void* w, const void* s, const void* b,
                  const void* dy, void* dx, void* dw, void* ds, void* db,
                  void* part, int64_t part_bytes, const Geometry& g,
                  cudaStream_t stream) {
  if (dx != nullptr) {
    const int err = launch_dx<T, true>(w, s, b, dy, dx, g, stream);
    if (err != int(cudaSuccess)) return err;
  }
  if (dw != nullptr) {
    return launch_dw_affine<T>(x, w, s, dy, dw, ds, db, part, part_bytes, g,
                               stream);
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
// skips the dx kernel; a null dw skips the kernels that write dw, ds and db
// together (all three null or none).  ``part``: device memory of
// ``part_bytes`` bytes for ds's and db's partial sums, at least what
// local_agg_bwd_dw_affine_workspace returns (null when that is 0).
extern "C" int local_agg_bwd_affine_launch(
    int dtype, const void* x, const void* w, const void* s, const void* b,
    const void* dy, void* dx, void* dw, void* ds, void* db, void* part,
    long long part_bytes, int n, int c, int hi, int wi, int heads, int cw,
    int kh, int kw, int ho, int wo, int ph, int pw, int dh, int dw_,
    void* stream) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw_};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dw == nullptr) != (ds == nullptr) || (dw == nullptr) != (db == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return launch_affine<float>(x, w, s, b, dy, dx, dw, ds, db, part,
                                  part_bytes, g, st);
    case 1:
      return launch_affine<__half>(x, w, s, b, dy, dx, dw, ds, db, part,
                                   part_bytes, g, st);
    case 2:
      return launch_affine<__nv_bfloat16>(x, w, s, b, dy, dx, dw, ds, db,
                                          part, part_bytes, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The bytes of the partial sums a launch of the affine dw at this geometry
// needs (local_agg_bwd_affine_launch's ``part``); dtype as above.
extern "C" long long local_agg_bwd_dw_affine_workspace(
    int dtype, int n, int c, int hi, int wi, int heads, int cw, int kh,
    int kw, int ho, int wo, int ph, int pw, int dh, int dw) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  return dw_affine_workspace(g, elem_size(dtype));
}

// The route a dx, dw or affine dw launch at this geometry runs, decided as
// the launcher decides it: 3 (k3: K = 3, dilation 1, column padding 1; for
// dx one head too), 0 (general: K up to kMaxK) or 1 (pointwise: every
// geometry whose tiles do not fit).  dtype as above.
extern "C" int local_agg_bwd_dx_variant(int dtype, int n, int c, int hi,
                                        int wi, int heads, int cw, int kh,
                                        int kw, int ho, int wo, int ph,
                                        int pw, int dh, int dw) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  return agg_route(kAggDx, g, elem_size(dtype));
}

extern "C" int local_agg_bwd_dw_variant(int dtype, int n, int c, int hi,
                                        int wi, int heads, int cw, int kh,
                                        int kw, int ho, int wo, int ph,
                                        int pw, int dh, int dw) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  return agg_route(kAggDw, g, elem_size(dtype));
}

extern "C" int local_agg_bwd_dw_affine_variant(int dtype, int n, int c,
                                               int hi, int wi, int heads,
                                               int cw, int kh, int kw, int ho,
                                               int wo, int ph, int pw, int dh,
                                               int dw) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  return agg_route(kAggDwAffine, g, elem_size(dtype));
}
