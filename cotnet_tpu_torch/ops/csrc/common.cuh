// What every kernel source of the local aggregation shares: widening to
// f32 and rounding back once, the op's geometry, and the 1-D launch grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x [N, C, Hi, Wi]; w [N, heads, Cw, Kh*Kw, Ho, Wo]; stride 1, zero padding
// (ph, pw) as a bounds check, dilation (dh, dw).
struct Geometry {
  int n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw;
};

// The C entries' dtype codes: 0 float32, 1 float16, 2 bfloat16; the size
// of one element.
inline int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

constexpr int kThreads = 256;

// Blocks of kThreads threads for one thread per element; false when the
// grid would not fit.
inline bool grid_for(int64_t total, unsigned* blocks) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  if (b > 0x7fffffff) return false;
  *blocks = unsigned(b);
  return true;
}

// Sum over the warp's 32 lanes; every lane gets the same bits (a + b is
// commutative, and each butterfly step pairs lane i with lane i ^ m).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

}  // namespace

// ---------------------------------------------------------------------------
// Halo tiles: what the aggregation forward (local_agg_fwd.cu) and its dx and
// dw kernels (local_agg_bwd.cu) share.
//
// All three compute, at each position of an output "plane", a sum over the
// G = C/Cw channels that share one weight channel: the forward and dx sum
// K*K taps of a weight times a source element at a shifted position; dw
// keeps the K*K taps apart, each the product of x at the shifted position
// and dy at the position itself.  A block owns ``planes`` whole planes
// (small maps) or one plane's tile of ``rows`` rows (large maps); a thread
// item is V neighbouring positions of one row, ``q`` items a row.  The
// block walks the G channel groups (times the heads, for dx); for each, it
// stages the source rows the tile reads, halo included, in shared memory,
// kStages groups deep (dw stages dy's ``rows`` rows besides, after the
// halo tile).  Shared memory holds each source row at a fixed ``stride``
// with ``pl`` zero columns before it and zero columns after it, and a row
// outside the image as zeros: the zeros are written once, when the block
// starts, and the stages copy only the image's rows, with cp.async in
// units of 16, 8 or 4 bytes (``unit``, the widest that every row start
// allows; 0: element by element).  So the taps read shared memory without
// a mask: the padding is the zeros.
//
// The affine dw (dw, ds and db in one pass, local_agg_bwd.cu) runs dw's
// tiles with another store; the fused embed op's aggregation
// (local_agg_embed_gn.cu) runs the forward's (fwd_tiles.cuh) with weights
// it forms itself.
//
// Three routes, chosen before any launch from the geometry alone
// (agg_route): ``k3``, the tiles with K = 3 at dilation 1 and column
// padding 1 compile-time and unrolled (every main path); ``general``, the
// tiles with runtime K <= kMaxK; and ``pointwise``, one thread per output
// with no limit on K, width or dilation, for every geometry whose tiles do
// not fit (K > kMaxK, a row of more than kMaxThreads items, a halo tile
// beyond a block's shared memory, offsets beyond 32 bits).

namespace {

constexpr int kMaxThreads = 512;   // threads of a block, at most
constexpr int kMaxPlanes = 32;     // planes of a block, at most
constexpr int kStages = 4;         // channel groups in shared memory at once
constexpr int kMaxK = 7;           // the general instantiation's largest K
constexpr int kTargetItems = 128;  // a forward or dx block's thread items
// dw's and the affine dw's: its stage holds dy's rows besides x's halo
// tile, and the card ran it faster with whole 28x28 planes in a block
// (fewer halo rows and block prologues), within 3% at the other maps (the
// affine dw, too, ran fastest at 256 of 128, 192, 256 and 384)
constexpr int kDwTargetItems = 256;
// the fused embed op's aggregation: whole 28x28 planes in a block, so that
// the block takes their GroupNorm statistics itself
constexpr int kEmbedTargetItems = 256;
constexpr int kSmemAim = 48 * 1024;  // a block's shared memory, when it can
constexpr int kMaxSmem = 232448;   // shared memory of one block on sm_90
constexpr int kStaticSmem = 1024;  // a kernel's static shared memory, at most

struct Tiling {
  int q, rows, tiles, planes;  // items a row, rows a tile, tiles, planes
  int staged, stride, pl;      // staged rows, their stride and left zeros
  int region, unit;            // bytes of a plane's stage; copy unit
};

// The tiling of ``plane_count`` planes of out_h x out_w positions, V =
// ``vec`` positions a thread item, at most ``items`` thread items a block
// (kMaxThreads where one row is wider).  A tile of R rows reads R + ``halo``
// rows of a src_h x src_w source plane of ``elem``-byte elements, and an
// item at positions [c, c + V) reads source columns [c + col_lo,
// c + V - 1 + col_hi]; with ``own_rows`` a stage also holds the tile's R
// rows of an out_h x out_w plane (dw's dy), q * V columns each, after the
// halo tile.  ``unit``: the staging copy unit in bytes.  False when no
// block can hold one row (a row wider than kMaxThreads items, or its stages
// larger than a block's shared memory) or the grid is too large.
inline bool plan_tiles(int64_t plane_count, int out_h, int out_w, int src_h,
                       int src_w, int halo, bool own_rows, int col_lo,
                       int col_hi, int elem, int vec, int items, int unit,
                       Tiling* t, unsigned* blocks, unsigned* threads,
                       size_t* smem) {
  if (plane_count <= 0 || out_h <= 0 || out_w <= 0) return false;
  const int q = (out_w + vec - 1) / vec;
  if (q > kMaxThreads) return false;
  const int per16 = 16 / elem;  // elements of 16 bytes
  const int pl = (std::max(0, -col_lo) + per16 - 1) / per16 * per16;
  const int pr = std::max(0, q * vec - 1 + col_hi - (src_w - 1));
  const int64_t stride = std::max<int64_t>(
      (int64_t(pl) + src_w + pr + per16 - 1) / per16 * per16,
      own_rows ? (int64_t(q) * vec + per16 - 1) / per16 * per16 : 0);
  // whole rows up to ``items`` items: a tile of one plane's rows, or at a
  // map of fewer rows, whole planes
  const int per_block = std::max(1, items / q);
  int rows = std::min(per_block, out_h), planes = 1;
  if (per_block > out_h) {
    planes = std::max(1, std::min(per_block / out_h, kMaxPlanes));
  }
  int64_t region;
  for (;;) {
    region = (rows * (own_rows ? 2 : 1) + int64_t(halo)) * stride * elem;
    if (kStages * planes * region <= kSmemAim || (planes == 1 && rows == 1))
      break;
    if (planes > 1) {
      planes = (planes + 1) / 2;
    } else {
      rows = (rows + 1) / 2;
    }
  }
  const int64_t bytes = kStages * planes * region;
  const int tiles = (out_h + rows - 1) / rows;
  const int64_t count = (plane_count + planes - 1) / planes * tiles;
  if (bytes > kMaxSmem - kStaticSmem || count > 0x7fffffff) return false;
  *t = Tiling{q, rows, tiles, planes, rows + halo, int(stride), pl,
              int(region), unit};
  *blocks = unsigned(count);
  *threads = unsigned((int64_t(planes) * rows * q + 31) / 32 * 32);
  *smem = size_t(bytes);
  return true;
}

// The widest copy unit (16, 8 or 4 bytes; 0: none) that divides a tensor's
// address and its rows' bytes, so that every row of it starts on a unit.
inline int copy_unit(const void* base, int64_t row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) | uintptr_t(row_bytes);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

// Opt a kernel in to more dynamic shared memory than the default allows
// (48 KB with its static shared memory) when a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem + kStaticSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// The kernels of the halo tiles, and their routes (the numbers the C
// entries *_variant return).  The affine dw (dw, ds and db) tiles as dw;
// the fused embed op's aggregation as the forward, with its own target.
enum AggKernel { kAggFwd, kAggDx, kAggDw, kAggDwAffine, kAggEmbed };
constexpr int kRouteGeneral = 0;
constexpr int kRoutePointwise = 1;
constexpr int kRouteK3 = 3;

// The embed aggregation's scratch, the shared memory after its stages:
// byte offsets of its parts from the scratch's start, each 16-byte aligned.
// The block's w_pre and w2 values are staged ``chunk`` embed channels at a
// time, two chunks in flight: two w_pre buffers, for each of the at most
// ``images`` images its planes span (at ``img_stride`` bytes) the chunk's
// channels of the tile, ``span`` = rows * Wo elements each; two raw w2
// buffers, [plane][K*K][cstride] elements; w2 in f32, [plane][channel]
// [K*K padded to 4], ``w2_stride`` floats a plane (16 bytes more than the
// values, so that neighbouring planes' values fall in other banks); per
// thread its sums of w_raw and w_raw^2, then per plane its mean and 1/std
// (float2).
struct EmbedScratch {
  int chunk, images, span, img_stride, cstride, w2_stride;
  int wpre, wpre_buf, w2raw, w2raw_buf, w2f, sums, bytes;
};
constexpr int kEmbedScratchAim = 72 * 1024;  // the scratch, when it can

inline int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// The scratch of an embed aggregation block of tiling t, ``threads``
// threads, with ``elem``-byte elements: the largest chunk of 64 channels
// or fewer (16 or fewer beyond K = 3), halving down to 4, whose scratch
// fits kEmbedScratchAim.  False when the byte counts overflow.
inline bool plan_embed_scratch(const Geometry& g, const Tiling& t, int elem,
                               unsigned threads, EmbedScratch* e) {
  const int k2 = g.kh * g.kw, k2p = (k2 + 3) / 4 * 4;
  const int images = std::min(t.planes, (t.planes + g.cw - 2) / g.cw + 1);
  const int64_t span = int64_t(t.rows) * g.wo;
  for (int chunk = k2 <= 9 ? 64 : 16;; chunk /= 2) {
    const int64_t cstride = round16(int64_t(chunk) * elem) / elem;
    const int64_t img_stride = round16(chunk * span * elem);
    const int64_t wpre_buf = images * img_stride;
    const int64_t w2raw_buf = round16(t.planes * k2 * cstride * elem);
    const int64_t w2_stride = int64_t(chunk) * k2p + 4;
    const int64_t w2f = 2 * (wpre_buf + w2raw_buf);
    const int64_t sums = w2f + t.planes * w2_stride * 4;
    const int64_t bytes = sums + round16((int64_t(threads) + t.planes) * 8);
    if (bytes <= kEmbedScratchAim || chunk == 4) {
      if (bytes > INT_MAX) return false;
      *e = EmbedScratch{chunk,          images,        int(span),
                        int(img_stride), int(cstride), int(w2_stride),
                        0,              int(wpre_buf), int(2 * wpre_buf),
                        int(w2raw_buf), int(w2f),      int(sums),
                        int(bytes)};
      return true;
    }
  }
}

// The tiling of ``kernel``'s tiled routes at geometry g: the forward, the
// embed aggregation and dw tile the output (Ho x Wo) over x's halo rows,
// one plane per (n, head, cw) (dw staging dy's rows besides); dx tiles dx
// (Hi x Wi) over dy's halo rows, one plane per (n, cw).  The affine dw
// tiles as dw, and after the last stage its threads' partial sums of ds
// and db (K*K float2 a thread) take the same shared memory: ``smem`` is the
// larger of the two.  The embed aggregation's scratch (plan_embed_scratch)
// follows its stages: ``smem`` counts both.
inline bool plan_agg(AggKernel kernel, const Geometry& g, int elem, int vec,
                     int unit, Tiling* t, unsigned* blocks, unsigned* threads,
                     size_t* smem) {
  const int halo = (g.kh - 1) * g.dh;
  if (kernel == kAggDx) {
    return plan_tiles(int64_t(g.n) * g.cw, g.hi, g.wi, g.ho, g.wo, halo,
                      false, g.pw - (g.kw - 1) * g.dw, g.pw, elem, vec,
                      kTargetItems, unit, t, blocks, threads, smem);
  }
  const bool dw = kernel == kAggDw || kernel == kAggDwAffine;
  const int items = dw                    ? kDwTargetItems
                    : kernel == kAggEmbed ? kEmbedTargetItems
                                          : kTargetItems;
  if (!plan_tiles(int64_t(g.n) * g.heads * g.cw, g.ho, g.wo, g.hi, g.wi,
                  halo, dw, -g.pw, (g.kw - 1) * g.dw - g.pw, elem, vec, items,
                  unit, t, blocks, threads, smem)) {
    return false;
  }
  if (kernel == kAggDwAffine) {
    const int64_t sums = int64_t(g.kh) * g.kw * *threads * 8;
    if (sums > kMaxSmem - kStaticSmem) return false;
    *smem = std::max(*smem, size_t(sums));
  }
  if (kernel == kAggEmbed) {
    EmbedScratch e;
    if (!plan_embed_scratch(g, *t, elem, *threads, &e)) return false;
    const int64_t bytes = int64_t(*smem) + e.bytes;
    if (bytes > kMaxSmem - kStaticSmem) return false;
    *smem = size_t(bytes);
  }
  return true;
}

// The route a launch of ``kernel`` at geometry g with ``elem``-byte
// elements takes: kRouteK3 for K = 3 at dilation 1 and column padding 1
// (and, for dx, one head) when its tiles fit; kRouteGeneral for any K up
// to kMaxK when its tiles fit; kRoutePointwise for every other geometry.
inline int agg_route(AggKernel kernel, const Geometry& g, int elem) {
  const bool k3 = g.kh == 3 && g.kw == 3 && g.dh == 1 && g.dw == 1 &&
                  g.pw == 1 && (kernel != kAggDx || g.heads == 1);
  const bool general = g.kh >= 1 && g.kw >= 1 && g.kh <= kMaxK &&
                       g.kw <= kMaxK && g.dh >= 1 && g.dw >= 1;
  // the tiled kernels' offsets within a plane (and within a weight
  // channel's K*K planes) and their plane numbers are 32-bit
  const bool narrow = int64_t(g.hi) * g.wi <= INT_MAX &&
                      int64_t(g.kh) * g.kw * g.ho * g.wo <= INT_MAX &&
                      int64_t(g.n) * g.heads * g.cw <= INT_MAX;
  if (!(k3 || general) || !narrow) return kRoutePointwise;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kernel, g, elem, k3 ? 4 : 1, 0, &t, &blocks, &threads,
                &smem)) {
    return kRoutePointwise;
  }
  return k3 ? kRouteK3 : kRouteGeneral;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Zero every stage of the block's shared memory (``bytes``, a multiple of
// 16): the padding columns and the rows outside the image stay so.
__device__ __forceinline__ void zero_stages(char* stages, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0, 0, 0, 0);
  }
}

// One stage: for each plane p of the block, the image rows [h_lo, h_hi) of
// the source plane at src[p] + offset (src[p] null: no such plane), each
// row of ``w`` elements to its place in buf + p * region: row h at
// (h - first) * stride + pl.  The threads take the rows' copy units side
// by side; with no copy unit, the elements, each thread several at once.
// The caller commits the cp.async group.
template <typename T>
__device__ __forceinline__ void stage_rows(char* buf, const Tiling& t,
                                           const T* const* src,
                                           int64_t offset, int h_lo,
                                           int h_hi, int first, int w) {
  const int n_rows = h_hi - h_lo;
  if (n_rows <= 0) return;
  const int per_row = t.unit == 0 ? w : w * int(sizeof(T)) / t.unit;
  const int per_plane = n_rows * per_row;
  const int total = t.planes * per_plane;
  if (t.unit == 0) {
    // kBatch loads in flight a thread, then their stores
    constexpr int kBatch = 4;
    T* out = reinterpret_cast<T*>(buf);
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
      T v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * blockDim.x;
        const int p = i / per_plane;
        const int r = (i - p * per_plane) / w;
        const int col = i - p * per_plane - r * w;
        at[k] = -1;
        if (i < total && src[p] != nullptr) {
          v[k] = src[p][offset + int64_t(h_lo + r) * w + col];
          at[k] = p * (t.region / int(sizeof(T))) +
                  (h_lo + r - first) * t.stride + t.pl + col;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (at[k] >= 0) out[at[k]] = v[k];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = t.planes == 1 ? 0 : i / per_plane;
    const int r = (i - p * per_plane) / per_row;
    const int j = i - p * per_plane - r * per_row;
    if (src[p] == nullptr) continue;
    char* dst = buf + p * t.region +
                ((h_lo + r - first) * t.stride + t.pl) * int(sizeof(T)) +
                j * t.unit;
    const char* from = reinterpret_cast<const char*>(
                           src[p] + offset + int64_t(h_lo + r) * w) +
                       j * t.unit;
    if (t.unit == 16) {
      cp_async<16>(dst, from);
    } else if (t.unit == 8) {
      cp_async<8>(dst, from);
    } else {
      cp_async<4>(dst, from);
    }
  }
}

template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// V elements at p, widened to f32, in loads of B bytes (p aligned to B).
template <int B, typename T, int V>
__device__ __forceinline__ void load_pieces(const T* __restrict__ p,
                                            float (&v)[V]) {
  using R = typename Raw<B>::type;
  constexpr int E = B / int(sizeof(T));
#pragma unroll
  for (int i = 0; i < V; i += E) {
    const R raw = *reinterpret_cast<const R*>(p + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < E; ++k) v[i + k] = to_f32(e[k]);
  }
}

// V f32 values rounded to T, to p, in stores of B bytes (p aligned to B).
template <int B, typename T, int V>
__device__ __forceinline__ void store_pieces(T* __restrict__ p,
                                             const float (&v)[V]) {
  using R = typename Raw<B>::type;
  constexpr int E = B / int(sizeof(T));
#pragma unroll
  for (int i = 0; i < V; i += E) {
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < E; ++k) e[k] = from_f32<T>(v[i + k]);
    *reinterpret_cast<R*>(p + i) = raw;
  }
}

// 2N elements of shared memory from p, an even element index, widened to
// f32, in N loads of two elements.
template <typename T, int N>
__device__ __forceinline__ void load_pairs(const T* p, float (&v)[2 * N]) {
  using R = typename Raw<2 * int(sizeof(T))>::type;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const R raw = reinterpret_cast<const R*>(p)[k];
    const T* e = reinterpret_cast<const T*>(&raw);
    v[2 * k] = to_f32(e[0]);
    v[2 * k + 1] = to_f32(e[1]);
  }
}

// The first n of V elements at p, widened to f32 (the rest 0): all V in
// the widest loads p's alignment allows when n == V, else one by one.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int n,
                                         float (&v)[V]) {
  constexpr int kBytes = V * int(sizeof(T));
  const unsigned a = unsigned(reinterpret_cast<uintptr_t>(p));
  if (n == V) {
    if constexpr (kBytes % 16 == 0) {
      if (a % 16 == 0) return load_pieces<16>(p, v);
    }
    if constexpr (kBytes % 8 == 0 && sizeof(T) <= 8) {
      if (a % 8 == 0) return load_pieces<8>(p, v);
    }
    if constexpr (kBytes % 4 == 0 && sizeof(T) <= 4) {
      if (a % 4 == 0) return load_pieces<4>(p, v);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
}

// The first n of V f32 values, rounded to T, to p: in the widest stores
// p's alignment allows when n == V, else one by one.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int n,
                                          const float (&v)[V]) {
  constexpr int kBytes = V * int(sizeof(T));
  const unsigned a = unsigned(reinterpret_cast<uintptr_t>(p));
  if (n == V) {
    if constexpr (kBytes % 16 == 0) {
      if (a % 16 == 0) return store_pieces<16>(p, v);
    }
    if constexpr (kBytes % 8 == 0 && sizeof(T) <= 8) {
      if (a % 8 == 0) return store_pieces<8>(p, v);
    }
    if constexpr (kBytes % 4 == 0 && sizeof(T) <= 4) {
      if (a % 4 == 0) return store_pieces<4>(p, v);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i < n) p[i] = from_f32<T>(v[i]);
  }
}

}  // namespace
