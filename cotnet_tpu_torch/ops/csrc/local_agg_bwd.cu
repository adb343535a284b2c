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
// dw and the affine dw keep the first design, one thread per output
// element, neighbouring threads on neighbouring addresses.  The affine dw:
// one block per (n, head, cw, tap) row of ds and db; its threads stride
// over the row's Ho*Wo positions, store dw, and keep private f32 sums that
// the block then reduces through warp shuffles and shared memory in a fixed
// order.  The TPU kernel reduces a whole image inside one grid step; here
// the row's owner is the block.  Each output has exactly one owner: no
// atomics, and the result is deterministic.  Left for later: one launch
// that reads dy once for dx and dw, and shared-memory tiles for dw (its K*K
// taps re-read the same x and dy planes through L1/L2).

#include <climits>

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

// dx's instantiation: the forward's, but K = 3 only with one head (every
// main path), whose weights it reads once.
inline int dx_variant(const Geometry& g) {
  const int v = agg_variant(g.kh, g.kw, g.dh, g.dw, g.pw);
  return v == 3 && g.heads != 1 ? 0 : v;
}

template <typename T, bool AFFINE, int KC>
int launch_dx_variant(const void* w, const void* s, const void* b,
                      const void* dy, void* dx, const Geometry& g,
                      cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_tiles(int64_t(g.n) * g.cw, g.hi, g.wi, g.ho, g.wo,
                  (g.kh - 1) * g.dh, g.pw - (g.kw - 1) * g.dw, g.pw,
                  int(sizeof(T)), V,
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
  if (int64_t(g.n) * g.c * g.hi * g.wi == 0) return int(cudaSuccess);
  // offsets within a plane (and within a weight channel's K*K planes) are
  // 32-bit
  if (int64_t(g.hi) * g.wi > INT_MAX ||
      int64_t(g.kh) * g.kw * g.ho * g.wo > INT_MAX ||
      int64_t(g.n) * g.heads * g.cw > INT_MAX) {
    return int(cudaErrorInvalidConfiguration);
  }
  switch (dx_variant(g)) {
    case 3:
      return launch_dx_variant<T, AFFINE, 3>(w, s, b, dy, dx, g, stream);
    case 0:
      return launch_dx_variant<T, AFFINE, 0>(w, s, b, dy, dx, g, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
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

// The instantiation a dx launch at this geometry runs: 3 (K = 3, dilation
// 1, column padding 1, one head), 0 (the general one) or -1 (none: the
// launch is refused).
extern "C" int local_agg_bwd_dx_variant(int kh, int kw, int dh, int dw,
                                        int pw, int heads) {
  Geometry g{};
  g.kh = kh, g.kw = kw, g.dh = dh, g.dw = dw, g.pw = pw, g.heads = heads;
  return dx_variant(g);
}
