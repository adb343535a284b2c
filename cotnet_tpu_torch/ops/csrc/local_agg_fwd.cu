// Local aggregation forward (the CoT "local conv") for Hopper, sm_90a.
//
//   out[n, head*C + c, ho, wo] =
//       sum_{i<Kh, j<Kw} wn[n, head, c % Cw, i*Kw + j, ho, wo]
//                        * x[n, c, ho - ph + i*dh, wo - pw + j*dw]
//   with wn = w * s + b when AFFINE (the eval GroupNorm fold), else wn = w;
//   x outside the image reads as zero (the padding is a bounds check, no
//   padded copy is made).
//
// Replaces, in cotnet_tpu/ops/local_agg_pallas.py, the four TPU forward
// kernels that compute this one function: _fwd_kernel and
// _fwd_kernel_affine (whole-image NHWC, fused zero pad), _fwd_chwn_kernel
// (batch-on-lanes CHWN layout) and _fwd_chwn_strip_kernel (CHWN in
// H-strips).  Their layouts and tilings exist for the TPU's VMEM budget and
// lane width; on this card one kernel on the reference's own NCHW /
// cw-major layout covers all four.  The gated 56x56 tilings
// _fwd_wloop_kernel and _fwd_strip_kernel compute the same function too.
//
// Arithmetic follows the TPU kernels (_tap_weight, _fwd_body,
// _fwd_chwn_kernel): the tap weight is formed in f32 (w*s + b with the
// affine), x is widened to f32, products and the sum are f32, and only the
// output is rounded to T.
//
// Bound on this card: about one flop per byte, so the least time is the
// bytes over the HBM rate: (x + w + out) bytes / 3.35 TB/s on an H100 SXM,
// 0.0479 ms at cotnet50's 56x56 C=64 Cw=8 bs128 bf16 (x 51.4 MB, w 57.8 MB,
// out 51.4 MB).  The design reads each of those bytes from HBM once.
//
// Design (the halo tiles of common.cuh; the walk below is fwd_tiles.cuh's,
// which the fused embed op's aggregation runs with another weight source):
// - A block owns one weight channel (n, head, cw), the "plane" of Ho x Wo
//   positions whose K*K weights the G = C/Cw channels c = cw + g*Cw share,
//   and a tile of whole rows of it, at most kTargetItems thread items; at a
//   map of fewer rows than that, several whole planes.
// - A thread item is V neighbouring positions of one output row.  The
//   thread reads the K*K weights of its positions once, in the widest loads
//   their alignment allows (8 bytes at V = 4 in bf16), forms w*s + b in f32
//   once per weight with the affine, and keeps them in registers for all G
//   channels.
// - The block walks the G channels.  For each it stages x's halo tile (the
//   tile's rows plus (K-1)*dh, the whole width) in shared memory with
//   cp.async in the widest unit the rows' alignment allows (16 bytes at
//   56x56 in bf16), kStages channels deep, so that the next channels' tiles
//   land while this one is summed.  The staged rows sit between zero
//   columns, and rows outside the image are zero rows: both are written
//   once, when the block starts, so the zero padding costs the taps nothing.
// - The taps are summed in f32 and the V outputs of channel head*C + c
//   stored in the widest stores their alignment allows.  At K = 3 a thread
//   reads its V + 2 columns of a row in (V + 4) / 2 shared loads of two
//   elements.
// - Index arithmetic is done once per block and thread, in 32 bits (the
//   launcher checks the sizes).
// Two instantiations: K = 3 at dilation 1 and column padding 1, compile-
// time and fully unrolled (every CoT main path), V = 4, at most 64
// registers; and a general one, runtime K <= kMaxK, dilation, padding and
// heads, V = 1, its 7x7 taps unrolled under runtime guards.  K = 7 at
// dilation 1, column padding 3, one head and at most 8 channel groups
// (SAN19's stages 1-4, which the JAX package sends to _fwd_kernel :447
// through pallas_plan) takes a walk of its own, local_agg_fwd_k7
// (k7_tiles.cuh): every group of a plane staged at once, the tap rows
// outermost, 8 x 4 f32 accumulators a thread; __launch_bounds__(128, 4),
// at most 116 registers and no spills (ptxas, sm_90a), four blocks an
// SM, 12.5-44 KB of shared memory a block (15.75 KB at 56x56 bf16).  A geometry whose tiles do
// not fit (K > kMaxK, a row of more than kMaxThreads items, a halo tile
// beyond shared memory) takes a third route, local_agg_fwd_pointwise: one
// thread per output, wo fastest, its taps read through L1/L2, with no
// limit on K, width or dilation.  The launcher picks the route from the
// geometry before it launches (agg_route, common.cuh) and launches exactly
// that kernel.

#include "fwd_tiles.cuh"
#include "k7_tiles.cuh"

namespace {

// The forward's weight source (fwd_tiles.cuh): the K*K weights of the
// thread's positions, read once from w [N, heads, Cw, Kh*Kw, Ho, Wo] in the
// widest loads their alignment allows, w*s + b in f32 once per weight with
// the affine (s, b [N, heads, Cw, Kh*Kw] f32).
template <typename T, bool AFFINE, int KC>
struct LoadedWeights {
  static constexpr bool kLate = false;
  const T* __restrict__ w;
  const float* __restrict__ s;
  const float* __restrict__ b;

  template <int KT, int V>
  __device__ __forceinline__ void form(float (&wr)[KT * KT][V],
                                       const FwdItem& it, const Geometry& g,
                                       const Tiling&, char*) const {
    const int kh = KC == 3 ? 3 : g.kh, kw = KC == 3 ? 3 : g.kw;
    const int k2 = kh * kw;
    const int hw_out = g.ho * g.wo;
    const T* wp = w + int64_t(it.plane) * k2 * hw_out + it.ho * g.wo + it.wo0;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (i < kh && j < kw) {
          const int k = i * kw + j;
          load_vec<T, V>(wp + k * hw_out, it.nv, wr[i * KT + j]);
          if (AFFINE) {
            const float sk = s[int64_t(it.plane) * k2 + k];
            const float bk = b[int64_t(it.plane) * k2 + k];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              wr[i * KT + j][v] = wr[i * KT + j][v] * sk + bk;
            }
          }
        }
      }
    }
  }
};

// x [N, C, Hi, Wi]; w [N, heads, Cw, Kh*Kw, Ho, Wo];
// s, b [N, heads, Cw, Kh*Kw] f32 (AFFINE only); out [N, heads*C, Ho, Wo].
// KC = 3: K = 3 at dilation 1; KC = 0: any K up to kMaxK.  The K = 3
// instantiation is held to 64 registers (two blocks of kMaxThreads): its
// blocks have at most kTargetItems threads, so eight fit on an SM, and the
// card ran it faster than with more registers and fewer blocks.
template <typename T, bool AFFINE, int KC>
__global__ void __launch_bounds__(kMaxThreads, KC == 3 ? 2 : 1)
    local_agg_fwd(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ b,
                  T* __restrict__ out, Geometry g, Tiling t) {
  fwd_tiles<T, KC>(x, out, g, t, LoadedWeights<T, AFFINE, KC>{w, s, b});
}

// The k7 route (k7_tiles.cuh): K = 7 at dilation 1, column padding 3 and
// one head; WA, the bytes of its weight pieces.  At most kK7Threads threads
// a block and four blocks an SM: at most 128 registers a thread.
template <typename T, bool AFFINE, int WA>
__global__ void __launch_bounds__(kK7Threads, 4)
    local_agg_fwd_k7(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ s, const float* __restrict__ b,
                     T* __restrict__ out, Geometry g, Tiling t) {
  fwd_k7_tiles<T, AFFINE, WA>(x, w, s, b, out, g, t);
}

// The pointwise route, for the geometries the tiles do not take.  x, w, s,
// b, out as above; one thread per output element, wo fastest, so
// neighbouring threads read neighbouring x and w addresses.
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    local_agg_fwd_pointwise(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ s,
                            const float* __restrict__ b, T* __restrict__ out,
                            Geometry g) {
  const int64_t total = int64_t(g.n) * g.heads * g.c * g.ho * g.wo;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int wo = int(idx % g.wo);
  int64_t r = idx / g.wo;
  const int ho = int(r % g.ho);
  r /= g.ho;
  const int c = int(r % g.c);
  r /= g.c;
  const int head = int(r % g.heads);
  const int n = int(r / g.heads);

  const int k2 = g.kh * g.kw;
  const int64_t plane = int64_t(g.ho) * g.wo;
  // (n, head, c % Cw, tap 0): the row of s/b, and of w in units of a plane
  const int64_t row = ((int64_t(n) * g.heads + head) * g.cw + c % g.cw) * k2;
  const T* wp = w + row * plane + int64_t(ho) * g.wo + wo;
  const T* xp = x + (int64_t(n) * g.c + c) * g.hi * g.wi;

  float acc = 0.f;
  for (int i = 0; i < g.kh; ++i) {
    const int h = ho - g.ph + i * g.dh;
    const bool h_in = h >= 0 && h < g.hi;
    for (int j = 0; j < g.kw; ++j) {
      const int k = i * g.kw + j;
      float wk = to_f32(wp[k * plane]);
      if (AFFINE) wk = wk * s[row + k] + b[row + k];
      const int col = wo - g.pw + j * g.dw;
      const float xv = (h_in && col >= 0 && col < g.wi)
                           ? to_f32(xp[int64_t(h) * g.wi + col])
                           : 0.f;
      acc += xv * wk;
    }
  }
  out[idx] = from_f32<T>(acc);
}

template <typename T, bool AFFINE>
int launch_pointwise(const void* x, const void* w, const void* s,
                     const void* b, void* out, const Geometry& g,
                     cudaStream_t stream) {
  unsigned blocks;
  if (!grid_for(int64_t(g.n) * g.heads * g.c * g.ho * g.wo, &blocks)) {
    return int(cudaErrorInvalidConfiguration);
  }
  local_agg_fwd_pointwise<T, AFFINE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

template <typename T, bool AFFINE, int KC>
int launch(const void* x, const void* w, const void* s, const void* b,
           void* out, const Geometry& g, cudaStream_t stream) {
  constexpr int V = KC == 3 ? 4 : 1;
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_agg(kAggFwd, g, int(sizeof(T)), V,
                copy_unit(x, int64_t(g.wi) * int(sizeof(T))), &t, &blocks,
                &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  const auto kernel = local_agg_fwd<T, AFFINE, KC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<T*>(out), g, t);
  return int(cudaGetLastError());
}

template <typename T, bool AFFINE>
int launch_k7(const void* x, const void* w, const void* s, const void* b,
              void* out, const Geometry& g, cudaStream_t stream) {
  Tiling t;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_k7(kAggFwd, g, int(sizeof(T)),
               copy_unit(x, int64_t(g.wi) * int(sizeof(T))), &t, &blocks,
               &threads, &smem)) {
    return int(cudaErrorInvalidConfiguration);
  }
  constexpr int E = int(sizeof(T));
  const int wa = k7_weight_piece(w, g.wo, g.ho * g.wo, E);
  const auto kernel = wa == 4 * E   ? local_agg_fwd_k7<T, AFFINE, 4 * E>
                      : wa == 2 * E ? local_agg_fwd_k7<T, AFFINE, 2 * E>
                                    : local_agg_fwd_k7<T, AFFINE, E>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<T*>(out), g, t);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int affine, const void* x, const void* w, const void* s,
             const void* b, void* out, const Geometry& g,
             cudaStream_t stream) {
  if (int64_t(g.n) * g.heads * g.c * g.ho * g.wo == 0) {
    return int(cudaSuccess);
  }
  switch (agg_route(kAggFwd, g, int(sizeof(T)))) {
    case kRouteK3:
      return affine ? launch<T, true, 3>(x, w, s, b, out, g, stream)
                    : launch<T, false, 3>(x, w, s, b, out, g, stream);
    case kRouteK7:
      return affine ? launch_k7<T, true>(x, w, s, b, out, g, stream)
                    : launch_k7<T, false>(x, w, s, b, out, g, stream);
    case kRouteGeneral:
      return affine ? launch<T, true, 0>(x, w, s, b, out, g, stream)
                    : launch<T, false, 0>(x, w, s, b, out, g, stream);
    default:
      return affine ? launch_pointwise<T, true>(x, w, s, b, out, g, stream)
                    : launch_pointwise<T, false>(x, w, s, b, out, g, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Returns a cudaError_t code; 0
// means the launch was accepted.
extern "C" int local_agg_fwd_launch(int dtype, int affine, const void* x,
                                    const void* w, const void* s,
                                    const void* b, void* out, int n, int c,
                                    int hi, int wi, int heads, int cw, int kh,
                                    int kw, int ho, int wo, int ph, int pw,
                                    int dh, int dw, void* stream) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(affine, x, w, s, b, out, g, st);
    case 1:
      return dispatch<__half>(affine, x, w, s, b, out, g, st);
    case 2:
      return dispatch<__nv_bfloat16>(affine, x, w, s, b, out, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The route a launch at this geometry runs, decided as the launcher decides
// it: 3 (k3: K = 3, dilation 1, column padding 1), 7 (k7: K = 7, dilation
// 1, column padding 3, one head), 0 (general: K up to kMaxK) or 1
// (pointwise: every geometry whose tiles do not fit).
extern "C" int local_agg_fwd_variant(int dtype, int n, int c, int hi, int wi,
                                     int heads, int cw, int kh, int kw,
                                     int ho, int wo, int ph, int pw, int dh,
                                     int dw) {
  const Geometry g{n, c, hi, wi, heads, cw, kh, kw, ho, wo, ph, pw, dh, dw};
  return agg_route(kAggFwd, g, elem_size(dtype));
}
