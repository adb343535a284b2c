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
// bytes over the HBM rate: (x + w + out) bytes / 3.35 TB/s on an H100 SXM.
// The K*K reads of each x element are meant to hit L1/L2, not HBM.
//
// Design (simple and right first): one thread per output element, wo
// fastest, 256 threads a block, so neighbouring threads read neighbouring
// x and w addresses and the loads coalesce.  Left for later: shared-memory
// halo tiles of x reused across the K*K taps and the G = C/Cw channel
// groups that share one weight channel, 16-byte vector loads, and TMA.

#include "common.cuh"

namespace {

// x [N, C, Hi, Wi]; w [N, heads, Cw, Kh*Kw, Ho, Wo];
// s, b [N, heads, Cw, Kh*Kw] f32 (AFFINE only); out [N, heads*C, Ho, Wo].
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    local_agg_fwd(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ b,
                  T* __restrict__ out, Geometry g) {
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
int launch(const void* x, const void* w, const void* s, const void* b,
           void* out, const Geometry& g, cudaStream_t stream) {
  const int64_t total = int64_t(g.n) * g.heads * g.c * g.ho * g.wo;
  if (total == 0) return int(cudaSuccess);
  unsigned blocks;
  if (!grid_for(total, &blocks)) return int(cudaErrorInvalidConfiguration);
  local_agg_fwd<T, AFFINE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<T*>(out), g);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_affine(int affine, const void* x, const void* w, const void* s,
                    const void* b, void* out, const Geometry& g,
                    cudaStream_t stream) {
  return affine ? launch<T, true>(x, w, s, b, out, g, stream)
                : launch<T, false>(x, w, s, b, out, g, stream);
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
      return dispatch_affine<float>(affine, x, w, s, b, out, g, st);
    case 1:
      return dispatch_affine<__half>(affine, x, w, s, b, out, g, st);
    case 2:
      return dispatch_affine<__nv_bfloat16>(affine, x, w, s, b, out, g, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
