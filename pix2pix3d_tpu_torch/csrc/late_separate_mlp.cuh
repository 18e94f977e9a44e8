// The lateSeparate decoder's per-sample MLP, shared by decode_composite.cu
// and late_separate_decode.cu.
//
// The decoder's two 32 -> 64 -> 33 MLPs are packed side by side
// (ops/decode_composite.py::fuse_late_separate_params):
//     h = softplus(x[32] . W1[32,128] + b1)        (f32, then rounded to E)
//     o = h . W2[128,128]                           (f32 accumulation)
// W2 is block-diagonal and only its first 65 columns are live: 0:32 the rgb
// features, 32:64 the semantic features, 64 sigma.  The caller adds b2 and
// applies its epilogue.
//
// Shared-memory layout of the weights, as both kernels stage them:
//     w1s[j * C_IN + c]     = W1[c][j]            (f32, widened from E)
//     w2s[j * OUT_PAD + k]  = W2[j][k] for k < 65, 0 for 65 <= k < OUT_PAD
//     b1s[j]                = b1[j]
// E (float or __nv_bfloat16) is the compute type: inputs and weights in E
// are widened to f32 exactly, so the f32 FMAs give bf16-in / f32-accumulate
// products, and h is rounded to E where the TPU kernels cast it.

#pragma once

#include <cuda_bf16.h>

namespace p2p3d {

constexpr int C_IN = 32;      // feature channels
constexpr int HID = 128;      // hidden units (both MLPs side by side)
constexpr int N_OUT = 65;     // live columns of W2 (64 colors + sigma)
constexpr int OUT_PAD = 68;   // W2 row stride in shared memory (float4)
constexpr int N_COL = 64;     // colors (rgb features + semantic features)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename E>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<E>(v));
}

// jax.nn.softplus: log(1 + exp(v)) = max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// MipNeRF sigmoid clamp
__device__ __forceinline__ float sigmoid_clamp(float v) {
  return (1.f / (1.f + expf(-v))) * 1.002f - 0.001f;
}

// o[k] = sum_j round_E(softplus(x . W1[:, j] + b1[j])) * W2[j][k] for
// k < OUT_PAD (columns 65.. read zeros), without b2.
template <typename E>
__device__ __forceinline__ void decode_sample(const float (&x)[C_IN],
                                              const float* __restrict__ w1s,
                                              const float* __restrict__ b1s,
                                              const float* __restrict__ w2s,
                                              float (&o)[OUT_PAD]) {
#pragma unroll
  for (int k = 0; k < OUT_PAD; ++k) o[k] = 0.f;

#pragma unroll 2
  for (int j = 0; j < HID; ++j) {
    const float4* w1row = reinterpret_cast<const float4*>(w1s + j * C_IN);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c4 = 0; c4 < C_IN / 4; ++c4) {
      const float4 w = w1row[c4];
      a[0] = fmaf(w.x, x[4 * c4 + 0], a[0]);
      a[1] = fmaf(w.y, x[4 * c4 + 1], a[1]);
      a[2] = fmaf(w.z, x[4 * c4 + 2], a[2]);
      a[3] = fmaf(w.w, x[4 * c4 + 3], a[3]);
    }
    const float h =
        round_to<E>(softplus(((a[0] + a[1]) + (a[2] + a[3])) + b1s[j]));
    const float4* w2row = reinterpret_cast<const float4*>(w2s + j * OUT_PAD);
#pragma unroll
    for (int k4 = 0; k4 < OUT_PAD / 4; ++k4) {
      const float4 w = w2row[k4];
      o[4 * k4 + 0] = fmaf(w.x, h, o[4 * k4 + 0]);
      o[4 * k4 + 1] = fmaf(w.y, h, o[4 * k4 + 1]);
      o[4 * k4 + 2] = fmaf(w.z, h, o[4 * k4 + 2]);
      o[4 * k4 + 3] = fmaf(w.w, h, o[4 * k4 + 3]);
    }
  }
}

}  // namespace p2p3d
