// Fused decode + composite for the frustum renderer (serving forward).
//
// Replaces the TPU kernel pix2pix3d_tpu/ops/render_pallas.py::
// fused_decode_composite (kernel bodies _make_kernel and _make_kernel_chunk).
// For each image and ray, over the T depth slabs in order:
//     h = softplus(W1t[128,32] . x[32] + b1)           (h rounded to the
//     o = W2t[128,128] . h + b2                          compute type)
//     colors = o[0:64] with the sigmoid clamp s(o)*1.002-0.001 on rows 0:32
//              (rgb, always) and, if sem_sigmoid, 32:64; sigma = o[64] (raw)
//     front-to-back midpoint composite with depth d = t * |dir| and the
//     1e-10 transmittance epsilon (render_pallas.py:28-33).
// Outputs the unnormalized acc_rgb [N,64,R], acc_d [N,R], acc_w [N,R] (f32).
//
// Bound at the main-path shape (seg2cat serving: N=1, T=64, R=128^2=16384,
// bf16 features, sem_sigmoid off), worked out from the code; chip_smoke.py
// computes the same three terms from the inputs of each run:
//   - Bytes: feats T*32*R*2 B = 67 MB + outputs 66*R*4 B = 4.3 MB, about
//     71.6 MB per image, 21 us at 3.35 TB/s.
//   - Products: 17.3 GFLOP per image, 17.5 us at 989 TFLOP/s (bf16 tensor
//     cores).  W1t is dense (32*128 MACs per sample); of W2t only the 65
//     rows the composite reads count, and the packed lateSeparate W2t is
//     block-diagonal, so they hold 64*64 + 64 nonzero weights: 8,256 MACs
//     per sample, 2*T*R*8256 FLOP.
//   - Transcendentals: per sample exp + log for each of the 128 softplus
//     hidden units and exp + reciprocal for each of the 32 clamped rgb
//     colors; per composite step exp + log (softplus) and exp (alpha):
//     323 special-function operations per sample, 339 M per image.  At 16
//     per clock per SM (132 SMs at 1.98 GHz, 4.2 T/s) that is 81 us.
//   The special-function units, not memory or the tensor cores, bound this
//   function: a faster design meets ~81 us first.
// This first design makes no attempt on that bound: one thread per ray
// runs both products as plain f32 FMA loops on the CUDA cores (it computes
// all 65 W2t rows densely) with the weights broadcast from shared memory,
// and accurate expf/log1pf.  On an H100 SXM (700 W) it takes ~2.8 ms at the
// main-path shape, about 35x the bound: the FMA chains and the software
// expf/log1pf sequences stall at 4 warps per SM (PERF.md).
//
// Design: one block per (ray tile of RAYS rays, image); thread = ray.  The
// sequential TPU grid axis over slabs becomes the loop over t inside the
// thread, so the composite carry never leaves the SM: prev_c and acc_c in
// shared memory (a private column per thread), the scalars in registers.
// Both TPU grid variants (per slab, per chunk) compute the same math; this
// one loop replaces both.  bf16 inputs are widened to f32 exactly, so the
// f32 FMAs reproduce bf16-in / f32-accumulate products; h (and, without
// carry_f32, the colors) are rounded to bf16 where the TPU kernel casts.
//
// The per-sample MLP (decode_sample) and the weights' shared-memory layout
// are in late_separate_mlp.cuh, which late_separate_decode.cu shares.
//
// The plain PyTorch version is decode_composite_plain() in
// pix2pix3d_tpu_torch/ops/decode_composite.py; the CPU tests hold it
// against the JAX kernel, chip_smoke.py holds this kernel against it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_composite.so decode_composite.cu
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "late_separate_mlp.cuh"

namespace {

using namespace p2p3d;

constexpr int RAYS = 64;      // rays per block, one per thread

constexpr size_t SMEM_FLOATS =
    HID * C_IN + HID * OUT_PAD + HID + OUT_PAD + 2 * N_COL * RAYS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <typename E>
__global__ void __launch_bounds__(RAYS)
decode_composite_kernel(const E* __restrict__ feats,
                        const float* __restrict__ t_vals,
                        const float* __restrict__ dnorm,
                        const E* __restrict__ w1t, const float* __restrict__ b1,
                        const E* __restrict__ w2t, const float* __restrict__ b2,
                        float* __restrict__ acc_rgb, float* __restrict__ acc_d,
                        float* __restrict__ acc_w, int CH, int N, int TC, int R,
                        int sem_sigmoid, int carry_f32) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                      // [HID][C_IN]   = W1t
  float* w2s = w1s + HID * C_IN;          // [HID][OUT_PAD] = W2t^T, rows < 65
  float* b1s = w2s + HID * OUT_PAD;       // [HID]
  float* b2s = b1s + HID;                 // [OUT_PAD]
  float* prev_c = b2s + OUT_PAD;          // [N_COL][RAYS]
  float* acc_c = prev_c + N_COL * RAYS;   // [N_COL][RAYS]

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int r = blockIdx.x * RAYS + tid;
  const int n_slabs = CH * TC;

  for (int i = tid; i < HID * C_IN; i += RAYS) w1s[i] = to_f(w1t[i]);
  for (int i = tid; i < HID * OUT_PAD; i += RAYS) {
    const int j = i / OUT_PAD, k = i % OUT_PAD;
    w2s[i] = k < N_OUT ? to_f(w2t[k * HID + j]) : 0.f;
  }
  for (int i = tid; i < HID; i += RAYS) b1s[i] = b1[i];
  for (int i = tid; i < OUT_PAD; i += RAYS) b2s[i] = i < N_OUT ? b2[i] : 0.f;
  __syncthreads();
  if (r >= R) return;

  const float dn = dnorm[(size_t)n * R + r];
  float prev_s = 0.f, prev_d = 0.f, trans = 1.f, acc_dd = 0.f, acc_ww = 0.f;

  for (int t = 0; t < n_slabs; ++t) {
    const int ch = t / TC, tc = t - ch * TC;
    const E* xp = feats + ((((size_t)ch * N + n) * TC + tc) * C_IN) * R + r;
    float x[C_IN];
#pragma unroll
    for (int c = 0; c < C_IN; ++c) x[c] = to_f(xp[(size_t)c * R]);

    float o[OUT_PAD];
    decode_sample<E>(x, w1s, b1s, w2s, o);

    const float s = o[N_COL] + b2s[N_COL];
    const float d = t_vals[(size_t)n * n_slabs + t] * dn;
    float half_w = 0.f;
    if (t > 0) {
      const float delta = d - prev_d;
      const float sig_mid = softplus((prev_s + s) * 0.5f - 1.f);
      const float alpha = 1.f - expf(-sig_mid * delta);
      const float w = alpha * trans;
      half_w = 0.5f * w;
      acc_dd += half_w * (prev_d + d);
      acc_ww += w;
      trans *= 1.f - alpha + 1e-10f;
    }
#pragma unroll
    for (int k = 0; k < N_COL; ++k) {
      float c = o[k] + b2s[k];
      if (k < 32 || sem_sigmoid) c = sigmoid_clamp(c);
      if (!carry_f32) c = round_to<E>(c);
      float* pc = prev_c + k * RAYS + tid;
      float* ac = acc_c + k * RAYS + tid;
      if (t > 0) {
        *ac += half_w * (*pc + c);
      } else {
        *ac = 0.f;
      }
      *pc = c;
    }
    prev_s = s;
    prev_d = d;
  }

#pragma unroll 4
  for (int k = 0; k < N_COL; ++k)
    acc_rgb[((size_t)n * N_COL + k) * R + r] = acc_c[k * RAYS + tid];
  acc_d[(size_t)n * R + r] = acc_dd;
  acc_w[(size_t)n * R + r] = acc_ww;
}

template <typename E>
cudaError_t launch(const void* feats, const void* t_vals, const void* dnorm,
                   const void* w1t, const void* b1, const void* w2t,
                   const void* b2, void* acc_rgb, void* acc_d, void* acc_w,
                   int CH, int N, int TC, int R, int sem_sigmoid,
                   int carry_f32, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_composite_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + RAYS - 1) / RAYS, N);
  decode_composite_kernel<E><<<grid, RAYS, SMEM_BYTES, stream>>>(
      static_cast<const E*>(feats), static_cast<const float*>(t_vals),
      static_cast<const float*>(dnorm), static_cast<const E*>(w1t),
      static_cast<const float*>(b1), static_cast<const E*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(acc_rgb),
      static_cast<float*>(acc_d), static_cast<float*>(acc_w), CH, N, TC, R,
      sem_sigmoid, carry_f32);
  return cudaGetLastError();
}

}  // namespace

// feats [CH, N, TC, 32, R] (f32 or bf16 as is_bf16 says), t_vals [N, CH*TC],
// dnorm [N, R], w1t [128, 32] and w2t [128, 128] in the feats type, b1 and
// b2 [128] f32; outputs acc_rgb [N, 64, R], acc_d [N, R], acc_w [N, R] f32.
// All contiguous, all on the current device.
extern "C" int p2p3d_decode_composite(
    const void* feats, const void* t_vals, const void* dnorm, const void* w1t,
    const void* b1, const void* w2t, const void* b2, void* acc_rgb,
    void* acc_d, void* acc_w, int CH, int N, int TC, int R, int is_bf16,
    int sem_sigmoid, int carry_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(feats, t_vals, dnorm, w1t, b1, w2t, b2,
                                      acc_rgb, acc_d, acc_w, CH, N, TC, R,
                                      sem_sigmoid, carry_f32, s)
              : launch<float>(feats, t_vals, dnorm, w1t, b1, w2t, b2, acc_rgb,
                              acc_d, acc_w, CH, N, TC, R, sem_sigmoid,
                              carry_f32, s);
  return static_cast<int>(err);
}
