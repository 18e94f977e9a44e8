// The lateSeparate decoder as one kernel: both MLPs and their epilogue.
//
// Replaces the TPU kernel pix2pix3d_tpu/ops/decoder_pallas.py::
// late_separate_decode (kernel body _make_kernel).  For each row of
// feats [M, 32] (compute type E, f32 or bf16):
//     h = softplus(x . W1[32,128] + b1)      (f32, h rounded to E)
//     o = h . W2[128,128] + b2               (f32 accumulation)
//     colors[M, 64] = o[0:64] in E, with the sigmoid clamp s(o)*1.002-0.001
//                     on cols 0:32 if rgb_sigmoid and 32:64 if sem_sigmoid
//     sigma[M]      = o[64] rounded to E, stored as f32 (raw density)
// The TPU kernel writes one [M, 128] buffer in E and its caller slices
// colors and casts sigma to f32; this kernel writes only what the function
// returns, with the same roundings.  At f32 the products are FP32 FMAs (the
// TPU kernel runs f32 at Precision.HIGHEST, which TF32 would not match).
// There is no tile and no padding: any M.
//
// Bound, worked out from the code for one chunk of the importance
// renderer (M = 65,536 rows, f32, rgb clamp only); chip_smoke.py computes
// the same three terms from the inputs of each run:
//   - Bytes: feats M*32*4 = 8.4 MB, colors M*64*4 = 16.8 MB, sigma 0.26 MB,
//     25.4 MB, 7.6 us at 3.35 TB/s.
//   - Products: W1 is dense (4,096 MACs a row), W2's 65 live columns hold
//     64*64 + 64 = 4,160 nonzero weights (block-diagonal packing): 8,256
//     MACs a row, 1.08 GFLOP, 16.1 us at 67 TFLOP/s FP32 FMA (bf16 inputs:
//     1.1 us at 989 TFLOP/s on tensor cores).
//   - Transcendentals: exp + log for each of the 128 softplus units, exp +
//     reciprocal for each clamped color: 320 a row, 21 M, 5.0 us at 16
//     per clock per SM (132 SMs at 1.98 GHz).
//   At f32 the FMAs bound it (~16 us); at bf16 the special-function units
//   do (the 12.58 M-row working set of scripts/profile_decoder.py: ~1 ms).
// This first design makes no attempt on that bound: one thread per row
// runs both products as f32 FMA loops on the CUDA cores (it computes all
// 65 live W2 columns densely, zeros included) with the weights broadcast
// from shared memory, and accurate expf/log1pf.  Each block loads the
// weights once and walks rows with a grid stride, so the 52 KB weight
// staging is paid once per resident block, not once per 128 rows.
//
// The per-row MLP (decode_sample) is late_separate_mlp.cuh, shared with
// decode_composite.cu.  The plain PyTorch version is
// late_separate_decode_plain() in
// pix2pix3d_tpu_torch/ops/late_separate_decode.py; the CPU tests hold it
// against the JAX kernel, chip_smoke.py holds this kernel against it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblate_separate_decode.so late_separate_decode.cu
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "late_separate_mlp.cuh"

namespace {

using namespace p2p3d;

constexpr int ROWS = 128;           // threads per block, one row each
constexpr int BLOCKS_PER_SM = 4;    // 52 KB of weights each

constexpr size_t SMEM_FLOATS = HID * C_IN + HID * OUT_PAD + HID + OUT_PAD;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <typename E>
__global__ void __launch_bounds__(ROWS)
late_separate_decode_kernel(const E* __restrict__ feats,
                            const E* __restrict__ w1,
                            const float* __restrict__ b1,
                            const E* __restrict__ w2,
                            const float* __restrict__ b2,
                            E* __restrict__ colors, float* __restrict__ sigma,
                            long long M, int rgb_sigmoid, int sem_sigmoid) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                      // [HID][C_IN]    = W1^T
  float* w2s = w1s + HID * C_IN;          // [HID][OUT_PAD] = W2, cols < 65
  float* b1s = w2s + HID * OUT_PAD;       // [HID]
  float* b2s = b1s + HID;                 // [OUT_PAD]

  const int tid = threadIdx.x;
  for (int i = tid; i < HID * C_IN; i += ROWS) {
    const int j = i / C_IN, c = i % C_IN;
    w1s[i] = to_f(w1[c * HID + j]);
  }
  for (int i = tid; i < HID * OUT_PAD; i += ROWS) {
    const int j = i / OUT_PAD, k = i % OUT_PAD;
    w2s[i] = k < N_OUT ? to_f(w2[j * HID + k]) : 0.f;
  }
  for (int i = tid; i < HID; i += ROWS) b1s[i] = b1[i];
  for (int i = tid; i < OUT_PAD; i += ROWS) b2s[i] = i < N_OUT ? b2[i] : 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * ROWS;
  for (long long row = (long long)blockIdx.x * ROWS + tid; row < M;
       row += stride) {
    const E* xp = feats + row * C_IN;
    float x[C_IN];
#pragma unroll
    for (int c = 0; c < C_IN; ++c) x[c] = to_f(xp[c]);

    float o[OUT_PAD];
    decode_sample<E>(x, w1s, b1s, w2s, o);

    E* cp = colors + row * N_COL;
#pragma unroll
    for (int k = 0; k < N_COL; ++k) {
      float c = o[k] + b2s[k];
      if (k < 32 ? rgb_sigmoid : sem_sigmoid) c = sigmoid_clamp(c);
      cp[k] = from_f<E>(c);
    }
    sigma[row] = round_to<E>(o[N_COL] + b2s[N_COL]);
  }
}

template <typename E>
cudaError_t launch(const void* feats, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* colors, void* sigma,
                   long long M, int rgb_sigmoid, int sem_sigmoid,
                   cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      late_separate_decode_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + ROWS - 1) / ROWS;
  const long long cap = (long long)n_sm * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  late_separate_decode_kernel<E><<<grid, ROWS, SMEM_BYTES, stream>>>(
      static_cast<const E*>(feats), static_cast<const E*>(w1),
      static_cast<const float*>(b1), static_cast<const E*>(w2),
      static_cast<const float*>(b2), static_cast<E*>(colors),
      static_cast<float*>(sigma), M, rgb_sigmoid, sem_sigmoid);
  return cudaGetLastError();
}

}  // namespace

// feats [M, 32], w1 [32, 128] and w2 [128, 128] in the compute type (f32,
// or bf16 if is_bf16), b1 and b2 [128] f32; outputs colors [M, 64] in the
// compute type and sigma [M] f32.  All contiguous, all on the current
// device.
extern "C" int p2p3d_late_separate_decode(const void* feats, const void* w1,
                                          const void* b1, const void* w2,
                                          const void* b2, void* colors,
                                          void* sigma, long long M,
                                          int is_bf16, int rgb_sigmoid,
                                          int sem_sigmoid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(feats, w1, b1, w2, b2, colors, sigma, M,
                                      rgb_sigmoid, sem_sigmoid, s)
              : launch<float>(feats, w1, b1, w2, b2, colors, sigma, M,
                              rgb_sigmoid, sem_sigmoid, s);
  return static_cast<int>(err);
}
