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
// Design (the MLP is late_separate_mlp.cuh's; both forms read only W2's
// two live blocks, W2[0:64, 0:32] and W2[64:128, 32:65]):
//   - bf16: a warp per tile of 16 rows on the tensor cores (mma.sync
//     m16n8k16, warp_branch), the A fragments of the features loaded
//     straight from the row-major [M, 32] input, h kept in registers, the
//     colors stored as bf16 pairs.  Blocks of 4 warps stage the weights'
//     fragments once and walk the tiles with a grid stride.
//   - f32: register micro-tiles on the FP32 FMA units.  A block of 256
//     threads takes 128 rows: the first product as 8 rows x 8 hidden
//     units per thread (each shared-memory weight and feature read feeds 8
//     FMAs from registers), softplus, h through shared memory (H^T), the
//     second product as 8 rows x 4 colors per thread over the live block
//     of its branch, sigma (col 64) by the first 128 threads, one row each.
//     About 100 KB of shared memory and at most 128 registers a thread, so
//     2 blocks (16 warps) fit on an SM.  Grid stride over row tiles.
// The transcendentals are the special-function units' approximations
// (__expf, __logf, __fdividef); the gates against the plain version (f32
// 2e-5, the JAX suite's) are unchanged.
//
// The plain PyTorch version is late_separate_decode_plain() in
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
#include <cstdint>

#include "late_separate_mlp.cuh"

namespace {

using namespace p2p3d;

// ---- bf16: warp tiles on the tensor cores --------------------------------

constexpr int WARPS = 4;

// Stores one branch's colors (its first 4 n8-tiles) of rows ra, rb as bf16
// pairs at columns col0 + 8 j + 2 (lane % 4).
template <int NT>
__device__ __forceinline__ void store_colors(const float (&o)[NT][4],
                                             const float (&bias)[4][2],
                                             bool clamp, int col0, int lane,
                                             long long ra, long long rb,
                                             long long M,
                                             __nv_bfloat16* __restrict__ colors) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = half ? rb : ra;
      float c0 = o[j][2 * half] + bias[j][0];
      float c1 = o[j][2 * half + 1] + bias[j][1];
      if (clamp) {
        c0 = sigmoid_clamp(c0);
        c1 = sigmoid_clamp(c1);
      }
      if (row < M)
        *reinterpret_cast<uint32_t*>(colors + row * N_COL + col) = pack_bf16(c0, c1);
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
late_separate_decode_bf16(const __nv_bfloat16* __restrict__ feats,
                          const __nv_bfloat16* __restrict__ w1,
                          const float* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ w2,
                          const float* __restrict__ b2,
                          __nv_bfloat16* __restrict__ colors,
                          float* __restrict__ sigma, long long M,
                          int rgb_sigmoid, int sem_sigmoid) {
  __shared__ __align__(16) WarpMlpSmem sm;
  __shared__ float b2s[N_OUT];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // W1 [32, 128] (row = channel, col = hidden), W2 [128, 128] as they are
  stage_warp_mlp(Mat{w1, HID, 1}, Mat{w2, HID, 1}, b1, sm, tid, WARPS * 32);
  for (int i = tid; i < N_OUT; i += WARPS * 32) b2s[i] = b2[i];
  __syncthreads();

  const int q2 = 2 * (lane % 4);
  float b_rgb[4][2], b_sem[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      b_rgb[j][u] = b2s[8 * j + q2 + u];
      b_sem[j][u] = b2s[32 + 8 * j + q2 + u];
    }
  }
  const float b_sig = b2s[N_COL];

  const long long tiles = (M + 15) / 16;
  for (long long tile = (long long)blockIdx.x * WARPS + warp; tile < tiles;
       tile += (long long)gridDim.x * WARPS) {
    const long long ra = tile * 16 + lane / 4, rb = ra + 8;
    uint32_t xa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = (i & 1) ? rb : ra;
        const int col = 16 * ks + 8 * (i >> 1) + q2;
        xa[ks][i] = row < M ? __ldg(reinterpret_cast<const unsigned int*>(
                                  feats + row * C_IN + col))
                            : 0u;
      }
    }
    float o_sem[SEM_TILES][4];
    warp_branch<1>(xa, sm, lane, o_sem);
    store_colors<SEM_TILES>(o_sem, b_sem, sem_sigmoid, 32, lane, ra, rb, M,
                            colors);
    if (lane % 4 == 0) {   // output col 64 of rows ra, rb
      if (ra < M) sigma[ra] = round_to<__nv_bfloat16>(o_sem[SEM_TILES - 1][0] + b_sig);
      if (rb < M) sigma[rb] = round_to<__nv_bfloat16>(o_sem[SEM_TILES - 1][2] + b_sig);
    }
    float o_rgb[RGB_TILES][4];
    warp_branch<0>(xa, sm, lane, o_rgb);
    store_colors<RGB_TILES>(o_rgb, b_rgb, rgb_sigmoid, 0, lane, ra, rb, M,
                            colors);
  }
}

// ---- f32: register micro-tiles on the FP32 FMA units -----------------------

constexpr int F_THREADS = 256;
constexpr int BM = 128;          // rows per tile
constexpr int HP = BM + 4;       // row pitch of H^T and X^T

struct F32Smem {
  float w1[C_IN][HID];           // W1
  float w2[HALF][N_COL];         // [k][c] = W2[k][c] (c < 32), W2[64 + k][c]
  float w2sig[HALF];             // W2[64 + k][64]
  float b1[HID];
  float b2[N_OUT + 3];           // padded: h starts on 16 bytes
  alignas(16) float h[HID][HP];  // H^T; X^T [C_IN][HP] aliases its start
};

// Rows and hidden units (or colors) of a thread's micro-tile: 4 + 4 with
// the second group 64 further on, so a warp's 16-byte reads and writes of
// neighbouring threads are neighbours in shared memory.
__device__ __forceinline__ int split4(int base4, int i) {
  return i < 4 ? 4 * base4 + i : HALF + 4 * base4 + (i - 4);
}

__global__ void __launch_bounds__(F_THREADS, 2)
late_separate_decode_f32(const float* __restrict__ feats,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         float* __restrict__ colors, float* __restrict__ sigma,
                         long long M, int rgb_sigmoid, int sem_sigmoid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(smem_raw);
  float (*xt)[HP] = sm.h;        // X^T, rows 0:32 of the H^T buffer
  const int tid = threadIdx.x;

  for (int i = tid; i < C_IN * HID; i += F_THREADS) sm.w1[i / HID][i % HID] = w1[i];
  for (int i = tid; i < HALF * N_COL; i += F_THREADS) {
    const int k = i / N_COL, c = i % N_COL;
    sm.w2[k][c] = c < 32 ? w2[k * HID + c] : w2[(HALF + k) * HID + c];
  }
  for (int i = tid; i < HALF; i += F_THREADS) sm.w2sig[i] = w2[(HALF + i) * HID + N_COL];
  for (int i = tid; i < HID; i += F_THREADS) sm.b1[i] = b1[i];
  for (int i = tid; i < N_OUT; i += F_THREADS) sm.b2[i] = b2[i];

  const int rg = tid % 16;       // row group: rows split4(rg, 0..7)
  const int hg = tid / 16;       // hidden group (first product)
  const int cg = tid / 16;       // color group (second product): cols 4cg..
  const int kbase = cg < 8 ? 0 : HALF;   // its branch's hidden units
  const bool clamp = cg < 8 ? rgb_sigmoid : sem_sigmoid;

  const long long tiles = (M + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    __syncthreads();   // the weights; the last tile's reads of H^T
    for (int i = tid; i < BM * (C_IN / 4); i += F_THREADS) {
      const int r = i / (C_IN / 4), c4 = i % (C_IN / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < M)
        v = __ldg(reinterpret_cast<const float4*>(feats + (row0 + r) * C_IN) + c4);
      xt[4 * c4 + 0][r] = v.x;
      xt[4 * c4 + 1][r] = v.y;
      xt[4 * c4 + 2][r] = v.z;
      xt[4 * c4 + 3][r] = v.w;
    }
    __syncthreads();

    // first product: 8 rows x 8 hidden units per thread
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < C_IN; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&xt[k][4 * rg]);
      const float4 xb = *reinterpret_cast<const float4*>(&xt[k][HALF + 4 * rg]);
      const float4 wa = *reinterpret_cast<const float4*>(&sm.w1[k][4 * hg]);
      const float4 wb = *reinterpret_cast<const float4*>(&sm.w1[k][HALF + 4 * hg]);
      const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
    }
    __syncthreads();   // X^T read; H^T overwrites it
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hid = split4(hg, j);
      const float bj = sm.b1[hid];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 v;
        v.x = softplus(acc[4 * half + 0][j] + bj);
        v.y = softplus(acc[4 * half + 1][j] + bj);
        v.z = softplus(acc[4 * half + 2][j] + bj);
        v.w = softplus(acc[4 * half + 3][j] + bj);
        *reinterpret_cast<float4*>(&sm.h[hid][half * HALF + 4 * rg]) = v;
      }
    }
    __syncthreads();

    // second product: 8 rows x 4 colors per thread over its branch's block
    float o[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 16
    for (int k = 0; k < HALF; ++k) {
      const float4 ha = *reinterpret_cast<const float4*>(&sm.h[kbase + k][4 * rg]);
      const float4 hb = *reinterpret_cast<const float4*>(&sm.h[kbase + k][HALF + 4 * rg]);
      const float4 wv = *reinterpret_cast<const float4*>(&sm.w2[k][4 * cg]);
      const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(hv[i], w[j], o[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = row0 + split4(rg, i);
      float4 v;
      float* pv = &v.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = o[i][j] + sm.b2[4 * cg + j];
        pv[j] = clamp ? sigmoid_clamp(c) : c;
      }
      if (row < M) *reinterpret_cast<float4*>(colors + row * N_COL + 4 * cg) = v;
    }
    if (tid < BM && row0 + tid < M) {   // sigma: one row per thread
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < HALF; ++k) s = fmaf(sm.h[HALF + k][tid], sm.w2sig[k], s);
      sigma[row0 + tid] = s + sm.b2[N_COL];
    }
  }
}

// Blocks of `kernel` that fit on the device at once (SMs x blocks per SM);
// the grid strides over the tiles with no more blocks than that.
int grid_size(const void* kernel, int threads, size_t smem, long long tiles,
              cudaError_t* err) {
  int device = 0, n_sm = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     device)) != cudaSuccess)
    return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return 0;
  const long long resident = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  return (int)(tiles < resident ? tiles : resident);
}

cudaError_t launch_bf16(const void* feats, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* colors,
                        void* sigma, long long M, int rgb_sigmoid,
                        int sem_sigmoid, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const int grid = grid_size(reinterpret_cast<const void*>(late_separate_decode_bf16),
                             WARPS * 32, 0, (M + 16 * WARPS - 1) / (16 * WARPS), &err);
  if (err != cudaSuccess) return err;
  late_separate_decode_bf16<<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(colors), static_cast<float*>(sigma), M,
      rgb_sigmoid, sem_sigmoid);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* feats, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* colors,
                       void* sigma, long long M, int rgb_sigmoid,
                       int sem_sigmoid, cudaStream_t stream) {
  const size_t smem = sizeof(F32Smem);
  cudaError_t err = cudaFuncSetAttribute(
      late_separate_decode_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = grid_size(reinterpret_cast<const void*>(late_separate_decode_f32),
                             F_THREADS, smem, (M + BM - 1) / BM, &err);
  if (err != cudaSuccess) return err;
  late_separate_decode_f32<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(feats), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(colors),
      static_cast<float*>(sigma), M, rgb_sigmoid, sem_sigmoid);
  return cudaGetLastError();
}

}  // namespace

// feats [M, 32], w1 [32, 128] and w2 [128, 128] in the compute type (f32,
// or bf16 if is_bf16), b1 and b2 [128] f32; outputs colors [M, 64] in the
// compute type and sigma [M] f32.  All contiguous, all on the current
// device.  Only W2[0:64, 0:32] and W2[64:128, 32:65] are read.
extern "C" int p2p3d_late_separate_decode(const void* feats, const void* w1,
                                          const void* b1, const void* w2,
                                          const void* b2, void* colors,
                                          void* sigma, long long M,
                                          int is_bf16, int rgb_sigmoid,
                                          int sem_sigmoid, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_bf16(feats, w1, b1, w2, b2, colors, sigma, M,
                            rgb_sigmoid, sem_sigmoid, s)
              : launch_f32(feats, w1, b1, w2, b2, colors, sigma, M,
                           rgb_sigmoid, sem_sigmoid, s);
  return static_cast<int>(err);
}
