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
// Design.  The TPU kernel's sequential grid axis over slabs becomes a loop
// over t inside the block, so the composite carry never leaves the SM.
//   - bf16 (the serving path): a block of 8 warps owns 64 rays of one
//     image, 4 tiles of 16 rays, the M dimension of the mma.sync products
//     (late_separate_mlp.cuh, warp_branch): softplus on the accumulators in
//     registers, W2's two live blocks only.  Each tile has two warps that
//     split the MLP by branch: the semantic warp (hidden 64:128, 5 W2
//     n8-tiles) holds sigma and runs the composite's alpha, transmittance
//     and depth terms, and hands each ray's weight to the rgb warp (hidden
//     0:64, 4 n8-tiles) through shared memory; the rgb warp adds its colors
//     one slab later, after the barrier that makes the weight visible.  So
//     at batch 1 the 16,384 rays give 2,048 warps, ~16 per SM.  Each lane
//     keeps the running sums and previous colors of its 2 rays x 16 colors
//     in registers (32 + 32 f32); the quad's lane 0 holds a ray's sigma and __shfl_sync hands it
//     to the quad.  Each slab's [32 x 64 rays] feature tile is staged in
//     shared memory with cp.async, double-buffered across slabs so the next
//     slab loads while this one computes, and read as A fragments with
//     ldmatrix.trans (the features are rays-fastest: A column-major).  The
//     sem_sigmoid and carry_f32 switches are template parameters.  One
//     warp per tile (one loop, no weight handoff, ~8 warps per SM) computes
//     the same and is simpler, but timed 7-9% slower than this split on
//     the H100 (chip_smoke.py on both designs in one run; PERF.md).
//   - f32 (off the serving path: the fused-vs-unfused check): the first
//     design, one thread per ray running decode_sample's FP32 FMA loops
//     over W1 and W2's live blocks, colors in a private shared-memory
//     column per thread.
// The transcendentals are the special-function units' approximations
// (__expf, __logf, __fdividef); the gates against the plain version are
// those of the first design's accurate expf/log1pf.  bf16 inputs are exact
// in f32, so the products are bf16-in / f32-accumulate; h (and, without
// carry_f32, the colors) are rounded to bf16 where the TPU kernel casts.
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
#include <cstdint>

#include "late_separate_mlp.cuh"

namespace {

using namespace p2p3d;

constexpr unsigned FULL = 0xffffffffu;

// ---- bf16: warp tiles on the tensor cores --------------------------------

constexpr int TILES = 4;                    // ray tiles per block
constexpr int TILE = 16;                    // rays per tile
constexpr int BLOCK_RAYS = TILES * TILE;    // 64
constexpr int THREADS = 2 * TILES * 32;     // a semantic and an rgb warp per tile
constexpr int XPITCH = BLOCK_RAYS + 8;      // 144 B rows: ldmatrix without
                                            // bank conflicts
struct TileSmem {
  WarpMlpSmem mlp;
  __nv_bfloat16 x[2][C_IN][XPITCH];         // two slabs' feature tiles
  float b2[72];
  float half_w[2][TILES][TILE];             // per slab parity: 0.5 * weight
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

// Stages one slab's [32 x BLOCK_RAYS] features (src = the slab's [32, R]
// plane) into dst: 16-byte cp.async where the chunk is whole and aligned,
// element loads with zero fill at the ragged edge.
__device__ __forceinline__ void load_slab(__nv_bfloat16 (*dst)[XPITCH],
                                          const __nv_bfloat16* __restrict__ src,
                                          int R, int r0, bool vec, int tid) {
  for (int i = tid; i < C_IN * (BLOCK_RAYS / 8); i += THREADS) {
    const int c = i / (BLOCK_RAYS / 8), q = i % (BLOCK_RAYS / 8);
    const int r = r0 + 8 * q;
    __nv_bfloat16* d = &dst[c][8 * q];
    const __nv_bfloat16* g = src + (size_t)c * R + r;
    if (vec && r + 8 <= R) {
      cp_async16(d, g);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = r + e < R ? g[e] : __float2bfloat16(0.f);
    }
  }
}

// The 32 colors of one branch held by a lane (its first 4 n8-tiles: rows
// g, g+8 x 8 columns): b2 added, the clamp if CLAMP, rounded to bf16 unless
// CARRY_F32.
template <bool CLAMP, bool CARRY_F32, int NT>
__device__ __forceinline__ void colors_of(const float (&o)[NT][4],
                                          const float (&bias)[4][2],
                                          float (&c)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = o[j][e] + bias[j][e & 1];
      if (CLAMP) v = sigmoid_clamp(v);
      c[j][e] = CARRY_F32 ? v : round_to<__nv_bfloat16>(v);
    }
  }
}

// The composite's color step: acc += half_w * (prev + c), prev = c; the
// first slab only sets prev.
__device__ __forceinline__ void add_colors(const float (&c)[4][4],
                                           const float (&half_w)[2], bool first,
                                           float (&prev)[4][4],
                                           float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = first ? 0.f : fmaf(half_w[e >> 1], prev[j][e] + c[j][e], acc[j][e]);
      prev[j][e] = c[j][e];
    }
  }
}

// Block: TILES ray tiles of 16 rays, each with two warps that split the MLP
// by branch.  The semantic warp (hidden 64:128) has sigma: it runs the
// composite's alpha, transmittance and depth terms and publishes each
// ray's half weight in shared memory; the rgb warp (hidden 0:64) adds its
// colors one slab later, after the block barrier that makes that weight
// visible.  Each warp keeps its 32 running sums and 32 previous colors in
// registers; each role has its own loop, so neither holds the other's
// state.  Both loops pass the same barriers.
template <bool SEM_SIGMOID, bool CARRY_F32>
__global__ void __launch_bounds__(THREADS, 2)
decode_composite_bf16(const __nv_bfloat16* __restrict__ feats,
                      const float* __restrict__ t_vals,
                      const float* __restrict__ dnorm,
                      const __nv_bfloat16* __restrict__ w1t,
                      const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2t,
                      const float* __restrict__ b2, float* __restrict__ acc_rgb,
                      float* __restrict__ acc_d, float* __restrict__ acc_w,
                      int CH, int N, int TC, int R, int vec) {
  __shared__ __align__(16) TileSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = warp % TILES;
  const bool sem_warp = warp < TILES;
  const int n = blockIdx.y, r0 = blockIdx.x * BLOCK_RAYS;
  const int n_slabs = CH * TC;

  // W1 (row = channel, col = hidden) is w1t [128, 32]; W2 (row = hidden,
  // col = output) is w2t [128, 128]
  stage_warp_mlp(Mat{w1t, 1, C_IN}, Mat{w2t, 1, HID}, b1, sm.mlp, tid, THREADS);
  for (int i = tid; i < 72; i += THREADS) sm.b2[i] = i < N_OUT ? b2[i] : 0.f;

  auto slab = [&](int t) {
    const int ch = t / TC, tc = t - ch * TC;
    return feats + (((size_t)ch * N + n) * TC + tc) * C_IN * R;
  };
  load_slab(sm.x[0], slab(0), R, r0, vec, tid);
  cp_async_commit();
  __syncthreads();   // b2 and the fragments

  const int g = lane / 4, q2 = 2 * (lane % 4);
  const int ray[2] = {r0 + tile * TILE + g, r0 + tile * TILE + g + 8};
  const int col0 = sem_warp ? 32 : 0;      // the warp's 32 output colors
  // ldmatrix row addresses: lanes 8m..8m+7 give the rows of matrix m,
  // m = (channel half) * 2 + (ray half)
  const int lm = lane / 8, li = lane % 8;
  const int x_ch = li + 8 * (lm >> 1), x_ray = tile * TILE + 8 * (lm & 1);

  // Waits for slab t, starts loading slab t+1, and reads slab t's A
  // fragments.
  auto next_slab = [&](int t, uint32_t (&xa)[2][4]) {
    if (t + 1 < n_slabs) load_slab(sm.x[(t + 1) & 1], slab(t + 1), R, r0, vec, tid);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    ldmatrix_x4_trans(xa[0], &sm.x[t & 1][x_ch][x_ray]);
    ldmatrix_x4_trans(xa[1], &sm.x[t & 1][16 + x_ch][x_ray]);
  };
  auto bias_of = [&](float (&bias)[4][2]) {   // b2 at the lane's columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) bias[j][u] = sm.b2[col0 + 8 * j + q2 + u];
    }
  };

  float prev[4][4] = {}, acc[4][4] = {};
  if (sem_warp) {
    const float b_sig = sm.b2[N_COL];
    float dn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) dn[i] = ray[i] < R ? dnorm[(size_t)n * R + ray[i]] : 0.f;
    float prev_s[2] = {0.f, 0.f}, prev_d[2] = {0.f, 0.f};
    float trans[2] = {1.f, 1.f}, acc_dd[2] = {0.f, 0.f}, acc_ww[2] = {0.f, 0.f};
    for (int t = 0; t < n_slabs; ++t) {
      uint32_t xa[2][4];
      next_slab(t, xa);
      float o[SEM_TILES][4];
      warp_branch<1>(xa, sm.mlp, lane, o);
      // sigma (output col 64) of rays g and g+8 sits in the quad's lane 0
      float s[2];
      s[0] = __shfl_sync(FULL, o[SEM_TILES - 1][0], lane & ~3) + b_sig;
      s[1] = __shfl_sync(FULL, o[SEM_TILES - 1][2], lane & ~3) + b_sig;
      const float tv = t_vals[(size_t)n * n_slabs + t];
      float half_w[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float d = tv * dn[i];
        if (t > 0) {
          const float delta = d - prev_d[i];
          const float sig_mid = softplus((prev_s[i] + s[i]) * 0.5f - 1.f);
          const float alpha = 1.f - __expf(-sig_mid * delta);
          const float w = alpha * trans[i];
          half_w[i] = 0.5f * w;
          acc_dd[i] += half_w[i] * (prev_d[i] + d);
          acc_ww[i] += w;
          trans[i] *= 1.f - alpha + 1e-10f;
        }
        prev_s[i] = s[i];
        prev_d[i] = d;
      }
      if (lane % 4 == 0) {
        sm.half_w[t & 1][tile][g] = half_w[0];
        sm.half_w[t & 1][tile][g + 8] = half_w[1];
      }
      float bias[4][2], c[4][4];
      bias_of(bias);
      colors_of<SEM_SIGMOID, CARRY_F32>(o, bias, c);
      add_colors(c, half_w, t == 0, prev, acc);
      __syncthreads();   // this slab's buffer is refilled next iteration
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ray[i] >= R) continue;
        acc_d[(size_t)n * R + ray[i]] = acc_dd[i];
        acc_w[(size_t)n * R + ray[i]] = acc_ww[i];
      }
    }
  } else {
    float pending[4][4];                  // the last slab's colors
    for (int t = 0; t < n_slabs; ++t) {
      uint32_t xa[2][4];
      next_slab(t, xa);
      if (t > 0) {   // slab t-1's colors, with the weight published for it
        const float half_w[2] = {sm.half_w[(t - 1) & 1][tile][g],
                                 sm.half_w[(t - 1) & 1][tile][g + 8]};
        add_colors(pending, half_w, t == 1, prev, acc);
      }
      float o[RGB_TILES][4], bias[4][2];
      warp_branch<0>(xa, sm.mlp, lane, o);
      bias_of(bias);
      colors_of<true, CARRY_F32>(o, bias, pending);
      __syncthreads();   // this slab's buffer is refilled next iteration
    }
    const int t = n_slabs - 1;
    const float half_w[2] = {sm.half_w[t & 1][tile][g], sm.half_w[t & 1][tile][g + 8]};
    add_colors(pending, half_w, t == 0, prev, acc);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ray[e >> 1];
      if (r < R)
        acc_rgb[((size_t)n * N_COL + col0 + 8 * j + q2 + (e & 1)) * R + r] = acc[j][e];
    }
  }
}

// ---- f32: one thread per ray (the first design) ---------------------------

constexpr int RAYS = 64;      // rays per block, one per thread

constexpr size_t SMEM_FLOATS =
    HID * C_IN + HID * OUT_PAD + HID + OUT_PAD + 2 * N_COL * RAYS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__global__ void __launch_bounds__(RAYS)
decode_composite_f32(const float* __restrict__ feats,
                     const float* __restrict__ t_vals,
                     const float* __restrict__ dnorm,
                     const float* __restrict__ w1t, const float* __restrict__ b1,
                     const float* __restrict__ w2t, const float* __restrict__ b2,
                     float* __restrict__ acc_rgb, float* __restrict__ acc_d,
                     float* __restrict__ acc_w, int CH, int N, int TC, int R,
                     int sem_sigmoid) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                      // [HID][C_IN]    = W1t
  float* w2s = w1s + HID * C_IN;          // [HID][OUT_PAD] = W2, live blocks
  float* b1s = w2s + HID * OUT_PAD;       // [HID]
  float* b2s = b1s + HID;                 // [OUT_PAD]
  float* prev_c = b2s + OUT_PAD;          // [N_COL][RAYS]
  float* acc_c = prev_c + N_COL * RAYS;   // [N_COL][RAYS]

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int r = blockIdx.x * RAYS + tid;
  const int n_slabs = CH * TC;

  stage_sample_mlp<float>(Mat{w1t, 1, C_IN}, Mat{w2t, 1, HID}, b1, w1s, w2s,
                          b1s, tid, RAYS);
  for (int i = tid; i < OUT_PAD; i += RAYS) b2s[i] = i < N_OUT ? b2[i] : 0.f;
  __syncthreads();
  if (r >= R) return;

  const float dn = dnorm[(size_t)n * R + r];
  float prev_s = 0.f, prev_d = 0.f, trans = 1.f, acc_dd = 0.f, acc_ww = 0.f;

  for (int t = 0; t < n_slabs; ++t) {
    const int ch = t / TC, tc = t - ch * TC;
    const float* xp = feats + ((((size_t)ch * N + n) * TC + tc) * C_IN) * R + r;
    float x[C_IN];
#pragma unroll
    for (int c = 0; c < C_IN; ++c) x[c] = xp[(size_t)c * R];

    float o[OUT_PAD];
    decode_sample(x, w1s, b1s, w2s, o);

    const float s = o[N_COL] + b2s[N_COL];
    const float d = t_vals[(size_t)n * n_slabs + t] * dn;
    float half_w = 0.f;
    if (t > 0) {
      const float delta = d - prev_d;
      const float sig_mid = softplus((prev_s + s) * 0.5f - 1.f);
      const float alpha = 1.f - __expf(-sig_mid * delta);
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

template <bool SEM_SIGMOID, bool CARRY_F32>
cudaError_t launch_bf16(const void* feats, const void* t_vals,
                        const void* dnorm, const void* w1t, const void* b1,
                        const void* w2t, const void* b2, void* acc_rgb,
                        void* acc_d, void* acc_w, int CH, int N, int TC, int R,
                        cudaStream_t stream) {
  const int vec = R % 8 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const dim3 grid((R + BLOCK_RAYS - 1) / BLOCK_RAYS, N);
  decode_composite_bf16<SEM_SIGMOID, CARRY_F32><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const float*>(t_vals),
      static_cast<const float*>(dnorm), static_cast<const __nv_bfloat16*>(w1t),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(acc_rgb),
      static_cast<float*>(acc_d), static_cast<float*>(acc_w), CH, N, TC, R, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* feats, const void* t_vals, const void* dnorm,
                       const void* w1t, const void* b1, const void* w2t,
                       const void* b2, void* acc_rgb, void* acc_d, void* acc_w,
                       int CH, int N, int TC, int R, int sem_sigmoid,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_composite_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + RAYS - 1) / RAYS, N);
  decode_composite_f32<<<grid, RAYS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(feats), static_cast<const float*>(t_vals),
      static_cast<const float*>(dnorm), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(acc_rgb),
      static_cast<float*>(acc_d), static_cast<float*>(acc_w), CH, N, TC, R,
      sem_sigmoid);
  return cudaGetLastError();
}

}  // namespace

// feats [CH, N, TC, 32, R] (f32 or bf16 as is_bf16 says), t_vals [N, CH*TC],
// dnorm [N, R], w1t [128, 32] and w2t [128, 128] in the feats type, b1 and
// b2 [128] f32; outputs acc_rgb [N, 64, R], acc_d [N, R], acc_w [N, R] f32.
// All contiguous, all on the current device.  carry_f32 only matters for
// bf16 (f32 colors are f32 either way).
extern "C" int p2p3d_decode_composite(
    const void* feats, const void* t_vals, const void* dnorm, const void* w1t,
    const void* b1, const void* w2t, const void* b2, void* acc_rgb,
    void* acc_d, void* acc_w, int CH, int N, int TC, int R, int is_bf16,
    int sem_sigmoid, int carry_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return static_cast<int>(launch_f32(feats, t_vals, dnorm, w1t, b1, w2t, b2,
                                       acc_rgb, acc_d, acc_w, CH, N, TC, R,
                                       sem_sigmoid, s));
  auto* launch = sem_sigmoid ? (carry_f32 ? launch_bf16<true, true>
                                          : launch_bf16<true, false>)
                             : (carry_f32 ? launch_bf16<false, true>
                                          : launch_bf16<false, false>);
  return static_cast<int>(launch(feats, t_vals, dnorm, w1t, b1, w2t, b2,
                                 acc_rgb, acc_d, acc_w, CH, N, TC, R, s));
}
