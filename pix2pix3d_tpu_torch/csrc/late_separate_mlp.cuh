// The lateSeparate decoder's per-sample MLP, shared by decode_composite.cu
// and late_separate_decode.cu.
//
// The decoder's two 32 -> 64 -> 33 MLPs are packed side by side
// (ops/decode_composite.py::fuse_late_separate_params):
//     h = softplus(x[32] . W1[32,128] + b1)        (f32, then rounded to E)
//     o = h . W2[128,128]                           (f32 accumulation)
// W2 is block-diagonal, and only two blocks are live: W2[0:64, 0:32] (the
// rgb MLP: hidden units 0:64 -> rgb features, cols 0:32) and
// W2[64:128, 32:65] (the semantic MLP: hidden units 64:128 -> semantic
// features, cols 32:64, and sigma, col 64).  Everything here reads only
// those two blocks; the rest of W2 is never loaded.  The caller adds b2 and
// applies its epilogue.
//
// Two forms:
//   - bf16 (E = __nv_bfloat16): a warp computes a tile of 16 samples (rows)
//     on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//     Rows are the M dimension, so the f32 accumulator fragment of the
//     first product (row lane/4, cols 2*(lane%4)+{0,1}) has the layout of
//     the A fragment of the second: softplus runs on the accumulators in
//     registers, h is rounded to bf16 and packed in place, and h never
//     goes to shared memory.  One branch at a time (rgb: hidden 0:64 ->
//     4 n8-tiles of W2; semantic: hidden 64:128 -> 5 n8-tiles, sigma in
//     the 5th padded with zeros): 32 + 36 MMAs per tile, not 32 + 72.
//     The weights' B fragments are staged once per block in shared memory
//     in fragment order (WarpMlpSmem, stage_warp_mlp), one 8-byte load per
//     lane and MMA.
//   - f32 (E = float): decode_sample, one thread per sample, FP32 FMAs
//     (the first design; only decode_composite's f32 form, which is off the
//     serving path, still uses it).
// The transcendentals are the hardware approximations (ex2/lg2/rcp on the
// special-function units through __expf/__logf/__fdividef).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace p2p3d {

constexpr int C_IN = 32;      // feature channels
constexpr int HID = 128;      // hidden units (both MLPs side by side)
constexpr int N_OUT = 65;     // live columns of W2 (64 colors + sigma)
constexpr int OUT_PAD = 68;   // row stride of decode_sample's W2 (float4)
constexpr int N_COL = 64;     // colors (rgb features + semantic features)
constexpr int HALF = 64;      // hidden units of one branch

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

// jax.nn.softplus: log(1 + exp(v)) = max(v, 0) + log1p(exp(-|v|)), with the
// special-function units' exp and log (two MUFU operations)
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + __logf(1.f + __expf(-fabsf(v)));
}

// MipNeRF sigmoid clamp
__device__ __forceinline__ float sigmoid_clamp(float v) {
  return __fdividef(1.f, 1.f + __expf(-v)) * 1.002f - 0.001f;
}

// Element (row, col) of a weight matrix given by its two strides: the
// kernels take W1 and W2 either as they are or transposed.
struct Mat {
  const void* p;
  int s_row, s_col;
};

template <typename E>
__device__ __forceinline__ float at(const Mat& m, int r, int c) {
  return to_f(static_cast<const E*>(m.p)[(size_t)r * m.s_row + (size_t)c * m.s_col]);
}

// ---------------------------------------------------------------------------
// f32, one thread per sample (decode_composite's f32 form).
//
// Shared-memory layout of the weights:
//     w1s[j * C_IN + c]     = W1[c][j]            (f32)
//     w2s[j * OUT_PAD + k]  = W2[j][k] for the live block of row j
//                             (k < 32 if j < 64, 32 <= k < 65 if j >= 64),
//                             0 elsewhere
//     b1s[j]                = b1[j]
// o[k] = sum_j softplus(x . W1[:, j] + b1[j]) * W2[j][k] for k < OUT_PAD,
// without b2; each hidden unit feeds only its branch's columns.
__device__ __forceinline__ void decode_sample(const float (&x)[C_IN],
                                              const float* __restrict__ w1s,
                                              const float* __restrict__ b1s,
                                              const float* __restrict__ w2s,
                                              float (&o)[OUT_PAD]) {
#pragma unroll
  for (int k = 0; k < OUT_PAD; ++k) o[k] = 0.f;

  auto hidden = [&](int j) {
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
    return softplus(((a[0] + a[1]) + (a[2] + a[3])) + b1s[j]);
  };
#pragma unroll 2
  for (int j = 0; j < HALF; ++j) {            // rgb: cols 0:32
    const float h = hidden(j);
    const float4* w2row = reinterpret_cast<const float4*>(w2s + j * OUT_PAD);
#pragma unroll
    for (int k4 = 0; k4 < 8; ++k4) {
      const float4 w = w2row[k4];
      o[4 * k4 + 0] = fmaf(w.x, h, o[4 * k4 + 0]);
      o[4 * k4 + 1] = fmaf(w.y, h, o[4 * k4 + 1]);
      o[4 * k4 + 2] = fmaf(w.z, h, o[4 * k4 + 2]);
      o[4 * k4 + 3] = fmaf(w.w, h, o[4 * k4 + 3]);
    }
  }
#pragma unroll 2
  for (int j = HALF; j < HID; ++j) {          // semantic + sigma: cols 32:68
    const float h = hidden(j);
    const float4* w2row = reinterpret_cast<const float4*>(w2s + j * OUT_PAD);
#pragma unroll
    for (int k4 = 8; k4 < OUT_PAD / 4; ++k4) {
      const float4 w = w2row[k4];
      o[4 * k4 + 0] = fmaf(w.x, h, o[4 * k4 + 0]);
      o[4 * k4 + 1] = fmaf(w.y, h, o[4 * k4 + 1]);
      o[4 * k4 + 2] = fmaf(w.z, h, o[4 * k4 + 2]);
      o[4 * k4 + 3] = fmaf(w.w, h, o[4 * k4 + 3]);
    }
  }
}

// Stages decode_sample's weights (f32 layout above) with `nthreads`
// threads; W1 and W2 as Mats of E.
template <typename E>
__device__ __forceinline__ void stage_sample_mlp(const Mat& w1, const Mat& w2,
                                                 const float* __restrict__ b1,
                                                 float* w1s, float* w2s,
                                                 float* b1s, int tid,
                                                 int nthreads) {
  for (int i = tid; i < HID * C_IN; i += nthreads)
    w1s[i] = at<E>(w1, i % C_IN, i / C_IN);
  for (int i = tid; i < HID * OUT_PAD; i += nthreads) {
    const int j = i / OUT_PAD, k = i % OUT_PAD;
    const bool live = j < HALF ? k < 32 : (k >= 32 && k < N_OUT);
    w2s[i] = live ? at<E>(w2, j, k) : 0.f;
  }
  for (int i = tid; i < HID; i += nthreads) b1s[i] = b1[i];
}

// ---------------------------------------------------------------------------
// bf16, a warp per 16-sample tile, mma.sync on the tensor cores.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16x16, 4 x bf16x2): a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..),
//                          a3 (g+8, 2q+8..)
//   B (16x8, 2 x bf16x2):  b0 (k 2q..2q+1, n g), b1 (k 2q+8..2q+9, n g)
//   C (16x8, 4 x f32):     c0, c1 (g, 2q..2q+1), c2, c3 (g+8, 2q..2q+1)

constexpr int W1_FRAGS = 2 * 16;              // 2 k16-steps x 16 n8-tiles
constexpr int RGB_TILES = 4;                  // W2[0:64, 0:32]
constexpr int SEM_TILES = 5;                  // W2[64:128, 32:65], padded to 72
constexpr int W2_FRAGS = 4 * (RGB_TILES + SEM_TILES);   // 4 k16-steps each

struct WarpMlpSmem {
  uint2 w1[W1_FRAGS][32];   // [k-step * 16 + n-tile][lane]
  uint2 w2[W2_FRAGS][32];   // [k-step * 9 + tile][lane]; tiles 0:4 rgb, 4:9 sem
  float b1[HID];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// B fragment of the 16x8 block of W (row = k, col = n) at (k0, n0) for
// `lane`; columns at or past n_end read as 0.
__device__ __forceinline__ uint2 b_fragment(const Mat& w, int k0, int n0,
                                            int n_end, int lane) {
  const int n = n0 + lane / 4, k = k0 + 2 * (lane % 4);
  if (n >= n_end) return make_uint2(0u, 0u);
  return make_uint2(pack_bf16(at<__nv_bfloat16>(w, k, n),
                              at<__nv_bfloat16>(w, k + 1, n)),
                    pack_bf16(at<__nv_bfloat16>(w, k + 8, n),
                              at<__nv_bfloat16>(w, k + 9, n)));
}

// Stages the B fragments of W1 and of W2's two live blocks, and b1, with
// `nthreads` threads.
__device__ __forceinline__ void stage_warp_mlp(const Mat& w1, const Mat& w2,
                                               const float* __restrict__ b1,
                                               WarpMlpSmem& s, int tid,
                                               int nthreads) {
  for (int i = tid; i < W1_FRAGS * 32; i += nthreads) {
    const int f = i / 32, lane = i % 32;
    s.w1[f][lane] = b_fragment(w1, 16 * (f / 16), 8 * (f % 16), HID, lane);
  }
  for (int i = tid; i < W2_FRAGS * 32; i += nthreads) {
    const int f = i / 32, lane = i % 32;
    const int ks = f / 9, tile = f % 9;
    s.w2[f][lane] =
        tile < RGB_TILES
            ? b_fragment(w2, 16 * ks, 8 * tile, 32, lane)
            : b_fragment(w2, HALF + 16 * ks, 32 + 8 * (tile - RGB_TILES),
                         N_OUT, lane);
  }
  for (int i = tid; i < HID; i += nthreads) s.b1[i] = b1[i];
}

// One branch of the tile's MLP.  xa: the A fragments of the tile's
// features (2 k16-steps).  BR 0 is rgb (hidden 0:64 -> W2 tiles 0:4, out
// cols 0:32), BR 1 semantic (hidden 64:128 -> tiles 4:9, out cols 32:72,
// col 64 sigma, 65:72 zero).  out[tile][i] is the C fragment of output
// n8-tile `tile` of the branch, without b2.
template <int BR>
__device__ __forceinline__ void warp_branch(
    const uint32_t (&xa)[2][4], const WarpMlpSmem& s, int lane,
    float (&out)[BR == 0 ? RGB_TILES : SEM_TILES][4]) {
  constexpr int NT = BR == 0 ? RGB_TILES : SEM_TILES;
  constexpr int T0 = BR == 0 ? 0 : RGB_TILES;
  const int q2 = 2 * (lane % 4);
  uint32_t ha[4][4];   // h as A fragments of the second product (4 k16-steps)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float c[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int nt = BR * 8 + 2 * kk + u;      // n8-tile of the hidden layer
      const float b0 = s.b1[8 * nt + q2], b1v = s.b1[8 * nt + q2 + 1];
      c[u][0] = b0;
      c[u][1] = b1v;
      c[u][2] = b0;
      c[u][3] = b1v;
      mma_bf16(c[u], xa[0], s.w1[nt][lane]);
      mma_bf16(c[u], xa[1], s.w1[16 + nt][lane]);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[u][i] = softplus(c[u][i]);
    }
    ha[kk][0] = pack_bf16(c[0][0], c[0][1]);
    ha[kk][1] = pack_bf16(c[0][2], c[0][3]);
    ha[kk][2] = pack_bf16(c[1][0], c[1][1]);
    ha[kk][3] = pack_bf16(c[1][2], c[1][3]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    out[t][0] = out[t][1] = out[t][2] = out[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_bf16(out[t], ha[kk], s.w2[kk * 9 + T0 + t][lane]);
  }
}

}  // namespace p2p3d
