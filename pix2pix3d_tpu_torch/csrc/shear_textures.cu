// Both texture-side shears of the frustum render, for every image and plane
// of a batch in one launch.
//
// Replaces no Pallas kernel: the JAX package shears with plain XLA
// (pix2pix3d_tpu/render/frustum.py shear_pass / shear_texture, vmapped in
// prepare_textures), as dense Catmull-Rom band matrices contracted with the
// texture, of which 4 weights in every 256 (or 512) are nonzero.  This
// kernel computes only the 4 live taps on each axis.
//
// For texture k = n*q + plane (K = N*q of them), M = 128 (MARGIN), S the
// plane size and ext = S + 2M:
//     out[k, p, c, o] = sum_y w(y - (p - M + b_k*(o - M)))
//                       * sum_x w(x - (o - M + a_k*y)) * tex_k[y, x, c]
// w is Catmull-Rom, (1.5d - 2.5)d^2 + 1 for d = |.| < 1, ((-0.5d + 2.5)d - 4)d
// + 2 for d < 2, else 0; taps outside [0, S) count as zeros (zero padding).
// tex_k is plane (n, plane) of planes [N, q, S, S, C], transposed when
// flip[k]: the kernel swaps the y and x strides, it copies nothing.  The
// planes are read through their strides (the backbone's [N, q*C, S, S]
// memory as render/frustum.py views it: channel-planar, x contiguous).  The
// output is [K, ext, C, ext] contiguous (rows p, channels, columns o: the
// layout resample_slabs reads), every element written, margins included.
//
// Bound (seg2cat serving, N=32: K=96, S=256, C=32, f32 planes, bf16 out):
// read the planes once, 96*256^2*32*4 B = 805 MB; write the textures once,
// 96*512^2*32*2 B = 1611 MB; 0.72 ms at 3.35 TB/s.  The work is 16 taps an
// output (~26 GFLOP, 0.4 ms at the f32 FMA rate), so memory bounds it.
//
// Design.  The two shears are separable 1-D resamples whose fractional
// offset is constant along a line: the first pass shifts texture row y by
// a*y, the second shifts output column o by b*(o - M).  A block owns one
// texture, one channel and a strip of 64 output columns:
//   1. the 4 x-taps of every texture row (weights and first tap) into
//      shared memory, once;
//   2. pass 1, t1[y][o] for every row y of the texture and the strip's
//      columns, into shared memory (S x 65 f32: 66.5 KB at S = 256), read
//      straight from the planes.  The lanes of a warp run along the texture
//      axis with the smaller stride, so the reads coalesce whether or not
//      the plane is flipped (along x for a plane as it lies, along y for a
//      flipped one; the row stride of 65 keeps both write patterns free of
//      bank conflicts);
//   3. pass 2, each thread one column o and a quarter of the rows p: its 4
//      y-taps' weights stay in registers, and a window of 4 t1 values
//      slides down the column, one shared-memory read an output.  The warp
//      writes 32 adjacent columns of a row.
// Nothing of pass 1 goes to device memory.  Taps and sums are f32 whatever
// the input and output types; the output is rounded once (bf16: to nearest
// even, as torch's cast).  A line whose offset is NaN or so large that no
// tap can land on the texture gives zeros.
//
// The plain PyTorch version is shear_textures_plain() in
// pix2pix3d_tpu_torch/ops/shear_textures.py (the per-texture band-matrix
// shears); the CPU tests hold it against JAX's prepare_textures, and
// chip_smoke.py holds this kernel against it in f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libshear_textures.so shear_textures.cu
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMargin = 128;
constexpr int kStrip = 64;                 // output columns a block
constexpr int kRowStride = kStrip + 1;     // t1's row stride in floats
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kStrip;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float cubic_near(float d) {
  return (1.5f * d - 2.5f) * d * d + 1.0f;
}

__device__ __forceinline__ float cubic_far(float d) {
  return ((-0.5f * d + 2.5f) * d - 4.0f) * d + 2.0f;
}

// The taps of a line shifted by `s`: its output i samples the input at i + s,
// so inputs i + floor(s) - 1 + j (j = 0..3) at distances 1+f, f, 1-f, 2-f,
// f = s - floor(s).  `base` is floor(s).  A line with |s| >= limit (or s
// NaN) reaches no input: zero weights.
__device__ __forceinline__ void cubic_taps(float s, float limit, float4& w,
                                           int& base) {
  if (!(fabsf(s) < limit)) {
    w = make_float4(0.f, 0.f, 0.f, 0.f);
    base = 0;
    return;
  }
  const float fl = floorf(s);
  const float f = s - fl;
  base = static_cast<int>(fl);
  w = make_float4(cubic_far(1.0f + f), cubic_near(f), cubic_near(1.0f - f),
                  cubic_far(2.0f - f));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    cubic_shear_textures(const Tin* __restrict__ planes,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const unsigned char* __restrict__ flip,
                         Tout* __restrict__ out, int q, int S, int C,
                         long long sn, long long sq, long long sy,
                         long long sx, long long sc) {
  extern __shared__ float4 smem[];
  float4* row_w = smem;                                    // [S]
  int* row_base = reinterpret_cast<int*>(row_w + S);       // [S]
  float* t1 = reinterpret_cast<float*>(row_base + S);      // [S][kRowStride]

  const int k = blockIdx.z;
  const int c = blockIdx.y;
  const int o0 = blockIdx.x * kStrip;
  const int ext = S + 2 * kMargin;
  const int tid = threadIdx.x;
  // no tap of a line shifted by S + M + 2 or more lands on the texture
  const float limit = static_cast<float>(S + kMargin + 2);
  // tex_k[y, x] = planes[n, plane, y, x] or, flipped, planes[n, plane, x, y]
  const bool flipped = flip[k] != 0;
  const long long ty = flipped ? sx : sy;
  const long long tx = flipped ? sy : sx;
  const Tin* tex = planes + static_cast<long long>(k / q) * sn +
                   static_cast<long long>(k % q) * sq +
                   static_cast<long long>(c) * sc;

  // 1. each texture row's x-taps: row y is shifted by a*y
  const float ak = a[k];
  for (int y = tid; y < S; y += kThreads) {
    float4 w;
    int base;
    cubic_taps(ak * static_cast<float>(y), limit, w, base);
    row_w[y] = w;
    row_base[y] = base;
  }
  __syncthreads();

  // 2. pass 1: t1[y][ol] = sum_x w(x - (o - M + a*y)) tex[y, x], o = o0 + ol
  auto shear_x = [&](int y, int ol) {
    const float4 w = row_w[y];
    const int x = o0 + ol - kMargin + row_base[y] - 1;
    const Tin* row = tex + static_cast<long long>(y) * ty;
    float acc = 0.f;
    if (static_cast<unsigned>(x) < static_cast<unsigned>(S))
      acc = fmaf(w.x, load(row + static_cast<long long>(x) * tx), acc);
    if (static_cast<unsigned>(x + 1) < static_cast<unsigned>(S))
      acc = fmaf(w.y, load(row + static_cast<long long>(x + 1) * tx), acc);
    if (static_cast<unsigned>(x + 2) < static_cast<unsigned>(S))
      acc = fmaf(w.z, load(row + static_cast<long long>(x + 2) * tx), acc);
    if (static_cast<unsigned>(x + 3) < static_cast<unsigned>(S))
      acc = fmaf(w.w, load(row + static_cast<long long>(x + 3) * tx), acc);
    t1[y * kRowStride + ol] = acc;
  };
  const int cols = min(kStrip, ext - o0);
  if (tx <= ty) {
    // lanes along x: a warp reads a run of one row
    for (int i = tid; i < S * kStrip; i += kThreads) {
      const int y = i / kStrip;
      const int ol = i % kStrip;
      if (ol < cols) shear_x(y, ol);
    }
  } else {
    // lanes along y: a warp reads a run of one column
    const int lane = tid % 32;
    const int warp = tid / 32;
    for (int y0 = 0; y0 < S; y0 += 32) {
      const int y = y0 + lane;
      if (y >= S) continue;
      for (int ol = warp; ol < cols; ol += kThreads / 32) shear_x(y, ol);
    }
  }
  __syncthreads();

  // 3. pass 2: out[p][o] = sum_y w(y - (p - M + b*(o - M))) t1[y][o]
  const int ol = tid % kStrip;
  if (ol >= cols) return;
  const int o = o0 + ol;
  float4 w;
  int base;
  cubic_taps(b[k] * static_cast<float>(o - kMargin), limit, w, base);
  const int rows = (ext + kRowGroups - 1) / kRowGroups;
  const int p_begin = (tid / kStrip) * rows;
  const int p_end = min(ext, p_begin + rows);
  const float* col = t1 + ol;
  auto at = [&](int y) {
    return static_cast<unsigned>(y) < static_cast<unsigned>(S)
               ? col[y * kRowStride]
               : 0.f;
  };
  int y = p_begin - kMargin + base - 1;   // the first tap of row p_begin
  float v0 = at(y), v1 = at(y + 1), v2 = at(y + 2);
  const long long step = static_cast<long long>(C) * ext;
  Tout* dst = out + (static_cast<long long>(k) * ext + p_begin) * step +
              static_cast<long long>(c) * ext + o;
  for (int p = p_begin; p < p_end; ++p, ++y, dst += step) {
    const float v3 = at(y + 3);
    float acc = w.x * v0;
    acc = fmaf(w.y, v1, acc);
    acc = fmaf(w.z, v2, acc);
    acc = fmaf(w.w, v3, acc);
    store(dst, acc);
    v0 = v1;
    v1 = v2;
    v2 = v3;
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* planes, const void* a, const void* b,
                   const void* flip, void* out, int K, int q, int S, int C,
                   long long sn, long long sq, long long sy, long long sx,
                   long long sc, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(S) * (sizeof(float4) + sizeof(int) +
                                kRowStride * sizeof(float));
  auto kernel = cubic_shear_textures<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ext = S + 2 * kMargin;
  const dim3 grid((ext + kStrip - 1) / kStrip, C, K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(planes), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const unsigned char*>(flip),
      static_cast<Tout*>(out), q, S, C, sn, sq, sy, sx, sc);
  return cudaGetLastError();
}

}  // namespace

// planes: [N, q, S, S, C] with element strides (sn, sq, sy, sx, sc), f32 or
// bf16 (in_bf16); a, b: [K] f32; flip: [K] bool (one byte each); out:
// [K, S + 2M, C, S + 2M] contiguous, f32 or bf16 (out_bf16).
extern "C" int p2p3d_shear_textures(const void* planes, const void* a,
                                    const void* b, const void* flip, void* out,
                                    int K, int q, int S, int C, long long sn,
                                    long long sq, long long sy, long long sx,
                                    long long sc, int in_bf16, int out_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = in_bf16 ? (out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>
                                 : launch<__nv_bfloat16, float>)
                     : (out_bf16 ? launch<float, __nv_bfloat16>
                                 : launch<float, float>);
  return static_cast<int>(
      fn(planes, a, b, flip, out, K, q, S, C, sn, sq, sy, sx, sc, s));
}
