// upfirdn2d: pad, upsample, FIR-filter and downsample a batch of NCHW images
// in one pass.
//
// Replaces no Pallas kernel: the JAX package runs this op as plain XLA
// (pix2pix3d_tpu/ops/upfirdn2d.py), and the port's plain composition
// (upfirdn2d_plain in pix2pix3d_tpu_torch/ops/upfirdn2d.py) materialises
// the zero-inserted image (4x the input's bytes at up=2), pads it again,
// correlates it with a grouped depthwise convolution that spends 12 of its
// 16 multiply-adds a pixel on inserted zeros, and with down=2 filters at
// full resolution and then drops 3/4 of the result.  A seg2cat forward
// makes 34 such calls (the mask encoder's downsampling, the backbone's and
// SR's up=2 convolutions and ToRGB skips; the discriminators downsample
// too), the largest on [32, 256, 256, 256] -> [32, 256, 514, 514].
//
// Semantics (torch_utils/ops/upfirdn2d.py _upfirdn2d_ref): for each plane
//     out[oy, ox] = sum_{i,j} g[i, j] * xu[oy*downy - py0 + i, ox*downx - px0 + j]
// with xu the input zero-inserted by (upy, upx) (xu[Y, X] = x[Y/upy, X/upx]
// where both divide, else 0; zeros outside the input) and g the filter,
// flipped on both axes unless flip_filter, times gain.  A 1-D filter of
// `taps` is separable: g[i, j] = f[i] * f[j] (flipped likewise).  Negative
// padding crops; it is index arithmetic here, as all padding is.
//
// Bound: the op reads x once and writes the output once; its work is a few
// multiply-adds a byte, far below the card's balance (~300 FLOP/B), so
// memory bounds it.  SR block 1's conv0 input, bf16: 1.07 GB in, 4.33 GB
// out, 1.6 ms at 3.35 TB/s.
//
// Design: polyphase, in one pass, with nothing but the output written to
// device memory.
//   * An output pixel takes only the taps that land on real input pixels:
//     with up=u, taps i = i0 + k*u (i0 fixed by the output's phase), so the
//     4x4 filter at up=2 costs 2x2 taps, not 16.  With down=d only the kept
//     pixels are computed.
//   * Tiled path (4x4 filters at (up, down) = (2, 1), (1, 1), (1, 2) on both
//     axes, f32 or bf16: what the generators and discriminators run).  A
//     block owns a tile of outputs of one plane after another.  The input
//     rows and columns a tile reads (halo included) are copied with cp.async
//     in 16-, 8- or 4-byte chunks (as x's row length allows; 2-byte rows by
//     plain loads) into shared memory, the next plane's while the block
//     computes this one (two buffers): the copies keep many bytes in flight
//     without registers, and a chunk wholly outside the image is zero-filled
//     by the copy itself, so padding and crops cost nothing.  The tile's
//     origin is placed so that every thread's outputs have compile-time
//     phases: each thread computes a patch of 1-2 columns by 4-16 rows from
//     registers, reading each input value of its footprint once and adding
//     it into every output that takes it (at up=2: 12-18 reads for 16
//     outputs), and stores a row's pair of outputs as one 4- or 8-byte word.
//     A warp writes 32 or 64 adjacent outputs of a row.
//   * Separable path (1-D filters of other sizes, any up and down: the
//     loss's 65-tap blur): a tile's staged input filtered along x into
//     shared memory, then along y, so an output costs ~2*taps multiply-adds,
//     not taps^2.
//   * Generic path (everything else, f64 data too): one thread an
//     output, the filter in shared memory, the live taps found by the same
//     phase arithmetic.
//   * The filter is read from the caller's device buffer; flip and gain are
//     applied as the taps are read.  No host read, no allocation, no sync.
//   * Sums are f32 (f64 for f64 data) and rounded once to x's dtype.  Every
//     output is a gather in a fixed order: no atomics, so a training step
//     repeats bit for bit.
//
// The backward of the op is the same op (pix2pix3d_tpu_torch/ops/upfirdn2d.py
// _Upfirdn2dFunction): up and down swapped, the filter flipped, the adjoint
// padding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libupfirdn2d.so upfirdn2d.cu
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxGridZ = 65535;
constexpr int kGenericThreads = 256;
// the tiled path: one more plane a block for every this many blocks of one
// plane each, up to kMaxPlanesPerBlock
constexpr long long kBlocksPerPlaneStep = 16384;
constexpr long long kMaxPlanesPerBlock = 8;

template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename A>
struct Params {
  const void* x;
  const A* f;          // [fh, fw], or [fw] when separable, or null (a 1x1 one)
  void* y;
  int planes, in_h, in_w, out_h, out_w;
  int upx, upy, downx, downy, px0, py0;
  int fw, fh, separable, flip;
  A gain;
  int shift_y;  // the tiled path's origin shift (output rows)
};

// Tap (i, j) of the correlation: row i (y), column j (x).
template <typename A>
__device__ __forceinline__ A tap(const Params<A>& p, int i, int j) {
  if (p.f == nullptr) return p.gain;
  const int si = p.flip ? i : p.fh - 1 - i;
  const int sj = p.flip ? j : p.fw - 1 - j;
  if (p.separable) return __ldg(p.f + si) * __ldg(p.f + sj) * p.gain;
  return __ldg(p.f + si * p.fw + sj) * p.gain;
}

// ---------------------------------------------------------------- tiled
// The tiled path stages x's own bits in shared memory (copied by cp.async)
// and converts them to the sum's type as it reads them.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float;
  static __device__ __forceinline__ float acc(float r) { return r; }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float acc(unsigned short r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// An asynchronous copy of CPB bytes from device to shared memory; with
// `valid` false it writes CPB zero bytes and reads nothing.  Two bytes (a
// bf16 row of odd length) are copied with a plain load and store.
template <int CPB>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (CPB == 2) {  // below cp.async's smallest copy: a plain load
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src) : 0;
  } else if constexpr (CPB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(valid ? CPB : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "n"(CPB), "r"(valid ? CPB : 0));
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One block: output rows [oy0, oy0 + TH) and columns [ox0, ox0 + TW) of one
// plane after another (blockIdx.z strides over the planes).  Thread (tx, ty)
// computes the OY x OX patch at (oy0 + ty*OY, ox0 + tx*OX).
//   Rows: the tile origin oy0 is shifted up by p.shift_y < UP so that its
// first tap lands on an input row.  Columns: ox0 is a multiple of TW, so
// that a thread's OX outputs can be stored as one vector; the patch is read
// as columns SX.. of a virtual patch starting SX outputs to the left, whose
// first tap lands on an input column (SX < UP, a template argument so that
// every tap's column stays a compile-time offset).
//   Staging: the input rows and columns the tile reads, widened to whole
// CPB-byte chunks (x's row length is a multiple of CPB bytes, so a chunk is
// wholly inside the image or wholly outside it and then reads as zeros),
// copied with cp.async: the next plane's into one of two buffers while the
// block computes this plane from the other.
template <typename T, int UP, int DOWN, int FS, int OX, int OY, int BX, int BY,
          int SX, int CPB>
__global__ void __launch_bounds__(BX* BY)
    upfirdn2d_polyphase_tile(Params<float> p) {
  using R = typename Raw<T>::type;
  constexpr int kThreads = BX * BY;
  constexpr int TW = BX * OX, TH = BY * OY;
  static_assert((OX * DOWN) % UP == 0 && (OY * DOWN) % UP == 0,
                "a thread's patch must span whole phase periods");
  static_assert(OX == 1 || OX == 2, "stores are scalars or pairs");
  constexpr int VEC = CPB / static_cast<int>(sizeof(T));      // elements a chunk
  constexpr int SW = ((TW - 1 + SX) * DOWN + FS - 1) / UP + 1;  // columns read
  constexpr int SH = ((TH - 1) * DOWN + FS - 1) / UP + 1;       // rows read
  constexpr int CH = (SW + 2 * VEC - 2) / VEC;                  // chunks a row
  constexpr int NC = ((OX - 1 + SX) * DOWN + FS - 1) / UP + 1;  // a thread's columns
  constexpr int NR = ((OY - 1) * DOWN + FS - 1) / UP + 1;       // a thread's rows
  __shared__ __align__(16) R s_x[2][SH][CH * VEC];
  __shared__ float s_g[FS][FS];

  const int tid = threadIdx.x;
  const int tx = tid % BX, ty = tid / BX;
  if (tid < FS * FS) s_g[tid / FS][tid % FS] = tap(p, tid / FS, tid % FS);

  const int oy0 = blockIdx.y * TH - p.shift_y;
  const int ox0 = blockIdx.x * TW;
  // the first tap of output (oy0, ox0 - SX) lands on input pixel (row0, col0)
  const int row0 = (oy0 * DOWN - p.py0) / UP;
  const int col0 = ((ox0 - SX) * DOWN - p.px0) / UP;
  const int ca = col0 - pmod(col0, VEC);  // the first chunk's column
  const int off = col0 - ca;
  const int ly = ty * (OY * DOWN / UP), lx = off + tx * (OX * DOWN / UP);
  const int oy_t = oy0 + ty * OY, ox_t = ox0 + tx * OX;
  // a patch wholly outside the output (the ragged last tiles) computes nothing
  const bool live = oy_t + OY > 0 && oy_t < p.out_h && ox_t < p.out_w;
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const long long in_plane = static_cast<long long>(p.in_h) * p.in_w;
  const long long out_plane = static_cast<long long>(p.out_h) * p.out_w;

  auto stage = [&](int plane, int buf) {
    const T* xp = x + plane * in_plane;
    for (int k = tid; k < SH * CH; k += kThreads) {
      const int r = k / CH, q = k - (k / CH) * CH;
      const int iy = row0 + r, ix = ca + q * VEC;
      const bool valid = iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w;
      copy_async<CPB>(&s_x[buf][r][q * VEC],
                      valid ? xp + static_cast<long long>(iy) * p.in_w + ix : x, valid);
    }
    copy_commit();
  };

  if (blockIdx.z < p.planes) stage(blockIdx.z, 0);
  __syncthreads();
  float g[FS][FS];
#pragma unroll
  for (int i = 0; i < FS; ++i)
#pragma unroll
    for (int j = 0; j < FS; ++j) g[i][j] = s_g[i][j];

  int buf = 0;
  for (int plane = blockIdx.z; plane < p.planes; plane += gridDim.z, buf ^= 1) {
    const int next = plane + gridDim.z;
    if (next < p.planes) {
      stage(next, buf ^ 1);
    } else {
      copy_commit();  // an empty group keeps the wait below uniform
    }
    copy_wait_all_but_last();
    __syncthreads();  // every thread's copies of this plane have landed
    if (live) {
      float acc[OY][OX];
#pragma unroll
      for (int t = 0; t < OY; ++t)
#pragma unroll
        for (int u = 0; u < OX; ++u) acc[t][u] = 0.0f;
      // output row t's tap i reads staged row ly + (t*DOWN + i)/UP when UP
      // divides t*DOWN + i (else it lands on an inserted zero); output
      // column u's tap j reads lx + ((u + SX)*DOWN + j)/UP likewise
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        float v[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) v[cc] = Raw<T>::acc(s_x[buf][ly + rr][lx + cc]);
#pragma unroll
        for (int t = 0; t < OY; ++t)
#pragma unroll
          for (int i = 0; i < FS; ++i)
            if (t * DOWN + i == rr * UP)
#pragma unroll
              for (int u = 0; u < OX; ++u)
#pragma unroll
                for (int j = 0; j < FS; ++j)
                  if (((u + SX) * DOWN + j) % UP == 0)
                    acc[t][u] += g[i][j] * v[((u + SX) * DOWN + j) / UP];
      }
#pragma unroll
      for (int t = 0; t < OY; ++t) {
        const int oy = oy_t + t;
        if (oy < 0 || oy >= p.out_h) continue;
        const long long at = plane * out_plane + static_cast<long long>(oy) * p.out_w + ox_t;
        if (OX == 2 && ox_t + 2 <= p.out_w && at % 2 == 0) {
          store2(y + at, acc[t][0], acc[t][OX - 1]);
        } else {
#pragma unroll
          for (int u = 0; u < OX; ++u)
            if (ox_t + u < p.out_w) store(y + at + u, acc[t][u]);
        }
      }
    }
    __syncthreads();  // this buffer is read; the next plane but one may fill it
  }
}

// The smallest shift s in [0, up) with (-s*down - pad) divisible by up: the
// first tap of output -s then lands on an input pixel.  up and down are
// coprime on the tiled path, so one exists.
int origin_shift(int up, int down, int pad) {
  for (int s = 0; s < up; ++s)
    if (pmod(-s * down - pad, up) == 0) return s;
  return -1;
}

template <typename T, int UP, int DOWN, int FS, int OX, int OY, int BX, int BY,
          int SX, int CPB>
cudaError_t launch_tile_as(Params<float> p, cudaStream_t s) {
  constexpr int TW = BX * OX, TH = BY * OY;
  const int tiles_x = (p.out_w + TW - 1) / TW;
  const int tiles_y = (p.out_h + p.shift_y + TH - 1) / TH;
  // several planes a block once there are blocks enough to fill the card:
  // the copy of the next plane then overlaps the work on this one, and the
  // block's set-up (the filter) is paid fewer times
  const long long one_plane_blocks = static_cast<long long>(tiles_x) * tiles_y * p.planes;
  long long per_block = one_plane_blocks / kBlocksPerPlaneStep;
  per_block = per_block < 1 ? 1 : per_block > kMaxPlanesPerBlock ? kMaxPlanesPerBlock : per_block;
  long long grid_z = (p.planes + per_block - 1) / per_block;
  if (grid_z > kMaxGridZ) grid_z = kMaxGridZ;
  const dim3 grid(tiles_x, tiles_y, static_cast<unsigned>(grid_z));
  upfirdn2d_polyphase_tile<T, UP, DOWN, FS, OX, OY, BX, BY, SX, CPB>
      <<<grid, BX * BY, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int UP, int DOWN, int FS, int OX, int OY, int BX, int BY, int SX>
cudaError_t launch_tile_sx(Params<float> p, int cpb, cudaStream_t s) {
  if (cpb == 16) return launch_tile_as<T, UP, DOWN, FS, OX, OY, BX, BY, SX, 16>(p, s);
  if (cpb == 8) return launch_tile_as<T, UP, DOWN, FS, OX, OY, BX, BY, SX, 8>(p, s);
  if constexpr (sizeof(T) == 2) {
    if (cpb == 2) return launch_tile_as<T, UP, DOWN, FS, OX, OY, BX, BY, SX, 2>(p, s);
  }
  return launch_tile_as<T, UP, DOWN, FS, OX, OY, BX, BY, SX, 4>(p, s);
}

template <typename T, int UP, int DOWN, int FS, int OX, int OY, int BX, int BY>
cudaError_t launch_tile(Params<float> p, int cpb, cudaStream_t s) {
  p.shift_y = origin_shift(UP, DOWN, p.py0);
  if (origin_shift(UP, DOWN, p.px0) == 1)
    return launch_tile_sx<T, UP, DOWN, FS, OX, OY, BX, BY, 1 % UP>(p, cpb, s);
  return launch_tile_sx<T, UP, DOWN, FS, OX, OY, BX, BY, 0>(p, cpb, s);
}

// The widest copy (16, 8, 4 or, for 2-byte data, 2 bytes) that x's rows and
// base are aligned to, or 0 where none is (then the generic path runs).
int copy_bytes(const void* x, int in_w, int elem) {
  const auto base = reinterpret_cast<uintptr_t>(x);
  for (int cpb = 16; cpb >= 2; cpb /= 2)
    if (cpb >= elem && (static_cast<long long>(in_w) * elem) % cpb == 0 &&
        base % cpb == 0)
      return cpb;
  return 0;
}

// The tiled path where it applies (4x4 filter, (up, down) = (2, 1), (1, 1)
// or (1, 2) on both axes, f32 or bf16 data); false where another path is
// to run.
template <typename T>
bool try_tile(const Params<float>& p, cudaStream_t s, cudaError_t* err) {
  if (p.fw != 4 || p.fh != 4 || p.upx != p.upy || p.downx != p.downy) return false;
  const int cpb = copy_bytes(p.x, p.in_w, sizeof(T));
  if (cpb == 0) return false;
  // tiles 256 outputs wide at up=2 and 128 at up=1 (rows of 2 warps); at
  // (1, 1) a bf16 thread takes 16 rows, an f32 one 8 (the faster of the
  // shapes timed on the H100 at the generators' calls)
  const int up = p.upx, down = p.downx;
  if (up == 2 && down == 1) {
    *err = launch_tile<T, 2, 1, 4, 2, 8, 128, 2>(p, cpb, s);
  } else if (up == 1 && down == 1) {
    if constexpr (sizeof(T) == 2) {
      *err = launch_tile<T, 1, 1, 4, 1, 16, 128, 2>(p, cpb, s);
    } else {
      *err = launch_tile<T, 1, 1, 4, 1, 8, 128, 2>(p, cpb, s);
    }
  } else if (up == 1 && down == 2) {
    *err = launch_tile<T, 1, 2, 4, 1, 4, 128, 2>(p, cpb, s);
  } else {
    return false;
  }
  return true;
}

// ------------------------------------------------------------ separable
// Any 1-D (separable) filter, any up and down: a block owns a tile of
// kSepTH x kSepTW outputs of one plane after another; it stages the input
// rows and columns the tile reads, filters every staged row along x into
// shared memory (the tile's columns only, polyphase), then filters those
// columns along y.  taps + taps multiply-adds an output (times the rows
// staged over the tile's rows) instead of taps^2: the loss's 65-tap blur.
constexpr int kSepTW = 64, kSepTH = 32, kSepThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSepMaxSmem = 160 * 1024;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

template <typename A>
void sep_sizes(const Params<A>& p, int* sw, int* sh, size_t* bytes) {
  *sw = ((kSepTW - 1) * p.downx + p.fw - 1) / p.upx + 2;
  *sh = ((kSepTH - 1) * p.downy + p.fh - 1) / p.upy + 2;
  *bytes = (static_cast<size_t>(*sh) * (*sw + kSepTW) + p.fw + p.fh) * sizeof(A);
}

template <typename T>
__global__ void __launch_bounds__(kSepThreads)
    upfirdn2d_polyphase_sep(Params<typename Acc<T>::type> p, int sw, int sh) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* s_in = reinterpret_cast<A*>(smem);  // [sh][sw] input
  A* s_h = s_in + sh * sw;               // [sh][kSepTW] filtered along x
  A* s_fx = s_h + sh * kSepTW;           // [fw] x taps, gain included
  A* s_fy = s_fx + p.fw;                 // [fh] y taps
  const int tid = threadIdx.x;
  for (int j = tid; j < p.fw; j += kSepThreads)
    s_fx[j] = p.f[p.flip ? j : p.fw - 1 - j] * p.gain;
  for (int i = tid; i < p.fh; i += kSepThreads) s_fy[i] = p.f[p.flip ? i : p.fh - 1 - i];

  const int oy0 = blockIdx.y * kSepTH, ox0 = blockIdx.x * kSepTW;
  // the first input row and column the tile's first output reads
  const int r0 = ceil_div(oy0 * p.downy - p.py0, p.upy);
  const int c0 = ceil_div(ox0 * p.downx - p.px0, p.upx);
  const int th = min(kSepTH, p.out_h - oy0), tw = min(kSepTW, p.out_w - ox0);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const long long in_plane = static_cast<long long>(p.in_h) * p.in_w;
  const long long out_plane = static_cast<long long>(p.out_h) * p.out_w;

  for (int plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
    const T* xp = x + plane * in_plane;
    __syncthreads();  // the taps are in; the previous plane is read
    for (int k = tid; k < sh * sw; k += kSepThreads) {
      const int r = k / sw, c = k - (k / sw) * sw;
      const int iy = r0 + r, ix = c0 + c;
      s_in[k] = (iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w)
                    ? static_cast<A>(load(xp + static_cast<long long>(iy) * p.in_w + ix))
                    : A(0);
    }
    __syncthreads();
    for (int k = tid; k < sh * kSepTW; k += kSepThreads) {
      const int r = k / kSepTW, u = k % kSepTW;
      const int X0 = (ox0 + u) * p.downx - p.px0;
      const int j0 = pmod(-X0, p.upx);
      const A* row = s_in + r * sw + ((X0 + j0) / p.upx - c0);
      A acc = A(0);
      for (int j = j0; j < p.fw; j += p.upx, ++row) acc += s_fx[j] * *row;
      s_h[k] = acc;
    }
    __syncthreads();
    for (int k = tid; k < kSepTH * kSepTW; k += kSepThreads) {
      const int t = k / kSepTW, u = k % kSepTW;
      if (t >= th || u >= tw) continue;
      const int Y0 = (oy0 + t) * p.downy - p.py0;
      const int i0 = pmod(-Y0, p.upy);
      const A* col = s_h + ((Y0 + i0) / p.upy - r0) * kSepTW + u;
      A acc = A(0);
      for (int i = i0; i < p.fh; i += p.upy, col += kSepTW) acc += s_fy[i] * *col;
      store(y + plane * out_plane + static_cast<long long>(oy0 + t) * p.out_w + ox0 + u,
            acc);
    }
  }
}

// -------------------------------------------------------------- generic
// Anything else (2-D filters of other sizes or at other up/down, f64
// data): one thread an output of one plane after another, the filter
// (flip and gain applied) in shared memory, the live taps found by the
// phase arithmetic above.
constexpr int kGenericTW = 32, kGenericTH = kGenericThreads / kGenericTW;

template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
    upfirdn2d_polyphase_any(Params<typename Acc<T>::type> p) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* s_g = reinterpret_cast<A*>(smem);  // [fh][fw]
  for (int k = threadIdx.x; k < p.fh * p.fw; k += kGenericThreads)
    s_g[k] = tap(p, k / p.fw, k % p.fw);
  __syncthreads();
  const int ox = blockIdx.x * kGenericTW + threadIdx.x % kGenericTW;
  const int oy = blockIdx.y * kGenericTH + threadIdx.x / kGenericTW;
  if (ox >= p.out_w || oy >= p.out_h) return;
  const int Y0 = oy * p.downy - p.py0, X0 = ox * p.downx - p.px0;
  const int i0 = pmod(-Y0, p.upy), j0 = pmod(-X0, p.upx);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const long long in_plane = static_cast<long long>(p.in_h) * p.in_w;
  const long long out_plane = static_cast<long long>(p.out_h) * p.out_w;
  for (int plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
    const T* xp = x + plane * in_plane;
    A acc = A(0);
    for (int i = i0; i < p.fh; i += p.upy) {
      const int iy = (Y0 + i) / p.upy;  // exact: upy divides Y0 + i
      if (iy < 0 || iy >= p.in_h) continue;
      for (int j = j0; j < p.fw; j += p.upx) {
        const int ix = (X0 + j) / p.upx;
        if (ix < 0 || ix >= p.in_w) continue;
        acc += s_g[i * p.fw + j] * load(xp + static_cast<long long>(iy) * p.in_w + ix);
      }
    }
    store(y + plane * out_plane + static_cast<long long>(oy) * p.out_w + ox, acc);
  }
}

// Dynamic shared memory above the default needs the kernel's consent.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(Params<typename Acc<T>::type> p, cudaStream_t s) {
  using A = typename Acc<T>::type;
  if constexpr (std::is_same_v<T, float> || std::is_same_v<T, __nv_bfloat16>) {
    cudaError_t err;
    if (try_tile<T>(p, s, &err)) return err;
  }
  const unsigned planes = p.planes < kMaxGridZ ? p.planes : kMaxGridZ;
  if (p.separable) {
    int sw, sh;
    size_t bytes;
    sep_sizes(p, &sw, &sh, &bytes);
    if (bytes <= kSepMaxSmem) {
      const cudaError_t err = allow_smem(upfirdn2d_polyphase_sep<T>, bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((p.out_w + kSepTW - 1) / kSepTW, (p.out_h + kSepTH - 1) / kSepTH,
                      planes);
      upfirdn2d_polyphase_sep<T><<<grid, kSepThreads, bytes, s>>>(p, sw, sh);
      return cudaGetLastError();
    }
  }
  const size_t bytes = static_cast<size_t>(p.fh) * p.fw * sizeof(A);
  const cudaError_t err = allow_smem(upfirdn2d_polyphase_any<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.out_w + kGenericTW - 1) / kGenericTW,
                  (p.out_h + kGenericTH - 1) / kGenericTH, planes);
  upfirdn2d_polyphase_any<T><<<grid, kGenericThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* f, void* y, int planes, int in_h,
                int in_w, int out_h, int out_w, int upx, int upy, int downx,
                int downy, int px0, int py0, int fw, int fh, int separable,
                int flip, double gain, cudaStream_t s) {
  using A = typename Acc<T>::type;
  Params<A> p{};
  p.x = x;
  p.f = static_cast<const A*>(f);
  p.y = y;
  p.planes = planes;
  p.in_h = in_h;
  p.in_w = in_w;
  p.out_h = out_h;
  p.out_w = out_w;
  p.upx = upx;
  p.upy = upy;
  p.downx = downx;
  p.downy = downy;
  p.px0 = px0;
  p.py0 = py0;
  p.fw = fw;
  p.fh = fh;
  p.separable = separable;
  p.flip = flip;
  p.gain = static_cast<A>(gain);
  return launch<T>(p, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float64.  x [planes, in_h,
// in_w] and y [planes, out_h, out_w] contiguous; f in float32 (float64 for
// float64 data), [fh, fw] or, when `separable`, [fw] with fw == fh, or null
// for the 1x1 filter.  padx1 / pady1 are implied by out_w / out_h.
extern "C" int p2p3d_upfirdn2d(const void* x, const void* f, void* y, int planes,
                               int in_h, int in_w, int out_h, int out_w, int upx,
                               int upy, int downx, int downy, int px0, int py0,
                               int fw, int fh, int separable, int flip,
                               double gain, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = dtype == 1 ? run<__nv_bfloat16> : dtype == 2 ? run<double> : run<float>;
  return static_cast<int>(fn(x, f, y, planes, in_h, in_w, out_h, out_w, upx,
                             upy, downx, downy, px0, py0, fw, fh, separable,
                             flip, gain, s));
}
