// A 3x3 convolution tile on Hopper's bf16 tensor cores (mma.sync
// m16n8k16, f32 sums), for the small channel counts of PWC-Net's stem
// (3 to 64 input channels). Shared by the small-channel conv (K7,
// conv_folded.cu) and the stem backward (K5, stem.cu).
//
// The conv is an implicit GEMM: M = output pixels, N = output channels,
// K = 9 taps x Ci input channels, flattened as k = tap * Ci + c (the HWIO
// order of the weights). A block takes R output rows x TW = 64 output
// columns and up to NT * 8 output channels; warp r takes output row r of
// the tile as four m16 tiles. The input tile, (S * (R - 1) + 3) rows x
// (S * 63 + 3) columns x Ci, is staged in shared memory, zero outside the
// image (SAME padding), and the weights once per block in the order of the
// B fragments. Two ways to form the A fragments:
//   - taps (Ci % 16 == 0): pixels pitched Ci + 8 so that ldmatrix is free
//     of bank conflicts, Ci / 16 k16 steps per tap, the tap and stride only
//     moving the row addresses; under stride 2 the even and odd input
//     columns are stored apart, so that the 16 pixels of an m16 tile stay
//     on consecutive pitches;
//   - gather (any other Ci, e.g. the image's 3): each A element is read
//     through a table of k -> offset (the im2col of the pixel), K padded to
//     a multiple of 16 with zeros.
// The f32 sums are staged in shared memory and an epilogue functor turns
// every 8 consecutive channels of a pixel into the output (bias, LeakyReLU,
// or a mask read from another tensor), rounded once to bf16 and written
// with 16-byte stores.
//
// Bound: 2 * 9 * Ci flops per output value against (Ci / S^2 + Co) values
// in and out per pixel, about 10 flops per byte, far under the 295 per byte
// at which an H100's tensor cores and not its memory would be the limit:
// these convs are bound by bytes, and the tensor cores only keep the
// products off the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace c3 {

using bf16 = __nv_bfloat16;

constexpr int TW = 64;           // output columns per block row (per warp)
constexpr int MT = TW / 16;      // m16 tiles per warp
constexpr int MAX_SMEM = 232448; // a block's shared memory on an H100

// ---- PTX --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b: a 16x16 (row-major), b 16x8 (column-major), d 16x8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- Geometry ---------------------------------------------------------------

// A 3x3 conv: NHWC input (n, h, w, ci) -> output (n, ho, wo, co); pt, pl:
// the SAME padding before the rows and columns.
struct Conv {
  int n, h, w, ci, ho, wo, co, pt, pl;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// XLA SAME padding before a 3x3 conv of the given stride over `size`.
__host__ __device__ inline int same_pad(int size, int stride) {
  const int total = (cdiv(size, stride) - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

// The input tile of R output rows under stride S: ROWS x COLS pixels,
// stored in SCOLS column slots (stride 2 with taps: even columns in slots
// [0, HALF), odd ones from HALF).
template <int S, int R, bool TAPS>
struct InTile {
  static constexpr bool DEINT = TAPS && S == 2;
  static constexpr int ROWS = S * (R - 1) + 3;
  static constexpr int COLS = S * (TW - 1) + 3;
  static constexpr int HALF = (COLS + 1) / 2;
  static constexpr int SCOLS = DEINT ? 2 * HALF : COLS;
  __host__ __device__ static constexpr int pitch(int ci) {
    return TAPS ? ci + 8 : ci;
  }
};

// ---- Staging ----------------------------------------------------------------

// Rows [y0, y0 + rows) x columns [x0, x0 + cols) of image `img` of the NHWC
// tensor src (h, w, c), into dst: pixel (r, q) at dst + (r * scols +
// slot) * pitch, slot = q, or under deint q / 2 + (q odd) * half. 16-byte
// copies, so c % 8 == 0; zeros outside the image.
// Commit and wait with cp_async_wait_all.
template <bool DEINT>
__device__ void stage_vec(const bf16* __restrict__ src, int img, int h, int w,
                          int c, int y0, int x0, int rows, int cols,
                          int scols, int half, int pitch, bf16* dst) {
  const int chunks = c / 8;
  const int total = rows * cols * chunks;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int q = e % chunks, pix = e / chunks;
    const int col = pix % cols, row = pix / cols;
    const int y = y0 + row, x = x0 + col;
    const int s = DEINT ? (col & 1) * half + (col >> 1) : col;
    bf16* d = dst + (row * scols + s) * pitch + q * 8;
    if (y >= 0 && y < h && x >= 0 && x < w)
      cp_async16(d, src + ((static_cast<size_t>(img) * h + y) * w + x) * c +
                        q * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The same with 2-byte loads, any c, pixels pitched c, columns in order.
// Each thread issues U loads before it stores, so that their latencies
// overlap.
__device__ inline void stage_scalar(const bf16* __restrict__ src, int img,
                                    int h, int w, int c, int y0, int x0,
                                    int rows, int cols, bf16* dst) {
  constexpr int U = 8;
  const int total = rows * cols * c;
  const int span = cols * c;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * blockDim.x) {
    bf16 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      const int row = e / span, rest = e % span;
      const int y = y0 + row, x = x0 + rest / c;
      v[u] = __float2bfloat16_rn(0.f);
      if (e < total && y >= 0 && y < h && x >= 0 && x < w)
        v[u] = src[((static_cast<size_t>(img) * h + y) * w) * c + x0 * c +
                   rest];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * blockDim.x < total) dst[e0 + u * blockDim.x] = v[u];
  }
}

// Where B[k][n] (k = tap * ci + c, n the output channel) lies in the f32
// weights: w[t * tap + c * cs + n * ns], t = 8 - tap when flip (the stride-1
// input gradient of a conv is a conv with flipped, transposed weights).
struct WView {
  int tap, cs, ns, flip;
};

// A conv's own HWIO weights (3, 3, ci, co).
__host__ __device__ inline WView hwio(int ci, int co) {
  return {ci * co, co, 1, 0};
}
// The transposed conv of a conv with HWIO weights (3, 3, co, ci), i.e. from
// ci to co channels; flip for the stride-1 input gradient.
__host__ __device__ inline WView hwio_t(int ci, int co, int flip) {
  return {ci * co, 1, ci, flip};
}

// The B fragments of ks k16 steps x nt n8 tiles (output channels co0 +
// [0, 8 nt)): wf[(step * nt + tile) * 32 + lane] holds the lane's {b0, b1}.
// B is 0 for k >= 9 ci and for channels >= co. Weights are rounded to bf16
// here (exact when they hold bf16 values already).
__device__ inline void stage_weights(const float* __restrict__ w, WView v,
                                     int ci, int co, int co0, int ks, int nt,
                                     uint2* wf) {
  const int kmax = 9 * ci;
  for (int e = threadIdx.x; e < ks * nt * 32; e += blockDim.x) {
    const int lane = e & 31, f = e >> 5;
    const int n = co0 + (f % nt) * 8 + (lane >> 2);
    const int k0 = (f / nt) * 16 + 2 * (lane & 3);
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + (j & 1) + (j >> 1) * 8;
      const int tap = k / ci;
      x[j] = k < kmax && n < co
                 ? __ldg(w + (v.flip ? 8 - tap : tap) * v.tap +
                         (k % ci) * v.cs + n * v.ns)
                 : 0.f;
    }
    wf[e] = make_uint2(pack(x[0], x[1]), pack(x[2], x[3]));
  }
}

// ---- Products ---------------------------------------------------------------

// The lane's ldmatrix row for an A fragment: pixel of the m16 tile and the
// k offset (matrices: rows 0-7 / 8-15 x k 0-7 / 8-15 = a0, a1, a2, a3).
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_k(int lane) { return (lane >> 4) * 8; }

// acc[mt][nt] += the warp's output row r (64 pixels) from a tap-staged tile.
template <int S, int R, int NT>
__device__ __forceinline__ void mma_taps(const bf16* tile, int ci,
                                         const uint2* wf, int r,
                                         float (&acc)[MT][NT][4]) {
  using T = InTile<S, R, true>;
  const int lane = threadIdx.x & 31;
  const int pitch = T::pitch(ci), steps = ci / 16;
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int slot0 = T::DEINT ? (kx & 1) * T::HALF + (kx >> 1) : kx;
      const bf16* row = tile + ((S * r + ky) * T::SCOLS + slot0 +
                                a_row(lane)) * pitch + a_k(lane);
      for (int cc = 0; cc < steps; ++cc) {
        const int ks = (ky * 3 + kx) * steps + cc;
        uint2 b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt] = wf[(ks * NT + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, row + mt * 16 * pitch + cc * 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a, b[nt].x, b[nt].y);
        }
      }
    }
  }
}

// The same from a gather-staged tile: A[p][k] = tile[base(p) + koff[k]],
// koff[k] < 0 for the zero padding of K.
template <int S, int R, int NT>
__device__ __forceinline__ void mma_gather(const bf16* tile, int ci, int ks,
                                           const int* koff, const uint2* wf,
                                           int r, float (&acc)[MT][NT][4]) {
  using T = InTile<S, R, false>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint16_t* base =
      reinterpret_cast<const uint16_t*>(tile) + S * r * T::COLS * ci;
  for (int s = 0; s < ks; ++s) {
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = koff[s * 16 + 2 * t + (j & 1) + (j >> 1) * 8];
    uint2 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = wf[(s * NT + nt) * 32 + lane];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint16_t* p0 = base + S * (mt * 16 + g) * ci;
      const uint16_t* p1 = p0 + S * 8 * ci;
      uint32_t v[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[0][j] = o[j] < 0 ? 0u : p0[o[j]];
        v[1][j] = o[j] < 0 ? 0u : p1[o[j]];
      }
      const uint32_t a[4] = {
          v[0][0] | (v[0][1] << 16), v[1][0] | (v[1][1] << 16),
          v[0][2] | (v[0][3] << 16), v[1][2] | (v[1][3] << 16)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a, b[nt].x, b[nt].y);
    }
  }
}

// ---- Epilogue ---------------------------------------------------------------

// Row pitch (f32) of the staged sums: NT * 8 channels + 8, so that the
// float2 writes of a half-warp fall in distinct banks.
template <int NT>
__host__ __device__ constexpr int stage_pitch() { return NT * 8 + 8; }

// The warp's sums, m16 tile mt at staged pixels px0 + step * (16 mt + i),
// i < 16 (c0, c1: pixel g, channels 2t, 2t + 1; c2, c3: pixel g + 8).
template <int NT>
__device__ __forceinline__ void stage_acc(const float (&acc)[MT][NT][4],
                                          float* stage, int px0, int step) {
  constexpr int SP = stage_pitch<NT>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* d = stage + (px0 + step * (mt * 16 + g)) * SP + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(d) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(d + 8 * step * SP) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

// Epilogues: vec8 maps the sums of channels ch..ch+7 of the output element
// idx..idx+7 (16-byte aligned); one maps a single element.

// + bias, then LeakyReLU(slope) when act.
struct BiasAct {
  const float* b;
  float slope;
  int act;
  __device__ float one(float v, size_t, int ch) const {
    v += __ldg(b + ch);
    return act && v < 0.f ? v * slope : v;
  }
  __device__ void vec8(float (&v)[8], size_t idx, int ch) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = one(v[j], idx + j, ch + j);
  }
};

// The incoming gradient through LeakyReLU 0.1: z = sum + bias, out = g *
// (z > 0 ? 1 : 0.1).
struct BiasLreluGrad {
  const float* b;
  const bf16* g;
  __device__ float one(float v, size_t idx, int ch) const {
    const float z = v + __ldg(b + ch);
    return __bfloat162float(g[idx]) * (z > 0.f ? 1.f : 0.1f);
  }
  __device__ void vec8(float (&v)[8], size_t idx, int ch) const {
    float gv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(g + idx)), gv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = gv[j] * (v[j] + __ldg(b + ch + j) > 0.f ? 1.f : 0.1f);
  }
};

// A gradient through the LeakyReLU 0.1 whose output is y: out = sum * (y >
// 0 ? 1 : 0.1).
struct LreluMask {
  const bf16* y;
  __device__ float one(float v, size_t idx, int) const {
    return v * (__bfloat162float(y[idx]) > 0.f ? 1.f : 0.1f);
  }
  __device__ void vec8(float (&v)[8], size_t idx, int) const {
    float yv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(y + idx)), yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] *= yv[j] > 0.f ? 1.f : 0.1f;
  }
};

struct Identity {
  __device__ float one(float v, size_t, int) const { return v; }
  __device__ void vec8(float (&)[8], size_t, int) const {}
};

// Writes the staged sums of rows x cols output pixels (row-major, pitch
// stage_pitch<NT>) at output pixels (y0 + r, x0 + c) of image img, channels
// co0 + [0, 8 NT), through epi, rounded once to bf16. 16-byte stores when co
// % 8 == 0.
template <int NT, class Epi>
__device__ void store_tile(const float* stage, int rows, int cols, int img,
                           int y0, int x0, int ho, int wo, int co, int co0,
                           bf16* __restrict__ out, const Epi& epi) {
  constexpr int SP = stage_pitch<NT>();
  const bool vec = co % 8 == 0;
  const int total = rows * cols * NT;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int q = e % NT, pix = e / NT;
    const int y = y0 + pix / cols, x = x0 + pix % cols;
    const int ch = co0 + q * 8;
    if (y >= ho || x >= wo || ch >= co) continue;
    const float* s = stage + pix * SP + q * 8;
    const size_t idx = ((static_cast<size_t>(img) * ho + y) * wo + x) * co + ch;
    if (vec) {
      const float4 lo = *reinterpret_cast<const float4*>(s);
      const float4 hi = *reinterpret_cast<const float4*>(s + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      epi.vec8(v, idx, ch);
      *reinterpret_cast<uint4*>(out + idx) =
          make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                     pack(v[6], v[7]));
    } else {
      const int m = min(8, co - ch);
      for (int j = 0; j < m; ++j)
        out[idx + j] = __float2bfloat16_rn(epi.one(s[j], idx + j, ch + j));
    }
  }
}

// ---- The conv ---------------------------------------------------------------

// k16 steps of a conv with ci input channels.
__host__ __device__ inline int k_steps(int ci) { return cdiv(9 * ci, 16); }

// Shared memory: the B fragments, the gather table, then the input tile,
// which the staged sums overwrite.
template <int S, int R, int NT, bool TAPS>
__host__ __device__ inline size_t conv_smem(int ci) {
  using T = InTile<S, R, TAPS>;
  const size_t w = static_cast<size_t>(k_steps(ci)) * NT * 32 * sizeof(uint2);
  const size_t koff =
      TAPS ? 0 : (k_steps(ci) * 16 * sizeof(int) + 15) / 16 * 16;
  const size_t tile = static_cast<size_t>(T::ROWS) * T::SCOLS * T::pitch(ci) *
                      sizeof(bf16);
  const size_t stage =
      static_cast<size_t>(R) * TW * stage_pitch<NT>() * sizeof(float);
  return w + koff + (tile > stage ? tile : stage);
}

// One block: output rows R * blockIdx.y + [0, R), columns TW * blockIdx.x +
// [0, TW), channel group blockIdx.z % groups of NT * 8, image blockIdx.z /
// groups. x: (n, h, w, ci) bf16; w: f32 weights seen through wv; out: (n,
// ho, wo, co) bf16.
template <int S, int R, int NT, bool TAPS, class Epi>
__global__ void __launch_bounds__(32 * R)
conv3x3(const bf16* __restrict__ x, const float* __restrict__ w, WView wv,
        Conv cv, bf16* __restrict__ out, Epi epi) {
  using T = InTile<S, R, TAPS>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int ks = k_steps(cv.ci);
  uint2* wf = reinterpret_cast<uint2*>(tile_smem);
  int* koff = reinterpret_cast<int*>(wf + ks * NT * 32);
  bf16* tile = reinterpret_cast<bf16*>(
      tile_smem + ks * NT * 32 * sizeof(uint2) +
      (TAPS ? 0 : (ks * 16 * sizeof(int) + 15) / 16 * 16));
  float* stage = reinterpret_cast<float*>(tile);

  const int groups = cdiv(cv.co, NT * 8);
  const int img = blockIdx.z / groups, co0 = (blockIdx.z % groups) * NT * 8;
  const int oy0 = blockIdx.y * R, ox0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5;

  if constexpr (TAPS)
    stage_vec<T::DEINT>(x, img, cv.h, cv.w, cv.ci, S * oy0 - cv.pt,
                        S * ox0 - cv.pl, T::ROWS, T::COLS, T::SCOLS, T::HALF,
                        T::pitch(cv.ci), tile);
  else
    stage_scalar(x, img, cv.h, cv.w, cv.ci, S * oy0 - cv.pt, S * ox0 - cv.pl,
                 T::ROWS, T::COLS, tile);
  stage_weights(w, wv, cv.ci, cv.co, co0, ks, NT, wf);
  if constexpr (!TAPS)
    for (int k = threadIdx.x; k < ks * 16; k += blockDim.x) {
      const int tap = k / cv.ci;
      koff[k] = k < 9 * cv.ci
                    ? ((tap / 3) * T::COLS + tap % 3) * cv.ci + k % cv.ci
                    : -1;
    }
  cp_async_wait_all();
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  if constexpr (TAPS)
    mma_taps<S, R, NT>(tile, cv.ci, wf, warp, acc);
  else
    mma_gather<S, R, NT>(tile, cv.ci, ks, koff, wf, warp, acc);
  __syncthreads();  // the sums overwrite the tile
  stage_acc<NT>(acc, stage, warp * TW, 1);
  __syncthreads();
  store_tile<NT>(stage, R, TW, img, oy0, ox0, cv.ho, cv.wo, cv.co, co0, out,
                 epi);
}

// Launches conv3x3 over the whole output on `stream`; returns the CUDA error.
template <int S, int R, int NT, bool TAPS, class Epi>
cudaError_t launch_conv(const bf16* x, const float* w, WView wv,
                        const Conv& cv, bf16* out, const Epi& epi,
                        cudaStream_t stream) {
  const size_t smem = conv_smem<S, R, NT, TAPS>(cv.ci);
  const long long gy = cdiv(cv.ho, R);
  const long long gz = static_cast<long long>(cv.n) * cdiv(cv.co, NT * 8);
  if (smem > MAX_SMEM || (TAPS && cv.ci % 16) || gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3<S, R, NT, TAPS, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(cv.wo, TW), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  kernel<<<grid, 32 * R, smem, stream>>>(x, w, wv, cv, out, epi);
  return cudaGetLastError();
}

}  // namespace c3
