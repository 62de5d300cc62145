// The banded correlation tile on Hopper's bf16 tensor cores (mma.sync
// m16n8k16, f32 sums; the PTX helpers of conv3x3_mma.cuh). Shared by the
// correlation forward K1/K1p (cost_volume.cu), the fused warp + correlation
// K6/K6p (warp_corr.cu) and the correlation backward K2 and K3
// (cost_volume_bwd.cu).
//
// Forward (K1, K6): for one output row, one m16 tile of f1 pixels x0..x0+15
// (A, 16 x C) and one dy, the 24 pixels x0-4..x0+19 of row y+dy of the
// second operand (B: f2, or the warped f2) give 16 x 24 sums, of which the
// diagonals j = i + 4 + dx, |dx| <= d, are the taps. A block takes R rows x
// 16 MT columns and a group of dyg dy values; warp (r, mt, q) takes row r,
// m16 tile mt and the dy indices q TPW + [0, TPW) of the group. The taps
// are staged in shared memory as f32 and each tile row leaves as one
// contiguous run of bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace band {

using c3::bf16;
using c3::cdiv;

constexpr int TPW = 3;     // dy values per warp
constexpr int BAND = 8;    // extra B columns of a window: 4 on each side
constexpr int FILL = 132;  // an H100's SMs: the blocks a level should reach
constexpr int MINW = 4;    // warps a block has at least (the others stage)

// Warps of a block: one per (row, m16 tile, TPW dy values), at least MINW,
// so that a small tile still stages its chunks with 4 warps.
__host__ __device__ constexpr int band_warps(int compute) {
  return compute > MINW ? compute : MINW;
}

// ---- PTX ----------------------------------------------------------------

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(c3::smem_u32(p)));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   c3::smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Staging --------------------------------------------------------------

// Vectors [0, nvk) of the NV = CK / VEC vectors of channels [c0, c0 + CK)
// of `rows` rows x COLS pixels of the NHWC array src (image img, nrows rows,
// w columns, c channels), from row fy0 and column x0, into dst pitched CK +
// 8: pixel (r, q) at dst + (r * COLS + q) * (CK + 8). Zeros outside the
// array and at channels >= c. VEC: channels a copy moves (8: 16-byte
// cp.async, 4: 8-byte, 1: a 2-byte load and store); c % VEC == 0. The
// shapes are template arguments, so the index arithmetic is shifts and
// multiplications.
template <int VEC, int CK, int COLS>
__device__ __forceinline__ void stage_band(const bf16* __restrict__ src,
                                           int img, int nrows, int w, int c,
                                           int fy0, int x0, int rows,
                                           int c0, int nvk, bf16* dst) {
  constexpr int NV = CK / VEC;
  const int total = rows * COLS * NV;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int v = e % NV, pix = e / NV;
    if (v >= nvk) continue;
    const int fy = fy0 + pix / COLS, x = x0 + pix % COLS, ch = c0 + v * VEC;
    bf16* d = dst + pix * (CK + 8) + v * VEC;
    const bool in = fy >= 0 && fy < nrows && x >= 0 && x < w && ch < c;
    const bf16* s =
        in ? src + ((static_cast<size_t>(img) * nrows + fy) * w + x) * c + ch
           : nullptr;
    if constexpr (VEC == 8) {
      if (in)
        c3::cp_async16(d, s);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if constexpr (VEC == 4) {
      if (in)
        cp_async8(d, s);
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(0, 0);
    } else {
      *d = in ? *s : __float2bfloat16_rn(0.f);
    }
  }
}

// ---- The forward's products and taps ---------------------------------------

// The bytes of shared memory of a forward launch: two chunk buffers (one
// when C fits one chunk), then the taps' f32 staging over them.
__host__ inline size_t fwd_stage_bytes(int r, int mt, int ck, int d, int dyg,
                                       int chunks) {
  const size_t xw = 16 * mt, pitch = ck + 8;
  const size_t chunk =
      (r * xw + (r + dyg - 1) * (xw + BAND)) * pitch * sizeof(bf16);
  const size_t taps = r * xw * dyg * (2 * d + 1) * sizeof(float);
  const size_t stages = (chunks > 1 ? 2 : 1) * chunk;
  return stages > taps ? stages : taps;
}

// One staged chunk's products, `steps` k16 steps: warp (r, mt, q) takes the
// m16 tile mt of row r of A (R x XW pixels) against the 24-pixel windows
// 16 mt + [0, 24) of B's rows r + dyi (WW = XW + BAND pixels a row), dyi =
// q TPW + j < ndy; both pitched PITCH.
template <int XW, int PITCH>
__device__ __forceinline__ void band_mma(float (&acc)[TPW][3][4],
                                         const bf16* a_tile,
                                         const bf16* b_tile, int r, int mt,
                                         int q, int ndy, int steps) {
  constexpr int WW = XW + BAND;
  const int lane = threadIdx.x & 31;
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t a[4];
    c3::ldsm_x4(a, a_tile + (r * XW + 16 * mt + c3::a_row(lane)) * PITCH +
                       16 * ks + c3::a_k(lane));
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int dyi = q * TPW + j;  // dy index within the group
      if (dyi >= ndy) break;
      // Window row: B pixels 16 mt + [0, 24) of row r + dyi.
      const bf16* win = b_tile + ((r + dyi) * WW + 16 * mt) * PITCH +
                        16 * ks;
      // Matrices (n8 tile 0, k 0-7), (0, k 8-15), (1, k 0-7), (1, k 8-15).
      const int m = lane >> 3;
      uint32_t b01[4], b2[2];
      c3::ldsm_x4(b01, win + (8 * (m >> 1) + (lane & 7)) * PITCH +
                           8 * (m & 1));
      ldsm_x2(b2, win + (16 + (lane & 7)) * PITCH + 8 * (m & 1));
      c3::mma(acc[j][0], a, b01[0], b01[1]);
      c3::mma(acc[j][1], a, b01[2], b01[3]);
      c3::mma(acc[j][2], a, b2[0], b2[1]);
    }
  }
}

// The diagonals: sum (i, j) of the m16 x 24 tile is tap dx = j - i - 4 of
// pixel i (c0, c1: i = g, j = 8 nt + 2t + {0, 1}; c2, c3: i = g + 8).
// Staged as taps[(r XW + pixel) dyg S + dyi S + dx + d], the mean in f32.
// Rows g never reach n8 tile 2 (dx >= 5) and rows g + 8 never tile 0
// (dx <= -5): those sums are skipped at compile time.
template <int XW>
__device__ __forceinline__ void band_taps(const float (&acc)[TPW][3][4],
                                          float* taps, int r, int mt, int q,
                                          int ndy, int dyg, int d, float cf) {
  const int s = 2 * d + 1;
  const int lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int dyi = q * TPW + j;
    if (dyi >= ndy) break;
    float* px = taps + ((r * XW + 16 * mt + gi) * dyg + dyi) * s + d - gi -
                BAND / 2 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if ((nt == 2 && v < 2) || (nt == 0 && v >= 2)) continue;
        const int i8 = 8 * (v >> 1), jj = 8 * nt + (v & 1);  // + gi, + 2t
        const int dx = jj + 2 * t - gi - i8 - BAND / 2;
        if (dx >= -d && dx <= d)
          px[i8 * dyg * s + jj - i8] = acc[j][nt][v] / cf;
      }
  }
}

// Each tile row leaves as runs: per pixel the ndy S taps at channel
// dy_lo S; with one group (dg == 1) the whole row is one run of cols K,
// stored 16 bytes at a time where aligned.
template <int R, int XW>
__device__ __forceinline__ void band_store(bf16* __restrict__ out,
                                           const float* taps, int img, int h,
                                           int w, int y0, int x0, int d,
                                           int dg, int dyg, int dy_lo,
                                           int ndy) {
  const int s = 2 * d + 1, k = s * s;
  const int cols = min(XW, w - x0);
  for (int rr = 0; rr < R; ++rr) {
    const int y = y0 + rr;
    if (y >= h) break;
    const size_t base = ((static_cast<size_t>(img) * h + y) * w + x0) * k;
    const float* src = taps + rr * XW * dyg * s;
    if (dg == 1) {
      const int len = cols * k;
      const int head = min(len, static_cast<int>((8 - base % 8) % 8));
      const int nvec = (len - head) / 8;
      for (int e = threadIdx.x; e < head; e += blockDim.x)
        out[base + e] = __float2bfloat16_rn(src[e]);
      for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        const float* p = src + head + 8 * v;
        *reinterpret_cast<uint4*>(out + base + head + 8 * v) =
            make_uint4(c3::pack(p[0], p[1]), c3::pack(p[2], p[3]),
                       c3::pack(p[4], p[5]), c3::pack(p[6], p[7]));
      }
      for (int e = head + 8 * nvec + threadIdx.x; e < len; e += blockDim.x)
        out[base + e] = __float2bfloat16_rn(src[e]);
    } else {
      const int run = ndy * s;
      for (int e = threadIdx.x; e < cols * run; e += blockDim.x) {
        const int p = e / run, kk = e % run;
        out[base + static_cast<size_t>(p) * k + dy_lo * s + kk] =
            __float2bfloat16_rn(src[p * dyg * s + kk]);
      }
    }
  }
}

}  // namespace band
