// Correlation forward (the PWC-Net cost volume), written by hand for Hopper.
//
// Replaces: pwcnet_tpu/ops/pallas/cost_volume_kernel.py, _corr_fwd_kernel
// (launched by _corr_forward_pallas; entry cost_volume_pallas), as K1, and
// the same kernel under _corr_forward_pallas(rows_prepadded=True) (entry
// cost_volume_pallas_prepadded), as K1p.
//
//   out[n, y, x, k] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y + dy, x + dx, c]
//   k = (dy + d) * (2d + 1) + (dx + d),  |dy|, |dx| <= d,  f2 = 0 outside.
//
// K1p is the spatially sharded form: f2 arrives as f2e with d real halo rows
// above and below (rows [-d, H + d) of the shard), so only columns outside
// [0, W) read zeros. Both kernels below serve both entries: f2 row y of the
// output frame is row y + f2_off of an f2 array of f2_rows rows (K1: off 0,
// H rows; K1p: off d, H + 2d rows).
//
// Layout: f1, f2 and out are NHWC and contiguous, so each tap is a dot product
// over the contiguous C. Products and sums are f32 (as in cost_volume_lax,
// which upcasts first; a product of two bf16 values is exact in f32), and
// the mean is rounded once to the input type.
//
// Bound on an H100 SXM: every pixel reads 2C inputs and writes 81 outputs,
// (2C + 81) * 2 bytes in bf16, and does 162 * C flops: 18 to 34 flops a byte
// at C = 32..196, far below the 295 at which the bf16 tensor cores would
// bound it, so the least time is the bytes over 3.35 TB/s (about 2.5 us at
// the finest level of a 448x1024 pair). At PWC-Net's sizes every level is
// small (7 x 16 to 112 x 256 pixels a frame), so what costs is latency: the
// round trips to memory and the number of blocks that a level puts on the
// 132 SMs.
//
// bf16 (corr_band): banded products on the tensor cores (mma.sync m16n8k16,
// f32 sums; the tile of corr_band.cuh, shared with K6 and K3). For one
// output row y, one m16 tile of f1 pixels x0..x0+15 (A, 16 x C) and one dy,
// the 24 pixels x0-4..x0+19 of f2's row y+dy (B, three n8 tiles) give 16 x
// 24 sums, of which the diagonals j = i + 4 + dx, |dx| <= d, are the taps:
// 37.5% of the products are kept, and the products cost nothing beside the
// bytes.
//   - Staging: C is taken in chunks of CK channels (zero-padded to a multiple
//     of 16), double-buffered with cp.async so that the loads of chunk k + 1
//     overlap the products of chunk k; 16-byte copies where C % 8 == 0,
//     8-byte where C % 4 == 0 (C = 196: 392 bytes a pixel), 2-byte loads
//     otherwise (C = 5); pixels pitched CK + 8 (conflict-free ldmatrix).
//   - Filling the card: a block takes R rows x 16 MT columns and a group of
//     the dy values; its warps take (row, m16 tile, up to TPW dy values),
//     and a block has at least MINW warps, the extra ones only staging.
//     The host picks the largest tile (2 x 32, 1 x 32, 1 x 16) that puts at
//     least one block on every SM, and below that splits the dy values over
//     3 or 2d + 1 blocks (pick_band): levels 4-6 get 63 to 336 blocks at
//     batch 1 and 8. The index arithmetic of the staging is in
//     template constants: at these sizes the kernel issues more integer
//     instructions than it moves bytes.
//   - Stores: the taps are staged in shared memory as f32 and each tile row
//     leaves as one contiguous run of bf16 (16-byte stores where aligned).
// The plain model of this tiling is corr_band_ref
// (pwcnet_tpu_torch/ops/cost_volume.py), pinned against cost_volume_lax by
// tests/test_torch_port_corr_band.py.
//
// f32 (corr_fwd, the correctness path, held to 1e-5, no TF32): one block per
// (n, TH rows, TW columns) of output on the CUDA cores. The block stages C in
// chunks of CC channels: the f1 tile and the f2 tile with a d-pixel halo,
// both channel-major in shared memory, zero-filled outside the image. One
// thread per (pixel, dy) keeps the 2d+1 sums of its dx row in registers; the
// 81 results of each pixel are staged in shared memory and written out as
// contiguous rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_band.cuh"

namespace {

using c3::bf16;
using c3::cdiv;

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int TW = 32;  // output columns per block (one warp)
constexpr int TH = 2;   // output rows per block
constexpr int CC = 16;  // channels staged per chunk

// Two blocks per SM: at d = 4 (576 threads) that caps the kernel at 56
// registers. Without the cap the two extra arguments of the K1p entry took
// it to 74-78 registers, one block per SM, and K1 ran up to 45% slower at the
// large levels (tools/ab_kernels.py on the H100; PERF.md, section 6).
template <int D>
__global__ void __launch_bounds__(TW * TH * (2 * D + 1), 2)
corr_fwd(const float* __restrict__ f1, const float* __restrict__ f2,
         float* __restrict__ out, int H, int W, int C, int f2_rows,
         int f2_off) {
  constexpr int S = 2 * D + 1;
  constexpr int K = S * S;
  constexpr int HR = TH + 2 * D;  // f2 tile rows, halo included
  constexpr int HC = TW + 2 * D;  // f2 tile columns, halo included
  constexpr int F1N = CC * TH * TW;
  constexpr int F2N = CC * HR * HC;
  static_assert(TH * TW * K <= F2N, "output staging must fit the f2 tile");
  __shared__ float f1s[F1N];
  __shared__ float f2s[F2N];  // after the last chunk: the output staging

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int nthr = TW * TH * S;
  const int tid = threadIdx.x + TW * threadIdx.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y / S;
  const int dy = threadIdx.y % S;
  const size_t img = static_cast<size_t>(n) * H * W;
  const size_t img2 = static_cast<size_t>(n) * f2_rows * W;

  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int e = tid; e < F1N; e += nthr) {
      const int c = e % CC, p = e / CC, col = p % TW, row = p / TW;
      const int y = y0 + row, x = x0 + col, cc = c0 + c;
      float v = 0.f;
      if (y < H && x < W && cc < C)
        v = __ldg(f1 + (img + static_cast<size_t>(y) * W + x) * C + cc);
      f1s[(c * TH + row) * TW + col] = v;
    }
    for (int e = tid; e < F2N; e += nthr) {
      const int c = e % CC, p = e / CC, col = p % HC, row = p / HC;
      const int y = y0 + row - D + f2_off, x = x0 + col - D, cc = c0 + c;
      float v = 0.f;
      if (y >= 0 && y < f2_rows && x >= 0 && x < W && cc < C)
        v = __ldg(f2 + (img2 + static_cast<size_t>(y) * W + x) * C + cc);
      f2s[(c * HR + row) * HC + col] = v;
    }
    __syncthreads();
    const int cn = min(CC, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float a = f1s[(c * TH + ty) * TW + tx];
      const float* r = f2s + (c * HR + ty + dy) * HC + tx;
#pragma unroll
      for (int dx = 0; dx < S; ++dx) acc[dx] = fmaf(a, r[dx], acc[dx]);
    }
    __syncthreads();
  }

  // Stage: pixel (ty, tx) holds channels [dy * S, dy * S + S). K is odd, so
  // the stride of K words between neighbouring threads hits distinct banks.
  const float cf = static_cast<float>(C);
#pragma unroll
  for (int dx = 0; dx < S; ++dx)
    f2s[(ty * TW + tx) * K + dy * S + dx] = acc[dx] / cf;
  __syncthreads();

  // Each output row of the tile is one contiguous run of cols * K values.
  const int cols = min(TW, W - x0);
  for (int row = 0; row < TH; ++row) {
    const int y = y0 + row;
    if (y >= H) break;
    float* dst = out + (img + static_cast<size_t>(y) * W + x0) * K;
    const float* src = f2s + row * TW * K;
    for (int e = tid; e < cols * K; e += nthr) dst[e] = src[e];
  }
}

template <int D>
cudaError_t launch_f32(const float* f1, const float* f2, float* out, int n,
                       int h, int w, int c, int f2_rows, int f2_off,
                       cudaStream_t stream) {
  const dim3 grid(cdiv(w, TW), cdiv(h, TH), n);
  const dim3 block(TW, TH * (2 * D + 1));
  corr_fwd<D><<<grid, block, 0, stream>>>(f1, f2, out, h, w, c, f2_rows,
                                          f2_off);
  return cudaGetLastError();
}

// ---- bf16: banded products on the tensor cores ------------------------------

using band::BAND;
using band::FILL;
using band::TPW;

// One block: output rows R * (blockIdx.y / dg) + [0, R), columns 16 MT *
// blockIdx.x + [0, 16 MT), dy indices [g dyg, g dyg + dyg) ∩ [0, 2D + 1)
// with g = blockIdx.y % dg, image blockIdx.z. Warp (r, mt, q) takes row r,
// m16 tile mt and the dy indices q TPW + [0, TPW) of the group.
template <int D, int R, int MT, int CK, int VEC>
__global__ void __launch_bounds__(band::band_warps(R * MT * TPW) * 32)
corr_band(const bf16* __restrict__ f1, const bf16* __restrict__ f2,
          bf16* __restrict__ out, int H, int W, int C, int f2_rows,
          int f2_off, int dg, int dyg) {
  constexpr int S = 2 * D + 1;
  constexpr int XW = 16 * MT, WW = XW + BAND, PITCH = CK + 8;
  extern __shared__ __align__(16) unsigned char band_smem[];
  bf16* bufs = reinterpret_cast<bf16*>(band_smem);
  float* taps = reinterpret_cast<float*>(band_smem);

  const int img = blockIdx.z;
  const int g = blockIdx.y % dg, y0 = blockIdx.y / dg * R;
  const int x0 = blockIdx.x * XW;
  const int dy_lo = g * dyg, ndy = min(dyg, S - dy_lo);
  const int f2r = R + ndy - 1;  // f2 rows the block stages
  const int chunk = (R * XW + (R + dyg - 1) * WW) * PITCH;
  const int cp = (C + 15) / 16 * 16, chunks = cdiv(cp, CK);

  const int wq = cdiv(dyg, TPW);
  const int warp = threadIdx.x >> 5;
  const int q = warp % wq, mt = warp / wq % MT, r = warp / (wq * MT);
  const bool computes = warp < R * MT * wq;  // the others only stage

  auto stage = [&](int k) {
    bf16* b = bufs + (k & 1) * chunk;
    const int c0 = k * CK, nvk = min(CK, cp - c0) / VEC;
    band::stage_band<VEC, CK, XW>(f1, img, H, W, C, y0, x0, R, c0, nvk, b);
    band::stage_band<VEC, CK, WW>(f2, img, f2_rows, W, C,
                                  y0 + dy_lo - D + f2_off, x0 - BAND / 2,
                                  f2r, c0, nvk, b + R * XW * PITCH);
    band::cp_commit();
  };

  float acc[TPW][3][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][nt][v] = 0.f;

  stage(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(k + 1);  // the buffer of chunk k - 1, free since its last sync
      band::cp_wait<1>();
    } else {
      band::cp_wait<0>();
    }
    __syncthreads();
    const bf16* a_tile = bufs + (k & 1) * chunk;
    const int steps = computes ? min(CK, cp - k * CK) / 16 : 0;
    band::band_mma<XW, PITCH>(acc, a_tile, a_tile + R * XW * PITCH, r, mt,
                              q, ndy, steps);
    __syncthreads();  // chunk k's buffer is refilled by stage(k + 2)
  }

  if (computes)
    band::band_taps<XW>(acc, taps, r, mt, q, ndy, dyg, D,
                        static_cast<float>(C));
  __syncthreads();
  band::band_store<R, XW>(out, taps, img, H, W, y0, x0, D, dg, dyg, dy_lo,
                          ndy);
}

template <int D, int R, int MT, int CK, int VEC>
cudaError_t launch_band(const bf16* f1, const bf16* f2, bf16* out, int n,
                        int h, int w, int c, int f2_rows, int f2_off, int dg,
                        cudaStream_t stream) {
  constexpr int S = 2 * D + 1;
  const int dyg = cdiv(S, dg);
  dg = cdiv(S, dyg);
  const int chunks = cdiv(cdiv(c, 16) * 16, CK);
  const size_t smem = band::fwd_stage_bytes(R, MT, CK, D, dyg, chunks);
  const long long gy = static_cast<long long>(cdiv(h, R)) * dg;
  if (smem > c3::MAX_SMEM || gy > 65535 || n > 65535)
    return cudaErrorInvalidValue;
  auto kernel = corr_band<D, R, MT, CK, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(w, 16 * MT), static_cast<unsigned>(gy), n);
  kernel<<<grid, band::band_warps(R * MT * cdiv(dyg, TPW)) * 32, smem,
           stream>>>(f1, f2, out, h, w, c, f2_rows, f2_off, dg, dyg);
  return cudaGetLastError();
}

// The copy width: 16 bytes where C % 8 == 0, 8 where C % 4 == 0, else 2.
template <int D, int R, int MT, int CK>
cudaError_t launch_band_vec(const bf16* f1, const bf16* f2, bf16* out, int n,
                            int h, int w, int c, int f2_rows, int f2_off,
                            int dg, cudaStream_t s) {
  if (c % 8 == 0)
    return launch_band<D, R, MT, CK, 8>(f1, f2, out, n, h, w, c, f2_rows,
                                        f2_off, dg, s);
  if (c % 4 == 0)
    return launch_band<D, R, MT, CK, 4>(f1, f2, out, n, h, w, c, f2_rows,
                                        f2_off, dg, s);
  return launch_band<D, R, MT, CK, 1>(f1, f2, out, n, h, w, c, f2_rows,
                                      f2_off, dg, s);
}

// The tile of a launch: 2 x 32 pixels (R = 2, MT = 2), 1 x 32 or 1 x 16, all
// dy values in one block; or 1 x 16 with the dy values over 3 or 2d + 1
// blocks. The first that puts at least FILL blocks on the card, else the
// last. Returns the number of dy groups; *tile = 0, 1, 2 for the three tiles.
int pick_band(int n, int h, int w, int d, int* tile) {
  const long long rows = static_cast<long long>(n) * h;
  const long long rows2 = static_cast<long long>(n) * cdiv(h, 2);
  if (rows2 * cdiv(w, 32) >= FILL) return *tile = 0, 1;
  if (rows * cdiv(w, 32) >= FILL) return *tile = 1, 1;
  *tile = 2;
  for (int dg = 1; dg <= 3; dg += 2)
    if (rows * cdiv(w, 16) * dg >= FILL) return dg;
  return 2 * d + 1;
}

template <int D>
cudaError_t dispatch_band(const bf16* f1, const bf16* f2, bf16* out, int n,
                          int h, int w, int c, int f2_rows, int f2_off,
                          cudaStream_t s) {
  int tile;
  const int dg = pick_band(n, h, w, D, &tile);
  if (tile == 0)
    return launch_band_vec<D, 2, 2, 32>(f1, f2, out, n, h, w, c, f2_rows,
                                        f2_off, dg, s);
  if (tile == 1)
    return launch_band_vec<D, 1, 2, 32>(f1, f2, out, n, h, w, c, f2_rows,
                                        f2_off, dg, s);
  return launch_band_vec<D, 1, 1, 64>(f1, f2, out, n, h, w, c, f2_rows,
                                      f2_off, dg, s);
}

int run(const void* f1, const void* f2, void* out, int n, int h, int w,
        int c, int d, int pre, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f2_rows = pre ? h + 2 * d : h, f2_off = pre ? d : 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (is_bf16) {
    const auto* a = static_cast<const bf16*>(f1);
    const auto* b = static_cast<const bf16*>(f2);
    auto* o = static_cast<bf16*>(out);
    if (d == 1) e = dispatch_band<1>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 2) e = dispatch_band<2>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 3) e = dispatch_band<3>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 4) e = dispatch_band<4>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
  } else {
    const auto* a = static_cast<const float*>(f1);
    const auto* b = static_cast<const float*>(f2);
    auto* o = static_cast<float*>(out);
    if (d == 1) e = launch_f32<1>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 2) e = launch_f32<2>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 3) e = launch_f32<3>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
    if (d == 4) e = launch_f32<4>(a, b, o, n, h, w, c, f2_rows, f2_off, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// K1. f1, f2: (n, h, w, c); out: (n, h, w, (2d+1)^2); all contiguous, of one
// type: bf16 when is_bf16 (then f1 and f2 16-byte aligned), else f32.
// 1 <= d <= 4. Returns the CUDA error.
extern "C" int pwc_cost_volume_fwd(const void* f1, const void* f2, void* out,
                                   int n, int h, int w, int c, int d,
                                   int is_bf16, void* stream) {
  return run(f1, f2, out, n, h, w, c, d, 0, is_bf16, stream);
}

// K1p. f1: (n, h, w, c); f2e: (n, h + 2d, w, c), rows [-d, h + d) of the
// shard; out: (n, h, w, (2d+1)^2); as pwc_cost_volume_fwd otherwise.
extern "C" int pwc_cost_volume_fwd_prepadded(const void* f1, const void* f2e,
                                             void* out, int n, int h, int w,
                                             int c, int d, int is_bf16,
                                             void* stream) {
  return run(f1, f2e, out, n, h, w, c, d, 1, is_bf16, stream);
}

// The bf16 kernel's launch for a shape: the tile (0: 2 x 32 pixels, 1: 1 x
// 32, 2: 1 x 16) in *tile, the number of dy groups returned.
extern "C" int pwc_cost_volume_band_plan(int n, int h, int w, int d,
                                         int* tile) {
  return pick_band(n, h, w, d, tile);
}
