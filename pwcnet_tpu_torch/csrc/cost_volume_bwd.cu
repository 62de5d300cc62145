// Correlation backward (both inputs), written by hand for Hopper.
//
// Replaces: pwcnet_tpu/ops/pallas/cost_volume_kernel.py, _corr_bwd_f1_kernel
// (K2) and _corr_bwd_f2_kernel (K3), launched by _corr_backward_pallas (the
// VJP of cost_volume_pallas). Forward in cost_volume.cu:
//   out[n, y, x, k] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y + dy, x + dx, c]
//   k = (dy + d) * (2d + 1) + (dx + d), f2 = 0 outside the image.
// With g = dL/dout:
//   K2: df1[n, y, x, c] = (1/C) sum_k g[n, y, x, k] * f2[n, y + dy, x + dx, c]
//   K3: df2[n, y, x, c] = (1/C) sum_k g[n, y - dy, x - dx, k]
//                                   * f1[n, y - dy, x - dx, c]
// Taps outside the image are zero. K3 is the transpose of a scatter, written
// as a gather from the opposite displacement (as the Pallas kernel does), so
// it needs no atomics and its sums are the same run to run.
//
// Precision: as the JAX backward (CORR_BWD_COMPUTE_DTYPE = "f32"),
// products and sums are f32 (a product of two bf16 values is exact in f32),
// and the result is rounded once to the input type.
//
// Bound on an H100 SXM: each pixel reads 81 + 2C inputs and writes C outputs
// and does 162 * C flops, i.e. below 20 flops a byte, so the least time is
// the bytes over 3.35 TB/s. At PWC-Net's sizes what costs is latency and
// the number of blocks a level puts on the 132 SMs.
//
// bf16 (corr_bwd_band): banded products on the tensor cores (mma.sync
// m16n8k16, f32 sums; the helpers of corr_band.cuh). For an output row y,
// an m16 tile of pixels x0..x0+15 and one dy, the window is the 32 pixels
// x0-8..x0+23 (two whole k16 steps) of one feature row, and the tile gains
// a 16 x 32 band A of g times that window:
//   K3 (the transpose of K1's band): window = f1's row ys = y - dy,
//     A[i, j] = g[ys, x_j, k(dy, x_i - x_j)] for |x_i - x_j| <= d, else 0;
//   K2: window = f2's row y + dy,
//     A[i, j] = g[y, x_i, k(dy, x_j - x_i)] for |x_j - x_i| <= d, else 0.
//   - The block stages its feature rows (y0-d..y0+R-1+d, the columns of
//     its windows, its channel slice) once with cp.async, pixels pitched
//     CB + 8, and builds every band A (16 x 32, pitch 40: ldmatrix without
//     bank conflicts) of its (row, dy, m16 tile) once. K3 fills a band
//     column by column, from each source pixel's S taps of row dy; K2 row by
//     row: band row i is pixel x_i's S taps of row dy, contiguous in g and in
//     the band, so a block reads each g value of its own pixels once, and f2
//     is zero outside the image already. (A g pixel holds 81 values, 162
//     bytes, so wider loads than 2 bytes would be misaligned; a warp's loads
//     of consecutive pixels are all in flight at once.)
//   - B is the window, row-major in (K = pixel, N = channel): its fragments
//     come from ldmatrix.trans. A warp holds 16 pixels x 32 channels of f32
//     sums in registers over the 2d + 1 dy values, then scales them by 1/C,
//     rounds once and stores them.
//   - Filling the card: pick_bwd_band picks, per gradient, the tile (2 x
//     32, 1 x 32, 1 x 16 or 4 x 16 pixels) and the channel slice of a block
//     (32 or 64 channels; C = 196 pads to 208), from tools/tune_band.py's
//     measurements of every plan; rows, columns and slices make the blocks.
//     A block has at least 8 warps, so that its band fill keeps enough loads
//     in flight. No atomics: every output value is one warp's sum, the same
//     run to run.
//
// f32 (corr_bwd): the CUDA cores, the correctness path. One block per (n,
// 32-channel chunk, TH x TW pixel tile), 32 x TH threads: lane = channel in
// the chunk, warp = tile row. The block stages the f2 (K2) or f1 (K3) tile
// with a d-pixel halo, pixel-major with the 32 channels contiguous
// (coalesced loads, conflict-free reads), zero outside the image. It then
// walks dy: for each dy it stages the 2d+1 taps of g that this row of
// displacements needs (broadcast reads), loads the halo row of features into
// registers and updates the TW sums of its row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_band.cuh"

namespace {

constexpr int TW = 16;  // tile columns
constexpr int TH = 8;   // tile rows = warps per block
constexpr int CC = 32;  // channels per block = lanes

// F3 = false: K2 (feat = f2). F3 = true: K3 (feat = f1).
template <int D, bool F3>
__global__ void __launch_bounds__(CC * TH)
corr_bwd(const float* __restrict__ g, const float* __restrict__ feat,
         float* __restrict__ out, int H, int W, int C) {
  constexpr int S = 2 * D + 1;
  constexpr int K = S * S;
  constexpr int HR = TH + 2 * D;  // halo tile rows
  constexpr int HC = TW + 2 * D;  // halo tile columns
  // g taps of one dy: K2 at the tile's pixels, K3 at the halo columns of
  // the tile's rows shifted by -dy.
  constexpr int GC = F3 ? HC : TW;
  extern __shared__ float smem[];
  float* fs = smem;                 // HR * HC * CC
  float* gs = smem + HR * HC * CC;  // TH * GC * S

  const int nchunks = (C + CC - 1) / CC;
  const int n = blockIdx.z / nchunks;
  const int c0 = (blockIdx.z % nchunks) * CC;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int lane = threadIdx.x;  // channel c0 + lane
  const int ty = threadIdx.y;    // tile row
  const int tid = lane + CC * ty;
  constexpr int NTHR = CC * TH;
  const size_t img = static_cast<size_t>(n) * H * W;

  for (int e = tid; e < HR * HC * CC; e += NTHR) {
    const int c = e % CC, p = e / CC, col = p % HC, row = p / HC;
    const int y = y0 + row - D, x = x0 + col - D, cc = c0 + c;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W && cc < C)
      v = feat[(img + static_cast<size_t>(y) * W + x) * C + cc];
    fs[e] = v;
  }

  float acc[TW];
#pragma unroll
  for (int i = 0; i < TW; ++i) acc[i] = 0.f;

  for (int dy = 0; dy < S; ++dy) {
    __syncthreads();  // fs is staged / the previous gs is consumed
    for (int e = tid; e < TH * GC * S; e += NTHR) {
      const int dx = e % S, p = e / S, col = p % GC, row = p / GC;
      // K2: g at (y0 + row, x0 + col), channel dy*S + dx.
      // K3: g at (y0 + row - (dy - D), x0 + col - D), channel dy*S + dx;
      //     pixel (row, tx) then reads column tx + 2D - dx of this slice.
      const int y = F3 ? y0 + row - dy + D : y0 + row;
      const int x = F3 ? x0 + col - D : x0 + col;
      float v = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = g[(img + static_cast<size_t>(y) * W + x) * K + dy * S + dx];
      gs[e] = v;
    }
    __syncthreads();
    // Features of halo row (K2: ty + dy; K3: ty + 2D - dy), all columns.
    const int frow = F3 ? ty + 2 * D - dy : ty + dy;
    float f[HC];
#pragma unroll
    for (int j = 0; j < HC; ++j) f[j] = fs[(frow * HC + j) * CC + lane];
    const float* gr = gs + ty * GC * S;
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
#pragma unroll
      for (int tx = 0; tx < TW; ++tx) {
        const int j = F3 ? tx + 2 * D - dx : tx + dx;
        const float gv = F3 ? gr[j * S + dx] : gr[tx * S + dx];
        acc[tx] = fmaf(gv, f[j], acc[tx]);
      }
    }
  }

  const int y = y0 + ty, cc = c0 + lane;
  if (y >= H || cc >= C) return;
  const float inv_c = 1.f / static_cast<float>(C);
#pragma unroll
  for (int tx = 0; tx < TW; ++tx) {
    const int x = x0 + tx;
    if (x < W)
      out[(img + static_cast<size_t>(y) * W + x) * C + cc] = acc[tx] * inv_c;
  }
}

template <int D, bool F3>
constexpr size_t smem_bytes() {
  return ((TH + 2 * D) * (TW + 2 * D) * CC +
          TH * (F3 ? TW + 2 * D : TW) * (2 * D + 1)) * sizeof(float);
}

template <int D, bool F3>
cudaError_t launch(const void* g, const void* feat, void* out, int n, int h,
                   int w, int c, cudaStream_t stream) {
  // Above 48 KB (d = 4) only as opted-in dynamic shared memory.
  constexpr size_t bytes = smem_bytes<D, F3>();
  cudaError_t e = cudaFuncSetAttribute(
      corr_bwd<D, F3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH,
                  n * ((c + CC - 1) / CC));
  const dim3 block(CC, TH);
  corr_bwd<D, F3><<<grid, block, bytes, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(feat),
      static_cast<float*>(out), h, w, c);
  return cudaGetLastError();
}

template <bool F3>
cudaError_t dispatch(const void* g, const void* feat, void* out, int n, int h,
                     int w, int c, int d, cudaStream_t s) {
  switch (d) {
    case 1: return launch<1, F3>(g, feat, out, n, h, w, c, s);
    case 2: return launch<2, F3>(g, feat, out, n, h, w, c, s);
    case 3: return launch<3, F3>(g, feat, out, n, h, w, c, s);
    case 4: return launch<4, F3>(g, feat, out, n, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 K2 and K3: the bands on the tensor cores --------------------------

using c3::bf16;
using c3::cdiv;

constexpr int WIN = 32;          // window: x0 - 8 .. x0 + 23
constexpr int APITCH = WIN + 8;  // a band row, pitched for ldmatrix

// Warps of a block: one per (row, m16 tile, 32 channels), at least 8, so
// that the band fill has enough loads in flight.
__host__ __device__ constexpr int bwd_warps(int compute) {
  return compute > 8 ? compute : 8;
}

// Shared memory: the feature rows (R + 2d rows x 16 MT + 16 pixels, pitch
// 32 QW + 8), then the bands of (row, dy, m16 tile), 16 x APITCH each.
__host__ inline size_t bwd_band_bytes(int r, int mt, int qw, int d) {
  const size_t s = 2 * d + 1;
  return ((r + 2 * d) * (16 * mt + 16) * (32 * qw + 8) +
          r * s * mt * 16 * APITCH) * sizeof(bf16);
}

// K3's bands: zeros, then the taps. Band b = (r S + dyi) MT + mt, entry
// (i, j) = g[ys, x_j, dyi S + dx + D], ys = y0 + r - dyi + D, x_j = x0 + 16
// mt - 8 + j, dx = i + 8 - j. A thread takes (band, source pixel j), loads
// the pixel's S taps of row dyi together (contiguous in g, so a warp's loads
// are coalesced and all in flight at once), then writes those that fall on
// the tile's pixels 0..15.
template <int R, int MT>
__device__ __forceinline__ void fill_f2_bands(const bf16* __restrict__ g,
                                              bf16* bands, int img, int H,
                                              int W, int D, int y0, int x0) {
  const int S = 2 * D + 1, K = S * S, nb = R * S * MT;
  uint4* z = reinterpret_cast<uint4*>(bands);
  for (int e = threadIdx.x; e < nb * 16 * APITCH / 8; e += blockDim.x)
    z[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int e = threadIdx.x; e < nb * WIN; e += blockDim.x) {
    const int j = e % WIN, b = e / WIN;
    const int mt = b % MT, rd = b / MT, dyi = rd % S, r = rd / S;
    const int ys = y0 + r - dyi + D, xs = x0 + 16 * mt - 8 + j;
    if (ys < 0 || ys >= H || xs < 0 || xs >= W) continue;
    const bf16* src =
        g + ((static_cast<size_t>(img) * H + ys) * W + xs) * K + dyi * S;
    bf16* dst = bands + b * 16 * APITCH + j;
    const int i0 = j - 8 - D;  // the pixel of tap dxi is i0 + dxi
    bf16 v[9];
#pragma unroll
    for (int dxi = 0; dxi < 9; ++dxi)
      if (dxi < S && i0 + dxi >= 0 && i0 + dxi < 16) v[dxi] = src[dxi];
#pragma unroll
    for (int dxi = 0; dxi < 9; ++dxi)
      if (dxi < S && i0 + dxi >= 0 && i0 + dxi < 16)
        dst[(i0 + dxi) * APITCH] = v[dxi];
  }
}

// K2's bands. Band b = (r S + dyi) MT + mt, row i = output pixel x_i = x0 +
// 16 mt + i of row y = y0 + r: g[y, x_i, dyi S + dxi] at column i + 8 - D +
// dxi, the pixel's S taps of row dyi, contiguous in g and in the row. A
// thread takes (band, row): it loads the taps, zeroes the row's 32 columns
// and writes the taps, all its own stores, so no barrier parts zeros and
// taps. Rows of pixels outside the image stay zero; a band whose f2 row y +
// dyi - D is outside the image is skipped by the products, so it is not
// filled.
template <int R, int MT>
__device__ __forceinline__ void fill_f1_bands(const bf16* __restrict__ g,
                                              bf16* bands, int img, int H,
                                              int W, int D, int y0, int x0) {
  const int S = 2 * D + 1, K = S * S, nb = R * S * MT;
  for (int e = threadIdx.x; e < nb * 16; e += blockDim.x) {
    const int i = e % 16, b = e / 16;
    const int mt = b % MT, rd = b / MT, dyi = rd % S, r = rd / S;
    const int y = y0 + r, x = x0 + 16 * mt + i, yf = y + dyi - D;
    if (yf < 0 || yf >= H) continue;
    const bool in = y < H && x < W;
    const bf16* src =
        in ? g + ((static_cast<size_t>(img) * H + y) * W + x) * K + dyi * S
           : g;
    bf16 v[9];
#pragma unroll
    for (int dxi = 0; dxi < 9; ++dxi)
      if (in && dxi < S) v[dxi] = src[dxi];
    bf16* row = bands + (b * 16 + i) * APITCH;
    uint4* z = reinterpret_cast<uint4*>(row);  // 80-byte rows: aligned
#pragma unroll
    for (int q = 0; q < WIN / 8; ++q) z[q] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int dxi = 0; dxi < 9; ++dxi)
      if (in && dxi < S) row[i + 8 - D + dxi] = v[dxi];
  }
}

// One block: output rows R * blockIdx.y + [0, R), columns 16 MT * blockIdx.x
// + [0, 16 MT), channels CB * (blockIdx.z % slices) + [0, CB) with CB = 32
// QW, image blockIdx.z / slices. Warp (r, mt, q) takes row r, m16 tile mt
// and channels 32 q + [0, 32) of the slice. F1: K2 (feat = f2, out = df1);
// else K3 (feat = f1, out = df2).
template <bool F1, int R, int MT, int QW, int VEC>
__global__ void __launch_bounds__(bwd_warps(R * MT * QW) * 32)
corr_bwd_band(const bf16* __restrict__ g, const bf16* __restrict__ feat,
              bf16* __restrict__ out, int H, int W, int C, int D,
              int slices) {
  constexpr int XW = 16 * MT, FW = XW + 16, CB = 32 * QW, PITCH = CB + 8;
  const int S = 2 * D + 1, FR = R + 2 * D;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* fs = reinterpret_cast<bf16*>(bwd_smem);  // feature row y0 - D + i
  bf16* bands = fs + FR * FW * PITCH;

  const int img = blockIdx.z / slices, c0 = blockIdx.z % slices * CB;
  const int y0 = blockIdx.y * R, x0 = blockIdx.x * XW;
  const int cp = (C + 15) / 16 * 16;
  band::stage_band<VEC, CB, FW>(feat, img, H, W, C, y0 - D, x0 - 8, FR, c0,
                                min(CB, cp - c0) / VEC, fs);
  band::cp_commit();
  if constexpr (F1)
    fill_f1_bands<R, MT>(g, bands, img, H, W, D, y0, x0);
  else
    fill_f2_bands<R, MT>(g, bands, img, H, W, D, y0, x0);
  band::cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp % QW, mt = warp / QW % MT, r = warp / (QW * MT);
  if (warp >= R * MT * QW) return;  // a staging warp
  // Channel pairs (16 channels) of the warp's 32 that hold padded channels.
  const int pairs = max(0, min(2, (cp - c0 - 32 * q) / 16));
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;

  for (int dyi = 0; dyi < S; ++dyi) {
    // The window's row: f2's y + dy (K2), f1's y - dy (K3), staged as row
    // ys - y0 + D. (Tested on ys: with the staged row as the test, ptxas
    // spilled 4 bytes in a third of the entries.)
    const int ys = F1 ? y0 + r + dyi - D : y0 + r - dyi + D;
    if (ys < 0 || ys >= H) continue;  // a row of zeros
    const bf16* a_band = bands + ((r * S + dyi) * MT + mt) * 16 * APITCH;
    const bf16* win = fs + ((F1 ? r + dyi : r - dyi + 2 * D) * FW + 16 * mt) *
                               PITCH + 32 * q;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4];
      c3::ldsm_x4(a, a_band + c3::a_row(lane) * APITCH + 16 * ks +
                         c3::a_k(lane));
      // Matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
      // n 8-15) of the pair, transposed: b0, b1 of two n8 tiles.
      const bf16* row = win + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                  PITCH + 8 * (lane >> 4);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p >= pairs) break;
        uint32_t b[4];
        c3::ldsm_x4_t(b, row + 16 * p);
        c3::mma(acc[2 * p], a, b[0], b[1]);
        c3::mma(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }

  // c0, c1: pixel gi, channels 2t, 2t + 1 of n8 tile nt; c2, c3: pixel
  // gi + 8. Scaled by 1/C and rounded once; channel pairs as one 4-byte
  // store where C is even.
  const int y = y0 + r;
  if (y >= H) return;
  const float inv_c = 1.f / static_cast<float>(C);
  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt >= 2 * pairs) break;
    const int cc = c0 + 32 * q + 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + 16 * mt + gi + 8 * half;
      if (x >= W || cc >= C) continue;
      bf16* o = out + ((static_cast<size_t>(img) * H + y) * W + x) * C + cc;
      const float v0 = acc[nt][2 * half] * inv_c;
      const float v1 = acc[nt][2 * half + 1] * inv_c;
      if (VEC > 1) {
        *reinterpret_cast<uint32_t*>(o) = c3::pack(v0, v1);
      } else {
        o[0] = __float2bfloat16_rn(v0);
        if (cc + 1 < C) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <bool F1, int R, int MT, int QW, int VEC>
cudaError_t launch_band(const bf16* g, const bf16* feat, bf16* out, int n,
                        int h, int w, int c, int d, cudaStream_t stream) {
  const size_t smem = bwd_band_bytes(R, MT, QW, d);
  const int slices = cdiv(cdiv(c, 16) * 16, 32 * QW);
  const long long gz = static_cast<long long>(n) * slices;
  if (smem > c3::MAX_SMEM || cdiv(h, R) > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  auto kernel = corr_bwd_band<F1, R, MT, QW, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(w, 16 * MT), cdiv(h, R), static_cast<unsigned>(gz));
  kernel<<<grid, bwd_warps(R * MT * QW) * 32, smem, stream>>>(
      g, feat, out, h, w, c, d, slices);
  return cudaGetLastError();
}

// The copy width of the feature staging: 16 bytes where C % 8 == 0, 8
// where C % 4 == 0, else 2.
template <bool F1, int R, int MT, int QW>
cudaError_t launch_band_vec(const bf16* g, const bf16* feat, bf16* out,
                            int n, int h, int w, int c, int d,
                            cudaStream_t s) {
  if (c % 8 == 0)
    return launch_band<F1, R, MT, QW, 8>(g, feat, out, n, h, w, c, d, s);
  if (c % 4 == 0)
    return launch_band<F1, R, MT, QW, 4>(g, feat, out, n, h, w, c, d, s);
  return launch_band<F1, R, MT, QW, 1>(g, feat, out, n, h, w, c, d, s);
}

template <bool F1>
cudaError_t dispatch_band_of(const bf16* g, const bf16* feat, bf16* out,
                             int n, int h, int w, int c, int d, int tile,
                             int qw, cudaStream_t s) {
#define PWC_BAND(R, MT)                                                      \
  (qw == 1 ? launch_band_vec<F1, R, MT, 1>(g, feat, out, n, h, w, c, d, s)   \
           : launch_band_vec<F1, R, MT, 2>(g, feat, out, n, h, w, c, d, s))
  switch (tile) {
    case 0: return PWC_BAND(2, 2);
    case 1: return PWC_BAND(1, 2);
    case 2: return PWC_BAND(1, 1);
    case 3: return PWC_BAND(4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef PWC_BAND
}

// which: 1 = K2, 2 = K3; tile: 0: 2 x 32 pixels, 1: 1 x 32, 2: 1 x 16, 3:
// 4 x 16; qw: 32-channel groups a block takes (1 or 2).
cudaError_t dispatch_band(const void* g, const void* feat, void* out, int n,
                          int h, int w, int c, int d, int which, int tile,
                          int qw, cudaStream_t s) {
  if (d < 1 || d > 4 || (qw != 1 && qw != 2) || (which != 1 && which != 2))
    return cudaErrorInvalidValue;
  const bf16 *gb = static_cast<const bf16*>(g),
             *fb = static_cast<const bf16*>(feat);
  bf16* ob = static_cast<bf16*>(out);
  return which == 1
             ? dispatch_band_of<true>(gb, fb, ob, n, h, w, c, d, tile, qw, s)
             : dispatch_band_of<false>(gb, fb, ob, n, h, w, c, d, tile, qw, s);
}

// The tile and the channel slice of a bf16 K2 (which = 1) or K3 (which = 2)
// launch, set from tools/tune_band.py's tables of every plan at the train
// step's levels (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 4 x 16
// pixels where that puts a block on a third of the SMs (its feature rows
// serve four output rows), else 1 x 16 pixels. K3 takes 64-channel slices
// on the 4 x 16 tile where C >= 64; K2, whose band fill reads fewer g bytes
// a block, gains more from the blocks of 32-channel slices than it pays
// for filling its bands once per slice, and takes them everywhere. Returns
// qw (the slice is 32 qw channels); the tile in *tile.
int pick_bwd_band(int which, int n, int h, int w, int c, int* tile) {
  const long long blocks4 = static_cast<long long>(n) * cdiv(h, 4) *
                            cdiv(w, 16);
  if (blocks4 >= band::FILL / 3)
    return *tile = 3, which == 2 && c >= 64 ? 2 : 1;
  return *tile = 2, 1;
}

}  // namespace

// g: (n, h, w, (2d+1)^2); feat, out: (n, h, w, c); all contiguous, of one
// type: bf16 when is_bf16, else f32. 1 <= d <= 4. which = 1: K2 (feat = f2,
// out = df1); which = 2: K3 (feat = f1, out = df2). Returns the CUDA error.
extern "C" int pwc_cost_volume_bwd(const void* g, const void* feat, void* out,
                                   int n, int h, int w, int c, int d,
                                   int which, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (which != 1 && which != 2) {
    e = cudaErrorInvalidValue;
  } else if (is_bf16) {
    int tile;
    const int qw = pick_bwd_band(which, n, h, w, c, &tile);
    e = dispatch_band(g, feat, out, n, h, w, c, d, which, tile, qw, s);
  } else {
    e = which == 1 ? dispatch<false>(g, feat, out, n, h, w, c, d, s)
                   : dispatch<true>(g, feat, out, n, h, w, c, d, s);
  }
  return static_cast<int>(e);
}

// The bf16 K2's (which = 1) or K3's (which = 2) launch for a shape: the
// tile (0: 2 x 32 pixels, 1: 1 x 32, 2: 1 x 16, 3: 4 x 16) in *tile;
// returns the 32-channel groups of a block's slice.
extern "C" int pwc_cost_volume_bwd_band_plan(int which, int n, int h, int w,
                                             int c, int* tile) {
  return pick_bwd_band(which, n, h, w, c, tile);
}

// The bf16 K2 or K3 with the tile and the slice given, for tuning the plan
// (tools/tune_band.py). g, feat, out, which as pwc_cost_volume_bwd's, bf16.
extern "C" int pwc_cost_volume_bwd_tiled(const void* g, const void* feat,
                                         void* out, int n, int h, int w,
                                         int c, int d, int which, int tile,
                                         int qw, void* stream) {
  return static_cast<int>(dispatch_band(g, feat, out, n, h, w, c, d, which,
                                        tile, qw,
                                        static_cast<cudaStream_t>(stream)));
}
