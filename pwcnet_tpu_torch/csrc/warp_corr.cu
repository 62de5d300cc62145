// Fused bilinear warp + correlation (K6), written by hand for Hopper.
//
// Replaces: pwcnet_tpu/ops/pallas/warp_corr_kernel.py, _fused_kernel
// (launched by _fused_forward; entry warp_corr_fused, with the corner gather
// _gather_corners in XLA in front of it).
//
//   warped[n, y, x, c] = round_T(mask * sum_a w_a * (m_a * f2[n, y_a, x_a, c]))
//   out[n, y, x, k] = (1/C) * sum_c f1[n, y, x, c] * warped[n, y + dy, x + dx, c]
//
// with the four bilinear corners a of (x + flow_x, y + flow_y), their weights
// w_a, their in-bounds masks m_a and the coverage mask (sum_a w_a * m_a >=
// 0.9999), exactly as pwcnet_tpu_torch/ops/warp.py computes them; warped = 0
// outside the image (the correlation's zero padding belongs to the warped
// tensor). k = (dy + d) * (2d + 1) + (dx + d).
//
// The Pallas design keeps the gather in XLA, because Mosaic cannot gather,
// and feeds the kernel a packed 4C-wide corner table. On Hopper a gather in
// the kernel is cheap, and the table would read 4x f2's bytes, so this kernel
// takes (f1, f2, flow) directly and never writes the warped tensor to device
// memory.
//
// Bound on an H100 SXM: each pixel reads 2C features and 2 flow values and
// writes 81 outputs, and does 2 * C * (81 + 4) flops: far below the bf16
// tensor-core balance point, so the least time is the bytes over 3.35 TB/s.
// At PWC-Net's sizes what costs is latency, as in K1 (csrc/cost_volume.cu).
//
// bf16 (warp_corr_band): K1's banded products on the tensor cores
// (corr_band.cuh: for one output row, an m16 tile of f1 pixels against the
// 24-pixel window x0-4..x0+19 of warped row y+dy, the taps on the
// diagonals), with the B tile made by the warp instead of copied:
//   - Corners: before the channel loop the block computes the four corner
//     offsets and weights of every warped pixel of its B rows (R rows plus
//     the dy group's, x0-4..x0+XW+3) into shared memory, with the f32
//     kernel's own function (warp_corners below).
//   - Blend: per chunk of CK channels, each thread takes (warped pixel,
//     vector of VEC channels), loads the four corner vectors (NHWC: each
//     corner is a contiguous C-vector; 16-byte loads where C % 8 == 0,
//     8-byte where C % 4 == 0, 2-byte otherwise), blends them in f32 in
//     warp.py's order, rounds once to bf16 and stores straight into the
//     pitched B tile that ldmatrix reads. The f1 tile (A) arrives by
//     cp.async, double-buffered as in K1, so the f1 loads of chunk k + 1
//     are in flight under the blend of chunk k + 1 and the products of
//     chunk k.
//   - The warped values are bit-identical to the f32-order blend of
//     warp.py rounded to bf16; only the order of the f32 tap sums differs
//     from warp_corr_ref.
//   - Filling the card: pick_wc_band picks the tile (8 x 16, 4 x 16, 2 x 32
//     or 1 x 16 pixels; 1 x 32 only for tools/tune_band.py) and the split
//     of the dy values over blocks, from measurements of every plan. A
//     block warps R + dyg - 1 rows for R output rows: a tall tile blends
//     fewer rows per output row, a dy split blends none twice at R = 1.
//
// f32 (warp_corr_fwd, the correctness path, held to 1e-5): K1's f32 tiling
// on the CUDA cores, with only the staging of the f2 tile changed. One
// block per (n, TH rows, TW columns) of output; one thread per (pixel, dy)
// keeps the 2d+1 sums of its dx row in registers. Before the channel loop,
// the block computes, for each pixel of the tile and its d-pixel halo, the
// four corner offsets (or -1 for a corner that contributes nothing) and the
// four weights, into shared memory. Each C chunk then gathers the corners,
// blends them in f32 and stores the warped tile channel-major in shared
// memory.
//
// Exactness (both paths). The coverage mask is a threshold: a cov rounded
// otherwise than eager PyTorch's separate kernels round it can flip a pixel
// in or out, and all 81 of its outputs with it. So the coordinates,
// weights, cov and the blend use __fadd_rn / __fsub_rn / __fmul_rn (never
// contracted into FMAs), in the order of warp.py: w00 = (1 - wy)(1 - wx),
// ..., cov = ((w00 m00 + w01 m01) + w10 m10) + w11 m11, blend = ((w00 g00 +
// w01 g01) + w10 g10) + w11 g11. Corner indices are clamped before any
// load.
//
// K6p (PRE = true) replaces the same Pallas kernel under
// _fused_forward(rows_prepadded=True) (entry warp_corr_fused_prepadded, with
// the corner gather parallel/halo.py:_warp_ext_corners in XLA in front of
// it): the spatially sharded form. The shard's output rows are [0, t); f2
// arrives as f2e, global rows [row0 - halo, row0 + t + halo), and the flow
// with d halo rows, rows [-d, t + d). Every warped row of the tile, halo
// included, is real: the warp runs on rows [-d, t + d). As in
// _warp_ext_corners, the sample row is global (y + row0 + flow_y), the
// in-bounds masks test the global image [0, h_global), and the corners come
// from a table over a 1-pixel zero ring of f2e, clamped to it: corner row
// yc + a_y - 1 of f2e with yc = clip(y0 - row0 + halo + 1, 0, te), so a
// sample beyond the exchanged rows reads the ring (zero) and the farthest
// exchanged row. Columns work the same way with xc = clip(x0 + 1, 0, W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "corr_band.cuh"

namespace {

using band::BAND;
using band::TPW;
using c3::bf16;
using c3::cdiv;

// The bilinear corners of warped pixel (y, x) of the output frame (warp.py's
// math; under PRE, _warp_ext_corners'): idx[a] is the pixel (row * W +
// column) of f2's image for corner a = y0x0, y0x1, y1x0, y1x1, or -1 where
// it contributes nothing; wt[a] is its weight. The flow of warped row y is
// row y (K6) or y + D (K6p) of the image's flow_rows rows at flow_img. H:
// output rows (the shard's t under PRE). te: f2 rows (H, or t + 2 halo).
// row0, h_global, halo: the shard's place in the image (PRE only).
template <bool PRE>
__device__ __forceinline__ void warp_corners(
    const float* __restrict__ flow, size_t flow_img, int flow_rows, int y,
    int x, int W, int H, int D, int te, int row0, int h_global, int halo,
    int (&idx)[4], float (&wt)[4]) {
  const float wmax = static_cast<float>(W - 1);
  const float hmax = static_cast<float>((PRE ? h_global : H) - 1);
  const int fr = PRE ? y + D : y;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    idx[a] = -1;
    wt[a] = 0.f;
  }
  if (fr >= 0 && fr < flow_rows && x >= 0 && x < W) {
    const float* fl = flow + (flow_img + static_cast<size_t>(fr) * W + x) * 2;
    const float xs = __fadd_rn(static_cast<float>(x), fl[0]);
    const float ys = __fadd_rn(static_cast<float>(PRE ? y + row0 : y), fl[1]);
    const float xa = floorf(xs), ya = floorf(ys);
    const float xb = __fadd_rn(xa, 1.f), yb = __fadd_rn(ya, 1.f);
    const float wx = __fsub_rn(xs, xa), wy = __fsub_rn(ys, ya);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    wt[0] = __fmul_rn(uy, ux);
    wt[1] = __fmul_rn(uy, wx);
    wt[2] = __fmul_rn(wy, ux);
    wt[3] = __fmul_rn(wy, wx);
    const float cx[2] = {xa, xb}, cy[2] = {ya, yb};
    float cov = 0.f;
    bool inb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float xi = cx[a & 1], yi = cy[a >> 1];
      inb[a] = xi >= 0.f && xi <= wmax && yi >= 0.f && yi <= hmax;
      cov = __fadd_rn(cov, __fmul_rn(wt[a], inb[a] ? 1.f : 0.f));
    }
    if (cov >= 0.9999f) {
      if constexpr (PRE) {
        // The ring table's clamped corner (f2e row j0 = y0 - row0 + halo).
        const float j0 = __fadd_rn(__fsub_rn(ya, static_cast<float>(row0)),
                                   static_cast<float>(halo));
        const int yc = static_cast<int>(
            fminf(fmaxf(__fadd_rn(j0, 1.f), 0.f), static_cast<float>(te)));
        const int xc =
            static_cast<int>(fminf(fmaxf(xb, 0.f), static_cast<float>(W)));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = yc + (a >> 1) - 1, c = xc + (a & 1) - 1;
          if (inb[a] && r >= 0 && r < te && c >= 0 && c < W)
            idx[a] = r * W + c;
        }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          // Clamped before the conversion: far or non-finite coordinates
          // never reach an index.
          const int xi = static_cast<int>(fminf(fmaxf(cx[a & 1], 0.f), wmax));
          const int yi = static_cast<int>(fminf(fmaxf(cy[a >> 1], 0.f), hmax));
          if (inb[a]) idx[a] = yi * W + xi;
        }
      }
    }
  }
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int TW = 32;  // output columns per block (one warp)
constexpr int TH = 2;   // output rows per block
constexpr int CC = 16;  // channels staged per chunk

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Two blocks per SM (56 registers at d = 4), as in csrc/cost_volume.cu: one
// block per SM made K6 up to 47% slower at the large levels.
template <typename T, int D, bool PRE>
__global__ void __launch_bounds__(TW * TH * (2 * D + 1), 2)
warp_corr_fwd(const T* __restrict__ f1, const T* __restrict__ f2,
              const float* __restrict__ flow, T* __restrict__ out, int H,
              int W, int C, int te, int row0, int h_global, int halo) {
  constexpr int S = 2 * D + 1;
  constexpr int K = S * S;
  constexpr int HR = TH + 2 * D;  // warped tile rows, halo included
  constexpr int HC = TW + 2 * D;  // warped tile columns, halo included
  constexpr int NP = HR * HC;     // warped tile pixels
  constexpr int F1N = CC * TH * TW;
  constexpr int F2N = CC * NP;
  static_assert(TH * TW * K <= F2N, "output staging must fit the f2 tile");
  __shared__ float f1s[F1N];
  __shared__ float f2s[F2N];  // after the last chunk: the output staging
  __shared__ int cidx[NP * 4];    // corner pixel offsets in image n, or -1
  __shared__ float cw[NP * 4];    // corner weights

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int nthr = TW * TH * S;
  const int tid = threadIdx.x + TW * threadIdx.y;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y / S;
  const int dy = threadIdx.y % S;
  const size_t img = static_cast<size_t>(n) * H * W;
  const int flow_rows = PRE ? H + 2 * D : H;
  const size_t flow_img = static_cast<size_t>(n) * flow_rows * W;

  // Corners and weights of every warped pixel of the tile.
  for (int p = tid; p < NP; p += nthr) {
    int idx[4];
    float wt[4];
    warp_corners<PRE>(flow, flow_img, flow_rows, y0 + p / HC - D,
                      x0 + p % HC - D, W, H, D, te, row0, h_global, halo,
                      idx, wt);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      cidx[p * 4 + a] = idx[a];
      cw[p * 4 + a] = wt[a];
    }
  }
  __syncthreads();

  float acc[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc[i] = 0.f;

  const T* f2n = f2 + static_cast<size_t>(n) * te * W * C;
  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int e = tid; e < F1N; e += nthr) {
      const int c = e % CC, p = e / CC, col = p % TW, row = p / TW;
      const int y = y0 + row, x = x0 + col, cc = c0 + c;
      float v = 0.f;
      if (y < H && x < W && cc < C)
        v = load_f32(f1 + (img + static_cast<size_t>(y) * W + x) * C + cc);
      f1s[(c * TH + row) * TW + col] = v;
    }
    for (int e = tid; e < F2N; e += nthr) {
      const int c = e % CC, p = e / CC, cc = c0 + c;
      float v = 0.f;
      if (cc < C) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = cidx[p * 4 + a];
          if (i >= 0)
            v = __fadd_rn(v, __fmul_rn(cw[p * 4 + a],
                                       load_f32(f2n + static_cast<size_t>(i) *
                                                          C + cc)));
        }
        v = round_to(v, f2);
      }
      f2s[c * NP + p] = v;  // p = row * HC + col
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

  // Stage: pixel (ty, tx) holds channels [dy * S, dy * S + S).
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
    T* dst = out + (img + static_cast<size_t>(y) * W + x0) * K;
    const float* src = f2s + row * TW * K;
    for (int e = tid; e < cols * K; e += nthr) store(dst + e, src[e]);
  }
}

template <typename T, int D, bool PRE>
cudaError_t launch(const void* f1, const void* f2, const float* flow,
                   void* out, int n, int h, int w, int c, int te, int row0,
                   int h_global, int halo, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  const dim3 block(TW, TH * (2 * D + 1));
  warp_corr_fwd<T, D, PRE><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), flow,
      static_cast<T*>(out), h, w, c, te, row0, h_global, halo);
  return cudaGetLastError();
}

template <typename T, bool PRE>
cudaError_t dispatch(const void* f1, const void* f2, const float* flow,
                     void* out, int n, int h, int w, int c, int d, int te,
                     int row0, int h_global, int halo, cudaStream_t s) {
#define PWC_LAUNCH(D)                                                     \
  launch<T, D, PRE>(f1, f2, flow, out, n, h, w, c, te, row0, h_global, \
                    halo, s)
  switch (d) {
    case 1: return PWC_LAUNCH(1);
    case 2: return PWC_LAUNCH(2);
    case 3: return PWC_LAUNCH(3);
    case 4: return PWC_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef PWC_LAUNCH
}

// ---- bf16: the warped band on the tensor cores -----------------------------

// Channels [ch, ch + VEC) of the warped pixel with corners (o, wt) of image
// f2n (c channels): the f32 blend in warp.py's order, rounded once to bf16,
// into dst; zeros at ch >= c (the padding to a multiple of 16 channels).
// VEC = 8: 16-byte loads (c % 8 == 0), 4: 8-byte (c % 4 == 0), 1: 2-byte.
// The four corner loads are issued before the blend, so they are in flight
// together.
template <int VEC>
__device__ __forceinline__ void blend(const bf16* __restrict__ f2n, int c,
                                      int ch, int4 o, float4 wt, bf16* dst) {
  using Raw = typename std::conditional<
      VEC == 8, uint4,
      typename std::conditional<VEC == 4, uint2, uint16_t>::type>::type;
  const int off[4] = {o.x, o.y, o.z, o.w};
  const float w[4] = {wt.x, wt.y, wt.z, wt.w};
  float v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  if (ch < c) {
    Raw raw[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (off[a] >= 0)
        raw[a] = __ldg(reinterpret_cast<const Raw*>(
            f2n + static_cast<size_t>(off[a]) * c + ch));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (off[a] < 0) continue;
      uint32_t u[(VEC + 1) / 2];
      if constexpr (VEC == 8) {
        u[0] = raw[a].x, u[1] = raw[a].y, u[2] = raw[a].z, u[3] = raw[a].w;
      } else if constexpr (VEC == 4) {
        u[0] = raw[a].x, u[1] = raw[a].y;
      } else {
        u[0] = raw[a];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // bf16 -> f32 is exact: the bits move to the top half.
        const float f = __uint_as_float(i & 1 ? u[i >> 1] & 0xffff0000u
                                              : u[i >> 1] << 16);
        v[i] = __fadd_rn(v[i], __fmul_rn(w[a], f));
      }
    }
  }
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(c3::pack(v[0], v[1]), c3::pack(v[2], v[3]),
                   c3::pack(v[4], v[5]), c3::pack(v[6], v[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(c3::pack(v[0], v[1]), c3::pack(v[2], v[3]));
  } else {
    *dst = __float2bfloat16_rn(v[0]);
  }
}

// The arguments of a bf16 launch (K6: te = h, row0 = 0, h_global = h).
struct WarpArgs {
  const bf16* f1;
  const bf16* f2;
  const float* flow;
  bf16* out;
  int n, h, w, c, d, te, row0, h_global, halo;
};

// The corner table's bytes: an int4 of offsets and a float4 of weights for
// each warped pixel of the largest dy group's R + dyg - 1 rows.
__host__ __device__ constexpr int corner_pixels(int r, int mt, int dyg) {
  return (r + dyg - 1) * (16 * mt + BAND);
}

// One block: output rows R * (blockIdx.y / dg) + [0, R), columns 16 MT *
// blockIdx.x + [0, 16 MT), dy indices [g dyg, g dyg + dyg) ∩ [0, 2D + 1)
// with g = blockIdx.y % dg, image blockIdx.z. Row i of the B tile is warped
// row y0 + g dyg - D + i, column j warped column x0 - 4 + j. Shared memory:
// the corner table, then two chunk buffers (A: R x XW f1 pixels, B: the
// warped rows), then over the buffers the taps' f32 staging.
template <int R, int MT, int CK, int VEC, bool PRE>
__global__ void __launch_bounds__(band::band_warps(R * MT * TPW) * 32)
warp_corr_band(const bf16* __restrict__ f1, const bf16* __restrict__ f2,
               const float* __restrict__ flow, bf16* __restrict__ out, int H,
               int W, int C, int D, int te, int row0, int h_global, int halo,
               int dg, int dyg) {
  constexpr int XW = 16 * MT, WW = XW + BAND, PITCH = CK + 8, NV = CK / VEC;
  const int S = 2 * D + 1;
  extern __shared__ __align__(16) unsigned char wc_smem[];
  const int np = corner_pixels(R, MT, dyg);
  int4* cidx = reinterpret_cast<int4*>(wc_smem);
  float4* cwt = reinterpret_cast<float4*>(cidx + np);
  bf16* bufs = reinterpret_cast<bf16*>(cwt + np);
  float* taps = reinterpret_cast<float*>(bufs);

  const int img = blockIdx.z;
  const int g = blockIdx.y % dg, y0 = blockIdx.y / dg * R;
  const int x0 = blockIdx.x * XW;
  const int dy_lo = g * dyg, ndy = min(dyg, S - dy_lo);
  const int f2r = R + ndy - 1;  // warped rows the block makes
  const int chunk = (R * XW + (R + dyg - 1) * WW) * PITCH;
  const int cp = (C + 15) / 16 * 16, chunks = cdiv(cp, CK);

  const int wq = cdiv(dyg, TPW);
  const int warp = threadIdx.x >> 5;
  const int q = warp % wq, mt = warp / wq % MT, r = warp / (wq * MT);
  const bool computes = warp < R * MT * wq;  // the others only stage

  const int flow_rows = PRE ? H + 2 * D : H;
  const size_t flow_img = static_cast<size_t>(img) * flow_rows * W;
  for (int p = threadIdx.x; p < f2r * WW; p += blockDim.x) {
    int idx[4];
    float wt[4];
    warp_corners<PRE>(flow, flow_img, flow_rows, y0 + dy_lo - D + p / WW,
                      x0 - BAND / 2 + p % WW, W, H, D, te, row0, h_global,
                      halo, idx, wt);
    cidx[p] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    cwt[p] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
  __syncthreads();

  const bf16* f2n = f2 + static_cast<size_t>(img) * te * W * C;
  auto stage = [&](int k) {
    bf16* a = bufs + (k & 1) * chunk;
    const int c0 = k * CK, nvk = min(CK, cp - c0) / VEC;
    band::stage_band<VEC, CK, XW>(f1, img, H, W, C, y0, x0, R, c0, nvk, a);
    band::cp_commit();
    // The warped B tile: a thread per (warped pixel p, vector v).
    bf16* b = a + R * XW * PITCH;
    for (int e = threadIdx.x; e < f2r * WW * NV; e += blockDim.x) {
      const int v = e % NV, p = e / NV;
      if (v < nvk)
        blend<VEC>(f2n, C, c0 + v * VEC, cidx[p], cwt[p],
                   b + p * PITCH + v * VEC);
    }
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
      stage(k + 1);  // the buffers of chunk k - 1, free since its last sync
      band::cp_wait<1>();
    } else {
      band::cp_wait<0>();
    }
    __syncthreads();
    const bf16* a_tile = bufs + (k & 1) * chunk;
    const int steps = computes ? min(CK, cp - k * CK) / 16 : 0;
    band::band_mma<XW, PITCH>(acc, a_tile, a_tile + R * XW * PITCH, r, mt,
                              q, ndy, steps);
    __syncthreads();
  }

  if (computes)
    band::band_taps<XW>(acc, taps, r, mt, q, ndy, dyg, D,
                        static_cast<float>(C));
  __syncthreads();
  band::band_store<R, XW>(out, taps, img, H, W, y0, x0, D, dg, dyg, dy_lo,
                          ndy);
}

template <int R, int MT, int CK, int VEC, bool PRE>
cudaError_t launch_band(const WarpArgs& a, int dg, cudaStream_t stream) {
  const int s = 2 * a.d + 1, dyg = cdiv(s, dg);
  dg = cdiv(s, dyg);
  const int chunks = cdiv(cdiv(a.c, 16) * 16, CK);
  const size_t smem =
      corner_pixels(R, MT, dyg) * (sizeof(int4) + sizeof(float4)) +
      band::fwd_stage_bytes(R, MT, CK, a.d, dyg, chunks);
  const long long gy = static_cast<long long>(cdiv(a.h, R)) * dg;
  if (smem > c3::MAX_SMEM || gy > 65535 || a.n > 65535)
    return cudaErrorInvalidValue;
  auto kernel = warp_corr_band<R, MT, CK, VEC, PRE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(a.w, 16 * MT), static_cast<unsigned>(gy), a.n);
  kernel<<<grid, band::band_warps(R * MT * cdiv(dyg, TPW)) * 32, smem,
           stream>>>(a.f1, a.f2, a.flow, a.out, a.h, a.w, a.c, a.d, a.te,
                     a.row0, a.h_global, a.halo, dg, dyg);
  return cudaGetLastError();
}

// The copy width: 16 bytes where C % 8 == 0, 8 where C % 4 == 0, else 2.
template <int R, int MT, int CK, bool PRE>
cudaError_t launch_band_vec(const WarpArgs& a, int dg, cudaStream_t s) {
  if (a.c % 8 == 0) return launch_band<R, MT, CK, 8, PRE>(a, dg, s);
  if (a.c % 4 == 0) return launch_band<R, MT, CK, 4, PRE>(a, dg, s);
  return launch_band<R, MT, CK, 1, PRE>(a, dg, s);
}

template <bool PRE>
cudaError_t dispatch_band(const WarpArgs& a, int tile, int dg,
                          cudaStream_t s) {
  if (a.d < 1 || a.d > 4 || dg < 1) return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_band_vec<2, 2, 32, PRE>(a, dg, s);
    case 1: return launch_band_vec<1, 2, 32, PRE>(a, dg, s);
    case 2: return launch_band_vec<1, 1, 64, PRE>(a, dg, s);
    case 3: return launch_band_vec<4, 1, 32, PRE>(a, dg, s);
    case 4: return launch_band_vec<8, 1, 32, PRE>(a, dg, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tile (0: 2 x 32 pixels, 1: 1 x 32, 2: 1 x 16, 3: 4 x 16, 4: 8 x 16)
// and the dy split of a bf16 launch, set from tools/tune_band.py's table of
// every plan at the train step's, the 448x1024 pair's and the S = 2
// shards' levels (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). A tall
// tile blends fewer warped rows per output row (R + 2d for R rows), so it
// wins wherever it still puts enough blocks on the card: 8 x 16 where that
// makes FILL / 2 blocks, then 4 x 16 where that makes FILL / 3; below that
// all the dy values go over 2d + 1 blocks (at one row a block, a split
// blends no row twice), of 2 x 32 pixels where W >= 64, else 1 x 16.
// Returns the number of dy groups; the tile in *tile.
int pick_wc_band(int n, int h, int w, int d, int* tile) {
  const long long cols = static_cast<long long>(n) * cdiv(w, 16);
  if (cols * cdiv(h, 8) >= band::FILL / 2) return *tile = 4, 1;
  if (cols * cdiv(h, 4) >= band::FILL / 3) return *tile = 3, 1;
  *tile = w >= 64 ? 0 : 2;
  return 2 * d + 1;
}

template <bool PRE>
int run(const void* f1, const void* f2, const void* flow, void* out, int n,
        int h, int w, int c, int d, int te, int row0, int h_global, int halo,
        int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  if (is_bf16) {
    const WarpArgs a{static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
                     fl, static_cast<bf16*>(out), n, h, w, c, d, te, row0,
                     h_global, halo};
    int tile;
    const int dg = pick_wc_band(n, h, w, d, &tile);
    return static_cast<int>(dispatch_band<PRE>(a, tile, dg, s));
  }
  return static_cast<int>(dispatch<float, PRE>(f1, f2, fl, out, n, h, w, c,
                                               d, te, row0, h_global, halo,
                                               s));
}

}  // namespace

// K6. f1, f2: (n, h, w, c), bf16 when is_bf16, else f32; flow: (n, h, w, 2)
// f32; out: (n, h, w, (2d+1)^2) in the features' type; all contiguous.
// 1 <= d <= 4. Returns the CUDA error.
extern "C" int pwc_warp_corr_fwd(const void* f1, const void* f2,
                                 const void* flow, void* out, int n, int h,
                                 int w, int c, int d, int is_bf16,
                                 void* stream) {
  return run<false>(f1, f2, flow, out, n, h, w, c, d, h, 0, h, 0, is_bf16,
                    stream);
}

// K6p. f1: (n, t, w, c); f2e: (n, te, w, c) with te = t + 2 halo, global
// rows [row0 - halo, row0 + t + halo); flow: (n, t + 2d, w, 2) f32, rows
// [row0 - d, row0 + t + d); out: (n, t, w, (2d+1)^2). The image has h_global
// rows. As pwc_warp_corr_fwd otherwise.
extern "C" int pwc_warp_corr_fwd_prepadded(const void* f1, const void* f2e,
                                           const void* flow, void* out, int n,
                                           int t, int w, int c, int d, int te,
                                           int row0, int h_global, int halo,
                                           int is_bf16, void* stream) {
  return run<true>(f1, f2e, flow, out, n, t, w, c, d, te, row0, h_global,
                   halo, is_bf16, stream);
}

// The bf16 K6's launch for a shape: the tile (0: 2 x 32 pixels, 1: 1 x 32,
// 2: 1 x 16, 3: 4 x 16, 4: 8 x 16) in *tile, the number of dy groups
// returned.
extern "C" int pwc_warp_corr_band_plan(int n, int h, int w, int d,
                                       int* tile) {
  return pick_wc_band(n, h, w, d, tile);
}

// The bf16 K6 with the tile and the number of dy groups given, for tuning
// the plan (tools/tune_band.py). As pwc_warp_corr_fwd otherwise.
extern "C" int pwc_warp_corr_fwd_tiled(const void* f1, const void* f2,
                                       const void* flow, void* out, int n,
                                       int h, int w, int c, int d, int tile,
                                       int dg, void* stream) {
  const WarpArgs a{static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
                   static_cast<const float*>(flow), static_cast<bf16*>(out),
                   n, h, w, c, d, h, 0, h, 0};
  return static_cast<int>(
      dispatch_band<false>(a, tile, dg, static_cast<cudaStream_t>(stream)));
}
