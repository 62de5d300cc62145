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
// Like K1 (csrc/cost_volume.cu), it multiplies on the CUDA cores in f32.
//
// Design: K1's tiling, with only the staging of the f2 tile changed. One
// block per (n, TH rows, TW columns) of output; one thread per (pixel, dy)
// keeps the 2d+1 sums of its dx row in registers. Before the channel loop,
// the block computes, for each pixel of the tile and its d-pixel halo, the
// four corner offsets (or -1 for a corner that contributes nothing) and the
// four weights, into shared memory. Each C chunk then gathers the corners
// (NHWC: each corner is a contiguous C-vector), blends them in f32, rounds to
// the input type as the composed path does, and stores the warped tile
// channel-major in shared memory.
//
// Exactness. The coverage mask is a threshold: a cov rounded otherwise than
// eager PyTorch's separate kernels round it can flip a pixel in or out, and
// all 81 of its outputs with it. So the coordinates, weights, cov and the
// blend use __fadd_rn / __fsub_rn / __fmul_rn (never contracted into FMAs),
// in the order of warp.py: w00 = (1 - wy)(1 - wx), ..., cov = ((w00 m00 +
// w01 m01) + w10 m10) + w11 m11, blend = ((w00 g00 + w01 g01) + w10 g10) +
// w11 g11. Corner indices are clamped before any load.
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

namespace {

constexpr int TW = 32;  // output columns per block (one warp)
constexpr int TH = 2;   // output rows per block
constexpr int CC = 16;  // channels staged per chunk

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// H: output rows (the shard's t under PRE). te: f2 rows (H, or t + 2 halo).
// row0, h_global, halo: the shard's place in the image (PRE only).
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
  // The flow of warped row y is row y (K6) or y + D (K6p) of flow_rows.
  const int flow_rows = PRE ? H + 2 * D : H;
  const size_t flow_img = static_cast<size_t>(n) * flow_rows * W;

  // Corners and weights of every warped pixel of the tile (warp.py's math;
  // under PRE, _warp_ext_corners').
  const float wmax = static_cast<float>(W - 1);
  const float hmax = static_cast<float>((PRE ? h_global : H) - 1);
  for (int p = tid; p < NP; p += nthr) {
    const int y = y0 + p / HC - D, x = x0 + p % HC - D;
    const int fr = PRE ? y + D : y;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (fr >= 0 && fr < flow_rows && x >= 0 && x < W) {
      const float* fl =
          flow + (flow_img + static_cast<size_t>(fr) * W + x) * 2;
      const float xs = __fadd_rn(static_cast<float>(x), fl[0]);
      const float ys =
          __fadd_rn(static_cast<float>(PRE ? y + row0 : y), fl[1]);
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
          const int xc = static_cast<int>(
              fminf(fmaxf(xb, 0.f), static_cast<float>(W)));
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
            const int xi =
                static_cast<int>(fminf(fmaxf(cx[a & 1], 0.f), wmax));
            const int yi =
                static_cast<int>(fminf(fmaxf(cy[a >> 1], 0.f), hmax));
            if (inb[a]) idx[a] = yi * W + xi;
          }
        }
      }
    }
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

template <bool PRE>
int run(const void* f1, const void* f2, const void* flow, void* out, int n,
        int h, int w, int c, int d, int te, int row0, int h_global, int halo,
        int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16, PRE>(f1, f2, fl, out, n, h, w, c, d,
                                             te, row0, h_global, halo, s)
              : dispatch<float, PRE>(f1, f2, fl, out, n, h, w, c, d, te,
                                     row0, h_global, halo, s);
  return static_cast<int>(e);
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
