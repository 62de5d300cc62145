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

template <typename T, int D>
__global__ void __launch_bounds__(TW * TH * (2 * D + 1))
warp_corr_fwd(const T* __restrict__ f1, const T* __restrict__ f2,
              const float* __restrict__ flow, T* __restrict__ out, int H,
              int W, int C) {
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

  // Corners and weights of every warped pixel of the tile (warp.py's math).
  const float wmax = static_cast<float>(W - 1);
  const float hmax = static_cast<float>(H - 1);
  for (int p = tid; p < NP; p += nthr) {
    const int y = y0 + p / HC - D, x = x0 + p % HC - D;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float* fl = flow + (img + static_cast<size_t>(y) * W + x) * 2;
      const float xs = __fadd_rn(static_cast<float>(x), fl[0]);
      const float ys = __fadd_rn(static_cast<float>(y), fl[1]);
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

  const T* f2n = f2 + img * C;
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

template <typename T, int D>
cudaError_t launch(const void* f1, const void* f2, const float* flow,
                   void* out, int n, int h, int w, int c,
                   cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  const dim3 block(TW, TH * (2 * D + 1));
  warp_corr_fwd<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), flow,
      static_cast<T*>(out), h, w, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, const float* flow,
                     void* out, int n, int h, int w, int c, int d,
                     cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(f1, f2, flow, out, n, h, w, c, s);
    case 2: return launch<T, 2>(f1, f2, flow, out, n, h, w, c, s);
    case 3: return launch<T, 3>(f1, f2, flow, out, n, h, w, c, s);
    case 4: return launch<T, 4>(f1, f2, flow, out, n, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// f1, f2: (n, h, w, c), bf16 when is_bf16, else f32; flow: (n, h, w, 2) f32;
// out: (n, h, w, (2d+1)^2) in the features' type; all contiguous.
// 1 <= d <= 4. Returns the CUDA error.
extern "C" int pwc_warp_corr_fwd(const void* f1, const void* f2,
                                 const void* flow, void* out, int n, int h,
                                 int w, int c, int d, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, fl, out, n, h, w, c, d, s)
              : dispatch<float>(f1, f2, fl, out, n, h, w, c, d, s);
  return static_cast<int>(e);
}
