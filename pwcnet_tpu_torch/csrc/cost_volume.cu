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
// [0, W) read zeros. One kernel serves both: f2 row y of the output frame is
// row y + f2_off of an f2 array of f2_rows rows (K1: off 0, H rows; K1p:
// off d, H + 2d rows).
//
// Layout: f1, f2 and out are NHWC and contiguous, so each tap is a dot product
// over the contiguous C. Inputs are converted to f32 as they are staged, the
// products and the sum are f32 (as in cost_volume_lax, which upcasts first),
// and the mean is rounded once to the input type.
//
// Bound on an H100 SXM: every pixel reads 2C inputs and writes 81 outputs,
// (2C + 81) * 2 bytes in bf16, and does 162 * C flops. That is 18 to 34 flops
// a byte at C = 32..196, far below the 295 at which bf16 tensor cores would
// bound it, so the least time is the bytes over 3.35 TB/s (about 2.5 us at
// the finest level of a 448x1024 pair). This kernel multiplies on the CUDA
// cores in f32, whose balance point (67 TFLOP/s over 3.35 TB/s = 20 flops a
// byte) the larger C pass, so it is FMA-bound at the coarse levels.
//
// Design: one block per (n, TH rows, TW columns) of output. The block stages
// C in chunks of CC channels: the f1 tile and the f2 tile with a d-pixel halo,
// both channel-major in shared memory, zero-filled outside the image (that is
// the zero padding). One thread per (pixel, dy) keeps the 2d+1 sums of its
// dx row in registers; neighbouring threads read neighbouring columns, free
// of bank conflicts. The 81 results of each pixel are staged in shared memory
// and written out as contiguous rows, so the stores coalesce.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two blocks per SM: at d = 4 (576 threads) that caps the kernel at 56
// registers. Without the cap the two extra arguments of the K1p entry took
// it to 74-78 registers, one block per SM, and K1 ran up to 45% slower at the
// large levels (tools/ab_kernels.py on the H100; PERF.md, section 6).
template <typename T, int D>
__global__ void __launch_bounds__(TW * TH * (2 * D + 1), 2)
corr_fwd(const T* __restrict__ f1, const T* __restrict__ f2,
         T* __restrict__ out, int H, int W, int C, int f2_rows, int f2_off) {
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
        v = load_f32(f1 + (img + static_cast<size_t>(y) * W + x) * C + cc);
      f1s[(c * TH + row) * TW + col] = v;
    }
    for (int e = tid; e < F2N; e += nthr) {
      const int c = e % CC, p = e / CC, col = p % HC, row = p / HC;
      const int y = y0 + row - D + f2_off, x = x0 + col - D, cc = c0 + c;
      float v = 0.f;
      if (y >= 0 && y < f2_rows && x >= 0 && x < W && cc < C)
        v = load_f32(f2 + (img2 + static_cast<size_t>(y) * W + x) * C + cc);
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
    T* dst = out + (img + static_cast<size_t>(y) * W + x0) * K;
    const float* src = f2s + row * TW * K;
    for (int e = tid; e < cols * K; e += nthr) store(dst + e, src[e]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* f1, const void* f2, void* out, int n, int h,
                   int w, int c, int pre, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  const dim3 block(TW, TH * (2 * D + 1));
  corr_fwd<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), h, w, c, pre ? h + 2 * D : h, pre ? D : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, void* out, int n, int h,
                     int w, int c, int d, int pre, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(f1, f2, out, n, h, w, c, pre, s);
    case 2: return launch<T, 2>(f1, f2, out, n, h, w, c, pre, s);
    case 3: return launch<T, 3>(f1, f2, out, n, h, w, c, pre, s);
    case 4: return launch<T, 4>(f1, f2, out, n, h, w, c, pre, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* f1, const void* f2, void* out, int n, int h, int w,
        int c, int d, int pre, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, out, n, h, w, c, d, pre, s)
              : dispatch<float>(f1, f2, out, n, h, w, c, d, pre, s);
  return static_cast<int>(e);
}

}  // namespace

// K1. f1, f2: (n, h, w, c); out: (n, h, w, (2d+1)^2); all contiguous, of one
// type: bf16 when is_bf16, else f32. 1 <= d <= 4. Returns the CUDA error.
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
