// Small-channel 3x3 convolution + bias (+ LeakyReLU) (K7), written by hand
// for Hopper.
//
// Replaces: pwcnet_tpu/ops/pallas/conv_kernel.py, _kernel_folded (launched by
// _conv_folded_impl; entry conv2d_folded).
//
//   out[n, y, x, co] = act(b[co] + sum_{ky, kx, ci} x[n, s*y - pt + ky,
//                                                   s*x - pl + kx, ci]
//                                           * w[ky, kx, ci, co])
//
// with XLA "SAME" padding (pt, pl from the wrapper: 1 for stride 1, 0 for
// stride 2 on an even size), zeros outside the image, act = LeakyReLU(slope)
// or the identity. As in the Pallas kernel, the weights arrive rounded to the
// input type, the bias in f32, and the sum, bias and activation are f32,
// rounded once to the input type.
//
// The Pallas kernel folds G image columns into the 128 lanes, (N, H, W, C)
// -> (N, H, W/G, G*C), because a TPU lays C along the lanes and pads a small
// C to 128. On a contiguous NHWC tensor that folded layout is a view, and a
// GPU has no lanes to fill: this kernel is a direct convolution on NHWC and
// the wrapper returns the folded view.
//
// Bound on an H100 SXM: 2 * 9 * Ci flops per output value, at most 576 at
// Ci = 32, against (Ci / s^2 + Co) input and output values per pixel: about
// 10 flops a byte in bf16, far below the tensor cores' 295, so the bytes over
// 3.35 TB/s bound it. Design, bf16: the implicit GEMM of conv3x3_mma.cuh on
// the tensor cores (mma.sync m16n8k16, f32 sums): a block stages its input
// tile of 8 (stride 1) or 4 (stride 2) output rows x 64 columns once with
// 16-byte copies, every output channel of the tile comes from that one copy
// (up to 32 per block), and the outputs leave in 16-byte stores. The tile
// stages at most 64 input channels; above that a bf16 conv, like every f32
// one (held to 1e-5, so no TF32), runs on the CUDA cores: one thread per
// output pixel and group of COT output channels, sums in registers, every
// weight read from shared memory a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_mma.cuh"

namespace {

constexpr int THREADS = 128;  // CUDA cores: output columns per block
constexpr int COT = 16;       // CUDA cores: output channels per thread
constexpr int MAX_W = 12288;  // 9 * ci * co: f32 weights in shared memory
constexpr int TILE_CI = 64;   // input channels the bf16 tile stages

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const c3::bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(c3::bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_cc(const T* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, T* __restrict__ out, int H, int W,
           int CI, int HO, int WO, int CO, int stride, int pt, int pl,
           float slope, int has_slope) {
  extern __shared__ float ws[];  // [ky][kx][ci][co], as w
  const int nw = 9 * CI * CO;
  for (int i = threadIdx.x; i < nw; i += THREADS) ws[i] = w[i];
  __syncthreads();

  // blockIdx.x walks the column blocks of each output row, row-major over
  // (n, oy); blockIdx.y is the channel group.
  const int xblocks = (WO + THREADS - 1) / THREADS;
  const int row = blockIdx.x / xblocks;
  const int ox = (blockIdx.x % xblocks) * THREADS + threadIdx.x;
  const int oy = row % HO;
  const int n = row / HO;
  const int co0 = blockIdx.y * COT;
  if (ox >= WO) return;

  float acc[COT];
#pragma unroll
  for (int k = 0; k < COT; ++k) acc[k] = 0.f;
  const int ncot = min(COT, CO - co0);
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = oy * stride - pt + ky;
    if (iy < 0 || iy >= H) continue;
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = ox * stride - pl + kx;
      if (ix < 0 || ix >= W) continue;
      const T* px = x + ((static_cast<size_t>(n) * H + iy) * W + ix) * CI;
      const float* wk = ws + (ky * 3 + kx) * CI * CO + co0;
      for (int ci = 0; ci < CI; ++ci) {
        const float v = load_f32(px + ci);
        const float* wr = wk + ci * CO;
#pragma unroll
        for (int k = 0; k < COT; ++k)  // unrolled: acc stays in registers
          if (k < ncot) acc[k] = fmaf(v, wr[k], acc[k]);
      }
    }
  }
  T* dst = out + ((static_cast<size_t>(n) * HO + oy) * WO + ox) * CO + co0;
#pragma unroll
  for (int k = 0; k < COT; ++k) {
    if (k >= ncot) break;
    float v = acc[k] + b[co0 + k];
    if (has_slope && v < 0.f) v *= slope;
    store(dst + k, v);
  }
}

template <typename T>
cudaError_t launch_cc(const T* x, const float* w, const float* b, T* out,
                      int n, int h, int wd, int ci, int ho, int wo, int co,
                      int stride, int pt, int pl, float slope, int has_slope,
                      cudaStream_t s) {
  const long long blocks =
      static_cast<long long>((wo + THREADS - 1) / THREADS) * n * ho;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), (co + COT - 1) / COT);
  const size_t smem = static_cast<size_t>(9) * ci * co * sizeof(float);
  conv3x3_cc<T><<<grid, THREADS, smem, s>>>(x, w, b, out, h, wd, ci, ho, wo,
                                            co, stride, pt, pl, slope,
                                            has_slope);
  return cudaGetLastError();
}

// Stride 1: 8 output rows per block; stride 2: 4 (a quarter of the input
// rows per output row). 16 or 32 output channels per block.
template <int S, bool TAPS>
cudaError_t launch_bf16(const c3::bf16* x, const float* w, const c3::Conv& cv,
                        c3::bf16* out, const c3::BiasAct& epi,
                        cudaStream_t s) {
  constexpr int R = S == 1 ? 8 : 4;
  const c3::WView wv = c3::hwio(cv.ci, cv.co);
  return cv.co <= 16
             ? c3::launch_conv<S, R, 2, TAPS>(x, w, wv, cv, out, epi, s)
             : c3::launch_conv<S, R, 4, TAPS>(x, w, wv, cv, out, epi, s);
}

}  // namespace

// x: (n, h, w, ci) contiguous, bf16 when is_bf16 (then 16-byte aligned),
// else f32; w: (3, 3, ci, co) f32 holding values rounded to x's type; b:
// (co,) f32; out: (n, ho, wo, co) in x's type. pt, pl: the SAME padding
// before (rows, columns). slope is used when has_slope. Needs 9 * ci * co <=
// 12288. Returns the CUDA error.
extern "C" int pwc_conv_folded_fwd(const void* x, const void* w,
                                   const void* b, void* out, int n, int h,
                                   int wd, int ci, int ho, int wo, int co,
                                   int stride, int pt, int pl, float slope,
                                   int has_slope, int is_bf16, void* stream) {
  if (9 * ci * co > MAX_W || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (!is_bf16)
    return static_cast<int>(launch_cc(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(out), n, h,
        wd, ci, ho, wo, co, stride, pt, pl, slope, has_slope, s));
  const auto* xb = static_cast<const c3::bf16*>(x);
  auto* ob = static_cast<c3::bf16*>(out);
  if (ci > TILE_CI)
    return static_cast<int>(launch_cc(xb, wf, bf, ob, n, h, wd, ci, ho, wo,
                                      co, stride, pt, pl, slope, has_slope,
                                      s));
  const c3::Conv cv{n, h, wd, ci, ho, wo, co, pt, pl};
  const c3::BiasAct epi{bf, slope, has_slope};
  const bool taps = ci % 16 == 0;
  cudaError_t e;
  if (stride == 1)
    e = taps ? launch_bf16<1, true>(xb, wf, cv, ob, epi, s)
             : launch_bf16<1, false>(xb, wf, cv, ob, epi, s);
  else
    e = taps ? launch_bf16<2, true>(xb, wf, cv, ob, epi, s)
             : launch_bf16<2, false>(xb, wf, cv, ob, epi, s);
  return static_cast<int>(e);
}
