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
// Precision: as the JAX backward (CORR_BWD_COMPUTE_DTYPE = "f32"), every
// input is converted to f32 as it is staged, products and sums are f32, and
// the result is rounded once to the input type.
//
// Bound on an H100 SXM: each pixel reads 81 + 2C inputs and writes C outputs
// and does 162 * C flops, i.e. below 20 flops a byte, so the least time is
// the bytes over 3.35 TB/s. This first version multiplies on the CUDA cores
// in f32 and re-reads the halo of every tile, so it sits well above that
// bound (the measured time is in PERF.md).
//
// Design: one block per (n, 32-channel chunk, TH x TW pixel tile), 32 x TH
// threads: lane = channel in the chunk, warp = tile row. The block stages
// the f2 (K2) or f1 (K3) tile with a d-pixel halo, pixel-major with the 32
// channels contiguous (coalesced loads, conflict-free reads), zero outside
// the image. It then walks dy: for each dy it stages the 2d+1 taps of g that
// this row of displacements needs (broadcast reads), loads the halo row of
// features into registers and updates the TW sums of its row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 16;  // tile columns
constexpr int TH = 8;   // tile rows = warps per block
constexpr int CC = 32;  // channels per block = lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// F3 = false: K2 (feat = f2). F3 = true: K3 (feat = f1).
template <typename T, int D, bool F3>
__global__ void __launch_bounds__(CC * TH)
corr_bwd(const T* __restrict__ g, const T* __restrict__ feat,
         T* __restrict__ out, int H, int W, int C) {
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
      v = to_f32(feat[(img + static_cast<size_t>(y) * W + x) * C + cc]);
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
        v = to_f32(g[(img + static_cast<size_t>(y) * W + x) * K + dy * S +
                     dx]);
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
      store(out + (img + static_cast<size_t>(y) * W + x) * C + cc,
            acc[tx] * inv_c);
  }
}

template <int D, bool F3>
constexpr size_t smem_bytes() {
  return ((TH + 2 * D) * (TW + 2 * D) * CC +
          TH * (F3 ? TW + 2 * D : TW) * (2 * D + 1)) * sizeof(float);
}

template <typename T, int D, bool F3>
cudaError_t launch(const void* g, const void* feat, void* out, int n, int h,
                   int w, int c, cudaStream_t stream) {
  // Above 48 KB (d = 4) only as opted-in dynamic shared memory.
  constexpr size_t bytes = smem_bytes<D, F3>();
  cudaError_t e = cudaFuncSetAttribute(
      corr_bwd<T, D, F3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH,
                  n * ((c + CC - 1) / CC));
  const dim3 block(CC, TH);
  corr_bwd<T, D, F3><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(feat),
      static_cast<T*>(out), h, w, c);
  return cudaGetLastError();
}

template <typename T, bool F3>
cudaError_t dispatch(const void* g, const void* feat, void* out, int n, int h,
                     int w, int c, int d, cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1, F3>(g, feat, out, n, h, w, c, s);
    case 2: return launch<T, 2, F3>(g, feat, out, n, h, w, c, s);
    case 3: return launch<T, 3, F3>(g, feat, out, n, h, w, c, s);
    case 4: return launch<T, 4, F3>(g, feat, out, n, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
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
  if (which == 1)
    e = is_bf16 ? dispatch<__nv_bfloat16, false>(g, feat, out, n, h, w, c, d, s)
                : dispatch<float, false>(g, feat, out, n, h, w, c, d, s);
  else if (which == 2)
    e = is_bf16 ? dispatch<__nv_bfloat16, true>(g, feat, out, n, h, w, c, d, s)
                : dispatch<float, true>(g, feat, out, n, h, w, c, d, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
