// Fused PWC-Net stem (pyramid levels 1-2), written by hand for Hopper.
//
// Replaces: pwcnet_tpu/ops/pallas/stem_kernel.py, _stem_kernel (launched by
// _stem_impl; entry stem_pallas). Plain version: stem_ref beside the wrapper.
//
// Four 3x3 convs, each + bias + LeakyReLU 0.1, with XLA "SAME" padding:
//   conv1 3 -> 16 stride 2, conv2 16 -> 16, conv3 16 -> 32 stride 2,
//   conv4 32 -> 32.
// (N, H, W, 3) image -> (N, H/4, W/4, 32) level-2 features, NHWC. Level-1
// features never reach device memory, which is the point of the kernel.
//
// Bound on an H100 SXM: 1.42 GMAC (2.84 GFLOP) and about 6 MB of image in and
// features out for a bf16 448x1024 pair, i.e. about 3 us on bf16 tensor
// cores and 2 us of memory traffic. This first version multiplies on the
// CUDA cores in f32 and recomputes the halo of every tile, so it sits far
// above that bound (the measured time is in PERF.md); tensor cores are later
// work.
//
// Design: one block per level-2 output tile of TH2 x TW2 pixels. With SAME
// padding (stride 2 on even sizes pads 0 before and 1 after), output rows
// [r0, r0 + T) need level-2a rows [r0 - 1, r0 + T + 1), level-1b rows
// [2r0 - 2, 2r0 + 2T + 3), level-1a rows [2r0 - 3, 2r0 + 2T + 4) and image
// rows [4r0 - 6, 4r0 + 4T + 9); columns likewise. The image tile is staged
// in shared memory (zero outside the image), and the four convs run from one
// shared buffer into the other, channel-major so that neighbouring threads
// read neighbouring columns. Intermediate positions outside the valid
// level-1 or level-2 extent are set to zero after the activation: XLA pads
// the *features* with zeros, and a conv over zero input would give
// lrelu(bias) there instead. Sums are f32; every layer's output is rounded
// to the working type, as the plain chain of convs rounds it. Weights come in
// as f32 (already rounded to the working type), HWIO.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH2 = 8;   // level-2 output rows per block
constexpr int TW2 = 16;  // level-2 output columns per block
constexpr int CIN = 3, C1 = 16, C2 = 32;
constexpr int G = 16;    // output channels per thread
constexpr int THREADS = 256;

constexpr int IMG_R = 4 * TH2 + 15, IMG_C = 4 * TW2 + 15;  // image tile
constexpr int L1A_R = 2 * TH2 + 7, L1A_C = 2 * TW2 + 7;    // conv1 out
constexpr int L1B_R = 2 * TH2 + 5, L1B_C = 2 * TW2 + 5;    // conv2 out
constexpr int L2A_R = TH2 + 2, L2A_C = TW2 + 2;            // conv3 out
constexpr int OUT_LD = C2 + 1;  // staging stride, odd: no bank conflicts

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// Buffer X: image, then conv2's output, then conv4's output staging.
constexpr int BUF_X = cmax(cmax(CIN * IMG_R * IMG_C, C1 * L1B_R * L1B_C),
                           TH2 * TW2 * OUT_LD);
// Buffer Y: conv1's output, then conv3's output.
constexpr int BUF_Y = cmax(C1 * L1A_R * L1A_C, C2 * L2A_R * L2A_C);
constexpr size_t SMEM_BYTES = (BUF_X + BUF_Y) * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 3x3 conv + bias + LeakyReLU between shared buffers. The input is
// channel-major [CI][in_r][in_c]; output (r, c) reads input (S*r + ky,
// S*c + kx). Output channel co of pixel (r, c) goes to
// out[co * os_c + r * os_r + c * os_x]. Pixels whose absolute position
// (abs_r0 + r, abs_c0 + c) lies outside [0, valid_r) x [0, valid_c) are 0.
template <typename T, int CI, int CO, int S>
__device__ void conv_layer(const float* in, int in_r, int in_c, float* out,
                           int out_r, int out_c, int os_c, int os_r, int os_x,
                           const float* __restrict__ w,
                           const float* __restrict__ b, int abs_r0,
                           int abs_c0, int valid_r, int valid_c) {
  static_assert(CO % G == 0, "CO must be a multiple of G");
  const int npix = out_r * out_c;
  const int items = npix * (CO / G);
  const int plane = in_r * in_c;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it / npix, p = it % npix;
    const int r = p / out_c, c = p % out_c;
    float acc[G];
#pragma unroll
    for (int k = 0; k < G; ++k) acc[k] = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const float* src = in + (S * r + ky) * in_c + (S * c + kx);
        // 16-byte weight loads: CO and g * G are multiples of 4.
        const float4* wk = reinterpret_cast<const float4*>(
            w + (ky * 3 + kx) * CI * CO + g * G);
#pragma unroll 4
        for (int ci = 0; ci < CI; ++ci) {
          const float v = src[ci * plane];
#pragma unroll
          for (int q = 0; q < G / 4; ++q) {
            const float4 wq = __ldg(wk + ci * (CO / 4) + q);
            acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
          }
        }
      }
    }
    const int ar = abs_r0 + r, ac = abs_c0 + c;
    const bool ok = ar >= 0 && ar < valid_r && ac >= 0 && ac < valid_c;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int co = g * G + k;
      float v = acc[k] + __ldg(b + co);
      v = v >= 0.f ? v : 0.1f * v;
      out[co * os_c + r * os_r + c * os_x] = ok ? round_to<T>(v) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_fwd(const T* __restrict__ im, const float* __restrict__ w1,
         const float* __restrict__ b1, const float* __restrict__ w2,
         const float* __restrict__ b2, const float* __restrict__ w3,
         const float* __restrict__ b3, const float* __restrict__ w4,
         const float* __restrict__ b4, T* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  float* bx = smem;
  float* by = smem + BUF_X;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * TH2, c0 = blockIdx.x * TW2;
  const int H1 = H / 2, W1 = W / 2, H2 = H / 4, W2 = W / 4;

  // Image rows [4r0 - 6, +IMG_R), columns [4c0 - 6, +IMG_C), zero outside.
  const T* imn = im + static_cast<size_t>(n) * H * W * CIN;
  for (int e = threadIdx.x; e < IMG_R * IMG_C * CIN; e += blockDim.x) {
    const int ci = e % CIN, p = e / CIN;
    const int col = p % IMG_C, row = p / IMG_C;
    const int y = 4 * r0 - 6 + row, x = 4 * c0 - 6 + col;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = to_f32(imn[(static_cast<size_t>(y) * W + x) * CIN + ci]);
    bx[(ci * IMG_R + row) * IMG_C + col] = v;
  }
  __syncthreads();
  conv_layer<T, CIN, C1, 2>(bx, IMG_R, IMG_C, by, L1A_R, L1A_C,
                            L1A_R * L1A_C, L1A_C, 1, w1, b1,
                            2 * r0 - 3, 2 * c0 - 3, H1, W1);
  __syncthreads();
  conv_layer<T, C1, C1, 1>(by, L1A_R, L1A_C, bx, L1B_R, L1B_C,
                           L1B_R * L1B_C, L1B_C, 1, w2, b2,
                           2 * r0 - 2, 2 * c0 - 2, H1, W1);
  __syncthreads();
  conv_layer<T, C1, C2, 2>(bx, L1B_R, L1B_C, by, L2A_R, L2A_C,
                           L2A_R * L2A_C, L2A_C, 1, w3, b3,
                           r0 - 1, c0 - 1, H2, W2);
  __syncthreads();
  // conv4 writes pixel-major [r][c][co] staging for coalesced stores.
  conv_layer<T, C2, C2, 1>(by, L2A_R, L2A_C, bx, TH2, TW2,
                           1, TW2 * OUT_LD, OUT_LD, w4, b4,
                           r0, c0, H2, W2);
  __syncthreads();

  // Each tile row is one contiguous run of cols * C2 outputs.
  const int rows = min(TH2, H2 - r0), cols = min(TW2, W2 - c0);
  T* outn = out + static_cast<size_t>(n) * H2 * W2 * C2;
  for (int e = threadIdx.x; e < rows * cols * C2; e += blockDim.x) {
    const int co = e % C2, p = e / C2;
    const int c = p % cols, r = p / cols;
    store(outn + (static_cast<size_t>(r0 + r) * W2 + c0 + c) * C2 + co,
          bx[(r * TW2 + c) * OUT_LD + co]);
  }
}

template <typename T>
cudaError_t launch(const void* im, const float* const* wb, void* out, int n,
                   int h, int w, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      stem_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((w / 4 + TW2 - 1) / TW2, (h / 4 + TH2 - 1) / TH2, n);
  stem_fwd<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(im), wb[0], wb[1], wb[2], wb[3], wb[4], wb[5],
      wb[6], wb[7], static_cast<T*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace

// im: (n, h, w, 3), out: (n, h/4, w/4, 32), contiguous, bf16 when is_bf16
// else f32; h, w divisible by 4. w1..w4: f32 HWIO (3, 3, ci, co) with
// ci, co = 3, 16 / 16, 16 / 16, 32 / 32, 32; b1..b4: f32. Returns the CUDA
// error.
extern "C" int pwc_stem_fwd(const void* im, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, const void* w4, const void* b4,
                            void* out, int n, int h, int w, int is_bf16,
                            void* stream) {
  const float* wb[8] = {
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(w4), static_cast<const float*>(b4)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(im, wb, out, n, h, w, s)
                          : launch<float>(im, wb, out, n, h, w, s);
  return static_cast<int>(e);
}
