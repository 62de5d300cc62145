// Fused PWC-Net stem (pyramid levels 1-2), forward and backward, written by
// hand for Hopper.
//
// Forward (K4) replaces: pwcnet_tpu/ops/pallas/stem_kernel.py, _stem_kernel
// (launched by _stem_impl; entry stem_pallas). The backward (K5) follows it
// below. Plain version: stem_ref beside the wrappers.
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

#include "conv3x3_mma.cuh"

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

// ---------------------------------------------------------------------------
// Backward (K5). Replaces pwcnet_tpu/ops/pallas/stem_kernel.py,
// _stem_bwd_kernel (launched by _stem_backward_pallas; the VJP of
// stem_pallas). A recompute backward: the residuals are only the image and
// the weights. With m = LeakyReLU' (1 where the activation is > 0, else
// 0.1, as torch's leaky_relu backward takes it) and y_l the output of conv l:
//   p4 = g * m(z4), p3 = conv4^T(p4) * m(y3), p2 = conv3^T(p3) * m(y2),
//   p1 = conv2^T(p2) * m(y1), d_im = conv1^T(p1),
//   dW_l = sum over pixels of (input patch of conv l) x p_l, db_l = sum p_l.
//
// bf16, the train step's form: layer by layer on the tensor cores, every
// intermediate in device memory in bf16 (y_l are bf16 in the forward
// already, so storing them is exact; p_l is rounded to bf16 before it
// enters a product, as the plain version's bf16 autograd rounds it; sums
// are f32). 13 kernels (14 with d_im), launch_bwd_bf16 below:
//   1. the weights, OIHW -> HWIO, rounded to bf16 (pack_params);
//   2-5. conv1..conv4 of conv3x3_mma.cuh, writing y1, y2, y3, and for conv4
//        p4 straight from its sums (y4 is never needed);
//   6, 8. p3, p1: the stride-1 input gradients are 3x3 convs of p with the
//        weights flipped and transposed, the same tile with an epilogue that
//        multiplies by m(y);
//   7. p2: conv3's stride-2 input gradient, split by output parity
//        (conv3x3_t2); 14: d_im, the same for conv1;
//   9-12. dW_l, db_l: per layer a GEMM (M = Ci per tap, N = Co, K =
//        pixels) over a fixed split of the pixels (wg_blocks(l) blocks,
//        each summing its tiles in order into one row of partials);
//   13. the fixed-order reduction of the rows, which writes the gradients
//        in OIHW rounded to bf16. No atomics, so the gradients are the same
//        from run to run.
// Bound: every layer's activations and gradients cross device memory about
// three times (about 0.45 GB at 16 x 384x448), which bounds it; the
// products (3 x the forward's, on the tensor cores) do not.
//
// f32 (a correctness path, held to 1e-4 against the plain version): one
// fused kernel. One block per level-2 tile of BH2 x BW2 pixels recomputes the
// forward over the tile's halo regions (the same conv_layer calls as
// stem_fwd, so the same rounded values and the same masks), then walks the
// chain back with the incoming gradient restricted to its own tile:
//   p4 = g * lrelu'(z4)                 on the tile
//   G3 = conv4^T(p4), p3 = G3 * m3      on the tile's level-2 halo region
//   G2 = conv3^T(p3), p2 = G2 * m2      on its level-1 region
//   G1 = conv2^T(p2), p1 = G1 * m1      on its level-1 halo region
//   d_im = conv1^T(p1)                  on its image region
// with m times the forward's valid-extent mask. The chain is linear in g,
// so summing the tiles' contributions gives the exact gradient: that is the
// JAX kernel's overlap-add. Each tile writes its dW/db sums (f32, HWIO) to
// its own row of a partials buffer and its d_im region to its own block;
// two more kernels reduce the partials over the tiles and overlap-add the
// d_im blocks, each in a fixed order (no atomics). The recompute of the halo
// regions and the f32 CUDA-core FMAs put it far above the bound.
// ---------------------------------------------------------------------------

constexpr int BH2 = 4, BW2 = 16;  // level-2 tile of the backward
constexpr int BTHREADS = 512;
constexpr int B_IMG_R = 4 * BH2 + 15, B_IMG_C = 4 * BW2 + 15;
constexpr int B_L1A_R = 2 * BH2 + 7, B_L1A_C = 2 * BW2 + 7;
constexpr int B_L1B_R = 2 * BH2 + 5, B_L1B_C = 2 * BW2 + 5;
constexpr int B_L2A_R = BH2 + 2, B_L2A_C = BW2 + 2;
constexpr int B_IMG_N = B_IMG_R * B_IMG_C;  // image region pixels
// Activations, channel-major: image, conv1..conv3 outputs.
constexpr int S_IMG = CIN * B_IMG_N;
constexpr int S_Y1 = C1 * B_L1A_R * B_L1A_C;
constexpr int S_Y2 = C1 * B_L1B_R * B_L1B_C;
constexpr int S_Y3 = C2 * B_L2A_R * B_L2A_C;
// Gradients p_l, pixel-major with an odd stride C + 1 (conflict-free both
// when lanes run over channels and when they run over pixels).
constexpr int S_P4 = BH2 * BW2 * (C2 + 1);
constexpr int S_P3 = B_L2A_R * B_L2A_C * (C2 + 1);
constexpr int S_P2 = B_L1B_R * B_L1B_C * (C1 + 1);
constexpr int S_P1 = B_L1A_R * B_L1A_C * (C1 + 1);
constexpr size_t BWD_SMEM_BYTES =
    (S_IMG + S_Y1 + S_Y2 + S_Y3 + S_P4 + S_P3 + S_P2 + S_P1) * sizeof(float);
static_assert(BWD_SMEM_BYTES <= 232448, "backward tile must fit 227 KB");

// Offsets of the dW (HWIO) and db sums in a row of partials.
constexpr int OFF_W1 = 0, OFF_B1 = OFF_W1 + 9 * CIN * C1;
constexpr int OFF_W2 = OFF_B1 + C1, OFF_B2 = OFF_W2 + 9 * C1 * C1;
constexpr int OFF_W3 = OFF_B2 + C1, OFF_B3 = OFF_W3 + 9 * C1 * C2;
constexpr int OFF_W4 = OFF_B3 + C2, OFF_B4 = OFF_W4 + 9 * C2 * C2;
constexpr int N_GRAD = OFF_B4 + C2;

// dW[k][ci][co] = sum_{(r, c) < (out_r, out_c)} in[ci][S*r + ky][S*c + kx]
// * p[(r, c)][co] and db[co] = sum p[(r, c)][co], into dst (one partials
// row). Lanes run over co: p reads are contiguous, in reads broadcast.
template <int CI, int CO, int S>
__device__ void weight_grads(const float* in, int in_r, int in_c,
                             const float* p, int out_r, int out_c,
                             float* __restrict__ dst_w,
                             float* __restrict__ dst_b) {
  constexpr int NW = 9 * CI * CO;
  const int plane = in_r * in_c;
  const int npix = out_r * out_c;
  for (int e = threadIdx.x; e < NW + CO; e += blockDim.x) {
    const int co = e % CO;
    float acc = 0.f;
    if (e < NW) {
      const int rest = e / CO, ci = rest % CI, k = rest / CI;
      const float* src = in + ci * plane + (k / 3) * in_c + (k % 3);
      for (int r = 0; r < out_r; ++r)
        for (int c = 0; c < out_c; ++c)
          acc = fmaf(src[S * r * in_c + S * c],
                     p[(r * out_c + c) * (CO + 1) + co], acc);
      dst_w[e] = acc;
    } else {
      for (int q = 0; q < npix; ++q) acc += p[q * (CO + 1) + co];
      dst_b[co] = acc;
    }
  }
}

// The transpose of a 3x3 conv (stride S) from p (out_r x out_c pixels, CO
// channels, pixel-major) back onto its input region (in_r x in_c, CI
// channels), times the mask of that region: pnext[(j, k)][ci] =
// m(j, k, ci) * sum over taps with S*r + ky = j, S*c + kx = k of
// p[(r, c)][co] * W[ky][kx][ci][co]. wt is W as [ky][kx][co][ci] (f32).
// m = 0 outside [0, valid_r) x [0, valid_c) (absolute position abs_r0 + j,
// abs_c0 + k), else 1 where y[ci][j][k] > 0 and 0.1 elsewhere.
template <int CI, int CO, int S>
__device__ void grad_input(const float* p, int out_r, int out_c,
                           const float* __restrict__ wt, const float* y,
                           int in_r, int in_c, float* pnext, int abs_r0,
                           int abs_c0, int valid_r, int valid_c) {
  static_assert(CI % G == 0, "CI must be a multiple of G");
  const int npix = in_r * in_c;
  const int items = npix * (CI / G);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it / npix, q = it % npix;
    const int j = q / in_c, k = q % in_c;
    float acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = 0.f;
    for (int ky = 0; ky < 3; ++ky) {
      const int rs = j - ky;
      if (rs < 0 || rs % S) continue;
      const int r = rs / S;
      if (r >= out_r) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int cs = k - kx;
        if (cs < 0 || cs % S) continue;
        const int c = cs / S;
        if (c >= out_c) continue;
        const float* src = p + (r * out_c + c) * (CO + 1);
        const float4* wk = reinterpret_cast<const float4*>(
            wt + (ky * 3 + kx) * CO * CI + g * G);
#pragma unroll 4
        for (int co = 0; co < CO; ++co) {
          const float v = src[co];
#pragma unroll
          for (int qq = 0; qq < G / 4; ++qq) {
            const float4 wq = __ldg(wk + co * (CI / 4) + qq);
            acc[4 * qq + 0] = fmaf(v, wq.x, acc[4 * qq + 0]);
            acc[4 * qq + 1] = fmaf(v, wq.y, acc[4 * qq + 1]);
            acc[4 * qq + 2] = fmaf(v, wq.z, acc[4 * qq + 2]);
            acc[4 * qq + 3] = fmaf(v, wq.w, acc[4 * qq + 3]);
          }
        }
      }
    }
    const int ar = abs_r0 + j, ac = abs_c0 + k;
    const bool ok = ar >= 0 && ar < valid_r && ac >= 0 && ac < valid_c;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int ci = g * G + i;
      const float m = !ok ? 0.f : (y[ci * npix + q] > 0.f ? 1.f : 0.1f);
      pnext[q * (CI + 1) + ci] = acc[i] * m;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BTHREADS)
stem_bwd(const T* __restrict__ im, const T* __restrict__ gout,
         const float* __restrict__ w1, const float* __restrict__ b1,
         const float* __restrict__ w2, const float* __restrict__ b2,
         const float* __restrict__ w3, const float* __restrict__ b3,
         const float* __restrict__ w4, const float* __restrict__ b4,
         const float* __restrict__ wt1, const float* __restrict__ wt2,
         const float* __restrict__ wt3, const float* __restrict__ wt4,
         float* __restrict__ partials, float* __restrict__ dim_blocks,
         int H, int W) {
  extern __shared__ float smem[];
  float* s_img = smem;
  float* s_y1 = s_img + S_IMG;
  float* s_y2 = s_y1 + S_Y1;
  float* s_y3 = s_y2 + S_Y2;
  float* s_p4 = s_y3 + S_Y3;
  float* s_p3 = s_p4 + S_P4;
  float* s_p2 = s_p3 + S_P3;
  float* s_p1 = s_p2 + S_P2;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * BH2, c0 = blockIdx.x * BW2;
  const int H1 = H / 2, W1 = W / 2, H2 = H / 4, W2 = W / 4;
  const size_t tile =
      (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  float* part = partials + tile * N_GRAD;

  // ---- recompute: image rows [4r0 - 6, +B_IMG_R), zero outside ----
  const T* imn = im + static_cast<size_t>(n) * H * W * CIN;
  for (int e = threadIdx.x; e < B_IMG_N * CIN; e += blockDim.x) {
    const int ci = e % CIN, p = e / CIN;
    const int col = p % B_IMG_C, row = p / B_IMG_C;
    const int y = 4 * r0 - 6 + row, x = 4 * c0 - 6 + col;
    float v = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = to_f32(imn[(static_cast<size_t>(y) * W + x) * CIN + ci]);
    s_img[ci * B_IMG_N + p] = v;
  }
  __syncthreads();
  conv_layer<T, CIN, C1, 2>(s_img, B_IMG_R, B_IMG_C, s_y1, B_L1A_R, B_L1A_C,
                            B_L1A_R * B_L1A_C, B_L1A_C, 1, w1, b1,
                            2 * r0 - 3, 2 * c0 - 3, H1, W1);
  __syncthreads();
  conv_layer<T, C1, C1, 1>(s_y1, B_L1A_R, B_L1A_C, s_y2, B_L1B_R, B_L1B_C,
                           B_L1B_R * B_L1B_C, B_L1B_C, 1, w2, b2,
                           2 * r0 - 2, 2 * c0 - 2, H1, W1);
  __syncthreads();
  conv_layer<T, C1, C2, 2>(s_y2, B_L1B_R, B_L1B_C, s_y3, B_L2A_R, B_L2A_C,
                           B_L2A_R * B_L2A_C, B_L2A_C, 1, w3, b3,
                           r0 - 1, c0 - 1, H2, W2);
  __syncthreads();
  // conv4's output (pixel-major) only gives the sign for lrelu'.
  conv_layer<T, C2, C2, 1>(s_y3, B_L2A_R, B_L2A_C, s_p4, BH2, BW2,
                           1, BW2 * (C2 + 1), C2 + 1, w4, b4,
                           r0, c0, H2, W2);
  __syncthreads();

  // ---- p4 = g * lrelu'(z4) on the tile, 0 outside the level-2 extent ----
  const T* gn = gout + static_cast<size_t>(n) * H2 * W2 * C2;
  for (int e = threadIdx.x; e < BH2 * BW2 * C2; e += blockDim.x) {
    const int co = e % C2, q = e / C2;
    const int y = r0 + q / BW2, x = c0 + q % BW2;
    float* dst = s_p4 + q * (C2 + 1) + co;
    float v = 0.f;
    if (y < H2 && x < W2)
      v = to_f32(gn[(static_cast<size_t>(y) * W2 + x) * C2 + co]) *
          (*dst > 0.f ? 1.f : 0.1f);
    *dst = v;
  }
  __syncthreads();

  // ---- back through conv4, conv3, conv2, conv1 ----
  weight_grads<C2, C2, 1>(s_y3, B_L2A_R, B_L2A_C, s_p4, BH2, BW2,
                          part + OFF_W4, part + OFF_B4);
  grad_input<C2, C2, 1>(s_p4, BH2, BW2, wt4, s_y3, B_L2A_R, B_L2A_C, s_p3,
                        r0 - 1, c0 - 1, H2, W2);
  __syncthreads();
  weight_grads<C1, C2, 2>(s_y2, B_L1B_R, B_L1B_C, s_p3, B_L2A_R, B_L2A_C,
                          part + OFF_W3, part + OFF_B3);
  grad_input<C1, C2, 2>(s_p3, B_L2A_R, B_L2A_C, wt3, s_y2, B_L1B_R, B_L1B_C,
                        s_p2, 2 * r0 - 2, 2 * c0 - 2, H1, W1);
  __syncthreads();
  weight_grads<C1, C1, 1>(s_y1, B_L1A_R, B_L1A_C, s_p2, B_L1B_R, B_L1B_C,
                          part + OFF_W2, part + OFF_B2);
  grad_input<C1, C1, 1>(s_p2, B_L1B_R, B_L1B_C, wt2, s_y1, B_L1A_R, B_L1A_C,
                        s_p1, 2 * r0 - 3, 2 * c0 - 3, H1, W1);
  __syncthreads();
  weight_grads<CIN, C1, 2>(s_img, B_IMG_R, B_IMG_C, s_p1, B_L1A_R, B_L1A_C,
                           part + OFF_W1, part + OFF_B1);
  if (dim_blocks == nullptr) return;

  // ---- d_im on the image region: conv1^T(p1), into this tile's block ----
  float* dst = dim_blocks + tile * (B_IMG_N * CIN);
  for (int q = threadIdx.x; q < B_IMG_N; q += blockDim.x) {
    const int j = q / B_IMG_C, k = q % B_IMG_C;
    float acc[CIN] = {0.f, 0.f, 0.f};
    for (int ky = 0; ky < 3; ++ky) {
      const int rs = j - ky;
      if (rs < 0 || rs % 2 || rs / 2 >= B_L1A_R) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int cs = k - kx;
        if (cs < 0 || cs % 2 || cs / 2 >= B_L1A_C) continue;
        const float* src = s_p1 + ((rs / 2) * B_L1A_C + cs / 2) * (C1 + 1);
        const float* wk = wt1 + (ky * 3 + kx) * C1 * CIN;
        for (int co = 0; co < C1; ++co) {
          const float v = src[co];
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
            acc[ci] = fmaf(v, __ldg(wk + co * CIN + ci), acc[ci]);
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) dst[q * CIN + ci] = acc[ci];
  }
}

// out[e] = sum over t < ntiles of partials[t][e], in the order of t. Lanes
// run over e; the TH_R warps of a block take every TH_R-th tile, then warp 0
// adds their sums in a fixed order.
constexpr int TH_R = 8;
__global__ void __launch_bounds__(32 * TH_R)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                int ntiles) {
  __shared__ float s[TH_R][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < N_GRAD)
    for (int t = threadIdx.y; t < ntiles; t += TH_R)
      acc += partials[static_cast<size_t>(t) * N_GRAD + e];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < N_GRAD) {
    float sum = 0.f;
    for (int i = 0; i < TH_R; ++i) sum += s[i][threadIdx.x];
    out[e] = sum;
  }
}

// d_im[n, y, x, ci] = sum of the d_im blocks of the tiles whose image
// region holds (y, x), tile rows then tile columns in increasing order.
template <typename T>
__global__ void overlap_add(const float* __restrict__ blocks,
                            T* __restrict__ dim, int N, int H, int W,
                            int tiles_h, int tiles_w) {
  const size_t total = static_cast<size_t>(N) * H * W * CIN;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ci = e % CIN;
    const size_t p = e / CIN;
    const int x = p % W, y = (p / W) % H, n = p / (static_cast<size_t>(W) * H);
    // Tile t's image region starts at 4 * BH2 * t - 6 (rows) and spans
    // B_IMG_R rows; columns likewise.
    const int ty_lo = max(0, (y + 6 - B_IMG_R + 4 * BH2) / (4 * BH2));
    const int ty_hi = min(tiles_h - 1, (y + 6) / (4 * BH2));
    const int tx_lo = max(0, (x + 6 - B_IMG_C + 4 * BW2) / (4 * BW2));
    const int tx_hi = min(tiles_w - 1, (x + 6) / (4 * BW2));
    float acc = 0.f;
    for (int ty = ty_lo; ty <= ty_hi; ++ty)
      for (int tx = tx_lo; tx <= tx_hi; ++tx) {
        const int j = y + 6 - 4 * BH2 * ty, k = x + 6 - 4 * BW2 * tx;
        const size_t t = (static_cast<size_t>(n) * tiles_h + ty) * tiles_w + tx;
        acc += blocks[(t * B_IMG_N + j * B_IMG_C + k) * CIN + ci];
      }
    store(dim + e, acc);
  }
}

cudaError_t launch_bwd_f32(const float* im, const float* gout,
                           const float* const* wb, const float* const* wt,
                           float* partials, float* grads, float* dim_blocks,
                           float* dim, int n, int h, int w,
                           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      stem_bwd<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BWD_SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const int tiles_h = (h / 4 + BH2 - 1) / BH2;
  const int tiles_w = (w / 4 + BW2 - 1) / BW2;
  const dim3 grid(tiles_w, tiles_h, n);
  stem_bwd<float><<<grid, BTHREADS, BWD_SMEM_BYTES, stream>>>(
      im, gout, wb[0], wb[1], wb[2], wb[3], wb[4], wb[5], wb[6], wb[7], wt[0],
      wt[1], wt[2], wt[3], partials, dim_blocks, h, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int ntiles = n * tiles_h * tiles_w;
  reduce_partials<<<(N_GRAD + 31) / 32, dim3(32, TH_R), 0, stream>>>(
      partials, grads, ntiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (dim_blocks != nullptr) {
    overlap_add<float><<<1024, 256, 0, stream>>>(dim_blocks, dim, n, h, w,
                                                 tiles_h, tiles_w);
    e = cudaGetLastError();
  }
  return e;
}

// ---- The bf16 backward, layer by layer -----------------------------------

using c3::bf16;
using c3::Conv;
using c3::TW;
using c3::MT;

// Stride-2 transposed conv, the input gradient of the stride-2 conv cv from
// p (n, cv.ho, cv.wo, cv.co), cv.co % 16 == 0, and the conv's HWIO weights
// w: out[n, j, i, c] = epi(sum of p[n, oy, ox, o] * w[ky, kx, c, o] over o
// and the taps with j = 2 oy - pt + ky and i = 2 ox - pl + kx), out (n,
// cv.h, cv.w, cv.ci) bf16. Split by
// output parity: output columns of one parity share their taps (ky with
// j + pt - ky even: 1 or 2; kx likewise), so warp (row r, parity q) of a
// block takes the 64 columns i0 + 2u + q (u < 64) of output row j0 + r as
// m16 tiles over 64 consecutive pixels of p, and each of its 1, 2 or 4 taps
// is a product with that tap's weights. SAME's (0, 1) stride-2 padding
// enters only through pt, pl.
template <int NT, int RJ>
struct T2 {
  static constexpr int PR = RJ / 2 + 2, PC = TW + 2;  // p tile rows, cols
  static size_t smem(int co) {
    const size_t w = static_cast<size_t>(9 * co / 16) * NT * 32 * sizeof(uint2);
    const size_t tile = static_cast<size_t>(PR) * PC * (co + 8) * sizeof(bf16);
    const size_t stage = static_cast<size_t>(RJ) * 2 * TW *
                         c3::stage_pitch<NT>() * sizeof(float);
    return w + (tile > stage ? tile : stage);
  }
};

template <int NT, int RJ, class Epi>
__global__ void __launch_bounds__(64 * RJ)
conv3x3_t2(const bf16* __restrict__ p, const float* __restrict__ w, Conv cv,
           bf16* __restrict__ out, Epi epi) {
  using Geo = T2<NT, RJ>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int steps = cv.co / 16, ks = 9 * steps, pitch = cv.co + 8;
  uint2* wf = reinterpret_cast<uint2*>(dyn_smem);
  bf16* tile = reinterpret_cast<bf16*>(wf + ks * NT * 32);
  float* stage = reinterpret_cast<float*>(tile);
  const int img = blockIdx.z, j0 = blockIdx.y * RJ, i0 = blockIdx.x * 2 * TW;
  const int oy0 = j0 / 2 - 1, ox0 = i0 / 2 - 1;  // the p tile's origin
  c3::stage_vec<false>(p, img, cv.ho, cv.wo, cv.co, oy0, ox0, Geo::PR, Geo::PC,
                       Geo::PC, 0, pitch, tile);
  c3::stage_weights(w, c3::hwio_t(cv.co, cv.ci, 0), cv.co, cv.ci, 0, ks, NT,
                    wf);
  c3::cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp >> 1, q = warp & 1, j = j0 + r;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;
  for (int ky = (j + cv.pt) & 1; ky < 3; ky += 2) {
    const int py = (j + cv.pt - ky) / 2 - oy0;  // exact: the sum is even
    for (int kx = (q + cv.pl) & 1; kx < 3; kx += 2) {
      const int px = (q + cv.pl - kx) / 2 + 1;
      const bf16* row = tile + (py * Geo::PC + px + c3::a_row(lane)) * pitch +
                        c3::a_k(lane);
      for (int cc = 0; cc < steps; ++cc) {
        const int s = (ky * 3 + kx) * steps + cc;
        uint2 b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt] = wf[(s * NT + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          c3::ldsm_x4(a, row + mt * 16 * pitch + cc * 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            c3::mma(acc[mt][nt], a, b[nt].x, b[nt].y);
        }
      }
    }
  }
  __syncthreads();  // the sums overwrite the tile
  c3::stage_acc<NT>(acc, stage, r * 2 * TW + q, 2);
  __syncthreads();
  c3::store_tile<NT>(stage, RJ, 2 * TW, img, j0, i0, cv.h, cv.w, cv.ci, 0,
                     out, epi);
}

template <int NT, class Epi>
cudaError_t launch_t2(const bf16* p, const float* w, const Conv& cv,
                      bf16* out, const Epi& epi, cudaStream_t stream) {
  constexpr int RJ = 4;
  const size_t smem = T2<NT, RJ>::smem(cv.co);
  if (cv.co % 16 || cv.ci > NT * 8 || smem > c3::MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_t2<NT, RJ, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(c3::cdiv(cv.w, 2 * TW), c3::cdiv(cv.h, RJ), cv.n);
  kernel<<<grid, 64 * RJ, smem, stream>>>(p, w, cv, out, epi);
  return cudaGetLastError();
}

// The weight and bias gradients of the conv cv (CI -> CO channels, stride
// S) from its input x and the gradient p at its output (pre-activation):
//   dw[tap][c][o] = sum over output pixels of x[n, S oy - pt + ky,
//                   S ox - pl + kx, c] * p[n, oy, ox, o],  db[o] = sum p.
// Per tap a GEMM with M = CI, N = CO, K = pixels: warp `tap` of a block of
// 9 warps takes one tap. Block b of B sums the tiles (WG_R output rows x 64
// columns) b, b + B, ... in that order in registers and writes its sums to
// row b of part (dw in HWIO, then db): a fixed split, reduced in a fixed
// order afterwards. A = x^T and B = p are read with ldmatrix.trans from
// pixel-major tiles (x element by element when CI is not a multiple of 16:
// the image); db is the product of p with an A of ones.
constexpr int WG_R = 4;

template <int S, int CI, int CO>
struct WGrad {
  using T = c3::InTile<S, WG_R, CI % 16 == 0>;
  static constexpr int XP = T::pitch(CI), PP = CO + 8;
  static constexpr int X_ELEMS = (T::ROWS * T::SCOLS * XP + 7) / 8 * 8;
  static constexpr size_t SMEM = (X_ELEMS + WG_R * TW * PP) * sizeof(bf16);
};

template <int S, int CI, int CO>
__global__ void __launch_bounds__(9 * 32)
wgrad(const bf16* __restrict__ x, const bf16* __restrict__ p, Conv cv,
      float* __restrict__ part) {
  using Geo = WGrad<S, CI, CO>;
  using T = typename Geo::T;
  constexpr bool TAPS = CI % 16 == 0;
  constexpr int MTW = (CI + 15) / 16, NTW = CO / 8;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  bf16* xtile = reinterpret_cast<bf16*>(dyn_smem);
  bf16* ptile = xtile + Geo::X_ELEMS;
  const int tap = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ky = tap / 3, kx = tap % 3;
  const int xb = c3::cdiv(cv.wo, TW), yb = c3::cdiv(cv.ho, WG_R);
  const int tiles = cv.n * yb * xb;
  float acc[MTW][NTW][4], accb[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      accb[nt][v] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) acc[mt][nt][v] = 0.f;
    }
  const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                            0x3f803f80u};  // bf16 1.0 pairs

  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int img = tl / (yb * xb);
    const int oy0 = (tl / xb) % yb * WG_R, ox0 = tl % xb * TW;
    if constexpr (TAPS)
      c3::stage_vec<T::DEINT>(x, img, cv.h, cv.w, CI, S * oy0 - cv.pt,
                              S * ox0 - cv.pl, T::ROWS, T::COLS, T::SCOLS,
                              T::HALF, Geo::XP, xtile);
    else
      c3::stage_scalar(x, img, cv.h, cv.w, CI, S * oy0 - cv.pt,
                       S * ox0 - cv.pl, T::ROWS, T::COLS, xtile);
    c3::stage_vec<false>(p, img, cv.ho, cv.wo, CO, oy0, ox0, WG_R, TW, TW, 0,
                         Geo::PP, ptile);
    c3::cp_async_wait_all();
    __syncthreads();
    for (int r = 0; r < WG_R; ++r)
      for (int kb = 0; kb < TW; kb += 16) {
        // B[k][o] = p(pixel kb + k)[o]: matrices (pixels 0-7 / 8-15) x
        // (channels 0-7 / 8-15) give b0, b1 of two n8 tiles.
        uint32_t b[NTW][2];
#pragma unroll
        for (int h = 0; h < NTW / 2; ++h) {
          uint32_t m[4];
          c3::ldsm_x4_t(m, ptile + (r * TW + kb + c3::a_row(lane)) * Geo::PP +
                               h * 16 + c3::a_k(lane));
          b[2 * h][0] = m[0];
          b[2 * h][1] = m[1];
          b[2 * h + 1][0] = m[2];
          b[2 * h + 1][1] = m[3];
        }
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          uint32_t a[4];
          if constexpr (TAPS) {
            // A[c][k] = x(pixel kb + k shifted by the tap)[c]: matrices
            // (pixels 0-7, channels 0-7 / 8-15), (pixels 8-15, ...) give
            // a0, a1, a2, a3.
            const int k = kb + (lane & 7) + (lane >> 4) * 8;
            const int slot = T::DEINT ? (kx & 1) * T::HALF + k + (kx >> 1)
                                      : S * k + kx;
            c3::ldsm_x4_t(a, xtile +
                                 ((S * r + ky) * T::SCOLS + slot) * Geo::XP +
                                 mt * 16 + ((lane >> 3) & 1) * 8);
          } else {
            // Rows c = g < CI of A; a1, a3 (rows 8-15) are 0.
            const uint16_t* xr = reinterpret_cast<const uint16_t*>(xtile) +
                                 ((S * r + ky) * T::COLS + kx) * CI + g;
            uint32_t v[4] = {0u, 0u, 0u, 0u};
            if (g < CI) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = xr[S * (kb + 2 * t + (i & 1) + (i >> 1) * 8) * CI];
            }
            a[0] = v[0] | (v[1] << 16);
            a[1] = 0u;
            a[2] = v[2] | (v[3] << 16);
            a[3] = 0u;
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
            c3::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
        if (tap == 0) {
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
            c3::mma(accb[nt], ones, b[nt][0], b[nt][1]);
        }
      }
    __syncthreads();
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8.
  constexpr int NW = 9 * CI * CO;
  float* dst = part + static_cast<size_t>(blockIdx.x) * (NW + CO);
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = mt * 16 + g + 8 * hh, o = nt * 8 + 2 * t;
        if (c < CI) {
          float* d = dst + (tap * CI + c) * CO + o;
          d[0] = acc[mt][nt][2 * hh];
          d[1] = acc[mt][nt][2 * hh + 1];
        }
      }
  if (tap == 0 && g == 0) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      dst[NW + nt * 8 + 2 * t] = accb[nt][0];
      dst[NW + nt * 8 + 2 * t + 1] = accb[nt][1];
    }
  }
}

template <int S, int CI, int CO>
cudaError_t launch_wgrad(const bf16* x, const bf16* p, const Conv& cv,
                         int blocks, float* part, cudaStream_t stream) {
  constexpr size_t smem = WGrad<S, CI, CO>::SMEM;
  static_assert(smem <= c3::MAX_SMEM, "wgrad tiles must fit 227 KB");
  auto kernel = wgrad<S, CI, CO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<blocks, 9 * 32, smem, stream>>>(x, p, cv, part);
  return cudaGetLastError();
}

// Blocks of each layer's weight-gradient split (conv1..conv4): as many as
// its tiles keep resident on the 132 SMs of an H100 (7, 4, 2, 2 per SM; the
// larger layers hold larger partial rows and tiles). Fixed, so the sums do
// not depend on the card.
__host__ __device__ constexpr int wg_blocks(int l) {
  return l == 0 ? 924 : l == 1 ? 528 : 264;
}
__host__ __device__ constexpr int wg_in(int l) {
  return l == 0 ? CIN : l < 3 ? C1 : C2;
}
__host__ __device__ constexpr int wg_out(int l) { return l < 2 ? C1 : C2; }
// A partial row of layer l: dW (HWIO), then db.
__host__ __device__ constexpr int wg_row(int l) {
  return 9 * wg_in(l) * wg_out(l) + wg_out(l);
}
// Where layer l's rows start in the partials; wg_base(4): their size.
__host__ __device__ constexpr int wg_base(int l) {
  int base = 0;
  for (int i = 0; i < l; ++i) base += wg_blocks(i) * wg_row(i);
  return base;
}

// grads[e], OIHW per layer in the order of N_GRAD (dW1, db1, ..., dW4,
// db4), = the sum over the layer's partial rows (HWIO, then db) in the
// order of the rows, rounded to bf16. Lanes run over a row's elements; the
// TH_R warps of a block take every TH_R-th row, then warp 0 adds their sums
// in a fixed order.
__global__ void __launch_bounds__(32 * TH_R)
reduce_wgrad(const float* __restrict__ partials, float* __restrict__ grads) {
  __shared__ float s[TH_R][32];
  int l = 0, j = blockIdx.x * 32 + threadIdx.x;  // element j of layer l
  while (l < 4 && j >= wg_row(l)) j -= wg_row(l++);
  float acc = 0.f;
  if (l < 4) {
    const float* src = partials + wg_base(l) + j;
    for (int r = threadIdx.y; r < wg_blocks(l); r += TH_R)
      acc += src[static_cast<size_t>(r) * wg_row(l)];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || l == 4) return;
  float sum = 0.f;
  for (int i = 0; i < TH_R; ++i) sum += s[i][threadIdx.x];
  const int ci = wg_in(l), co = wg_out(l), nw = 9 * ci * co;
  int off = 0;  // the layer's offset in grads
  for (int i = 0; i < l; ++i) off += wg_row(i);
  const int tap = j / (ci * co), c = j / co % ci, o = j % co;
  grads[off + (j < nw ? (o * ci + c) * 9 + tap : j)] =
      __bfloat162float(__float2bfloat16_rn(sum));
}

// Elements of the bf16 scratch: y1, y2, p1, p2 at level 1, y3, p3, p4 at
// level 2.
size_t bwd_bf16_scratch(int n, int h, int w) {
  return static_cast<size_t>(n) * (4 * (h / 2) * (w / 2) * C1 +
                                   3 * (h / 4) * (w / 4) * C2);
}

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t err_ = (call);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// out = params (w1 OIHW, b1, ..., w4, b4, f32, in the layout of grads) with
// each weight HWIO, every value rounded to bf16.
__global__ void pack_params(const float* __restrict__ params,
                            float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_GRAD) return;
  int l = 0, j = e;
  while (j >= wg_row(l)) j -= wg_row(l++);
  const int ci = wg_in(l), co = wg_out(l);
  int dst = e;  // the biases keep their place
  if (j < 9 * ci * co)  // OIHW j = (o * ci + c) * 9 + tap -> HWIO
    dst += (j % 9 * ci + j / 9 % ci) * co + j / (9 * ci) - j;
  out[dst] = __bfloat162float(__float2bfloat16_rn(params[e]));
}

// params: the OIHW weights and the biases, f32, in the order and layout of
// grads; partials holds wg_base(4) + N_GRAD f32, the last N_GRAD for them
// packed by pack_params.
cudaError_t launch_bwd_bf16(const bf16* im, const bf16* g,
                            const float* params, bf16* scratch,
                            float* partials, float* grads, bf16* dim, int n,
                            int h, int w, cudaStream_t st) {
  float* wb = partials + wg_base(4);
  pack_params<<<(N_GRAD + 255) / 256, 256, 0, st>>>(params, wb);
  const int h1 = h / 2, w1 = w / 2, h2 = h / 4, w2 = w / 4;
  const size_t s1 = static_cast<size_t>(n) * h1 * w1 * C1;
  const size_t s2 = static_cast<size_t>(n) * h2 * w2 * C2;
  bf16 *y1 = scratch, *y2 = y1 + s1, *p1 = y2 + s1, *p2 = p1 + s1;
  bf16 *y3 = p2 + s1, *p3 = y3 + s2, *p4 = p3 + s2;
  const float *w1_ = wb + OFF_W1, *w2_ = wb + OFF_W2, *w3_ = wb + OFF_W3,
              *w4_ = wb + OFF_W4;
  const Conv c1{n, h, w, CIN, h1, w1, C1, c3::same_pad(h, 2),
                c3::same_pad(w, 2)};
  const Conv c2{n, h1, w1, C1, h1, w1, C1, 1, 1};
  const Conv c3v{n, h1, w1, C1, h2, w2, C2, c3::same_pad(h1, 2),
                 c3::same_pad(w1, 2)};
  const Conv c4{n, h2, w2, C2, h2, w2, C2, 1, 1};
  const c3::BiasAct act1{wb + OFF_B1, 0.1f, 1}, act2{wb + OFF_B2, 0.1f, 1},
      act3{wb + OFF_B3, 0.1f, 1};
  // The forward, and p4 from conv4's sums.
  CHECK(cudaGetLastError());
  CHECK((c3::launch_conv<2, 4, 2, false>(im, w1_, c3::hwio(CIN, C1), c1, y1,
                                         act1, st)));
  CHECK((c3::launch_conv<1, 8, 2, true>(y1, w2_, c3::hwio(C1, C1), c2, y2,
                                        act2, st)));
  CHECK((c3::launch_conv<2, 4, 4, true>(y2, w3_, c3::hwio(C1, C2), c3v, y3,
                                        act3, st)));
  CHECK((c3::launch_conv<1, 8, 4, true>(y3, w4_, c3::hwio(C2, C2), c4, p4,
                                        c3::BiasLreluGrad{wb + OFF_B4, g},
                                        st)));
  // The input gradients: conv4 and conv2 (stride 1) as convs with flipped,
  // transposed weights; conv3 by output parity.
  CHECK((c3::launch_conv<1, 8, 4, true>(p4, w4_, c3::hwio_t(C2, C2, 1), c4,
                                        p3, c3::LreluMask{y3}, st)));
  CHECK((launch_t2<2>(p3, w3_, c3v, p2, c3::LreluMask{y2}, st)));
  CHECK((c3::launch_conv<1, 8, 2, true>(p2, w2_, c3::hwio_t(C1, C1, 1), c2,
                                        p1, c3::LreluMask{y1}, st)));
  // The weight and bias gradients, then their fixed-order reduction.
  CHECK((launch_wgrad<2, CIN, C1>(im, p1, c1, wg_blocks(0),
                                  partials + wg_base(0), st)));
  CHECK((launch_wgrad<1, C1, C1>(y1, p2, c2, wg_blocks(1),
                                 partials + wg_base(1), st)));
  CHECK((launch_wgrad<2, C1, C2>(y2, p3, c3v, wg_blocks(2),
                                 partials + wg_base(2), st)));
  CHECK((launch_wgrad<1, C2, C2>(y3, p4, c4, wg_blocks(3),
                                 partials + wg_base(3), st)));
  reduce_wgrad<<<(N_GRAD + 31) / 32, dim3(32, TH_R), 0, st>>>(partials,
                                                               grads);
  CHECK(cudaGetLastError());
  if (dim != nullptr)
    CHECK((launch_t2<1>(p1, w1_, c1, dim, c3::Identity{}, st)));
  return cudaSuccess;
}

#undef CHECK

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

// Number of f32 sums in a row of partials and in grads: dW1 (HWIO), db1,
// dW2, db2, dW3, db3, dW4, db4, in that order.
extern "C" int pwc_stem_bwd_grad_size() { return N_GRAD; }

// The f32 backward's tiles: partials has (n * tiles) rows of the size
// above, dim_blocks (n * tiles) blocks of (4*4 + 15) * (4*16 + 15) * 3 f32.
extern "C" int pwc_stem_bwd_tiles(int n, int h, int w) {
  return n * ((h / 4 + BH2 - 1) / BH2) * ((w / 4 + BW2 - 1) / BW2);
}
extern "C" int pwc_stem_bwd_block_size() { return B_IMG_N * CIN; }

// The bf16 backward's scratch: bf16 elements, and f32 partial sums.
extern "C" long long pwc_stem_bwd_bf16_scratch(int n, int h, int w) {
  return static_cast<long long>(bwd_bf16_scratch(n, h, w));
}
extern "C" int pwc_stem_bwd_bf16_partials() { return wg_base(4) + N_GRAD; }

// f32. im: (n, h, w, 3), gout: (n, h/4, w/4, 32), dim: like im;
// contiguous. w1..b4 as for pwc_stem_fwd; wt1..wt4: the weights as
// [ky][kx][co][ci] f32. partials, grads, dim_blocks: f32 scratch and output
// of the sizes above. dim_blocks and dim may both be null: then d_im is not
// computed. Returns the CUDA error.
extern "C" int pwc_stem_bwd(const void* im, const void* gout, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* w4,
                            const void* b4, const void* wt1, const void* wt2,
                            const void* wt3, const void* wt4, void* partials,
                            void* grads, void* dim_blocks, void* dim, int n,
                            int h, int w, void* stream) {
  const float* wb[8] = {
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(w4), static_cast<const float*>(b4)};
  const float* wt[4] = {
      static_cast<const float*>(wt1), static_cast<const float*>(wt2),
      static_cast<const float*>(wt3), static_cast<const float*>(wt4)};
  if ((dim_blocks == nullptr) != (dim == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd_f32(
      static_cast<const float*>(im), static_cast<const float*>(gout), wb, wt,
      static_cast<float*>(partials), static_cast<float*>(grads),
      static_cast<float*>(dim_blocks), static_cast<float*>(dim), n, h, w,
      static_cast<cudaStream_t>(stream)));
}

// bf16. im: (n, h, w, 3), gout: (n, h/4, w/4, 32), dim: like im or null
// (then d_im is not computed); contiguous, gout 16-byte aligned. params:
// f32 w1 (OIHW), b1, ..., w4, b4 concatenated, in the layout of grads.
// scratch, partials: of the sizes above. grads: as for pwc_stem_bwd, but
// each dW OIHW, every value rounded to bf16. Returns the CUDA error.
extern "C" int pwc_stem_bwd_bf16(const void* im, const void* gout,
                                 const void* params, void* scratch,
                                 void* partials, void* grads, void* dim,
                                 int n, int h, int w, void* stream) {
  return static_cast<int>(launch_bwd_bf16(
      static_cast<const bf16*>(im), static_cast<const bf16*>(gout),
      static_cast<const float*>(params), static_cast<bf16*>(scratch),
      static_cast<float*>(partials), static_cast<float*>(grads),
      static_cast<bf16*>(dim), n, h, w, static_cast<cudaStream_t>(stream)));
}
