// All-pairs correlation pyramid (K8), written by hand for Hopper. A
// port-only kernel: the TPU package has no all-pairs volume.
//
//   out0[n, i, y, x] = sum_c f1[n, i, c] * f2[n, y, x, c] / sqrt(C)
//
// for every pixel i of frame 1 (row-major over its h x w grid) and every
// target pixel (y, x) of frame 2, then levels 1..L-1 (L <= 4): each the
// avg_pool2d(2, 2) of the level before over the target dimensions, floored
// as avg_pool2d floors (level l is (h >> l) x (w >> l)). This is RAFT's
// CorrBlock volume and pyramid; its plain model is
// pwcnet_tpu_torch/ops/corr_pyramid.py:corr_pyramid_ref.
//
// A block takes BM = 64 source pixels and one 8 x 8 block of target
// pixels, so that the 2x2 pools of levels 1 to 3 (4 x 4, 2 x 2, 1 x 1
// targets) lie inside the tile. bf16: the GEMM of the tile on the tensor
// cores (mma.sync m16n8k16, f32 sums, the helpers of conv3x3_mma.cuh),
// the channels staged KC = 64 at a time with 16-byte copies, each of the
// four warps taking 16 sources x the 64 targets. f32: the same tile on the
// CUDA cores (4 sources x 8 targets a thread). Either way the scaled f32
// sums go to shared memory; level 0 leaves rounded once to the input type,
// and each coarser level is pooled in f32 from the f32 level before it,
// then rounded. Targets outside the image are sums of zeros, and a pooled
// value that would need one is not written (the floor).
//
// Bound on an H100 SXM at 440 x 1024 (h, w = 55, 128; P = 7040, C = 256):
// 25.4 GFLOP against 131 MB written in bf16 (99 MB of it level 0): the
// bytes bound it, 39 us at 3.35 TB/s against 26 us of tensor-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace {

using c3::bf16;

constexpr int BM = 64;         // source pixels a block
constexpr int TB = 8;          // the target block's side
constexpr int BN = TB * TB;    // target pixels a block
constexpr int KC = 64;         // channels a staging step (bf16)
constexpr int PITCH = KC + 8;  // bf16 staging pitch: ldmatrix without bank
                               // conflicts
constexpr int KF = 32;         // channels a staging step (f32)
constexpr int SP = BN + 4;     // f32 sums' pitch
constexpr int THREADS = 128;

struct Out {
  void* p[4];
  int levels;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Where level l's f32 values of a block lie in shared memory, and their
// pitch: level 0 (8 x 8 targets a source, pitch SP), then 4 x 4, 2 x 2 and
// 1 x 1 (pitch side * side).
__host__ __device__ constexpr int level_offset(int l) {
  return l == 0 ? 0 : BM * SP + BM * ((l > 1 ? 16 : 0) + (l > 2 ? 4 : 0));
}
constexpr int SUM_FLOATS = level_offset(3) + BM;

// The block's scaled sums (level 0 at s, source row src, target u * 8 + v)
// to every level: level 0 straight from s, level l pooled in f32 from level
// l - 1.
template <typename T>
__device__ void write_levels(float* s, const Out& out, int b, int m0, int P,
                             int h, int w, int ty0, int tx0) {
  int side = TB;
  // Level l of the block lies at (ty0 >> l, tx0 >> l) of the level's grid.
  for (int l = 0; l < out.levels; ++l) {
    const int hl = h >> l, wl = w >> l, y0 = ty0 >> l, x0 = tx0 >> l;
    const float* lv = s + level_offset(l);
    const int pitch = l == 0 ? SP : side * side;
    T* o = static_cast<T*>(out.p[l]);
    for (int e = threadIdx.x; e < BM * side * side; e += THREADS) {
      const int src = e / (side * side), t = e % (side * side);
      const int y = y0 + t / side, x = x0 + t % side;
      if (m0 + src < P && y < hl && x < wl)
        store(o + ((static_cast<size_t>(b) * P + m0 + src) * hl + y) * wl + x,
              lv[src * pitch + t]);
    }
    const int half = side / 2;
    if (l + 1 < out.levels) {
      float* nxt = s + level_offset(l + 1);
      for (int e = threadIdx.x; e < BM * half * half; e += THREADS) {
        const int src = e / (half * half), t = e % (half * half);
        const int u = t / half, v = t % half;
        const float* q = lv + src * pitch + (2 * u) * side + 2 * v;
        nxt[src * half * half + t] =
            (((q[0] + q[1]) + q[side]) + q[side + 1]) * 0.25f;
      }
      __syncthreads();
    }
    side = half;
  }
}

// bf16: f1, f2 (n, P, c) with P = h * w, c % 8 == 0, 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
    corr_pyramid_bf16(const bf16* __restrict__ f1, const bf16* __restrict__ f2,
                      Out out, int P, int h, int w, int c, float scale) {
  // Staging (A: sources, B: targets, each BM or BN x PITCH) is reused for
  // the f32 sums of every level.
  constexpr int STAGE = (BM + BN) * PITCH * 2;
  constexpr int SUMS = SUM_FLOATS * 4;
  __shared__ __align__(16) unsigned char smem[STAGE > SUMS ? STAGE : SUMS];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * PITCH;
  const int bx = blockIdx.x % ((w + TB - 1) / TB);
  const int by = blockIdx.x / ((w + TB - 1) / TB);
  const int ty0 = by * TB, tx0 = bx * TB;
  const int m0 = blockIdx.y * BM, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* a_img = f1 + static_cast<size_t>(b) * P * c;
  const bf16* b_img = f2 + static_cast<size_t>(b) * P * c;

  float acc[BN / 8][4];
#pragma unroll
  for (int t = 0; t < BN / 8; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  for (int k0 = 0; k0 < c; k0 += KC) {
    // 8-channel chunks: BM + BN rows x KC / 8 chunks.
    for (int e = threadIdx.x; e < (BM + BN) * (KC / 8); e += THREADS) {
      const int row = e / (KC / 8), q = e % (KC / 8), ch = k0 + q * 8;
      bf16* d;
      const bf16* src = nullptr;
      if (row < BM) {
        d = As + row * PITCH + q * 8;
        if (m0 + row < P && ch < c)
          src = a_img + static_cast<size_t>(m0 + row) * c + ch;
      } else {
        const int t = row - BM, y = ty0 + t / TB, x = tx0 + t % TB;
        d = Bs + t * PITCH + q * 8;
        if (y < h && x < w && ch < c)
          src = b_img + (static_cast<size_t>(y) * w + x) * c + ch;
      }
      if (src)
        c3::cp_async16(d, src);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    c3::cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[4];
      c3::ldsm_x4(a, As + (warp * 16 + (lane & 15)) * PITCH + kk +
                         (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < BN / 8; t += 2) {
        uint32_t bb[4];
        c3::ldsm_x4(bb, Bs + (t * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                 PITCH +
                            kk + ((lane >> 3) & 1) * 8);
        c3::mma(acc[t], a, bb[0], bb[1]);
        c3::mma(acc[t + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  float* s = reinterpret_cast<float*>(smem);
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
    float* r0 = s + (warp * 16 + g) * SP + t * 8 + q2;
    r0[0] = acc[t][0] * scale;
    r0[1] = acc[t][1] * scale;
    r0[8 * SP] = acc[t][2] * scale;
    r0[8 * SP + 1] = acc[t][3] * scale;
  }
  __syncthreads();
  write_levels<bf16>(s, out, b, m0, P, h, w, ty0, tx0);
}

// f32 on the CUDA cores: thread (ts, tt) sums sources 4 ts + [0, 4) against
// targets tt + 8 j, j < 8; any c.
__global__ void __launch_bounds__(THREADS)
    corr_pyramid_f32(const float* __restrict__ f1,
                     const float* __restrict__ f2, Out out, int P, int h,
                     int w, int c, float scale) {
  constexpr int STAGE = (BM + BN) * (KF + 1) * 4;
  constexpr int SUMS = SUM_FLOATS * 4;
  __shared__ __align__(16) unsigned char smem[STAGE > SUMS ? STAGE : SUMS];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * (KF + 1);
  const int bx = blockIdx.x % ((w + TB - 1) / TB);
  const int by = blockIdx.x / ((w + TB - 1) / TB);
  const int ty0 = by * TB, tx0 = bx * TB;
  const int m0 = blockIdx.y * BM, b = blockIdx.z;
  const float* a_img = f1 + static_cast<size_t>(b) * P * c;
  const float* b_img = f2 + static_cast<size_t>(b) * P * c;
  const int ts = threadIdx.x / 8, tt = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < c; k0 += KF) {
    for (int e = threadIdx.x; e < (BM + BN) * KF; e += THREADS) {
      const int row = e / KF, k = e % KF, ch = k0 + k;
      float v = 0.f;
      if (row < BM) {
        if (m0 + row < P && ch < c)
          v = a_img[static_cast<size_t>(m0 + row) * c + ch];
        As[row * (KF + 1) + k] = v;
      } else {
        const int t = row - BM, y = ty0 + t / TB, x = tx0 + t % TB;
        if (y < h && x < w && ch < c)
          v = b_img[(static_cast<size_t>(y) * w + x) * c + ch];
        Bs[t * (KF + 1) + k] = v;
      }
    }
    __syncthreads();
    for (int k = 0; k < KF; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(4 * ts + i) * (KF + 1) + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[(tt + 8 * j) * (KF + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[(4 * ts + i) * SP + tt + 8 * j] = acc[i][j] * scale;
  __syncthreads();
  write_levels<float>(s, out, b, m0, P, h, w, ty0, tx0);
}

}  // namespace

// f1, f2: (n, h, w, c) contiguous, bf16 when is_bf16 (then c % 8 == 0 and
// 16-byte aligned), else f32. o0..o3: level l is (n, h * w, h >> l,
// w >> l) in the inputs' type; the first `levels` (1 to 4) are written.
// Returns the CUDA error.
extern "C" int pwc_corr_pyramid(const void* f1, const void* f2, void* o0,
                                void* o1, void* o2, void* o3, int n, int h,
                                int w, int c, int levels, int is_bf16,
                                void* stream) {
  if (levels < 1 || levels > 4 || n < 1 || h < 1 || w < 1 || c < 1 ||
      (is_bf16 && c % 8) || (h >> (levels - 1)) < 1 ||
      (w >> (levels - 1)) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = h * w;
  const dim3 grid(((h + TB - 1) / TB) * ((w + TB - 1) / TB),
                  (P + BM - 1) / BM, n);
  if (grid.x > 2147483647u || grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  const Out out{{o0, o1, o2, o3}, levels};
  const float scale = 1.0f / sqrtf(static_cast<float>(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    corr_pyramid_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(f1), static_cast<const bf16*>(f2), out, P, h,
        w, c, scale);
  else
    corr_pyramid_f32<<<grid, THREADS, 0, s>>>(static_cast<const float*>(f1),
                                              static_cast<const float*>(f2),
                                              out, P, h, w, c, scale);
  return static_cast<int>(cudaGetLastError());
}
