// Lookup in the all-pairs correlation pyramid (K9), written by hand for
// Hopper. A port-only kernel: the TPU package has no all-pairs volume.
//
// For every pixel i = (y, x) of the h x w grid, each level l < L (L <= 4) of
// the pyramid that K8 writes (corr_pyramid.cu: level l is (n, h * w,
// h >> l, w >> l)) is sampled bilinearly, zero outside, at the (2r + 1)^2
// points (cx + a - r, cy + b - r), a, b in [0, 2r], around the centre
// (cx, cy) = coords[n, y, x] / 2^l, in pixel units (grid_sample with
// align_corners=True):
//
//   out[n, y, x, l (2r+1)^2 + a (2r+1) + b]
//
// the channel order of RAFT's CorrBlock, whose window is meshgrid(dy, dx)
// added to (x, y): the first window index moves x. Its plain model is
// pwcnet_tpu_torch/ops/corr_lookup.py:corr_lookup_ref.
//
// Every point of a level shares the centre's fractional part, so a level's
// (2r + 1)^2 samples read one (2r + 2)^2 patch of integer positions. A block
// takes PX pixels of all levels: the centres' floors and fractions first,
// then the PX x L patches staged in shared memory as f32 (zero outside the
// level), then the outputs, each the four corners weighted as grid_sample
// weights them (nw, ne, sw, se, summed in that order), written in the
// outputs' order, so a block's stores are one contiguous run. Outputs are
// in the pyramid's type (bf16 or f32), ready for the 1x1 conv after it.
//
// Bound on an H100 SXM at 440 x 1024 (P = 7040, r = 4): the patches, 400
// values a pixel, and the 324 outputs: 10.2 MB in bf16 a call, 3.1 us at
// 3.35 TB/s; each patch row lies in its own pixel's map, so the reads are
// as scattered as the pixels are many.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PX = 4;           // pixels a block
constexpr int THREADS = 256;
constexpr int MAX_R = 4;
constexpr int MAX_S = 2 * MAX_R + 2;  // the patch's side
constexpr int MAX_L = 4;
// A centre this far outside a level (in its pixels) samples only zeros;
// the bound keeps the integer arithmetic exact.
constexpr float FAR = 1.0e7f;

struct Levels {
  const void* p[MAX_L];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                       T* __restrict__ out, int total, int P, int h, int w,
                       int levels, int r) {
  __shared__ float patch[PX * MAX_L * MAX_S * MAX_S];
  __shared__ int ix0[PX * MAX_L], iy0[PX * MAX_L];
  __shared__ float fx[PX * MAX_L], fy[PX * MAX_L];
  const int S = 2 * r + 2, K = 2 * r + 1;
  const int p0 = blockIdx.x * PX;
  for (int e = threadIdx.x; e < PX * levels; e += THREADS) {
    const int px = e / levels, l = e % levels, p = p0 + px;
    float cx = FAR, cy = FAR;
    if (p < total) {
      // Centre / 2^l: an exact scaling, as RAFT's coords / 2**i.
      const float inv = 1.0f / static_cast<float>(1 << l);
      cx = coords[2 * static_cast<size_t>(p)] * inv;
      cy = coords[2 * static_cast<size_t>(p) + 1] * inv;
    }
    const int k = px * MAX_L + l;
    if (!(fabsf(cx) < FAR && fabsf(cy) < FAR)) {  // NaN too
      ix0[k] = iy0[k] = -(1 << 30);
      fx[k] = fy[k] = 0.f;
    } else {
      const float x0 = floorf(cx), y0 = floorf(cy);
      ix0[k] = static_cast<int>(x0) - r;
      iy0[k] = static_cast<int>(y0) - r;
      fx[k] = cx - x0;
      fy[k] = cy - y0;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < PX * levels * S * S; e += THREADS) {
    const int px = e / (levels * S * S), rest = e % (levels * S * S);
    const int l = rest / (S * S), q = rest % (S * S);
    const int row = q / S, col = q % S, p = p0 + px, k = px * MAX_L + l;
    const int hl = h >> l, wl = w >> l;
    const int y = iy0[k] + row, x = ix0[k] + col;
    float v = 0.f;
    // A far centre's origin is -2^30: every row and column is outside.
    if (p < total && y >= 0 && y < hl && x >= 0 && x < wl)
      v = load(static_cast<const T*>(lv.p[l]) +
               (static_cast<size_t>(p) * hl + y) * wl + x);
    patch[(px * MAX_L + l) * MAX_S * MAX_S + row * MAX_S + col] = v;
  }
  __syncthreads();
  const int ch = levels * K * K;
  for (int e = threadIdx.x; e < PX * ch; e += THREADS) {
    const int px = e / ch, c = e % ch, p = p0 + px;
    if (p >= total) break;
    const int l = c / (K * K), a = (c % (K * K)) / K, b = c % K;
    const int k = px * MAX_L + l;
    // Window index a moves x, b moves y.
    const float* q = patch + k * MAX_S * MAX_S + b * MAX_S + a;
    const float wx = fx[k], wy = fy[k];
    const float nw = (1.f - wx) * (1.f - wy), ne = wx * (1.f - wy);
    const float sw = (1.f - wx) * wy, se = wx * wy;
    const float v = q[0] * nw + q[1] * ne + q[MAX_S] * sw + q[MAX_S + 1] * se;
    store(out + static_cast<size_t>(p) * ch + c, v);
  }
}

}  // namespace

// l0..l3: the pyramid's levels, level l (n, h * w, h >> l, w >> l)
// contiguous, bf16 when is_bf16 else f32; the first `levels` (1 to 4) are
// read. coords: (n, h, w, 2) f32 contiguous, (x, y) in level-0 pixels. out:
// (n, h, w, levels (2r + 1)^2) in the levels' type. 1 <= r <= 4. Returns
// the CUDA error.
extern "C" int pwc_corr_lookup(const void* l0, const void* l1, const void* l2,
                               const void* l3, const void* coords, void* out,
                               int n, int h, int w, int levels, int r,
                               int is_bf16, void* stream) {
  if (levels < 1 || levels > MAX_L || r < 1 || r > MAX_R || n < 1 || h < 1 ||
      w < 1 || (h >> (levels - 1)) < 1 || (w >> (levels - 1)) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = h * w;
  const long long total = static_cast<long long>(n) * P;
  const long long blocks = (total + PX - 1) / PX;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv{{l0, l1, l2, l3}};
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    corr_lookup_kernel<bf16><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        lv, c, static_cast<bf16*>(out), static_cast<int>(total), P, h, w,
        levels, r);
  else
    corr_lookup_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0,
                                s>>>(lv, c, static_cast<float*>(out),
                                     static_cast<int>(total), P, h, w, levels,
                                     r);
  return static_cast<int>(cudaGetLastError());
}
