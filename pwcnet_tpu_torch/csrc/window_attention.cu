// GMFlow's single-head attention over the windows of a grid (K12), written
// by hand for Hopper. A port-only kernel: the TPU package has no attention.
//
//   out[b, p] = sum_j softmax_j(q[b, p] . k[b', j] / sqrt(128) + m) v[b', j]
//
// over the tokens j of p's window. The (H, W) grid of every image is split
// into S x S windows of (H / S) x (W / S) tokens (S = 1: one window, the
// global attention of GMFlow's matching and propagation). A shifted call
// attends within the windows of the grid rolled by half a window up and
// left (Swin's shifted windows, as the released code rolls, splits, merges
// and rolls back), and its mask m adds -100 to every score between tokens
// of two regions of the rolled frame (Swin's region mask: the last window
// row and column hold two regions each). Keys and values come from image
// b' = (b + kv_off) mod bk, so that GMFlow's cross-attention of
// concat(f0, f1) to concat(f1, f0) reads one tensor, swapped. Plain model:
// pwcnet_tpu_torch/ops/window_attention.py (window_attention_ref).
//
// Nothing is copied: every block finds its tokens by index arithmetic
// (window, roll, wrap), gathers them into shared memory with cp.async and
// writes its outputs back to the tokens' own pixels. q and k have 128
// channels; values and outputs have VW = 128 channels (the transformer's
// self- and cross-attention) or 2 (the coordinates of the global matching,
// the flow of the global propagation).
//
// bf16 (sm_90a): a block of three warpgroups takes BM = 128 queries of one
// window. Warpgroup 2 (its registers cut to 40 by setmaxnreg) gathers each
// tile of KT = 128 keys, a row a thread, into one of two stages with
// cp.async, 128-byte swizzled as wgmma reads them (two panels of 64
// channels), zeros past the window; a full and an empty mbarrier a stage
// pass the stages between it and warpgroups 0 and 1 (232 registers), which
// take 64 queries each through every tile: S = q k^T on wgmma m64n128k16
// (both operands from shared memory, f32 sums); in registers the mask
// (added in q.k's units from a byte table of the window's regions, made
// once a block where the window holds two), the keys past the window
// (-inf) and the online softmax in f32 with the scale folded into ex2;
// with VW = 128 the probabilities, rounded to bf16, are the register A
// operand of O += P v on wgmma m64n128k16 (v as it lies, MN-major); with
// VW = 2 the f32 probabilities multiply the f32 values on the CUDA cores.
// The output O / sum is rounded once (bf16 with VW = 128, f32 with VW = 2)
// and, with VW = 128, leaves through the warpgroup's own rows of the staged
// queries as 16-byte row chunks. Every key tile of a window is multiplied:
// no tile is skipped where the mask makes its weight small.
// Measured (H100 80GB HBM3, 700 W; PERF.md): 1.03-1.15 ms a windowed call
// at the cell's shapes against a 0.276 ms bound (24-27%; flash SDPA on the
// same windows, split beforehand, 0.45 ms), 1.19 ms a global call. Tried
// and no faster: tiles of 64 keys, a three-stage software pipeline in each
// warpgroup, the two warpgroups taking turns on the tensor cores.
// f32 (f32 models and tests, not tuned): the same arithmetic on the CUDA
// cores, 32 queries a block, keys in tiles of 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace {

using c3::bf16;
using i64 = long long;

constexpr int C = 128;  // q and k channels (GMFlow's one head)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.f;  // Swin's score between two regions

// The windows of one call.
struct Win {
  int H, W;    // the grid
  int S;       // windows a side
  int wh, ww;  // a window's rows and columns
  int sh, sw;  // the roll (0, 0 unshifted)
  int L;       // tokens a window
  int bk;      // images of k and v
  int kv_off;  // k, v image of query image b: (b + kv_off) % bk
};

// Token t of window (wy, wx): its pixel (y W + x) in the unrolled grid and
// its region in the rolled frame (0 everywhere unless shifted; within a
// window the regions differ only in the last window row or column).
__device__ __forceinline__ int locate(const Win& g, int wy, int wx, int t,
                                      int& lab) {
  const int ty = t / g.ww, tx = t - ty * g.ww;
  lab = (wy == g.S - 1 && ty >= g.wh - g.sh ? 2 : 0) +
        (wx == g.S - 1 && tx >= g.ww - g.sw ? 1 : 0);
  int y = wy * g.wh + ty + g.sh, x = wx * g.ww + tx + g.sw;
  if (y >= g.H) y -= g.H;
  if (x >= g.W) x -= g.W;
  return y * g.W + x;
}

// ---- bf16: cp.async, mbarriers, wgmma -------------------------------------

constexpr int BM = 128;  // queries a block: two consumer warpgroups of 64
constexpr int KT = 128;  // keys a tile
constexpr int ST = 2;    // stages of k and v
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; 2 gathers
constexpr int Q_BYTES = BM * C * 2;  // two panels of BM rows x 128 bytes
constexpr int K_BYTES = KT * C * 2;  // two panels of KT rows x 128 bytes

template <int VW>
struct Tile {
  // A stage: k (K_BYTES), then v (two panels, or KT float2).
  static constexpr int V_BYTES = VW == C ? KT * C * 2 : KT * 8;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  // 1 KB of slack aligns the start for the 128-byte swizzle; the regions'
  // byte table and the barriers follow the stages.
  static constexpr int FIXED = 1024 + Q_BYTES + ST * STAGE + 2 * ST * 8;
};
static_assert(Tile<C>::STAGE % 1024 == 0 && Tile<2>::STAGE % 1024 == 0,
              "stages keep the swizzle's 1 KB alignment");
constexpr int MAX_MASKED_TOKENS = 32768;  // the region table's bytes

// cp.async of `bytes` (16 or 8) from src, or zeros where !valid (src then
// unread).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Offset of 16-byte chunk c (of 16) of staged row r, rows of a panel 128
// bytes, the panels (64 channels each) `rows` rows apart: TMA's and
// wgmma's 128-byte swizzle (chunk c ^ (r mod 8) within a row).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete. A wait of over 10 s
// (a fault of the pipeline: a tile takes microseconds) traps, so that it
// fails the launch in place of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = now_ns();
    else if (now_ns() - start > 10000000000ull)
      __trap();
  }
}

// 2^x on the special-function unit (flushing subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma operand in shared memory laid out in the 128-byte swizzle: lbo,
// sbo in bytes (PTX's matrix descriptor).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register accesses across the asynchronous
// products.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 queries x 128 keys, f32) (+)= A (q: 64 x 16, K-major) B (k: 16 x
// 128, K-major: k's rows as they lie); acc 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 queries x 128 channels, f32) += A (the probabilities: 64 x 16 keys,
// bf16 in registers) B (v: 16 keys x 128, MN-major: v's rows as they lie).
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Grid (query blocks, S * S windows, bq images). v and out are bf16 with
// VW = 128, f32 with VW = 2; token pitches ld*, image strides s* (elements).
// All 384 threads gather the block's queries (and, where the window is
// masked, every token's region into a byte table); then warpgroup 2
// gathers each key tile (one row a thread, zeros past the window) into the
// stage its mbarrier says is free and marks it full, while warpgroups 0
// and 1 (232 registers) each take 64 queries through every tile and free
// the stage after its P v.
template <int VW>
__global__ void __launch_bounds__(THREADS, 1)
    window_attention_bf16(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const void* __restrict__ v, void* __restrict__ out,
                          Win g, i64 ldq, i64 ldk, i64 ldv, i64 ldo, i64 sq,
                          i64 sk, i64 sv, i64 so, int shifted, float scale2) {
  using T = Tile<VW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = c3::smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem + (base - raw);
  const uint32_t qs = base, st0 = base + Q_BYTES;
  const uint32_t full = st0 + ST * T::STAGE, empty = full + ST * 8;
  signed char* labs = reinterpret_cast<signed char*>(
      base_ptr + Q_BYTES + ST * T::STAGE + 2 * ST * 8);

  const int wy = blockIdx.y / g.S, wx = blockIdx.y - wy * g.S;
  const int img = blockIdx.z, kimg = (img + g.kv_off) % g.bk;
  const int m0 = blockIdx.x * BM;
  q += img * sq;
  k += kimg * sk;
  const int tiles = (g.L + KT - 1) / KT;
  const int wg = threadIdx.x / 128;
  // Only the last window row and column hold two regions.
  const bool masked = shifted && (wy == g.S - 1 || wx == g.S - 1);

  for (int e = threadIdx.x; e < BM * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15, t = m0 + r;
    int lab;
    const i64 pix = t < g.L ? locate(g, wy, wx, t, lab) : 0;
    cp_async(qs + swz(r, c, BM), q + pix * ldq + c * 8, 16, t < g.L);
  }
  commit();
  if (masked)
    for (int t = threadIdx.x; t < g.L; t += THREADS) {
      int lab;
      locate(g, wy, wx, t, lab);
      labs[t] = static_cast<signed char>(lab);
    }
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 128);  // every gathering thread
      mbar_init(empty + 8 * s, 8);   // lane 0 of each consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  wait_all();
  fence_async();
  __syncthreads();

  if (wg == 2) {  // the gatherers: key row r of every tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int r = threadIdx.x - 256;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % ST, t = i * KT + r;
      const uint32_t st = st0 + s * T::STAGE;
      mbar_wait(empty + 8 * s, ((i / ST) & 1) ^ 1);
      int lab;
      const i64 pix = t < g.L ? locate(g, wy, wx, t, lab) : 0;
      const bf16* kr = k + pix * ldk;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        cp_async(st + swz(r, c, KT), kr + c * 8, 16, t < g.L);
      if constexpr (VW == C) {
        const bf16* vr = static_cast<const bf16*>(v) + kimg * sv + pix * ldv;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          cp_async(st + K_BYTES + swz(r, c, KT), vr + c * 8, 16, t < g.L);
      } else {
        cp_async(st + K_BYTES + r * 8,
                 static_cast<const float*>(v) + kimg * sv + pix * ldv, 8,
                 t < g.L);
      }
      commit();
      wait_all();
      fence_async();
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gq = lane / 4, q2 = (lane % 4) * 2;
  const uint32_t q_wg = qs + wg * 64 * 128;  // the warpgroup's 64 rows
  // This thread's two rows (gq and gq + 8 of its warp's 16): their regions.
  int qlab[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = m0 + wg * 64 + warp * 16 + gq + 8 * h;
    if (masked && t < g.L) qlab[h] = labs[t];
  }

  constexpr int NO = VW == C ? 64 : 4;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const float raw_bias = MASK / scale2 * LOG2E;  // -100 in q.k's units

  for (int i = 0; i < tiles; ++i) {
    const int s = i % ST;
    const uint32_t ks = st0 + s * T::STAGE, vs = ks + K_BYTES;
    mbar_wait(full + 8 * s, (i / ST) & 1);

    float sc[KT / 2];
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint32_t koff = (kk & 3) * 32;  // 16 channels of a panel
      wgmma_qk(sc,
               desc_sw128(q_wg + (kk >> 2) * (BM * 128) + koff, 16, 1024),
               desc_sw128(ks + (kk >> 2) * (KT * 128) + koff, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    pin(sc);

    // The raw scores, the mask added in their units (Swin's -100 over the
    // scale) and the keys past the window at -inf; the row max is taken
    // on them and the scale folded into the exponent.
    const int j0 = i * KT;
    if (masked) {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int j = j0 + n * 8 + q2;
        const char2 kl = j < g.L ? *reinterpret_cast<const char2*>(labs + j)
                                 : make_char2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((e & 1 ? kl.y : kl.x) != qlab[e >> 1]) sc[4 * n + e] += raw_bias;
      }
    }
    if (j0 + KT > g.L) {
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + n * 8 + q2 + (e & 1) >= g.L) sc[4 * n + e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
        tm = fmaxf(tm, fmaxf(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      const float nm = fmaxf(mrow[h], tm * scale2);  // finite: j0 < L
      alpha[h] = ex2(mrow[h] - nm);
      mrow[h] = nm;
      float ts = 0.f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        sc[4 * n + 2 * h] = ex2(fmaf(sc[4 * n + 2 * h], scale2, -nm));
        sc[4 * n + 2 * h + 1] = ex2(fmaf(sc[4 * n + 2 * h + 1], scale2, -nm));
        ts += sc[4 * n + 2 * h] + sc[4 * n + 2 * h + 1];
      }
      lrow[h] = lrow[h] * alpha[h] + ts;
    }

    if constexpr (VW == C) {
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= alpha[e >> 1];
      uint32_t a[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        a[kk][0] = c3::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        a[kk][1] = c3::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        a[kk][2] = c3::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        a[kk][3] = c3::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_pv(o, a[kk], desc_sw128(vs + kk * 16 * 128, KT * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      pin(o);
    } else {
      const float2* vv = reinterpret_cast<const float2*>(
          base_ptr + Q_BYTES + s * T::STAGE + K_BYTES);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[2 * h] *= alpha[h];
        o[2 * h + 1] *= alpha[h];
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          const float2 v0 = vv[n * 8 + q2], v1 = vv[n * 8 + q2 + 1];
          const float p0 = sc[4 * n + 2 * h], p1 = sc[4 * n + 2 * h + 1];
          o[2 * h] = fmaf(p1, v1.x, fmaf(p0, v0.x, o[2 * h]));
          o[2 * h + 1] = fmaf(p1, v1.y, fmaf(p0, v0.y, o[2 * h + 1]));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / l;
  }
  if constexpr (VW == C) {
    // The warpgroup's rows through its own rows of the staged queries
    // (no other warpgroup reads them), in their swizzle, 16 bytes out.
    fence_async();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + gq + 8 * h;
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
        *reinterpret_cast<uint32_t*>(base_ptr + swz(r, n, BM) + q2 * 2) =
            c3::pack(o[4 * n + 2 * h] * inv[h], o[4 * n + 2 * h + 1] * inv[h]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    bf16* ob = static_cast<bf16*>(out) + img * so;
    for (int e = threadIdx.x % 128; e < 64 * 16; e += 128) {
      const int r = wg * 64 + (e >> 4), c = e & 15, t = m0 + r;
      if (t >= g.L) continue;
      int lab;
      const i64 pix = locate(g, wy, wx, t, lab);
      *reinterpret_cast<uint4*>(ob + pix * ldo + c * 8) =
          *reinterpret_cast<const uint4*>(base_ptr + swz(r, c, BM));
    }
  } else {
    float* ob = static_cast<float*>(out) + img * so;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = o[2 * h], y = o[2 * h + 1];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      const int t = m0 + wg * 64 + warp * 16 + gq + 8 * h;
      if (q2 == 0 && t < g.L) {
        int lab;
        const i64 pix = locate(g, wy, wx, t, lab);
        *reinterpret_cast<float2*>(ob + pix * ldo) =
            make_float2(x * inv[h], y * inv[h]);
      }
    }
  }
}

// ---- f32 on the CUDA cores ------------------------------------------------

constexpr int FM = 32;  // queries a block
constexpr int F_THREADS = 256;
constexpr int FK = 32;  // keys a tile, and channels a staging step

// Thread (tr, tc) = (tid / 16, tid % 16) scores rows 2 tr + i against keys
// tc + 16 j of each tile and sums channels tc + 16 j of rows 2 tr + i.
template <int VW>
__global__ void __launch_bounds__(F_THREADS)
    window_attention_f32(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         Win g, i64 ldq, i64 ldk, i64 ldv, i64 ldo, i64 sq,
                         i64 sk, i64 sv, i64 so, int shifted, float scale2) {
  constexpr int NC = VW == C ? C / 16 : 1;  // channels a thread sums
  __shared__ float qs[FM][C + 1];
  __shared__ float ks[FK][FK + 1];
  __shared__ float vs[FK][VW];
  __shared__ float ps[FM][FK + 1];
  __shared__ i64 kpix[FK];
  __shared__ int klab[FK];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int wy = blockIdx.y / g.S, wx = blockIdx.y - wy * g.S;
  const int img = blockIdx.z, kimg = (img + g.kv_off) % g.bk;
  const int m0 = blockIdx.x * FM;
  q += img * sq;
  k += kimg * sk;
  v += kimg * sv;
  out += img * so;
  const bool masked = shifted && (wy == g.S - 1 || wx == g.S - 1);
  const float bias = MASK * LOG2E;

  for (int e = threadIdx.x; e < FM * C; e += F_THREADS) {
    const int r = e / C, c = e % C, t = m0 + r;
    int lab;
    qs[r][c] = t < g.L ? q[locate(g, wy, wx, t, lab) * ldq + c] : 0.f;
  }
  int qlab[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (m0 + 2 * tr + i < g.L) locate(g, wy, wx, m0 + 2 * tr + i, qlab[i]);

  float o[2][NC] = {}, mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < g.L; j0 += FK) {
    __syncthreads();
    if (threadIdx.x < FK) {
      const int t = j0 + threadIdx.x;
      int lab = 0;
      kpix[threadIdx.x] = t < g.L ? locate(g, wy, wx, t, lab) : -1;
      klab[threadIdx.x] = lab;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < FK * VW; e += F_THREADS) {
      const int r = e / VW, c = e % VW;
      vs[r][c] = kpix[r] >= 0 ? v[kpix[r] * ldv + c] : 0.f;
    }
    float s[2][2] = {};
    for (int c0 = 0; c0 < C; c0 += FK) {
      __syncthreads();
      for (int e = threadIdx.x; e < FK * FK; e += F_THREADS) {
        const int r = e / FK, c = e % FK;
        ks[r][c] = kpix[r] >= 0 ? k[kpix[r] * ldk + c0 + c] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < FK; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s[i][j] =
                fmaf(qs[2 * tr + i][c0 + c], ks[tc + 16 * j][c], s[i][j]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tc + 16 * j;
        float x = s[i][j] * scale2;
        if (masked && klab[col] != qlab[i]) x += bias;
        s[i][j] = j0 + col < g.L ? x : -INFINITY;
      }
      float tm = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
      const float nm = fmaxf(mrow[i], tm);
      alpha[i] = exp2f(mrow[i] - nm);
      mrow[i] = nm;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = exp2f(s[i][j] - nm);
        lrow[i] = j ? lrow[i] + p : lrow[i] * alpha[i] + p;
        ps[2 * tr + i][tc + 16 * j] = p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tc + 16 * j;
        if (c >= VW) continue;
        float acc = o[i][j] * alpha[i];
        for (int kk = 0; kk < FK; ++kk)
          acc = fmaf(ps[2 * tr + i][kk], vs[kk][c], acc);
        o[i][j] = acc;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int off = 1; off < 16; off *= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int t = m0 + 2 * tr + i;
    if (t >= g.L) continue;
    int lab;
    const i64 pix = locate(g, wy, wx, t, lab);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tc + 16 * j;
      if (c < VW) out[pix * ldo + c] = o[i][j] / l;
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's attribute, set once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

bool smem_set[2] = {false, false};

template <int VW>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, const Win& g, int bq, i64 ldq, i64 ldk,
                        i64 ldv, i64 ldo, i64 sq, i64 sk, i64 sv, i64 so,
                        int shifted, float scale2, cudaStream_t s) {
  const int smem_bytes =
      Tile<VW>::FIXED + (shifted ? (g.L + 15) / 16 * 16 : 0);
  const cudaError_t err =
      allow_smem(window_attention_bf16<VW>,
                 Tile<VW>::FIXED + MAX_MASKED_TOKENS, smem_set[VW == C]);
  if (err != cudaSuccess) return err;
  window_attention_bf16<VW><<<dim3((g.L + BM - 1) / BM, g.S * g.S, bq),
                              THREADS, smem_bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), v, out, g,
      ldq, ldk, ldv, ldo, sq, sk, sv, so, shifted, scale2);
  return cudaGetLastError();
}

template <int VW>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const Win& g, int bq, i64 ldq, i64 ldk, i64 ldv,
                       i64 ldo, i64 sq, i64 sk, i64 sv, i64 so, int shifted,
                       float scale2, cudaStream_t s) {
  window_attention_f32<VW><<<dim3((g.L + FM - 1) / FM, g.S * g.S, bq),
                             F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), g, ldq, ldk,
      ldv, ldo, sq, sk, sv, so, shifted, scale2);
  return cudaGetLastError();
}

}  // namespace

// q: (bq, H, W, 128), k: (bk, H, W, 128), v: (bk, H, W, vw), out:
// (bq, H, W, vw); a tensor's pixel (y, x) of image b at b s + (y W + x) ld
// (elements: token pitch ld, image stride s). splits S divides H and W;
// shifted rolls by half a window (which must then be 2 x 2 tokens or more;
// not with S = 1); query image b reads k and v of image (b + kv_off) % bk.
// q and k are bf16 when is_bf16, else f32; v and out are bf16 where q is
// and vw = 128, else f32. vw is 128 or 2. bf16 pitches and strides of
// 16-byte tensors are multiples of 8 elements and their pointers 16-byte
// aligned; an f32 v of vw = 2 has even pitches and strides and an 8-byte
// aligned pointer. Returns the CUDA error.
extern "C" int pwc_window_attention(const void* q, const void* k,
                                    const void* v, void* out, int bq, int bk,
                                    int H, int W, int S, int shifted,
                                    int kv_off, int vw, long long ldq,
                                    long long ldk, long long ldv,
                                    long long ldo, long long sq, long long sk,
                                    long long sv, long long so, int is_bf16,
                                    void* stream) {
  if (bq < 1 || bk < 1 || bq > 65535 || H < 1 || W < 1 || S < 1 ||
      S * S > 65535 || H % S || W % S || (vw != C && vw != 2) || kv_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Win g;
  g.H = H;
  g.W = W;
  g.S = S;
  g.wh = H / S;
  g.ww = W / S;
  g.sh = shifted ? g.wh / 2 : 0;
  g.sw = shifted ? g.ww / 2 : 0;
  g.L = g.wh * g.ww;
  g.bk = bk;
  g.kv_off = kv_off % bk;
  if (shifted && (S == 1 || g.sh < 1 || g.sw < 1 ||
                  (is_bf16 && g.L > MAX_MASKED_TOKENS)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16_v = is_bf16 && vw == C;
  if (is_bf16 && (ldq % 8 || ldk % 8 || sq % 8 || sk % 8 ||
                  reinterpret_cast<uintptr_t>(q) % 16 ||
                  reinterpret_cast<uintptr_t>(k) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_v && (ldv % 8 || ldo % 8 || sv % 8 || so % 8 ||
                 reinterpret_cast<uintptr_t>(v) % 16 ||
                 reinterpret_cast<uintptr_t>(out) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && !bf16_v &&
      (ldv % 2 || ldo % 2 || sv % 2 || so % 2 ||
       reinterpret_cast<uintptr_t>(v) % 8 ||
       reinterpret_cast<uintptr_t>(out) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale2 = LOG2E / sqrtf(static_cast<float>(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = vw == C ? launch_bf16<C>(q, k, v, out, g, bq, ldq, ldk, ldv, ldo,
                                   sq, sk, sv, so, shifted, scale2, s)
                  : launch_bf16<2>(q, k, v, out, g, bq, ldq, ldk, ldv, ldo,
                                   sq, sk, sv, so, shifted, scale2, s);
  else
    err = vw == C ? launch_f32<C>(q, k, v, out, g, bq, ldq, ldk, ldv, ldo, sq,
                                  sk, sv, so, shifted, scale2, s)
                  : launch_f32<2>(q, k, v, out, g, bq, ldq, ldk, ldv, ldo, sq,
                                  sk, sv, so, shifted, scale2, s);
  return static_cast<int>(err);
}
