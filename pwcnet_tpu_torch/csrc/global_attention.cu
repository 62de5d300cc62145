// GMA's global motion aggregation (K11), written by hand for Hopper. A
// port-only kernel: the TPU package has no attention.
//
//   map:       A[n, i, j] = softmax_j(q[n, i, :] . k[n, j, :] / sqrt(D))
//   aggregate: g[n, i, :] = m[n, i, :] + gamma * sum_j A[n, i, j] v[n, j, :]
//
// over the P pixels of the 1/8 grid, with D = 128 (GMA's one head, whose
// width is also the motion features' and the values'). The map is built
// once a pair and stored in the inputs' type; the aggregation runs in each
// of the GRU's iterations. Plain model: pwcnet_tpu_torch/ops/
// global_attention.py (attention_map_ref, aggregate_ref).
//
// Bounds at 136 x 240 (P = 32640), bf16, on an H100 SXM. The map is 2.13 GB:
// an aggregation that streams it reads 2.13 GB (0.64 ms at 3.35 TB/s; its
// product is 0.28 ms of tensor-core time), while one that recomputes
// softmax(q k^T) v from q and k each iteration (flash-style, nothing
// quadratic held) does twice the products, 0.55 ms at the bf16 peak. On
// mma.sync, about two thirds of that peak, the recompute is the slower of
// the two, so the map is stored: two more products (its max and sum, then
// its values) once a pair, in place of a recompute in every iteration.
// PERF.md gives the card's measurement of both bounds.
//
// map (one launch a pair): a block takes BM = 128 queries (8 warps of 16
// rows), whose q fragments stay in registers for the whole launch. It walks
// the keys in tiles of KT = 64 twice, each tile staged with cp.async while
// the one before is multiplied (m16n8k16, f32 sums): first for each row's
// max and sum (online, in f32, exp2 of scores premultiplied by log2(e) /
// sqrt(D)), then to write exp(s - max) / sum, rounded once to the type and
// staged in shared memory so that a row of a tile leaves as 128 contiguous
// bytes. The products bound it (1.1 TFLOP at 136 x 240); the keys (8.4 MB)
// stay in L2.
// aggregate (one launch an iteration; sm_90a): bound by the map's bytes,
// read once: 2.10 GB at 135 x 240, 0.627 ms at 3.35 TB/s, while its
// product (0.27 TFLOP) needs about 43% of the bf16 peak to keep pace, on
// the tensor cores at the same time as the stream. A block of three
// warpgroups takes 256 rows of the map and all D = 128 channels. One
// thread of warpgroup 2 (its registers cut to 40 by setmaxnreg) fills a
// ring of 4 stages of 48 KB by TMA, each the block's 256 rows x 64 columns
// of the map and the matching 64 rows of v, 128-byte swizzled, with a full
// and an empty mbarrier a stage; the tensor maps, built on the host at each
// launch, travel as __grid_constant__ parameters (so a captured graph
// holds them), and TMA's zero fill past P stands for the ragged last tile
// (the pad columns past P are never read). Warpgroups 0 and 1 (232
// registers) each sum 128 rows on wgmma m64n128k16, A (the map, K-major)
// and B (v, MN-major as it lies) from shared memory, f32 sums in registers,
// and free each stage once its products retire. 256-row blocks hold v's
// re-reads from L2 to half the map's bytes; at P = 32400 the 127 blocks
// are one wave on the 132 SMs. Where the row blocks are too few to fill
// the card (published GMA at Sintel size, 55 x 128: 28 blocks), a cluster
// of up to 8 blocks splits each row block's key tiles, the partial sums
// meet in distributed shared memory and each block finishes 256 / cluster
// rows: one launch whose tiling follows P. The epilogue writes g = m +
// gamma * sum in the plain model's f32 roundings, 16 bytes a thread.
// Measured (H100 80GB HBM3, 700 W; PERF.md): 0.70 ms at 135 x 240, 89% of
// the bound (cuBLAS streams the same map in 0.73 ms); 0.049 ms at 55 x 128
// in clusters of 4 (bound 0.030, cuBLAS 0.039).
// f32 (f32 models and tests, not tuned): the same two launches on the CUDA
// cores, 4 x 4 scores or 4 x 8 sums a thread.
// Offsets that involve P^2 are 64-bit: a map holds 1.07e9 values.

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3_mma.cuh"

namespace {

using c3::bf16;
using i64 = long long;

constexpr int D = 128;        // head width = value channels
constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // query rows a block (bf16)
constexpr int KT = 64;        // keys a tile (map)
constexpr int DP = D + 8;     // pitch of a staged row of D: ldmatrix
                              // without bank conflicts
constexpr int OP = KT + 8;    // pitch of a warp's staged output rows (map)
constexpr int CP = D + 4;     // f32 pitch of the aggregate's staged sums
constexpr int MAP_SMEM = (2 * KT * DP + 8 * 16 * OP) * 2;
static_assert(BM * DP <= 2 * KT * DP, "q is staged in the key stages");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(bf16* d) {
  *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
}

// Rows [r0, r0 + rows) of x (row pitch ld, 16-byte rows), D wide, into dst
// (pitch DP); rows at or past P are zeros.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ x, i64 ld,
                                           int r0, int rows, int P,
                                           bf16* dst) {
  for (int e = threadIdx.x; e < rows * (D / 8); e += THREADS) {
    const int r = e / (D / 8), q = (e % (D / 8)) * 8;
    if (r0 + r < P)
      c3::cp_async16(dst + r * DP + q, x + (r0 + r) * ld + q);
    else
      zero16(dst + r * DP + q);
  }
}

// ---- map, bf16 -------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2)
    global_attention_map_bf16(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              bf16* __restrict__ out, int P, i64 ldq, i64 ldk,
                              i64 ldo, i64 sq, i64 sk, i64 so, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // 2 stages of KT x DP
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* os = ks + 2 * KT * DP + warp * 16 * OP;  // the warp's 16 x OP
  const int m0 = blockIdx.x * BM;
  q += blockIdx.y * sq;
  k += blockIdx.y * sk;
  out += blockIdx.y * so;

  // The block's queries, staged in the key stages' room, then held as the
  // A fragments of every product.
  stage_rows(q, ldq, m0, BM, P, ks);
  commit();
  wait_group<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    c3::ldsm_x4(qa[kk], ks + (warp * 16 + (lane & 15)) * DP + kk * 16 +
                            (lane >> 4) * 8);
  __syncthreads();

  const int tiles = (P + KT - 1) / KT;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  // Rows g and g + 8 of the warp: running max and this lane's share of the
  // sum, in log2 units.
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
  for (int pass = 0; pass < 2; ++pass) {
    stage_rows(k, ldk, 0, KT, P, ks);
    commit();
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles)
        stage_rows(k, ldk, (t + 1) * KT, KT, P, ks + ((t + 1) & 1) * KT * DP);
      commit();
      wait_group<1>();
      __syncthreads();
      const bf16* kt = ks + (t & 1) * KT * DP;
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int n = 0; n < KT / 8; n += 2) {
          uint32_t bb[4];
          c3::ldsm_x4(bb, kt + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          c3::mma(s[n], qa[kk], bb[0], bb[1]);
          c3::mma(s[n + 1], qa[kk], bb[2], bb[3]);
        }
      const int j0 = t * KT;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = j0 + n * 8 + q2 + (e & 1) < P ? s[n][e] * scale2
                                                  : -INFINITY;
      if (pass == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tm = -INFINITY;
#pragma unroll
          for (int n = 0; n < KT / 8; ++n)
            tm = fmaxf(tm, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
          tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
          tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
          const float nm = fmaxf(mx[h], tm);  // finite: j0 < P
          float ts = 0.f;
#pragma unroll
          for (int n = 0; n < KT / 8; ++n)
            ts += exp2f(s[n][2 * h] - nm) + exp2f(s[n][2 * h + 1] - nm);
          sum[h] = sum[h] * exp2f(mx[h] - nm) + ts;
          mx[h] = nm;
        }
      } else {
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * h) * OP + n * 8 +
                                               q2) =
                __floats2bfloat162_rn(exp2f(s[n][2 * h] - mx[h]) * inv[h],
                                      exp2f(s[n][2 * h + 1] - mx[h]) * inv[h]);
        __syncwarp();
        for (int e = lane; e < 16 * (KT / 8); e += 32) {
          const int r = e / (KT / 8), c = (e % (KT / 8)) * 8;
          const int row = m0 + warp * 16 + r, col = j0 + c;
          if (row >= P || col >= P) continue;
          const uint4 val = *reinterpret_cast<const uint4*>(os + r * OP + c);
          bf16* dst = out + row * ldo + col;
          if (col + 8 <= P) {
            *reinterpret_cast<uint4*>(dst) = val;
          } else {
            const bf16* v8 = reinterpret_cast<const bf16*>(&val);
            for (int i = 0; col + i < P; ++i) dst[i] = v8[i];
          }
        }
        __syncwarp();
      }
      __syncthreads();  // the next prefetch overwrites this stage
    }
    if (pass == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        inv[h] = 1.f / sum[h];
      }
  }
}

// ---- aggregate, bf16: TMA, mbarriers, wgmma ---------------------------------

constexpr int AG_BM = 256;  // map rows a block: two consumer warpgroups
constexpr int AG_BK = 64;   // map columns (keys) a stage: one 128-byte row
constexpr int AG_STAGES = 4;
constexpr int AG_THREADS = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int AG_A_BYTES = AG_BM * AG_BK * 2;  // a stage's map tile
constexpr int AG_V_HALF = AG_BK * 64 * 2;      // 64 keys x 64 channels of v
constexpr int AG_STAGE_BYTES = AG_A_BYTES + 2 * AG_V_HALF;
constexpr int AG_RING = AG_STAGES * AG_STAGE_BYTES;
// The ring, 1 KB to align it for the 128-byte swizzle, 2 barriers a stage.
constexpr int AG_SMEM = AG_RING + 1024 + 2 * AG_STAGES * 8;
constexpr int AG_MAX_CLUSTER = 8;  // portable cluster size
static_assert(AG_BM * CP * 4 <= AG_RING, "the sums are staged in the ring");
static_assert(AG_STAGE_BYTES % 1024 == 0, "stages keep the swizzle's 1 KB");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
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

// TMA: the box of `map` at (c0, c1, c2), innermost first, into shared
// memory at dst; its bytes complete a transaction on bar.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma operand in shared memory laid out by TMA's 128-byte swizzle:
// lbo, sbo in bytes (PTX's matrix descriptor).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d (64 rows x 128 f32 columns of the warpgroup) += A (64 x 16, K-major)
// B (16 x 128, MN-major: v's rows as they lie).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
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
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving the sums across the asynchronous products.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// g = m + gamma * s for one row's 8 channels, in the plain model's f32
// roundings, 16 bytes out.
__device__ __forceinline__ void finish8(const bf16* __restrict__ m,
                                        bf16* __restrict__ out, float gm,
                                        const float* s) {
  const uint4 mv = *reinterpret_cast<const uint4*>(m);
  const bf16* m8 = reinterpret_cast<const bf16*>(&mv);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(m8[i]), __fmul_rn(gm, s[i])));
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(o);
}

// Grid (row blocks x cs, n), clusters of cs along x: block (b, rank) sums
// map rows [256 b, 256 b + 256) over its share of the key tiles. The map
// (P x P of pitch lda, image stride sa) and v (P x 128) come through the
// tensor maps `amap` (box 64 x 256) and `vmap` (box 64 x 64), zeros past
// P. Warpgroup 2's first thread fills the ring; warpgroups 0 and 1 each
// multiply 128 of the rows. With cs > 1 the cluster's partial sums meet in
// distributed shared memory and each block finishes 256 / cs rows.
__global__ void __launch_bounds__(AG_THREADS, 1)
    global_attention_aggregate_bf16(const __grid_constant__ CUtensorMap amap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const bf16* __restrict__ m,
                                    const float* __restrict__ gamma,
                                    bf16* __restrict__ out, int P, i64 ldm,
                                    i64 ldo, i64 sm, i64 so, int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = c3::smem_u32(smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_ptr = smem + (ring - raw);
  const uint32_t full = ring + AG_RING, empty = full + AG_STAGES * 8;
  const int wg = threadIdx.x / 128, img = blockIdx.y;
  const int rank = blockIdx.x % cs, m0 = blockIdx.x / cs * AG_BM;
  const int tiles = (P + AG_BK - 1) / AG_BK;
  const int t0 = rank * tiles / cs, nt = (rank + 1) * tiles / cs - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < AG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&amap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&vmap))
                   : "memory");
      for (int i = 0; i < nt; ++i) {
        const int s = i % AG_STAGES, k0 = (t0 + i) * AG_BK;
        const uint32_t st = ring + s * AG_STAGE_BYTES, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((i / AG_STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, AG_STAGE_BYTES);
        tma_load3(st, &amap, bar, k0, m0, img);
        tma_load3(st + AG_A_BYTES, &vmap, bar, 0, k0, img);
        tma_load3(st + AG_A_BYTES + AG_V_HALF, &vmap, bar, 64, k0, img);
      }
    }
    if (cs > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    const uint32_t a_rows = wg * 128 * 128;  // the warpgroup's map rows
    for (int i = 0; i < nt; ++i) {
      const int s = i % AG_STAGES;
      const uint32_t st = ring + s * AG_STAGE_BYTES;
      mbar_wait(full + 8 * s, (i / AG_STAGES) & 1);
      pin(acc[0]);
      pin(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < AG_BK / 16; ++kk) {
        // Map: 128-byte rows, 8-row groups 1 KB apart, k by 32 bytes. v:
        // 64-channel halves 8 KB apart, 8-key groups 1 KB apart.
        const uint64_t db =
            desc_sw128(st + AG_A_BYTES + kk * 16 * 128, AG_V_HALF, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_n128(acc[h],
                     desc_sw128(st + a_rows + h * 64 * 128 + kk * 32, 16,
                                1024),
                     db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<1>();  // the previous tile's products are done
      pin(acc[0]);
      pin(acc[1]);
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % AG_STAGES));
    }
    wgmma_wait<0>();
    pin(acc[0]);
    pin(acc[1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the ring is free

    // The sums (or this block's share of them), staged as 256 x CP f32.
    float* sums = reinterpret_cast<float*>(ring_ptr);
    const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        float* r0 =
            sums + (wg * 128 + h * 64 + (warp % 4) * 16 + g) * CP + n * 8 + q2;
        *reinterpret_cast<float2*>(r0) =
            make_float2(acc[h][4 * n], acc[h][4 * n + 1]);
        *reinterpret_cast<float2*>(r0 + 8 * CP) =
            make_float2(acc[h][4 * n + 2], acc[h][4 * n + 3]);
      }
    const float gm = *gamma;
    m += img * sm;
    out += img * so;
    if (cs == 1) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      for (int e = threadIdx.x; e < AG_BM * (D / 8); e += 256) {
        const int r = e / (D / 8), c = (e % (D / 8)) * 8;
        if (m0 + r >= P) continue;
        finish8(m + (m0 + r) * ldm + c, out + (m0 + r) * ldo + c, gm,
                sums + r * CP + c);
      }
    } else {
      cluster_sync();  // every block's share is staged
      const int rows = AG_BM / cs;
      const uint32_t base = c3::smem_u32(sums);
      for (int e = threadIdx.x; e < rows * (D / 8); e += 256) {
        const int r = rank * rows + e / (D / 8), c = (e % (D / 8)) * 8;
        if (m0 + r >= P) continue;
        float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int q = 0; q < cs; ++q) {
          uint32_t peer;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(peer)
                       : "r"(base + (r * CP + c) * 4), "r"(q));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float x[4];
            asm volatile(
                "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                : "r"(peer + half * 16)
                : "memory");
#pragma unroll
            for (int j = 0; j < 4; ++j) s[half * 4 + j] += x[j];
          }
        }
        finish8(m + (m0 + r) * ldm + c, out + (m0 + r) * ldo + c, gm, s);
      }
      cluster_sync();  // no block leaves while the others read its share
    }
  }
}

// ---- f32 on the CUDA cores -------------------------------------------------

constexpr int FM = 64;  // rows a block
constexpr int FK = 32;  // channels or map columns a staging step

// Thread (tr, tc) = (tid / 16, tid % 16) scores rows 4 tr + i against keys
// tc + 16 j of each tile of FM keys.
__global__ void __launch_bounds__(THREADS)
    global_attention_map_f32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             float* __restrict__ out, int P, i64 ldq, i64 ldk,
                             i64 ldo, i64 sq, i64 sk, i64 so, float scale2) {
  __shared__ float qs[FM][D + 1];
  __shared__ float ks[FM][FK + 1];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int m0 = blockIdx.x * FM;
  q += blockIdx.y * sq;
  k += blockIdx.y * sk;
  out += blockIdx.y * so;
  for (int e = threadIdx.x; e < FM * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r][c] = m0 + r < P ? q[(m0 + r) * ldq + c] : 0.f;
  }
  float mx[4], sum[4], inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = -INFINITY, sum[i] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < P; j0 += FM) {
      float s[4][4] = {};
      for (int c0 = 0; c0 < D; c0 += FK) {
        __syncthreads();
        for (int e = threadIdx.x; e < FM * FK; e += THREADS) {
          const int r = e / FK, c = e % FK;
          ks[r][c] = j0 + r < P ? k[(j0 + r) * ldk + c0 + c] : 0.f;
        }
        __syncthreads();
        for (int c = 0; c < FK; ++c) {
          float qa[4], kb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qs[4 * tr + i][c0 + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) kb[j] = ks[tc + 16 * j][c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = j0 + tc + 16 * j < P ? s[i][j] * scale2 : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pass == 0) {
          float tm = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int o = 1; o < 16; o *= 2)
            tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, o));
          const float nm = fmaxf(mx[i], tm);
          float ts = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) ts += exp2f(s[i][j] - nm);
          sum[i] = sum[i] * exp2f(mx[i] - nm) + ts;
          mx[i] = nm;
        } else {
          const int row = m0 + 4 * tr + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + tc + 16 * j;
            if (row < P && col < P)
              out[row * ldo + col] = exp2f(s[i][j] - mx[i]) * inv[i];
          }
        }
      }
    }
    if (pass == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 1; o < 16; o *= 2)
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
        inv[i] = 1.f / sum[i];
      }
  }
}

// Thread (tr, tc) sums rows 4 tr + i over channels tc + 16 j (j < 8).
__global__ void __launch_bounds__(THREADS)
    global_attention_aggregate_f32(const float* __restrict__ a,
                                   const float* __restrict__ v,
                                   const float* __restrict__ m,
                                   const float* __restrict__ gamma,
                                   float* __restrict__ out, int P, i64 lda,
                                   i64 ldv, i64 ldm, i64 ldo, i64 sa, i64 sv,
                                   i64 sm, i64 so) {
  __shared__ float as[FM][FK + 1];
  __shared__ float vs[FK][D];
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int m0 = blockIdx.x * FM;
  a += blockIdx.y * sa;
  v += blockIdx.y * sv;
  m += blockIdx.y * sm;
  out += blockIdx.y * so;
  float acc[4][8] = {};
  for (int j0 = 0; j0 < P; j0 += FK) {
    __syncthreads();
    for (int e = threadIdx.x; e < FM * FK; e += THREADS) {
      const int r = e / FK, c = e % FK;
      as[r][c] = m0 + r < P && j0 + c < P ? a[(m0 + r) * lda + j0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < FK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      vs[r][c] = j0 + r < P ? v[(j0 + r) * ldv + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < FK; ++c) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[4 * tr + i][c];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = vs[c][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  const float gm = *gamma;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * tr + i;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tc + 16 * j;
      out[row * ldo + c] =
          __fadd_rn(m[row * ldm + c], __fmul_rn(gm, acc[i][j]));
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

bool map_smem_set = false, agg_smem_set = false;

bool shape_ok(int n, int P, int d) {
  return d == D && n >= 1 && n <= 65535 && P >= 1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// links against nothing more; null where it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// n bf16 images of rows x cols, row pitch ld and image stride si
// (elements), as TMA reads them: boxes of box_cols x box_rows, swizzled by
// 128 bytes, zeros past the last row and column.
bool tensor_map(CUtensorMap* map, const void* base, int n, int rows,
                int cols, i64 ld, i64 si, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dim[3] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows),
                             static_cast<cuuint64_t>(n)};
  // One image's stride is never used; give it one that TMA takes.
  const cuuint64_t stride[2] = {static_cast<cuuint64_t>(ld) * 2,
                                static_cast<cuuint64_t>(n > 1 ? si
                                                              : ld * rows) *
                                    2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dim, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many blocks of a cluster share each row block's keys: 1 where the
// row blocks of the n maps fill the card's SMs; else the largest power of
// two up to AG_MAX_CLUSTER whose blocks still fit in one wave, one block
// an SM, with a key tile or more each.
int cluster_size(int n, int P) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  const i64 blocks = static_cast<i64>((P + AG_BM - 1) / AG_BM) * n;
  const int tiles = (P + AG_BK - 1) / AG_BK;
  int cs = 1;
  while (cs < AG_MAX_CLUSTER && blocks * cs * 2 <= sms && cs * 2 <= tiles)
    cs *= 2;
  return cs;
}

}  // namespace

// q, k: (n, P, D) rows of pitch ldq, ldk (elements), images sq, sk apart;
// out: (n, P, P) rows of pitch ldo, images so apart; bf16 when is_bf16
// (then every pitch a multiple of 8 and every pointer 16-byte aligned),
// else f32. d must be D. Returns the CUDA error.
extern "C" int pwc_attention_map(const void* q, const void* k, void* out,
                                 int n, int P, int d, long long ldq,
                                 long long ldk, long long ldo, long long sq,
                                 long long sk, long long so, int is_bf16,
                                 void* stream) {
  if (!shape_ok(n, P, d) || ldo < P)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && (ldq % 8 || ldk % 8 || ldo % 8 || sq % 8 || sk % 8 ||
                  so % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale2 = LOG2E / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const cudaError_t err =
        allow_smem(global_attention_map_bf16, MAP_SMEM, map_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    global_attention_map_bf16<<<dim3((P + BM - 1) / BM, n), THREADS,
                                MAP_SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<bf16*>(out), P, ldq, ldk, ldo, sq, sk, so, scale2);
  } else {
    global_attention_map_f32<<<dim3((P + FM - 1) / FM, n), THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<float*>(out), P, ldq, ldk, ldo, sq, sk, so, scale2);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (n, P, P) map rows of pitch lda; v, m: (n, P, D) rows of pitch ldv,
// ldm; gamma: one f32 on the device; out: (n, P, D) rows of pitch ldo;
// sa, sv, sm, so: image strides. Types and alignment as pwc_attention_map;
// m and out in the map's type. Returns the CUDA error.
extern "C" int pwc_attention_aggregate(const void* a, const void* v,
                                       const void* m, const void* gamma,
                                       void* out, int n, int P, int d,
                                       long long lda, long long ldv,
                                       long long ldm, long long ldo,
                                       long long sa, long long sv,
                                       long long sm, long long so,
                                       int is_bf16, void* stream) {
  if (!shape_ok(n, P, d) || lda < P)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && (lda % 8 || ldv % 8 || ldm % 8 || ldo % 8 || sa % 8 ||
                  sv % 8 || sm % 8 || so % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const cudaError_t err =
        allow_smem(global_attention_aggregate_bf16, AG_SMEM, agg_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    // The descriptors travel as launch parameters, so a captured graph
    // holds them with the launch.
    CUtensorMap amap, vmap;
    if (!tensor_map(&amap, a, n, P, P, lda, sa, AG_BK, AG_BM) ||
        !tensor_map(&vmap, v, n, P, D, ldv, sv, 64, AG_BK))
      return static_cast<int>(cudaErrorInvalidValue);
    const int cs = cluster_size(n, P);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = cs;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((P + AG_BM - 1) / AG_BM * cs, n);
    cfg.blockDim = dim3(AG_THREADS);
    cfg.dynamicSmemBytes = AG_SMEM;
    cfg.stream = s;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    const cudaError_t launch = cudaLaunchKernelEx(
        &cfg, global_attention_aggregate_bf16, amap, vmap,
        static_cast<const bf16*>(m), static_cast<const float*>(gamma),
        static_cast<bf16*>(out), P, static_cast<i64>(ldm),
        static_cast<i64>(ldo), static_cast<i64>(sm), static_cast<i64>(so),
        cs);
    if (launch != cudaSuccess) return static_cast<int>(launch);
  } else {
    global_attention_aggregate_f32<<<dim3((P + FM - 1) / FM, n), THREADS, 0,
                                     s>>>(
        static_cast<const float*>(a), static_cast<const float*>(v),
        static_cast<const float*>(m), static_cast<const float*>(gamma),
        static_cast<float*>(out), P, lda, ldv, ldm, ldo, sa, sv, sm, so);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster size over which pwc_attention_aggregate splits the keys of
// n maps of P x P on the current device: 1 where it does not (f32 never
// does).
extern "C" int pwc_attention_aggregate_cluster(int n, int P, int is_bf16) {
  return is_bf16 && shape_ok(n, P, D) ? cluster_size(n, P) : 1;
}
