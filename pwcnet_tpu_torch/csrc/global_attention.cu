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
// aggregate (one launch an iteration): a block takes BM = 128 rows of the
// map and all D = 128 channels (8 warps, 4 x 2 of 32 rows x 64 channels),
// and streams its rows of the map in BK = 64-column tiles through a
// three-stage cp.async ring, each with the matching 64 rows of v (from
// L2), summing on the tensor cores in f32. The epilogue stages the sums in
// shared memory and writes g = m + gamma * sum in the plain model's f32
// roundings, 16 bytes a thread. Two blocks fit an SM, so at P = 32640 all
// 255 blocks are resident on the 132 SMs at once and the map's bytes bound
// it.
// f32 (f32 models and tests, not tuned): the same two launches on the CUDA
// cores, 4 x 4 scores or 4 x 8 sums a thread.
// Offsets that involve P^2 are 64-bit: a map holds 1.07e9 values.

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
constexpr int BK = 64;        // map columns a tile (aggregate)
constexpr int AP = BK + 8;    // pitch of a staged map tile
constexpr int STAGES = 3;     // the aggregate's cp.async ring
constexpr int CP = D + 4;     // f32 pitch of the aggregate's staged sums
constexpr int MAP_SMEM = (2 * KT * DP + 8 * 16 * OP) * 2;
constexpr int AGG_STAGE = BM * AP + BK * DP;  // bf16 values a stage
constexpr int AGG_SMEM = STAGES * AGG_STAGE * 2;
static_assert(BM * DP <= 2 * KT * DP, "q is staged in the key stages");
static_assert(BM * CP * 4 <= AGG_SMEM, "the sums are staged in the ring");
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

// ---- aggregate, bf16 -------------------------------------------------------

// Map tile t (BK columns of the block's BM rows) and the matching BK rows of
// v into ring stage st. Columns at or past P read as zeros; a 16-byte chunk
// that P cuts is read value by value.
__device__ __forceinline__ void stage_agg(const bf16* __restrict__ a, i64 lda,
                                          const bf16* __restrict__ v, i64 ldv,
                                          int m0, int t, int P, bf16* as) {
  bf16* vs = as + BM * AP;
  const int j0 = t * BK;
  for (int e = threadIdx.x; e < BM * (BK / 8); e += THREADS) {
    const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
    const int row = m0 + r, col = j0 + c;
    bf16* d = as + r * AP + c;
    if (row < P && col + 8 <= P) {
      c3::cp_async16(d, a + row * lda + col);
    } else if (row < P && col < P) {
      __align__(16) bf16 tmp[8];
      const bf16* src = a + row * lda + col;
      for (int i = 0; i < 8; ++i)
        tmp[i] = col + i < P ? src[i] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    } else {
      zero16(d);
    }
  }
  for (int e = threadIdx.x; e < BK * (D / 8); e += THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    if (j0 + r < P)
      c3::cp_async16(vs + r * DP + c, v + (j0 + r) * ldv + c);
    else
      zero16(vs + r * DP + c);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    global_attention_aggregate_bf16(const bf16* __restrict__ a,
                                    const bf16* __restrict__ v,
                                    const bf16* __restrict__ m,
                                    const float* __restrict__ gamma,
                                    bf16* __restrict__ out, int P, i64 lda,
                                    i64 ldv, i64 ldm, i64 ldo, i64 sa, i64 sv,
                                    i64 sm, i64 so) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // rows 32 wm, channels 64 wn
  const int m0 = blockIdx.x * BM;
  a += blockIdx.y * sa;
  v += blockIdx.y * sv;
  m += blockIdx.y * sm;
  out += blockIdx.y * so;
  const int tiles = (P + BK - 1) / BK;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles)
      stage_agg(a, lda, v, ldv, m0, st, P, ring + st * AGG_STAGE);
    commit();
  }
  for (int t = 0; t < tiles; ++t) {
    wait_group<STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    const int pf = t + STAGES - 1;
    if (pf < tiles)
      stage_agg(a, lda, v, ldv, m0, pf, P, ring + (pf % STAGES) * AGG_STAGE);
    commit();
    const bf16* as = ring + (t % STAGES) * AGG_STAGE;
    const bf16* vs = as + BM * AP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        c3::ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * AP + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        // Matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k
        // 8-15, n 8-15) of v's rows, transposed: b0, b1 of two n8 tiles.
        uint32_t bb[4];
        c3::ldsm_x4_t(bb, vs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * DP +
                              wn * 64 + n * 8 + 8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          c3::mma(acc[i][n], af[i], bb[0], bb[1]);
          c3::mma(acc[i][n + 1], af[i], bb[2], bb[3]);
        }
      }
    }
  }
  wait_group<0>();
  __syncthreads();

  float* cs = reinterpret_cast<float*>(smem);  // BM x CP f32 sums
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* r0 = cs + (wm * 32 + i * 16 + g) * CP + wn * 64 + n * 8 + q2;
      r0[0] = acc[i][n][0];
      r0[1] = acc[i][n][1];
      r0[8 * CP] = acc[i][n][2];
      r0[8 * CP + 1] = acc[i][n][3];
    }
  __syncthreads();
  const float gm = *gamma;
  for (int e = threadIdx.x; e < BM * (D / 8); e += THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const int row = m0 + r;
    if (row >= P) continue;
    const uint4 mv = *reinterpret_cast<const uint4*>(m + row * ldm + c);
    const bf16* m8 = reinterpret_cast<const bf16*>(&mv);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(m8[i]), __fmul_rn(gm, cs[r * CP + c + i])));
    *reinterpret_cast<uint4*>(out + row * ldo + c) =
        *reinterpret_cast<const uint4*>(o);
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
        allow_smem(global_attention_aggregate_bf16, AGG_SMEM, agg_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    global_attention_aggregate_bf16<<<dim3((P + BM - 1) / BM, n), THREADS,
                                      AGG_SMEM, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(v),
        static_cast<const bf16*>(m), static_cast<const float*>(gamma),
        static_cast<bf16*>(out), P, lda, ldv, ldm, ldo, sa, sv, sm, so);
  } else {
    global_attention_aggregate_f32<<<dim3((P + FM - 1) / FM, n), THREADS, 0,
                                     s>>>(
        static_cast<const float*>(a), static_cast<const float*>(v),
        static_cast<const float*>(m), static_cast<const float*>(gamma),
        static_cast<float*>(out), P, lda, ldv, ldm, ldo, sa, sv, sm, so);
  }
  return static_cast<int>(cudaGetLastError());
}
