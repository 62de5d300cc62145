// The BasicEncoders' norms of published RAFT (K10), written by hand for
// Hopper. A port-only kernel: the TPU package has no published RAFT.
//
// Each norm of the encoders (instance norm, eps 1e-5, no affine; or batch
// norm in its eval form), with the ReLU after it and a residual block's
// join, on an (n, C, H, W) channels-last tensor, that is (n, P = H * W, C)
// in memory, bf16 or f32:
//
//   y   = relu(T((x - s) * m + t))                       apply
//   out = relu(T(r + y)),  r = skip or T((skip - s') * m' + t')   joined
//
// each operation an f32 rounding (no contraction), T the rounding to the
// tensor's type. Instance norm: s = the mean over P of each (n, c), m =
// rsqrt(biased variance + eps), t = 0; batch norm: s = 0, m and t the
// per-channel terms that FrozenBatchNorm makes. That is the order of f32
// operations of the plain composition (pwcnet_tpu_torch/ops/encoder_norm.py:
// encoder_norm_ref), so batch norm's path is bit-equal to it.
//
// Statistics (instance norm only): one launch for the images of one or
// two tensors (a block's end: its conv output and its down path), a grid
// of K chunks of the P pixels x the images. A thread holds 8 channels (one
// 16-byte bf16 load) of R = 256 / (C / 8) rows, so a block reads R whole
// rows at a time, contiguous. A thread takes its rows 8 (f32: 4) at a
// time, loading the next 8 before it reduces these: their mean, then their
// centred sum of squares, from registers, merged into its running (count,
// mean, M2) by Chan's formula. The block combines its threads' rows in two
// passes (the mean of the rows' sums, then their M2 plus their centred
// means) and writes the chunk's (mean, M2). The last block of an image to
// finish (an integer ticket; the tickets are zeroed before each launch)
// combines the K chunks the same way, in chunk order (each lane reads 16
// chunks at once, so it waits on the L2 a few times, not K times), and
// writes (mean, rstd). No float atomics and a fixed order: two launches
// give the same bits, and so does a captured graph.
//
// Apply: a block takes a run of rows of one image; each thread reads its 8
// channels' terms once, then streams its rows: the conv output, the
// block's second input where it joins, one store in the tensor's type.
//
// Bound on an H100 SXM: bytes, each input read once and the output written
// once (chip_smoke.py:encoder_norm_cost). At 440 x 1024 the encoders' 30
// norms move 0.74 GB in bf16 a pair, 0.22 ms at 3.35 TB/s; the statistics
// launches read instance norm's 0.22 GB of inputs a second time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int VEC = 8;                 // channels a thread holds
constexpr int MAX_C = VEC * THREADS;   // one row of a block at most
constexpr float EPS = 1e-5f;
constexpr int TARGET_BLOCKS = 264;     // two blocks a multiprocessor
constexpr int BATCH = 16;              // partials a lane reads at once

// 8 channels as loaded: 16 bytes of bf16 or 32 of f32.
template <typename T>
struct Raw;
template <>
struct Raw<bf16> {
  uint4 u;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ Raw<bf16> load(const bf16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Raw<float> load(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ void unpack(const Raw<bf16>& r, float v[VEC]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower half is the lower address
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const Raw<float>& r, float v[VEC]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ void store(bf16* p, const float v[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
            << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store(float* p, const float v[VEC]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The value rounded to T, as f32.
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// torch's relu: NaN stays NaN.
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

__device__ __forceinline__ float norm(float x, float s, float m, float t) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, s), m), t);
}

// Loads per thread in flight: 16 bytes each for bf16, 32 for f32.
template <typename T>
__host__ __device__ constexpr int unroll() {
  return sizeof(T) == 2 ? 8 : 4;
}

// Combines m partials (count, mean, M2) of each of C channels in two
// passes, in a fixed order: mean = sum(count_i mean_i) / total, then M2 =
// sum(M2_i + count_i (mean_i - mean)^2). get(i, c, count, mean, M2) reads
// partial i of channel c; put(c, mean, M2) takes the result. J lanes a
// channel (J = 256 / C, at least 1): lane j sums i = j, j + J, ..., and
// the lanes' sums are added in lane order. A lane reads BATCH partials
// before it adds them, so that reads from the L2 overlap. Every thread of
// the block calls it; red and avg hold THREADS floats.
template <typename Get, typename Put>
__device__ void combine(int m, int C, float total, Get get, Put put,
                        float* red, float* avg) {
  const int J = max(1, THREADS / C), CP = THREADS / J;
  const int t = threadIdx.x, j = t / CP, cl = t % CP;
  for (int c0 = 0; c0 < C; c0 += CP) {
    const int c = c0 + cl;
    const bool on = c < C && j < J;
    float cn[BATCH], mu[BATCH], q[BATCH];
    float s = 0.f;
    for (int i0 = j; on && i0 < m; i0 += J * BATCH) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (i0 + b * J < m) get(i0 + b * J, c, cn[b], mu[b], q[b]);
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (i0 + b * J < m) s += cn[b] * mu[b];
    }
    red[t] = s;
    __syncthreads();
    if (on && j == 0) {
      float a = 0.f;
      for (int l = 0; l < J; ++l) a += red[l * CP + cl];
      avg[cl] = a / total;
    }
    __syncthreads();
    s = 0.f;
    const float mean = on ? avg[cl] : 0.f;
    for (int i0 = j; on && i0 < m; i0 += J * BATCH) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (i0 + b * J < m) get(i0 + b * J, c, cn[b], mu[b], q[b]);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (i0 + b * J < m) {
          const float d = mu[b] - mean;
          s += q[b] + cn[b] * d * d;
        }
      }
    }
    red[t] = s;
    __syncthreads();
    if (on && j == 0) {
      float a = 0.f;
      for (int l = 0; l < J; ++l) a += red[l * CP + cl];
      put(c, avg[cl], a);
    }
    __syncthreads();
  }
}

// Rows p, p + R, ... below p1 (U at most) of 8 channels at base into raw;
// returns how many.
template <typename T, int U>
__device__ __forceinline__ int load_rows(Raw<T> (&raw)[U], const T* base,
                                         int p, int p1, int R, int C) {
  int nb = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (p + u * R < p1) {
      raw[u] = load(base + static_cast<size_t>(p + u * R) * C);
      ++nb;
    }
  }
  return nb;
}

// Image y of the grid: x's n-th for y = n < N, else x2's (y - N)-th; chunk
// k of a grid of K: pixels [k S, min(P, (k + 1) S)). part: (y, K, C) chunk
// (mean, M2); tickets: y, zero at launch; stats: (y, C) (mean, rstd).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ x, const T* __restrict__ x2, int N,
                 float2* __restrict__ part, unsigned* __restrict__ tickets,
                 float2* __restrict__ stats, int P, int C, int S) {
  constexpr int U = unroll<T>();
  __shared__ float s_mean[THREADS * VEC], s_m2[THREADS * VEC];
  __shared__ float s_cnt[THREADS], red[THREADS], avg[THREADS];
  __shared__ bool last;
  const int G = C / VEC, R = THREADS / G;
  const int n = blockIdx.y, k = blockIdx.x, K = gridDim.x, t = threadIdx.x;
  const int g = t % G, r = t / G;
  const int p0 = k * S, p1 = min(P, p0 + S);
  const T* img = n < N ? x + static_cast<size_t>(n) * P * C
                       : x2 + static_cast<size_t>(n - N) * P * C;
  float cnt = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  if (r < R) {
    const T* base = img + g * VEC;
    // Up to U rows at once: their mean and M2 in two passes over the
    // registers, then Chan's merge into the thread's running ones. The
    // next U rows are loaded before these are reduced.
    Raw<T> cur[U], nxt[U];
    int nb = load_rows(cur, base, p0 + r, p1, R, C);
    for (int p = p0 + r; p < p1; p += U * R) {
      const int nb_next = load_rows(nxt, base, p + U * R, p1, R, C);
      float bm[VEC], bq[VEC], v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) bm[i] = bq[i] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nb) {
          unpack(cur[u], v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) bm[i] += v[i];
        }
      }
      const float fb = static_cast<float>(nb), inv = 1.f / fb;
#pragma unroll
      for (int i = 0; i < VEC; ++i) bm[i] *= inv;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nb) {
          unpack(cur[u], v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float d = v[i] - bm[i];
            bq[i] += d * d;
          }
        }
      }
      const float nn = cnt + fb, f = fb / nn;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = bm[i] - mean[i];
        mean[i] += d * f;
        m2[i] += bq[i] + d * d * cnt * f;
      }
      cnt = nn;
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
      nb = nb_next;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s_mean[r * C + g * VEC + i] = mean[i];
      s_m2[r * C + g * VEC + i] = m2[i];
    }
    if (g == 0) s_cnt[r] = cnt;
  }
  __syncthreads();
  float2* mine = part + (static_cast<size_t>(n) * K + k) * C;
  combine(
      R, C, static_cast<float>(p1 - p0),
      [&](int i, int c, float& cn, float& mu, float& q) {
        cn = s_cnt[i];
        mu = s_mean[i * C + c];
        q = s_m2[i * C + c];
      },
      [&](int c, float mu, float q) { mine[c] = make_float2(mu, q); }, red,
      avg);
  // The last block of this n to get here combines the K chunks.
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + n, 1u) == static_cast<unsigned>(K - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float2* all = part + static_cast<size_t>(n) * K * C;
  float2* out = stats + static_cast<size_t>(n) * C;
  combine(
      K, C, static_cast<float>(P),
      [&](int i, int c, float& cn, float& mu, float& q) {
        cn = static_cast<float>(min(S, P - i * S));
        const float2 v = __ldcg(all + static_cast<size_t>(i) * C + c);
        mu = v.x;
        q = v.y;
      },
      [&](int c, float mu, float q) {
        out[c] = make_float2(
            mu, rsqrtf(__fadd_rn(q / static_cast<float>(P), EPS)));
      },
      red, avg);
}

// One norm's terms: stats (n, C) (mean, rstd) for instance norm, or mul
// and add (C) for batch norm; neither: the identity.
struct Terms {
  const float2* stats;
  const float* mul;
  const float* add;
};

__device__ __forceinline__ void load_terms(const Terms& tm, int n, int C,
                                           int c0, float s[VEC],
                                           float m[VEC], float t[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (tm.stats) {
      const float2 v = tm.stats[static_cast<size_t>(n) * C + c0 + i];
      s[i] = v.x;
      m[i] = v.y;
      t[i] = 0.f;
    } else if (tm.mul) {
      s[i] = 0.f;
      m[i] = tm.mul[c0 + i];
      t[i] = tm.add[c0 + i];
    } else {
      s[i] = t[i] = 0.f;
      m[i] = 1.f;
    }
  }
}

// out = relu(T(norm(x))), or relu(T(r + relu(T(norm(x))))) with r the
// skip, normalized by its terms where it has some. A block takes `rows`
// rows of one n.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const T* __restrict__ x, Terms tx,
                 const T* __restrict__ skip, Terms ts, T* __restrict__ out,
                 int P, int C, int rows) {
  constexpr int U = unroll<T>() / 2;  // two streams in flight
  const int G = C / VEC, R = THREADS / G;
  const int n = blockIdx.y, t = threadIdx.x;
  const int g = t % G, r = t / G;
  if (r >= R) return;
  const int p0 = blockIdx.x * rows, p1 = min(P, p0 + rows);
  float xs[VEC], xm[VEC], xt[VEC], ss[VEC], sm[VEC], st[VEC];
  load_terms(tx, n, C, g * VEC, xs, xm, xt);
  const bool join = skip != nullptr;
  const bool skip_norm = ts.stats != nullptr || ts.mul != nullptr;
  if (join) load_terms(ts, n, C, g * VEC, ss, sm, st);
  const size_t base = static_cast<size_t>(n) * P * C + g * VEC;
  const T* tag = nullptr;
  for (int p = p0 + r; p < p1; p += U * R) {
    Raw<T> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = p + u * R;
      if (q < p1) {
        a[u] = load(x + base + static_cast<size_t>(q) * C);
        if (join) b[u] = load(skip + base + static_cast<size_t>(q) * C);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = p + u * R;
      if (q >= p1) continue;
      float v[VEC];
      unpack(a[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        v[i] = relu(round_to(norm(v[i], xs[i], xm[i], xt[i]), tag));
      if (join) {
        float w[VEC];
        unpack(b[u], w);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float s = skip_norm
                              ? round_to(norm(w[i], ss[i], sm[i], st[i]), tag)
                              : w[i];
          v[i] = relu(round_to(__fadd_rn(s, v[i]), tag));
        }
      }
      store(out + base + static_cast<size_t>(q) * C, v);
    }
  }
}

bool bad_shape(int n, int hw, int c) {
  return n < 1 || n > 65535 || hw < 1 || hw > (1 << 24) || c < VEC ||
         c % VEC || c > MAX_C;
}

int rows_per_pass(int c) { return THREADS / (c / VEC); }

}  // namespace

// x, and x2 unless null: (n, hw, c) contiguous, bf16 when is_bf16 else
// f32, 16-byte aligned; c a multiple of 8 up to 2048, hw up to 2^24. With
// m = n (2n with x2): part: m * max_chunks * c float2 (scratch; an image
// is split into max_chunks chunks at most); tickets: m unsigned (scratch,
// zeroed here); stats: (m, c) float2 (mean, rstd) out, x's images first.
// Returns the CUDA error.
extern "C" int pwc_encoder_norm_stats(const void* x, const void* x2,
                                      void* part, void* tickets, void* stats,
                                      int n, int hw, int c, int is_bf16,
                                      int max_chunks, void* stream) {
  const int m = x2 ? 2 * n : n;
  if (bad_shape(m, hw, c) || max_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Enough blocks to fill the card, each thread at least a pass of rows.
  const int pass = rows_per_pass(c) * (is_bf16 ? unroll<bf16>()
                                               : unroll<float>());
  const int want = max(1, min(min(max_chunks, (TARGET_BLOCKS + m - 1) / m),
                              (hw + pass - 1) / pass));
  const int rows = (hw + want - 1) / want;  // a chunk's; none is empty
  const int chunks = (hw + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * m, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(chunks, m);
  float2* p = static_cast<float2*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float2* st = static_cast<float2*>(stats);
  if (is_bf16)
    stats_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(x2), n, p, tk,
        st, hw, c, rows);
  else
    stats_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(x2), n, p,
        tk, st, hw, c, rows);
  return static_cast<int>(cudaGetLastError());
}

// x, skip (null: no join), out: (n, hw, c) contiguous of one type (as
// above). x_stats / skip_stats: (n, c) float2 of the stats launch, or
// x_mul, x_add / skip_mul, skip_add: (c) f32; the skip's all null: it
// joins as it is. Returns the CUDA error.
extern "C" int pwc_encoder_norm_apply(
    const void* x, const void* x_stats, const void* x_mul, const void* x_add,
    const void* skip, const void* skip_stats, const void* skip_mul,
    const void* skip_add, void* out, int n, int hw, int c, int is_bf16,
    void* stream) {
  if (bad_shape(n, hw, c) ||
      (x_stats == nullptr && (x_mul == nullptr || x_add == nullptr)) ||
      ((skip_mul == nullptr) != (skip_add == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Terms tx{static_cast<const float2*>(x_stats),
                 static_cast<const float*>(x_mul),
                 static_cast<const float*>(x_add)};
  const Terms ts{static_cast<const float2*>(skip_stats),
                 static_cast<const float*>(skip_mul),
                 static_cast<const float*>(skip_add)};
  // One pass of each thread's loads a block.
  const int rows = rows_per_pass(c) *
                   (is_bf16 ? unroll<bf16>() : unroll<float>()) / 2;
  const dim3 grid((hw + rows - 1) / rows, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    apply_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), tx, static_cast<const bf16*>(skip), ts,
        static_cast<bf16*>(out), hw, c, rows);
  else
    apply_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), tx, static_cast<const float*>(skip), ts,
        static_cast<float*>(out), hw, c, rows);
  return static_cast<int>(cudaGetLastError());
}
