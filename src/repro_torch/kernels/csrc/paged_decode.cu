// Flash-decode of one query token per batch row over a paged KV cache,
// split over pages (flash-decoding's split-K), with a ring of
// asynchronous page copies.
//
// Replaces the Pallas kernel
//   src/repro/kernels/paged_decode.py::paged_decode_kernel
//     (body _decode_kernel, wrapper ops.py::paged_decode).
//
// q (B, Hq, hd) attends over the pages page_table[b] picks out of the
// (NP, ps, Hkv, hd) pools; positions >= lengths[b] get the finite mask
// value -1e30. Query heads h*G .. h*G+G-1 share kv head h (G = Hq / Hkv).
// Scores are dot * hd^-0.5; the softmax keeps a float32 running max m,
// denominator l and unnormalised accumulator, and ends with
// acc / max(l, 1e-30). Pools are float32 or bfloat16, arithmetic is
// float32, the output has q's type.
//
// What bounds it on an H100: bytes. At llama3.2-3b's widths (B = 5 rows
// of 128 pages of 16 tokens, 8 kv heads, hd 128, float32) one call reads
// 83.9 MB of K and V, 25.0 us at 3.35 TB/s, and does about 1.5 flops a
// byte, far below float32's ridge (67 TFLOP/s over 3.35 TB/s = 20). So
// there are no tensor cores here: wgmma would not shorten a kernel that
// waits on memory, and in float32 it runs as TF32, whose ~1e-3 relative
// error breaks the 2e-5 float32 tolerance. bfloat16 pools take the same
// path with float32 arithmetic.
//
// The split plan. The grid is (split, kv head, batch row): each block
// owns pages_per_split consecutive entries of one row's page table for
// one kv head, so the card gets B x Hkv x n_splits blocks instead of
// B x Hkv (40 at B = 5). The wrapper chooses pages_per_split from the
// shapes alone (paged_decode.py::split_plan) and never reads lengths on
// the host.
//
// The length rule. A block reads lengths[b] itself. For length >= 1 it
// reads only positions below min(length, npg * ps), so pages at or past
// ceil(length / ps) are never touched, and a split wholly past length
// reads nothing and writes the empty partial (m = -1e30, l = 0,
// acc = 0). For length <= 0 every position is masked, and the reference
// then averages V uniformly over all npg pages, padding included: such a
// row reads every page and scores every position -1e30 on purpose.
//
// The async-copy ring. Each block stages TOK = 16 positions of K and V
// (its kv head's slice: hd elements at a row stride of Hkv * hd) into a
// ring of STAGES = 3 buffers in shared memory with cp.async, 16 B a
// thread, neighbouring threads on neighbouring addresses; two chunks are
// in flight while the third is computed, one __syncthreads per chunk.
// cp.async with commit groups rather than the 1-D bulk copy
// (cp.async.bulk): a chunk is 16 rows of hd * 4 = 512 B at a 4 KiB
// stride, so a bulk copy per row would be 32 single-thread copies and
// mbarrier bookkeeping per chunk for the same bytes, and a page may hold
// fewer positions than a chunk (page 8 in the quick shape), which 16 B
// copies handle per element with no special case. The split's page ids
// are staged once in shared memory so no copy waits on a table read.
//
// The compute. q is held in registers: lane l of a warp owns columns
// l, l + 32, ... of up to HPW = 4 query heads. For G <= 4 the four warps
// split each chunk's positions (4 each); for larger G they split the
// heads too (2 x 2 for G <= 8, 4 x 1 for G <= 16). A warp scores 4
// positions of each of its heads, reduces the dots with shuffles, and
// updates its own m, l and accumulator with no shared memory and no
// barrier. At the end the warps that shared a head merge in shared
// memory, in warp order.
//
// The merge order. With one split the block writes the output itself.
// Otherwise each block writes its float32 partial (m, l, acc (G, hd))
// to scratch, and paged_decode_merge (one block per query head and row,
// a thread per column) combines a row's splits in split order 0, 1,
// ...: M = max of m over splits with l > 0, weights exp(m - M) (0 for
// an empty split), out = sum w acc / max(sum w l, 1e-30). The order is
// fixed, so the output is the same from run to run. The splits' m and l
// are staged in shared memory in one round of loads, so the merge waits
// on memory about once for them and once per 8 splits of acc.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TOK = 16;        // positions a ring stage holds
constexpr int STAGES = 3;      // ring depth: STAGES - 1 chunks in flight
constexpr int HPW = 4;         // query heads a warp holds (G <= 16, 4 warps)
constexpr int TSUB = 4;        // positions a warp scores per softmax update
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q and the output are float32 (type 0) or bfloat16 (type 1)
__device__ __forceinline__ float load_any(const void* p, int type, size_t i) {
  return type == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_any(void* p, int type, size_t i,
                                          float x) {
  if (type == 0)
    static_cast<float*>(p)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// warps split G's heads into head_groups groups, and positions among the
// WARPS / head_groups warps of a group
__host__ __device__ __forceinline__ int head_groups(int g_n) {
  return g_n <= HPW ? 1 : (g_n <= 2 * HPW ? 2 : 4);
}

// the ring, reused after the last chunk for the warps' merge; then the
// split's page ids
__host__ __device__ __forceinline__ size_t ring_bytes(int g_n, int hd,
                                                      int esize) {
  const size_t ring = static_cast<size_t>(STAGES) * 2 * TOK * hd * esize;
  const size_t merge = static_cast<size_t>(WARPS / head_groups(g_n)) * g_n *
                       (hd + 2) * sizeof(float);
  const size_t n = ring > merge ? ring : merge;
  return (n + 15) / 16 * 16;
}

size_t smem_bytes(int g_n, int hd, int esize, int pps) {
  return ring_bytes(g_n, hd, esize) + static_cast<size_t>(pps) * sizeof(int);
}

template <typename TKV, int DPL>
__global__ void __launch_bounds__(THREADS) paged_decode_split(
    const void* __restrict__ q, int q_type, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ lengths, void* __restrict__ out, float* part,
    int hq, int hkv, int hd, int ps, int npg, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int g_n = hq / hkv;
  const int wg_n = head_groups(g_n), wt_n = WARPS / wg_n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp % wg_n, wt = warp / wg_n;
  TKV* ring = reinterpret_cast<TKV*>(smem);
  int* s_tab =
      reinterpret_cast<int*>(smem + ring_bytes(g_n, hd, sizeof(TKV)));

  // the positions this split reads (module note: the length rule)
  const int length = lengths[b];
  const bool all_masked = length <= 0;
  const int live_end = all_masked ? npg * ps : min(length, npg * ps);
  const int page0 = split * pps;
  const int pos0 = page0 * ps;
  const int n_tok = max(min(min(page0 + pps, npg) * ps, live_end) - pos0, 0);
  const int n_chunks = (n_tok + TOK - 1) / TOK;
  const int n_live_pages = (n_tok + ps - 1) / ps;
  for (int i = tid; i < n_live_pages; i += THREADS)
    s_tab[i] = page_table[static_cast<size_t>(b) * npg + page0 + i];

  const size_t q_base =
      (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g_n) * hd;
  float qr[HPW][DPL], acc[HPW][DPL], m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = wg + wg_n * j;
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + 32 * k;
      qr[j][k] = g < g_n && d < hd ? load_any(q, q_type, q_base + g * hd + d)
                                   : 0.f;
      acc[j][k] = 0.f;
    }
  }
  __syncthreads();                            // s_tab is written

  constexpr int VEC = 16 / sizeof(TKV);       // elements a 16 B copy moves
  const int row_vecs = hd / VEC;
  const size_t tok_stride = static_cast<size_t>(hkv) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const size_t stage_elems = static_cast<size_t>(2) * TOK * hd;
  auto load_chunk = [&](int c) {              // chunk c into its stage
    TKV* sk = ring + (c % STAGES) * stage_elems;
    TKV* sv = sk + TOK * hd;
    const int nt = min(TOK, n_tok - c * TOK);
    for (int i = tid; i < nt * row_vecs; i += THREADS) {
      const int t = i / row_vecs, j = i - t * row_vecs;
      const int rel = c * TOK + t;            // position within the split
      const int lp = rel / ps;
      const size_t src =
          (static_cast<size_t>(s_tab[lp]) * ps + (rel - lp * ps)) *
              tok_stride + head_off + static_cast<size_t>(j) * VEC;
      cp_async16(sk + t * hd + j * VEC, k_pool + src);
      cp_async16(sv + t * hd + j * VEC, v_pool + src);
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();              // chunk c has landed ...
    __syncthreads();                          // ... for every thread, and
    if (c + STAGES - 1 < n_chunks)            // chunk c - 1's stage is free
      load_chunk(c + STAGES - 1);
    cp_async_commit();
    const TKV* sk = ring + (c % STAGES) * stage_elems;
    const TKV* sv = sk + TOK * hd;
    const int nt = min(TOK, n_tok - c * TOK);
    // this warp's positions wt, wt + wt_n, ..., TSUB at a time
    for (int t0 = wt; t0 < nt; t0 += TSUB * wt_n) {
      float p[HPW][TSUB];
#pragma unroll
      for (int i = 0; i < TSUB; ++i) {
        const int t = t0 + i * wt_n;
#pragma unroll
        for (int j = 0; j < HPW; ++j) {
          float dot = 0.f;
          if (t < nt) {
#pragma unroll
            for (int k = 0; k < DPL; ++k) {
              const int d = lane + 32 * k;
              if (d < hd) dot += qr[j][k] * to_f(sk[t * hd + d]);
            }
          }
          p[j][i] = dot;
        }
      }
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        if (wg + wg_n * j >= g_n) {           // a head this warp lacks
#pragma unroll
          for (int i = 0; i < TSUB; ++i) p[j][i] = 0.f;
          continue;
        }
        float mx = m[j];
#pragma unroll
        for (int i = 0; i < TSUB; ++i) {
          const float s = all_masked ? NEG_INF : warp_sum(p[j][i]) * scale;
          p[j][i] = s;
          if (t0 + i * wt_n < nt) mx = fmaxf(mx, s);
        }
        const float corr = expf(m[j] - mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < TSUB; ++i) {
          const float e = t0 + i * wt_n < nt ? expf(p[j][i] - mx) : 0.f;
          p[j][i] = e;
          sum += e;
        }
        l[j] = l[j] * corr + sum;
        m[j] = mx;
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[j][k] *= corr;
      }
#pragma unroll
      for (int i = 0; i < TSUB; ++i) {
        const int t = t0 + i * wt_n;
        if (t < nt) {
#pragma unroll
          for (int k = 0; k < DPL; ++k) {
            const int d = lane + 32 * k;
            if (d < hd) {
              const float v = to_f(sv[t * hd + d]);
#pragma unroll
              for (int j = 0; j < HPW; ++j) acc[j][k] += p[j][i] * v;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                            // the ring is free again

  // the warps of a head group merge, in warp order: (wt_n, G, hd) sums,
  // then (wt_n, G) maxima and denominators
  float* s_acc = reinterpret_cast<float*>(smem);
  float* s_m = s_acc + wt_n * g_n * hd;
  float* s_l = s_m + wt_n * g_n;
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = wg + wg_n * j;
    if (g < g_n) {
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int d = lane + 32 * k;
        if (d < hd) s_acc[(wt * g_n + g) * hd + d] = acc[j][k];
      }
      if (lane == 0) {
        s_m[wt * g_n + g] = m[j];
        s_l[wt * g_n + g] = l[j];
      }
    }
  }
  __syncthreads();
  const size_t unit = (static_cast<size_t>(b) * hkv + h) * n_splits + split;
  const size_t n_units = static_cast<size_t>(gridDim.z) * hkv * n_splits;
  for (int e = tid; e < g_n * hd; e += THREADS) {
    const int g = e / hd;
    float mx = NEG_INF, den = 0.f, num = 0.f;
    for (int w = 0; w < wt_n; ++w)
      if (s_l[w * g_n + g] > 0.f) mx = fmaxf(mx, s_m[w * g_n + g]);
    for (int w = 0; w < wt_n; ++w) {
      const float lw = s_l[w * g_n + g];
      if (lw > 0.f) {
        const float c = expf(s_m[w * g_n + g] - mx);
        den += c * lw;
        num += c * s_acc[(w * g_n + g) * hd + e - g * hd];
      }
    }
    if (n_splits == 1) {
      store_any(out, q_type, q_base + e, num / fmaxf(den, 1e-30f));
    } else {
      part[unit * g_n * hd + e] = num;
      if (e - g * hd == 0) {
        float* part_m = part + n_units * g_n * hd;
        part_m[unit * g_n + g] = mx;
        part_m[n_units * g_n + unit * g_n + g] = den;    // part_l
      }
    }
  }
}

// one block per (query head, batch row), a thread per column: the
// splits' m and l go to shared memory in one round of loads, their
// weights follow, then every thread sums its columns in split order
__global__ void __launch_bounds__(THREADS) paged_decode_merge(
    const float* __restrict__ part, void* __restrict__ out, int out_type,
    int hq, int hkv, int hd, int n_splits) {
  extern __shared__ float s_ml[];             // (n_splits,) m, then l
  float* s_w = s_ml;                          // m, then its weight
  float* s_l = s_ml + n_splits;
  const int hqi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g_n = hq / hkv, h = hqi / g_n, g = hqi - h * g_n;
  const size_t n_units = static_cast<size_t>(gridDim.y) * hkv * n_splits;
  const size_t u0 = (static_cast<size_t>(b) * hkv + h) * n_splits;
  const float* part_m = part + n_units * g_n * hd + u0 * g_n + g;
  const float* part_l = part_m + n_units * g_n;
  for (int s = tid; s < n_splits; s += THREADS) {
    s_w[s] = part_m[s * g_n];
    s_l[s] = part_l[s * g_n];
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int s = 0; s < n_splits; ++s)
    if (s_l[s] > 0.f) mx = fmaxf(mx, s_w[s]);
  __syncthreads();                            // every thread has read m
  for (int s = tid; s < n_splits; s += THREADS)
    s_w[s] = s_l[s] > 0.f ? expf(s_w[s] - mx) : 0.f;
  __syncthreads();
  const float* acc = part + u0 * g_n * hd + static_cast<size_t>(g) * hd;
  const size_t stride = static_cast<size_t>(g_n) * hd;   // one split
  constexpr int COLS = 256 / THREADS;         // hd <= 256
  float den = 0.f, num[COLS] = {};
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = s_w[s];
    den += w * s_l[s];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tid + c * THREADS;
      if (d < hd) num[c] += w * acc[s * stride + d];
    }
  }
  const size_t o_base = (static_cast<size_t>(b) * hq + hqi) * hd;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = tid + c * THREADS;
    if (d < hd)
      store_any(out, out_type, o_base + d, num[c] / fmaxf(den, 1e-30f));
  }
}

template <typename TKV, int DPL>
int launch_split(const void* q, int q_type, const void* k_pool,
                 const void* v_pool, const int* page_table,
                 const int* lengths, void* out, float* part, int b, int hq,
                 int hkv, int hd, int ps, int npg, int pps, int n_splits,
                 float scale, cudaStream_t stream) {
  auto kern = paged_decode_split<TKV, DPL>;
  const size_t smem = smem_bytes(hq / hkv, hd, sizeof(TKV), pps);
  static size_t granted = 48 * 1024;          // per instantiation
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  dim3 grid(n_splits, hkv, b);
  kern<<<grid, THREADS, smem, stream>>>(
      q, q_type, static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), page_table, lengths, out, part, hq,
      hkv, hd, ps, npg, pps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_dpl(int hd, const void* q, int q_type, const void* k_pool,
               const void* v_pool, const int* page_table, const int* lengths,
               void* out, float* part, int b, int hq, int hkv, int ps,
               int npg, int pps, int n_splits, float scale,
               cudaStream_t s) {
#define MITHRIL_DECODE_DPL(N)                                                \
  return launch_split<TKV, N>(q, q_type, k_pool, v_pool, page_table,         \
                              lengths, out, part, b, hq, hkv, hd, ps, npg,   \
                              pps, n_splits, scale, s)
  if (hd <= 32) MITHRIL_DECODE_DPL(1);
  if (hd <= 64) MITHRIL_DECODE_DPL(2);
  if (hd <= 128) MITHRIL_DECODE_DPL(4);
  if (hd <= 256) MITHRIL_DECODE_DPL(8);
#undef MITHRIL_DECODE_DPL
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The split kernel: one block per (split, kv head, batch row). q_type /
// kv_type: 0 = float32, 1 = bfloat16. With n_splits == 1 it writes
// ``out``; otherwise the float32 partials into ``part``, which holds
// B * Hkv * n_splits * G * (hd + 2) floats: every acc, then every m,
// then every l.
extern "C" int mithril_paged_decode(const void* q, const void* k_pool,
                                    const void* v_pool, const int* page_table,
                                    const int* lengths, void* out,
                                    float* part, int q_type, int kv_type,
                                    int b, int hq, int hkv, int hd, int ps,
                                    int npg, int pps, int n_splits,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type < 0 || q_type > 1 || hq % hkv || pps < 1 || n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_type == 0)
    return launch_dpl<float>(hd, q, q_type, k_pool, v_pool, page_table,
                             lengths, out, part, b, hq, hkv, ps, npg, pps,
                             n_splits, scale, s);
  if (kv_type == 1)
    return launch_dpl<__nv_bfloat16>(hd, q, q_type, k_pool, v_pool,
                                     page_table, lengths, out, part, b, hq,
                                     hkv, ps, npg, pps, n_splits, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The merge of n_splits > 1 partials, one block per (query head, batch
// row).
extern "C" int mithril_paged_decode_merge(const float* part, void* out,
                                          int out_type, int b, int hq,
                                          int hkv, int hd, int n_splits,
                                          void* stream) {
  if (out_type < 0 || out_type > 1 || hq % hkv || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(hq, b);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_splits);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  paged_decode_merge<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      part, out, out_type, hq, hkv, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one split block (the ring, or the warps'
// merge if larger, then the split's page ids).
extern "C" long long mithril_paged_decode_smem(int hq, int hkv, int hd,
                                               int kv_type, int pps) {
  return static_cast<long long>(
      smem_bytes(hq / hkv, hd, kv_type == 0 ? 4 : 2, pps));
}
