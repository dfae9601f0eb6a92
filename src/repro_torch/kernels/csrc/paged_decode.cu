// Flash-decode of one query token per batch row over a paged KV cache.
//
// Replaces the Pallas kernel
//   src/repro/kernels/paged_decode.py::paged_decode_kernel
//     (body _decode_kernel, wrapper ops.py::paged_decode).
//
// q (B, Hq, hd) attends over the pages page_table[b] picks out of the
// (NP, ps, Hkv, hd) pools; positions >= lengths[b] get the finite mask
// value -1e30 (so a fully masked row averages V uniformly, as in the
// reference; -inf would give NaN). Query heads h*G .. h*G+G-1 share kv
// head h (G = Hq / Hkv). Scores are dot * hd^-0.5; the online softmax
// keeps a float32 running max, denominator and accumulator and ends
// with acc / max(l, 1e-30). Pools are float32 or bfloat16, arithmetic
// is float32, the output has q's type.
//
// What bounds it on an H100: bytes. Each (row, kv head) reads its pages'
// K and V head slices once (at llama3.2-3b's widths, page 16, 128 pages
// a row: 16 x 128 x 4 B = 8 KiB of K and of V per page and head) and does
// 4 flops per element of them, far below the card's ridge. The design:
// one block per (kv head, batch row) walks the page table in order; it
// keeps its G query rows in shared memory and the accumulator in
// registers (each thread owns hd / 128 columns of every query head),
// stages each page's K and V head slices 16 tokens at a time in shared
// memory (converted to float32), takes the dots one warp per (query
// head, token) with a warp sum, and the softmax update one warp per
// query head. Only the pages in the table are read, from pools that
// stay on the card: the Pallas BlockSpecs' copy of the whole pool into
// every grid step has no counterpart. With B x Hkv blocks (40 at B = 5,
// Hkv = 8) the card is under-filled; splitting the pages across blocks
// and wgmma/TMA staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TOK = 16;        // tokens of a page staged at a time
constexpr int MAX_G = 16;      // query heads per kv head
constexpr int MAX_DPT = 2;     // accumulator columns a thread owns: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int g_n, int hd) {
  return static_cast<size_t>(g_n * hd + 2 * TOK * hd + g_n * TOK + 3 * g_n) *
         sizeof(float);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ lengths, TQ* __restrict__ out, int hq, int hkv,
    int hd, int ps, int npg, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;                   // kv head
  const int b = blockIdx.y;                   // batch row
  const int g_n = hq / hkv;
  float* s_q = smem;                          // (G, hd)
  float* s_k = s_q + g_n * hd;                // (TOK, hd)
  float* s_v = s_k + TOK * hd;                // (TOK, hd)
  float* s_p = s_v + TOK * hd;                // (G, TOK) scores -> weights
  float* s_m = s_p + g_n * TOK;               // (G,) running max
  float* s_l = s_m + g_n;                     // (G,) running denominator
  float* s_c = s_l + g_n;                     // (G,) this chunk's correction
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const size_t q_off =
      (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g_n) * hd;
  for (int i = tid; i < g_n * hd; i += THREADS) s_q[i] = to_f(q[q_off + i]);
  if (tid < g_n) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  float acc[MAX_G][MAX_DPT];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int k = 0; k < MAX_DPT; ++k) acc[g][k] = 0.f;

  const int length = lengths[b];
  const size_t tok_stride = static_cast<size_t>(hkv) * hd;
  for (int p = 0; p < npg; ++p) {
    const size_t page = static_cast<size_t>(
        page_table[static_cast<size_t>(b) * npg + p]);
    const size_t base = page * ps * tok_stride + static_cast<size_t>(h) * hd;
    for (int t0 = 0; t0 < ps; t0 += TOK) {
      const int nt = min(TOK, ps - t0);
      __syncthreads();                        // the last chunk is consumed
      for (int i = tid; i < nt * hd; i += THREADS) {
        const int t = i / hd, d = i - t * hd;
        const size_t off = base + (t0 + t) * tok_stride + d;
        s_k[i] = to_f(k_pool[off]);
        s_v[i] = to_f(v_pool[off]);
      }
      __syncthreads();
      // scores: one warp per (query head, token), lanes across hd
      for (int pr = warp; pr < g_n * nt; pr += WARPS) {
        const int g = pr / nt, t = pr - g * nt;
        float dot = 0.f;
        for (int d = lane; d < hd; d += 32)
          dot += s_q[g * hd + d] * s_k[t * hd + d];
        dot = warp_sum(dot);
        if (lane == 0)
          s_p[g * TOK + t] = p * ps + t0 + t < length ? dot * scale : NEG_INF;
      }
      __syncthreads();
      // online softmax: one warp per query head, tokens across lanes
      for (int g = warp; g < g_n; g += WARPS) {
        const float sv = lane < nt ? s_p[g * TOK + lane] : NEG_INF;
        const float m_prev = s_m[g];
        const float m_new = fmaxf(m_prev, warp_max(sv));
        const float e = lane < nt ? expf(sv - m_new) : 0.f;
        const float sum = warp_sum(e);
        if (lane < nt) s_p[g * TOK + lane] = e;
        if (lane == 0) {
          const float c = expf(m_prev - m_new);
          s_c[g] = c;
          s_l[g] = s_l[g] * c + sum;
          s_m[g] = m_new;
        }
      }
      __syncthreads();
      // accumulator: acc = acc * c + weights @ V over this chunk
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < g_n) {
          const float c = s_c[g];
#pragma unroll
          for (int k = 0; k < MAX_DPT; ++k) {
            const int d = tid + k * THREADS;
            if (d < hd) {
              float a = acc[g][k] * c;
              for (int t = 0; t < nt; ++t)
                a += s_p[g * TOK + t] * s_v[t * hd + d];
              acc[g][k] = a;
            }
          }
        }
      }
    }
  }
  // s_l was last written before the final chunk's last __syncthreads
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < g_n) {
      const float l = fmaxf(s_l[g], 1e-30f);
#pragma unroll
      for (int k = 0; k < MAX_DPT; ++k) {
        const int d = tid + k * THREADS;
        if (d < hd) store(out + q_off + g * hd + d, acc[g][k] / l);
      }
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* lengths, void* out, int b,
           int hq, int hkv, int hd, int ps, int npg, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hq / hkv, hd);
  auto kern = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(hkv, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), page_table, lengths,
      static_cast<TQ*>(out), hq, hkv, hd, ps, npg, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_type / kv_type: 0 = float32, 1 = bfloat16.
extern "C" int mithril_paged_decode(const void* q, const void* k_pool,
                                    const void* v_pool, const int* page_table,
                                    const int* lengths, void* out, int q_type,
                                    int kv_type, int b, int hq, int hkv,
                                    int hd, int ps, int npg, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_type == 0 && kv_type == 0)
    return launch<float, float>(q, k_pool, v_pool, page_table, lengths, out,
                                b, hq, hkv, hd, ps, npg, scale, s);
  if (q_type == 0 && kv_type == 1)
    return launch<float, bf16>(q, k_pool, v_pool, page_table, lengths, out,
                               b, hq, hkv, hd, ps, npg, scale, s);
  if (q_type == 1 && kv_type == 0)
    return launch<bf16, float>(q, k_pool, v_pool, page_table, lengths, out,
                               b, hq, hkv, hd, ps, npg, scale, s);
  if (q_type == 1 && kv_type == 1)
    return launch<bf16, bf16>(q, k_pool, v_pool, page_table, lengths, out, b,
                              hq, hkv, hd, ps, npg, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
