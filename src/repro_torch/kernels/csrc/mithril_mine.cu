// MITHRIL pairwise association check at the mining barrier.
//
// Replaces the Pallas kernels
//   src/repro/kernels/mithril_mine_batched.py::pairwise_codes_batched_kernel
//     (body _mine_kernel_batched, grid (lane, row-block))
//   src/repro/kernels/mithril_mine.py::pairwise_codes_kernel
//     (body _mine_kernel; the serial wrapper here is the L = 1 launch).
//
// For every lane l and first-ts-sorted mining row i, against rows
// j = i+1 .. i+W: code 2 (strong), 1 (weak) or 0, bit for bit as
// src/repro/core/mining.py::pairwise_codes.
//
// What bounds it on an H100: the work is tiny (paper size 135 lanes x
// 1024 rows x 100 offsets x 8 timestamps of int32 compares) and the
// output, 4 bytes per (row, offset), dominates the bytes; each input row
// is read by up to W+1 (row, offset) pairs. The design keeps that reuse
// out of device memory: a block owns one lane's row block of RB rows,
// stages rows [r0, r0 + RB + W) of timestamps, counts and valid flags in
// shared memory once, and then runs one thread per (row, offset) with the
// offset fastest, so the code writes are coalesced. Rows past N are
// masked here, so the wrapper pads nothing. At the paper's W = 100 and
// S = 8 a block stages (64 + 100) x 10 x 4 B = 6.6 KB.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ int wrap_sub(int a, int b) {
  // int32 subtraction with two's complement wrap, as the reference's
  // int32 arithmetic does
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<uint32_t>(a)) : a;
}

__global__ void pairwise_codes_kernel(const int* __restrict__ ts,
                                      const int* __restrict__ cnt,
                                      const unsigned char* __restrict__ valid,
                                      int* __restrict__ out, int n, int s,
                                      int delta, int window, int rb) {
  extern __shared__ int smem[];
  const int lane = blockIdx.y;
  const int r0 = blockIdx.x * rb;
  const int staged = min(rb + window, n - r0);  // rows this block reads
  const int n_out = min(rb, n - r0);            // rows this block writes
  int* s_ts = smem;                             // (rb + window, s)
  int* s_cnt = s_ts + (rb + window) * s;        // (rb + window,)
  int* s_val = s_cnt + (rb + window);           // (rb + window,)

  const size_t lane_rows = static_cast<size_t>(lane) * n;
  const int* lts = ts + (lane_rows + r0) * s;
  for (int k = threadIdx.x; k < staged * s; k += blockDim.x) s_ts[k] = lts[k];
  for (int k = threadIdx.x; k < staged; k += blockDim.x) {
    s_cnt[k] = cnt[lane_rows + r0 + k];
    s_val[k] = valid[lane_rows + r0 + k] != 0;
  }
  __syncthreads();

  int* lout = out + (lane_rows + r0) * window;
  for (int p = threadIdx.x; p < n_out * window; p += blockDim.x) {
    const int i = p / window;
    const int j = i + 1 + (p - i * window);     // local row of the partner
    int code = 0;
    if (r0 + j < n && s_val[i] && s_val[j] && s_cnt[i] == s_cnt[j]) {
      const int* a = s_ts + i * s;
      const int* b = s_ts + j * s;
      if (wrap_sub(b[0], a[0]) <= delta) {      // paper inner-loop break
        const int live = s_cnt[i];              // aligned pairs only
        bool weak = true, strong = false;
        for (int k = 0; k < s; ++k) {
          if (k < live) {
            const int d = wrap_abs(wrap_sub(b[k], a[k]));
            weak = weak && d <= delta;
            strong = strong || d == 1;
          }
        }
        code = weak ? (strong ? 2 : 1) : 0;
      }
    }
    lout[p] = code;
  }
}

}  // namespace

extern "C" int mithril_pairwise_codes(const int* ts, const int* cnt,
                                      const unsigned char* valid, int* out,
                                      int lanes, int n, int s, int delta,
                                      int window, int rb, void* stream) {
  const int threads = 256;
  dim3 grid((n + rb - 1) / rb, lanes);
  const size_t smem = static_cast<size_t>(rb + window) * (s + 2) * sizeof(int);
  pairwise_codes_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      ts, cnt, valid, out, n, s, delta, window, rb);
  return static_cast<int>(cudaGetLastError());
}
