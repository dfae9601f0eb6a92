// Device code of the pairwise association check that both launches of
// mithril_mine.cu share: the standalone codes kernel and the fused mining
// run (mine_step_kernel).
//
// The check of row i against row j, bit for bit as
// src/repro/core/mining.py::pairwise_codes: 2 (strong), 1 (weak) or 0.
// Rows are staged in shared memory at an odd stride (stage_stride), so the
// 32 partner rows j = i+1+d that a warp reads at once, one per lane, fall
// in 32 distinct banks; row i is one address for the whole warp (a
// broadcast).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace mithril {

// int32 subtraction with two's complement wrap, as the reference's int32
// arithmetic does
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// |a| in int32: |INT32_MIN| stays INT32_MIN, as the reference's abs gives
__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<uint32_t>(a)) : a;
}

// The shared-memory row stride for S timestamps: S or S + 1, whichever is
// odd, so rows at consecutive indices start in distinct banks.
__host__ __device__ __forceinline__ int stage_stride(int s) { return s | 1; }

// The code of row a against row b (staged timestamps): ``same`` says both
// rows are valid with equal counts, ``live`` = min(count, S) is the number
// of aligned pairs. First-timestamp gap b[0] - a[0] <= delta (the paper's
// inner-loop break) and every aligned pair within delta is weak; an aligned
// difference of exactly 1 makes it strong.
__device__ __forceinline__ int pair_code(const int* a, const int* b, bool same,
                                         int live, int delta) {
  if (!same || wrap_sub(b[0], a[0]) > delta) return 0;
  bool weak = true, strong = false;
#pragma unroll 4
  for (int k = 0; k < live; ++k) {
    const int d = wrap_abs(wrap_sub(b[k], a[k]));
    weak = weak && d <= delta;
    strong = strong || d == 1;
  }
  return weak ? (strong ? 2 : 1) : 0;
}

}  // namespace mithril
