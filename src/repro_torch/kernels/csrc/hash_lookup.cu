// Batched MITHRIL prefetch-table probe.
//
// Replaces the Pallas kernel
//   src/repro/kernels/hash_lookup.py::hash_lookup_kernel
//     (body _lookup_kernel, wrapper ops.py::prefetch_lookup).
//
// For every query q: bucket = mix32(q) & (NB - 1) with the murmur3
// finalizer on uint32 (logical shifts, as the reference's uint32 cast
// gives), then the first of the W ways whose key equals q; its P values
// are the result, else P times EMPTY (-1). A query equal to EMPTY
// matches an empty way and returns that way's values, as the reference
// does: no special case.
//
// What bounds it on an H100: nothing but latency. Each query reads one
// bucket row of W keys and, on a hit, P values of one way: a dependent
// chain of two loads of a few bytes. On the serving path Q = 1, so one
// launch of one thread is the whole call. One thread per query reads
// the row straight from device memory; the tables stay where they are
// (the Pallas BlockSpecs copy both whole tables into VMEM per grid
// step, which Hopper does not need), and no padding of Q is needed.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return k;
}

__global__ void hash_lookup_kernel(const int* __restrict__ queries,
                                   const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   int* __restrict__ out, int n_q, int nb,
                                   int ways, int plist) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int q = queries[i];
  const int b = static_cast<int>(mix32(static_cast<uint32_t>(q)) &
                                 static_cast<uint32_t>(nb - 1));
  const int* row = keys + static_cast<size_t>(b) * ways;
  int way = -1;
  for (int w = 0; w < ways; ++w) {
    if (row[w] == q) {                      // first hit way, as argmax
      way = w;
      break;
    }
  }
  int* o = out + static_cast<size_t>(i) * plist;
  if (way < 0) {
    for (int p = 0; p < plist; ++p) o[p] = -1;
  } else {
    const int* v = vals + (static_cast<size_t>(b) * ways + way) * plist;
    for (int p = 0; p < plist; ++p) o[p] = v[p];
  }
}

}  // namespace

extern "C" int mithril_hash_lookup(const int* queries, const int* keys,
                                   const int* vals, int* out, int n_q,
                                   int nb, int ways, int plist,
                                   void* stream) {
  const int threads = 128;
  const int blocks = (n_q + threads - 1) / threads;
  hash_lookup_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      queries, keys, vals, out, n_q, nb, ways, plist);
  return static_cast<int>(cudaGetLastError());
}
