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
// chain of two loads of a few bytes (key row -> values). So one warp per
// query: the ways sit across the lanes (32 at a time for W > 32), a ballot
// and __ffs pick the first hit way, and lanes p < P copy the values (32 at
// a time for P > 32). The tables stay where they are (the Pallas
// BlockSpecs copy both whole tables into VMEM per grid step, which Hopper
// does not need), and any Q is taken without padding. On the serving path
// the tier probes inside its miss launch (mithril_record.cu) and calls
// this kernel only after a mining run.

#include "mithril_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void hash_lookup_kernel(const int* __restrict__ queries,
                                   const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   int* __restrict__ out, int n_q, int nb,
                                   int ways, int plist) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_q) return;                         // whole warp leaves together
  const int q = queries[i];
  const int b = mithril::bucket_of(q, nb);
  const int way = mithril::warp_first_hit(keys + static_cast<size_t>(b) * ways,
                                          ways, q, lane);
  const int* v = vals + (static_cast<size_t>(b) * ways + way) * plist;
  int* o = out + static_cast<size_t>(i) * plist;
  for (int p = lane; p < plist; p += 32) o[p] = way >= 0 ? v[p] : mithril::kEmpty;
}

}  // namespace

extern "C" int mithril_hash_lookup(const int* queries, const int* keys,
                                   const int* vals, int* out, int n_q,
                                   int nb, int ways, int plist,
                                   void* stream) {
  const int warps = n_q < kWarpsPerBlock ? n_q : kWarpsPerBlock;
  const int blocks = (n_q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hash_lookup_kernel<<<blocks, 32 * warps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      queries, keys, vals, out, n_q, nb, ways, plist);
  return static_cast<int>(cudaGetLastError());
}
