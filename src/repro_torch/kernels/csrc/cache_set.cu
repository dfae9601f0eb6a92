// The request step's cache set, one warp a lane: the demand access with
// its statistics and the MITHRIL record event that follows it, and the
// MITHRIL lookup with its prefetch inserts.
//
// Replaces, for configurations without a learned scorer, the plain
// composition of the step (the jnp code of src/repro/cache/base.py and
// src/repro/cache/simulator.py in the reference):
//   cache/base.py::access, insert_prefetch, _insert_rows (scorer None),
//   cache/simulator.py::_count, _apply_prefetches (PF_MITHRIL) and the
//   record gate of the step's first recording segment,
//   core/mithril.py::lookup.
//
// Access kernel, per valid lane: the clock advances by one; the bucket row
// of the packed (7, L, NB, W) tables is read, way t on lane t; the first
// way holding the block hits (a ballot). An LRU hit restamps the way, a
// FIFO hit does not; both clear pf_flag and pf_src and bump freq, and a
// hit on an unused prefetched block counts as used by its source. A miss
// inserts the block: the first empty way, else the first way of least
// stamp; if that way is an unused prefetched block with its second chance
// left, it is refreshed to the clock once (pf_sc = 1) and the first way of
// least stamp after the refresh is evicted instead. Only the ways that
// change are written. The lane's requests, hits, pf_used and
// pf_evicted_unused advance without atomics (one warp owns a lane). Then,
// when the configuration records before its first mining barrier, the
// record event of the same lane runs (mithril_common.cuh::record_event,
// the record kernel's body) on the demanded block (record_on miss: only
// on a miss; all) or on the evicted block (evict), and the barrier's need
// flag is written: mine_fill >= mine_rows on a valid lane.
//
// Prefetch kernel, per valid lane, after the mining barrier: the lane's
// prefetch-table bucket row, the first way whose key is the block, its P
// values (none when no way matches). Each value that is not EMPTY and not
// already cached is inserted as an unused MITHRIL prefetch (flag 1, freq
// 1, assoc 0, stamped with the clock the access left), under the same
// insertion rule, in order: a later value sees the bucket as the earlier
// ones left it. pf_issued[MITHRIL] and pf_evicted_unused advance.
//
// An invalid lane writes nothing but its outputs (no hit, no eviction,
// need 0). Every decision is the plain composition's bit for bit: the
// same hash (murmur3's finalizer on the uint32 bits), first-index and
// first-minimum ties.
//
// What bounds it on an H100: latency, as for the record kernel. A lane
// touches one bucket row (7 x W ints) per insert and a few counters: a
// chain of dependent loads (block -> bucket row -> record tables) and the
// launch are the device time. The step it replaces was ~410 small
// PyTorch kernels.

#include "mithril_common.cuh"

namespace mithril {

constexpr int kKey = 0, kStamp = 1, kFlag = 2, kSc = 3, kSrc = 4, kFreq = 5,
              kAssoc = 6;
constexpr int kPfNone = 0, kPfMithril = 1, kSources = 4;

// A stacked cache state and its statistics, lanes first (kernels/
// cache_set.py::CacheArgs mirrors this layout).
struct CacheTables {
  int* tables;             // (7, L, NB, W): key, stamp, pf_flag, pf_sc,
                           // pf_src, freq, assoc
  int* clock;              // (L,)
  int* requests;           // (L,)
  int* hits;               // (L,)
  int* pf_issued;          // (L, 4)
  int* pf_used;            // (L, 4)
  int* pf_evicted_unused;  // (L, 4)
  int lanes, nb, ways;
};
static_assert(sizeof(CacheTables) == 72, "CacheArgs mirrors this layout");

// The access launch's state: the cache, the MITHRIL record tables (unused
// when record_on is 0) and what the record event needs.
struct AccessArgs {
  CacheTables c;
  RecordTables r;
  int record_on;  // 0 none, 1 miss, 2 evict, 3 all
  int mine_rows;
};
static_assert(sizeof(AccessArgs) == 192, "AccessArgs mirrors this layout");

// The prefetch launch's state: the cache and the MITHRIL prefetch table.
struct PrefetchArgs {
  CacheTables c;
  const int* pf_key;   // (L, PB, PW)
  const int* pf_vals;  // (L, PB, PW, P)
  int pf_nb, pf_ways, plist;
};
static_assert(sizeof(PrefetchArgs) == 104, "PrefetchArgs mirrors this layout");

// Lane t's way of a bucket row (t < W): its seven fields.
struct Way {
  int key, stamp, flag, sc, src, freq;
};

struct Evict {
  int block, unused, src;
};

__device__ __forceinline__ size_t plane(const CacheTables& c) {
  return static_cast<size_t>(c.lanes) * c.nb * c.ways;
}

// The offset of way 0 of lane l's bucket of ``blk`` in each table.
__device__ __forceinline__ size_t cache_row(const CacheTables& c, int l,
                                            int blk) {
  return (static_cast<size_t>(l) * c.nb + bucket_of(blk, c.nb)) * c.ways;
}

__device__ __forceinline__ Way load_cache_way(const CacheTables& c,
                                              size_t row, int t) {
  Way w{kEmpty, INT32_MAX, 0, 0, kPfNone, 0};
  if (t < c.ways) {
    const int* p = c.tables + row + t;
    const size_t n = plane(c);
    w.key = p[kKey * n];
    w.stamp = p[kStamp * n];
    w.flag = p[kFlag * n];
    w.sc = p[kSc * n];
    w.src = p[kSrc * n];
    w.freq = p[kFreq * n];
  }
  return w;
}

// The first way of least value of ``v`` among the W ways.
__device__ __forceinline__ int first_min(int v, bool mine) {
  const int m = __reduce_min_sync(kFullMask, mine ? v : INT32_MAX);
  return __ffs(__ballot_sync(kFullMask, mine && v == m)) - 1;
}

// Inserts ``blk`` into the bucket row at ``row`` whose way t lane t holds
// in ``w``, stamped ``clock``, with pf_flag ``pf`` and pf_src ``src``:
// cache/base.py::_insert_rows with no scorer, then the writes of the ways
// that change. Every lane of the warp calls it; returns the eviction.
__device__ __forceinline__ Evict insert(const CacheTables& c, size_t row,
                                        const Way& w, int t, int blk, int pf,
                                        int src, int clock) {
  const bool mine = t < c.ways;
  const size_t n = plane(c);
  int* p = c.tables + row + t;
  Evict ev{kEmpty, 0, kPfNone};
  const unsigned empty = __ballot_sync(kFullMask, mine && w.key == kEmpty);
  int way;
  if (empty) {
    way = __ffs(empty) - 1;
  } else {
    const int v0 = first_min(w.stamp, mine);
    const bool grant =
        __shfl_sync(kFullMask, w.flag == 1 && w.sc == 0 ? 1 : 0, v0) != 0;
    way = v0;
    if (grant) {
      // second chance: the victim is refreshed once, the next evicts
      way = first_min(t == v0 ? clock : w.stamp, mine);
      if (t == v0 && t != way) {
        p[kStamp * n] = clock;
        p[kSc * n] = 1;
      }
    }
    ev.block = __shfl_sync(kFullMask, w.key, way);
    ev.unused = __shfl_sync(kFullMask, w.flag, way) == 1 ? 1 : 0;
    ev.src = __shfl_sync(kFullMask, w.src, way);
  }
  if (t == way) {
    p[kKey * n] = blk;
    p[kStamp * n] = clock;
    p[kFlag * n] = pf;
    p[kSc * n] = 0;
    p[kSrc * n] = src;
    p[kFreq * n] = 1;
    p[kAssoc * n] = 0;
  }
  return ev;
}

}  // namespace mithril

namespace {

using namespace mithril;
constexpr int kWarpsPerBlock = 4;

// outputs, lanes last: ints (3, L) used_src, evicted block, evicted pf_src;
// flags (2, L) evicted-unused, need; hit (L,)
template <bool kLru>
__global__ void cache_access_kernel(AccessArgs a,
                                    const int* __restrict__ block,
                                    const bool* __restrict__ valid,
                                    bool* __restrict__ hit_out,
                                    int* __restrict__ ints,
                                    bool* __restrict__ flags) {
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const CacheTables& c = a.c;
  if (l >= c.lanes) return;                     // whole warp leaves together
  const int lanes = c.lanes;
  // round 1: the lane's flag, block and clock
  const bool en = valid[l];
  const int blk = block[l];
  const int clock = c.clock[l] + 1;
  bool hit = false;
  int used = kPfNone;
  Evict ev{kEmpty, 0, kPfNone};
  if (en) {
    // round 2: the bucket row
    const size_t row = cache_row(c, l, blk);
    const Way w = load_cache_way(c, row, t);
    const unsigned hm = __ballot_sync(kFullMask, t < c.ways && w.key == blk);
    if (hm) {
      hit = true;
      const int way = __ffs(hm) - 1;
      const int flag = __shfl_sync(kFullMask, w.flag, way);
      const int src = __shfl_sync(kFullMask, w.src, way);
      used = flag == 1 ? src : kPfNone;
      if (t == way) {
        int* p = c.tables + row + t;
        const size_t n = plane(c);
        if (kLru) p[kStamp * n] = clock;
        p[kFlag * n] = 0;
        p[kSrc * n] = kPfNone;
        p[kFreq * n] = w.freq + 1;
      }
    } else {
      ev = insert(c, row, w, t, blk, 0, kPfNone, clock);
    }
    if (t == 0) {
      c.clock[l] = clock;
      c.requests[l] += 1;
      if (hit) c.hits[l] += 1;
      if (used != kPfNone) c.pf_used[l * kSources + used] += 1;
      if (ev.unused) c.pf_evicted_unused[l * kSources + ev.src] += 1;
    }
  }
  if (a.record_on != 0) {
    const bool by_evict = a.record_on == 2;
    const bool rec_en = a.record_on == 1   ? en && !hit
                        : by_evict         ? ev.block != kEmpty
                                           : en;
    const int fill =
        record_event(a.r, l, by_evict ? ev.block : blk, rec_en, t);
    if (t == 0) flags[lanes + l] = en && fill >= a.mine_rows;
  }
  if (t == 0) {
    hit_out[l] = hit;
    ints[l] = used;
    ints[lanes + l] = ev.block;
    ints[2 * lanes + l] = ev.src;
    flags[l] = ev.unused != 0;
  }
}

__global__ void mithril_prefetch_kernel(PrefetchArgs a,
                                        const int* __restrict__ block,
                                        const bool* __restrict__ valid) {
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const CacheTables& c = a.c;
  if (l >= c.lanes || !valid[l]) return;        // whole warp leaves together
  const int blk = block[l];
  const int clock = c.clock[l];
  // the lookup: the first way of the prefetch bucket holding the block
  const size_t prow =
      (static_cast<size_t>(l) * a.pf_nb + bucket_of(blk, a.pf_nb)) *
      a.pf_ways;
  const int pway = warp_first_hit(a.pf_key + prow, a.pf_ways, blk, t);
  if (pway < 0) return;                         // P times EMPTY: a no-op
  const int* vals = a.pf_vals + (prow + pway) * a.plist;
  const int mine_val = t < a.plist ? vals[t] : kEmpty;
  int issued = 0;
  for (int k = 0; k < a.plist; ++k) {
    const int cand = k < 32 ? __shfl_sync(kFullMask, mine_val, k) : vals[k];
    if (cand == kEmpty) continue;
    // the row as the earlier candidates left it (lane t reads back its
    // own writes to way t)
    const size_t row = cache_row(c, l, cand);
    const Way w = load_cache_way(c, row, t);
    if (__ballot_sync(kFullMask, t < c.ways && w.key == cand)) continue;
    const Evict ev = insert(c, row, w, t, cand, 1, kPfMithril, clock);
    ++issued;
    if (t == 0 && ev.unused) c.pf_evicted_unused[l * kSources + ev.src] += 1;
  }
  if (t == 0 && issued) c.pf_issued[l * kSources + kPfMithril] += issued;
}

int grid_of(int lanes) {
  return (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int mithril_cache_access(const AccessArgs* a, const int* block,
                                    const bool* valid, bool* hit, int* ints,
                                    bool* flags, int lru, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(a->c.lanes);
  if (lru)
    cache_access_kernel<true><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        *a, block, valid, hit, ints, flags);
  else
    cache_access_kernel<false><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        *a, block, valid, hit, ints, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mithril_prefetch(const PrefetchArgs* a, const int* block,
                                const bool* valid, void* stream) {
  mithril_prefetch_kernel<<<grid_of(a->c.lanes), 32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a, block,
                                                                 valid);
  return static_cast<int>(cudaGetLastError());
}
