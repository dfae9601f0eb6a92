// MITHRIL's mining barrier: the pairwise association check, and the whole
// mining run of a lane in one launch.
//
// Replaces the Pallas kernels
//   src/repro/kernels/mithril_mine_batched.py::pairwise_codes_batched_kernel
//     (body _mine_kernel_batched, grid (lane, row-block))
//   src/repro/kernels/mithril_mine.py::pairwise_codes_kernel
//     (body _mine_kernel; here the L = 1 launch of the same kernel).
// pairwise_codes_kernel keeps their contract: for every lane l and
// first-ts-sorted mining row i, against rows j = i+1 .. i+W, code 2
// (strong), 1 (weak) or 0, bit for bit as
// src/repro/core/mining.py::pairwise_codes, written to (L, N, W).
//
// mine_step_kernel is what the main path runs: the mining run of
// src/repro/core/mithril.py::mine_batched for every lane whose need flag is
// set, in place: the stable sort by first timestamp, the codes, the Alg. 2
// selection, the compaction, the fold into the prefetch table and the
// clear. A lane with need == 0 leaves at once, every byte untouched.
//
// What bounds them on an H100. The codes kernel writes 4 bytes per (row,
// offset) and reads each row up to W + 1 times; the bytes of the codes
// bound it, and the host marshalling of a call costs more than the body.
// A mining run reads a mining table (N x (S + 2) ints) and writes a few
// thousand pairs into a prefetch table; as separate ops on the host it was
// a few hundred launches and three host waits. The fused run keeps the
// codes and the pair list in shared memory and never writes the (L, N, W)
// codes; its bytes are the mining table, the prefetch rows the pairs touch
// and the recording table's rec_loc, which the clear walks (512 KiB a lane
// at the paper's 32,768 x 4). Launch latency and a chain of dependent
// shared-memory phases set its time at the serving tier's N = 8.
//
// Design, both kernels: one warp per mining row, the offsets d = 1..W
// across the lanes, 32 at a time, so there is no divide by the window;
// rows staged at an odd stride (mithril_mine_common.cuh) so a warp's 32
// partner rows fall in 32 banks. The codes kernel stages a row block plus
// W rows per block, with enough row blocks to fill the card. The fused
// kernel is one block per lane:
//   1. sort keys (valid ? ts[0] : INT32_MAX) << 32 | row, a bitonic sort
//      in shared memory over the next power of two (padding sorts last),
//      which equals torch.sort(stable=True); the rows are gathered in that
//      order;
//   2. per row, ballots of code > 0 and code == 2 over the offset chunks:
//      the first association (lowest set bit of the first chunk with one)
//      and every strong pair; rows past the first-timestamp gap stop early;
//   3. a block-wide exclusive scan of the per-row counts, then the pairs
//      written row-major with d ascending (core/mining.py::_emit_pairs),
//      the first pairs_cap of them; n_dropped += max(total - cap, 0);
//   4. the fold: add_association(s, d) for every kept pair, then (d, s)
//      when symmetric. An operation touches only the bucket of its source,
//      so operations on different buckets commute: they are sorted by
//      (bucket, list position) and each bucket's run is applied in list
//      order by one thread, the runs in parallel; at the paper's tables
//      almost every run is one operation, so a thread (not a warp) takes a
//      run and scans the bucket's W ways itself;
//   5. the clear of core/mithril.py::_clear_after_mine: every recording
//      slot with rec_loc == 1 loses its key, rec_loc is zeroed (the whole
//      table is walked, as the reference does, writing only what changes),
//      the mining table is reset, mine_fill = 0, n_mines += 1.

#include "mithril_common.cuh"
#include "mithril_mine_common.cuh"

namespace mithril {

// The tables a mining run reads and writes, of one stacked MithrilState,
// lanes first, and the configuration's scalars
// (kernels/mithril_mine_step.py::MineArgs mirrors this layout).
struct MineTables {
  int* mine_block;  // (L, N)
  int* mine_ts;     // (L, N, S)
  int* mine_cnt;    // (L, N)
  int* mine_fill;   // (L,)
  int* rec_key;     // (L, NB, W)
  int* rec_loc;     // (L, NB, W)
  int* pf_key;      // (L, PB, PW)
  int* pf_vals;     // (L, PB, PW, P)
  int* pf_cnt;      // (L, PB, PW)
  int* pf_age;      // (L, PB, PW)
  int* ts;          // (L,)
  int* n_mines;     // (L,)
  int* n_pairs;     // (L,)
  int* n_dropped;   // (L,)
  int lanes, n, s_sup, rec_slots, rec_vec4, pf_nb, pf_ways, plist;
  int r_sup, delta, window, pairs_cap, symmetric;
};
static_assert(sizeof(MineTables) == 168, "MineArgs mirrors this layout");

}  // namespace mithril

namespace {

using mithril::kEmpty;
using mithril::kFullMask;
using mithril::MineTables;
using u64 = unsigned long long;

constexpr int kCodesWarps = 8;         // rows of a codes block in flight
// two blocks an SM (55 registers a thread), so the paper's 135 lanes run
// in one wave on 132 SMs
constexpr int kMineMaxThreads = 512;
constexpr int kWalk = 4;               // int4 loads in flight a thread
constexpr size_t kStaticSmem = 48 * 1024;
constexpr int kScalars = 33;           // 32 warp sums of the scan, stored

// Above 48 KiB a launch needs the kernel's dynamic shared-memory limit
// raised first; ``set`` remembers the largest limit set so far.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* set) {
  if (bytes <= kStaticSmem || bytes <= *set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *set = bytes;
  return err;
}

__global__ void __launch_bounds__(32 * kCodesWarps)
    pairwise_codes_kernel(const int* __restrict__ ts,
                          const int* __restrict__ cnt,
                          const unsigned char* __restrict__ valid,
                          int* __restrict__ out, int n, int s, int delta,
                          int window, int rb) {
  extern __shared__ int codes_smem[];
  const int stride = mithril::stage_stride(s);
  const size_t lane_rows = static_cast<size_t>(blockIdx.y) * n;
  const int r0 = blockIdx.x * rb;
  const int staged = min(rb + window, n - r0);  // rows this block reads
  const int n_out = min(rb, n - r0);            // rows this block writes
  int* s_ts = codes_smem;                       // (rb + window, stride)
  int* s_cnt = s_ts + (rb + window) * stride;   // (rb + window,)
  int* s_val = s_cnt + (rb + window);           // (rb + window,)

  const int* lts = ts + (lane_rows + r0) * s;
  for (int e = threadIdx.x; e < staged * s; e += blockDim.x) {
    const int r = e / s;                        // staging only
    s_ts[r * stride + (e - r * s)] = lts[e];
  }
  for (int r = threadIdx.x; r < staged; r += blockDim.x) {
    s_cnt[r] = cnt[lane_rows + r0 + r];
    s_val[r] = valid[lane_rows + r0 + r] != 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n_out; i += kCodesWarps) {
    const int* a = s_ts + i * stride;
    const int ci = s_cnt[i];
    const bool vi = s_val[i];
    const int live = min(ci, s);
    int* orow = out + (lane_rows + r0 + i) * window;
    for (int d = lane; d < window; d += 32) {   // offset d + 1
      const int j = i + 1 + d;
      orow[d] = j < staged
                    ? mithril::pair_code(a, s_ts + j * stride,
                                         vi && s_val[j] && ci == s_cnt[j],
                                         live, delta)
                    : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// The fused mining run
// ---------------------------------------------------------------------------

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Byte offsets of the fused kernel's shared memory, from the shapes.
struct MineLayout {
  int n2, kept_cap, m2, stride;
  size_t keys, ts, vc, blk, off, keep0, pairs, scal, bytes;
};

__host__ __device__ inline MineLayout mine_layout(int n, int s, int window,
                                                  int pairs_cap,
                                                  int symmetric) {
  MineLayout m;
  m.n2 = next_pow2(n);
  const long long all = static_cast<long long>(n) * window;
  m.kept_cap = static_cast<int>(pairs_cap < all ? pairs_cap : all);
  if (m.kept_cap < 0) m.kept_cap = 0;
  m.m2 = next_pow2(m.kept_cap * (symmetric ? 2 : 1));
  m.stride = mithril::stage_stride(s);
  size_t o = 0;
  m.keys = o;   // sort keys: the rows', later the fold's operations'
  o += sizeof(u64) * (m.n2 > m.m2 ? m.n2 : m.m2);
  m.ts = o;     // (N, stride) timestamps in sorted order
  o += sizeof(int) * static_cast<size_t>(n) * m.stride;
  m.vc = o;     // (N,) valid ? count : -1, in sorted order
  o += sizeof(int) * n;
  m.blk = o;    // (N,) blocks in sorted order
  o += sizeof(int) * n;
  m.off = o;    // (N,) counts by original row; then kept pairs per row,
  o += sizeof(int) * n;  //   then their exclusive offsets
  m.keep0 = o;  // (N,) each row's kept pairs among offsets 1..32
  o += sizeof(int) * n;
  m.pairs = o;  // (kept_cap, 2) the kept (src, dst) pairs
  o += 2 * sizeof(int) * static_cast<size_t>(m.kept_cap);
  m.scal = o;
  o += sizeof(int) * kScalars;
  m.bytes = o;
  return m;
}

// Ascending bitonic sort of a[0..n2) in shared memory (n2 a power of two)
// by the whole block; the keys must be visible to every thread.
__device__ void bitonic_sort(u64* a, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n2 >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 x = a[lo], y = a[hi];
        if ((x > y) == ((lo & k) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Exclusive prefix sums of v[0..n) in place, by the whole block; returns
// the total. ``warp_sums`` holds 32 ints.
__device__ int block_exclusive_scan(int* v, int n, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int b = min(static_cast<int>(threadIdx.x) * per, n);
  const int e = min(b + per, n);
  int local = 0;
  for (int r = b; r < e; ++r) local += v[r];
  int x = local;                                // inclusive, in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - local + (warp ? warp_sums[warp - 1] : 0);
  for (int r = b; r < e; ++r) {
    const int c = v[r];
    v[r] = run;
    run += c;
  }
  const int total = warp_sums[n_warps - 1];
  __syncthreads();
  return total;
}

// The first timestamp of a sorted row, from its sort key.
__device__ __forceinline__ int key_ts0(u64 key) {
  return static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
}

// A lane's mining table after the sort, in shared memory.
struct Staged {
  const int* ts;    // (N, stride)
  const int* vc;    // (N,) valid ? count : -1 (a valid count is >= R >= 1)
  const u64* keys;  // (N,) the sort keys, ascending
  int n, s, stride, delta, window;
};

// Walks row i's partners j = i+1+c0 .. i+W in chunks of 32 across the
// warp and calls visit(keep, c) for the chunk of offsets c+1 .. c+32,
// ``keep`` the ballot of the pairs Alg. 2 keeps there: the row's first
// association (the lowest set bit of the first chunk that has one, while
// ``first_open``) and every strong pair. Stops when visit returns false,
// and at the first chunk whose first partner is past the gap: first
// timestamps ascend with j, and with a[0] >= 0 no wrapped gap can pass the
// check, so no later partner can associate. Every lane of the warp calls
// it, with the same i.
template <class Visit>
__device__ __forceinline__ void select_row(const Staged& st, int i, int lane,
                                           int c0, bool first_open,
                                           Visit visit) {
  const int ca = st.vc[i];
  if (ca < 0) return;                            // not a valid row
  const int* a = st.ts + i * st.stride;
  const int a0 = a[0], live = min(ca, st.s);
  for (int c = c0; c < st.window; c += 32) {
    const int j0 = i + 1 + c;
    if (j0 >= st.n) break;
    if (a0 >= 0 && key_ts0(st.keys[j0]) - a0 > st.delta) break;
    const int j = j0 + lane;
    int code = 0;
    if (c + lane < st.window && j < st.n)
      code = mithril::pair_code(a, st.ts + j * st.stride, st.vc[j] == ca,
                                live, st.delta);
    const unsigned any = __ballot_sync(kFullMask, code > 0);
    unsigned keep = __ballot_sync(kFullMask, code == 2);
    if (first_open && any) {
      keep |= any & (0u - any);
      first_open = false;
    }
    if (!visit(keep, c)) break;
  }
}

// add_association(src -> dst) into bucket b of lane l's prefetch table:
// the hit way, else the first EMPTY way, else the first way of least age;
// the FIFO slot old_cnt mod P unless dst is listed already; age := ts.
// Returns 1 when a pair landed. Bit for bit
// src/repro/core/mithril.py::add_association with valid = True.
__device__ int add_association(const MineTables& t, int l, int b, int src,
                               int dst, int ts) {
  const size_t row = (static_cast<size_t>(l) * t.pf_nb + b) * t.pf_ways;
  int hit = -1, empty = -1, oldest = 0, min_age = 0;
  for (int w = 0; w < t.pf_ways; ++w) {
    const int key = t.pf_key[row + w], age = t.pf_age[row + w];
    if (hit < 0 && key == src) hit = w;
    if (empty < 0 && key == kEmpty) empty = w;
    if (w == 0 || age < min_age) {
      min_age = age;
      oldest = w;
    }
  }
  const size_t slot = row + (hit >= 0 ? hit : (empty >= 0 ? empty : oldest));
  int* vals = t.pf_vals + slot * t.plist;
  int landed = 1;
  if (hit >= 0) {
    bool already = false;
    for (int p = 0; p < t.plist; ++p) already = already || vals[p] == dst;
    if (already) {
      landed = 0;
    } else {
      const int old = t.pf_cnt[slot];
      int pos = old % t.plist;                   // the remainder's sign
      if (pos < 0) pos += t.plist;               // follows the divisor
      vals[pos] = dst;
      t.pf_cnt[slot] = static_cast<int>(static_cast<uint32_t>(old) + 1u);
    }
  } else {
    t.pf_key[slot] = src;
    vals[0] = dst;
    for (int p = 1; p < t.plist; ++p) vals[p] = kEmpty;
    t.pf_cnt[slot] = 1;
  }
  t.pf_age[slot] = ts;
  return landed;
}

__device__ __forceinline__ int bump(int x, int by) {
  return static_cast<int>(static_cast<uint32_t>(x) +
                          static_cast<uint32_t>(by));
}

__global__ void __launch_bounds__(kMineMaxThreads, 2)
    mine_step_kernel(MineTables t, const unsigned char* __restrict__ need) {
  const int l = blockIdx.x;
  if (!need[l]) return;                          // bit-exact no-op
  extern __shared__ __align__(16) unsigned char mine_smem[];
  const MineLayout m =
      mine_layout(t.n, t.s_sup, t.window, t.pairs_cap, t.symmetric);
  u64* keys = reinterpret_cast<u64*>(mine_smem + m.keys);
  int* s_ts = reinterpret_cast<int*>(mine_smem + m.ts);
  int* s_vc = reinterpret_cast<int*>(mine_smem + m.vc);
  int* s_blk = reinterpret_cast<int*>(mine_smem + m.blk);
  int* s_off = reinterpret_cast<int*>(mine_smem + m.off);
  unsigned* s_keep0 = reinterpret_cast<unsigned*>(mine_smem + m.keep0);
  int* s_pairs = reinterpret_cast<int*>(mine_smem + m.pairs);
  int* s_scal = reinterpret_cast<int*>(mine_smem + m.scal);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int n = t.n, s = t.s_sup;
  const size_t lrow = static_cast<size_t>(l) * n;
  if (tid == 0) s_scal[32] = 0;

  // 1. the stable sort by first timestamp; invalid rows (and padding) last
  for (int i = tid; i < m.n2; i += nt) {
    u64 key = ~0ull;
    if (i < n) {
      const int c = t.mine_cnt[lrow + i];
      const bool ok = c >= t.r_sup && c <= s;
      s_off[i] = c;
      const int k0 = ok ? t.mine_ts[(lrow + i) * s] : INT32_MAX;
      key = (static_cast<u64>(static_cast<uint32_t>(k0) ^ 0x80000000u) << 32)
            | static_cast<uint32_t>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  bitonic_sort(keys, m.n2);
  for (int r = tid; r < n; r += nt) {
    const int src = static_cast<int>(static_cast<uint32_t>(keys[r]));
    const int c = s_off[src];
    s_vc[r] = c >= t.r_sup && c <= s ? c : -1;
    s_blk[r] = t.mine_block[lrow + src];
  }
  for (int e = tid; e < n * s; e += nt) {
    const int r = e / s;                         // staging only
    const int src = static_cast<int>(static_cast<uint32_t>(keys[r]));
    s_ts[r * m.stride + (e - r * s)] = t.mine_ts[(lrow + src) * s + e - r * s];
  }
  __syncthreads();

  // 2. the pairs each row keeps, counted; the first chunk's kept for the
  // compaction
  const Staged st{s_ts, s_vc, keys, n, s, m.stride, t.delta, t.window};
  for (int i = warp; i < n; i += n_warps) {
    int count = 0;
    unsigned keep0 = 0;
    select_row(st, i, lane, 0, true, [&](unsigned keep, int c) {
      if (c == 0) keep0 = keep;
      count += __popc(keep);
      return true;
    });
    if (lane == 0) {
      s_off[i] = count;
      s_keep0[i] = keep0;
    }
  }
  __syncthreads();

  // 3. compaction in discovery order: the first pairs_cap pairs
  const int total = block_exclusive_scan(s_off, n, s_scal);
  const int kept = min(total, t.pairs_cap);
  for (int i = warp; i < n; i += n_warps) {
    int run = s_off[i];
    const int end = i + 1 < n ? s_off[i + 1] : total;
    if (run == end || run >= kept) continue;
    const int src = s_blk[i];
    const auto emit = [&](unsigned keep, int c) {
      if ((keep >> lane) & 1u) {
        const int pos = run + __popc(keep & ((1u << lane) - 1u));
        if (pos < kept) {
          s_pairs[2 * pos] = src;
          s_pairs[2 * pos + 1] = s_blk[i + 1 + c + lane];
        }
      }
      run += __popc(keep);
      return run < kept;
    };
    // the first chunk from the count pass; the rest computed again
    const unsigned keep0 = s_keep0[i];
    if (emit(keep0, 0) && run < end)
      select_row(st, i, lane, 32, keep0 == 0, emit);
  }
  __syncthreads();

  // 4. the fold: operations grouped by bucket, list order kept in a group
  const int n_ops = kept * (t.symmetric ? 2 : 1);
  int stored = 0;
  if (n_ops > 0) {
    const int m2 = next_pow2(n_ops);
    for (int o = tid; o < m2; o += nt) {
      u64 key = ~0ull;
      if (o < n_ops) {
        const int k = t.symmetric ? o >> 1 : o;
        const int back = t.symmetric ? o & 1 : 0;
        const int b = mithril::bucket_of(s_pairs[2 * k + back], t.pf_nb);
        key = (static_cast<u64>(b) << 32) | static_cast<uint32_t>(o);
      }
      keys[o] = key;
    }
    __syncthreads();
    bitonic_sort(keys, m2);
    const int ts_now = t.ts[l];
    for (int p = tid; p < n_ops; p += nt) {
      const int b = static_cast<int>(keys[p] >> 32);
      if (p > 0 && static_cast<int>(keys[p - 1] >> 32) == b) continue;
      for (int q = p; q < n_ops && static_cast<int>(keys[q] >> 32) == b; ++q) {
        const int o = static_cast<int>(static_cast<uint32_t>(keys[q]));
        const int k = t.symmetric ? o >> 1 : o;
        const int back = t.symmetric ? o & 1 : 0;
        stored += add_association(t, l, b, s_pairs[2 * k + back],
                                  s_pairs[2 * k + 1 - back], ts_now);
      }
    }
  }
  stored = __reduce_add_sync(kFullMask, stored);
  if (lane == 0 && stored) atomicAdd(&s_scal[32], stored);

  // 5. the clear: stale recording pointers, then the mining table
  int* rk = t.rec_key + static_cast<size_t>(l) * t.rec_slots;
  int* rl = t.rec_loc + static_cast<size_t>(l) * t.rec_slots;
  if (t.rec_vec4) {
    // a round of kWalk loads of four rec_loc slots a thread, a round of
    // the keys those quads must drop, then the stores
    int4* __restrict__ k4 = reinterpret_cast<int4*>(rk);
    int4* __restrict__ l4 = reinterpret_cast<int4*>(rl);
    const int n4 = t.rec_slots >> 2;
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int e0 = tid; e0 < n4; e0 += kWalk * nt) {
      int4 loc[kWalk], key[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int e = e0 + u * nt;
        loc[u] = e < n4 ? l4[e] : zero;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int4 c = loc[u];
        key[u] = (c.x == 1 || c.y == 1 || c.z == 1 || c.w == 1)
                     ? k4[e0 + u * nt] : zero;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int4 c = loc[u];
        if (!(c.x | c.y | c.z | c.w)) continue;
        const int e = e0 + u * nt;
        if (c.x == 1 || c.y == 1 || c.z == 1 || c.w == 1) {
          int4 k = key[u];
          if (c.x == 1) k.x = kEmpty;
          if (c.y == 1) k.y = kEmpty;
          if (c.z == 1) k.z = kEmpty;
          if (c.w == 1) k.w = kEmpty;
          k4[e] = k;
        }
        l4[e] = zero;
      }
    }
  } else {
    for (int e = tid; e < t.rec_slots; e += nt) {
      const int loc = rl[e];
      if (loc == 1) rk[e] = kEmpty;
      if (loc != 0) rl[e] = 0;
    }
  }
  for (int i = tid; i < n; i += nt) {
    t.mine_block[lrow + i] = kEmpty;
    t.mine_cnt[lrow + i] = 0;
  }
  for (int e = tid; e < n * s; e += nt) t.mine_ts[lrow * s + e] = 0;
  __syncthreads();
  if (tid == 0) {
    t.mine_fill[l] = 0;
    t.n_mines[l] = bump(t.n_mines[l], 1);
    t.n_pairs[l] = bump(t.n_pairs[l], s_scal[32]);
    t.n_dropped[l] = bump(t.n_dropped[l], max(total - t.pairs_cap, 0));
  }
}

size_t g_codes_smem = 0;
size_t g_mine_smem = 0;

}  // namespace

extern "C" int mithril_pairwise_codes(const int* ts, const int* cnt,
                                      const unsigned char* valid, int* out,
                                      int lanes, int n, int s, int delta,
                                      int window, int rb, void* stream) {
  const size_t smem = static_cast<size_t>(rb + window) *
                      (mithril::stage_stride(s) + 2) * sizeof(int);
  const cudaError_t err =
      allow_smem(pairwise_codes_kernel, smem, &g_codes_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + rb - 1) / rb, lanes);
  pairwise_codes_kernel<<<grid, 32 * kCodesWarps, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      ts, cnt, valid, out, n, s, delta, window, rb);
  return static_cast<int>(cudaGetLastError());
}

// One block per lane; the lanes whose need flag is 0 leave at once. Raises
// the kernel's shared-memory limit first when the layout needs more than
// 48 KiB (the paper's N = 1024, S = 8 takes about 80 KiB).
extern "C" int mithril_mine_step(const MineTables* t,
                                 const unsigned char* need, void* stream) {
  const MineLayout m =
      mine_layout(t->n, t->s_sup, t->window, t->pairs_cap, t->symmetric);
  // a thread a compare-exchange of the larger sort, or kWalk loads of the
  // recording table's walk each, whichever needs more
  const int sort_threads = (m.n2 > m.m2 ? m.n2 : m.m2) / 2;
  const int walk_threads = (t->rec_slots / 4 + kWalk - 1) / kWalk;
  int threads = sort_threads > walk_threads ? sort_threads : walk_threads;
  threads = threads < 32 ? 32 : (threads > kMineMaxThreads ? kMineMaxThreads
                                                            : threads);
  threads = (threads + 31) & ~31;
  const cudaError_t err = allow_smem(mine_step_kernel, m.bytes, &g_mine_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mine_step_kernel<<<t->lanes, threads, m.bytes,
                     static_cast<cudaStream_t>(stream)>>>(*t, need);
  return static_cast<int>(cudaGetLastError());
}
