// The fused MITHRIL record event, one per lane, updated in place.
//
// Replaces the Pallas kernel
//   src/repro/kernels/mithril_record.py::record_step_kernel
//     (body _record_kernel; wrapper src/repro/kernels/ops.py::mithril_record_fused).
//
// Per lane: mix32 bucket probe of the (NB, W) recording table, hit way or
// victim (first EMPTY way, else the first way of minimal rec_age), the
// R-slot timestamp stamp, migration to the mining table at cnt >= R, the
// S-slot append / frequent mark of a mining-resident block, and the
// mine_fill / ts bump. enabled == 0 leaves every byte as it was. Bit for
// bit src/repro/core/mithril.py::record_event.
//
// What bounds it on an H100: per lane it touches one bucket (5 x W ints),
// one R-slot row and one S-slot mining row, a few hundred bytes, so at
// the sweep's 16..135 lanes the launch itself (a few microseconds) is the
// bound, not bytes or operations. The design therefore does the least
// per launch: one warp per lane with the W ways across the warp's
// threads (ballots give the first hit / first empty way, a warp min the
// oldest way), then one thread writes the touched rows in place. The
// Pallas kernel's whole-table copy-through (needed only because its
// blocks lived in VMEM) is gone: nothing else of the tables is read.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kEmpty = -1;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return k;
}

__global__ void record_kernel(const int* __restrict__ block,
                              const int* __restrict__ enabled,
                              int* rec_key, int* rec_ts, int* rec_cnt,
                              int* rec_age, int* rec_loc, int* rec_row,
                              int* mine_block, int* mine_ts, int* mine_cnt,
                              int* mine_fill, int* ts_arr, int lanes,
                              int nb, int ways, int r_sup, int nm,
                              int s_sup) {
  const int t = threadIdx.x & 31;
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (l >= lanes) return;                       // whole warp leaves together
  const bool en = enabled[l] != 0;
  if (!en) return;                              // bit-exact no-op

  const int blk = block[l];
  const int ts = ts_arr[l];
  const int fill = mine_fill[l];
  const int b = static_cast<int>(mix32(static_cast<uint32_t>(blk)) &
                                 static_cast<uint32_t>(nb - 1));
  const size_t bucket = (static_cast<size_t>(l) * nb + b) * ways;

  // --- hashindex.locate across the warp: thread t holds way t ---
  const bool mine_way = t < ways;
  const int key_t = mine_way ? rec_key[bucket + t] : 0;
  const int age_t = mine_way ? rec_age[bucket + t] : INT32_MAX;
  const unsigned hit = __ballot_sync(0xFFFFFFFFu, mine_way && key_t == blk);
  const unsigned empty = __ballot_sync(0xFFFFFFFFu, mine_way && key_t == kEmpty);
  const int min_age = __reduce_min_sync(0xFFFFFFFFu, age_t);
  const unsigned oldest = __ballot_sync(0xFFFFFFFFu, mine_way && age_t == min_age);
  if (t != 0) return;

  const bool found = hit != 0;
  const int w = found ? __ffs(hit) - 1
                      : (empty ? __ffs(empty) - 1 : __ffs(oldest) - 1);
  const size_t slot = bucket + w;
  const int old_cnt = rec_cnt[slot];
  const int old_loc = rec_loc[slot];
  const int old_row = rec_row[slot];
  const bool is_new = !found;
  const bool is_rec = found && old_loc != 1;
  const bool is_upd = found && old_loc == 1;

  // --- recording-table stamp (one R-slot row) ---
  int* ts_row = rec_ts + slot * r_sup;
  if (is_new) {
    ts_row[0] = ts;
    for (int k = 1; k < r_sup; ++k) ts_row[k] = 0;
  } else if (is_rec) {
    for (int k = 0; k < r_sup; ++k)
      if (k == old_cnt) ts_row[k] = ts;
  }
  const int cnt_val = is_new ? 1 : old_cnt + (is_rec ? 1 : 0);
  bool migrate = is_rec && cnt_val >= r_sup;
  if (r_sup == 1) migrate = migrate || is_new;  // born mining-ready

  if (is_new) {
    rec_key[slot] = blk;
    rec_age[slot] = ts;
  }
  rec_cnt[slot] = cnt_val;
  rec_loc[slot] = migrate ? 1 : (is_new ? 0 : old_loc);
  if (migrate) rec_row[slot] = fill;

  // --- mining-table insert (one S-slot row at m) ---
  // the record/maybe_mine contract keeps fill < nm; a row out of range
  // is dropped, as the reference's scatter drops it
  const int m = migrate ? fill : (is_upd ? old_row : -1);
  if (m >= 0 && m < nm) {
    const size_t row = static_cast<size_t>(l) * nm + m;
    int* mts = mine_ts + row * s_sup;
    if (migrate) {
      mine_block[row] = blk;
      for (int k = 0; k < r_sup && k < s_sup; ++k) mts[k] = ts_row[k];
      mine_cnt[row] = r_sup;
    } else {
      const int old_mcnt = mine_cnt[row];
      if (old_mcnt < s_sup) {
        for (int k = 0; k < s_sup; ++k)
          if (k == old_mcnt) mts[k] = ts;
        mine_cnt[row] = old_mcnt + 1;
      } else {
        mine_cnt[row] = s_sup + 1;              // frequent: excluded
      }
    }
  }
  if (migrate) mine_fill[l] = fill + 1;
  ts_arr[l] = ts + 1;
}

}  // namespace

extern "C" int mithril_record_step(const int* block, const int* enabled,
                                   int* rec_key, int* rec_ts, int* rec_cnt,
                                   int* rec_age, int* rec_loc, int* rec_row,
                                   int* mine_block, int* mine_ts,
                                   int* mine_cnt, int* mine_fill, int* ts,
                                   int lanes, int nb, int ways, int r_sup,
                                   int nm, int s_sup, void* stream) {
  const int threads = 32 * kWarpsPerBlock;
  const int grid = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  record_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      block, enabled, rec_key, rec_ts, rec_cnt, rec_age, rec_loc, rec_row,
      mine_block, mine_ts, mine_cnt, mine_fill, ts, lanes, nb, ways, r_sup,
      nm, s_sup);
  return static_cast<int>(cudaGetLastError());
}
