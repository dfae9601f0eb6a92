// Device code that mithril_record.cu, hash_lookup.cu and cache_set.cu share:
// the bucket hash, the warp-wide first-hit probe of a set-associative table,
// and the MITHRIL record event of one lane on one warp (record_event).
//
// The record event is split in two so that a caller can put its own loads
// into the same round as the event's bucket row (mithril_record.cu's miss
// kernel probes the prefetch table there):
//   load_way      the bucket row: lane t < W loads key, age, cnt, loc and
//                 row of way t, one round of independent loads;
//   record_commit picks the way with ballots, takes the chosen way's
//                 cnt/loc/row from its lane with shuffles, loads what the
//                 event still needs (the old R-slot row of a migration,
//                 the count of an updated mining row: one more round) and
//                 writes the touched rows in place.
// Counting the lane's block, ts and mine_fill, the chain of dependent
// global loads is block -> bucket row -> mining row: three rounds.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace mithril {

constexpr int kEmpty = -1;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// murmur3's finalizer on uint32 (logical shifts, as the reference's uint32
// cast gives)
__device__ __forceinline__ uint32_t mix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return k;
}

// mix32(key) & (nb - 1); nb is a power of two
__device__ __forceinline__ int bucket_of(int key, int nb) {
  return static_cast<int>(mix32(static_cast<uint32_t>(key)) &
                          static_cast<uint32_t>(nb - 1));
}

// The first of the ``ways`` keys of ``row`` equal to ``key``, or -1; the
// ways sit across the warp, 32 at a time. A key equal to EMPTY matches an
// empty way, as the reference's compare does. Every lane of the warp calls
// it and gets the same answer.
__device__ __forceinline__ int warp_first_hit(const int* row, int ways,
                                              int key, int lane) {
  for (int base = 0; base < ways; base += 32) {
    const int w = base + lane;
    const unsigned hit = __ballot_sync(kFullMask, w < ways && row[w] == key);
    if (hit) return base + __ffs(hit) - 1;
  }
  return -1;
}

// The record path's tables of one stacked MithrilState, lanes first: the
// 11 int32 leaves and their dimensions. The host binds it once per state
// (kernels/mithril_record.py::RecordArgs mirrors this layout).
struct RecordTables {
  int* rec_key;     // (L, NB, W)
  int* rec_ts;      // (L, NB, W, R)
  int* rec_cnt;     // (L, NB, W)
  int* rec_age;     // (L, NB, W)
  int* rec_loc;     // (L, NB, W)
  int* rec_row;     // (L, NB, W)
  int* mine_block;  // (L, Nm)
  int* mine_ts;     // (L, Nm, S)
  int* mine_cnt;    // (L, Nm)
  int* mine_fill;   // (L,)
  int* ts;          // (L,)
  int lanes, nb, ways, r_sup, nm, s_sup;
};
static_assert(sizeof(RecordTables) == 112, "RecordArgs mirrors this layout");

// Lane t's way of the bucket (t < W); other lanes hold a way that matches
// nothing.
struct WayLoad {
  int key, age, cnt, loc, row;
};

__device__ __forceinline__ size_t bucket_base(const RecordTables& t, int l,
                                              int blk) {
  return (static_cast<size_t>(l) * t.nb + bucket_of(blk, t.nb)) * t.ways;
}

__device__ __forceinline__ WayLoad load_way(const RecordTables& t,
                                            size_t bucket, int lane) {
  WayLoad w{kEmpty, INT32_MAX, 0, 0, 0};
  if (lane < t.ways) {
    const size_t s = bucket + lane;
    w.key = t.rec_key[s];
    w.age = t.rec_age[s];
    w.cnt = t.rec_cnt[s];
    w.loc = t.rec_loc[s];
    w.row = t.rec_row[s];
  }
  return w;
}

// The rest of lane l's record event of ``blk`` at timestamp ``ts`` with
// ``fill`` mining rows in use, after load_way: hit way or victim (first
// EMPTY way, else the first way of minimal rec_age), the R-slot stamp,
// migration to the mining table at cnt >= R, the S-slot append or frequent
// mark of a mining-resident block, the mine_fill / ts bump. Bit for bit
// src/repro/core/mithril.py::record_event. Every lane of the warp calls it;
// returns mine_fill after the event.
__device__ __forceinline__ int record_commit(const RecordTables& t, int l,
                                             int blk, int ts, int fill,
                                             size_t bucket, const WayLoad& w,
                                             int lane) {
  const bool my_way = lane < t.ways;
  const unsigned hit = __ballot_sync(kFullMask, my_way && w.key == blk);
  const unsigned empty = __ballot_sync(kFullMask, my_way && w.key == kEmpty);
  const int min_age = __reduce_min_sync(kFullMask, my_way ? w.age : INT32_MAX);
  const unsigned oldest = __ballot_sync(kFullMask, my_way && w.age == min_age);
  const bool found = hit != 0;
  const int way = (found ? __ffs(hit) : (empty ? __ffs(empty) : __ffs(oldest)))
                  - 1;
  const int old_cnt = __shfl_sync(kFullMask, w.cnt, way);
  const int old_loc = __shfl_sync(kFullMask, w.loc, way);
  const int old_row = __shfl_sync(kFullMask, w.row, way);

  const bool is_new = !found;
  const bool is_rec = found && old_loc != 1;
  const bool is_upd = found && old_loc == 1;
  const int cnt_val = is_new ? 1 : old_cnt + (is_rec ? 1 : 0);
  // mining-ready: R timestamps accumulated (at once, when R == 1)
  const bool migrate =
      (is_rec && cnt_val >= t.r_sup) || (is_new && t.r_sup == 1);
  // the record/maybe_mine contract keeps fill < Nm; a row out of range is
  // dropped, as the reference's scatter drops it
  const int m = migrate ? fill : (is_upd ? old_row : -1);
  const bool m_ok = m >= 0 && m < t.nm;
  const size_t slot = bucket + way;
  const size_t mrow = static_cast<size_t>(l) * t.nm + (m_ok ? m : 0);
  int* ts_row = t.rec_ts + slot * t.r_sup;
  int* mts = t.mine_ts + mrow * t.s_sup;
  // the second round: the updated mining row's count (lane 0 writes the
  // row's scalars) ...
  const int old_mcnt = (lane == 0 && m_ok && is_upd) ? t.mine_cnt[mrow] : 0;

  // ... and the old R-slot row of a migration, lane k holding slot k.
  // R-slot stamp: a new block gets (ts, 0, ...); a recording block its
  // slot old_cnt; a migration copies the new row to the mining row.
  for (int k = lane; k < t.r_sup; k += 32) {
    const bool stamp = is_new ? k == 0 : k == old_cnt;
    const int v = stamp ? ts : (is_new ? 0 : (migrate ? ts_row[k] : 0));
    if (is_new || (is_rec && stamp)) ts_row[k] = v;
    if (migrate && m_ok) mts[k] = v;
  }

  if (lane == 0) {
    if (is_new) {
      t.rec_key[slot] = blk;
      t.rec_age[slot] = ts;
    }
    t.rec_cnt[slot] = cnt_val;
    t.rec_loc[slot] = migrate ? 1 : (is_new ? 0 : old_loc);
    if (migrate) t.rec_row[slot] = fill;
    if (m_ok) {
      if (migrate) {
        t.mine_block[mrow] = blk;
        t.mine_cnt[mrow] = t.r_sup;
      } else if (old_mcnt < t.s_sup) {       // S-slot append
        if (old_mcnt >= 0) mts[old_mcnt] = ts;
        t.mine_cnt[mrow] = old_mcnt + 1;
      } else {
        t.mine_cnt[mrow] = t.s_sup + 1;      // frequent: excluded
      }
    }
    if (migrate) t.mine_fill[l] = fill + 1;
    t.ts[l] = ts + 1;
  }
  return migrate ? fill + 1 : fill;
}

// One record event of lane l: ``blk`` when ``en``, else a bit-exact no-op.
// The body of mithril_record.cu's record kernel, which cache_set.cu's access
// kernel runs too after the demand access. Every lane of the warp calls it;
// returns mine_fill after the event.
__device__ __forceinline__ int record_event(const RecordTables& t, int l,
                                            int blk, bool en, int lane) {
  // round 1 (with the caller's loads of blk and en): ts and mine_fill
  const int ts = t.ts[l];
  const int fill = t.mine_fill[l];
  if (!en) return fill;
  // round 2: the bucket row; round 3 inside record_commit
  const size_t bucket = bucket_base(t, l, blk);
  const WayLoad w = load_way(t, bucket, lane);
  return record_commit(t, l, blk, ts, fill, bucket, w, lane);
}

}  // namespace mithril
