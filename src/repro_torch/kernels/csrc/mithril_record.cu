// The fused MITHRIL record event, one per lane, updated in place; and the
// serving tier's miss: one lane's record event with the prefetch-table
// probe of the same block, in one launch.
//
// Replaces the Pallas kernel
//   src/repro/kernels/mithril_record.py::record_step_kernel
//     (body _record_kernel; wrapper src/repro/kernels/ops.py::mithril_record_fused).
// The miss launch also does the work of
//   src/repro/kernels/hash_lookup.py::hash_lookup_kernel
// for the one query of a miss (the tier's record + lookup,
// src/repro/cache/tiered.py::_mithril_on_miss).
//
// Per lane: mix32 bucket probe of the (NB, W) recording table, hit way or
// victim, the R-slot stamp, migration to the mining table at cnt >= R, the
// S-slot append / frequent mark of a mining-resident block, and the
// mine_fill / ts bump (mithril_common.cuh). enabled == 0 leaves every byte
// as it was. Bit for bit src/repro/core/mithril.py::record_event.
//
// What bounds it on an H100: latency. An event touches one bucket (5 x W
// ints), one R-slot row and one S-slot mining row, a few hundred bytes; the
// launch (about a microsecond on the card) and the chain of dependent
// loads are the whole device time, and the host's work around the launch
// costs more than both. So: one warp per lane, the ways across the warp,
// three rounds of dependent loads (block -> bucket row -> mining row), and
// every table updated in place (the Pallas kernel's whole-table
// copy-through, needed only because its blocks lived in VMEM, is gone).
// The host binds a state's pointers and dimensions once (RecordTables) and
// passes them by address: a launch takes four arguments.
//
// The miss kernel (one warp): the page comes by value, so the recording
// table's bucket row, the prefetch table's key row, ts and mine_fill load
// in one round; the hit way's P values and the event's mining row in the
// next. It writes [need, cand_0 .. cand_{P-1}] to ``out`` (pinned host
// memory mapped into the card's address space, or device memory):
// need = mine_fill after the event >= mine_rows. The event never writes
// the prefetch table, so the probe equals the lookup after the record
// whenever no mining runs; when need is 1 the host mines and probes again.

#include "mithril_common.cuh"

namespace mithril {

// The serving tier's miss: a one-lane state's record tables, its prefetch
// table and the result buffer (kernels/mithril_record.py::MissArgs mirrors
// this layout).
struct MissArgs {
  RecordTables rec;      // lanes == 1
  const int* pf_key;     // (PB, PW) of lane 0
  const int* pf_vals;    // (PB, PW, P) of lane 0
  int* out;              // (1 + P,): need, then the P candidates
  int pf_nb, pf_ways, plist, mine_rows;
};
static_assert(sizeof(MissArgs) == 152, "MissArgs mirrors this layout");

}  // namespace mithril

namespace {

using mithril::MissArgs;
using mithril::RecordTables;
constexpr int kWarpsPerBlock = 4;

__global__ void record_kernel(RecordTables t, const int* __restrict__ block,
                              const void* __restrict__ enabled,
                              int enabled_is_bool) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (l >= t.lanes) return;                     // whole warp leaves together
  const int en = enabled_is_bool
                     ? static_cast<const unsigned char*>(enabled)[l]
                     : static_cast<const int*>(enabled)[l];
  mithril::record_event(t, l, block[l], en != 0, lane);
}

__global__ void miss_kernel(MissArgs a, int page) {
  const int lane = threadIdx.x;
  const RecordTables& t = a.rec;
  // round 1: ts, mine_fill, the recording table's bucket row and the
  // prefetch table's key row (its first 32 ways)
  const int ts = t.ts[0];
  const int fill = t.mine_fill[0];
  const size_t bucket = mithril::bucket_base(t, 0, page);
  const mithril::WayLoad w = mithril::load_way(t, bucket, lane);
  const int pb = mithril::bucket_of(page, a.pf_nb);
  const int way = mithril::warp_first_hit(
      a.pf_key + static_cast<size_t>(pb) * a.pf_ways, a.pf_ways, page, lane);
  // round 2: the hit way's values (issued here, stored after the event)
  // beside the event's own second round
  const int* vals = a.pf_vals + (static_cast<size_t>(pb) * a.pf_ways + way)
                                    * a.plist;
  const int v0 = (way >= 0 && lane < a.plist) ? vals[lane] : mithril::kEmpty;
  const int fill_after =
      mithril::record_commit(t, 0, page, ts, fill, bucket, w, lane);
  if (lane < a.plist) a.out[1 + lane] = v0;
  for (int p = lane + 32; p < a.plist; p += 32)
    a.out[1 + p] = way >= 0 ? vals[p] : mithril::kEmpty;
  if (lane == 0) a.out[0] = fill_after >= a.mine_rows ? 1 : 0;
}

}  // namespace

extern "C" int mithril_record_step(const RecordTables* t, const int* block,
                                   const void* enabled, int enabled_is_bool,
                                   void* stream) {
  const int threads = 32 * kWarpsPerBlock;
  const int grid = (t->lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  record_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *t, block, enabled, enabled_is_bool);
  return static_cast<int>(cudaGetLastError());
}

// Launches the miss kernel, then records ``done`` (a CUDA event, or null)
// on the same stream for the host to wait on; it does not wait itself.
extern "C" int mithril_miss_step(const MissArgs* a, int page, void* stream,
                                 void* done) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  miss_kernel<<<1, 32, 0, s>>>(*a, page);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && done)
    err = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return static_cast<int>(err);
}

// The address under which the card reaches ``p``: device memory as it is,
// pinned host memory through its mapping (the same address under unified
// addressing). Returns a CUDA error for memory the card cannot reach.
extern "C" int mithril_device_address(void* p, void** dev) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *dev = attr.devicePointer;
  return *dev ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
