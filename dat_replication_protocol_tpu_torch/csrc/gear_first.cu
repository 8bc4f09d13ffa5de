// Kernel B4: the first gear candidate of every 256-byte group of a tile
// row (route "first").
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/rabin_pallas.py
// gear_first_native (body _kernel_first, :365; wrapper gear_first_pallas
// :447), which walks each row serially in one vector lane with a per-byte
// select on the first hit.  Here the (T, S) rows, contiguous in memory,
// are read as one run of T * S/256 groups, cut into spans of 256 groups
// (a span may cross a row boundary; only the last one is ragged), and
// scanned by the staged scan of gear_staged.cuh: a persistent CTA copies
// each span (and the 64 bytes before it) into a shared-memory ring with
// coalesced cp.async requests while it scans the previous one; thread t
// warms its state on the 64 bytes before its group (the tail of the slot
// before its own, none for a row's group 0) and scans its group from
// shared memory into eight packed hit words held in registers.  The first
// hit (first nonzero word, then its lowest set bit) is taken after the
// scan, off the gear chain, and each thread writes one u32, so a warp's
// stores are 128 contiguous bytes.
//
// Input: rows (T, S/4) uint32 words (int32 storage), S a multiple of 256.
// Output: first (T, S/256) uint32, the group-local offset of the group's
// first candidate or 256 (NO_HIT).  The CTA count and the span count come
// from the wrapper, ops/rabin_cuda.py staged_geometry; dat_gear_first
// returns cudaErrorInvalidValue on a geometry it does not take, else the
// launch's cudaGetLastError().
//
// What bounds it: the 32-bit integer ALU pipe, about 6 instructions per
// byte stepped (chip_smoke.py staged_bound walks its SASS), against 0.33
// ms of bytes per 1 GiB slab (1 byte read, 1/64 byte written).  The design
// pays a 25% warm-up per group to run one chain per group, and takes the
// strided global loads of the one-thread-per-group scan (gear.cuh, kept
// for B3) off the load path.
#include "gear_staged.cuh"

namespace {

namespace st = dat::staged;

__global__ void __launch_bounds__(st::kThreads)
gear_first_kernel(const uint8_t* __restrict__ rows,
                  uint32_t* __restrict__ first, int ng, int ng_all,
                  int total_spans, uint32_t mask) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x;
  const int nspans =
      (total_spans - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  // the rows read as one row of ng_all groups: span i of this CTA starts
  // at group (blockIdx.x + i * gridDim.x) * kThreads
  auto g0 = [&](int i) {
    return static_cast<int>(blockIdx.x + i * gridDim.x) * st::kThreads;
  };
  if (nspans > 0) st::issue_span(smem, rows, g0(0), ng_all);
  st::commit();
#pragma unroll 1
  for (int i = 0; i < nspans; ++i) {
    if (i + 1 < nspans)
      st::issue_span(smem + ((i + 1) % st::kStages) * st::kStageBytes, rows,
                     g0(i + 1), ng_all);
    st::commit();
    st::wait_ring();
    __syncthreads();
    const uint8_t* stage = smem + (i % st::kStages) * st::kStageBytes;
    const int g = g0(i) + t;
    uint64_t h = st::warm(stage + t * st::kSlot + dat::kGroup -
                          dat::kGearWindow);
    if (g % ng == 0) h = 0;  // a row's group 0 starts from the zero state
    uint32_t w[dat::kGroup / dat::kPack];
    st::scan_group(stage + (t + 1) * st::kSlot, h, mask, w);
    if (g < ng_all) first[g] = dat::group_first(w);
    __syncthreads();
  }
}

}  // namespace

extern "C" int dat_gear_first(const void* rows, void* first, int nrows,
                              int row_bytes, int avg_bits, int ctas,
                              int total_spans, void* stream) {
  // the rows are scanned as one row of nrows * row_bytes bytes
  const long long all = static_cast<long long>(nrows) * row_bytes;
  if (row_bytes <= 0 || row_bytes % dat::kGroup || nrows < 1 ||
      all >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = row_bytes / dat::kGroup;
  const int ng_all = static_cast<int>(all / dat::kGroup);
  if (total_spans != (ng_all + st::kThreads - 1) / st::kThreads ||
      ctas < 1 || ctas > total_spans)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(
      gear_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st::kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  gear_first_kernel<<<ctas, st::kThreads, st::kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<uint32_t*>(first), ng,
      ng_all, total_spans, (1u << avg_bits) - 1u);
  return static_cast<int>(cudaGetLastError());
}
