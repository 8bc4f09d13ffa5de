// Kernel B6: B5's per-window first candidate plus an independent
// per-window occupancy fold (route "fused1p").
//
// Replaces the TPU kernel
// dat_replication_protocol_tpu/ops/fused_cdc_hash_pallas.py
// gear_window_first_checked_native (body _kernel_wfirst_checked, :66;
// wrapper gear_window_first_checked :226).  The design is B5's
// (gear_window_first.cu): one thread per (row, window), warm-up over the
// 64 bytes before the window, first-hit tracking in registers.  In the
// same scan every packed hit word is ORed into an occupancy word that
// never reads the first-hit tracking (gear.cuh gear_window<true>).  The
// kernel writes both; the wrapper counts the windows where (occ != 0)
// disagrees with (first != 1 << 30), as the reference wrapper does outside
// its kernel, and the caller refuses a nonzero count.
//
// Input: as B5.  Output: first and occ, each (T * nwin,) uint32 in stream
// order.  dat_gear_window_first_checked returns cudaGetLastError().
//
// What bounds it: as B5 plus one OR per 32 bytes and 4 more bytes written
// per window: the 32-bit integer ALU pipe, about 0.41 ms per 1 GiB slab on
// an H100 at 1.98 GHz by the SASS (chip_smoke.py sass_bound), against 0.32
// ms of bytes.
#include "gear.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gear_window_first_checked_kernel(const uint4* __restrict__ rows,
                                 uint32_t* __restrict__ first,
                                 uint32_t* __restrict__ occ, int nrows,
                                 int row_bytes, int thin_bits, uint32_t mask) {
  const int nwin = (row_bytes - dat::kGroup) >> thin_bits;
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (id >= static_cast<long long>(nrows) * nwin) return;
  const int t = static_cast<int>(id / nwin);
  const int w = static_cast<int>(id % nwin);
  const uint4* row = rows + static_cast<size_t>(t) * (row_bytes / 16);
  first[id] = dat::gear_window<true>(row, w, thin_bits, mask, occ + id);
}

}  // namespace

extern "C" int dat_gear_window_first_checked(const void* rows, void* first,
                                             void* occ, int nrows,
                                             int row_bytes, int avg_bits,
                                             int thin_bits, void* stream) {
  const long long n =
      static_cast<long long>(nrows) * ((row_bytes - dat::kGroup) >> thin_bits);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    gear_window_first_checked_kernel<<<grid, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rows), static_cast<uint32_t*>(first),
        static_cast<uint32_t*>(occ), nrows, row_bytes, thin_bits,
        (1u << avg_bits) - 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
