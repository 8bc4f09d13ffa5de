// Kernel B6: the first gear candidate of every 2^thin_bits-byte window of
// a tile row's payload plus an independent per-window occupancy fold
// (route "fused1p").
//
// Replaces the TPU kernel
// dat_replication_protocol_tpu/ops/fused_cdc_hash_pallas.py
// gear_window_first_checked_native (body _kernel_wfirst_checked, :66;
// wrapper gear_window_first_checked :226), which carries one window's
// first-hit tracking and occupancy in VMEM scratch across grid steps, one
// vector lane per row.  Here one thread owns one (row, window) and runs
// B5's window scan (gear.cuh gear_window_scan) with the occupancy fold:
// it replays the 64 bytes before the window and scans the window's
// 2^thin_bits / 256 groups from global memory (group 0 of a row is
// warm-up and belongs to no window), each group's eight packed hit words
// into registers.  After each group it takes two things from its words,
// on separate paths: the group's first hit (first nonzero word, lowest
// set bit), kept if the window has none yet, and their OR into the
// window's occupancy word, which never reads the first-hit path.  The
// wrapper counts the windows where (occ != 0) disagrees with (first !=
// 1 << 30), as the reference wrapper does outside its kernel, and the
// caller refuses a nonzero count.
//
// Input: rows (T, S/4) uint32 words (int32 storage), (S - 256) a multiple
// of 2^thin_bits, thin_bits >= 8.  Output: first and occ, each (T * nwin,)
// uint32 in stream order.  dat_gear_window_first_checked returns
// cudaGetLastError().
//
// What bounds it: the 32-bit integer ALU pipe, about 6 instructions per
// byte stepped (chip_smoke.py sass_bound walks its SASS), against 0.32 ms
// of bytes per 1 GiB slab.  With the select and the fold both after the
// group, nothing but the gear chain sits between the 16-byte loads, and
// ptxas can issue them well ahead of their use, off the chain.  At 2 KiB
// windows the warm-up adds 3% more steps.
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
  first[id] = dat::gear_window_scan<true>(row, w, thin_bits, mask, occ + id);
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
