// Kernel B5: the first gear candidate of every 2^thin_bits-byte window of
// a tile row's payload (route "fused").
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/rabin_pallas.py
// gear_window_first_native (body _kernel_wfirst, :190; wrapper
// gear_window_first_pallas :342).  The TPU kernel carries the first-hit
// tracking of one window in VMEM scratch across grid steps, one vector
// lane per row.  Here one thread owns one (row, window) and runs the
// window scan of gear.cuh (gear_window_scan), the scan of B6
// (gear_window_first_checked.cu) without its occupancy fold: it replays
// the 64 bytes before the window, scans the window's 2^thin_bits / 256
// groups from global memory, each group's eight packed hit words into
// registers, takes each group's first hit after the group, and writes
// one u32.  Group 0 of a row is warm-up and belongs to no window, as in
// the reference.
//
// Input: rows (T, S/4) uint32 words (int32 storage), (S - 256) a multiple
// of 2^thin_bits, thin_bits >= 8.  Output: first (T * nwin,) uint32 in
// stream order (row-major), the in-window offset of the first candidate or
// 1 << 30.  dat_gear_window_first returns cudaGetLastError().
//
// What bounds it: the 32-bit integer ALU pipe, about 6 instructions per
// byte stepped (chip_smoke.py sass_bound walks its SASS), against 0.32 ms
// of bytes per 1 GiB slab (1 byte read, 4 bytes written per window).  The
// design keeps the first-hit select out of the scan, so nothing but the
// gear chain sits between the 16-byte loads and ptxas can issue them well
// ahead of their use, off the chain.  At 2 KiB windows the warm-up adds
// 3% more steps.
#include "gear.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gear_window_first_kernel(const uint4* __restrict__ rows,
                         uint32_t* __restrict__ first, int nrows,
                         int row_bytes, int thin_bits, uint32_t mask) {
  const int nwin = (row_bytes - dat::kGroup) >> thin_bits;
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (id >= static_cast<long long>(nrows) * nwin) return;
  const int t = static_cast<int>(id / nwin);
  const int w = static_cast<int>(id % nwin);
  const uint4* row = rows + static_cast<size_t>(t) * (row_bytes / 16);
  first[id] = dat::gear_window_scan<false>(row, w, thin_bits, mask, nullptr);
}

}  // namespace

extern "C" int dat_gear_window_first(const void* rows, void* first, int nrows,
                                     int row_bytes, int avg_bits,
                                     int thin_bits, void* stream) {
  const long long n =
      static_cast<long long>(nrows) * ((row_bytes - dat::kGroup) >> thin_bits);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    gear_window_first_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rows), static_cast<uint32_t*>(first), nrows,
        row_bytes, thin_bits, (1u << avg_bits) - 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
