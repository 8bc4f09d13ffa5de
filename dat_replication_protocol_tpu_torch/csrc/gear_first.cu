// Kernel B4: the first gear candidate of every 256-byte group of a tile
// row (route "first").
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/rabin_pallas.py
// gear_first_native (body _kernel_first, :365; wrapper gear_first_pallas
// :447), which walks each row serially in one vector lane with a per-byte
// select on the first hit.  Here, as in B3 (gear_candidates.cu), one
// thread owns one (row, group): warm-up over the 64 bytes before the group
// (none for group 0), a scan of its 256 bytes, and one u32 out.  The first
// hit is taken from the packed hit words (first nonzero word, then its
// lowest set bit), off the gear chain's serial path.
//
// Input: rows (T, S/4) uint32 words (int32 storage), S a multiple of 256.
// Output: first (T, S/256) uint32, the group-local offset of the group's
// first candidate or 256 (NO_HIT).  dat_gear_first returns
// cudaGetLastError().
//
// What bounds it: the same scan as B3, with B3's instruction count in the
// SASS to within 1% (chip_smoke.py sass_bound): the 32-bit integer ALU
// pipe, about 0.46 ms per 1 GiB slab on an H100 at 1.98 GHz, against 0.33
// ms of bytes (1 byte read, 1/64 byte written).  The design pays the 25%
// warm-up for 64x more threads than a row each.
#include "gear.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gear_first_kernel(const uint4* __restrict__ rows, uint32_t* __restrict__ first,
                  int nrows, int row_bytes, uint32_t mask) {
  const int ng = row_bytes / dat::kGroup;
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (id >= static_cast<long long>(nrows) * ng) return;
  const int t = static_cast<int>(id / ng);
  const int g = static_cast<int>(id % ng);
  const uint4* row = rows + static_cast<size_t>(t) * (row_bytes / 16);
  const int p = g * dat::kGroup;
  uint64_t h = dat::gear_warm(row, p);
  uint32_t out = dat::kNoHit;
  dat::gear_group(row, p, h, mask, [&](int k, uint32_t b) {
    if (out == dat::kNoHit && b != 0u) out = k * dat::kPack + (__ffs(b) - 1);
  });
  first[id] = out;
}

}  // namespace

extern "C" int dat_gear_first(const void* rows, void* first, int nrows,
                              int row_bytes, int avg_bits, void* stream) {
  const long long n = static_cast<long long>(nrows) * (row_bytes / dat::kGroup);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    gear_first_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rows), static_cast<uint32_t*>(first), nrows,
        row_bytes, (1u << avg_bits) - 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
