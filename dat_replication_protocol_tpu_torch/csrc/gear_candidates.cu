// Kernel B3: the packed candidate bitmask of the gear rolling hash over
// tile rows (route "bitmask", the default CDC route).
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/rabin_pallas.py
// gear_candidates_native (body _kernel, :35; wrapper gear_candidates_pallas
// :467).  On the TPU one vector lane owns one 128 KiB row and walks it
// serially across the grid with its state in VMEM scratch, eight chains
// interleaved.  That shape does not carry over: a thread per row would
// give 8,192 threads per 1 GiB slab, 128 KiB apart.  Here one thread owns
// one (row, 256-byte group): it replays the 64 bytes before its group
// (gear.cuh gear_warm; none for group 0, whose state starts from zero as
// the TPU kernel's does) and scans its 256 bytes, 16 bytes a load, and
// writes its 8 packed words as two 16-byte stores.  A warp covers 32
// consecutive groups of a row, 8 KiB of contiguous memory.
//
// Input: rows (T, S/4) uint32 words (int32 storage), S a multiple of 256.
// Output: bits (T, S/32) uint32, bit j%32 of word j/32 set iff byte j of
// the row is a candidate.  dat_gear_candidates returns cudaGetLastError().
//
// What bounds it: the instructions it issues, read from the SASS
// (chip_smoke.py sass_bound walks `cuobjdump -sass` of the built library).
// With nvcc 12.9 one thread issues 2,662 instructions for its 320 bytes
// (64 warm-up, 256 scanned): 1,814 on the 32-bit integer ALU pipe (LEA,
// LOP3, SEL, SHF: about 5.7 a byte), 789 IMAD on the FMA pipe and the
// rest loads, stores and control.  The ALU pipe, 64 lanes per SM, bounds
// it: about 0.46 ms over a 1 GiB slab at 132 SMs x 1.98 GHz, against 0.36
// ms of bytes at 3.35 TB/s.  The design adds the 64-byte warm-up per
// 256-byte group (25% more steps) to buy 64x more threads than a row
// each; nothing else is tuned yet.
#include "gear.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gear_candidates_kernel(const uint4* __restrict__ rows,
                       uint32_t* __restrict__ bits, int nrows, int row_bytes,
                       uint32_t mask) {
  const int ng = row_bytes / dat::kGroup;
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (id >= static_cast<long long>(nrows) * ng) return;
  const int t = static_cast<int>(id / ng);
  const int g = static_cast<int>(id % ng);
  const uint4* row = rows + static_cast<size_t>(t) * (row_bytes / 16);
  const int p = g * dat::kGroup;
  uint64_t h = dat::gear_warm(row, p);
  uint32_t w[dat::kGroup / dat::kPack];
  dat::gear_group(row, p, h, mask, [&](int k, uint32_t b) { w[k] = b; });
  uint4* dst = reinterpret_cast<uint4*>(
      bits + static_cast<size_t>(t) * (row_bytes / dat::kPack) + g * 8);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

}  // namespace

extern "C" int dat_gear_candidates(const void* rows, void* bits, int nrows,
                                   int row_bytes, int avg_bits, void* stream) {
  const long long n = static_cast<long long>(nrows) * (row_bytes / dat::kGroup);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    gear_candidates_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rows), static_cast<uint32_t*>(bits), nrows,
        row_bytes, (1u << avg_bits) - 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
