// Kernel B1: batched RFC 7693 BLAKE2b over B items of variable length.
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/blake2b_pallas.py
// blake2b_native (body _kernel, :128), which walks a (batch tile, block)
// grid with the chaining state in VMEM scratch and the batch split (8, B/8)
// across vector sublanes.  None of that layout carries over: here one
// thread owns one item, holds its 8-word chaining state in registers and
// loops over that item's ceil(len/128) blocks (at least one).  Blocks past
// an item's end are skipped, which is what the reference's active mask
// makes of them; the final flag and the counter t = min(len, (k+1)*128)
// are computed as in blake2b_pallas.py:157-167.
//
// Input: mh/ml (B, nblocks, 16) uint32 hi/lo message words (int32 storage
// on the PyTorch side), lengths (B,) int32.  Output: hh/hl (B, 8) hi/lo
// digest words.  The kernel allocates nothing and launches on the caller's
// stream; dat_blake2b_packed returns cudaGetLastError().
//
// What bounds it: BLAKE2b is integer-ALU work, about 2.1k 32-bit instructions
// per 128-byte block, 1.4k of them xors and funnel shifts that only the
// INT32 lanes execute, so on an H100 the operation bound lies above the
// byte bound.  What this design does not yet do: with one thread per item,
// neighbouring threads read addresses a whole item apart (1 MiB for the
// blob bucket of the digest session), so the message loads do not coalesce,
// and a bucket of 32 large items runs 32 threads on one SM while the other
// 131 stay idle.  One item cannot be split across threads (each block
// chains into the next), so the later fixes are cooperative, coalesced
// loads of many items' blocks through shared memory and wider buckets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_compress.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
blake2b_packed_kernel(const uint32_t* __restrict__ mh,
                      const uint32_t* __restrict__ ml,
                      const int32_t* __restrict__ lengths,
                      uint32_t* __restrict__ out_h,
                      uint32_t* __restrict__ out_l, int batch, int nblocks,
                      int digest_size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const uint64_t len = static_cast<uint32_t>(lengths[i]);
  int item_blocks = static_cast<int>((len + 127) >> 7);
  if (item_blocks < 1) item_blocks = 1;  // the empty message is one block
  // a length past the padded width never reaches its final block, as in
  // the reference's masked scan
  const int steps = item_blocks < nblocks ? item_blocks : nblocks;

  uint64_t h[8];
  dat::blake2b_init(h, digest_size);

  const size_t row = static_cast<size_t>(i) * nblocks * 16;
  const uint4* ph = reinterpret_cast<const uint4*>(mh + row);
  const uint4* pl = reinterpret_cast<const uint4*>(ml + row);
  for (int k = 0; k < steps; ++k) {
    uint64_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 hi = ph[k * 4 + q];
      const uint4 lo = pl[k * 4 + q];
      m[4 * q + 0] = dat::join64(hi.x, lo.x);
      m[4 * q + 1] = dat::join64(hi.y, lo.y);
      m[4 * q + 2] = dat::join64(hi.z, lo.z);
      m[4 * q + 3] = dat::join64(hi.w, lo.w);
    }
    const uint64_t cap = static_cast<uint64_t>(k + 1) << 7;
    const uint64_t t = cap < len ? cap : len;
    dat::blake2b_compress(h, m, t, k == item_blocks - 1);
  }

#pragma unroll
  for (int w = 0; w < 8; ++w) {
    out_h[i * 8 + w] = static_cast<uint32_t>(h[w] >> 32);
    out_l[i * 8 + w] = static_cast<uint32_t>(h[w]);
  }
}

}  // namespace

extern "C" int dat_blake2b_packed(const void* mh, const void* ml,
                                  const void* lengths, void* out_h,
                                  void* out_l, int batch, int nblocks,
                                  int digest_size, void* stream) {
  if (batch > 0) {
    const int grid = (batch + kThreads - 1) / kThreads;
    blake2b_packed_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(mh), static_cast<const uint32_t*>(ml),
        static_cast<const int32_t*>(lengths), static_cast<uint32_t*>(out_h),
        static_cast<uint32_t*>(out_l), batch, nblocks, digest_size);
  }
  return static_cast<int>(cudaGetLastError());
}
