// Kernel B2: one Merkle tree level.  Each parent digest is BLAKE2b-256 of
// the 64-byte concatenation left || right of its two children's 32-byte
// digests: exactly one final compression with t = 64.
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/merkle_pallas.py
// merkle_level_native (body _kernel, :42), which lays the parents out as
// (8, P/8) vector tiles.  Here one thread computes one parent.  Children
// pair even and odd rows (dat's flat in-order convention), so parent p's
// message is rows 2p and 2p+1 of the (N, 4) hi/lo digest matrices, i.e. the
// 8 contiguous words starting at p*8: neighbouring threads read neighbouring
// 32-byte runs, and the loads coalesce.
//
// Input: hh/hl (2P, 4) uint32 hi/lo digest words (int32 storage on the
// PyTorch side).  Output: ph/pl (P, 4).  The kernel allocates nothing and
// launches on the caller's stream; dat_merkle_level returns
// cudaGetLastError().
//
// What bounds it: 64 input bytes and 32 output bytes per parent against
// about 2.1k 32-bit integer instructions for its one compression (1.4k
// xors and funnel shifts on the INT32 lanes), so the integer-ALU rate
// bounds it, not memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_compress.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDigestSize = 32;

__global__ void __launch_bounds__(kThreads)
merkle_level_kernel(const uint32_t* __restrict__ hh,
                    const uint32_t* __restrict__ hl,
                    uint32_t* __restrict__ ph, uint32_t* __restrict__ pl,
                    int parents) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= parents) return;
  const uint4* src_h = reinterpret_cast<const uint4*>(hh) + p * 2;
  const uint4* src_l = reinterpret_cast<const uint4*>(hl) + p * 2;
  uint64_t m[16];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 hi = src_h[q];
    const uint4 lo = src_l[q];
    m[4 * q + 0] = dat::join64(hi.x, lo.x);
    m[4 * q + 1] = dat::join64(hi.y, lo.y);
    m[4 * q + 2] = dat::join64(hi.z, lo.z);
    m[4 * q + 3] = dat::join64(hi.w, lo.w);
  }
#pragma unroll
  for (int w = 8; w < 16; ++w) m[w] = 0;  // the message fills half a block

  uint64_t h[8];
  dat::blake2b_init(h, kDigestSize);
  dat::blake2b_compress(h, m, 2 * kDigestSize, true);

  uint4 out_h, out_l;
  out_h.x = static_cast<uint32_t>(h[0] >> 32);
  out_h.y = static_cast<uint32_t>(h[1] >> 32);
  out_h.z = static_cast<uint32_t>(h[2] >> 32);
  out_h.w = static_cast<uint32_t>(h[3] >> 32);
  out_l.x = static_cast<uint32_t>(h[0]);
  out_l.y = static_cast<uint32_t>(h[1]);
  out_l.z = static_cast<uint32_t>(h[2]);
  out_l.w = static_cast<uint32_t>(h[3]);
  reinterpret_cast<uint4*>(ph)[p] = out_h;
  reinterpret_cast<uint4*>(pl)[p] = out_l;
}

}  // namespace

extern "C" int dat_merkle_level(const void* hh, const void* hl, void* ph,
                                void* pl, int parents, void* stream) {
  if (parents > 0) {
    const int grid = (parents + kThreads - 1) / kThreads;
    merkle_level_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(hh), static_cast<const uint32_t*>(hl),
        static_cast<uint32_t*>(ph), static_cast<uint32_t*>(pl), parents);
  }
  return static_cast<int>(cudaGetLastError());
}
