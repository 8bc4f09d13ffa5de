// A probe, not a port of a TPU kernel: the dependent-issue latency of the
// 32-bit integer instructions a BLAKE2b G mix is made of, which turns the
// dependent path of kernel B1's compression (read from its SASS by
// chip_smoke.py) into a chain bound in cycles.
//
// One thread runs a serial chain of the G mix's operations on one 64-bit
// word, xor, funnel-shift rotate and 64-bit add (LOP3, SHF, IADD3 and
// IADD3.X in the SASS), `iters` times 64 steps, and reads the SM clock
// before and after.  cycles / (iters x the dependent path of the loop
// body, again read from this library's SASS) is the latency of one
// dependent instruction.  dat_chain_latency launches one thread on the
// caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_compress.cuh"

namespace {

__global__ void chain_latency_kernel(uint32_t* __restrict__ out,
                                     long long* __restrict__ cycles,
                                     int iters, uint32_t seed) {
  uint64_t x = dat::join64(seed, ~seed);
  const uint64_t y = dat::join64(seed * 2654435761u, seed ^ 0x5bd1e995u);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      x = dat::rotr64(x ^ y, 24);
      x = x + y;
    }
  }
  const long long t1 = clock64();
  out[0] = static_cast<uint32_t>(x) ^ static_cast<uint32_t>(x >> 32);
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int dat_chain_latency(void* out, void* cycles, int iters, int seed,
                                 void* stream) {
  chain_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<long long*>(cycles), iters,
      static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}
