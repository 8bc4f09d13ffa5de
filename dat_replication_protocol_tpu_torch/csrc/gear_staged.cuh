// The staged gear scan of kernel B4 (gear_first.cu): rows are copied
// global -> shared memory in coalesced 16-byte cp.async requests and
// scanned from there.
//
// Why: the one-thread-per-group scan of gear.cuh (B3) issues 16-byte
// global loads 256 B apart across a warp, so every load instruction
// touches 32 cache lines and each line is consumed over several loads of
// one lane.  Here a warp's copy request covers 512 contiguous bytes and
// each lane then reads its own group from shared memory.
//
// Work is cut into spans of kThreads consecutive 256-byte groups; thread
// t of a CTA scans group g0 + t of its span after one 64-byte warm-up.
// Stage layout (bytes): slot 0 of kSlot bytes, then slots 1..kThreads
// (slot t+1 holds thread t's group, 256 bytes of data and 16 of padding,
// so lanes reading 16 bytes at slot stride spread over all 32 banks).
// The warm-up of a group is the 64 bytes before it: the tail of slot t
// (thread t-1's group, or for t = 0 the span's own halo, held in bytes
// 192..255 of slot 0), so only the span's halo is read twice from global
// memory.
//
// A CTA walks spans blockIdx.x, blockIdx.x + gridDim.x, ... (a persistent
// grid sized by the wrapper, ops/rabin_cuda.py staged_geometry), through a
// ring of kStages stages: the copy of span i + 1 is in flight while span i
// is scanned.  Groups past the end (the ragged last span) are zero-filled
// by the copy and scanned, and their results are dropped.
#pragma once

#include "gear.cuh"

namespace dat {
namespace staged {

constexpr int kThreads = 256;     // threads a CTA, groups a span
constexpr int kStages = 2;        // spans in the ring
constexpr int kSlot = kGroup + 16;  // shared bytes per group slot
constexpr int kStageBytes = (kThreads + 1) * kSlot;
constexpr int kSmemBytes = kStages * kStageBytes;  // 139,808: one CTA an SM

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src,
                                       int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kStages - 1 committed copy groups are in flight.
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Issues the copies of the span of groups [g0, g0 + kThreads) of src (ng
// groups in all) into stage st: each thread copies 16 chunks of 16 bytes
// (a warp covers two groups' 512 contiguous bytes per request), and
// threads 0-3 the 64 bytes before g0 (none at g0 = 0).
__device__ __forceinline__ void issue_span(uint8_t* st, const uint8_t* src,
                                           int g0, int ng) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kGroup / 16; ++q) {
    const int c = tid + q * kThreads;
    const int t = c >> 4;
    const int off = (c & 15) * 16;
    const int g = g0 + t;
    const bool ok = g < ng;
    copy16(st + (t + 1) * kSlot + off, src + (ok ? g * kGroup + off : 0),
           ok ? 16 : 0);
  }
  if (tid < kGearWindow / 16) {
    const bool ok = g0 > 0;
    copy16(st + kGroup - kGearWindow + tid * 16,
           src + (ok ? g0 * kGroup - kGearWindow + tid * 16 : 0),
           ok ? 16 : 0);
  }
}

// The state after the 64 warm-up bytes at src (a shared-memory slot tail).
__device__ __forceinline__ uint64_t warm(const uint8_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
  uint64_t h = 0;
#pragma unroll
  for (int q = 0; q < kGearWindow / 16; ++q) {
    const uint4 a = v[q];
    gear_word(h, a.x, 0u);
    gear_word(h, a.y, 0u);
    gear_word(h, a.z, 0u);
    gear_word(h, a.w, 0u);
  }
  return h;
}

// Scans the 256-byte group at src (shared memory) into 8 packed hit words,
// kept in registers: nothing but the chain itself sits between the loads.
__device__ __forceinline__ void scan_group(const uint8_t* src, uint64_t& h,
                                           uint32_t mask, uint32_t (&w)[8]) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < kGroup / kPack; ++k) {
    const uint4 a = v[2 * k];
    const uint4 b = v[2 * k + 1];
    uint32_t bits = gear_word(h, a.x, mask);
    bits |= gear_word(h, a.y, mask) << 4;
    bits |= gear_word(h, a.z, mask) << 8;
    bits |= gear_word(h, a.w, mask) << 12;
    bits |= gear_word(h, b.x, mask) << 16;
    bits |= gear_word(h, b.y, mask) << 20;
    bits |= gear_word(h, b.z, mask) << 24;
    bits |= gear_word(h, b.w, mask) << 28;
    w[k] = bits;
  }
}

}  // namespace staged
}  // namespace dat
